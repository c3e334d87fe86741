// The body of the fused gate + expert forward for Hopper (sm_90a): one
// device function that K1 (gate_expert_fwd.cu, MODE_PRODUCTION) and its
// ablation variants K3 (gate_expert_variants.cu, the other modes) are both
// instances of, so that timing a K3 mode times K1's own code with parts
// removed.  For every pixel n and every kernel k:
//
//   mh    = min(phi_n . q'_k, 0)        q' = -0.5 * mask * q, prescaled by the
//                                       caller (exact; dead rows are zero);
//                                       exp2 mode: times log2(e)
//   n_w   = exp(mh) * pi_det_k
//   w     = n_w / max(floor, sum_k n_w)
//   w     = w if w > thr else 0         influence cull, thr = 0.5 / 2^precision
//   res_n = sum_j xe_nj * (sum_k w G_k)[j*C + c]
//   surv_k = max over valid n of w
//
// Modes.  A mode removes only what it removes (the functions are
// kernels/gate_expert_variants.py:gate_expert_variant_reference's):
//
//   MODE        pass 1              compaction  pass 2 visits  w             tail
//   PRODUCTION  denom + maxima      yes         candidates     cull(n_w/d)   survivors, den_out, stats, xe mix
//   FULL        denom + maxima      yes         candidates     cull(n_w/d)   res = sum_j wg[j*C + c]
//   EXP2        as FULL, exp2f      yes         candidates     as FULL       as FULL
//   NO_CULL     denom only          no          every kernel   n_w / d       as FULL
//   NO_NORM     none                no          every kernel   n_w           as FULL
//   NO_EXP      none                no          every kernel   mh            as FULL
//   FULL_DENSE  denom only          no          every kernel   cull(n_w/d)   as FULL
//
// FULL's tail is PRODUCTION's with xe = 1 (fmaf(1, a, r) is a + r), so FULL
// gives K1's bits for xe = 1, mask = 1.  FULL_DENSE is FULL with the
// compaction and the certain-cull skip taken out: the one loop over every
// kernel that K1 ran before it had candidates, divided and culled per pair.
// It is no ablation (gate_expert_variants.py does not offer it);
// chip_smoke.py calls it through the C interface as the witness that
// compaction and segments keep that loop's bits.
//
// Design.  One thread per pixel, TPB pixels per CTA; rows are bounds-checked
// here, so N needs no padding.  q', G and pi_det are staged through shared
// memory KC kernels at a time, q' rows padded to whole float4s.
//
//   Pass 1 sums the denominator over every kernel.  The kernels are then
//   taken in segments of up to SEG, in increasing k; per segment, each
//   kernel's largest n_w in the CTA is recorded: each warp takes it with one
//   redux.sync on the float bits (n_w > 0, so the unsigned order is the float
//   order) into shared memory, and at the end of each chunk one thread per
//   kernel folds the warps' maxima into s_cand[k - s0] (SEG words of dynamic
//   shared memory; no atomics).  The first segment's maxima are recorded
//   during pass 1 itself, so a K <= SEG costs no extra pass; a later
//   segment recomputes n_w for its kernels, the same roundings.
//   Before the first segment the CTA takes dmin = min of its valid pixels'
//   denominators; per segment it compacts, in increasing k and in place, the
//   kernels whose CTA max is not below cull_cut(thr, dmin).  Every other
//   kernel has, for every pixel of the CTA, n_w < cull_cut(thr, dmin) <=
//   cull_cut(thr, denom_n), so it is culled everywhere here
//   (gate_expert_common.cuh: CULL_MARGIN).
//   Pass 2 stages and visits that segment's candidates only, in k order,
//   recomputes n_w, skips the division where n_w < cull_cut(thr, denom_n)
//   (certainly culled), and accumulates wg = w @ G in registers across the
//   segments; res is formed from wg and xe at the end, the TPU kernel's
//   order.  The candidate set and the order of the accumulation do not
//   depend on SEG, so every K gives the bits of the one loop over all K
//   (FULL_DENSE), and shared memory stays bounded for any K.  The modes
//   without compaction run pass 2 over every kernel, in the same segments
//   and chunks, and need no dynamic shared memory.
//
// A skipped pair added an exact zero and never raised a maximum in that
// loop, so res and surv keep its bits: the denominator is the same FMA
// chain, n_w and w the same roundings.  Survivors: each warp reduces w per
// kernel with redux.sync, the winner lane merges it into a per-CTA max in
// shared memory, and the CTA merges that into the global max with atomicMax
// on the bit pattern; max is order-free, so the result is deterministic.
// Every product is an fp32 FMA or an explicitly rounded fp32 op: no tensor
// cores, no TF32 (the quadratic-feature maha cancels A^2-scale terms and
// needs exact fp32; wgmma has no fp32 input).  Built without
// --use_fast_math: expf, exp2f, IEEE division.  No TMA or cp.async staging:
// a chunk of KC kernels is some 10-20 loads a thread against ~KC * (F + 12)
// instructions of arithmetic.
//
// BF16 (K1's bf16 instance, compute_dtype="bfloat16"; the TPU kernel's
// bf16=True, smoe_tpu/kernels/gate_expert.py:121-123): the maha alone comes
// from the bf16 tensor core, through gate_expert_common.cuh's one routine
// (maha_bf16_tile): before pass 1 the CTA stages its pixels' phi rounded to
// bf16 (into s_q) and each warp keeps its 32 rows as mma A fragments; every
// staging of q' rounds it to bf16 rows of depth D (16 or 32), padded with
// dead kernels to a whole n8 tile; at every eighth staged kernel each warp
// forms its (32 pixels, 8 kernels) tile in shared memory, from which the
// unchanged per-thread code reads its pixel's maha.  Pass 1, the later
// segments' maxima and pass 2 (the candidates sit at other tile columns)
// take the same routine, so a pair has the same maha bits in each, which
// FULL_DENSE's bf16 instance witnesses.  Everything after the maha is the
// fp32 code above.  What bounds it: the maha's 2 D flops a pair on the
// tensor core (989 TFLOP/s bf16 dense: 2.2 us at the flagship's 6.7e7
// pairs) sit far below the fp32 and SFU work that stays (67 TFLOP/s), so
// the instance is bound as the fp32 one is, less the F FMAs a pair.

// Optional outputs (PRODUCTION): den_out (N,) receives each pixel's
// max(floor, sum n_w) for the backward K2 (gate_expert_bwd.cu), which then
// skips its own denominator pass; raw > floor is den_out > floor.  stats
// (2,) receives += (pairs visited in pass 2, surviving pairs).  Null
// pointers skip both.
//
// What bounds it (a reckoning, not a measurement).  Every (pixel, kernel)
// pair pays pass 1: F maha FMAs, one expf (SFU plus range-reduction FMAs),
// the denominator FMA, the n_w multiply and a warp max.  Pass 2 repeats the
// maha and expf for the candidates only, and the division and E*C mixing
// FMAs where the pair may survive.  At the 512^2 x 256-kernel flagship that
// is 6.7e7 pairs against ~14 MB of input and output: compute/SFU bound, not
// memory bound.  On raster-ordered pixels a CTA covers a short run of one
// row and only the kernels near it are candidates; on randomly ordered
// pixels nearly every kernel is.  The per-mode bounds are
// smoe_tpu_torch/diag/contraction.py:mode_bound.  Staged q'/G are read as
// shared-memory broadcasts (every thread of a warp reads the same word),
// which costs no bank conflicts.  At F = 26 (the dual-model video features)
// a thread holds a 26-float phi row, and s_q (KC x 28 floats) brings the
// static shared memory to 43 KB, under the 48 KB a static allocation may
// take.

#pragma once

#include <cuda_runtime.h>

#include "gate_expert_common.cuh"

namespace smoe {

// the modes' numbers: 0-4 are gate_expert_variants.py's VARIANTS in order
enum FwdMode : int {
  MODE_FULL = 0,
  MODE_EXP2 = 1,
  MODE_NO_CULL = 2,
  MODE_NO_NORM = 3,
  MODE_NO_EXP = 4,
  MODE_FULL_DENSE = 5,
  MODE_PRODUCTION = 6,
};

constexpr int NW = TPB / 32;    // warps per CTA
// kernels per segment: SEG words of dynamic shared memory per CTA (32 KB);
// a multiple of KC, so a segment is whole staging chunks
constexpr int SEG = 8192;
static_assert(SEG % KC == 0, "a segment is whole staging chunks");

// the modes that record the CTA maxima and compact the candidates
__host__ __device__ constexpr bool compacts(int mode) {
  return mode == MODE_PRODUCTION || mode == MODE_FULL || mode == MODE_EXP2;
}

// dynamic shared memory of a launch: the candidate words, compacting modes
__host__ __device__ constexpr int fwd_dynamic_smem(int mode, int k) {
  return compacts(mode) ? 4 * (k < SEG ? k : SEG) : 0;
}

template <int MODE>
__device__ __forceinline__ float gate_exp(float mh) {
  if constexpr (MODE == MODE_EXP2) return exp2f(mh);
  else return expf(mh);
}

// Fold the warps' maxima of one staged chunk (s_wmax, (NW, KC)) into
// dst[0, kc): one thread per kernel.
__device__ __forceinline__ void fold_maxima(const unsigned* s_wmax,
                                            unsigned* dst, int kc) {
  for (int i = threadIdx.x; i < kc; i += TPB) {
    unsigned m = s_wmax[i];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = max(m, s_wmax[w * KC + i]);
    dst[i] = m;
  }
}

// One warp's share of a CTA-wide max of n_w for the staged kernel kk.
__device__ __forceinline__ void record_max(unsigned* s_wmax, float n_w,
                                           bool valid, int lane, int warp,
                                           int kk) {
  // the loop over kk is uniform across the CTA, so every lane is here
  const unsigned m = __reduce_max_sync(
      FULL, valid && n_w > 0.f ? __float_as_uint(n_w) : 0u);
  if (lane == 0) s_wmax[warp * KC + kk] = m;
}

// The forward of one CTA.  xe, surv, den_out and stats are read or written
// by MODE_PRODUCTION only (the others take null); the launch gives
// fwd_dynamic_smem(MODE, k) bytes of dynamic shared memory.
template <int F, int E, int C, int MODE, bool BF16 = false>
__device__ __forceinline__ void gate_expert_fwd_body(
    const float* __restrict__ phi,     // (N, F)
    const float* __restrict__ xe,      // (N, E)
    const float* __restrict__ qs,      // (K, F) prescaled
    const float* __restrict__ G,       // (K, E*C)
    const float* __restrict__ pi_det,  // (K,)
    float* __restrict__ res,           // (N, C)
    unsigned* __restrict__ surv,       // (K,) float bits
    float* __restrict__ den_out,       // (N,) or null
    unsigned long long* __restrict__ stats,  // (2,) or null
    int n, int k, float thr, float floor_) {
  constexpr bool PROD = MODE == MODE_PRODUCTION;
  constexpr bool COMPACT = compacts(MODE);
  constexpr bool DENOM = MODE != MODE_NO_NORM && MODE != MODE_NO_EXP;
  constexpr bool CULL = COMPACT || MODE == MODE_FULL_DENSE;
  constexpr bool PI = MODE != MODE_NO_EXP;
  constexpr int EC = E * C;
  constexpr int FP = pad4(F);
  constexpr int GW = EC > NW ? EC : NW;
  constexpr int D = bf16_depth(F);
  static_assert(KC == TPB, "BF16 stages the CTA's pixels in s_q");
  // staged q' rows: FP floats each, or (BF16) D bf16s, no more bytes; BF16
  // stages the CTA's phi rows there first
  __shared__ __align__(16) float s_q[BF16 ? KC * D / 2 : KC * FP];
  __shared__ float s_gw[KC * GW];    // maxima passes: (NW, KC); pass 2: G
  __shared__ float s_pi[KC];
  __shared__ unsigned s_surv[KC];
  __shared__ unsigned s_dmin[NW];
  __shared__ int s_ncand;
  // (min(K, SEG),), compacting modes: a segment's CTA max n_w bits per
  // kernel, then its candidate list (absolute kernel indices)
  extern __shared__ unsigned s_cand[];
  unsigned* s_wmax = reinterpret_cast<unsigned*>(s_gw);
  const int* cand = reinterpret_cast<const int*>(s_cand);

  const int row = blockIdx.x * TPB + threadIdx.x;
  const bool valid = row < n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ph[F];
  FragA<D> afr[2];        // BF16: the warp's 32 pixels as the mma's A
  float* s_mt = nullptr;  // BF16: the warp's (32 pixels, 8 kernels) tile
  __nv_bfloat16* const s_qb = reinterpret_cast<__nv_bfloat16*>(s_q);
  if constexpr (BF16) {
    __shared__ float s_tile[NW * 32 * MT_LD];
    s_mt = s_tile + warp * 32 * MT_LD;
    // the first staging below starts with __syncthreads()
    pixel_frags_bf16<F, TPB>(afr, s_qb, phi, blockIdx.x * TPB, n);
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) ph[j] = valid ? phi[(size_t)row * F + j] : 0.f;
  }

  // Stage kc kernels' q' (rows k0 .., or idx[k0 ..]) for the maha; BF16
  // pads them with dead kernels to a whole n8 tile.
  auto stage_q = [&](int k0, int kc, const int* idx) {
    if constexpr (BF16)
      stage_bf16<F, TPB>(s_qb, qs, k0, kc, (kc + 7) & ~7, idx);
    else
      stage_padded<F, TPB>(s_q, qs, k0, kc, idx);
  };
  // The raw maha phi . q' of this thread's pixel and staged kernel kk: the
  // fp32 FMA chain, or (BF16) the warp's tensor-core tile, formed at every
  // eighth kernel (kk runs uniformly over the CTA, so the warp is whole).
  auto maha_at = [&](int kk) -> float {
    if constexpr (BF16) {
      return pixel_maha_bf16<D>(afr, s_qb, s_mt, kk);
    } else {
      return dot_padded<F>(ph, s_q + kk * FP);
    }
  };

  // pass 1: the gating denominator, with the first segment's maxima, then
  // (past SEG kernels) the rest of the denominator: one FMA chain in k order
  float denom = 1.f;
  if constexpr (DENOM) {
    const int seg0 = COMPACT ? min(k, SEG) : 0;
    denom = 0.f;
    for (int k0 = 0; k0 < seg0; k0 += KC) {
      const int kc = min(KC, seg0 - k0);
      __syncthreads();
      stage_q(k0, kc, nullptr);
      for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        const float e = gate_exp<MODE>(fminf(maha_at(kk), 0.f));
        denom = fmaf(e, s_pi[kk], denom);
        record_max(s_wmax, __fmul_rn(e, s_pi[kk]), valid, lane, warp, kk);
      }
      __syncthreads();
      fold_maxima(s_wmax, s_cand + k0, kc);
    }
    for (int k0 = seg0; k0 < k; k0 += KC) {
      const int kc = min(KC, k - k0);
      __syncthreads();
      stage_q(k0, kc, nullptr);
      for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        const float e = gate_exp<MODE>(fminf(maha_at(kk), 0.f));
        denom = fmaf(e, s_pi[kk], denom);
      }
    }
    denom = fmaxf(floor_, denom);
    if constexpr (PROD)
      if (valid && den_out) den_out[row] = denom;
  }

  // the CTA's least denominator (denom >= floor_ > 0, so the unsigned order
  // of the bits is the float order); warp 0 compacts with its cut
  float cta_cut = 0.f, cut = 0.f;
  if constexpr (COMPACT) {
    const unsigned db = __reduce_min_sync(
        FULL, valid ? __float_as_uint(denom) : 0xffffffffu);
    if (lane == 0) s_dmin[warp] = db;
    __syncthreads();
    if (warp == 0) {
      const unsigned dm =
          __reduce_min_sync(FULL, lane < NW ? s_dmin[lane] : 0xffffffffu);
      cta_cut = cull_cut(thr, __uint_as_float(dm));
    }
    cut = cull_cut(thr, denom);
  }

  const int rows = min(TPB, n - (int)blockIdx.x * TPB);
  float wg[EC];
#pragma unroll
  for (int j = 0; j < EC; ++j) wg[j] = 0.f;
  unsigned kept = 0;
  for (int s0 = 0; s0 < k; s0 += SEG) {
    const int sk = min(SEG, k - s0);
    int ncand = sk;
    if constexpr (COMPACT) {
      if (s0 > 0) {
        // this segment's maxima, n_w recomputed as pass 1 computed it
        for (int k0 = s0; k0 < s0 + sk; k0 += KC) {
          const int kc = min(KC, s0 + sk - k0);
          __syncthreads();
          stage_q(k0, kc, nullptr);
          for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
          __syncthreads();
          for (int kk = 0; kk < kc; ++kk) {
            const float e = gate_exp<MODE>(fminf(maha_at(kk), 0.f));
            record_max(s_wmax, __fmul_rn(e, s_pi[kk]), valid, lane, warp, kk);
          }
          __syncthreads();
          fold_maxima(s_wmax, s_cand + (k0 - s0), kc);
        }
      }
      __syncthreads();
      // the candidates: kernels of the segment that may survive at some
      // pixel of the CTA
      if (warp == 0) {
        int count = 0;
        for (int base = 0; base < sk; base += 32) {
          const int kk = base + lane;
          const bool keep =
              kk < sk && !(__uint_as_float(s_cand[kk]) < cta_cut);
          const unsigned bal = __ballot_sync(FULL, keep);
          __syncwarp();
          // in place: every write lands at or below an index this warp has
          // read
          if (keep)
            s_cand[count + __popc(bal & ((1u << lane) - 1u))] = s0 + kk;
          count += __popc(bal);
        }
        if (lane == 0) s_ncand = count;
      }
      __syncthreads();
      ncand = s_ncand;
      if constexpr (PROD)
        if (stats && threadIdx.x == 0)
          atomicAdd(&stats[0],
                    (unsigned long long)ncand * (unsigned long long)rows);
    }

    // pass 2: the mode's weights (K1: normalise, cull, track survivors),
    // mixed into wg = w @ G
    for (int c0 = 0; c0 < ncand; c0 += KC) {
      const int kc = min(KC, ncand - c0);
      __syncthreads();
      if constexpr (COMPACT) {
        stage_q(c0, kc, cand);
        for (int i = threadIdx.x; i < kc * EC; i += TPB) {
          const int r = i / EC, j = i - r * EC;
          s_gw[i] = G[(size_t)cand[c0 + r] * EC + j];
        }
        for (int i = threadIdx.x; i < kc; i += TPB) {
          s_pi[i] = pi_det[cand[c0 + i]];
          if constexpr (PROD) s_surv[i] = 0u;
        }
      } else {
        const int k0 = s0 + c0;
        stage_q(k0, kc, nullptr);
        for (int i = threadIdx.x; i < kc * EC; i += TPB)
          s_gw[i] = G[(size_t)k0 * EC + i];
        if constexpr (PI)
          for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        const float mh = fminf(maha_at(kk), 0.f);
        float w;
        if constexpr (MODE == MODE_NO_EXP) {
          w = mh;
        } else {
          const float n_w = __fmul_rn(gate_exp<MODE>(mh), s_pi[kk]);
          if constexpr (MODE == MODE_NO_NORM) {
            w = n_w;
          } else if constexpr (MODE == MODE_NO_CULL) {
            w = __fdiv_rn(n_w, denom);
          } else if constexpr (MODE == MODE_FULL_DENSE) {
            w = __fdiv_rn(n_w, denom);
            if (!(w > thr)) w = 0.f;
          } else {
            w = 0.f;
            if (valid && !(n_w < cut)) {  // else certainly culled: no division
              w = __fdiv_rn(n_w, denom);
              if (!(w > thr)) w = 0.f;
            }
          }
        }
        if constexpr (PROD) {
          const unsigned m = __reduce_max_sync(FULL, __float_as_uint(w));
          if (lane == 0 && m) atomicMax(&s_surv[kk], m);
        }
        const float* g = s_gw + kk * EC;
        if constexpr (CULL) {
          if (w > 0.f) {
            // skipping culled pairs adds exact zeros only
#pragma unroll
            for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
            ++kept;
          }
        } else {
#pragma unroll
          for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
        }
      }
      if constexpr (PROD) {
        __syncthreads();
        for (int i = threadIdx.x; i < kc; i += TPB)
          if (s_surv[i]) atomicMax(&surv[cand[c0 + i]], s_surv[i]);
      }
    }
  }
  if constexpr (PROD) {
    if (stats) {
      const unsigned kw = __reduce_add_sync(FULL, kept);
      if (lane == 0 && kw) atomicAdd(&stats[1], (unsigned long long)kw);
    }
  }

  if (!valid) return;
  float x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = PROD ? xe[(size_t)row * E + j] : 1.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float r = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) r = fmaf(x[j], wg[j * C + c], r);
    res[(size_t)row * C + c] = r;
  }
}

}  // namespace smoe
