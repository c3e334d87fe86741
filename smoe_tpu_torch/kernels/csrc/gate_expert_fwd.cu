// Fused SMoE gate + expert forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel smoe_tpu/kernels/gate_expert.py::_fwd_kernel
// (launched by _fwd_call).  Same interface and the same function, not the
// same block layout.  For every pixel n and every kernel k:
//
//   mh    = min(phi_n . q'_k, 0)        q' = -0.5 * mask * q, prescaled by the
//                                       caller (exact; dead rows are zero)
//   n_w   = exp(mh) * pi_det_k
//   w     = n_w / max(floor, sum_k n_w)
//   w     = w if w > thr else 0         influence cull, thr = 0.5 / 2^precision
//   res_n = sum_j xe_nj * (sum_k w G_k)[j*C + c]
//   surv_k = max over valid n of w
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
//   depend on SEG, so every K gives the bits a CTA holding all K maxima at
//   once would (as K3 `full`, which keeps the loop of one pass over all K,
//   matches bit for bit), and shared memory stays bounded for any K.
//
// A skipped pair added an exact zero and never raised a maximum in the loop
// it replaces (gate_expert_variants.cu keeps that loop), so res and surv keep
// its bits: the denominator is the same FMA chain, n_w and w the same
// roundings.  Survivors: each warp reduces w per kernel with redux.sync, the
// winner lane merges it into a per-CTA max in shared memory, and the CTA
// merges that into the global max with atomicMax on the bit pattern; max is
// order-free, so the result is deterministic.  Every product is an fp32 FMA
// or an explicitly rounded fp32 op: no tensor cores, no TF32 (the
// quadratic-feature maha cancels A^2-scale terms and needs exact fp32).
// Built without --use_fast_math: expf, IEEE division.
//
// Optional outputs: den_out (N,) receives each pixel's max(floor, sum n_w)
// for the backward K2 (gate_expert_bwd.cu), which then skips its own
// denominator pass; raw > floor is den_out > floor.  stats (2,) receives
// += (pairs visited in pass 2, surviving pairs).  Null pointers skip both.
//
// What bounds it (a reckoning, not a measurement).  Every (pixel, kernel)
// pair pays pass 1: F maha FMAs, one expf (SFU plus range-reduction FMAs),
// the denominator FMA, the n_w multiply and a warp max.  Pass 2 repeats the
// maha and expf for the candidates only, and the division and E*C mixing
// FMAs where the pair may survive.  At the 512^2 x 256-kernel flagship that
// is 6.7e7 pairs against ~14 MB of input and output: compute/SFU bound, not
// memory bound.  On raster-ordered pixels a CTA covers a short run of one
// row and only the kernels near it are candidates; on randomly ordered
// pixels nearly every kernel is, and pass 2 costs what it did before.
// Staged q'/G are read as shared-memory broadcasts (every thread of a warp
// reads the same word), which costs no bank conflicts.  At F = 26 (the
// dual-model video features) a thread holds a 26-float phi row: 80 registers
// with 48 bytes of spills at E = 4, C = 3, and 43 KB of static shared memory
// (s_q is 256 x 28 floats), under the 48 KB a static allocation may take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_expert_common.cuh"

namespace {

using smoe::FULL;
using smoe::KC;
using smoe::TPB;

constexpr int NW = TPB / 32;    // warps per CTA
// kernels per segment: SEG words of dynamic shared memory per CTA (32 KB);
// a multiple of KC, so a segment is whole staging chunks
constexpr int SEG = 8192;
static_assert(SEG % KC == 0, "a segment is whole staging chunks");

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
      smoe::FULL, valid && n_w > 0.f ? __float_as_uint(n_w) : 0u);
  if (lane == 0) s_wmax[warp * KC + kk] = m;
}

template <int F, int E, int C>
__global__ void __launch_bounds__(TPB)
gate_expert_fwd_kernel(const float* __restrict__ phi,     // (N, F)
                       const float* __restrict__ xe,      // (N, E)
                       const float* __restrict__ qs,      // (K, F) prescaled
                       const float* __restrict__ G,       // (K, E*C)
                       const float* __restrict__ pi_det,  // (K,)
                       float* __restrict__ res,           // (N, C)
                       unsigned* __restrict__ surv,       // (K,) float bits
                       float* __restrict__ den_out,       // (N,) or null
                       unsigned long long* __restrict__ stats,  // (2,) or null
                       int n, int k, float thr, float floor_) {
  constexpr int EC = E * C;
  constexpr int FP = smoe::pad4(F);
  constexpr int GW = EC > NW ? EC : NW;
  __shared__ __align__(16) float s_q[KC * FP];
  __shared__ float s_gw[KC * GW];    // maxima passes: (NW, KC); pass 2: G
  __shared__ float s_pi[KC];
  __shared__ unsigned s_surv[KC];
  __shared__ unsigned s_dmin[NW];
  __shared__ int s_ncand;
  // (min(K, SEG),): a segment's CTA max n_w bits per kernel, then its
  // candidate list (absolute kernel indices)
  extern __shared__ unsigned s_cand[];
  unsigned* s_wmax = reinterpret_cast<unsigned*>(s_gw);
  const int* cand = reinterpret_cast<const int*>(s_cand);

  const int row = blockIdx.x * TPB + threadIdx.x;
  const bool valid = row < n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ph[F];
#pragma unroll
  for (int j = 0; j < F; ++j) ph[j] = valid ? phi[(size_t)row * F + j] : 0.f;

  // pass 1: the gating denominator, with the first segment's maxima, then
  // (past SEG kernels) the rest of the denominator: one FMA chain in k order
  const int seg0 = min(k, SEG);
  float denom = 0.f;
  for (int k0 = 0; k0 < seg0; k0 += KC) {
    const int kc = min(KC, seg0 - k0);
    __syncthreads();
    smoe::stage_padded<F, TPB>(s_q, qs, k0, kc, nullptr);
    for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float e = expf(fminf(smoe::dot_padded<F>(ph, s_q + kk * FP), 0.f));
      denom = fmaf(e, s_pi[kk], denom);
      record_max(s_wmax, __fmul_rn(e, s_pi[kk]), valid, lane, warp, kk);
    }
    __syncthreads();
    fold_maxima(s_wmax, s_cand + k0, kc);
  }
  for (int k0 = seg0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);
    __syncthreads();
    smoe::stage_padded<F, TPB>(s_q, qs, k0, kc, nullptr);
    for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float e = expf(fminf(smoe::dot_padded<F>(ph, s_q + kk * FP), 0.f));
      denom = fmaf(e, s_pi[kk], denom);
    }
  }
  denom = fmaxf(floor_, denom);
  if (valid && den_out) den_out[row] = denom;

  // the CTA's least denominator (denom >= floor_ > 0, so the unsigned order
  // of the bits is the float order); warp 0 compacts with its cut
  const unsigned db = __reduce_min_sync(
      FULL, valid ? __float_as_uint(denom) : 0xffffffffu);
  if (lane == 0) s_dmin[warp] = db;
  __syncthreads();
  float cta_cut = 0.f;
  if (warp == 0) {
    const unsigned dm =
        __reduce_min_sync(FULL, lane < NW ? s_dmin[lane] : 0xffffffffu);
    cta_cut = smoe::cull_cut(thr, __uint_as_float(dm));
  }

  const float cut = smoe::cull_cut(thr, denom);
  const int rows = min(TPB, n - (int)blockIdx.x * TPB);
  float wg[EC];
#pragma unroll
  for (int j = 0; j < EC; ++j) wg[j] = 0.f;
  unsigned kept = 0;
  for (int s0 = 0; s0 < k; s0 += SEG) {
    const int sk = min(SEG, k - s0);
    if (s0 > 0) {
      // this segment's maxima, n_w recomputed as pass 1 computed it
      for (int k0 = s0; k0 < s0 + sk; k0 += KC) {
        const int kc = min(KC, s0 + sk - k0);
        __syncthreads();
        smoe::stage_padded<F, TPB>(s_q, qs, k0, kc, nullptr);
        for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
        __syncthreads();
        for (int kk = 0; kk < kc; ++kk) {
          const float e =
              expf(fminf(smoe::dot_padded<F>(ph, s_q + kk * FP), 0.f));
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
        const bool keep = kk < sk && !(__uint_as_float(s_cand[kk]) < cta_cut);
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
    const int ncand = s_ncand;
    if (stats && threadIdx.x == 0)
      atomicAdd(&stats[0],
                (unsigned long long)ncand * (unsigned long long)rows);

    // pass 2: normalise, cull, mix the experts, track survivors
    for (int c0 = 0; c0 < ncand; c0 += KC) {
      const int kc = min(KC, ncand - c0);
      __syncthreads();
      smoe::stage_padded<F, TPB>(s_q, qs, c0, kc, cand);
      for (int i = threadIdx.x; i < kc * EC; i += TPB) {
        const int r = i / EC, j = i - r * EC;
        s_gw[i] = G[(size_t)cand[c0 + r] * EC + j];
      }
      for (int i = threadIdx.x; i < kc; i += TPB) {
        s_pi[i] = pi_det[cand[c0 + i]];
        s_surv[i] = 0u;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        const float n_w = __fmul_rn(
            expf(fminf(smoe::dot_padded<F>(ph, s_q + kk * FP), 0.f)),
            s_pi[kk]);
        float w = 0.f;
        if (valid && !(n_w < cut)) {    // else certainly culled: no division
          w = __fdiv_rn(n_w, denom);
          if (!(w > thr)) w = 0.f;
        }
        const unsigned m = __reduce_max_sync(FULL, __float_as_uint(w));
        if (lane == 0 && m) atomicMax(&s_surv[kk], m);
        if (w > 0.f) {
          // skipping culled pairs adds exact zeros only
          const float* g = s_gw + kk * EC;
#pragma unroll
          for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
          ++kept;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kc; i += TPB)
        if (s_surv[i]) atomicMax(&surv[cand[c0 + i]], s_surv[i]);
    }
  }
  if (stats) {
    const unsigned kw = __reduce_add_sync(FULL, kept);
    if (lane == 0 && kw) atomicAdd(&stats[1], (unsigned long long)kw);
  }

  if (!valid) return;
  float x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = xe[(size_t)row * E + j];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float r = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) r = fmaf(x[j], wg[j * C + c], r);
    res[(size_t)row * C + c] = r;
  }
}

// A cudaError_t.  The CTA keeps min(K, SEG) words in dynamic shared memory;
// past the default 48 KB per block it needs the opt-in, set on every launch.
template <int F, int E, int C>
int launch(const float* phi, const float* xe, const float* qs, const float* G,
           const float* pi_det, float* res, float* surv, float* den_out,
           unsigned long long* stats, int n, int k, float thr, float floor_,
           cudaStream_t stream) {
  const int dyn = 4 * (k < SEG ? k : SEG);
  cudaError_t err = cudaFuncSetAttribute(
      gate_expert_fwd_kernel<F, E, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  const int grid = (n + TPB - 1) / TPB;
  gate_expert_fwd_kernel<F, E, C><<<grid, TPB, (size_t)dyn, stream>>>(
      phi, xe, qs, G, pi_det, res, reinterpret_cast<unsigned*>(surv), den_out,
      stats, n, k, thr, floor_);
  return (int)cudaGetLastError();
}

}  // namespace

#define SMOE_WIDTHS(X)                                                     \
  X(7, 3, 3) X(7, 1, 3) X(7, 3, 1) X(7, 1, 1)                              \
  X(13, 4, 3) X(13, 1, 3) X(13, 4, 1) X(13, 1, 1)                          \
  X(21, 5, 3) X(21, 1, 3) X(21, 5, 1) X(21, 1, 1)                          \
  X(26, 4, 3) X(26, 1, 3) X(26, 4, 1) X(26, 1, 1)

extern "C" {

// Feature widths this build instantiates: d = 2, 3, 4 (F = d^2 + d + 1),
// and F = 26 = 2 * 13, the dual-model video features at d = 3 (the
// transformed and the raw domain side by side, half of every q' row exact
// zeros, which the FMA chain multiplies through: fmaf(x, 0, acc) is acc for
// finite x); affine (E = d + 1) or constant (E = 1) experts, 1 or 3 channels.
int smoe_gate_expert_fwd_supported(int f, int e, int c) {
  const int d = f == 7 ? 2 : (f == 13 || f == 26) ? 3 : f == 21 ? 4 : 0;
  return d && (e == 1 || e == d + 1) && (c == 1 || c == 3);
}

// res (N, C) and surv (K,) are written; surv must arrive zeroed.  den_out
// (N,) and stats (2,) may be null.  Any K.  Launches on `stream` and does
// not synchronise.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a width this build lacks).
int smoe_gate_expert_fwd(const float* phi, const float* xe, const float* qs,
                         const float* G, const float* pi_det, float* res,
                         float* surv, float* den_out,
                         unsigned long long* stats, int n, int f, int e,
                         int c, int k, float thr, float floor_,
                         void* stream_ptr) {
  if (!smoe_gate_expert_fwd_supported(f, e, c) || n < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define SMOE_CASE(F_, E_, C_)                                             \
  if (f == F_ && e == E_ && c == C_)                                      \
    return launch<F_, E_, C_>(phi, xe, qs, G, pi_det, res, surv, den_out, \
                              stats, n, k, thr, floor_, s);
  SMOE_WIDTHS(SMOE_CASE)
#undef SMOE_CASE
  return (int)cudaErrorInvalidValue;
}

const char* smoe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
