// Fused SMoE gate + expert backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel smoe_tpu/kernels/gate_expert.py::_bwd_kernel
// (launched by _bwd_call, wrapped by _fused_bwd).  Same function, not the
// same block layout.  It recomputes the forward of gate_expert_fwd.cu and,
// for the cotangent g (N, C) of res, returns
//
//   dq'[k]  = sum_n dn_w * n_w * clamp_f * phi_n     (K, F)  wrt the prescaled
//                                                          q' = -0.5 * mask * q
//   dG[k]   = sum_n w * dwg_n                       (K, E*C)
//   dpi[k]  = sum_n dn_w * e                        (K,)
//
// with, per (pixel n, kernel k):
//   mh_raw = phi_n . q'_k,  e = exp(min(mh_raw, 0)),  n_w = e * pi_det_k
//   raw = sum_k n_w,  denom = max(floor, raw),  live = raw > floor
//   w~ = n_w / denom,  cull = w~ > thr (straight-through),  w = w~ * cull
//   dwg_n[j*C + c] = xe_nj * g_nc,  dw = cull * (dwg_n . G_k)
//   s_n = sum_k dw * w~,  dn_w = (dw - s_n * live) / denom
//   clamp_f = 1 below the tie, 0.5 at mh_raw == 0, 0 above (jnp.minimum's
//   subgradient; gate_expert.py:292-297).
//
// Design.  The sum s_n needs a full pass over K before any dn_w exists, and
// every output is a sum over all N pixels.  The TPU kernel walked pixel
// tiles in sequence and carried the sums in its output block; CTAs here run
// in parallel and in no order, and float atomics would make runs
// irreproducible (the trainer's kernel lists and k_cap feed back on the
// gradients).  So three launches, each summing in a fixed order:
//
//   A  pixel pass, one thread per pixel, q'/G/pi_det staged in shared
//      memory KC kernels at a time as K1 stages them.  The denominator is
//      K1's: the caller hands K2 the (N,) buffer K1 wrote for the same
//      inputs (live is denom > floor, which equals raw > floor).  One pass
//      over K sums s_n, skipping the division and the dw dot wherever
//      n_w < cull_cut(thr, denom): such a pair is certainly culled
//      (gate_expert_common.cuh: CULL_MARGIN) and added an exact zero.
//      Writes (denom, cut, s_n * live, dn0) per pixel, dn0 = (0 - s_n * live)
//      / denom: the dn_w of every culled pair, bit for bit.
//   B  kernel-major accumulate: each thread owns KPT kernels (their q', G,
//      pi and F + E*C + 1 running sums in registers); a CTA of KB kernels
//      walks a fixed set of TP-pixel tiles (grid-stride over tiles, S pixel
//      splits) staged in shared memory (phi rows padded to whole float4s),
//      every thread reading the same pixel (broadcast, no bank conflicts),
//      so each staged pixel serves KPT pairs.  A pair whose exp underflows
//      to exact 0 contributes exact zeros to every sum and is skipped; a
//      pair with n_w < cut takes dn_w = dn0, without either division.  No
//      shuffles, no atomics: each sum is sequential over that CTA's pixels.
//      Partials go to a (S, V, K) buffer, V = F + E*C + 1, k fastest so the
//      stores coalesce.
//   C  fixed-order reduce over the S splits, one thread per (v, k).
//
// S is chosen so that about 8 CTAs of KB kernels sit on each of the 132
// SMs, and at most 512, which bounds the partial buffer (S*V*K*4 bytes: 9 MB
// at 512^2 x K256 d2, 20 MB at K2304 d4) and the reduce's serial length.
// The split of the pixels is the same as with one kernel per thread, so the
// sums keep the order (and the bits) they had then.  Each sum is a plain fp32
// chain: a CTA adds a few thousand pixels (3,800 at 811,008 pixels x 640
// kernels), so where a gradient's terms cancel over the pixels (a video fit's
// motion-plane kernels: the magnitudes' sum is ~80 times the result) the
// result carries ~1e-5 of the magnitudes' sum, measured 4e-4 of max |dq'|
// against an fp64 sum on an H100.
//
// Every product is an fp32 FMA or an explicitly rounded fp32 op: no tensor
// cores, no TF32 (the quadratic-feature maha cancels A^2-scale terms).
// Built without --use_fast_math: expf, IEEE division.
//
// BF16 (the bf16 instance, compute_dtype="bfloat16"; the TPU kernel's
// bf16=True, smoe_tpu/kernels/gate_expert.py:246-247): the recomputed maha
// comes from the bf16 tensor core through gate_expert_common.cuh's routine
// K1's bf16 instance uses, so it has K1's bits and K2 re-decides K1's cull
// alike.  Pass A as K1's pass 1 (the warp's pixels as A fragments, a
// (32, 8) tile every eighth kernel); pass B stages the CTA's KB kernels'
// q' and each tile's pixels as bf16, and per 16-pixel sub-tile each warp
// forms the maha of its threads' kernels (columns t and t + TK of a
// (16, KB) tile), read by the unchanged per-thread code; q' then needs no
// registers (at F = 26, E = 4, C = 3 pass B takes 204 registers against
// the fp32 instance's 253).  dq' sums over the fp32 phi, as the TPU
// kernel's (:300).  Bound: the 2 D tensor-core flops of a pair's maha
// (989 TFLOP/s) are small beside the fp32 work that stays (67 TFLOP/s).

// What bounds it (a reckoning, not a measurement).  Per (pixel, kernel)
// pair: two maha recomputations (2F FMAs), two expf, the dpi and dq'
// accumulation (F + 2 FMAs) in pass B; the divisions and the dw dots only
// where the pair may survive.  At 512^2 x 256 that is 6.7e7 pairs against
// ~14 MB of input: compute / SFU bound like K1.  At F = 26 (the dual-model
// video features, half of every q' row exact zeros, multiplied through)
// pass B keeps 2 x (26 + 12) coefficients and as many sums per thread: 253
// registers at E = 4, C = 3, no spills, four CTAs of 64 threads an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_expert_common.cuh"

namespace {

using smoe::KC;
using smoe::TPB;            // pass A: pixels (threads) per CTA
constexpr int KPT = 2;      // pass B: kernels per thread
constexpr int TK = 64;      // pass B: threads per CTA
constexpr int KB = TK * KPT;   // pass B: kernels per CTA
constexpr int TP = 128;     // pass B: pixels per staged tile
constexpr int TARGET_CTAS = 132 * 8;
// BF16 pass B: rows of the (16 pixels, KB kernels) maha tile are MT_LDB
// floats apart (4 more than KB: a warp's stores spread over the banks)
constexpr int MT_LDB = KB + 4;
static_assert(TK == 64 && KPT == 2,
              "BF16 pass B: two warps, each the columns t and t + TK");
constexpr int MAX_SPLITS = 512;

int num_splits(int n, int k) {
  const int n_tiles = (n + TP - 1) / TP;
  const int kb = (k + KB - 1) / KB;
  int s = (TARGET_CTAS + kb - 1) / kb;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > n_tiles) s = n_tiles;
  return s < 1 ? 1 : s;
}

// ---- A: per-pixel denominator, s_n and the culled pairs' dn_w -----------
template <int F, int E, int C, bool BF16>
__global__ void __launch_bounds__(TPB)
bwd_pixel_kernel(const float* __restrict__ phi, const float* __restrict__ xe,
                 const float* __restrict__ qs, const float* __restrict__ G,
                 const float* __restrict__ pi_det,
                 const float* __restrict__ g,
                 const float* __restrict__ den_in,   // (N,) K1's
                 float4* __restrict__ pix, int n, int k, float thr,
                 float floor_) {
  constexpr int EC = E * C;
  constexpr int FP = smoe::pad4(F);
  constexpr int D = smoe::bf16_depth(F);
  static_assert(KC == TPB, "BF16 stages the CTA's pixels in s_q");
  // q' rows of FP floats, or (BF16) of D bf16s, as K1 stages them
  __shared__ __align__(16) float s_q[BF16 ? KC * D / 2 : KC * FP];
  __shared__ float s_G[KC * EC];
  __shared__ float s_pi[KC];

  const int row = blockIdx.x * TPB + threadIdx.x;
  const bool valid = row < n;
  float ph[F];
  smoe::FragA<D> afr[2];  // BF16: the warp's 32 pixels, K1's A fragments
  float* s_mt = nullptr;  // BF16: the warp's (32, 8) maha tile
  __nv_bfloat16* const s_qb = reinterpret_cast<__nv_bfloat16*>(s_q);
  if constexpr (BF16) {
    __shared__ float s_tile[TPB * smoe::MT_LD];
    s_mt = s_tile + (threadIdx.x >> 5) * 32 * smoe::MT_LD;
    smoe::pixel_frags_bf16<F, TPB>(afr, s_qb, phi, blockIdx.x * TPB, n);
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) ph[j] = valid ? phi[(size_t)row * F + j] : 0.f;
  }

  const float denom = valid ? den_in[row] : floor_;
  const float cut = smoe::cull_cut(thr, denom);

  float dwg[EC];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const float x = valid ? xe[(size_t)row * E + j] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dwg[j * C + c] = __fmul_rn(x, valid ? g[(size_t)row * C + c] : 0.f);
  }

  // s_n = sum_k cull * (dwg . G_k) * w~
  float s = 0.f;
  for (int k0 = 0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);
    __syncthreads();
    if constexpr (BF16)
      smoe::stage_bf16<F, TPB>(s_qb, qs, k0, kc, (kc + 7) & ~7, nullptr);
    else
      smoe::stage_padded<F, TPB>(s_q, qs, k0, kc, nullptr);
    for (int i = threadIdx.x; i < kc * EC; i += TPB) s_G[i] = G[(size_t)k0 * EC + i];
    for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float mh;
      if constexpr (BF16)
        mh = smoe::pixel_maha_bf16<D>(afr, s_qb, s_mt, kk);
      else
        mh = smoe::dot_padded<F>(ph, s_q + kk * FP);
      const float n_w = __fmul_rn(expf(fminf(mh, 0.f)), s_pi[kk]);
      if (n_w < cut) continue;    // certainly culled: adds an exact zero
      const float wt = __fdiv_rn(n_w, denom);
      if (wt > thr) {             // culled pairs add exact zeros
        const float* gk = s_G + kk * EC;
        float dw = 0.f;
#pragma unroll
        for (int j = 0; j < EC; ++j) dw = fmaf(dwg[j], gk[j], dw);
        s = fmaf(dw, wt, s);
      }
    }
  }
  if (valid) {
    const float sl = denom > floor_ ? s : 0.f;
    pix[row] = make_float4(denom, cut, sl,
                           __fdiv_rn(__fsub_rn(0.f, sl), denom));
  }
}

// ---- B: kernel-major accumulation over a fixed set of pixel tiles --------
template <int F, int E, int C, bool BF16>
__global__ void __launch_bounds__(TK)
bwd_accum_kernel(const float* __restrict__ phi, const float* __restrict__ xe,
                 const float* __restrict__ qs, const float* __restrict__ G,
                 const float* __restrict__ pi_det,
                 const float* __restrict__ g, const float4* __restrict__ pix,
                 float* __restrict__ part, int n, int k, float thr) {
  constexpr int EC = E * C;
  constexpr int FP = smoe::pad4(F);
  constexpr int V = F + EC + 1;
  constexpr int D = smoe::bf16_depth(F);
  __shared__ __align__(16) float s_phi[TP * FP];
  __shared__ float s_dwg[TP * EC];
  __shared__ float4 s_px[TP];     // (denom, cut, s_n * live, dn0)
  // BF16: the tile's pixels and the CTA's KB kernels as bf16 rows of depth
  // D, and the (16 pixels, KB kernels) maha of one sub-tile
  __nv_bfloat16* s_phib = nullptr;
  __nv_bfloat16* s_qkb = nullptr;
  float* s_mt = nullptr;
  if constexpr (BF16) {
    __shared__ __align__(16) __nv_bfloat16 s_pb[TP * D];
    __shared__ __align__(16) __nv_bfloat16 s_kb[KB * D];
    __shared__ float s_tile[16 * MT_LDB];
    s_phib = s_pb;
    s_qkb = s_kb;
    s_mt = s_tile;
    smoe::stage_bf16<F, TK>(s_kb, qs, blockIdx.y * KB,
                            min(KB, k - (int)blockIdx.y * KB), KB, nullptr);
    // the first tile's staging below is followed by __syncthreads()
  }

  int kid[KPT];
  bool act[KPT];
  float qk[KPT][F], gk[KPT][EC], aq[KPT][F], aG[KPT][EC], pk[KPT], ap[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    kid[r] = blockIdx.y * KB + r * TK + threadIdx.x;
    act[r] = kid[r] < k;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      if constexpr (!BF16) qk[r][j] = act[r] ? qs[(size_t)kid[r] * F + j] : 0.f;
      aq[r][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < EC; ++j) {
      gk[r][j] = act[r] ? G[(size_t)kid[r] * EC + j] : 0.f;
      aG[r][j] = 0.f;
    }
    pk[r] = act[r] ? pi_det[kid[r]] : 0.f;
    ap[r] = 0.f;
  }

  const int n_tiles = (n + TP - 1) / TP;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int r0 = t * TP;
    const int rows = min(TP, n - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * FP; i += TK) {
      const int p = i / FP, j = i - p * FP;
      s_phi[i] = j < F ? phi[(size_t)(r0 + p) * F + j] : 0.f;
    }
    for (int i = threadIdx.x; i < rows * EC; i += TK) {
      const int p = i / EC, jc = i - p * EC;
      const int j = jc / C, c = jc - j * C;
      s_dwg[i] = __fmul_rn(xe[(size_t)(r0 + p) * E + j],
                           g[(size_t)(r0 + p) * C + c]);
    }
    for (int i = threadIdx.x; i < rows; i += TK) s_px[i] = pix[r0 + i];
    if constexpr (BF16)
      smoe::stage_bf16<F, TK>(s_phib, phi, r0, rows, TP, nullptr);
    __syncthreads();
    // act[0] is false only if every act[r] is; BF16 keeps such threads for
    // the warp's mma
    if (!BF16 && !act[0]) continue;
    for (int p = 0; p < rows; ++p) {
      if constexpr (BF16) {
        if ((p & 15) == 0) {
          // the sub-tile's maha: this warp's columns t and t + TK of the
          // tile, the kernels its threads read
          const int w = threadIdx.x >> 5;
          smoe::FragA<D> a[1];
          __syncwarp();
          smoe::load_frag_a<D>(a[0], s_phib + p * D);
          smoe::maha_bf16_tile<D, 1, 4>(a, s_qkb + 32 * w * D, s_mt + 32 * w,
                                        MT_LDB);
          smoe::maha_bf16_tile<D, 1, 4>(a, s_qkb + (TK + 32 * w) * D,
                                        s_mt + TK + 32 * w, MT_LDB);
          __syncwarp();
        }
      }
      float ph[FP];
      const float4* ph4 = reinterpret_cast<const float4*>(s_phi + p * FP);
#pragma unroll
      for (int i = 0; i < FP / 4; ++i) {
        const float4 v = ph4[i];
        ph[4 * i] = v.x;
        ph[4 * i + 1] = v.y;
        ph[4 * i + 2] = v.z;
        ph[4 * i + 3] = v.w;
      }
      const float4 px = s_px[p];
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        if (!act[r]) continue;
        float mh = 0.f;
        if constexpr (BF16) {
          mh = s_mt[(p & 15) * MT_LDB + r * TK + threadIdx.x];
        } else {
#pragma unroll
          for (int j = 0; j < F; ++j) mh = fmaf(ph[j], qk[r][j], mh);
        }
        const float e = expf(fminf(mh, 0.f));
        if (e == 0.f) continue;    // every contribution is an exact zero
        const float n_w = __fmul_rn(e, pk[r]);
        float dn = px.w;           // certainly culled: dn0
        if (!(n_w < px.y)) {
          const float wt = __fdiv_rn(n_w, px.x);
          float dwt = 0.f;
          if (wt > thr) {
            const float* dg = s_dwg + p * EC;
            float dw = 0.f;
#pragma unroll
            for (int j = 0; j < EC; ++j) dw = fmaf(dg[j], gk[r][j], dw);
            dwt = dw;
#pragma unroll
            for (int j = 0; j < EC; ++j) aG[r][j] = fmaf(wt, dg[j], aG[r][j]);
          }
          dn = __fdiv_rn(__fsub_rn(dwt, px.z), px.x);
        }
        ap[r] = fmaf(dn, e, ap[r]);
        const float cf = mh < 0.f ? 1.f : (mh == 0.f ? 0.5f : 0.f);
        const float tq = __fmul_rn(__fmul_rn(dn, n_w), cf);
#pragma unroll
        for (int j = 0; j < F; ++j) aq[r][j] = fmaf(tq, ph[j], aq[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    if (!act[r]) continue;
    float* out = part + (size_t)blockIdx.x * V * k + kid[r];
#pragma unroll
    for (int j = 0; j < F; ++j) out[(size_t)j * k] = aq[r][j];
#pragma unroll
    for (int j = 0; j < EC; ++j) out[(size_t)(F + j) * k] = aG[r][j];
    out[(size_t)(F + EC) * k] = ap[r];
  }
}

// ---- C: fixed-order reduce over the pixel splits -------------------------
__global__ void bwd_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ dq,
                                  float* __restrict__ dG,
                                  float* __restrict__ dpi, int splits, int f,
                                  int ec, int k) {
  const int v_count = f + ec + 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= v_count * k) return;
  const int v = idx / k, kid = idx - v * k;
  const size_t stride = (size_t)v_count * k;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * stride + idx];
  if (v < f)
    dq[(size_t)kid * f + v] = acc;
  else if (v < f + ec)
    dG[(size_t)kid * ec + (v - f)] = acc;
  else
    dpi[kid] = acc;
}

template <int F, int E, int C, bool BF16>
cudaError_t launch(const float* phi, const float* xe, const float* qs,
                   const float* G, const float* pi_det, const float* g,
                   const float* den_in, float* dq, float* dG, float* dpi,
                   int n, int k, float thr, float floor_, float* ws,
                   cudaStream_t stream) {
  constexpr int EC = E * C;
  float4* pix = reinterpret_cast<float4*>(ws);
  float* part = ws + (size_t)n * 4;
  const int splits = num_splits(n, k);
  bwd_pixel_kernel<F, E, C, BF16><<<(n + TPB - 1) / TPB, TPB, 0, stream>>>(
      phi, xe, qs, G, pi_det, g, den_in, pix, n, k, thr, floor_);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_b(splits, (k + KB - 1) / KB);
  bwd_accum_kernel<F, E, C, BF16><<<grid_b, TK, 0, stream>>>(
      phi, xe, qs, G, pi_det, g, pix, part, n, k, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = (F + EC + 1) * k;
  bwd_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      part, dq, dG, dpi, splits, F, EC, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int smoe_gate_expert_bwd_supported(int f, int e, int c);

// Every width has an fp32 and a bf16 instance, as in gate_expert_fwd.cu.
template <bool BF16>
int dispatch(const float* phi, const float* xe, const float* qs,
             const float* G, const float* pi_det, const float* g,
             const float* den, float* dq, float* dG, float* dpi, int n, int f,
             int e, int c, int k, float thr, float floor_, float* ws,
             void* stream_ptr) {
  if (!smoe_gate_expert_bwd_supported(f, e, c) || n < 0 || k < 0 ||
      (n > 0 && !den))
    return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0) {
    cudaMemsetAsync(dq, 0, sizeof(float) * (size_t)k * f, s);
    cudaMemsetAsync(dG, 0, sizeof(float) * (size_t)k * e * c, s);
    cudaMemsetAsync(dpi, 0, sizeof(float) * (size_t)k, s);
    return (int)cudaGetLastError();
  }
#define SMOE_CASE(F_, E_, C_)                                                 \
  if (f == F_ && e == E_ && c == C_)                                          \
    return (int)launch<F_, E_, C_, BF16>(phi, xe, qs, G, pi_det, g, den, dq,  \
                                         dG, dpi, n, k, thr, floor_, ws, s);
  SMOE_CASE(7, 3, 3) SMOE_CASE(7, 1, 3) SMOE_CASE(7, 3, 1) SMOE_CASE(7, 1, 1)
  SMOE_CASE(13, 4, 3) SMOE_CASE(13, 1, 3) SMOE_CASE(13, 4, 1) SMOE_CASE(13, 1, 1)
  SMOE_CASE(21, 5, 3) SMOE_CASE(21, 1, 3) SMOE_CASE(21, 5, 1) SMOE_CASE(21, 1, 1)
  SMOE_CASE(26, 4, 3) SMOE_CASE(26, 1, 3) SMOE_CASE(26, 4, 1) SMOE_CASE(26, 1, 1)
#undef SMOE_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Feature widths this build instantiates: the same as gate_expert_fwd.cu
// (F = 26 is the dual-model video width at d = 3).
int smoe_gate_expert_bwd_supported(int f, int e, int c) {
  const int d = f == 7 ? 2 : (f == 13 || f == 26) ? 3 : f == 21 ? 4 : 0;
  return d && (e == 1 || e == d + 1) && (c == 1 || c == 3);
}

// Floats of scratch the caller allocates and passes as `ws` (16-byte
// aligned): (N, 4) per-pixel values, then the (S, V, K) partial sums.
long long smoe_gate_expert_bwd_workspace(int n, int f, int e, int c, int k) {
  if (n <= 0 || k <= 0) return 1;
  const long long v = f + (long long)e * c + 1;
  return 4LL * n + (long long)num_splits(n, k) * v * k;
}

// dq (K, F), dG (K, E*C), dpi (K,) are written whole.  den (N,) is the
// forward's denominator (gate_expert_fwd.cu's den_out) for the same phi, q'
// and pi_det.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a width
// this build lacks or a null den).
int smoe_gate_expert_bwd(const float* phi, const float* xe, const float* qs,
                         const float* G, const float* pi_det, const float* g,
                         const float* den, float* dq, float* dG, float* dpi,
                         int n, int f, int e, int c, int k, float thr,
                         float floor_, float* ws, void* stream_ptr) {
  return dispatch<false>(phi, xe, qs, G, pi_det, g, den, dq, dG, dpi, n, f,
                         e, c, k, thr, floor_, ws, stream_ptr);
}

// The same with the recomputed maha on the bf16 tensor core (compute_dtype=
// "bfloat16"), as gate_expert_fwd.cu's smoe_gate_expert_fwd_bf16 computes
// it; dq' still sums over the fp32 phi.
int smoe_gate_expert_bwd_bf16(const float* phi, const float* xe,
                              const float* qs, const float* G,
                              const float* pi_det, const float* g,
                              const float* den, float* dq, float* dG,
                              float* dpi, int n, int f, int e, int c, int k,
                              float thr, float floor_, float* ws,
                              void* stream_ptr) {
  return dispatch<true>(phi, xe, qs, G, pi_det, g, den, dq, dG, dpi, n, f, e,
                        c, k, thr, floor_, ws, stream_ptr);
}

const char* smoe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
