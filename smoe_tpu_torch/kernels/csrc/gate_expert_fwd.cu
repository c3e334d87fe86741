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
// memory KC kernels at a time, so any K works and the stage stays small
// (KC*(F + E*C + 2)*4 bytes: 18 KB at F=7, E*C=9; 38 KB at F=21, E*C=15).
// Pass 1 over K accumulates the denominator; pass 2 recomputes n_w (cheaper
// than keeping a (TPB, K) tile), applies the normalisation and the cull, and
// accumulates wg = w @ G in registers; res is formed from wg and xe at the
// end, the TPU kernel's order.  Every product is an fp32 FMA: no tensor
// cores, no TF32 — the quadratic-feature maha cancels A^2-scale terms and
// needs exact fp32.  Built without --use_fast_math: expf, IEEE division.
//
// Survivors.  The TPU kernel carried the max across its sequential grid in
// one output block.  CTAs here run in parallel, so each warp reduces w per
// kernel with one redux.sync (on the float bits: w >= 0, so the unsigned
// order is the float order), the winner lane merges it into a per-CTA max in
// shared memory, and the CTA merges that into the global max with atomicMax
// on the bit pattern.  max is order-free, so the result is deterministic.
//
// What bounds it (a reckoning, not a measurement).  Per (pixel, kernel)
// pair: 2F FMAs for the two maha passes, two expf (SFU plus range-reduction
// FMAs), one IEEE division, and E*C FMAs only where w survives the cull.
// At the 512^2 x 256-kernel flagship that is 6.7e7 pairs, ~2e9 FP32
// instructions, against ~10 MB of input (N*(F+E)*4 bytes): far above the
// card's ~20 flop/byte balance, so it is compute/SFU-bound, not memory-bound.
// The staged q'/G are read as shared-memory broadcasts (every thread of a
// warp reads the same word), which costs no bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_expert_common.cuh"

namespace {

using smoe::FULL;
using smoe::KC;
using smoe::TPB;
using smoe::maha_term;

template <int F, int E, int C>
__global__ void __launch_bounds__(TPB)
gate_expert_fwd_kernel(const float* __restrict__ phi,     // (N, F)
                       const float* __restrict__ xe,      // (N, E)
                       const float* __restrict__ qs,      // (K, F) prescaled
                       const float* __restrict__ G,       // (K, E*C)
                       const float* __restrict__ pi_det,  // (K,)
                       float* __restrict__ res,           // (N, C)
                       unsigned* __restrict__ surv,       // (K,) float bits
                       int n, int k, float thr, float floor_) {
  constexpr int EC = E * C;
  __shared__ float s_q[KC * F];
  __shared__ float s_G[KC * EC];
  __shared__ float s_pi[KC];
  __shared__ unsigned s_surv[KC];

  const int row = blockIdx.x * TPB + threadIdx.x;
  const bool valid = row < n;
  const int lane = threadIdx.x & 31;

  float ph[F];
#pragma unroll
  for (int j = 0; j < F; ++j) ph[j] = valid ? phi[(size_t)row * F + j] : 0.f;

  // pass 1: the gating denominator
  float denom = 0.f;
  for (int k0 = 0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kc * F; i += TPB) s_q[i] = qs[(size_t)k0 * F + i];
    for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk)
      denom += expf(maha_term<F>(ph, s_q + kk * F)) * s_pi[kk];
  }
  denom = fmaxf(floor_, denom);

  // pass 2: normalise, cull, mix the experts, track survivors
  float wg[EC];
#pragma unroll
  for (int j = 0; j < EC; ++j) wg[j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kc * F; i += TPB) s_q[i] = qs[(size_t)k0 * F + i];
    for (int i = threadIdx.x; i < kc * EC; i += TPB) s_G[i] = G[(size_t)k0 * EC + i];
    for (int i = threadIdx.x; i < kc; i += TPB) {
      s_pi[i] = pi_det[k0 + i];
      s_surv[i] = 0u;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float w = expf(maha_term<F>(ph, s_q + kk * F)) * s_pi[kk] / denom;
      if (!(w > thr) || !valid) w = 0.f;
      // the loop over kk is uniform across the CTA, so every lane is here
      const unsigned m = __reduce_max_sync(FULL, __float_as_uint(w));
      if (lane == 0 && m) atomicMax(&s_surv[kk], m);
      if (w > 0.f) {
        // skipping culled pairs adds exact zeros only
        const float* g = s_G + kk * EC;
#pragma unroll
        for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kc; i += TPB)
      if (s_surv[i]) atomicMax(&surv[k0 + i], s_surv[i]);
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

template <int F, int E, int C>
cudaError_t launch(const float* phi, const float* xe, const float* qs,
                   const float* G, const float* pi_det, float* res,
                   float* surv, int n, int k, float thr, float floor_,
                   cudaStream_t stream) {
  const int grid = (n + TPB - 1) / TPB;
  gate_expert_fwd_kernel<F, E, C><<<grid, TPB, 0, stream>>>(
      phi, xe, qs, G, pi_det, res, reinterpret_cast<unsigned*>(surv), n, k,
      thr, floor_);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Feature widths this build instantiates: d = 2, 3, 4 (F = d^2 + d + 1),
// affine (E = d + 1) or constant (E = 1) experts, 1 or 3 channels.
int smoe_gate_expert_fwd_supported(int f, int e, int c) {
  const int d = f == 7 ? 2 : f == 13 ? 3 : f == 21 ? 4 : 0;
  return d && (e == 1 || e == d + 1) && (c == 1 || c == 3);
}

// res (N, C) and surv (K,) are written; surv must arrive zeroed.  Launches
// on `stream` and does not synchronise.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a width this build lacks).
int smoe_gate_expert_fwd(const float* phi, const float* xe, const float* qs,
                         const float* G, const float* pi_det, float* res,
                         float* surv, int n, int f, int e, int c, int k,
                         float thr, float floor_, void* stream_ptr) {
  if (!smoe_gate_expert_fwd_supported(f, e, c) || n < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define SMOE_CASE(F_, E_, C_)                                              \
  if (f == F_ && e == E_ && c == C_)                                       \
    return (int)launch<F_, E_, C_>(phi, xe, qs, G, pi_det, res, surv, n, k, \
                                   thr, floor_, s);
  SMOE_CASE(7, 3, 3) SMOE_CASE(7, 1, 3) SMOE_CASE(7, 3, 1) SMOE_CASE(7, 1, 1)
  SMOE_CASE(13, 4, 3) SMOE_CASE(13, 1, 3) SMOE_CASE(13, 4, 1) SMOE_CASE(13, 1, 1)
  SMOE_CASE(21, 5, 3) SMOE_CASE(21, 1, 3) SMOE_CASE(21, 5, 1) SMOE_CASE(21, 1, 1)
#undef SMOE_CASE
  return (int)cudaErrorInvalidValue;
}

const char* smoe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
