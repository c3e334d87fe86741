// Ablation variants of the fused gate + expert forward (K3) for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel scripts/bench_contraction.py::_variant_kernel
// (launched by variant_call).  It times K1's forward with parts removed, to
// tell where K1's time goes on the card.  For every pixel n and kernel k:
//
//   mh  = min(phi_n . q'_k, 0)      q' = -0.5 q, or -0.5 log2(e) q in exp2;
//                                   prescaled by the caller
//   MODE      w
//   full      cull(n_w / max(floor, sum_k n_w)),  n_w = exp(mh) * pi_det_k
//   exp2      the same with exp2f
//   no_cull   n_w / max(floor, sum_k n_w)
//   no_norm   n_w                  (no denominator pass, no division, no cull)
//   no_exp    mh                   (no exp either)
//   res_n[c] = sum_j (sum_k w G_k)[j*C + c],  C = 3: the TPU variant folds
//              the xe mix into a fixed sum, so every mode has the same tail.
//
// Design.  The mode is a template parameter of K1's plain two-pass loop:
// one thread per pixel, q', G and pi_det staged through shared memory KC
// kernels at a time, pass 1 for the denominator, pass 2 to normalise, cull
// and mix with fp32 FMAs over every kernel.  (K1 itself, gate_expert_fwd.cu,
// now visits in pass 2 only its CTA's candidate kernels and skips certain
// culls, which keeps this loop's bits.)  The maha product and the staging
// constants come from gate_expert_common.cuh, shared with K1, so `full`
// gives K1's bits (xe = 1, mask = 1).  A mode drops only what it
// drops: no_norm and no_exp skip pass 1 and the division, no_exp also
// skips expf, exp2 calls exp2f.  Survivor tracking and the xe mix are left
// out, as the TPU variant does, so K1 - full measures K1's survivor merge
// and xe tail on this card.  Built without --use_fast_math.
//
// What bounds each mode (a reckoning; the attribution tool
// smoe_tpu_torch/diag/contraction.py measures it).  Per (pixel, kernel) pair
// `full` pays 2F FMAs for the two maha passes, two expf (SFU plus
// range-reduction FMAs), one IEEE division (a multi-instruction sequence),
// and E*C FMAs where w survives; at the flagship that is ~2e9 FP32
// instructions against ~10 MB of input, so every mode is bound by the FP32
// and SFU pipes, none by memory.  exp2 saves expf's multiply by log2(e);
// no_cull the compare; no_norm the whole first pass and the division;
// no_exp also both exponentials.
//
// Why no_cull and no_exp may run SLOWER than full here.  K1 skips the E*C
// FMAs of a culled pair (gate_expert_fwd.cu, pass 2), and so does `full`;
// no_cull and no_exp mix every pair (no_exp's w = mh <= 0 is never culled).
// On the TPU's dense MXU product the cull saved nothing, so removing it
// could only make the kernel faster; on this card it removes a saving.
// That is a finding of the ablation, not a fault.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_expert_common.cuh"

namespace {

using smoe::KC;
using smoe::TPB;
using smoe::maha_term;

constexpr int C = 3;  // the TPU variant's fixed channel count

enum Mode { FULL_ = 0, EXP2 = 1, NO_CULL = 2, NO_NORM = 3, NO_EXP = 4 };

template <int MODE>
__device__ __forceinline__ float gate_exp(float mh) {
  if constexpr (MODE == EXP2) return exp2f(mh);
  else return expf(mh);
}

template <int F, int EC, int MODE>
__global__ void __launch_bounds__(TPB)
gate_expert_variant_kernel(const float* __restrict__ phi,     // (N, F)
                           const float* __restrict__ qs,      // (K, F) prescaled
                           const float* __restrict__ G,       // (K, EC)
                           const float* __restrict__ pi_det,  // (K,)
                           float* __restrict__ res,           // (N, C)
                           int n, int k, float thr, float floor_) {
  constexpr bool NORM = MODE == FULL_ || MODE == EXP2 || MODE == NO_CULL;
  constexpr bool PI = MODE != NO_EXP;
  __shared__ float s_q[KC * F];
  __shared__ float s_G[KC * EC];
  __shared__ float s_pi[KC];

  const int row = blockIdx.x * TPB + threadIdx.x;
  const bool valid = row < n;

  float ph[F];
#pragma unroll
  for (int j = 0; j < F; ++j) ph[j] = valid ? phi[(size_t)row * F + j] : 0.f;

  // pass 1: the gating denominator (K1's loop and op order)
  float denom = 1.f;
  if constexpr (NORM) {
    denom = 0.f;
    for (int k0 = 0; k0 < k; k0 += KC) {
      const int kc = min(KC, k - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < kc * F; i += TPB) s_q[i] = qs[(size_t)k0 * F + i];
      for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk)
        denom += gate_exp<MODE>(maha_term<F>(ph, s_q + kk * F)) * s_pi[kk];
    }
    denom = fmaxf(floor_, denom);
  }

  // pass 2: the weights of the mode, mixed into wg = w @ G
  float wg[EC];
#pragma unroll
  for (int j = 0; j < EC; ++j) wg[j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kc * F; i += TPB) s_q[i] = qs[(size_t)k0 * F + i];
    for (int i = threadIdx.x; i < kc * EC; i += TPB) s_G[i] = G[(size_t)k0 * EC + i];
    if constexpr (PI)
      for (int i = threadIdx.x; i < kc; i += TPB) s_pi[i] = pi_det[k0 + i];
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float* g = s_G + kk * EC;
      if constexpr (MODE == NO_EXP) {
        const float w = maha_term<F>(ph, s_q + kk * F);
#pragma unroll
        for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
      } else if constexpr (MODE == NO_NORM) {
        const float w = gate_exp<MODE>(maha_term<F>(ph, s_q + kk * F)) * s_pi[kk];
#pragma unroll
        for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
      } else if constexpr (MODE == NO_CULL) {
        const float w = gate_exp<MODE>(maha_term<F>(ph, s_q + kk * F)) * s_pi[kk] / denom;
#pragma unroll
        for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
      } else {
        // full / exp2: K1's pass 2 without the survivor merge
        float w = gate_exp<MODE>(maha_term<F>(ph, s_q + kk * F)) * s_pi[kk] / denom;
        if (!(w > thr)) w = 0.f;
        if (w > 0.f) {
          // skipping culled pairs adds exact zeros only
#pragma unroll
          for (int j = 0; j < EC; ++j) wg[j] = fmaf(w, g[j], wg[j]);
        }
      }
    }
  }

  if (!valid) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float r = 0.f;
#pragma unroll
    for (int j = 0; j < EC / C; ++j) r += wg[j * C + c];
    res[(size_t)row * C + c] = r;
  }
}

template <int F, int EC, int MODE>
cudaError_t launch(const float* phi, const float* qs, const float* G,
                   const float* pi_det, float* res, int n, int k, float thr,
                   float floor_, cudaStream_t stream) {
  const int grid = (n + TPB - 1) / TPB;
  gate_expert_variant_kernel<F, EC, MODE><<<grid, TPB, 0, stream>>>(
      phi, qs, G, pi_det, res, n, k, thr, floor_);
  return cudaGetLastError();
}

template <int F, int EC>
cudaError_t launch_mode(int mode, const float* phi, const float* qs,
                        const float* G, const float* pi_det, float* res, int n,
                        int k, float thr, float floor_, cudaStream_t s) {
  switch (mode) {
    case FULL_: return launch<F, EC, FULL_>(phi, qs, G, pi_det, res, n, k, thr, floor_, s);
    case EXP2: return launch<F, EC, EXP2>(phi, qs, G, pi_det, res, n, k, thr, floor_, s);
    case NO_CULL: return launch<F, EC, NO_CULL>(phi, qs, G, pi_det, res, n, k, thr, floor_, s);
    case NO_NORM: return launch<F, EC, NO_NORM>(phi, qs, G, pi_det, res, n, k, thr, floor_, s);
    case NO_EXP: return launch<F, EC, NO_EXP>(phi, qs, G, pi_det, res, n, k, thr, floor_, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Widths this build instantiates: d = 2, 3, 4 (F = d^2 + d + 1), affine
// (E = d + 1) or constant (E = 1) experts, C = 3 (EC = E * 3); modes 0-4 in
// the order full, exp2, no_cull, no_norm, no_exp.
int smoe_gate_expert_variant_supported(int f, int ec, int mode) {
  const int d = f == 7 ? 2 : f == 13 ? 3 : f == 21 ? 4 : 0;
  return d && (ec == 3 || ec == 3 * (d + 1)) && mode >= 0 && mode <= 4;
}

// res (N, 3) is written.  Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// width or mode this build lacks).
int smoe_gate_expert_variant(const float* phi, const float* qs, const float* G,
                             const float* pi_det, float* res, int n, int f,
                             int ec, int k, int mode, float thr, float floor_,
                             void* stream_ptr) {
  if (!smoe_gate_expert_variant_supported(f, ec, mode) || n < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define SMOE_CASE(F_, EC_)                                                  \
  if (f == F_ && ec == EC_)                                                 \
    return (int)launch_mode<F_, EC_>(mode, phi, qs, G, pi_det, res, n, k,   \
                                     thr, floor_, s);
  SMOE_CASE(7, 9) SMOE_CASE(7, 3)
  SMOE_CASE(13, 12) SMOE_CASE(13, 3)
  SMOE_CASE(21, 15) SMOE_CASE(21, 3)
#undef SMOE_CASE
  return (int)cudaErrorInvalidValue;
}

const char* smoe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
