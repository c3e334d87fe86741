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
// Design.  Every mode is an instance of the forward body K1 is built from
// (gate_expert_fwd_body.cuh; K1 is its MODE_PRODUCTION): this file holds
// no loop of its own, only the kernel entry, the launch and the instance
// list.  full and exp2 keep K1's candidate compaction and certain-cull skip
// and drop only the survivor merge, the denominator and stats outputs and
// the xe mix, so K1 - full measures those on this card, and full gives
// K1's bits (xe = 1, mask = 1).  no_cull keeps the denominator pass and
// visits every kernel (no cull, so no candidates); no_norm and no_exp take
// one pass over every kernel.  Mode 5, the body's FULL_DENSE (full without
// compaction: the one loop over every kernel), is the witness chip_smoke.py
// holds K1's compaction and segments to; it is not an ablation and
// kernels/gate_expert_variants.py does not offer it.  Built without
// --use_fast_math.
//
// What bounds each mode: smoe_tpu_torch/diag/contraction.py:mode_bound
// reckons its least fp32 and SFU (MUFU) work and its bytes from the pairs
// P = N * K and the survivors; every mode is bound by the FP32 and SFU
// pipes, none by memory.  no_cull, no_norm and no_exp mix every pair (E*C
// FMAs each), where full mixes only the survivors, so on raster-ordered
// pixels, where most pairs are culled, they may run SLOWER than full: on
// the TPU's dense MXU product the cull saved nothing, on this card it
// saves the mixing and, through the candidates, pass 2 itself.  That is a
// finding of the ablation, not a fault.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_expert_common.cuh"
#include "gate_expert_fwd_body.cuh"

namespace {

using smoe::TPB;

constexpr int C = 3;  // the TPU variant's fixed channel count

template <int F, int E, int MODE>
__global__ void __launch_bounds__(TPB)
gate_expert_variant_kernel(const float* __restrict__ phi,     // (N, F)
                           const float* __restrict__ qs,      // (K, F) prescaled
                           const float* __restrict__ G,       // (K, E*C)
                           const float* __restrict__ pi_det,  // (K,)
                           float* __restrict__ res,           // (N, C)
                           int n, int k, float thr, float floor_) {
  smoe::gate_expert_fwd_body<F, E, C, MODE>(phi, nullptr, qs, G, pi_det, res,
                                            nullptr, nullptr, nullptr, n, k,
                                            thr, floor_);
}

template <int F, int E, int MODE>
cudaError_t launch(const float* phi, const float* qs, const float* G,
                   const float* pi_det, float* res, int n, int k, float thr,
                   float floor_, cudaStream_t stream) {
  const int dyn = smoe::fwd_dynamic_smem(MODE, k);
  cudaError_t err = cudaFuncSetAttribute(
      gate_expert_variant_kernel<F, E, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  const int grid = (n + TPB - 1) / TPB;
  gate_expert_variant_kernel<F, E, MODE><<<grid, TPB, (size_t)dyn, stream>>>(
      phi, qs, G, pi_det, res, n, k, thr, floor_);
  return cudaGetLastError();
}

template <int F, int E>
cudaError_t launch_mode(int mode, const float* phi, const float* qs,
                        const float* G, const float* pi_det, float* res, int n,
                        int k, float thr, float floor_, cudaStream_t s) {
#define SMOE_MODE(M)                                                     \
  case smoe::M:                                                          \
    return launch<F, E, smoe::M>(phi, qs, G, pi_det, res, n, k, thr,     \
                                 floor_, s);
  switch (mode) {
    SMOE_MODE(MODE_FULL)
    SMOE_MODE(MODE_EXP2)
    SMOE_MODE(MODE_NO_CULL)
    SMOE_MODE(MODE_NO_NORM)
    SMOE_MODE(MODE_NO_EXP)
    SMOE_MODE(MODE_FULL_DENSE)
  }
#undef SMOE_MODE
  return cudaErrorInvalidValue;
}

}  // namespace

// K1's C = 3 widths (gate_expert_fwd.cu SMOE_WIDTHS): d = 2, 3, 4
// (F = d^2 + d + 1) and the dual-model F = 26; E = d + 1 or 1
#define SMOE_VARIANT_WIDTHS(X) \
  X(7, 3) X(7, 1) X(13, 4) X(13, 1) X(21, 5) X(21, 1) X(26, 4) X(26, 1)

extern "C" {

// Widths this build instantiates (SMOE_VARIANT_WIDTHS, EC = E * 3); modes
// 0-4 in the order full, exp2, no_cull, no_norm, no_exp, and 5, the
// witness full without compaction.
int smoe_gate_expert_variant_supported(int f, int ec, int mode) {
  const int d = f == 7 ? 2 : (f == 13 || f == 26) ? 3 : f == 21 ? 4 : 0;
  return d && (ec == C || ec == C * (d + 1)) && mode >= smoe::MODE_FULL &&
         mode <= smoe::MODE_FULL_DENSE;
}

// res (N, 3) is written.  Any K.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a width or mode this build lacks).
int smoe_gate_expert_variant(const float* phi, const float* qs, const float* G,
                             const float* pi_det, float* res, int n, int f,
                             int ec, int k, int mode, float thr, float floor_,
                             void* stream_ptr) {
  if (!smoe_gate_expert_variant_supported(f, ec, mode) || n < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define SMOE_CASE(F_, E_)                                                   \
  if (f == F_ && ec == E_ * C)                                              \
    return (int)launch_mode<F_, E_>(mode, phi, qs, G, pi_det, res, n, k,    \
                                    thr, floor_, s);
  SMOE_VARIANT_WIDTHS(SMOE_CASE)
#undef SMOE_CASE
  return (int)cudaErrorInvalidValue;
}

const char* smoe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
