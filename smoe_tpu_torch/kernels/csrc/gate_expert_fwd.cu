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
// Design: K1 is the MODE_PRODUCTION instance of the forward body in
// gate_expert_fwd_body.cuh, which K3's ablation variants
// (gate_expert_variants.cu) are the other instances of.  There: the
// candidate compaction per CTA and per segment of 8192 kernels, the
// certain-cull skip of the division, the survivor merge, and what bounds
// the kernel.  Compaction and segments keep the bits of the one loop over
// every kernel (the body's MODE_FULL_DENSE, which chip_smoke.py holds K1
// to bit for bit).  At F = 26 (the dual-model video features) the E = 4,
// C = 3 instance takes 80 registers with 48 bytes of spills and 43 KB of
// static shared memory (nvcc -Xptxas -v; PERF.md section 6).
//
// Each width has a second instance, K1's bf16 one (smoe_gate_expert_fwd_bf16,
// the body's BF16 parameter), which replaces the same TPU kernel with its
// static bf16=True (gate_expert.py:121-123, compute_dtype="bfloat16"): the
// maha from phi and q' rounded to bf16 on the tensor core (mma.sync
// m16n8k16, fp32 accumulation), all else as the fp32 instance.  At F = 26,
// E = 4, C = 3 it takes 80 registers, no spills and 39,984 B of static
// shared memory (the per-warp maha tiles; q' staged as bf16).
//
// Optional outputs: den_out (N,) receives each pixel's max(floor, sum n_w)
// for the backward K2 (gate_expert_bwd.cu), which then skips its own
// denominator pass; raw > floor is den_out > floor.  stats (2,) receives
// += (pairs visited in pass 2, surviving pairs).  Null pointers skip both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_expert_common.cuh"
#include "gate_expert_fwd_body.cuh"

namespace {

using smoe::TPB;

template <int F, int E, int C, bool BF16>
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
  smoe::gate_expert_fwd_body<F, E, C, smoe::MODE_PRODUCTION, BF16>(
      phi, xe, qs, G, pi_det, res, surv, den_out, stats, n, k, thr, floor_);
}

// A cudaError_t.  The CTA keeps min(K, SEG) words in dynamic shared memory;
// past the default 48 KB per block it needs the opt-in, set on every launch.
template <int F, int E, int C, bool BF16>
int launch(const float* phi, const float* xe, const float* qs, const float* G,
           const float* pi_det, float* res, float* surv, float* den_out,
           unsigned long long* stats, int n, int k, float thr, float floor_,
           cudaStream_t stream) {
  const int dyn = smoe::fwd_dynamic_smem(smoe::MODE_PRODUCTION, k);
  cudaError_t err = cudaFuncSetAttribute(
      gate_expert_fwd_kernel<F, E, C, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  const int grid = (n + TPB - 1) / TPB;
  gate_expert_fwd_kernel<F, E, C, BF16><<<grid, TPB, (size_t)dyn, stream>>>(
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

extern "C" int smoe_gate_expert_fwd_supported(int f, int e, int c);

// Every width of SMOE_WIDTHS has an fp32 and a bf16 instance: a bf16 fit may
// be of any domain.
template <bool BF16>
int dispatch(const float* phi, const float* xe, const float* qs,
             const float* G, const float* pi_det, float* res, float* surv,
             float* den_out, unsigned long long* stats, int n, int f, int e,
             int c, int k, float thr, float floor_, void* stream_ptr) {
  if (!smoe_gate_expert_fwd_supported(f, e, c) || n < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define SMOE_CASE(F_, E_, C_)                                              \
  if (f == F_ && e == E_ && c == C_)                                       \
    return launch<F_, E_, C_, BF16>(phi, xe, qs, G, pi_det, res, surv,     \
                                    den_out, stats, n, k, thr, floor_, s);
  SMOE_WIDTHS(SMOE_CASE)
#undef SMOE_CASE
  return (int)cudaErrorInvalidValue;
}

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
  return dispatch<false>(phi, xe, qs, G, pi_det, res, surv, den_out, stats,
                         n, f, e, c, k, thr, floor_, stream_ptr);
}

// The same with the maha on the bf16 tensor core (compute_dtype=
// "bfloat16"): phi and q' rounded to bf16 for the maha only.
int smoe_gate_expert_fwd_bf16(const float* phi, const float* xe,
                              const float* qs, const float* G,
                              const float* pi_det, float* res, float* surv,
                              float* den_out, unsigned long long* stats,
                              int n, int f, int e, int c, int k, float thr,
                              float floor_, void* stream_ptr) {
  return dispatch<true>(phi, xe, qs, G, pi_det, res, surv, den_out, stats, n,
                        f, e, c, k, thr, floor_, stream_ptr);
}

const char* smoe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
