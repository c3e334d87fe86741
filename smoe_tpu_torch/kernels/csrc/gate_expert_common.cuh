// Device code shared by the gate+expert forward kernels: K1
// (gate_expert_fwd.cu) and its ablation variants (gate_expert_variants.cu).
// Sharing the maha product and the staging constants keeps the variant
// `full` on K1's exact arithmetic, so the two give the same bits.
//
// kernels/build.py rebuilds every library when a csrc/*.cuh header is
// newer than it.

#pragma once

#include <cuda_runtime.h>

namespace smoe {

constexpr int TPB = 256;    // pixels (threads) per CTA
constexpr int KC = 256;     // kernels staged in shared memory per chunk
constexpr unsigned FULL = 0xffffffffu;

template <int F>
__device__ __forceinline__ float maha_term(const float (&ph)[F],
                                           const float* __restrict__ qk) {
  // min(phi . q', 0): q' carries the -0.5 * mask scale, so this is
  // -0.5 * max(maha, 0), the maha >= 0 clamp of the reference.
  float mh = 0.f;
#pragma unroll
  for (int j = 0; j < F; ++j) mh = fmaf(ph[j], qk[j], mh);
  return fminf(mh, 0.f);
}

}  // namespace smoe
