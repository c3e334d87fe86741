// Device code shared by the gate+expert kernels: K1 (gate_expert_fwd.cu),
// its ablation variants K3 (gate_expert_variants.cu) and the backward K2
// (gate_expert_bwd.cu).  Sharing the maha product and the staging constants
// keeps the variant `full` on K1's exact arithmetic, so the two give the
// same bits, and keeps K2's recomputed gate on K1's bits.
//
// kernels/build.py rebuilds every library when a csrc/*.cuh header is
// newer than it.

#pragma once

#include <cuda_runtime.h>

namespace smoe {

constexpr int TPB = 256;    // pixels (threads) per CTA
constexpr int KC = 256;     // kernels staged in shared memory per chunk
constexpr unsigned FULL = 0xffffffffu;

// The certain-cull margin.  For a pixel with denominator d, a pair whose
// n_w < fl(fl(thr * d) * CULL_MARGIN) has fl(n_w / d) <= thr, so the cull
// `w > thr` drops it: fl(thr * d) is within half an ulp (2^-24 relative)
// of thr * d, the margin takes 2^-20 off, so the bound sits below thr * d
// and the exact quotient below thr, and rounding is monotone.  Such a pair
// needs no division.  This holds while thr * d is a normal float, as it is
// for thr = 0.5 / 2^precision and d >= the 1e-11 floor.
// tests/test_torch_gate_expert_cull.py checks the implication over fp32 and
// that this line holds the value it checks.
constexpr float CULL_MARGIN = 1.0f - 0x1p-20f;

// fl(fl(thr * d) * CULL_MARGIN), in that order, never contracted
__device__ __forceinline__ float cull_cut(float thr, float d) {
  return __fmul_rn(__fmul_rn(thr, d), CULL_MARGIN);
}

// F rounded up to whole float4s: staged rows of q' and phi are padded to
// FP floats with zeros, so one row is FP / 4 16-byte shared loads
__host__ __device__ constexpr int pad4(int f) { return (f + 3) & ~3; }

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

// phi . q' with q' (or phi) a padded row in shared memory, 16-byte aligned:
// the same FMA chain as maha_term (j = 0 .. F-1 in order, the padding never
// enters), read as float4s.  Returns the raw product, before the clamp.
template <int F>
__device__ __forceinline__ float dot_padded(const float (&x)[F],
                                            const float* __restrict__ row) {
  constexpr int FP = pad4(F);
  float r[FP];
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < FP / 4; ++i) {
    const float4 v = r4[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
  float mh = 0.f;
#pragma unroll
  for (int j = 0; j < F; ++j) mh = fmaf(x[j], r[j], mh);
  return mh;
}

// Stage rows [k0, k0 + kc) of a (K, F) matrix into a (kc, FP) shared tile,
// zero-padded.  `idx`, when given, names the source row of each staged row.
template <int F, int NT>
__device__ __forceinline__ void stage_padded(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             int k0, int kc,
                                             const int* __restrict__ idx) {
  constexpr int FP = pad4(F);
  for (int i = threadIdx.x; i < kc * FP; i += NT) {
    const int r = i / FP, j = i - r * FP;
    const int row = idx ? idx[k0 + r] : k0 + r;
    dst[i] = j < F ? src[(size_t)row * F + j] : 0.f;
  }
}

}  // namespace smoe
