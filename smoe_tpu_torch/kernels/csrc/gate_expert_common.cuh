// Device code shared by the gate+expert kernels: the forward body
// (gate_expert_fwd_body.cuh), of which K1 (gate_expert_fwd.cu) and its
// ablation variants K3 (gate_expert_variants.cu) are instances, and the
// backward K2 (gate_expert_bwd.cu).  Sharing the maha product and the
// staging constants keeps K2's recomputed gate on K1's bits: the fp32 FMA
// chain `dot_padded`, and the bf16 tensor-core tile `maha_bf16_tile` of the
// compute_dtype="bfloat16" instances.
//
// kernels/build.py rebuilds every library when a csrc/*.cuh header is
// newer than it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// phi . q' with q' (or phi) a padded row in shared memory, 16-byte aligned:
// one FMA a feature, j = 0 .. F-1 in order (the padding never enters), read
// as float4s.  Returns the raw product; min(., 0) of it is -0.5 * max(maha,
// 0), the maha >= 0 clamp of the reference (q' carries the -0.5 * mask).
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

// ---- the bf16 maha (compute_dtype="bfloat16") -------------------------
//
// The TPU kernels' `bf16=True` (smoe_tpu/kernels/gate_expert.py:121-123,
// 246-247) round phi and q' to bf16 for the maha product only and sum the
// products in fp32.  Hopper's counterpart is the bf16 tensor core:
// mma.sync m16n8k16 multiplies bf16 pairs exactly (8-bit significands) and
// accumulates in fp32.  Every bf16 instance takes its maha from the one
// routine below, so K1's two passes and K2's two passes see the same bits
// for a (pixel, kernel) pair as long as an mma result depends only on its
// row and column operands (chip_smoke.py holds K1's compacted result to the
// dense FULL_DENSE instance bit for bit, which is that assumption on the
// card).  Everything after the maha stays fp32.
//
// The tensor core does not round each addition to nearest as an fp32 FMA
// chain does, so a bf16 instance agrees with its plain version (an fp32
// product of the bf16-rounded operands) within a multiple of
// 2^-24 * sum_j |phi_j q'_j|, not bit for bit.

// depth of the staged bf16 operands: F zero-padded to whole k16 steps
// (16 at F = 7, 13; 32 at F = 21, 26)
__host__ __device__ constexpr int bf16_depth(int f) { return (f + 15) & ~15; }

// rows of a K1 / K2-pass-A per-warp tile (one a pixel) are MT_LD floats
// apart: 9 is odd, so 32 lanes reading column c hit 32 different banks
constexpr int MT_LD = 9;

// Stage rows [r0, r0 + rc) of a (rows, F) fp32 matrix (or rows idx[r0 + r])
// as bf16 rows of depth bf16_depth(F), rounded to nearest even; features F..
// and rows rc .. rp - 1 are zeros (a dead kernel, a pixel past N).
template <int F, int NT>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int r0, int rc, int rp,
                                           const int* __restrict__ idx) {
  constexpr int D = bf16_depth(F);
  for (int i = threadIdx.x; i < rp * D; i += NT) {
    const int r = i / D, j = i - r * D;
    float v = 0.f;
    if (r < rc && j < F) v = src[(size_t)(idx ? idx[r0 + r] : r0 + r) * F + j];
    dst[i] = __float2bfloat16_rn(v);
  }
}

// A operands of one m16 tile of the mma: rows [0, 16) of a staged (rows, D)
// bf16 matrix, in the m16n8k16 fragment layout (lane = 4 g + t holds rows g
// and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of each k-step).
template <int D>
struct FragA {
  uint32_t r[D / 16][4];
};

template <int D>
__device__ __forceinline__ void load_frag_a(FragA<D>& f,
                                            const __nv_bfloat16* a) {
  constexpr int RW = D / 2;  // 32-bit words a row
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    f.r[s][0] = w[g * RW + 8 * s + t];
    f.r[s][1] = w[(g + 8) * RW + 8 * s + t];
    f.r[s][2] = w[g * RW + 8 * s + 4 + t];
    f.r[s][3] = w[(g + 8) * RW + 8 * s + 4 + t];
  }
}

// d += a * b on the bf16 tensor core: exact products, fp32 accumulation
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 maha of one warp: MT m16 tiles of pixels (the A fragments a)
// against kernels [0, 8 NB) of a staged (kernels, D) bf16 q' tile b, each
// (pixel, kernel) accumulated from 0 over the k-steps 0 .. D/16 - 1 in that
// order, written to out[(16 m + row) * ld + kernel].  Raw phi . q': min(., 0)
// of it is -0.5 * max(maha, 0), as dot_padded's.  Every lane of the warp
// must be here, converged (the callers __syncwarp() first).
template <int D, int MT, int NB>
__device__ __forceinline__ void maha_bf16_tile(const FragA<D> (&a)[MT],
                                               const __nv_bfloat16* b,
                                               float* out, int ld) {
  constexpr int RW = D / 2;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(b);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    uint32_t b0[D / 16], b1[D / 16];
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      b0[s] = w[(8 * nb + g) * RW + 8 * s + t];
      b1[s] = w[(8 * nb + g) * RW + 8 * s + 4 + t];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < D / 16; ++s) mma_bf16_16816(d, a[m].r[s], b0[s], b1[s]);
      float* o = out + (16 * m + g) * ld + 8 * nb + 2 * t;
      o[0] = d[0];
      o[1] = d[1];
      o[8 * ld] = d[2];
      o[8 * ld + 1] = d[3];
    }
  }
}

// Where a thread is a pixel (K1, K2's pass A): the CTA's NT pixels, rows
// r0 .. of phi (those past N zero), as each warp's A fragments (its 32 rows,
// two m16 tiles).  Stages them through `stage` (NT rows of D bf16s) and
// syncs the CTA; the next write to `stage` must follow a __syncthreads().
template <int F, int NT>
__device__ __forceinline__ void pixel_frags_bf16(
    FragA<bf16_depth(F)> (&a)[2], __nv_bfloat16* stage,
    const float* __restrict__ phi, int r0, int n) {
  constexpr int D = bf16_depth(F);
  stage_bf16<F, NT>(stage, phi, r0, min(NT, n - r0), NT, nullptr);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  load_frag_a<D>(a[0], stage + warp * 32 * D);
  load_frag_a<D>(a[1], stage + (warp * 32 + 16) * D);
}

// ... and the raw maha of this thread's pixel with staged kernel kk of q
// (kk = 0, 1, ... in order, uniformly over the warp): the warp's (32, 8)
// tile (rows MT_LD floats apart) is formed at every eighth kernel.
template <int D>
__device__ __forceinline__ float pixel_maha_bf16(const FragA<D> (&a)[2],
                                                 const __nv_bfloat16* q,
                                                 float* tile, int kk) {
  if ((kk & 7) == 0) {
    __syncwarp();
    maha_bf16_tile<D, 2, 1>(a, q + kk * D, tile, MT_LD);
    __syncwarp();
  }
  return tile[(threadIdx.x & 31) * MT_LD + (kk & 7)];
}

}  // namespace smoe
