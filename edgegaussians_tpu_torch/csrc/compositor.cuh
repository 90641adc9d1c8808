// Device helpers shared by the compositor kernels of csrc/segpair.cu (the
// seg pair runs), csrc/pair.cu (the v4 pair runs), csrc/raster_v2.cu (the
// dense slot frames) and csrc/raster_v1.cu (the v1 log-space frame), and
// the forward kernel of the two pair compositors (run_fwd_kernel).
//
// All four walk one 16x16 tile per CTA, one thread per pixel, over
// depth-ordered features f[0:8] (f32) with the gsplat rules:
//   log a = sum_{j<6} f_j * basis_j(px)          (full f32 FMAs)
//   ok = log a <= f_6 + SIGMA_GUARD_EPS;  a = exp(log a);  ok &= a >= 1/255
//   a = min(a, 0.999);  t_inc = t * (1 - a);  stop once t_inc < 1e-4
//   img += a * t;  t = t_inc
// and their backwards reduce d log a over the tile's pixels against the
// basis on the tensor cores (3xTF32 mma.sync; see csrc/segpair.cu's header
// for the measurements behind the design).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int P = 256;           // pixels of a 16x16 tile = threads per CTA
constexpr int NF = 8;            // features per pair or slot
constexpr int WARPS = P / 32;
constexpr int MT = 16;           // backward: rows side by side; the m of
                                 // m16n8k8
constexpr int KSTEPS = 4;        // a warp's 32 pixels: 4 k-steps of 8
constexpr int DSTRIDE = 36;      // row of a warp's D tile: 32 pixels + 4
constexpr int NJ = 6;            // gradient columns the reduction makes
constexpr float ALPHA_THRESHOLD = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.999f;
constexpr float TRANSMITTANCE_EPS = 1e-4f;
constexpr float SIGMA_GUARD_EPS = 1e-3f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float log_alpha(const float* f, const float* b) {
  float la = f[0] * b[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) la = fmaf(f[j], b[j], la);
  return la;
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a @ b for one m16n8k8 tile: a [16 x 8] row-major, b [8 x 8]
// column-major, in TF32 with f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The pixel reduction of the backwards, dfeats[r, j] = sum_px dla[r, px] *
// basis_j(px), as a warp's share of a [16 x 256] @ [256 x 8] product: each
// warp owns 32 pixels, i.e. 4 k-steps of m16n8k8. grp = lane / 4 and tig =
// lane % 4 index the fragments.
//
// The B fragments of warp `warp`'s pixels, B[k][n] = basis[n][32 warp + k],
// zero for n = 6, 7, each split as b_hi + b_lo; returns whether every b_lo
// of the warp is zero (the monomial basis of tiles.pixel_basis is exact in
// TF32, and then the b_lo product is skipped: adding exact zeros changes no
// bit).
__device__ __forceinline__ bool basis_fragments(const float* basis, int warp,
                                                int grp, int tig,
                                                unsigned (&bhi)[KSTEPS][2],
                                                unsigned (&blo)[KSTEPS][2]) {
  bool b_exact = true;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = grp < NJ
          ? basis[grp * P + 32 * warp + 8 * ks + tig + 4 * h] : 0.0f;
      bhi[ks][h] = to_tf32(v);
      blo[ks][h] = to_tf32(v - __uint_as_float(bhi[ks][h]));
      b_exact &= blo[ks][h] == 0u;
    }
  }
  return __all_sync(FULL_MASK, b_exact);
}

// c += D @ B for the warp's D tile [16 x 32] (row r: dla of row r for the
// warp's 32 pixels, row stride DSTRIDE, so the fragment loads hit 32
// distinct banks), in the 3xTF32 split (a = a_hi + a_lo: a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi, f32 accumulators), which keeps f32 accuracy where
// plain TF32 (10-bit mantissa) would not. c holds D @ B's columns
// 2 tig, 2 tig + 1 of rows grp (c[0], c[1]) and grp + 8 (c[2], c[3]).
__device__ __forceinline__ void tile_product(const float* dw, int grp, int tig,
                                             const unsigned (&bhi)[KSTEPS][2],
                                             const unsigned (&blo)[KSTEPS][2],
                                             bool b_exact, float (&c)[4]) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const float* d0 = dw + grp * DSTRIDE + 8 * ks + tig;
    const float av[4] = {d0[0], d0[8 * DSTRIDE], d0[4], d0[8 * DSTRIDE + 4]};
    unsigned hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = to_tf32(av[i]);
      lo[i] = to_tf32(av[i] - __uint_as_float(hi[i]));
    }
    mma_tf32(c, lo, bhi[ks][0], bhi[ks][1]);
    if (!b_exact) mma_tf32(c, hi, blo[ks][0], blo[ks][1]);
    mma_tf32(c, hi, bhi[ks][0], bhi[ks][1]);
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Zero `slots` slots of NF floats from `dst`, the start of a slot of a
// 16-byte aligned dfeats (so 16-byte aligned itself), in 16-byte stores.
__device__ __forceinline__ void zero_slots(float* dst, int slots) {
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < slots * (NF / 4); i += P)
    d[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Start copying `count` floats (a multiple of 4) from global to shared
// memory without waiting: 16 bytes a thread where both are 16-byte
// aligned, else 4 bytes.
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int count, bool vec16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec16) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * P)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d + 4 * i), "l"(src + i));
  } else {
    for (int i = threadIdx.x; i < count; i += P)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(d + 4 * i), "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One pair of the forward's chain on one pixel, branch-free. A pair that
// is not kept (guard, threshold, or past the batch) comes with alpha 0,
// which leaves t and acc as they are bit for bit: t * (1 - 0) = t and
// acc + 0 * t = acc. t is multiplied by every pair's 1 - alpha, stopped
// or not: t only falls, so once a pair takes it below 1e-4 (the stop)
// every later pair finds it below too and adds 0 * t. So the pairs
// before the stop add what a serial loop with a break adds, bit for bit;
// t < 1e-4 is "done"; and the loop-carried path is one multiply on t and
// one multiply-add on acc.
__device__ __forceinline__ void chain_step(float a, float& t, float& acc) {
  const float t_inc = t * (1.0f - a);
  acc = fmaf(t_inc >= TRANSMITTANCE_EPS ? a : 0.0f, t, acc);
  t = t_inc;
}

// How a forward row finds its run [s, e) of feats: csrc/segpair.cu's runs
// are back to back (e = starts[row + 1]); csrc/pair.cu's are followed by
// pad rows, so their length is counts[row].
enum class RunEnd { kNextStart, kCount };

constexpr int RUN_FWD_BATCH = 128;  // pairs staged per pass (2 x 4 KB)
constexpr int RUN_FWD_GROUP = 16;   // pairs side by side

// The forward of the pair compositors (seg and v4), one CTA per frame row
// and one thread per pixel: the row's run in batches of RUN_FWD_BATCH
// pairs, double buffered by cp.async; within a batch, the t-free terms of
// RUN_FWD_GROUP pairs side by side, then the branch-free chain over them in
// pair order; a zero row at once for an empty run, a warp's skip once its
// pixels are done and the CTA's exit once all are. counts is read only
// under RunEnd::kCount. Each source instantiates the one it launches, so
// the seg forward compiles to the code it had as a kernel of its own.
template <RunEnd kEnd>
__global__ void __launch_bounds__(P)
run_fwd_kernel(const float* __restrict__ feats,
               const int* __restrict__ starts,
               const int* __restrict__ counts,
               const float* __restrict__ basis,
               float* __restrict__ img) {
  __shared__ __align__(16) float sf[2][RUN_FWD_BATCH * NF];
  const int fr = blockIdx.x;
  const int px = threadIdx.x;
  const int s = starts[fr];
  const int e = kEnd == RunEnd::kNextStart ? starts[fr + 1]
                                           : s + max(counts[fr], 0);
  float* out = img + static_cast<size_t>(fr) * P + px;
  if (s >= e) {   // an empty run: a zero row, nothing to stage
    *out = 0.0f;
    return;
  }
  const bool vec16 = (reinterpret_cast<size_t>(feats) & 15) == 0;
  stage_async(sf[0], feats + static_cast<size_t>(s) * NF,
              min(RUN_FWD_BATCH, e - s) * NF, vec16);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];

  float t = 1.0f;
  float acc = 0.0f;
  int buf = 0;
  for (int base = s; base < e; base += RUN_FWD_BATCH, buf ^= 1) {
    const int n = min(RUN_FWD_BATCH, e - base);
    const int next = base + RUN_FWD_BATCH;
    // the next batch lands in the other buffer while this one computes;
    // an empty group keeps the wait below uniform
    if (next < e)
      stage_async(sf[buf ^ 1], feats + static_cast<size_t>(next) * NF,
                  min(RUN_FWD_BATCH, e - next) * NF, vec16);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float* fb = sf[buf];
    for (int m0 = 0; m0 < n; m0 += RUN_FWD_GROUP) {
      // a warp whose pixels are all done skips the rest of the batch
      if (__all_sync(FULL_MASK, t < TRANSMITTANCE_EPS)) break;
      // what does not depend on t, for RUN_FWD_GROUP pairs side by side
      float a[RUN_FWD_GROUP];
#pragma unroll
      for (int r = 0; r < RUN_FWD_GROUP; ++r) {
        const float* f = fb + (m0 + r) * NF;
        const float la = log_alpha(f, b);
        const float x = expf(la);
        const bool ok = m0 + r < n && la <= f[6] + SIGMA_GUARD_EPS &&
                        x >= ALPHA_THRESHOLD;
        a[r] = ok ? fminf(x, ALPHA_CLAMP) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RUN_FWD_GROUP; ++r) chain_step(a[r], t, acc);
    }
    // the CTA stops once every pixel is done; also the barrier before the
    // next batch's prefetch overwrites this batch's buffer
    if (__syncthreads_and(t < TRANSMITTANCE_EPS)) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  *out = acc;
}

}  // namespace
