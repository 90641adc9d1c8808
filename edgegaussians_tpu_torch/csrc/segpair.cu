// Segmented pair compositor for Hopper (sm_90a): forward and backward.
//
// Replaces edgegaussians_tpu/ops/pallas_segpair.py::_fwd_kernel (:277) and
// ::_bwd_kernel (:345), launched there by _seg_fwd (:416) and _seg_bwd
// (:452). It ports what those kernels compute, not their layout: the
// 128-pair bricks, one-hot segment-sum matmuls, segmented roll scans,
// 8-row image carries and DMA windows exist for the TPU's Mosaic compiler
// and have no counterpart here.
//
// Input contract (built by ops/segpair.py): frame row fr owns the
// contiguous, depth-ordered pair run [s_f[fr], s_f[fr+1]) of feats [B,8]
// (f32, row-major); one 16x16 tile has P = 256 pixels whose monomial basis
// is basis [8,256]. Per pair and pixel:
//   log a = sum_{j<6} f_j * basis_j(px)          (full f32 FMAs)
//   ok = log a <= f_6 + SIGMA_GUARD_EPS;  a = exp(log a);  ok &= a >= 1/255
//   a = min(a, 0.999);  t_inc = t * (1 - a);  stop once t_inc < 1e-4
//   img += a * t;  t = t_inc
// The backward takes the pre-folded cotangent gt = g * (1 - img) and uses
// the algebraic suffix of the all-ones-colour composite:
//   d log a = a * gt / (1 - a) on kept lanes with ok and a < 0.999,
//   dfeats[p, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7.
//
// What bounds it on this card: neither bytes nor FLOPs. At the ABC shapes
// (~33k kept pairs of an 800x800 view) a view is ~8.4M pair-pixel
// evaluations (~0.3 GFLOP) over ~1 MB of features and 2.5 MB of image --
// microseconds at the H100's 3.35 TB/s and 67 TFLOP/s f32. What sets the
// time instead:
//
// 1. The run of the CTA with the longest run. A tile's pairs are a
//    dependent sequence per pixel, and one CTA walks each run, so the
//    time one CTA alone takes on the longest run is a floor for the
//    launch. chip_smoke.py phase 2 times it: on an H100 80GB HBM3 (700 W)
//    a backward CTA alone adds ~160 ns (~320 cycles) a pair where every
//    pixel walks every pair, ~0.12 ms at the 768-pair cap; on the ABC
//    fixture's longest runs (187-346 pairs) 0.03-0.06 ms, about the
//    whole launch's time. Runs are uneven across tiles. A forward CTA
//    alone adds ~40 ns a pair (~128 with a branch per pair) and takes
//    0.010-0.016 ms on those runs, 46-76% of its launch's 0.022 ms.
// 2. What a CTA does per pair, in its 8 warps: ~25 instructions per pixel
//    on the alpha and transmittance math (an expf, and in the backward a
//    division), the barriers of each batch, and the latency between them.
//    It is the CTA's latency more than the SM's issue rate: two CTAs
//    sharing an SM take ~1.3x one CTA's time, not 2x (same phase).
// 3. In the backward, the reduction dfeats[p, j] = sum_px dla[p, px] *
//    basis[j, px] over a tile's 256 pixels, a [pairs x 256] @ [256 x 8]
//    product per batch of pairs. Done as a warp shuffle butterfly (5 levels
//    x 6 values) it cost a CTA ~500 warp instructions per pair against ~120
//    on the pixel math.
//
// What the design does about them. The forward is compositor.cuh's
// run_fwd_kernel (RunEnd::kNextStart), which csrc/pair.cu launches too.
// Both kernels: one CTA per frame row, one thread per pixel, so every run
// is walked by exactly one CTA and needs no cross-CTA carry or atomics.
// Pairs are staged in shared memory in batches (coalesced loads, broadcast
// reads). A pixel stops once its transmittance falls below 1e-4, which is
// exact because t only falls, and the CTA stops when all its pixels have
// (__syncthreads_and).
//
// Splitting long runs across CTAs against (1) was measured for the forward
// and not taken: 64-pair work items of the flat pair array from a ticket
// counter, a run's per-pixel (t, acc) handed from item to item through
// global memory behind a release/acquire flag, the t-free terms of the
// continuation computed before the wait. On the fixture's longest runs it
// took 0.0132-0.0152 ms against 0.0167 for one CTA, but a whole camera
// 0.068 ms against 0.021: an item alone costs ~8 us, most of it the
// serial latency of the ticket, the run-table search and the staging,
// which one CTA a row pays once (chip_smoke.py's chain timing and
// scripts/torch_kernel_ab.py; PERF.md section 6).
//
// The backward does the reduction (3) on the tensor cores. Each warp owns
// 32 pixels, i.e. 4 k-steps of the product. Its pixels write their dla for
// 16 pairs into the warp's own tile D [16 x 32] (row stride 36, so the
// fragment loads hit 32 distinct banks), one store per pair per thread;
// after a __syncwarp the warp multiplies D by the basis columns of its
// pixels with mma.sync m16n8k8 in TF32, in the 3xTF32 split (a = a_hi +
// a_lo: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, f32 accumulators), which keeps
// f32 accuracy where plain TF32 (10-bit mantissa) would not. The basis
// fragments (B, fixed for every tile) are split once into registers; the
// monomial basis of tiles.pixel_basis is exact in TF32, so its b_lo is zero
// and the middle product is skipped then (adding exact zeros changes no
// bit). A warp whose 16 pairs are all zero skips its products. Each warp
// leaves a [batch x 6] partial in shared memory, and after the batch's
// barrier the 8 partials are added in warp order: deterministic, no
// atomics. Per pair, the reduction now costs a CTA ~8 stores plus ~40
// warp instructions of fragment loads, splits and MMAs.
//
// Against (1) and (2), both kernels compute what does not depend on t
// (the guard, alpha, 1 - alpha, and in the backward dla) for 16 pairs of
// a tile side by side, and walk only a multiply and a compare per pair
// along the chain; empty runs return at once (the forward writing its
// zero row). Batches are double buffered: the next batch's features
// arrive by cp.async (16 bytes a thread where feats is 16-byte aligned)
// while this batch computes. The backward divides with __fdividef (MUFU
// reciprocal and a multiply, within 2 ulp for 1 - alpha in [0.001, 1))
// where IEEE division costs a CTA ~20 instructions a pair. The forward
// keeps expf, as the backward does, so that the two agree on every pair
// at the 1/255 threshold, and walks its chain without branches: with a
// branch per pair (skip, stop) one CTA took 77 ns a pair of the fixture's
// longest run, branch-free 48 ns, and 42 ns with no chain at all; two or
// four pixels a thread (to share the features' shared-memory loads) were
// slower, groups of 8 pairs slower and of 32 within 3% (PERF.md section
// 6).

#include "compositor.cuh"

namespace {

constexpr int BWD_BATCH = 64;    // pairs staged per pass (2 x 2 KB)

__global__ void __launch_bounds__(P)
segpair_bwd_kernel(const float* __restrict__ feats,
                   const int* __restrict__ s_f,
                   const float* __restrict__ basis,
                   const float* __restrict__ gt,
                   float* __restrict__ dfeats) {
  __shared__ __align__(16) float sf[2][BWD_BATCH * NF];
  __shared__ __align__(16) float dt[WARPS][MT * DSTRIDE];
  __shared__ __align__(16) float part[WARPS][BWD_BATCH * NJ];
  const int fr = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const int grp = lane >> 2;   // the fragments' row (A) and column (B)
  const int tig = lane & 3;    // the fragments' column (A) and row (B)
  const int s = s_f[fr];
  const int e = s_f[fr + 1];
  if (s >= e) return;   // an empty run has no rows to write
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  const float g = gt[static_cast<size_t>(fr) * P + px];

  unsigned bhi[KSTEPS][2], blo[KSTEPS][2];
  const bool b_exact = basis_fragments(basis, warp, grp, tig, bhi, blo);
  float* dw = dt[warp];
  const bool vec16 = (reinterpret_cast<size_t>(feats) & 15) == 0;

  float t = 1.0f;
  bool done = false;       // this pixel's transmittance fell below 1e-4
  bool all_done = false;   // every pixel of the tile has: rows are zero
  int buf = 0;
  stage_async(sf[0], feats + static_cast<size_t>(s) * NF,
              min(BWD_BATCH, e - s) * NF, vec16);
  for (int base = s; base < e; base += BWD_BATCH, buf ^= 1) {
    const int n = min(BWD_BATCH, e - base);
    const int next = base + BWD_BATCH;
    // the next batch lands in the other buffer while this one computes;
    // an empty group keeps the wait below uniform
    if (!all_done && next < e)
      stage_async(sf[buf ^ 1], feats + static_cast<size_t>(next) * NF,
                  min(BWD_BATCH, e - next) * NF, vec16);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if (!all_done) {
      const float* fb = sf[buf];
      for (int m0 = 0; m0 < n; m0 += MT) {
        bool any = false;
        if (!__all_sync(FULL_MASK, done)) {   // else zero rows, no products
          // what does not depend on t, for the 16 pairs side by side: the
          // guard and threshold, 1 - alpha, and dla if the pair is kept
          float om[MT], q[MT];
          bool ok[MT];
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            const float* f = fb + (m0 + r) * NF;
            const float la = log_alpha(f, b);
            float a = expf(la);
            ok[r] = m0 + r < n && la <= f[6] + SIGMA_GUARD_EPS &&
                    a >= ALPHA_THRESHOLD;
            a = fminf(a, ALPHA_CLAMP);
            om[r] = 1.0f - a;
            q[r] = a < ALPHA_CLAMP ? a * __fdividef(g, om[r]) : 0.0f;
          }
          // the serial chain: a multiply and a compare per pair
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            float dla = 0.0f;
            if (ok[r] && !done) {
              const float t_inc = t * om[r];
              if (t_inc < TRANSMITTANCE_EPS) {
                done = true;
              } else {
                dla = q[r];
                t = t_inc;
              }
            }
            dw[r * DSTRIDE + lane] = dla;
            any |= dla != 0.0f;
          }
        }
        __syncwarp();
        // this warp's partial of the 16 pairs: D [16 x 32] @ B [32 x 8]
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (__any_sync(FULL_MASK, any))
          tile_product(dw, grp, tig, bhi, blo, b_exact, c);
        __syncwarp();   // D is read before the next 16 pairs overwrite it
        if (tig < NJ / 2) {   // columns 2 tig, 2 tig + 1 of rows grp, grp + 8
          float* pw = part[warp] + (m0 + grp) * NJ + 2 * tig;
          *reinterpret_cast<float2*>(pw) = make_float2(c[0], c[1]);
          *reinterpret_cast<float2*>(pw + 8 * NJ) = make_float2(c[2], c[3]);
        }
      }
    }
    __syncthreads();
    for (int i = px; i < n * NF; i += P) {
      const int k = i / NF;
      const int j = i % NF;
      float sum = 0.0f;
      if (!all_done && j < NJ) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[w][k * NJ + j];
      }
      dfeats[static_cast<size_t>(base) * NF + i] = sum;
    }
    // also the barrier before the next batch's prefetch overwrites this
    // batch's buffer and the warps overwrite part
    all_done = __syncthreads_and(done);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
int segpair_fwd(const float* feats, const int* s_f, const float* basis,
                float* img, int num_rows, void* stream) {
  if (num_rows > 0) {
    run_fwd_kernel<RunEnd::kNextStart>
        <<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
            feats, s_f, nullptr, basis, img);
  }
  return static_cast<int>(cudaGetLastError());
}

int segpair_bwd(const float* feats, const int* s_f, const float* basis,
                const float* gt, float* dfeats, int num_rows, void* stream) {
  if (num_rows > 0) {
    segpair_bwd_kernel<<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, s_f, basis, gt, dfeats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
