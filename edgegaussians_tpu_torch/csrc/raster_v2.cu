// Dense slot-frame compositor for Hopper (sm_90a): forward and backward.
//
// Replaces edgegaussians_tpu/ops/pallas_raster_v2.py::_fwd_kernel (:94) and
// ::_bwd_kernel (:146), launched there by _composite_fwd (:247) and
// _composite_bwd (:317). It ports what those kernels compute, not their
// layout: the TILE_BLOCK grid, the Hillis-Steele roll cumprods, the
// block-level chunk predication and the vma promotions exist for the TPU's
// Mosaic compiler and have no counterpart here.
//
// Input contract (built by ops/composite.py): frame row r holds K
// depth-ordered slots feats[r, k, 0:8] (f32, row-major [T,K,8]), of which
// the first min(counts[r], K) can be live (a negative count is 0); slots
// past the count carry a -1e30 constant term and are never read. One 16x16
// tile has P = 256 pixels whose monomial basis is basis [8,256]. The walk
// starts from the carried transmittance t_in[r, px] (1 where t_in is null)
// and follows the gsplat rules of csrc/compositor.cuh. The forward writes
// img and t_out, the transmittance the walk ends with: where it stays
// >= 1e-4 the product of every live slot's 1 - alpha; below 1e-4 its value
// depends on where the walk left the row, and a following segment keeps
// nothing from the pixel either way. The backward takes the upstream g and
// the GLOBAL per-tile total of all segments, folds the cotangent
// gt2 = g * (1 - total) per pixel itself, and uses the algebraic suffix
//   d log a = a * gt2 / (1 - a) on kept slots with ok and a < 0.999,
//   dfeats[r, k, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7,
// and 0 on every slot the walk never reaches.
//
// What bounds it on this card: neither bytes nor FLOPs. At the ABC
// fallback shapes (2500 rows of 128 slots, then 128 rows of 640) a view is
// some 9M live slot-pixel evaluations (~0.2 GFLOP, 9M expf on the SFUs)
// over ~13 MB of dfeats and 2.5 MB per [T,256] plane -- a few microseconds
// at the H100's 3.35 TB/s and 67 TFLOP/s f32. The time goes to the serial
// transmittance chain along each row (one CTA walks a row; rows are very
// uneven, most tiles empty and a few hundreds of slots deep), so a level's
// launch lasts about as long as the one CTA on its longest row
// (chip_smoke.py phase 2 dense times that CTA alone), and in the backward
// to the reduction of each slot's six values over the tile's pixels.
//
// What the design does about it -- the seg kernels' levers (csrc/segpair.cu,
// whose header has the measurements), on the dense frame:
// - One CTA per frame row, one thread per pixel: every row is walked by
//   exactly one CTA, so no carry crosses CTAs and the backward needs no
//   atomics. Splitting a row across CTAs was measured on the seg forward
//   and made a camera 3.3x slower (csrc/segpair.cu).
// - A row with no live slot, or whose every pixel enters below 1e-4, does
//   no work: the forward writes img = 0 and t_out = t_in, the backward
//   zeros with 16-byte stores.
// - Slots are staged in shared memory in cp.async double-buffered batches
//   (16 bytes a thread where feats is 16-byte aligned, else 4), the next
//   batch landing while this one computes.
// - The t-free terms (log alpha, the guard, expf, the threshold, the
//   clamp; in the backward dla = a * gt2 / (1 - a) with __fdividef) of 16
//   slots side by side, then a branch-free chain: a dropped slot enters
//   with alpha 0, and t is multiplied on past the stop (compositor.cuh's
//   chain_step), so the image is the serial loop's bit for bit with one
//   multiply on the loop-carried path. expf, not __expf: the forward and
//   the backward must decide the same 1/255 threshold.
// - A warp whose pixels are all below 1e-4 skips the rest of its batch,
//   and the CTA leaves the row once every pixel is.
// - The backward's pixel reduction runs on the tensor cores
//   (compositor.cuh's tile_product, 3xTF32 mma.sync m16n8k8); each warp
//   leaves its own partial, and the 8 partials are added in warp order:
//   deterministic. Its output, mostly the zeros of slots past the walk,
//   goes out in 16-byte stores.

#include "compositor.cuh"

namespace {

constexpr int FWD_BATCH = 128;   // slots staged per pass (2 x 4 KB)
constexpr int BWD_BATCH = 64;    // slots staged per pass (2 x 2 KB)
constexpr int FWD_GROUP = 16;    // forward: slots side by side

__global__ void __launch_bounds__(P)
raster_v2_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ counts,
                     const float* __restrict__ basis,
                     const float* __restrict__ t_in,
                     float* __restrict__ img,
                     float* __restrict__ t_out, int k_cap) {
  __shared__ __align__(16) float sf[2][FWD_BATCH * NF];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int n = min(max(counts[row], 0), k_cap);
  const size_t pix = static_cast<size_t>(row) * P + px;
  float t = t_in ? t_in[pix] : 1.0f;
  // no live slot, or every pixel entered done: t goes out as it came in
  if (n == 0 || __syncthreads_and(!(t >= TRANSMITTANCE_EPS))) {
    img[pix] = 0.0f;
    t_out[pix] = t;
    return;
  }
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  const bool vec16 = aligned16(feats);
  stage_async(sf[0], rf, min(FWD_BATCH, n) * NF, vec16);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];

  float acc = 0.0f;
  int buf = 0;
  for (int base = 0; base < n; base += FWD_BATCH, buf ^= 1) {
    const int m = min(FWD_BATCH, n - base);
    const int next = base + FWD_BATCH;
    // the next batch lands in the other buffer while this one computes;
    // an empty group keeps the wait below uniform
    if (next < n)
      stage_async(sf[buf ^ 1], rf + static_cast<size_t>(next) * NF,
                  min(FWD_BATCH, n - next) * NF, vec16);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float* fb = sf[buf];
    for (int m0 = 0; m0 < m; m0 += FWD_GROUP) {
      // a warp whose pixels are all done skips the rest of the batch
      if (__all_sync(FULL_MASK, t < TRANSMITTANCE_EPS)) break;
      // what does not depend on t, for the FWD_GROUP slots side by side
      float a[FWD_GROUP];
#pragma unroll
      for (int r = 0; r < FWD_GROUP; ++r) {
        const float* f = fb + (m0 + r) * NF;
        const float la = log_alpha(f, b);
        const float x = expf(la);
        const bool ok = m0 + r < m && la <= f[6] + SIGMA_GUARD_EPS &&
                        x >= ALPHA_THRESHOLD;
        a[r] = ok ? fminf(x, ALPHA_CLAMP) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < FWD_GROUP; ++r) chain_step(a[r], t, acc);
    }
    // the CTA stops once every pixel is done; also the barrier before the
    // next batch's prefetch overwrites this batch's buffer
    if (__syncthreads_and(t < TRANSMITTANCE_EPS)) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  img[pix] = acc;
  t_out[pix] = t;
}

__global__ void __launch_bounds__(P)
raster_v2_bwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ counts,
                     const float* __restrict__ basis,
                     const float* __restrict__ g_in,
                     const float* __restrict__ total,
                     const float* __restrict__ t_in,
                     float* __restrict__ dfeats, int k_cap) {
  __shared__ __align__(16) float sf[2][BWD_BATCH * NF];
  __shared__ __align__(16) float dt[WARPS][MT * DSTRIDE];
  __shared__ __align__(16) float part[WARPS][BWD_BATCH * NJ];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const int grp = lane >> 2;   // the fragments' row (A) and column (B)
  const int tig = lane & 3;    // the fragments' column (A) and row (B)
  const int n = min(max(counts[row], 0), k_cap);
  float* rd = dfeats + static_cast<size_t>(row) * k_cap * NF;
  const size_t pix = static_cast<size_t>(row) * P + px;
  float t = t_in ? t_in[pix] : 1.0f;
  // no live slot, or every pixel entered done: the row is zero
  if (n == 0 || __syncthreads_and(!(t >= TRANSMITTANCE_EPS))) {
    zero_slots(rd, k_cap);
    return;
  }
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  const bool vec16 = aligned16(feats);
  stage_async(sf[0], rf, min(BWD_BATCH, n) * NF, vec16);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  // the cotangent, folded as the plain version folds it
  const float g = g_in[pix] * (1.0f - total[pix]);
  unsigned bhi[KSTEPS][2], blo[KSTEPS][2];
  const bool b_exact = basis_fragments(basis, warp, grp, tig, bhi, blo);
  float* dw = dt[warp];

  int written = 0;   // slots [0, written) of the row are out
  int buf = 0;
  for (int base = 0; base < n; base += BWD_BATCH, buf ^= 1) {
    const int m = min(BWD_BATCH, n - base);
    const int next = base + BWD_BATCH;
    // the next batch lands in the other buffer while this one computes;
    // an empty group keeps the wait below uniform
    if (next < n)
      stage_async(sf[buf ^ 1], rf + static_cast<size_t>(next) * NF,
                  min(BWD_BATCH, n - next) * NF, vec16);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float* fb = sf[buf];
    for (int m0 = 0; m0 < m; m0 += MT) {
      bool any = false;
      if (!__all_sync(FULL_MASK, t < TRANSMITTANCE_EPS)) {
        // what does not depend on t, for the MT slots side by side: 1 - a
        // of a kept slot (1 for a dropped one, which leaves t as it is),
        // and dla if the slot is kept with a < 0.999
        float om[MT], q[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float* f = fb + (m0 + r) * NF;
          const float la = log_alpha(f, b);
          const float x = expf(la);
          const bool ok = m0 + r < m && la <= f[6] + SIGMA_GUARD_EPS &&
                          x >= ALPHA_THRESHOLD;
          const float a = fminf(x, ALPHA_CLAMP);
          om[r] = ok ? 1.0f - a : 1.0f;
          q[r] = ok && a < ALPHA_CLAMP ? a * __fdividef(g, 1.0f - a) : 0.0f;
        }
        // the chain, branch-free: a multiply and a compare per slot; t is
        // multiplied on past the stop, so every later slot fails the
        // compare as the serial loop's break would skip it
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float t_inc = t * om[r];
          const float dla = t_inc >= TRANSMITTANCE_EPS ? q[r] : 0.0f;
          t = t_inc;
          dw[r * DSTRIDE + lane] = dla;
          any |= dla != 0.0f;
        }
      }
      __syncwarp();
      // this warp's partial of the MT slots: D [16 x 32] @ B [32 x 8]
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (__any_sync(FULL_MASK, any))
        tile_product(dw, grp, tig, bhi, blo, b_exact, c);
      __syncwarp();   // D is read before the next MT slots overwrite it
      if (tig < NJ / 2) {   // columns 2 tig, 2 tig + 1 of rows grp, grp + 8
        float* pw = part[warp] + (m0 + grp) * NJ + 2 * tig;
        *reinterpret_cast<float2*>(pw) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(pw + 8 * NJ) = make_float2(c[2], c[3]);
      }
    }
    __syncthreads();
    // the batch's m slots, the 8 warp partials added in warp order: half
    // h of slot k is columns 4 h .. 4 h + 3
    for (int i = px; i < m * (NF / 4); i += P) {
      const int k = i >> 1;
      const int h = i & 1;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * h + jj;
        float sum = 0.0f;
        if (j < NJ) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += part[w][k * NJ + j];
        }
        v[jj] = sum;
      }
      *reinterpret_cast<float4*>(rd + static_cast<size_t>(base + k) * NF +
                                 4 * h) = make_float4(v[0], v[1], v[2], v[3]);
    }
    written = base + m;
    // the CTA leaves the row once every pixel is done: the rest is zero;
    // also the barrier before the next batch's prefetch overwrites this
    // batch's buffer and the warps overwrite part
    if (__syncthreads_and(t < TRANSMITTANCE_EPS)) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the slots the walk never reaches: past every pixel's stop and the count
  zero_slots(rd + static_cast<size_t>(written) * NF, k_cap - written);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// t_in may be null (transmittance 1 entering every row).
int raster_v2_fwd(const float* feats, const int* counts, const float* basis,
                  const float* t_in, float* img, float* t_out, int num_rows,
                  int k_cap, void* stream) {
  if (num_rows > 0) {
    raster_v2_fwd_kernel<<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, counts, basis, t_in, img, t_out, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

// g and total are [num_rows, 256]: the kernel folds gt2 = g * (1 - total).
// dfeats must be 16-byte aligned (the wrapper allocates it); else the entry
// launches nothing and returns cudaErrorMisalignedAddress.
int raster_v2_bwd(const float* feats, const int* counts, const float* basis,
                  const float* g, const float* total, const float* t_in,
                  float* dfeats, int num_rows, int k_cap, void* stream) {
  if (!aligned16(dfeats))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (num_rows > 0) {
    raster_v2_bwd_kernel<<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, counts, basis, g, total, t_in, dfeats, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
