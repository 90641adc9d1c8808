// v4 block-window pair compositor for Hopper (sm_90a): forward and backward.
//
// Replaces edgegaussians_tpu/ops/pallas_pair.py::_fwd_kernel (:152) and
// ::_bwd_kernel (:206), launched there by _pair_fwd (:311) and _pair_bwd
// (:346). It ports what those kernels compute, not their layout: the
// 128-pair bricks, the per-block DMA windows with lane-roll phase
// alignment, the run penalty and the block-level predication exist for
// the TPU's Mosaic compiler and have no counterpart here.
//
// Input contract (built by ops/pair.py from the block_tiles > 0 tables of
// ops/tiles.py): frame row r composites the depth-ordered pairs
// [sfp[r], sfp[r] + counts[r]) of feats [B,8] (f32, row-major). Unlike the
// seg kernel's contract (csrc/segpair.cu), runs are NOT back to back: the
// last row of every block is followed by brick-alignment pad rows, which
// carry the features of real Gaussians (their ranks are clipped), so the
// walk length is counts[r], never the distance to the next run start. One
// 16x16 tile has P = 256 pixels whose monomial basis is basis [8,256]. Per
// pair and pixel:
//   log a = sum_{j<6} f_j * basis_j(px)          (full f32 FMAs)
//   ok = log a <= f_6 + SIGMA_GUARD_EPS;  a = exp(log a);  ok &= a >= 1/255
//   a = min(a, 0.999);  t_inc = t * (1 - a);  stop once t_inc < 1e-4
//   img += a * t;  t = t_inc
// The backward takes the upstream g and the forward image `total`, and
// uses the v4 kernel's unfolded suffix form, carrying the running sum
// c_inc of the contributions a * t along the run:
//   d a = (t - (total - c_inc) / (1 - a)) * g on kept pairs,
//   d log a = a * d a where ok and a < 0.999,
//   dfeats[p, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7.
// The forward sums a * t in the same order the backward carries c_inc, so
// total - c_inc is the exact suffix of this walk. The unfolded form is the
// contract (the TPU kernel's and pair_bwd_ref's), not the seg kernels'
// folded g * (1 - img): the two differ in rounding.
// Every row inside a run gets its dfeats row, zeros past the stop included;
// rows outside every run (pads, the budget tail) are not written, because
// the caller masks them by pair validity.
//
// What bounds it on this card: neither bytes nor FLOPs. At the fixture's
// shapes (~33k kept pairs of an 800x800 view) a view is ~9M pair-pixel
// evaluations over ~1 MB of features and 2.5 MB per [T,256] plane --
// microseconds at the H100's 3.35 TB/s and 67 TFLOP/s f32. The time goes
// to the serial transmittance chain along each run (a tile's pairs are a
// dependent sequence per pixel, up to the cap of 768), to the uneven run
// lengths across tiles, and in the backward to a 6-value reduction over
// the tile's pixels per pair. The seg kernels have the same shape of work,
// and their measured answers (csrc/segpair.cu's header, PERF.md section 6)
// carry over; the helpers are compositor.cuh's.
//
// The design: one CTA per frame row, one thread per pixel, so every run is
// walked by exactly one CTA and needs no cross-CTA carry or atomics.
// - Forward: the seg forward itself, compositor.cuh's run_fwd_kernel with
//   the run's end from counts (RunEnd::kCount): batches of 128 pairs
//   double buffered by cp.async (16 bytes a thread where feats is 16-byte
//   aligned, else 4), the t-free terms of 16 pairs side by side (log a,
//   the guard, alpha), a branch-free chain (chain_step: one multiply on t
//   and one multiply-add on the image a pair), a zero row at once for an
//   empty run, a warp skip once its pixels are done and the CTA's exit
//   once all are. It computes the earlier one-pair-at-a-time kernel's
//   bits: that kernel's a * t added to the image was the same FMA, and a
//   pair the chain drops adds 0 * t.
// - Backward: the same staging in batches of 64 and t-free groups of 16
//   (alpha, 1 - alpha and whether the pair takes a gradient); along the
//   chain a multiply on t, a multiply-add on c_inc and the compare, with
//   the suffix's division by 1 - a as __fdividef (MUFU reciprocal and a
//   multiply, within 2 ulp for 1 - a in [0.001, 1]) beside it. A pair
//   that is not kept enters with alpha 0, which leaves t and c_inc as
//   they are bit for bit, and t is multiplied on past the stop, so every
//   later pair fails the compare as the serial loop's break would skip
//   it. The pixel reduction dfeats = dla @ basis^T runs on the tensor
//   cores: each warp writes its 32 pixels' dla of 16 pairs into its own
//   D tile and multiplies it by its basis columns with mma.sync m16n8k8
//   in 3xTF32 (compositor.cuh's basis_fragments and tile_product; never
//   plain TF32), a warp whose 16 pairs are all zero skipping its
//   products; the 8 warp partials are added in warp order, so the rows
//   are deterministic with no atomics. Rows go out in 16-byte stores, and
//   rows past the CTA's stop are zeroed in 16-byte stores (zero_slots), so
//   dfeats must be 16-byte aligned: the wrapper allocates it, and the
//   entry refuses an unaligned one (pair_bwd).

#include "compositor.cuh"

namespace {

constexpr int BWD_BATCH = 64;    // pairs staged per pass (2 x 2 KB)

__global__ void __launch_bounds__(P)
pair_bwd_kernel(const float* __restrict__ feats,
                const int* __restrict__ sfp,
                const int* __restrict__ counts,
                const float* __restrict__ basis,
                const float* __restrict__ g_in,
                const float* __restrict__ total_in,
                float* __restrict__ dfeats) {
  __shared__ __align__(16) float sf[2][BWD_BATCH * NF];
  __shared__ __align__(16) float dt[WARPS][MT * DSTRIDE];
  __shared__ __align__(16) float part[WARPS][BWD_BATCH * NJ];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const int grp = lane >> 2;   // the fragments' row (A) and column (B)
  const int tig = lane & 3;    // the fragments' column (A) and row (B)
  const int s = sfp[row];
  const int n = max(counts[row], 0);
  if (n == 0) return;   // an empty run has no rows to write
  const float* rf = feats + static_cast<size_t>(s) * NF;
  float* rd = dfeats + static_cast<size_t>(s) * NF;
  const bool vec16 = aligned16(feats);
  stage_async(sf[0], rf, min(BWD_BATCH, n) * NF, vec16);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  const size_t pix = static_cast<size_t>(row) * P + px;
  const float g = g_in[pix];
  const float total = total_in[pix];
  unsigned bhi[KSTEPS][2], blo[KSTEPS][2];
  const bool b_exact = basis_fragments(basis, warp, grp, tig, bhi, blo);
  float* dw = dt[warp];

  float t = 1.0f;   // transmittance before the pair
  float c = 0.0f;   // sum of a * t up to and including the pair
  int written = 0;  // pairs [0, written) of the run are out
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
        // what does not depend on t, for the MT pairs side by side: alpha
        // of a kept pair (0 for a dropped one, which leaves t and c_inc as
        // they are), and whether it takes a gradient (a < 0.999)
        float a[MT];
        unsigned grad = 0u;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float* f = fb + (m0 + r) * NF;
          const float la = log_alpha(f, b);
          const float x = expf(la);
          const bool ok = m0 + r < m && la <= f[6] + SIGMA_GUARD_EPS &&
                          x >= ALPHA_THRESHOLD;
          a[r] = ok ? fminf(x, ALPHA_CLAMP) : 0.0f;
          grad |= static_cast<unsigned>(ok && a[r] < ALPHA_CLAMP) << r;
        }
        // the chain, branch-free: a multiply on t and a multiply-add on
        // c_inc a pair, the suffix's division beside it
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float om = 1.0f - a[r];
          const float t_inc = t * om;
          const bool keep = t_inc >= TRANSMITTANCE_EPS;
          c = fmaf(keep ? a[r] : 0.0f, t, c);
          const float dla = keep && ((grad >> r) & 1u)
              ? a[r] * ((t - __fdividef(total - c, om)) * g) : 0.0f;
          t = t_inc;
          dw[r * DSTRIDE + lane] = dla;
          any |= dla != 0.0f;
        }
      }
      __syncwarp();
      // this warp's partial of the MT pairs: D [16 x 32] @ B [32 x 8]
      float cc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (__any_sync(FULL_MASK, any))
        tile_product(dw, grp, tig, bhi, blo, b_exact, cc);
      __syncwarp();   // D is read before the next MT pairs overwrite it
      if (tig < NJ / 2) {   // columns 2 tig, 2 tig + 1 of rows grp, grp + 8
        float* pw = part[warp] + (m0 + grp) * NJ + 2 * tig;
        *reinterpret_cast<float2*>(pw) = make_float2(cc[0], cc[1]);
        *reinterpret_cast<float2*>(pw + 8 * NJ) = make_float2(cc[2], cc[3]);
      }
    }
    __syncthreads();
    // the batch's m rows, the 8 warp partials added in warp order: half h
    // of row k is columns 4 h .. 4 h + 3
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
    // the CTA leaves the run once every pixel is done: the rest is zero;
    // also the barrier before the next batch's prefetch overwrites this
    // batch's buffer and the warps overwrite part
    if (__syncthreads_and(t < TRANSMITTANCE_EPS)) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the rows the walk never reaches: past every pixel's stop
  zero_slots(rd + static_cast<size_t>(written) * NF, n - written);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
int pair_fwd(const float* feats, const int* sfp, const int* counts,
             const float* basis, float* img, int num_rows, void* stream) {
  if (num_rows > 0) {
    run_fwd_kernel<RunEnd::kCount>
        <<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
            feats, sfp, counts, basis, img);
  }
  return static_cast<int>(cudaGetLastError());
}

// dfeats must be 16-byte aligned (the wrapper allocates it); else the entry
// launches nothing and returns cudaErrorMisalignedAddress.
int pair_bwd(const float* feats, const int* sfp, const int* counts,
             const float* basis, const float* g, const float* total,
             float* dfeats, int num_rows, void* stream) {
  if (!aligned16(dfeats))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (num_rows > 0) {
    pair_bwd_kernel<<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, sfp, counts, basis, g, total, dfeats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
