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
// total - c_inc is the exact suffix of this walk.
//
// What bounds it on this card: neither bytes nor FLOPs. At the fixture's
// shapes (~33k kept pairs of an 800x800 view) a view is ~9M pair-pixel
// evaluations (~0.2 GFLOP, 9M expf) over ~1 MB of features and 2.5 MB per
// [T,256] plane -- microseconds at the H100's 3.35 TB/s and 67 TFLOP/s
// f32. The time goes to the serial transmittance chain along each run (a
// tile's pairs are a dependent sequence per pixel, up to the cap of 768),
// to the uneven run lengths across tiles, and in the backward to a 6-value
// reduction over the tile's pixels per pair.
//
// What the design does about it: one CTA per frame row, one thread per
// pixel, so every run is walked by exactly one CTA and needs no cross-CTA
// carry or atomics. Pairs are staged in shared memory in batches (one
// coalesced load per batch, broadcast reads after). A pixel stops once its
// transmittance falls below 1e-4, which is exact because t only falls, and
// the CTA stops when all its pixels have (__syncthreads_and). The backward
// sums each pair's six values with warp shuffles (skipped when the whole
// warp holds zeros) and a cross-warp sum in shared memory per batch; each
// pair's gradient row belongs to one CTA, so the result is a plain
// deterministic store. Rows outside every run (pads, the budget tail) are
// not written: the caller masks them by pair validity.

#include <cuda_runtime.h>

namespace {

constexpr int P = 256;           // pixels of a 16x16 tile = threads per CTA
constexpr int NF = 8;            // features per pair
constexpr int WARPS = P / 32;
constexpr int FWD_BATCH = 256;   // pairs staged per pass (8 KB)
constexpr int BWD_BATCH = 128;   // pairs staged per pass (4 KB + 24 KB)
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

__global__ void __launch_bounds__(P)
pair_fwd_kernel(const float* __restrict__ feats,
                const int* __restrict__ sfp,
                const int* __restrict__ counts,
                const float* __restrict__ basis,
                float* __restrict__ img) {
  __shared__ float sf[FWD_BATCH * NF];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int s = sfp[row];
  const int e = s + max(counts[row], 0);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];

  float t = 1.0f;
  float acc = 0.0f;
  bool done = false;
  for (int base = s; base < e; base += FWD_BATCH) {
    const int n = min(FWD_BATCH, e - base);
    for (int i = px; i < n * NF; i += P)
      sf[i] = feats[static_cast<size_t>(base) * NF + i];
    __syncthreads();
    for (int k = 0; k < n && !done; ++k) {
      const float* f = sf + k * NF;
      const float la = log_alpha(f, b);
      if (!(la <= f[6] + SIGMA_GUARD_EPS)) continue;
      float a = expf(la);
      if (!(a >= ALPHA_THRESHOLD)) continue;
      a = fminf(a, ALPHA_CLAMP);
      const float t_inc = t * (1.0f - a);
      if (t_inc < TRANSMITTANCE_EPS) {
        done = true;
        break;
      }
      acc += a * t;
      t = t_inc;
    }
    // also the barrier before the next batch overwrites sf
    if (__syncthreads_and(done)) break;
  }
  img[static_cast<size_t>(row) * P + px] = acc;
}

__global__ void __launch_bounds__(P)
pair_bwd_kernel(const float* __restrict__ feats,
                const int* __restrict__ sfp,
                const int* __restrict__ counts,
                const float* __restrict__ basis,
                const float* __restrict__ g_in,
                const float* __restrict__ total_in,
                float* __restrict__ dfeats) {
  __shared__ float sf[BWD_BATCH * NF];
  __shared__ float part[BWD_BATCH][WARPS][6];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const int s = sfp[row];
  const int e = s + max(counts[row], 0);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  const size_t pix = static_cast<size_t>(row) * P + px;
  const float g = g_in[pix];
  const float total = total_in[pix];

  float t = 1.0f;          // transmittance before the pair
  float c = 0.0f;          // sum of a * t up to and including the pair
  bool done = false;       // this pixel's transmittance fell below 1e-4
  bool all_done = false;   // every pixel of the tile has: rows are zero
  for (int base = s; base < e; base += BWD_BATCH) {
    const int n = min(BWD_BATCH, e - base);
    if (!all_done) {
      for (int i = px; i < n * NF; i += P)
        sf[i] = feats[static_cast<size_t>(base) * NF + i];
    }
    __syncthreads();
    if (!all_done) {
      for (int k = 0; k < n; ++k) {
        float dla = 0.0f;
        if (!done) {
          const float* f = sf + k * NF;
          const float la = log_alpha(f, b);
          if (la <= f[6] + SIGMA_GUARD_EPS) {
            float a = expf(la);
            if (a >= ALPHA_THRESHOLD) {
              a = fminf(a, ALPHA_CLAMP);
              const float om = 1.0f - a;
              const float t_inc = t * om;
              if (t_inc < TRANSMITTANCE_EPS) {
                done = true;
              } else {
                c += a * t;
                const float da = (t - (total - c) / om) * g;
                if (a < ALPHA_CLAMP) dla = a * da;
                t = t_inc;
              }
            }
          }
        }
        // every lane joins the reduction, stopped pixels with zeros
        float v[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] = dla * b[j];
        if (__any_sync(FULL_MASK, dla != 0.0f)) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int j = 0; j < 6; ++j)
              v[j] += __shfl_xor_sync(FULL_MASK, v[j], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < 6; ++j) part[k][warp][j] = v[j];
        }
      }
    }
    __syncthreads();
    for (int i = px; i < n * NF; i += P) {
      const int k = i / NF;
      const int j = i % NF;
      float sum = 0.0f;
      if (!all_done && j < 6) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[k][w][j];
      }
      dfeats[static_cast<size_t>(base) * NF + i] = sum;
    }
    // also the barrier before the next batch overwrites sf and part
    all_done = __syncthreads_and(done);
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
int pair_fwd(const float* feats, const int* sfp, const int* counts,
             const float* basis, float* img, int num_rows, void* stream) {
  if (num_rows > 0) {
    pair_fwd_kernel<<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, sfp, counts, basis, img);
  }
  return static_cast<int>(cudaGetLastError());
}

int pair_bwd(const float* feats, const int* sfp, const int* counts,
             const float* basis, const float* g, const float* total,
             float* dfeats, int num_rows, void* stream) {
  if (num_rows > 0) {
    pair_bwd_kernel<<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, sfp, counts, basis, g, total, dfeats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
