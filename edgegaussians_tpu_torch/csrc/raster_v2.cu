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
// the first min(counts[r], K) can be live; slots past the count carry a
// -1e30 constant term, so skipping them is exact. One 16x16 tile has
// P = 256 pixels whose monomial basis is basis [8,256]. The walk starts
// from the carried transmittance t_in[r, px] (1 where t_in is null). Per
// slot and pixel:
//   log a = sum_{j<6} f_j * basis_j(px)          (full f32 FMAs)
//   ok = log a <= f_6 + SIGMA_GUARD_EPS;  a = exp(log a);  ok &= a >= 1/255
//   a = min(a, 0.999);  t_inc = t * (1 - a);  stop once t_inc < 1e-4
//   img += a * t;  t = t_inc
// The forward writes img and t_out (the transmittance the walk ends with;
// at a stop that is the t_inc below 1e-4, so a following segment keeps
// nothing, as with the TPU kernel's chunk-rounded value). The backward
// takes the cotangent pre-folded by the GLOBAL per-tile total of all
// segments, gt2 = g * (1 - total), and uses the algebraic suffix
//   d log a = a * gt2 / (1 - a) on kept slots with ok and a < 0.999,
//   dfeats[r, k, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7,
// and 0 on every slot the walk never reaches.
//
// What bounds it on this card: neither bytes nor FLOPs. At the ABC
// fallback shapes (2500 rows of 128 slots, then 128 rows of 640) a view is
// some 9M live slot-pixel evaluations (~0.2 GFLOP, 9M expf on the SFUs)
// over ~13 MB of features and 2.5 MB per [T,256] plane -- a few
// microseconds at the H100's 3.35 TB/s and 67 TFLOP/s f32. The time goes
// to the serial transmittance chain along each row (slots are a dependent
// sequence per pixel), to rows of very uneven length (most tiles are
// empty, a few hold hundreds), and in the backward to a 6-value reduction
// over the tile's pixels per slot.
//
// What the design does about it: one CTA per frame row, one thread per
// pixel, so every row is walked by exactly one CTA: no carry crosses CTAs
// and the backward needs no atomics. Only the row's first min(counts, K)
// slots are read, staged in shared memory in batches (one coalesced load
// per batch, broadcast reads after). A pixel stops at its first dropped
// slot, which is exact because t only falls; the CTA stops when all its
// pixels have (__syncthreads_and). The backward sums each slot's six
// values with warp shuffles (skipped when the whole warp holds zeros) and
// a cross-warp sum in shared memory per batch; each slot's row belongs to
// one CTA, so the result is a plain deterministic store.

#include <cuda_runtime.h>

namespace {

constexpr int P = 256;           // pixels of a 16x16 tile = threads per CTA
constexpr int NF = 8;            // features per slot
constexpr int WARPS = P / 32;
constexpr int FWD_BATCH = 256;   // slots staged per pass (8 KB)
constexpr int BWD_BATCH = 128;   // slots staged per pass (4 KB + 24 KB)
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
raster_v2_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ counts,
                     const float* __restrict__ basis,
                     const float* __restrict__ t_in,
                     float* __restrict__ img,
                     float* __restrict__ t_out, int k_cap) {
  __shared__ float sf[FWD_BATCH * NF];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int n = min(max(counts[row], 0), k_cap);
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  const size_t pix = static_cast<size_t>(row) * P + px;
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];

  float t = t_in ? t_in[pix] : 1.0f;
  float acc = 0.0f;
  bool done = !(t >= TRANSMITTANCE_EPS);
  bool all_done = __syncthreads_and(done);
  for (int base = 0; base < n && !all_done; base += FWD_BATCH) {
    const int m = min(FWD_BATCH, n - base);
    for (int i = px; i < m * NF; i += P)
      sf[i] = rf[static_cast<size_t>(base) * NF + i];
    __syncthreads();
    for (int k = 0; k < m && !done; ++k) {
      const float* f = sf + k * NF;
      const float la = log_alpha(f, b);
      if (!(la <= f[6] + SIGMA_GUARD_EPS)) continue;
      float a = expf(la);
      if (!(a >= ALPHA_THRESHOLD)) continue;
      a = fminf(a, ALPHA_CLAMP);
      const float t_inc = t * (1.0f - a);
      if (t_inc < TRANSMITTANCE_EPS) {
        t = t_inc;
        done = true;
        break;
      }
      acc += a * t;
      t = t_inc;
    }
    // also the barrier before the next batch overwrites sf
    all_done = __syncthreads_and(done);
  }
  img[pix] = acc;
  t_out[pix] = t;
}

__global__ void __launch_bounds__(P)
raster_v2_bwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ counts,
                     const float* __restrict__ basis,
                     const float* __restrict__ gt2,
                     const float* __restrict__ t_in,
                     float* __restrict__ dfeats, int k_cap) {
  __shared__ float sf[BWD_BATCH * NF];
  __shared__ float part[BWD_BATCH][WARPS][6];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const int n = min(max(counts[row], 0), k_cap);
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  float* rd = dfeats + static_cast<size_t>(row) * k_cap * NF;
  const size_t pix = static_cast<size_t>(row) * P + px;
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  const float g = gt2[pix];

  float t = t_in ? t_in[pix] : 1.0f;
  bool done = !(t >= TRANSMITTANCE_EPS);  // this pixel keeps nothing more
  bool all_done = __syncthreads_and(done);  // no pixel does: rows are zero
  for (int base = 0; base < n; base += BWD_BATCH) {
    const int m = min(BWD_BATCH, n - base);
    if (!all_done) {
      for (int i = px; i < m * NF; i += P)
        sf[i] = rf[static_cast<size_t>(base) * NF + i];
    }
    __syncthreads();
    if (!all_done) {
      for (int k = 0; k < m; ++k) {
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
                if (a < ALPHA_CLAMP) dla = a * (g / om);
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
    for (int i = px; i < m * NF; i += P) {
      const int k = i / NF;
      const int j = i % NF;
      float sum = 0.0f;
      if (!all_done && j < 6) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[k][w][j];
      }
      rd[static_cast<size_t>(base) * NF + i] = sum;
    }
    // also the barrier before the next batch overwrites sf and part
    all_done = __syncthreads_and(done);
  }
  // slots past the row's count: the walk never reaches them
  for (int i = n * NF + px; i < k_cap * NF; i += P) rd[i] = 0.0f;
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

int raster_v2_bwd(const float* feats, const int* counts, const float* basis,
                  const float* gt2, const float* t_in, float* dfeats,
                  int num_rows, int k_cap, void* stream) {
  if (num_rows > 0) {
    raster_v2_bwd_kernel<<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, counts, basis, gt2, t_in, dfeats, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
