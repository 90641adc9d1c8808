// v1 log-space dense compositor for Hopper (sm_90a): forward and backward.
//
// Replaces edgegaussians_tpu/ops/pallas_raster.py::_fwd_kernel (:90) and
// ::_bwd_kernel (:97), launched there by composite_fwd (:129) and
// composite_bwd (:163). It ports what those kernels compute, not their
// layout: the [T,8,K] lane layout, the one-hot log-opacity selector matmul
// and the Hillis-Steele roll scans exist for the TPU's Mosaic compiler and
// have no counterpart here.
//
// Input contract (built by ops/composite.py): tile r holds K depth-ordered
// slots feats[r, k, 0:8] (f32, row-major [T,K,8]), and the kernel walks
// all K of them: there are no counts. Invalid slots carry a -1e30 constant
// term, so their alpha is exactly 0 (and log(1 - 0) = 0). One 16x16 tile
// has P = 256 pixels whose monomial basis is basis [8,256]. Per slot and
// pixel, with the transmittance carried in LOG space as pallas_raster.py's
// _alpha_terms (:63-87) does:
//   log a = sum_{j<6} f_j * basis_j(px)          (full f32 FMAs)
//   a = exp(log a);  ok = log a <= f_6 + SIGMA_GUARD_EPS and a >= 1/255
//   a = ok ? min(a, 0.999) : 0
//   l = log1p(-a);  lt += l;  keep = lt >= log(1e-4)
//   T_prev = exp(lt - l);  img += a * T_prev * keep
// This is v1's rounding (a log-sum, not v2's product of (1 - a)), kept as
// the contract. lt never rises, so a pixel stops at its first dropped slot
// without changing the result.
// The backward uses the suffix form
//   d a = (T_prev - (total - c_inc) / (1 - a)) * keep * g,
//   d log a = a * d a where ok and a < 0.999,
//   dfeats[r, k, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7,
// with c_inc the running sum of a * T_prev * keep along the slots. It takes
// the total from the forward image rather than recomputing it in a first
// pass: the forward adds a * T_prev in the same order the backward carries
// c_inc, so the image IS that total, and a second walk would double the
// backward's dependent chain for nothing. (The TPU kernel recomputes it
// in-kernel because its forward and backward are separate grid programs
// with no image input.)
//
// What bounds it on this card: not bytes (the [T,K,8] frame is ~61 MB at
// the fixture's T = 2500, K = 768, ~18 us at 3.35 TB/s) but the serial
// per-pixel chain: every pixel walks its tile's slots in depth order, with
// two transcendentals (exp, log1p) and a third exp for T_prev on every
// live slot, and most of the K slots are empty (the frame is dense; real
// edge scenes hold ~9M live slot-pixel evaluations per view against
// T * K * 256 = 491M).
//
// What the design does about it: one CTA per tile, one thread per pixel;
// slots staged in shared memory in batches (one coalesced load per batch,
// broadcast reads after). A slot with ok false has a = 0 and l = 0, so it
// is skipped before the log1p and exp. A pixel stops at its first dropped
// slot and the CTA stops when all its pixels have (__syncthreads_and); the
// backward still writes zero rows for the slots it does not walk. The
// backward sums each slot's six values with warp shuffles (skipped when
// the whole warp holds zeros) and a cross-warp sum in shared memory per
// batch; each slot's row belongs to one CTA, so the result is a plain
// deterministic store.

#include <cuda_runtime.h>

namespace {

constexpr int P = 256;           // pixels of a 16x16 tile = threads per CTA
constexpr int NF = 8;            // features per slot
constexpr int WARPS = P / 32;
constexpr int FWD_BATCH = 256;   // slots staged per pass (8 KB)
constexpr int BWD_BATCH = 128;   // slots staged per pass (4 KB + 24 KB)
constexpr float ALPHA_THRESHOLD = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.999f;
constexpr float SIGMA_GUARD_EPS = 1e-3f;
// float32(log(1e-4)) as the JAX package computes it (np.log in float64)
constexpr float LOG_TRANSMITTANCE_EPS = -9.210340371976182f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float log_alpha(const float* f, const float* b) {
  float la = f[0] * b[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) la = fmaf(f[j], b[j], la);
  return la;
}

// alpha of one slot at one pixel, 0 where masked (pallas_raster.py:77-81)
__device__ __forceinline__ float slot_alpha(const float* f, const float* b) {
  const float la = log_alpha(f, b);
  const float a = expf(la);
  const bool ok = (la <= f[6] + SIGMA_GUARD_EPS) && (a >= ALPHA_THRESHOLD);
  return ok ? fminf(a, ALPHA_CLAMP) : 0.0f;
}

__global__ void __launch_bounds__(P)
raster_v1_fwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ basis,
                     float* __restrict__ img, int k_cap) {
  __shared__ float sf[FWD_BATCH * NF];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];

  float lt = 0.0f;
  float acc = 0.0f;
  bool done = false;
  for (int base = 0; base < k_cap; base += FWD_BATCH) {
    const int m = min(FWD_BATCH, k_cap - base);
    for (int i = px; i < m * NF; i += P)
      sf[i] = rf[static_cast<size_t>(base) * NF + i];
    __syncthreads();
    for (int k = 0; k < m && !done; ++k) {
      const float a = slot_alpha(sf + k * NF, b);
      if (a == 0.0f) continue;
      const float l = log1pf(-a);
      lt += l;
      if (!(lt >= LOG_TRANSMITTANCE_EPS)) {
        done = true;
        break;
      }
      acc += a * expf(lt - l);
    }
    // also the barrier before the next batch overwrites sf
    if (__syncthreads_and(done)) break;
  }
  img[static_cast<size_t>(row) * P + px] = acc;
}

__global__ void __launch_bounds__(P)
raster_v1_bwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ basis,
                     const float* __restrict__ g_in,
                     const float* __restrict__ total_in,
                     float* __restrict__ dfeats, int k_cap) {
  __shared__ float sf[BWD_BATCH * NF];
  __shared__ float part[BWD_BATCH][WARPS][6];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  float* rd = dfeats + static_cast<size_t>(row) * k_cap * NF;
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  const size_t pix = static_cast<size_t>(row) * P + px;
  const float g = g_in[pix];
  const float total = total_in[pix];

  float lt = 0.0f;         // log transmittance after the slot
  float c = 0.0f;          // sum of a * T_prev up to and including the slot
  bool done = false;       // this pixel keeps nothing more
  bool all_done = false;   // no pixel does: rows are zero
  for (int base = 0; base < k_cap; base += BWD_BATCH) {
    const int m = min(BWD_BATCH, k_cap - base);
    if (!all_done) {
      for (int i = px; i < m * NF; i += P)
        sf[i] = rf[static_cast<size_t>(base) * NF + i];
    }
    __syncthreads();
    if (!all_done) {
      for (int k = 0; k < m; ++k) {
        float dla = 0.0f;
        if (!done) {
          const float a = slot_alpha(sf + k * NF, b);
          if (a != 0.0f) {
            const float l = log1pf(-a);
            lt += l;
            if (!(lt >= LOG_TRANSMITTANCE_EPS)) {
              done = true;
            } else {
              const float t_prev = expf(lt - l);
              c += a * t_prev;
              const float da = (t_prev - (total - c) / (1.0f - a)) * g;
              if (a < ALPHA_CLAMP) dla = a * da;
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
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
int raster_v1_fwd(const float* feats, const float* basis, float* img,
                  int num_rows, int k_cap, void* stream) {
  if (num_rows > 0) {
    raster_v1_fwd_kernel<<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, basis, img, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

int raster_v1_bwd(const float* feats, const float* basis, const float* g,
                  const float* total, float* dfeats, int num_rows, int k_cap,
                  void* stream) {
  if (num_rows > 0) {
    raster_v1_bwd_kernel<<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, basis, g, total, dfeats, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
