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
// slots feats[r, k, 0:8] (f32, row-major [T,K,8]). There are no counts:
// a slot is dead where its constant term carries the marker that
// tiles.build_tile_features (and the JAX tiles.py:669) writes, -1e30 (a
// slot past the tile's count, or an invalid Gaussian inside it). One 16x16
// tile has P = 256 pixels whose monomial basis is basis [8,256], whose
// constant row (j = 5) is 1 (tiles.pixel_basis). Per slot and pixel, with
// the transmittance carried in LOG space as pallas_raster.py's
// _alpha_terms (:63-87) does:
//   log a = sum_{j<6} f_j * basis_j(px)          (full f32 FMAs)
//   a = exp(log a);  ok = log a <= f_6 + SIGMA_GUARD_EPS and a >= 1/255
//   a = ok ? min(a, 0.999) : 0
//   l = log1p(-a);  lt += l;  keep = lt >= log(1e-4)
//   T_prev = exp(lt - l);  img += a * T_prev * keep
// This is v1's rounding (a log-sum, not v2's product of (1 - a)), kept as
// the contract. lt never rises, so once keep is 0 it stays 0.
// The backward uses the suffix form
//   d a = (T_prev - (total - c_inc) / (1 - a)) * keep * g,
//   d log a = a * d a where ok and a < 0.999,
//   dfeats[r, k, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7,
// with c_inc the running sum of a * T_prev * keep along the slots. It takes
// the total from the forward image rather than recomputing it in a first
// pass: the forward adds a * T_prev in the same order the backward carries
// c_inc, so the image IS that total. (The TPU kernel recomputes it
// in-kernel because its forward and backward are separate grid programs
// with no image input.)
//
// Why the kernels skip the marked slots, and why that is exact: a marked
// slot's log a is the constant term -1e30 (times the basis's 1) plus five
// finite terms, far below log(1/255), so a = 0 on every pixel; then
// l = log1p(-0) = -0, and lt + l = lt, img + 0 = img, c_inc + 0 = c_inc and
// d log a = 0, bit for bit. Walking such a slot changes nothing, so a walk
// over the other slots alone computes the same bits, for any input whose
// other five terms stay finite (and far from 1e29). Liveness comes from the
// marker, not from a count: the marker also catches the invalid Gaussians
// inside a tile's count, which a count would walk.
//
// What bounds it on this card: its least time is the bytes'. The whole
// [T,K,8] frame has to pass (the backward writes as much again), and one
// slot is one 32-byte sector, so reading only each slot's marker moves the
// same bytes as reading it all. Its time is the longest rows' walks: a
// serial chain of live slots on one SM. The measured times, against the
// bounds, are in PERF.md section 6.
//
// What the design does about it, one CTA per tile and one thread per pixel
// (so no carry crosses CTAs and the backward needs no atomics):
// - Find: the CTA reads the markers of up to CHUNK = 1024 slots (4 a
//   thread, one 4-byte load each), and warp ballots, __popc prefixes and
//   one warp's scan of the 32 segment counts compact the live slot indices
//   into a list in depth order, in shared memory. K > CHUNK takes the row
//   in chunks, the walk's state carried across them. A row with no live
//   slot writes its zero image row (the backward: its zero rows) and ends.
// - Stage: the live slots' 32-byte rows are gathered by the list into
//   shared memory with cp.async (two 16-byte copies a slot where feats is
//   16-byte aligned, else eight 4-byte ones), double-buffered in batches.
// - Walk: the t-free terms of 16 slots side by side (log a, expf, the
//   masks), then per slot l = log1pf(-a) and the chain as one dependent
//   add (lt += l), with the keep test, expf(lt - l) and the accumulate off
//   it. A slot whose alpha is 0 on all 32 pixels of a warp (a live slot
//   whose footprint misses the warp's two pixel rows, or that the
//   threshold drops there) is skipped by the warp, uniformly: it would add
//   exact zeros, for one vote a slot. A pixel walks on
//   past its stop with keep 0, which adds exact zeros, so the image is the
//   serial loop's with a break; a warp whose pixels are all done skips the
//   rest of its batch, and the CTA leaves the row once every pixel is.
// - The backward: the same find, stage and walk, with c_inc carried beside
//   lt, the suffix's division by 1 - a as __fdividef (as in the seg and
//   dense backwards: 1 - a >= 0.001), and the pixel reduction of each
//   group of 16 live slots on the tensor cores (compositor.cuh's
//   tile_product, 3xTF32 mma.sync), the 8 warp partials added in warp
//   order: deterministic.
//   Dead slots get their zeros in 16-byte stores straight after the find,
//   live slots their sums (or zeros, past the walk) after each batch.
// - dfeats must be 16-byte aligned for the float4 zero stores: the wrapper
//   allocates it, and the entry refuses an unaligned one (raster_v1_bwd).
// The variants measured and not taken are in PERF.md section 6.

#include "compositor.cuh"

namespace {

constexpr int CHUNK = 4 * P;     // slots whose markers the find reads at once
constexpr int SEGS = CHUNK / 32; // ballot segments of 32 slots in a chunk
constexpr int FWD_BATCH = 128;   // live slots staged per pass (2 x 4 KB)
constexpr int BWD_BATCH = 64;    // live slots staged per pass (2 x 2 KB)
constexpr int GROUP = 16;        // slots whose t-free terms go side by side
// a slot is dead where its constant term is at or below this (the marker
// is -1e30)
constexpr float DEAD_MARK = -1e29f;
// float32(log(1e-4)) as the JAX package computes it (np.log in float64)
constexpr float LOG_TRANSMITTANCE_EPS = -9.210340371976182f;

// The find phase over slots [c0, c0 + len) of the row at rf (len <=
// CHUNK): writes the live slots' indices (in the row) to list in depth
// order, and to mask[s] the ballot of live slots among the chunk's slots
// [32 s, 32 s + 32); returns how many are live. Every thread of the CTA
// calls it; it starts and ends with a barrier, so it may reuse list, mask
// and offs of an earlier chunk, and its results are read after it.
__device__ __forceinline__ int find_live(const float* rf, int c0, int len,
                                         int* list, unsigned* mask,
                                         int* offs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float mark[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = i * P + threadIdx.x;
    mark[i] = k < len ? rf[static_cast<size_t>(c0 + k) * NF + 5] : DEAD_MARK;
  }
  __syncthreads();   // an earlier chunk's list, mask and offs are read
  unsigned bal[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // segment i * WARPS + warp holds the chunk's slots from 32 times that
    bal[i] = __ballot_sync(FULL_MASK, !(mark[i] <= DEAD_MARK));
    if (lane == 0) mask[i * WARPS + warp] = bal[i];
  }
  __syncthreads();
  if (warp == 0) {   // exclusive prefix of the SEGS = 32 segment counts
    const int cnt = __popc(mask[lane]);
    int inc = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, inc, off);
      if (lane >= off) inc += v;
    }
    offs[lane] = inc - cnt;
    if (lane == 31) offs[SEGS] = inc;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if ((bal[i] >> lane) & 1u)
      list[offs[i * WARPS + warp] + __popc(bal[i] & below)] =
          c0 + i * P + threadIdx.x;
  }
  __syncthreads();
  return offs[SEGS];
}

// Start copying the rows of the m slots list[0, m) of the row at rf into
// dst (m x NF floats) without waiting: two 16-byte copies a slot where
// feats is 16-byte aligned, else eight 4-byte ones.
__device__ __forceinline__ void stage_list_async(float* dst, const float* rf,
                                                 const int* list, int m,
                                                 bool vec16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec16) {
    for (int i = threadIdx.x; i < 2 * m; i += P)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d + 16 * i),
                   "l"(rf + static_cast<size_t>(list[i >> 1]) * NF +
                       4 * (i & 1)));
  } else {
    for (int i = threadIdx.x; i < NF * m; i += P)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(d + 4 * i),
                   "l"(rf + static_cast<size_t>(list[i >> 3]) * NF +
                       (i & 7)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The next batch [next, n) of the list into buf (or an empty group, which
// keeps the wait uniform), then wait for the current one and sync.
__device__ __forceinline__ void next_batch(float* buf, const float* rf,
                                           const int* list, int next, int n,
                                           int batch, bool vec16) {
  if (next < n)
    stage_list_async(buf, rf, list + next, min(batch, n - next), vec16);
  else
    asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
}

// What does not depend on lt, for slot f at this pixel: alpha (0 where the
// guard or the threshold drops it) and whether d log a is taken (ok and
// a < 0.999).
__device__ __forceinline__ float v1_alpha(const float* f, const float* b,
                                          bool in_batch, bool& takes_grad) {
  const float la = log_alpha(f, b);
  const float x = expf(la);
  const bool ok = in_batch && la <= f[6] + SIGMA_GUARD_EPS &&
                  x >= ALPHA_THRESHOLD;
  const float a = fminf(x, ALPHA_CLAMP);
  takes_grad = ok && a < ALPHA_CLAMP;
  return ok ? a : 0.0f;
}

__global__ void __launch_bounds__(P)
raster_v1_fwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ basis,
                     float* __restrict__ img, int k_cap) {
  __shared__ __align__(16) float sf[2][FWD_BATCH * NF];
  __shared__ int list[CHUNK];
  __shared__ unsigned mask[SEGS];
  __shared__ int offs[SEGS + 1];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  const bool vec16 = aligned16(feats);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];

  float lt = 0.0f;
  float acc = 0.0f;
  bool stop = false;
  for (int c0 = 0; c0 < k_cap && !stop; c0 += CHUNK) {
    const int n = find_live(rf, c0, min(CHUNK, k_cap - c0), list, mask,
                            offs);
    if (n == 0) continue;
    stage_list_async(sf[0], rf, list, min(FWD_BATCH, n), vec16);
    int buf = 0;
    for (int base = 0; base < n; base += FWD_BATCH, buf ^= 1) {
      const int m = min(FWD_BATCH, n - base);
      // the next batch lands in the other buffer while this one computes
      next_batch(sf[buf ^ 1], rf, list, base + FWD_BATCH, n, FWD_BATCH,
                 vec16);
      const float* fb = sf[buf];
      for (int m0 = 0; m0 < m; m0 += GROUP) {
        // a warp whose pixels are all done skips the rest of the batch
        if (__all_sync(FULL_MASK, !(lt >= LOG_TRANSMITTANCE_EPS))) break;
        float a[GROUP];
        unsigned nz = 0u;   // slots with alpha > 0 on a pixel of the warp
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          bool unused;
          a[r] = v1_alpha(fb + (m0 + r) * NF, b, m0 + r < m, unused);
          nz |= static_cast<unsigned>(__any_sync(FULL_MASK, a[r] != 0.0f))
                << r;
        }
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          if ((nz >> r) & 1u) {
            const float l = log1pf(-a[r]);
            lt += l;
            acc = fmaf(lt >= LOG_TRANSMITTANCE_EPS ? a[r] : 0.0f,
                       expf(lt - l), acc);
          }
        }
      }
      // the CTA stops once every pixel is done; also the barrier before
      // the next batch's prefetch overwrites this batch's buffer
      stop = __syncthreads_and(!(lt >= LOG_TRANSMITTANCE_EPS));
      if (stop) break;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  img[static_cast<size_t>(row) * P + px] = acc;
}

__global__ void __launch_bounds__(P)
raster_v1_bwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ basis,
                     const float* __restrict__ g_in,
                     const float* __restrict__ total_in,
                     float* __restrict__ dfeats, int k_cap) {
  __shared__ __align__(16) float sf[2][BWD_BATCH * NF];
  __shared__ __align__(16) float dt[WARPS][MT * DSTRIDE];
  __shared__ __align__(16) float part[WARPS][BWD_BATCH * NJ];
  __shared__ int list[CHUNK];
  __shared__ unsigned mask[SEGS];
  __shared__ int offs[SEGS + 1];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const int grp = lane >> 2;   // the fragments' row (A) and column (B)
  const int tig = lane & 3;    // the fragments' column (A) and row (B)
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  float* rd = dfeats + static_cast<size_t>(row) * k_cap * NF;
  const bool vec16 = aligned16(feats);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  const size_t pix = static_cast<size_t>(row) * P + px;
  const float g = g_in[pix];
  const float total = total_in[pix];
  unsigned bhi[KSTEPS][2], blo[KSTEPS][2];
  const bool b_exact = basis_fragments(basis, warp, grp, tig, bhi, blo);
  float* dw = dt[warp];

  float lt = 0.0f;   // log transmittance after the slot
  float c = 0.0f;    // sum of a * T_prev * keep up to and including it
  int walked = k_cap;  // slots [walked, k_cap) are past every pixel's stop
  for (int c0 = 0; c0 < k_cap; c0 += CHUNK) {
    const int len = min(CHUNK, k_cap - c0);
    const int n = find_live(rf, c0, len, list, mask, offs);
    // the chunk's dead slots: zeros, in 16-byte stores (slot k of the
    // chunk is bit k % 32 of mask[k / 32])
    float4* dz = reinterpret_cast<float4*>(rd + static_cast<size_t>(c0) * NF);
    for (int i = px; i < len * (NF / 4); i += P) {
      const int k = i >> 1;
      if (!((mask[k >> 5] >> (k & 31)) & 1u))
        dz[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (n == 0) continue;
    stage_list_async(sf[0], rf, list, min(BWD_BATCH, n), vec16);
    int written = 0;   // list[0, written) of the chunk are out
    bool stop = false;
    int buf = 0;
    for (int base = 0; base < n; base += BWD_BATCH, buf ^= 1) {
      const int m = min(BWD_BATCH, n - base);
      next_batch(sf[buf ^ 1], rf, list, base + BWD_BATCH, n, BWD_BATCH,
                 vec16);
      const float* fb = sf[buf];
      for (int m0 = 0; m0 < m; m0 += MT) {
        bool any = false;
        if (!__all_sync(FULL_MASK, !(lt >= LOG_TRANSMITTANCE_EPS))) {
          // what does not depend on lt, for the MT slots side by side
          float a[MT];
          unsigned grad = 0u, nz = 0u;
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            bool takes;
            a[r] = v1_alpha(fb + (m0 + r) * NF, b, m0 + r < m, takes);
            grad |= static_cast<unsigned>(takes) << r;
            nz |= static_cast<unsigned>(__any_sync(FULL_MASK, a[r] != 0.0f))
                  << r;
          }
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            float dla = 0.0f;
            if ((nz >> r) & 1u) {
              const float l = log1pf(-a[r]);
              lt += l;
              const bool keep = lt >= LOG_TRANSMITTANCE_EPS;
              const float t_prev = expf(lt - l);
              c = fmaf(keep ? a[r] : 0.0f, t_prev, c);
              if (keep && ((grad >> r) & 1u))
                dla = a[r] *
                    ((t_prev - __fdividef(total - c, 1.0f - a[r])) * g);
            }
            dw[r * DSTRIDE + lane] = dla;
            any |= dla != 0.0f;
          }
        }
        __syncwarp();
        // this warp's partial of the MT slots: D [16 x 32] @ B [32 x 8]
        float cc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (__any_sync(FULL_MASK, any))
          tile_product(dw, grp, tig, bhi, blo, b_exact, cc);
        __syncwarp();   // D is read before the next MT slots overwrite it
        if (tig < NJ / 2) {   // columns 2 tig, 2 tig + 1 of rows grp, grp + 8
          float* pw = part[warp] + (m0 + grp) * NJ + 2 * tig;
          *reinterpret_cast<float2*>(pw) = make_float2(cc[0], cc[1]);
          *reinterpret_cast<float2*>(pw + 8 * NJ) = make_float2(cc[2], cc[3]);
        }
      }
      __syncthreads();
      // the batch's m live slots, the 8 warp partials added in warp order:
      // half h of a slot is columns 4 h .. 4 h + 3
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
        *reinterpret_cast<float4*>(
            rd + static_cast<size_t>(list[base + k]) * NF + 4 * h) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      written = base + m;
      // the CTA leaves the row once every pixel is done; also the barrier
      // before the next batch's prefetch overwrites this batch's buffer
      // and the warps overwrite part
      stop = __syncthreads_and(!(lt >= LOG_TRANSMITTANCE_EPS));
      if (stop) break;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // the chunk's live slots the walk never reached: zeros
    for (int i = px; i < (n - written) * (NF / 4); i += P)
      reinterpret_cast<float4*>(
          rd + static_cast<size_t>(list[written + (i >> 1)]) * NF)[i & 1] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (stop) {
      walked = c0 + len;
      break;
    }
  }
  // the chunks the walk never reached
  if (walked < k_cap)
    zero_slots(rd + static_cast<size_t>(walked) * NF, k_cap - walked);
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

// dfeats must be 16-byte aligned (the wrapper allocates it); else the entry
// launches nothing and returns cudaErrorMisalignedAddress.
int raster_v1_bwd(const float* feats, const float* basis, const float* g,
                  const float* total, float* dfeats, int num_rows, int k_cap,
                  void* stream) {
  if (!aligned16(dfeats))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (num_rows > 0) {
    raster_v1_bwd_kernel<<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, basis, g, total, dfeats, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
