// The kernel lab's chunked-scan dense compositor for Hopper (sm_90a):
// forward in four scan forms (one template, one instance each) and backward.
//
// Replaces scripts/kernel_lab.py::_fwd_kernel_v3 (:86, launched by fwd_v3
// :116) and ::_bwd_kernel_v3 (:172, by bwd_v3 :206), and
// scripts/cumprod_lab.py::_fwd_kernel (:134, by fwd :165) with its scans
// _scan_v3 (:55), _scan_none (:66), _scan_twolevel (:70) and _scan_matmul
// (:116). The lab prices what each form of the per-pixel transmittance
// scan costs on this card, beside the production csrc/raster_v2.cu (V0) on
// the same frame. The TPU's tile_block (rows per grid step, a VMEM layout
// knob) has no counterpart.
//
// Contract (edgegaussians_tpu_torch/lab/chunked.py): frame row r holds K
// depth-ordered slots feats[r, k, 0:8] (f32, row-major [T,K,8]); dead
// slots carry a -1e30 constant term (there are no counts). Every live slot
// is evaluated; nothing stops early. Per pixel px of the row's 16x16 tile
// (basis [8,256], rows 6-7 zero, row 5 the constant 1) and slot k:
//   log a = sum_{j<6} f_j * basis_j(px)   (full f32 FMAs)
//   ok = log a <= f_6 + 1e-3 and exp(log a) >= 1/255
//   a = ok ? min(exp(log a), 0.999) : 0;  om = 1 - a
//   t_inc = t_carry * scan(om)            (inclusive along the slots)
//   keep = t_inc >= 1e-4;  img += a * (t_inc / om) * keep
// t_out is the product over all K slots. The scan runs over a sub-chunk of
// SUB live slots, and the carry moves at the sub-chunk's end, so the chunk
// width only changes rounding; scan():
//   V3        the running product of om;
//   NOSCAN    om as it is (wrong by design: the scan's cost floor); the
//             carry moves only at the end of each `chunk` of slots, by the
//             chunk's last slot BY POSITION, as the JAX kernel's does;
//   TWOLEVEL  running products inside groups of 8, each times the product
//             of the earlier groups' tails: the true cumulative product
//             (the JAX _scan_twolevel reads each group's head instead and
//             returns the in-group product only; the port computes what the
//             script meant);
//   LOGSUM    exp of a running sum of log(max(om, 1e-30)).
//
// The backward takes g, t_in (null: 1), prior (null: 0; the contributions
// composited in front of this frame) and total [T,256], replays the V3
// forward and carries c_inc = prior + the running sum of a * t_prev * keep
// (t_prev = t_inc / om), suffix = total - c_inc,
//   d a = (t_prev - suffix / om) * keep * g
//   d log a = (ok and a < 0.999) ? a * d a : 0
//   dfeats[r, k, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7
// (the algebraic suffix of kernel_lab.py:184-203, not raster_v2's folded
// g * (1 - total)).
//
// Why skipping a dead slot is exact: its log a is the -1e30 constant term
// (times the basis's constant 1) plus five finite terms, so a = 0 on every
// pixel of the tile: om = 1, and t * 1, p * 1, s + log 1 = s + 0, img + 0,
// c_inc + 0 and d log a = 0 change no bit. A walk over the live slots alone
// computes the same bits as one over every slot. The test reads the marker,
// so it is uniform across the CTA and holds wherever dead slots lie. The
// one place a dead slot counts is NOSCAN's carry: at a chunk end it moves by
// the chunk's last slot, which leaves it as it is when that slot is dead
// (not the t_inc of the last live slot).
//
// What bounds it on this card: operations. The lab scene (lab/scene.py:
// 2500 rows x 128 slots, then 625 x 384) walks 143.4M slot-pixel
// evaluations by position, of which 93.9M are live (57.55M and 36.33M).
// Each live one is 16 flops and one expf (forward; the backward 29 flops
// and two special-function ops): 0.0224 ms (forward) and 0.0448 ms
// (backward) at the SFUs' 4.19 T/s, against ~0.005 ms for the 18.1 MB of
// frames at 3.35 TB/s. The issue rate is what the kernels can reach: a
// live evaluation is ~28 warp-lane instructions in the forward (two
// 16-byte shared loads, 6 FMAs, expf, the masks, the scan's multiply, the
// division by om, the accumulate), so ~0.08 ms at 132 SMs x 4 schedulers
// x 1.98 GHz.
//
// What the design does about it:
// - One CTA of 256 threads per frame row, one thread per pixel (no carry
//   crosses CTAs, no atomics). Each thread keeps its pixel's carry and
//   image sum (the backward also c_inc, g and total) in registers: no warp
//   shuffle, broadcast or warp sum per evaluation.
// - The row's slots are staged by position in cp.async double-buffered
//   batches (16 bytes a thread where feats is 16-byte aligned); the next
//   batch lands while this one computes. Every thread reads the same slot,
//   a shared-memory broadcast of two 16-byte loads. The basis stays in
//   registers (six values a pixel).
// - Each warp reads the batch's markers and ballots them (no barrier); a
//   batch with dead slots is compacted to its live slots in depth order
//   (one slot a thread of the first warps, one barrier), so only live slots
//   are walked, in sub-chunks of SUB: their t-free terms (log a, expf, the
//   masks) side by side, the form's factors, then the image terms, with
//   the division by om as __fdividef under the 1e-4 gate (om >= 0.001).
// - The forward's batches divide `chunk` (the largest of 128, 96, 64, 32
//   slots that does), so a chunk ends at a batch's end, where NOSCAN's
//   carry moves by the slot at that position, evaluated once more.
// - The backward replays V3 over sub-chunks of MT = 16 live slots, writes
//   each slot's d log a to the warp's [16 x 32] shared tile, and reduces
//   it over the pixels on the tensor cores (compositor.cuh's
//   tile_product, 3xTF32 mma.sync m16n8k8, f32 accumulators); the 8 warp
//   partials are added in warp order, and each slot goes out in two
//   16-byte stores (zeros for dead slots and for columns 6-7): a launch
//   gives the same bits every time.
// The measured times, against the bounds, are in PERF.md section 6.

#include "compositor.cuh"

namespace {

constexpr int SUB = 16;           // forward: live slots side by side
constexpr int FWD_BATCH = 128;    // forward: most slots staged per pass
constexpr int BWD_BATCH = 64;     // backward: slots staged per pass
constexpr int GROUP = 8;          // the two-level scan's group
constexpr float LOG_FLOOR = 1e-30f;
// a slot is dead where its constant term is at or below this (the marker
// is -1e30)
constexpr float DEAD_MARK = -1e29f;

enum Scan { V3 = 0, NOSCAN = 1, TWOLEVEL = 2, LOGSUM = 3 };

// alpha of the slot staged at fs (16-byte aligned shared memory, read in
// two 16-byte loads) for the pixel of basis values b: 0 unless valid and
// the guard and threshold pass; takes: ok and a < 0.999, where d log a is
// not zero
__device__ __forceinline__ float slot_alpha(const float* fs, const float* b,
                                            bool valid, bool& takes) {
  const float4 lo = reinterpret_cast<const float4*>(fs)[0];
  const float4 hi = reinterpret_cast<const float4*>(fs)[1];
  const float f[7] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
  const float la = log_alpha(f, b);
  const float x = expf(la);
  const bool ok = valid && la <= f[6] + SIGMA_GUARD_EPS &&
                  x >= ALPHA_THRESHOLD;
  takes = ok && x < ALPHA_CLAMP;
  return ok ? fminf(x, ALPHA_CLAMP) : 0.0f;
}

// Which of the batch's m slots, staged at sb, are live: bit l of mask[s]
// is slot 32 s + l. Every warp reads the markers and ballots for itself;
// returns how many are live.
template <int SEGS>
__device__ __forceinline__ int live_masks(const float* sb, int m,
                                          unsigned (&mask)[SEGS]) {
  const int lane = threadIdx.x & 31;
  int n = 0;
#pragma unroll
  for (int s = 0; s < SEGS; ++s) {
    const int k = 32 * s + lane;
    mask[s] = __ballot_sync(FULL_MASK,
                            k < m && !(sb[k * NF + 5] <= DEAD_MARK));
    n += __popc(mask[s]);
  }
  return n;
}

// Copy the batch's live slots from sb to cf in depth order, one slot a
// thread of the first SEGS warps; pos[k] (where pos is given) gets slot
// k's place in cf, -1 for a dead slot. The caller's barrier follows.
template <int SEGS>
__device__ __forceinline__ void compact(const float* sb,
                                        const unsigned (&mask)[SEGS],
                                        float* cf, int* pos) {
  const int k = threadIdx.x;
  if (k >= 32 * SEGS) return;
  const int seg = k >> 5;
  const unsigned below = (1u << (k & 31)) - 1u;
  unsigned own = 0u;
  int p = 0;
#pragma unroll
  for (int s = 0; s < SEGS; ++s) {   // no dynamic index into mask
    if (s < seg) p += __popc(mask[s]);
    if (s == seg) own = mask[s];
  }
  const bool live = (own >> (k & 31)) & 1u;
  p += __popc(own & below);
  if (live) {
    const float4* src = reinterpret_cast<const float4*>(sb + k * NF);
    float4* dst = reinterpret_cast<float4*>(cf + p * NF);
    dst[0] = src[0];
    dst[1] = src[1];
  }
  if (pos) pos[k] = live ? p : -1;
}

template <int SEGS>
__device__ __forceinline__ bool slot_live(const unsigned (&mask)[SEGS],
                                          int k) {
  unsigned word = 0u;
#pragma unroll
  for (int s = 0; s < SEGS; ++s)
    if (s == (k >> 5)) word = mask[s];
  return (word >> (k & 31)) & 1u;
}

// The inclusive transmittance factors of a sub-chunk's slots, in the SCAN
// form, from their om = 1 - a (1 for a pad past the live slots)
template <int SCAN>
__device__ __forceinline__ void scan_factors(const float (&om)[SUB],
                                             float (&fac)[SUB]) {
  if constexpr (SCAN == V3) {
    float p = 1.0f;
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      p *= om[r];
      fac[r] = p;
    }
  } else if constexpr (SCAN == NOSCAN) {
#pragma unroll
    for (int r = 0; r < SUB; ++r) fac[r] = om[r];
  } else if constexpr (SCAN == TWOLEVEL) {
    float excl = 1.0f;   // the product of the earlier groups' tails
#pragma unroll
    for (int g0 = 0; g0 < SUB; g0 += GROUP) {
      float x = 1.0f;
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        x *= om[g0 + i];
        fac[g0 + i] = x;
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i) fac[g0 + i] *= excl;
      excl *= x;
    }
  } else {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      s += logf(fmaxf(om[r], LOG_FLOOR));
      fac[r] = expf(s);
    }
  }
}

template <int SCAN>
__global__ void __launch_bounds__(P)
lab_fwd_kernel(const float* __restrict__ feats,
               const float* __restrict__ basis,
               const float* __restrict__ t_in, float* __restrict__ img,
               float* __restrict__ t_out, int k_cap, int chunk, int batch) {
  constexpr int SEGS = FWD_BATCH / 32;
  __shared__ __align__(16) float sf[2][FWD_BATCH * NF];
  __shared__ __align__(16) float cf[FWD_BATCH * NF];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const size_t pix = static_cast<size_t>(row) * P + px;
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  const bool vec16 = aligned16(feats);
  stage_async(sf[0], rf, min(batch, k_cap) * NF, vec16);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  float t = t_in ? t_in[pix] : 1.0f;
  float acc = 0.0f;
  int buf = 0;
  for (int base = 0; base < k_cap; base += batch, buf ^= 1) {
    const int m = min(batch, k_cap - base);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // this batch has landed, and every thread is done with the last one,
    // whose buffer the next batch now takes
    __syncthreads();
    const int next = base + batch;
    if (next < k_cap)
      stage_async(sf[buf ^ 1], rf + static_cast<size_t>(next) * NF,
                  min(batch, k_cap - next) * NF, vec16);
    const float* sb = sf[buf];
    unsigned mask[SEGS];
    const int n = live_masks(sb, m, mask);
    const float* fb = sb;
    if (n < m) {   // the same n in every warp
      compact(sb, mask, cf, nullptr);
      __syncthreads();
      fb = cf;
    }
    for (int m0 = 0; m0 < n; m0 += SUB) {
      // what does not depend on t, for SUB live slots side by side; a pad
      // past the last enters with a = 0, om = 1
      float a[SUB], om[SUB], fac[SUB];
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        bool takes;
        a[r] = slot_alpha(fb + (m0 + r) * NF, b, m0 + r < n, takes);
        om[r] = 1.0f - a[r];
      }
      scan_factors<SCAN>(om, fac);
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        const float t_inc = t * fac[r];
        acc = fmaf(t_inc >= TRANSMITTANCE_EPS ? a[r] : 0.0f,
                   __fdividef(t_inc, om[r]), acc);
      }
      if constexpr (SCAN != NOSCAN) t *= fac[SUB - 1];
    }
    if constexpr (SCAN == NOSCAN) {
      // where a chunk ends with this batch, the carry moves by the chunk's
      // last slot by position; when that slot is live it is the batch's
      // last live slot, and when it is dead the carry stays as it is
      if ((base + m) % chunk == 0 && slot_live(mask, m - 1)) {
        bool takes;
        t *= 1.0f - slot_alpha(fb + (n - 1) * NF, b, true, takes);
      }
    }
  }
  img[pix] = acc;
  t_out[pix] = t;
}

__global__ void __launch_bounds__(P)
lab_bwd_kernel(const float* __restrict__ feats,
               const float* __restrict__ basis, const float* __restrict__ g,
               const float* __restrict__ t_in,
               const float* __restrict__ prior,
               const float* __restrict__ total, float* __restrict__ dfeats,
               int k_cap) {
  constexpr int SEGS = BWD_BATCH / 32;
  __shared__ __align__(16) float sf[2][BWD_BATCH * NF];
  __shared__ __align__(16) float cf[BWD_BATCH * NF];
  __shared__ int pos[BWD_BATCH];
  __shared__ __align__(16) float dt[WARPS][MT * DSTRIDE];
  __shared__ __align__(16) float part[WARPS][BWD_BATCH * NJ];
  const int row = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int warp = px >> 5;
  const int grp = lane >> 2;   // the fragments' row (A) and column (B)
  const int tig = lane & 3;    // the fragments' column (A) and row (B)
  const size_t pix = static_cast<size_t>(row) * P + px;
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  float* rd = dfeats + static_cast<size_t>(row) * k_cap * NF;
  const bool vec16 = aligned16(feats);
  stage_async(sf[0], rf, min(BWD_BATCH, k_cap) * NF, vec16);
  float b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = basis[j * P + px];
  float t = t_in ? t_in[pix] : 1.0f;
  float c = prior ? prior[pix] : 0.0f;   // c_inc
  const float gp = g[pix];
  const float tot = total[pix];
  unsigned bhi[KSTEPS][2], blo[KSTEPS][2];
  const bool b_exact = basis_fragments(basis, warp, grp, tig, bhi, blo);
  float* dw = dt[warp];
  int buf = 0;
  for (int base = 0; base < k_cap; base += BWD_BATCH, buf ^= 1) {
    const int m = min(BWD_BATCH, k_cap - base);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // this batch has landed, and every thread is done with the last one:
    // its buffer, cf, pos and part may be overwritten
    __syncthreads();
    const int next = base + BWD_BATCH;
    if (next < k_cap)
      stage_async(sf[buf ^ 1], rf + static_cast<size_t>(next) * NF,
                  min(BWD_BATCH, k_cap - next) * NF, vec16);
    const float* sb = sf[buf];
    unsigned mask[SEGS];
    const int n = live_masks(sb, m, mask);
    const float* fb = sb;
    if (n < m) {   // the same n in every warp
      compact(sb, mask, cf, pos);
      __syncthreads();
      fb = cf;
    }
    for (int m0 = 0; m0 < n; m0 += MT) {
      // what does not depend on t, for MT live slots side by side
      float a[MT], om[MT], fac[MT];
      unsigned takes = 0u;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        bool tk;
        a[r] = slot_alpha(fb + (m0 + r) * NF, b, m0 + r < n, tk);
        om[r] = 1.0f - a[r];
        takes |= static_cast<unsigned>(tk) << r;
      }
      float p = 1.0f;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        p *= om[r];
        fac[r] = p;
      }
      bool any = false;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float t_inc = t * fac[r];
        const bool keep = t_inc >= TRANSMITTANCE_EPS;
        const float t_prev = __fdividef(t_inc, om[r]);
        c = fmaf(keep ? a[r] : 0.0f, t_prev, c);
        const float dla = keep && ((takes >> r) & 1u)
            ? a[r] * ((t_prev - __fdividef(tot - c, om[r])) * gp) : 0.0f;
        dw[r * DSTRIDE + lane] = dla;
        any |= dla != 0.0f;
      }
      t *= fac[MT - 1];
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
    // the batch's m slots: a live one's 8 warp partials added in warp
    // order, zeros for a dead one; half h of a slot is columns 4 h .. 4 h + 3
    for (int i = px; i < m * (NF / 4); i += P) {
      const int k = i >> 1;
      const int h = i & 1;
      const int q = n == m ? k : pos[k];
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * h + jj;
        float sum = 0.0f;
        if (q >= 0 && j < NJ) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += part[w][q * NJ + j];
        }
        v[jj] = sum;
      }
      *reinterpret_cast<float4*>(rd + static_cast<size_t>(base + k) * NF +
                                 4 * h) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// the forward's batch: the largest of 128, 96, 64 and 32 slots that
// divides chunk (a multiple of 32), so that every chunk ends at a batch's
// end
int fwd_batch(int chunk) {
  for (int segs = FWD_BATCH / 32; segs > 1; --segs)
    if ((chunk / 32) % segs == 0) return 32 * segs;
  return 32;
}

template <int SCAN>
int launch_fwd(const float* feats, const float* basis, const float* t_in,
               float* img, float* t_out, int num_rows, int k_cap, int chunk,
               void* stream) {
  if (chunk < 32 || chunk % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows > 0) {
    lab_fwd_kernel<SCAN><<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, basis, t_in, img, t_out, k_cap, chunk, fwd_batch(chunk));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// t_in may be null (transmittance 1); chunk is a multiple of 32 dividing
// k_cap (else the entry launches nothing and returns cudaErrorInvalidValue;
// only the NOSCAN form's result depends on it).
int lab_fwd_v3(const float* feats, const float* basis, const float* t_in,
               float* img, float* t_out, int num_rows, int k_cap, int chunk,
               void* stream) {
  return launch_fwd<V3>(feats, basis, t_in, img, t_out, num_rows, k_cap,
                        chunk, stream);
}

int lab_fwd_noscan(const float* feats, const float* basis,
                   const float* t_in, float* img, float* t_out,
                   int num_rows, int k_cap, int chunk, void* stream) {
  return launch_fwd<NOSCAN>(feats, basis, t_in, img, t_out, num_rows,
                            k_cap, chunk, stream);
}

int lab_fwd_twolevel(const float* feats, const float* basis,
                     const float* t_in, float* img, float* t_out,
                     int num_rows, int k_cap, int chunk, void* stream) {
  return launch_fwd<TWOLEVEL>(feats, basis, t_in, img, t_out, num_rows,
                              k_cap, chunk, stream);
}

int lab_fwd_logsum(const float* feats, const float* basis,
                   const float* t_in, float* img, float* t_out,
                   int num_rows, int k_cap, int chunk, void* stream) {
  return launch_fwd<LOGSUM>(feats, basis, t_in, img, t_out, num_rows,
                            k_cap, chunk, stream);
}

// t_in (null: 1) and prior (null: 0) may be null; g and total may not.
// dfeats must be 16-byte aligned (the wrapper allocates it); else the entry
// launches nothing and returns cudaErrorMisalignedAddress.
int lab_bwd_v3(const float* feats, const float* basis, const float* g,
               const float* t_in, const float* prior, const float* total,
               float* dfeats, int num_rows, int k_cap, void* stream) {
  if (!aligned16(dfeats))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (num_rows > 0) {
    lab_bwd_kernel<<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, basis, g, t_in, prior, total, dfeats, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
