// The kernel lab's chunked-scan dense compositor for Hopper (sm_90a):
// forward in four scan forms (one template instance each) and backward.
//
// Replaces scripts/kernel_lab.py::_fwd_kernel_v3 (:86, launched by fwd_v3
// :116) and ::_bwd_kernel_v3 (:172, by bwd_v3 :206), and
// scripts/cumprod_lab.py::_fwd_kernel (:134, by fwd :165) with its scans
// _scan_v3 (:55), _scan_none (:66), _scan_twolevel (:70) and _scan_matmul
// (:116). The lab measures the cost of the per-pixel transmittance scan
// ACROSS slots, so this layout puts slots across the lanes of a warp,
// unlike the production csrc/raster_v2.cu, which walks one thread per
// pixel along the slots. The TPU's tile_block (rows per grid step, a VMEM
// layout knob) has no counterpart.
//
// Contract (edgegaussians_tpu_torch/lab/chunked.py): frame row r holds K
// depth-ordered slots feats[r, k, 0:8] (f32, row-major [T,K,8]); dead
// slots carry a -1e30 constant term, so their alpha is 0 (there are no
// counts). Every slot is evaluated; nothing stops early. Per pixel px of
// the row's 16x16 tile (basis [8,256]) and slot k:
//   log a = sum_{j<6} f_j * basis_j(px)   (full f32 FMAs; basis rows 6-7
//                                          are zero)
//   ok = log a <= f_6 + 1e-3 and exp(log a) >= 1/255
//   a = ok ? min(exp(log a), 0.999) : 0;  om = 1 - a
//   t_inc = t_carry * scan(om)            (inclusive along the slots)
//   keep = t_inc >= 1e-4;  img += a * (t_inc / om) * keep
// t_out is t_carry after all K slots. scan():
//   V3        inclusive product: 5 __shfl_up_sync steps over the 32 lanes;
//   NOSCAN    om as it is (wrong by design: the scan's cost floor); the
//             carry moves only at the end of each `chunk` of slots, as the
//             JAX kernel's does;
//   TWOLEVEL  3 in-group steps over groups of 8 lanes, then the exclusive
//             product of the lower groups' tails (3 broadcasts): the true
//             cumulative product (the JAX _scan_twolevel reads each
//             group's head instead and returns the in-group product only;
//             the port computes what the script meant);
//   LOGSUM    a 5-step sum scan of log(max(om, 1e-30)), then expf.
// A sub-chunk is one warp's 32 slots; the carry between sub-chunks is lane
// 31's t_inc, so the chunk width only changes rounding (NOSCAN aside).
//
// The backward takes g, t_in (null: 1), prior (null: 0; the contributions
// composited in front of this frame) and total [T,256], replays the V3
// forward and scans the contributions: c_inc = prior + inclusive sum of
// a * t_prev * keep (t_prev = t_inc / om), suffix = total - c_inc,
//   d a = (t_prev - suffix / om) * keep * g
//   d log a = (ok and a < 0.999) ? a * d a : 0
//   dfeats[r, k, j] = sum_px d log a * basis_j(px) for j < 6; 0 for j = 6, 7
// (the algebraic suffix of kernel_lab.py:184-203, not raster_v2's folded
// g * (1 - total)).
//
// What bounds it on this card: operations. The labs' level-1 frame is
// 2500 rows x 128 slots x 256 pixels = 81.9M slot-pixel evaluations (16
// flops and one expf each: ~20 us at 67 TFLOP/s f32 and the SFUs' rate)
// over 10.2 MB of features and 2.56 MB per [T,256] plane (~5 us at 3.35
// TB/s). This layout adds what the lab exists to price: per evaluation a
// lane-level scan (5 shuffles), a broadcast of the pixel's carry, a warp
// sum of the image term (5 shuffles) and the new carry's broadcast; the
// backward adds the sum scan and the cotangent's broadcasts. Shuffles issue
// at one warp instruction per SM clock, so they, not the FLOPs, set the
// time.
//
// What the design does about it: one CTA of 8 warps per frame row (no
// carry crosses CTAs, no atomics); warp w owns pixels 32w..32w+31, and
// lane i keeps pixel 32w+i's carry and image sum in registers, so a warp
// walks its 32 pixels one after the other over a sub-chunk whose 32 slots'
// features stay in registers (read once per warp, L1 serves the other 7).
// The basis is staged in shared memory and read as broadcasts. The
// backward accumulates each slot's six sums over the warp's pixels in
// registers, then adds the 8 warps' partials in a fixed order through
// shared memory: a launch gives the same bits every time.

#include <cuda_runtime.h>

namespace {

constexpr int P = 256;            // pixels of a 16x16 tile = threads per CTA
constexpr int NF = 8;             // features per slot
constexpr int WARPS = P / 32;
constexpr int SUB = 32;           // slots per sub-chunk: one per lane
constexpr int GROUP = 8;          // the two-level scan's group
constexpr float ALPHA_THRESHOLD = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.999f;
constexpr float TRANSMITTANCE_EPS = 1e-4f;
constexpr float SIGMA_GUARD_EPS = 1e-3f;
constexpr float LOG_FLOOR = 1e-30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Scan { V3 = 0, NOSCAN = 1, TWOLEVEL = 2, LOGSUM = 3 };

struct Slot {
  float f[6];
  float lo;    // f_6, the sigma guard's bound
  bool live;   // a slot of the frame (k < K)
};

__device__ __forceinline__ Slot load_slot(const float* rf, int k,
                                          int k_cap) {
  Slot s;
  s.live = k < k_cap;
  const float* f = rf + static_cast<size_t>(s.live ? k : 0) * NF;
#pragma unroll
  for (int j = 0; j < 6; ++j) s.f[j] = s.live ? f[j] : 0.0f;
  s.lo = s.live ? f[6] : 0.0f;
  return s;
}

// alpha of a slot at one pixel (basis values b); ok as the JAX kernel's
__device__ __forceinline__ float slot_alpha(const Slot& s, const float* b,
                                            bool& ok) {
  float la = s.f[0] * b[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) la = fmaf(s.f[j], b[j], la);
  const float a = expf(la);
  ok = s.live && la <= s.lo + SIGMA_GUARD_EPS && a >= ALPHA_THRESHOLD;
  return ok ? fminf(a, ALPHA_CLAMP) : 0.0f;
}

__device__ __forceinline__ float prod_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < SUB; off <<= 1) {
    const float y = __shfl_up_sync(FULL_MASK, x, off);
    if (lane >= off) x *= y;
  }
  return x;
}

__device__ __forceinline__ float sum_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < SUB; off <<= 1) {
    const float y = __shfl_up_sync(FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// the inclusive transmittance factor of this lane's slot in its sub-chunk
template <int SCAN>
__device__ __forceinline__ float scan_om(float om, int lane) {
  if constexpr (SCAN == V3) {
    return prod_scan(om, lane);
  } else if constexpr (SCAN == NOSCAN) {
    return om;
  } else if constexpr (SCAN == TWOLEVEL) {
    float x = om;
#pragma unroll
    for (int off = 1; off < GROUP; off <<= 1) {
      const float y = __shfl_up_sync(FULL_MASK, x, off);
      if ((lane & (GROUP - 1)) >= off) x *= y;
    }
    // exclusive product of the group tails below this lane's group
    float excl = 1.0f;
#pragma unroll
    for (int gr = 0; gr < SUB / GROUP - 1; ++gr) {
      const float tail = __shfl_sync(FULL_MASK, x, gr * GROUP + GROUP - 1);
      if (gr < lane / GROUP) excl *= tail;
    }
    return x * excl;
  } else {
    return expf(sum_scan(logf(fmaxf(om, LOG_FLOOR)), lane));
  }
}

__device__ __forceinline__ void stage_basis(const float* basis,
                                            float (*sb)[P]) {
  for (int i = threadIdx.x; i < 6 * P; i += P) sb[i / P][i % P] = basis[i];
  __syncthreads();
}

template <int SCAN>
__global__ void __launch_bounds__(P)
lab_fwd_kernel(const float* __restrict__ feats,
               const float* __restrict__ basis,
               const float* __restrict__ t_in, float* __restrict__ img,
               float* __restrict__ t_out, int k_cap, int chunk) {
  __shared__ float sb[6][P];
  stage_basis(basis, sb);
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t pix = static_cast<size_t>(row) * P + threadIdx.x;
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  float t_own = t_in ? t_in[pix] : 1.0f;   // pixel 32 warp + lane's carry
  float acc_own = 0.0f;
  for (int base = 0; base < k_cap; base += SUB) {
    const Slot s = load_slot(rf, base + lane, k_cap);
    const bool move_carry = SCAN != NOSCAN || (base + SUB) % chunk == 0;
    for (int i = 0; i < 32; ++i) {
      const int px = warp * 32 + i;
      float b[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) b[j] = sb[j][px];
      bool ok;
      const float a = slot_alpha(s, b, ok);
      const float om = 1.0f - a;
      const float t_inc = __shfl_sync(FULL_MASK, t_own, i) *
                          scan_om<SCAN>(om, lane);
      const float keep = t_inc >= TRANSMITTANCE_EPS ? 1.0f : 0.0f;
      const float c = warp_sum(a * (t_inc / om) * keep);
      const float t_last = __shfl_sync(FULL_MASK, t_inc, SUB - 1);
      if (lane == i) {
        acc_own += c;
        if (move_carry) t_own = t_last;
      }
    }
  }
  img[pix] = acc_own;
  t_out[pix] = t_own;
}

__global__ void __launch_bounds__(P)
lab_bwd_kernel(const float* __restrict__ feats,
               const float* __restrict__ basis, const float* __restrict__ g,
               const float* __restrict__ t_in,
               const float* __restrict__ prior,
               const float* __restrict__ total, float* __restrict__ dfeats,
               int k_cap) {
  __shared__ float sb[6][P];
  __shared__ float part[WARPS][SUB][6];
  stage_basis(basis, sb);
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t pix = static_cast<size_t>(row) * P + threadIdx.x;
  const float* rf = feats + static_cast<size_t>(row) * k_cap * NF;
  float* rd = dfeats + static_cast<size_t>(row) * k_cap * NF;
  float t_own = t_in ? t_in[pix] : 1.0f;
  float c_own = prior ? prior[pix] : 0.0f;
  const float g_own = g[pix];
  const float tot_own = total[pix];
  for (int base = 0; base < k_cap; base += SUB) {
    const Slot s = load_slot(rf, base + lane, k_cap);
    float d[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < 32; ++i) {
      const int px = warp * 32 + i;
      float b[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) b[j] = sb[j][px];
      bool ok;
      const float a = slot_alpha(s, b, ok);
      const float om = 1.0f - a;
      const float t_inc = __shfl_sync(FULL_MASK, t_own, i) *
                          prod_scan(om, lane);
      const float keep = t_inc >= TRANSMITTANCE_EPS ? 1.0f : 0.0f;
      const float t_prev = t_inc / om;
      const float c_inc = __shfl_sync(FULL_MASK, c_own, i) +
                          sum_scan(a * t_prev * keep, lane);
      const float suffix = __shfl_sync(FULL_MASK, tot_own, i) - c_inc;
      const float dalpha = (t_prev - suffix / om) * keep *
                           __shfl_sync(FULL_MASK, g_own, i);
      const float dla = (ok && a < ALPHA_CLAMP) ? a * dalpha : 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) d[j] = fmaf(dla, b[j], d[j]);
      const float t_last = __shfl_sync(FULL_MASK, t_inc, SUB - 1);
      const float c_last = __shfl_sync(FULL_MASK, c_inc, SUB - 1);
      if (lane == i) {
        t_own = t_last;
        c_own = c_last;
      }
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) part[warp][lane][j] = d[j];
    __syncthreads();
    // SUB slots x NF features = P entries: one per thread, in a fixed order
    const int sl = threadIdx.x / NF;
    const int j = threadIdx.x % NF;
    if (base + sl < k_cap) {
      float sum = 0.0f;
      if (j < 6) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[w][sl][j];
      }
      rd[static_cast<size_t>(base) * NF + threadIdx.x] = sum;
    }
    __syncthreads();   // before the next sub-chunk overwrites part
  }
}

template <int SCAN>
int launch_fwd(const float* feats, const float* basis, const float* t_in,
               float* img, float* t_out, int num_rows, int k_cap, int chunk,
               void* stream) {
  if (num_rows > 0) {
    lab_fwd_kernel<SCAN><<<num_rows, P, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, basis, t_in, img, t_out, k_cap, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// t_in may be null (transmittance 1); chunk is a multiple of 32 dividing
// k_cap (only the NOSCAN form reads it).
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
int lab_bwd_v3(const float* feats, const float* basis, const float* g,
               const float* t_in, const float* prior, const float* total,
               float* dfeats, int num_rows, int k_cap, void* stream) {
  if (num_rows > 0) {
    lab_bwd_kernel<<<num_rows, P, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, basis, g, t_in, prior, total, dfeats, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
