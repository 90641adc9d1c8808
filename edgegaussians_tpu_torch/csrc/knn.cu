// Exact brute-force k nearest neighbours for Hopper (sm_90a).
//
// Replaces edgegaussians_tpu/ops/pallas_knn.py::_knn_kernel (:52), launched
// there by knn_pallas (:123). It ports what that kernel computes, not its
// layout: the [3,N] lane layout, the 11-bit index packing into the low
// mantissa bits of d^2 (which perturbs selection by 2^-11) and the k
// min-reduce passes per 2048-key block exist for the TPU's vector unit and
// have no counterpart here.
//
// Contract (ops/knn.py): points [N,3] f32 row-major, NaN read as 0 and
// +-inf as +-FLT_MAX (jnp.nan_to_num); alive [N] bytes (0 = dead key; null =
// every key alive). For every query row q, dead or alive, the k keys j != q
// with alive[j] of smallest
//   d2 = (qx-px)^2 + (qy-py)^2 + (qz-pz)^2
// computed by direct differences, each product and sum rounded on its own
// (__fmul_rn/__fadd_rn: no FMA contraction, so the plain PyTorch version
// reproduces d2 bit for bit), in ascending (d2, index) order: keys are
// walked in ascending index and a key enters the list only when strictly
// smaller, so ties go to the lower index, as torch.sort(stable=True) in the
// plain version. Outputs: dists [N,k] = sqrt(d2), idx [N,k] int64. A slot
// no live key fills (fewer than k live keys besides the query, or d2 = inf)
// gets dists FLT_MAX and idx 0.
//
// What bounds it on this card: operations. Each (query, key) pair costs 3
// subs, 3 muls, 2 adds and the dead-key add (9 f32 operations) plus a
// compare; at the ABC capacity of 16384 rows that is 2.7e8 pairs, ~0.036 ms
// at 67 TFLOP/s. The bytes are negligible (16384 x 12 B in, N x k x 12 B
// out).
//
// What the design does about it: one thread per query keeps a sorted top-K
// list (K = 8 or 16, a compile-time size, so the list lives in registers)
// and inserts only when d2 beats the list's last entry, which after the
// first few hundred keys is rare. Keys are staged through shared memory in
// tiles of 2048 float4 (x, y, z, 0 or +inf for a dead key: 32 KB), loaded
// once per CTA and read as broadcasts by all its threads. 128 threads per
// CTA give 128 CTAs at the ABC capacity, about one per SM. Not done yet:
// compacting the live keys first, splitting the key range across warps, a
// tensor-core cross term.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;     // queries per CTA
constexpr int TILE = 2048;       // keys staged per pass (32 KB of float4)

__device__ __forceinline__ float clean(float v) {
  // jnp.nan_to_num / torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
  if (!(v == v)) return 0.0f;
  if (fabsf(v) > FLT_MAX) return copysignf(FLT_MAX, v);
  return v;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ alive,
           int n, int k, float* __restrict__ dists, long long* __restrict__ idx) {
  __shared__ float4 keys[TILE];
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const bool active = q < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    qx = clean(pts[3 * static_cast<size_t>(q)]);
    qy = clean(pts[3 * static_cast<size_t>(q) + 1]);
    qz = clean(pts[3 * static_cast<size_t>(q) + 2]);
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  for (int base = 0; base < n; base += TILE) {
    const int m = min(TILE, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < m; t += THREADS) {
      const size_t j = static_cast<size_t>(base + t);
      const bool live = alive == nullptr || alive[j] != 0;
      keys[t] = make_float4(clean(pts[3 * j]), clean(pts[3 * j + 1]),
                            clean(pts[3 * j + 2]), live ? 0.0f : INFINITY);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < m; ++t) {
      const float4 p = keys[t];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                          __fmul_rn(dz, dz));
      d = __fadd_rn(d, p.w);
      const int j = base + t;
      if (!(d < bd[K - 1]) || j == q) continue;
      // insert (d, j) after every entry <= d: entries strictly greater
      // move one slot down, so equal distances keep ascending index
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        if (bd[s - 1] > d) {
          bd[s] = bd[s - 1];
          bi[s] = bi[s - 1];
        } else if (bd[s] > d) {
          bd[s] = d;
          bi[s] = j;
        }
      }
      if (bd[0] > d) {
        bd[0] = d;
        bi[0] = j;
      }
    }
  }

  if (!active) return;
  float* od = dists + static_cast<size_t>(q) * k;
  long long* oi = idx + static_cast<size_t>(q) * k;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      const bool dry = !(bd[s] < INFINITY);
      od[s] = dry ? FLT_MAX : sqrtf(bd[s]);
      oi[s] = dry ? 0 : bi[s];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a k outside [1, 16]. `alive` may be null.
int knn_topk(const float* pts, const unsigned char* alive, int n, int k,
             float* dists, long long* idx, void* stream) {
  if (k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k <= 8)
      knn_kernel<8><<<blocks, THREADS, 0, s>>>(pts, alive, n, k, dists, idx);
    else
      knn_kernel<16><<<blocks, THREADS, 0, s>>>(pts, alive, n, k, dists, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
