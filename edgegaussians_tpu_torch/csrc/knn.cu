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
// What bounds it on this card: operations. Each (query, live key) pair
// costs 3 subs, 3 muls and 2 adds, uncontracted, plus a compare. The
// kernel table (PERF.md) bounds it at 9 f32 operations per (query, live
// key) over 67 TFLOP/s, which at the ABC capacity (16384 queries x 12740
// live keys) is 0.028 ms. Those operations cannot fuse into FMAs, so the
// card issues them one lane-instruction each: with the compare and the
// shared-memory read, ~10 lane-instructions per pair at the H100's ~33.5 T
// lane-instructions/s (132 SMs x 128 lanes x ~1.98 GHz) is a floor of
// ~0.06 ms there, about 2x the table's bound. The bytes are negligible
// (N x 12 B in, N x k x 12 B out).
//
// What the design does about it:
// - Parallelism: a CTA holds 32 queries (one per lane) and splits the key
//   range into 8 contiguous slices, one warp each, so the grid has N / 32
//   CTAs of 8 warps (at 16384 rows 512 CTAs, ~31 warps an SM). Each
//   thread keeps a sorted top-K for its (query, slice) in registers (K = k,
//   a compile-time size per k in 1..16), inserting only when d2 is strictly
//   smaller than its K-th entry.
// - Queued inserts: a warp diverges whenever one of its lanes inserts, and
//   with 8 slices each list fills 8 times, so direct inserts would cost
//   more than the distances at k = 15. A key that beats the K-th entry as
//   of the last flush goes into the thread's queue of 8 in shared memory;
//   when some queue is full (or the slice ends), every lane inserts its
//   queue in order, which gives the lists direct inserts would give. The
//   stale threshold only lets more keys into the queue, never fewer.
// - Live-key compaction: a warp loads its slice 128 keys at a time, 32 a
//   round, and writes only the live ones (__ballot_sync on alive, a
//   __popc prefix) to its shared-memory tile as float4 (x, y, z, index
//   bits), in ascending index. The walk then reads live keys only: dead
//   keys cost a load and a ballot, not a distance. No host sync, no
//   nonzero.
// - Overlap: the next tile's keys are loaded into registers before the
//   walk of this one starts, so their latency hides behind the walk (a
//   register double buffer: cp.async copies bytes as they are and could
//   neither read the 1-byte alive flags nor compact, so the values would
//   pass through registers anyway).
// - Exact merge: after the walks, each query's 8 sorted lists are merged in
//   shared memory by (d2, index), lexicographically. Slices are walked in
//   ascending index and a key enters a list only when strictly smaller, so
//   every list is in (d2, index) order, and so is the merge: ties go to
//   the lower index, as the plain version's stable sort. The self
//   exclusion compares original row indices. The CTA's [32, k] block of
//   each output is contiguous and is written coalesced.
// - No tensor-core cross term: |q|^2 + |p|^2 - 2 q.p cancels for near
//   neighbours and would break bit-equality with the plain version.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int QUERIES = 32;            // queries per CTA, one per lane
constexpr int SLICES = 8;              // key slices per CTA, one per warp
constexpr int THREADS = QUERIES * SLICES;
constexpr int ROUNDS = 4;              // 32-key loads per staged tile
constexpr int TILE = 32 * ROUNDS;      // keys a warp stages per pass
constexpr int QLEN = 8;                // candidates a thread queues
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float clean(float v) {
  // jnp.nan_to_num / torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
  if (!(v == v)) return 0.0f;
  if (fabsf(v) > FLT_MAX) return copysignf(FLT_MAX, v);
  return v;
}

// shared memory of knn_kernel<K>: the warps' key tiles and candidate
// queues while walking, then (aliasing them) the slices' lists and the
// CTA's output block
template <int K>
struct KnnSmem {
  static constexpr int KEYS = SLICES * TILE * 16;
  static constexpr int QUEUES = 2 * SLICES * QLEN * 32 * 4;
  static constexpr int LISTS = 2 * SLICES * K * QUERIES * 4;
  static constexpr int OUT = QUERIES * K * 12;
  static constexpr int BYTES = KEYS + QUEUES > LISTS + OUT
      ? KEYS + QUEUES : LISTS + OUT;
};

// Insert (d, j) into the sorted list (bd, bi) if d is strictly below its
// last entry: entries strictly greater than d move one slot down, so
// equal distances keep the order they came in.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int j) {
  if (!(d < bd[K - 1])) return;
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

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ alive,
           int n, float* __restrict__ dists, long long* __restrict__ idx) {
  __shared__ __align__(16) unsigned char smem[KnnSmem<K>::BYTES];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QUERIES;
  const int q = q0 + lane;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (q < n) {
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

  // this warp's slice of the keys
  const int lo = static_cast<int>(static_cast<long long>(n) * warp / SLICES);
  const int hi =
      static_cast<int>(static_cast<long long>(n) * (warp + 1) / SLICES);
  float4* tile = reinterpret_cast<float4*>(smem) + warp * TILE;
  // this thread's candidate queue, entry i at qd[32 i], qi[32 i]
  float* qd = reinterpret_cast<float*>(smem + KnnSmem<K>::KEYS) +
              warp * QLEN * 32 + lane;
  int* qi = reinterpret_cast<int*>(smem + KnnSmem<K>::KEYS) +
            (SLICES + warp) * QLEN * 32 + lane;
  float thr = INFINITY;   // the list's K-th distance at the last flush
  int qc = 0;
  auto flush = [&]() {
    for (int i = 0; i < qc; ++i) insert<K>(bd, bi, qd[32 * i], qi[32 * i]);
    qc = 0;
    thr = bd[K - 1];
  };
  const unsigned below = (1u << lane) - 1u;
  float kx[ROUNDS], ky[ROUNDS], kz[ROUNDS];
  bool kl[ROUNDS];
  auto fetch = [&](int base) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int j = base + 32 * r + lane;
      const bool in = j < hi;   // the four loads are independent
      kl[r] = in && (alive == nullptr || alive[j] != 0);
      kx[r] = in ? pts[3 * static_cast<size_t>(j)] : 0.0f;
      ky[r] = in ? pts[3 * static_cast<size_t>(j) + 1] : 0.0f;
      kz[r] = in ? pts[3 * static_cast<size_t>(j) + 2] : 0.0f;
    }
  };
  if (lo < hi) fetch(lo);
  for (int base = lo; base < hi; base += TILE) {
    // compact the fetched keys: live ones only, in ascending index
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const unsigned live = __ballot_sync(FULL_MASK, kl[r]);
      if (kl[r])
        tile[cnt + __popc(live & below)] =
            make_float4(clean(kx[r]), clean(ky[r]), clean(kz[r]),
                        __int_as_float(base + 32 * r + lane));
      cnt += __popc(live);
    }
    __syncwarp();
    if (base + TILE < hi) fetch(base + TILE);   // in flight during the walk
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const float4 p = tile[t];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const bool pass = d < thr;
      if (__any_sync(FULL_MASK, pass)) {   // rare once the lists fill
        const int j = __float_as_int(p.w);
        if (pass && j != q) {
          qd[32 * qc] = d;
          qi[32 * qc] = j;
          ++qc;
        }
        if (__any_sync(FULL_MASK, qc == QLEN)) flush();
      }
    }
    __syncwarp();   // the walk is done before the next compaction
  }
  flush();

  // merge the 8 slices' lists of each query by (d2, index)
  __syncthreads();   // every walk is done: the tiles' memory is free
  float* md = reinterpret_cast<float*>(smem);            // [SLICES][K][32]
  int* mi = reinterpret_cast<int*>(md + SLICES * K * QUERIES);
  float* od = reinterpret_cast<float*>(mi + SLICES * K * QUERIES);  // [32][K]
  long long* oi = reinterpret_cast<long long*>(od + QUERIES * K);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    md[(warp * K + s) * QUERIES + lane] = bd[s];
    mi[(warp * K + s) * QUERIES + lane] = bi[s];
  }
  __syncthreads();
  if (warp == 0) {
    int head[SLICES];
#pragma unroll
    for (int w = 0; w < SLICES; ++w) head[w] = 0;
    for (int s = 0; s < K; ++s) {
      float best_d = INFINITY;
      int best_i = 0x7fffffff;
      int best_w = 0;
#pragma unroll
      for (int w = 0; w < SLICES; ++w) {
        if (head[w] < K) {
          const int at = (w * K + head[w]) * QUERIES + lane;
          const float dw = md[at];
          const int iw = mi[at];
          if (dw < best_d || (dw == best_d && iw < best_i)) {
            best_d = dw;
            best_i = iw;
            best_w = w;
          }
        }
      }
#pragma unroll
      for (int w = 0; w < SLICES; ++w) head[w] += w == best_w;
      // a slot no live key fills: float32 max and index 0
      const bool dry = !(best_d < INFINITY);
      od[lane * K + s] = dry ? FLT_MAX : sqrtf(best_d);
      oi[lane * K + s] = dry ? 0 : best_i;
    }
  }
  __syncthreads();
  // rows q0 .. q0 + 31 of each output are one contiguous [rows, K] block
  const int rows = min(QUERIES, n - q0);
  for (int i = threadIdx.x; i < rows * K; i += THREADS) {
    dists[static_cast<size_t>(q0) * K + i] = od[i];
    idx[static_cast<size_t>(q0) * K + i] = oi[i];
  }
}

template <int K>
void launch(const float* pts, const unsigned char* alive, int n,
            float* dists, long long* idx, cudaStream_t s) {
  knn_kernel<K><<<(n + QUERIES - 1) / QUERIES, THREADS, 0, s>>>(
      pts, alive, n, dists, idx);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a k outside [1, 16]. `alive` may be null.
int knn_topk(const float* pts, const unsigned char* alive, int n, int k,
             float* dists, long long* idx, void* stream) {
  if (k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
#define KNN_CASE(K) \
      case K: launch<K>(pts, alive, n, dists, idx, s); break;
      KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4)
      KNN_CASE(5) KNN_CASE(6) KNN_CASE(7) KNN_CASE(8)
      KNN_CASE(9) KNN_CASE(10) KNN_CASE(11) KNN_CASE(12)
      KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
#undef KNN_CASE
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
