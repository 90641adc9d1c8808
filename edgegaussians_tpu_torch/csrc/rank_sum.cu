// Deterministic per-Gaussian row sums for Hopper (sm_90a).
//
// Replaces the float index_add_ with which the compositors' backwards sum
// their per-pair (or per-slot) gradient rows into per-Gaussian rows by
// depth rank (ops/segpair.py pair_grads_to_packed, ops/composite.py
// scatter_slot_grads and pair_prefix_grads). On CUDA that index_add_ runs
// float atomics, whose order, and so whose rounding, changes from launch to
// launch: the same training run on the card parted ways at it from epoch 0.
// It stands for the JAX package's _scatter_rows
// (edgegaussians_tpu/ops/composite.py:138), an XLA scatter-add that is
// deterministic on the TPU; no Pallas kernel. It is also the backward of
// the direction loss's neighbour gather (ops/rank_sum.py gather_backward;
// models/losses.py direction_loss, the JAX losses.py:154), for which
// ATen's CUDA index backward adds in an order of its own.
//
// What it computes: out[k, j] = ((0 + r_0[j]) + r_1[j]) + ... over the
// kept rows of key k in row order, one f32 add at a time: what index_add_
// on the CPU does (it walks the index in order), bit for bit, and the same
// bits on every launch. A row is kept where its index lies in [0, n), its
// valid flag (if given) is set and, for the gather's backward (drop_zero),
// it holds an element other than +0 or -0 (NaN counts as one): adding a
// +0 or -0 row never changes a sum that starts at +0.
//
// The design: a counting sort over the keys' known range [0, n), four
// launches, integer atomics only (their sums do not depend on their
// order), no float atomics:
//   1. count: one thread a row finds its key (n where dropped), stores it
//      and adds one to cnt[key]; the first thread zeroes the two counters
//      of step 2;
//   2. alloc: one thread a key gives each key a segment of cnt[key] slots
//      (a block scan, then one atomicAdd a CTA on a running total, so the
//      CTAs' segments lie in any order), sets cnt back to 0 and lists the
//      keys of more than THREAD_RUN rows (one atomicAdd a warp);
//   3. fill: one thread a kept row writes its row number into the next
//      free slot of its key's segment, in whatever order the atomics run;
//   4. sum: each key's segment of row numbers put in ascending order,
//      then its rows added in that order, and the key's output row
//      written (zeros for a key with no row).
// The order inside a segment is the only thing the atomics decide, and
// step 4 undoes it, so the bits do not depend on it. Step 4 runs 32 keys
// a warp, one a lane: a run of up to THREAD_RUN rows (on the fixture's
// cameras every run; most gather runs) is ordered by a sorting network
// and added by its lane alone, its columns in registers. The listed
// longer keys are spread over every warp of the grid (which has a warp
// for each key that could be one, up to LONG_BLOCKS blocks), a key a
// warp at a time: up to 32 rows ordered in registers, each lane's rank
// counted over the run by shuffles; past that a stable LSD radix sort by
// the warp over the bits of (row - the run's least row), 8 bits a pass,
// in shared memory up to SMEM_RUN rows and in the global workspace
// (list <-> tmp) past that, so a run of every row into one key sorts in
// the kernel too; then one lane a column adds the run.
//
// What bounds it: the bytes (each row read once, the keys and the row
// lists a few times, the output written once) are ~2 MB on a fixture
// camera, under a microsecond at the card's 3.35 TB/s; the time goes to
// four launches and to the dependent loads of each stage (a row's index,
// then its atomic; a key's segment, its row numbers, then its rows).
//
// Workspace (ops/rank_sum.py, one per stream): cnt [>= n] holds zeros
// between calls (the alloc kernel sets it back); total [2] (the running
// total and the count of longer keys) is zeroed by the count kernel;
// seg [>= n] (int2: start, length), cur and big [>= n], keys, list and
// tmp [>= b] are written before they are read in every call.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int ROW_THREADS = 256;     // count and fill: one thread a row
constexpr int ALLOC_THREADS = 1024;  // alloc: one thread a key
constexpr int SUM_WARPS = 8;         // sum: 32 keys a warp
constexpr int LONG_BLOCKS = 1024;    // sum: most blocks for the longer keys
constexpr int THREAD_RUN = 8;        // runs ordered and added by one thread
constexpr int THREAD_COLS = 16;      // columns one thread adds in registers
constexpr int SHORT_RUN = 32;        // runs a warp orders in registers
constexpr int SMEM_RUN = 256;        // longest run sorted in shared memory
constexpr int RADIX_BITS = 8;
constexpr int BINS = 1 << RADIX_BITS;
constexpr int BINS_PER_LANE = BINS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(ROW_THREADS)
rank_sum_count_kernel(const void* __restrict__ idx, int idx64,
                      const unsigned char* __restrict__ valid,
                      const float* __restrict__ rows, int drop_zero,
                      int64_t b, int n, int c, int* __restrict__ keys,
                      int* __restrict__ cnt, int* __restrict__ total) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * ROW_THREADS +
                    threadIdx.x;
  if (r == 0) total[0] = total[1] = 0;
  if (r >= b) return;
  const int64_t i = idx64 ? static_cast<const int64_t*>(idx)[r]
                          : static_cast<const int*>(idx)[r];
  bool keep = i >= 0 && i < n && (valid == nullptr || valid[r] != 0);
  if (keep && drop_zero) {
    const float* row = rows + r * c;
    keep = false;
    for (int j = 0; j < c && !keep; ++j) keep = row[j] != 0.0f;  // NaN too
  }
  const int key = keep ? static_cast<int>(i) : n;
  keys[r] = key;
  if (keep) atomicAdd(cnt + key, 1);
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

__global__ void __launch_bounds__(ALLOC_THREADS)
rank_sum_alloc_kernel(int n, int* __restrict__ cnt, int2* __restrict__ seg,
                      int* __restrict__ cur, int* __restrict__ big,
                      int* __restrict__ total) {
  __shared__ int warp_base[ALLOC_THREADS / 32];
  __shared__ int cta_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int key = blockIdx.x * ALLOC_THREADS + threadIdx.x;
  int count = 0;
  if (key < n) {
    count = cnt[key];
    cnt[key] = 0;
  }
  const int incl = warp_inclusive_scan(count, lane);
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const bool on = lane < ALLOC_THREADS / 32;
    const int w = on ? warp_base[lane] : 0;
    const int wi = warp_inclusive_scan(w, lane);
    if (on) warp_base[lane] = wi - w;
    if (lane == 31) cta_base = wi > 0 ? atomicAdd(total, wi) : 0;
  }
  __syncthreads();
  if (key < n) {
    const int start = cta_base + warp_base[warp] + incl - count;
    seg[key] = make_int2(start, count);
    cur[key] = start;
  }
  // the keys of more than THREAD_RUN rows, listed in any order
  const unsigned longer = __ballot_sync(FULL, count > THREAD_RUN);
  if (longer) {
    const int leader = __ffs(longer) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(total + 1, __popc(longer));
    at = __shfl_sync(FULL, at, leader);
    if (count > THREAD_RUN)
      big[at + __popc(longer & ((1u << lane) - 1u))] = key;
  }
}

__global__ void __launch_bounds__(ROW_THREADS)
rank_sum_fill_kernel(const int* __restrict__ keys, int64_t b, int n,
                     int* __restrict__ cur, int* __restrict__ list) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * ROW_THREADS +
                    threadIdx.x;
  if (r >= b) return;
  const int key = keys[r];
  if (key < n) list[atomicAdd(cur + key, 1)] = static_cast<int>(r);
}

struct WarpScratch {
  int bins[BINS];
  int a[SMEM_RUN];
  int b[SMEM_RUN];
};

// The len distinct row numbers at a, put in ascending order by one warp:
// stable LSD radix passes of RADIX_BITS bits over (row - least row),
// between a and b (both in shared memory, or both in the workspace).
// Returns the buffer that holds the result.
__device__ int* sort_run(int* a, int* b, int len, int* bins, int lane) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = lane; i < len; i += 32) {
    lo = min(lo, a[i]);
    hi = max(hi, a[i]);
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, d));
    hi = max(hi, __shfl_xor_sync(FULL, hi, d));
  }
  const unsigned range = static_cast<unsigned>(hi - lo);
  const int bits = range ? 32 - __clz(range) : 0;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int shift = 0; shift < bits; shift += RADIX_BITS) {
    for (int q = lane; q < BINS; q += 32) bins[q] = 0;
    __syncwarp();
    for (int i = lane; i < len; i += 32)
      atomicAdd(bins + ((static_cast<unsigned>(a[i] - lo) >> shift) &
                        (BINS - 1)), 1);
    __syncwarp();
    // exclusive scan of the bins: each lane holds BINS_PER_LANE of them
    int v[BINS_PER_LANE];
    int own = 0;
#pragma unroll
    for (int q = 0; q < BINS_PER_LANE; ++q) {
      v[q] = bins[lane * BINS_PER_LANE + q];
      own += v[q];
    }
    int at = warp_inclusive_scan(own, lane) - own;
#pragma unroll
    for (int q = 0; q < BINS_PER_LANE; ++q) {
      bins[lane * BINS_PER_LANE + q] = at;
      at += v[q];
    }
    __syncwarp();
    // scatter 32 rows at a time, in order: lanes with the same digit take
    // consecutive slots in lane order, after the earlier chunks' rows
    for (int base = 0; base < len; base += 32) {
      const int i = base + lane;
      const bool on = i < len;
      const int row = on ? a[i] : 0;
      const int digit = on ? static_cast<int>(
          (static_cast<unsigned>(row - lo) >> shift) & (BINS - 1)) : -1;
      const unsigned peers = __match_any_sync(FULL, digit);
      const int rank = __popc(peers & lanes_below);
      const int pos = on ? bins[digit] + rank : 0;
      __syncwarp();
      if (on) {
        b[pos] = row;
        if (rank == 0) bins[digit] += __popc(peers);
      }
      __syncwarp();
    }
    int* t = a;
    a = b;
    b = t;
  }
  return a;
}

// One thread's key of len <= THREAD_RUN rows (0 included): the rows'
// numbers put in ascending order by an odd-even transposition network in
// registers, then added in that order into o, the columns in registers
// where c <= THREAD_COLS.
__device__ __forceinline__ void sum_in_thread(const float* __restrict__ rows,
                                              const int* list, int len,
                                              int c, float* o) {
  int v[THREAD_RUN];
#pragma unroll
  for (int q = 0; q < THREAD_RUN; ++q) v[q] = q < len ? list[q] : INT_MAX;
#pragma unroll
  for (int round = 0; round < THREAD_RUN; ++round) {
#pragma unroll
    for (int q = round & 1; q + 1 < THREAD_RUN; q += 2) {
      const int lo = min(v[q], v[q + 1]);
      v[q + 1] = max(v[q], v[q + 1]);
      v[q] = lo;
    }
  }
  if (c <= THREAD_COLS) {
    float acc[THREAD_COLS];
#pragma unroll
    for (int j = 0; j < THREAD_COLS; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int q = 0; q < THREAD_RUN; ++q) {
      if (q < len) {
        const float* r = rows + static_cast<int64_t>(v[q]) * c;
#pragma unroll
        for (int j = 0; j < THREAD_COLS; ++j)
          if (j < c) acc[j] += r[j];
      }
    }
#pragma unroll
    for (int j = 0; j < THREAD_COLS; ++j)
      if (j < c) o[j] = acc[j];
    return;
  }
  for (int j = 0; j < c; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < THREAD_RUN; ++q)
      if (q < len) acc += rows[static_cast<int64_t>(v[q]) * c + j];
    o[j] = acc;
  }
}

// One warp's key of len > THREAD_RUN rows, its numbers at list[start..]:
// put in ascending order (in registers up to SHORT_RUN rows, each lane's
// rank counted by shuffles; past that by sort_run), then added in that
// order into o, one lane a column.
__device__ void sum_in_warp(const float* __restrict__ rows, int* list,
                            int* tmp, int start, int len, int c, float* o,
                            WarpScratch& w, int lane) {
  const int* order;
  if (len <= SHORT_RUN) {
    const int row = lane < len ? list[start + lane] : INT_MAX;
    int rank = 0;
    for (int q = 0; q < len; ++q) rank += __shfl_sync(FULL, row, q) < row;
    if (lane < len) w.a[rank] = row;
    __syncwarp();
    order = w.a;
  } else if (len <= SMEM_RUN) {
    for (int i = lane; i < len; i += 32) w.a[i] = list[start + i];
    __syncwarp();
    order = sort_run(w.a, w.b, len, w.bins, lane);
  } else {
    order = sort_run(list + start, tmp + start, len, w.bins, lane);
  }
  for (int j = lane; j < c; j += 32) {
    float acc = 0.0f;
#pragma unroll 4
    for (int q = 0; q < len; ++q)
      acc += rows[static_cast<int64_t>(order[q]) * c + j];
    o[j] = acc;
  }
  __syncwarp();  // the scratch is free for the warp's next key
}

// 32 keys a warp, one a lane: each lane sums its key if it has at most
// THREAD_RUN rows; then every warp of the grid takes the listed longer
// keys, one at a time each, in a grid-stride loop.
__global__ void __launch_bounds__(SUM_WARPS * 32)
rank_sum_sum_kernel(const float* __restrict__ rows,
                    const int2* __restrict__ seg,
                    const int* __restrict__ big,
                    const int* __restrict__ total, int n, int c, int* list,
                    int* tmp, float* __restrict__ out) {
  __shared__ WarpScratch scratch[SUM_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * SUM_WARPS + warp;
  const int key = gw * 32 + lane;
  if (key < n) {
    const int2 s = seg[key];
    if (s.y <= THREAD_RUN)
      sum_in_thread(rows, list + s.x, s.y, c,
                    out + static_cast<int64_t>(key) * c);
  }
  const int longer = total[1];
  for (int i = gw; i < longer; i += gridDim.x * SUM_WARPS) {
    const int k = big[i];
    const int2 s = seg[k];
    sum_in_warp(rows, list, tmp, s.x, s.y, c,
                out + static_cast<int64_t>(k) * c, scratch[warp], lane);
  }
}

}  // namespace

extern "C" {

// The four launches on `stream`; returns the first nonzero
// cudaGetLastError() (0 = ok). n > 0.
int rank_sum(const float* rows, const void* idx, int idx64,
             const unsigned char* valid, int drop_zero, int64_t b, int n,
             int c, float* out, int* keys, int* list, int* tmp, int* cnt,
             int* seg, int* cur, int* big, int* total, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one block at least: the count kernel also zeroes the two counters
  const unsigned row_blocks = static_cast<unsigned>(
      b > 0 ? (b + ROW_THREADS - 1) / ROW_THREADS : 1);
  const unsigned key_blocks = static_cast<unsigned>(
      (static_cast<int64_t>(n) + ALLOC_THREADS - 1) / ALLOC_THREADS);
  // a warp for each 32 keys, and at least a warp for each key that can
  // have more than THREAD_RUN rows, up to LONG_BLOCKS blocks
  const int64_t sum_blocks = std::max(
      (static_cast<int64_t>(n) + SUM_WARPS * 32 - 1) / (SUM_WARPS * 32),
      std::min<int64_t>(
          (std::min<int64_t>(n, b / (THREAD_RUN + 1)) + SUM_WARPS - 1) /
              SUM_WARPS,
          LONG_BLOCKS));
  rank_sum_count_kernel<<<row_blocks, ROW_THREADS, 0, st>>>(
      idx, idx64, valid, rows, drop_zero, b, n, c, keys, cnt, total);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  rank_sum_alloc_kernel<<<key_blocks, ALLOC_THREADS, 0, st>>>(
      n, cnt, reinterpret_cast<int2*>(seg), cur, big, total);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if (b > 0)
    rank_sum_fill_kernel<<<row_blocks, ROW_THREADS, 0, st>>>(keys, b, n, cur,
                                                             list);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  rank_sum_sum_kernel<<<static_cast<unsigned>(sum_blocks), SUM_WARPS * 32, 0,
                        st>>>(rows, reinterpret_cast<const int2*>(seg), big,
                              total, n, c, list, tmp, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
