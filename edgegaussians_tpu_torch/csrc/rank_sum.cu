// Deterministic per-Gaussian row sums for Hopper (sm_90a).
//
// Replaces the float index_add_ with which the compositors' backwards sum
// their per-pair (or per-slot) gradient rows into per-Gaussian rows by
// depth rank (ops/segpair.py pair_grads_to_packed, ops/composite.py
// scatter_slot_grads and pair_prefix_grads). On CUDA that index_add_ runs
// float atomics, whose order, and so whose rounding, changes from launch to
// launch: the same training run on the card parted ways at it from epoch 0.
// It stands for the JAX package's _scatter_rows
// (edgegaussians_tpu/ops/composite.py:140-186), an XLA scatter-add (or sort
// plus segment_sum) that is deterministic on the TPU; no Pallas kernel.
// It is also the backward of the direction loss's neighbour gather
// (ops/rank_sum.py gather_backward; models/losses.py direction_loss), for
// which ATen's CUDA index backward adds in an order of its own.
//
// Input contract (built by ops/rank_sum.py): the keys of the B rows, int32,
// sorted ascending by a stable sort, so rows with equal keys stand in row
// order; perm [B] int64, the row of each sorted key; rows [*, c] f32,
// row-major; out [n, c] f32, zero-filled. A key in [0, n) names the output
// row its row adds to; any other key (the wrapper gives dropped rows the key
// n) adds nowhere.
//
// What it computes: out[k, j] = ((0 + r_0[j]) + r_1[j]) + ... over the rows
// of key k in row order, one f32 add at a time: what index_add_ on the CPU
// does (it walks the index in order), bit for bit, and the same bits on
// every launch.
//
// The design: one thread per (sorted position, column). The thread at the
// first position of a key's run walks the run in order and writes the
// output element; every other thread returns. The c threads of one position
// read one row's c contiguous floats. The walk is as long as the longest
// run: one dependent add a row, whose loads do not depend on the sum. Runs
// are short on both jobs: a Gaussian touches at most max_tiles_per_gaussian
// tiles (64) in a compositor's backward; in the direction loss's gather
// backward a live row's run is the number of query rows that list it as a
// neighbour, once the wrapper has dropped the all-zero rows (the dead query
// rows', which would otherwise pile thousands of rows onto the few live
// rows nearest the dead ones). No atomics, no cross-thread order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rank_sum_kernel(const float* __restrict__ rows,
                const int* __restrict__ keys,
                const int64_t* __restrict__ perm, int64_t b, int n, int c,
                float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t p = t / c;
  const int j = static_cast<int>(t - p * c);
  if (p >= b) return;
  const int key = keys[p];
  // not a run's first position, or a dropped row
  if (key < 0 || key >= n || (p > 0 && keys[p - 1] == key)) return;
  float acc = 0.0f;
  for (int64_t q = p; q < b && keys[q] == key; ++q)
    acc += rows[perm[q] * c + j];
  out[static_cast<int64_t>(key) * c + j] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int rank_sum(const float* rows, const int* keys, const int64_t* perm,
             int64_t b, int n, int c, float* out, void* stream) {
  const int64_t threads = b * c;
  if (threads > 0) {
    const int64_t blocks = (threads + THREADS - 1) / THREADS;
    rank_sum_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        rows, keys, perm, b, n, c, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
