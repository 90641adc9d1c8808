// The shard-sum probe for Hopper (sm_90a): o[0, c] = sum_i 2 * x[i, c].
//
// Replaces the Pallas probe kernel of tests/test_vma.py:205 (`kernel`,
// launched by `pcall` :210 inside a shard_map over the 'tiles' axis) and
// scripts/vma_pallas_repro.py:52: each device folds its shard x [rows,128]
// f32 into one row with `acc + x_ref[i, :] * 2.0` in a fori_loop, then one
// psum over the axis gives the whole array's result. Here each rank
// launches this kernel on its shard and one torch.distributed all_reduce
// (SUM) follows (parallel/distributed.py: sharded_sum2x). The probe pins
// the double-reduction bug class: the all-reduced row must be the whole
// array's, 1x and not world x.
//
// Contract (ops/shard_sum.py): x [rows, 128] f32 row-major, rows >= 0;
// out [1, 128] f32. Each output column is written once, with a plain
// store: no atomics, so the result is the same on every run.
//
// What bounds it on this card: bytes. It reads rows * 512 B once and
// writes 512 B; at the probe's 16384 rows that is 8.4 MB, 2.5 us at
// 3.35 TB/s. One add per element is far below the f32 rate.
//
// What the design does about it: one CTA per block of 32 columns (4 CTAs
// for the 128 columns); in a CTA, lane l of each of the 32 warps reads
// column 32 * blockIdx.x + l of rows warp, warp + 32, ..., so a warp's
// load of a row is one 128-byte line. Each thread keeps its running sum
// in a register (4 rows in flight per iteration), then a shared-memory
// tree over the 32 warps, in a fixed order, gives the column's sum, and
// lane l of warp 0 stores 2 * sum. Only 4 SMs of 132 stream the array, so
// the kernel sits well above its bytes bound; a split of the rows over
// more CTAs with a second, ordered pass is the later form.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 128;        // the probe's lane width
constexpr int COL_BLOCK = 32;    // columns per CTA: one per lane
constexpr int WARPS = 32;        // row stride of a CTA
constexpr int UNROLL = 4;        // rows in flight per thread

__global__ void __launch_bounds__(COL_BLOCK * WARPS)
shard_sum2x_kernel(const float* __restrict__ x, int rows,
                   float* __restrict__ out) {
  __shared__ float part[WARPS][COL_BLOCK + 1];
  const int lane = threadIdx.x % COL_BLOCK;
  const int warp = threadIdx.x / COL_BLOCK;
  const int col = blockIdx.x * COL_BLOCK + lane;
  float acc[UNROLL] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = warp;
  for (; i + (UNROLL - 1) * WARPS < rows; i += UNROLL * WARPS) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      acc[u] += x[static_cast<long long>(i + u * WARPS) * COLS + col];
  }
  for (; i < rows; i += WARPS)
    acc[0] += x[static_cast<long long>(i) * COLS + col];
  part[warp][lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  // tree over the warps: 16, 8, 4, 2, 1 partners, a fixed order
  for (int half = WARPS / 2; half > 0; half /= 2) {
    if (warp < half) part[warp][lane] += part[warp + half][lane];
    __syncthreads();
  }
  if (warp == 0) out[col] = 2.0f * part[0][lane];
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int shard_sum2x(const float* x, int rows, float* out, void* stream) {
  shard_sum2x_kernel<<<COLS / COL_BLOCK, COL_BLOCK * WARPS, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
