// The shard-sum probe for Hopper (sm_90a): o[0, c] = 2 * sum_i x[i, c].
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
// Contract (ops/shard_sum.py): x [rows, 128] f32 row-major and 16-byte
// aligned, rows >= 0; out [1, 128] f32, 16-byte aligned; a workspace of
// one [128] partial per CTA and an unsigned ticket that is 0 before the
// launch (and is 0 again after it). No float atomics: the sum's order is
// a function of rows alone (not of the card or of which CTA ends last),
// so every launch gives the same bits.
//
// What bounds it on this card: bytes. It reads rows * 512 B once and
// writes 512 B; at the probe's 16384 rows that is 8.4 MB, 2.5 us at
// 3.35 TB/s. One add per element is far below the f32 rate.
//
// What the design does about it: the rows are split over the whole card
// in one launch. CTA b takes the fixed block of rows [b * ROWS_PER_CTA,
// (b + 1) * ROWS_PER_CTA) (128 CTAs for 16384 rows); in it warp w reads
// rows w, w + WARPS, ..., each as 32 16-byte loads (a lane's four columns),
// all ROWS_PER_WARP of them issued before the first add, and adds them in
// row order. A tree over the warps in a fixed order gives the CTA's
// partial, which goes to the workspace. Then an integer ticket, taken by
// one thread with acquire-release order at device scope (an atomic inc
// wrapping at gridDim.x - 1, so that the last CTA to take one leaves it at
// 0 for the next launch, whatever its grid), tells the last CTA that every
// partial is in (a __threadfence() on each side of a relaxed atomicInc
// took 0.4-0.5 us more, PERF.md section 6). That CTA reads the partials
// from L2 in CTA order, split into GROUPS contiguous groups (one warp
// each, a lane's four columns), adds the groups by a fixed tree and
// stores 2 * sum. A launch that faults leaves the CUDA context unusable,
// so no later launch reads a ticket it left behind.

#include <cuda_runtime.h>

namespace {

constexpr int COLS4 = 32;                  // 16-byte vectors of a row
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_CTA = 128;          // ops/shard_sum.py: the same
constexpr int ROWS_PER_WARP = ROWS_PER_CTA / WARPS;
constexpr int GROUPS = WARPS;              // the ordered pass: one a warp
constexpr int PASS_LOADS = 8;              // partials in flight a lane

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// part[0] = the sum of part[0..WARPS) by a fixed tree: 8, 4, 2, 1
// partners; each level's barrier first, so the caller's stores are in
__device__ __forceinline__ void warp_tree(float4 (*part)[COLS4], int warp,
                                          int lane) {
#pragma unroll
  for (int half = WARPS / 2; half > 0; half /= 2) {
    __syncthreads();
    if (warp < half) add_to(part[warp][lane], part[warp + half][lane]);
  }
  __syncthreads();
}

// atomicInc with acquire-release order at device scope: the CTA's partial,
// stored before the barrier that precedes this, is visible to whichever
// CTA takes the last ticket; that CTA sees every other CTA's partial (each
// released by its own ticket). True for the last of `last + 1` tickets,
// which leaves the ticket at 0.
__device__ __forceinline__ bool take_ticket(unsigned int* ticket,
                                            unsigned int last) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(ticket), "r"(last) : "memory");
  return old == last;
}

__global__ void __launch_bounds__(THREADS)
shard_sum2x_kernel(const float4* __restrict__ x, int rows,
                   float4* __restrict__ partials, unsigned int* ticket,
                   float4* __restrict__ out) {
  __shared__ float4 part[WARPS][COLS4];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS_PER_CTA + warp;
  float4 v[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int row = row0 + k * WARPS;
    v[k] = row < rows
        ? __ldg(x + static_cast<size_t>(row) * COLS4 + lane)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    if (row0 + k * WARPS < rows) add_to(acc, v[k]);
  }
  part[warp][lane] = acc;
  warp_tree(part, warp, lane);
  if (warp == 0)
    partials[static_cast<size_t>(blockIdx.x) * COLS4 + lane] = part[0][lane];
  __syncthreads();
  if (threadIdx.x == 0) last = take_ticket(ticket, gridDim.x - 1);
  __syncthreads();
  if (!last) return;
  // the ordered pass: warp g adds partials [g * per, (g + 1) * per) in
  // CTA order, read past L1
  const int n = gridDim.x;
  const int per = (n + GROUPS - 1) / GROUPS;
  const int p_end = min((warp + 1) * per, n);
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int p = warp * per; p < p_end; p += PASS_LOADS) {
    float4 w[PASS_LOADS];
#pragma unroll
    for (int u = 0; u < PASS_LOADS; ++u) {
      if (p + u < p_end)
        w[u] = __ldcg(partials + static_cast<size_t>(p + u) * COLS4 + lane);
    }
#pragma unroll
    for (int u = 0; u < PASS_LOADS; ++u) {
      if (p + u < p_end) add_to(sum, w[u]);
    }
  }
  part[warp][lane] = sum;
  warp_tree(part, warp, lane);
  if (warp == 0) {
    const float4 s = part[0][lane];
    out[lane] = make_float4(2.0f * s.x, 2.0f * s.y, 2.0f * s.z, 2.0f * s.w);
  }
}

}  // namespace

extern "C" {

// Launches max(1, cdiv(rows, ROWS_PER_CTA)) CTAs on `stream` and returns
// cudaGetLastError() (0 = ok); cudaErrorInvalidValue, launching nothing,
// where the workspace holds fewer than that many partials.
int shard_sum2x(const float* x, int rows, float* out, float* partials,
                int capacity, unsigned int* ticket, void* stream) {
  const int blocks = rows > 0 ? (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA : 1;
  if (blocks > capacity) return static_cast<int>(cudaErrorInvalidValue);
  shard_sum2x_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), rows,
      reinterpret_cast<float4*>(partials), ticket,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
