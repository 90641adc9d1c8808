// The six lowering probes of the kernel lab for Hopper (sm_90a).
//
// Replaces the Pallas kernels of scripts/segpair_mosaic_probe.py:
// probe_roll (:51, call :58), probe_onehot (:66, :82), probe_dyn_write
// (:92, :107), probe_dyn_read (:128, :143), probe_transpose (:163, :169)
// and probe_vmem_dyn (:177, :196). On the TPU each asked whether Mosaic
// lowers one construct the segmented compositor wanted; here each is the
// Hopper form of that construct, held to the script's NumPy oracle
// (edgegaussians_tpu_torch/lab/probes.py):
//
//   roll       out = x + 0.5 * roll(x, shift, axis): an index roll;
//   onehot     out[i, :] = sum_j [seg[0, j] == i] * c[j, :], a segmented
//              sum, owner-computes (no one-hot and no product is built).
//              Each CTA owns a block of output rows (and of 16-byte column
//              vectors, 2 a thread); in rounds of 256 ids it compacts, by
//              warp ballots, the source rows whose id equals one of its
//              row indices into one list per row, in ascending j, then
//              each owned vector loads its row's source rows 8 side by
//              side and adds them in that order. For a finite c the
//              one-hot product adds the same terms in the same order plus
//              exact zeros, which change no bit. c must be finite: where a
//              row of c holds inf or NaN, the product's 0 * inf puts NaN
//              in every output row, while this kernel adds that row only
//              to the row its id names. An id that is no integer in
//              [0, J) matches no row; a row that no id names is written 0.
//              Every source row is read by the one CTA that owns its id
//              (c once), not by every CTA;
//   dyn_write  window b, rows [offs[b], offs[b] + win) of out, gets
//              (b + 1) + row, the rest of out 0: owner-computes. Each CTA
//              owns a block of output rows and loads offs into shared
//              memory once; per row it finds the LAST fitting window that
//              covers it (a later window wins, as on the TPU's in-order
//              grid) and stores that row's value, or 0, with 16-byte
//              coalesced stores. No row is written twice, nothing scans
//              serially, and no separate fill runs: one launch writes every
//              element. Plain vector stores, not a TMA bulk store of the
//              CTA's block: the bulk store moves the same bytes, after a
//              shared-memory stage and a proxy fence.
//   dyn_read   out[b * win + r, :] = 2 * src[offs[b] + r, :], or 0 where
//              window b does not fit: the same shape. Each CTA owns a block
//              of output rows, maps each to its source row (or none) once,
//              and copies with 16-byte vector loads and stores; one launch
//              writes every element;
//   transpose  through a 32 x 33 shared tile (the pad keeps the column
//              reads free of bank conflicts);
//   vmem_dyn   a scratch buffer [buf_rows, cols], zero at step 0, kept
//              across the steps: step s reads (or, with rmw, adds x[s]
//              into) the window at row offs[s]. The TPU keeps the buffer
//              across SEQUENTIAL grid steps; here no buffer is kept at
//              all: owner-computes, as dyn_write. Each thread owns one
//              16-byte vector (s, r, c) of out [steps, win, cols] and
//              computes it where it is stored, so the grid spreads over
//              steps * win * cols / 4 vectors. Read mode stores 0 + 2 *
//              x[s, r, c] (the buffer is never written, so its * 0 term is
//              an exact +0). rmw walks the steps t = 0..s in order and adds
//              x[t, R - offs[t], c] for each fitting window that covers
//              buffer row R = offs[s] + r, from 0: the additions of the
//              sequential buffer in its order, so the same bits; later
//              steps cannot change out[s]. Each CTA loads offs into shared
//              memory once. A step whose window does not fit is written as
//              zeros, so one launch writes every element.
//
// Windows whose offset lies outside the array are skipped (the offsets are
// read on the device, where nothing can raise).
//
// What bounds them on this card: bytes, and at the probes' sizes (128 KB
// to 1 MB moved; dyn_write 0.5 MB written, dyn_read 0.25 MB read and 0.25
// MB written) launch latency: the least time at 3.35 TB/s is 0.04-0.3 us,
// a launch some microseconds. The designs keep every access coalesced and
// move each byte once (but vmem_dyn's rmw, which reads a row of x again
// for each later step whose window covers it), in one launch per call;
// the probes are about the constructs, not time.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC_PER_CTA = 512;      // dyn_write / dyn_read: 16-byte
                                      // vectors a CTA stores, 2 a thread
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int ONEHOT_ROWS = 16;       // onehot: most output rows a CTA owns
constexpr int ONEHOT_VEC_PER_THREAD = 2;
constexpr int ONEHOT_LOADS = 8;       // source rows loaded side by side

__global__ void __launch_bounds__(THREADS)
probe_roll_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int rows, int cols, int shift, int axis) {
  const int n = rows * cols;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const int r = i / cols;
    const int c = i % cols;
    int src;
    if (axis == 0) {
      const int rr = ((r - shift) % rows + rows) % rows;
      src = rr * cols + c;
    } else {
      const int cc = ((c - shift) % cols + cols) % cols;
      src = r * cols + cc;
    }
    out[i] = x[i] + 0.5f * x[src];
  }
}

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void set_zero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void set_zero(float& a) { a = 0.0f; }

// grid (cdiv(n_seg, rows_per_cta), cdiv(cols_v, vec_cols)): CTA (x, y)
// owns output rows [x * rows_per_cta, ...) and vector columns [y *
// vec_cols, ...) of out [n_seg, cols_v], at most 2 vectors a thread
// (V = float4: 16-byte vectors; float where a row is not 16-byte). seg
// row 0 holds the segment id of each row of cmat [n_seg, cols_v].
template <typename V>
__global__ void __launch_bounds__(THREADS)
probe_onehot_kernel(const float* __restrict__ seg,
                    const V* __restrict__ cmat, V* __restrict__ out,
                    int n_seg, int cols_v, int rows_per_cta, int vec_cols) {
  __shared__ int s_list[ONEHOT_ROWS][THREADS];   // a round's j per row
  __shared__ int s_warp[WARPS][ONEHOT_ROWS];     // matches per warp, row
  __shared__ int s_count[ONEHOT_ROWS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows_per_cta;
  const int n_rows = min(rows_per_cta, n_seg - r0);
  const int c0 = blockIdx.y * vec_cols;
  const int n_cols = min(vec_cols, cols_v - c0);
  V acc[ONEHOT_VEC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ONEHOT_VEC_PER_THREAD; ++i) set_zero(acc[i]);
  // rounds of THREADS source rows: the ids of this CTA's rows compacted
  // into one list per row, in ascending j
  for (int j0 = 0; j0 < n_seg; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    int k = -1;   // the owned row whose index the id equals exactly
    if (j < n_seg) {
      const float id = seg[j];
      if (id >= static_cast<float>(r0) &&
          id < static_cast<float>(r0 + n_rows) && id == floorf(id))
        k = static_cast<int>(id) - r0;
    }
    int pos = 0;
    for (int kk = 0; kk < n_rows; ++kk) {
      const unsigned m = __ballot_sync(FULL_MASK, k == kk);
      if (lane == 0) s_warp[warp][kk] = __popc(m);
      if (k == kk) pos = __popc(m & ((1u << lane) - 1u));
    }
    __syncthreads();
    if (k >= 0) {   // the warps before this one come first
      for (int w = 0; w < warp; ++w) pos += s_warp[w][k];
      s_list[k][pos] = j;
    }
    if (threadIdx.x < n_rows) {
      int n = 0;
      for (int w = 0; w < WARPS; ++w) n += s_warp[w][threadIdx.x];
      s_count[threadIdx.x] = n;
    }
    __syncthreads();
    // each owned vector adds its row's source rows in ascending j: the
    // loads of ONEHOT_LOADS rows side by side, then the sums in order
#pragma unroll
    for (int i = 0; i < ONEHOT_VEC_PER_THREAD; ++i) {
      const int v = threadIdx.x + i * THREADS;
      if (v < n_rows * n_cols) {
        const int row = v / n_cols;
        const int col = c0 + v % n_cols;
        const int n = s_count[row];
        for (int q0 = 0; q0 < n; q0 += ONEHOT_LOADS) {
          V x[ONEHOT_LOADS];
#pragma unroll
          for (int u = 0; u < ONEHOT_LOADS; ++u) {
            if (q0 + u < n)
              x[u] = __ldg(cmat + static_cast<size_t>(s_list[row][q0 + u]) *
                                      cols_v + col);
          }
#pragma unroll
          for (int u = 0; u < ONEHOT_LOADS; ++u) {
            if (q0 + u < n) add_to(acc[i], x[u]);
          }
        }
      }
    }
    __syncthreads();   // the lists are read before the next round's
  }
#pragma unroll
  for (int i = 0; i < ONEHOT_VEC_PER_THREAD; ++i) {
    const int v = threadIdx.x + i * THREADS;
    if (v < n_rows * n_cols)
      out[static_cast<size_t>(r0 + v / n_cols) * cols_v + c0 + v % n_cols] =
          acc[i];
  }
}

__device__ __forceinline__ bool window_fits(int off, int win, int rows) {
  return off >= 0 && off <= rows - win;
}

// grid cdiv(rows, rows_per_cta): CTA k owns output rows [k * rows_per_cta,
// (k + 1) * rows_per_cta); out is [rows, cols4] 16-byte vectors. Dynamic
// shared memory: n_win offsets, then one value per owned row.
__global__ void __launch_bounds__(THREADS)
probe_dyn_write_kernel(const int* __restrict__ offs, float4* __restrict__ out,
                       int n_win, int win, int rows, int cols4,
                       int rows_per_cta) {
  extern __shared__ int s_offs[];
  float* s_val = reinterpret_cast<float*>(s_offs + n_win);
  const int r0 = blockIdx.x * rows_per_cta;
  const int n_rows = min(rows_per_cta, rows - r0);
  for (int b = threadIdx.x; b < n_win; b += THREADS) s_offs[b] = offs[b];
  __syncthreads();
  for (int r = threadIdx.x; r < n_rows; r += THREADS) {
    const int row = r0 + r;
    float v = 0.0f;
    for (int b = n_win - 1; b >= 0; --b) {   // the last covering window wins
      const int off = s_offs[b];
      if (window_fits(off, win, rows) && row >= off && row < off + win) {
        v = static_cast<float>(b + 1) + static_cast<float>(row - off);
        break;
      }
    }
    s_val[r] = v;
  }
  __syncthreads();
  float4* to = out + static_cast<size_t>(r0) * cols4;
  const int n_vec = n_rows * cols4;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) {
    const float v = s_val[i / cols4];
    to[i] = make_float4(v, v, v, v);
  }
}

// grid cdiv(n_win * win, rows_per_cta): CTA k owns rows [k * rows_per_cta,
// (k + 1) * rows_per_cta) of out [n_win * win, cols4]; src [rows, cols4].
// Static shared memory: each owned row's source row, -1 for none.
__global__ void __launch_bounds__(THREADS)
probe_dyn_read_kernel(const int* __restrict__ offs,
                      const float4* __restrict__ src,
                      float4* __restrict__ out, int n_win, int win, int rows,
                      int cols4, int rows_per_cta) {
  __shared__ int s_src[VEC_PER_CTA];
  const int r0 = blockIdx.x * rows_per_cta;
  const int n_rows = min(rows_per_cta, n_win * win - r0);
  for (int r = threadIdx.x; r < n_rows; r += THREADS) {
    const int row = r0 + r;
    const int b = row / win;
    const int off = offs[b];
    s_src[r] = window_fits(off, win, rows) ? off + (row - b * win) : -1;
  }
  __syncthreads();
  float4* to = out + static_cast<size_t>(r0) * cols4;
  const int n_vec = n_rows * cols4;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) {
    const int s = s_src[i / cols4];
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s >= 0) {
      v = __ldg(src + static_cast<size_t>(s) * cols4 + i % cols4);
      v.x *= 2.0f;
      v.y *= 2.0f;
      v.z *= 2.0f;
      v.w *= 2.0f;
    }
    to[i] = v;
  }
}

// block (32, 8), grid (cdiv(cols, 32), cdiv(rows, 32)): out [cols, rows]
__global__ void probe_transpose_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int rows,
                                       int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32;
  const int r0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = r0 + j;
    const int c = c0 + threadIdx.x;
    if (r < rows && c < cols)
      tile[j][threadIdx.x] = x[static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int c = c0 + j;
    const int r = r0 + threadIdx.x;
    if (c < cols && r < rows)
      out[static_cast<size_t>(c) * rows + r] = tile[threadIdx.x][j];
  }
}

// grid cdiv(steps * win * cols4, THREADS): thread i owns 16-byte vector i
// of out [steps, win, cols4]; x alike. Dynamic shared memory: the steps'
// offsets.
__global__ void __launch_bounds__(THREADS)
probe_vmem_dyn_kernel(const int* __restrict__ offs,
                      const float4* __restrict__ x, float4* __restrict__ out,
                      int steps, int win, int cols4, int buf_rows, int rmw) {
  extern __shared__ int s_offs[];
  for (int t = threadIdx.x; t < steps; t += THREADS) s_offs[t] = offs[t];
  __syncthreads();
  const size_t per_step = static_cast<size_t>(win) * cols4;
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= per_step * steps) return;
  const int s = static_cast<int>(i / per_step);
  const int r = static_cast<int>(i % per_step / cols4);
  const int c = static_cast<int>(i % cols4);
  const int off = s_offs[s];
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (window_fits(off, win, buf_rows)) {
    if (rmw) {
      const int row = off + r;   // the buffer row this element reads
      for (int t = 0; t <= s; ++t) {   // the steps in their order
        const int o = s_offs[t];
        if (window_fits(o, win, buf_rows) && row >= o && row < o + win)
          add_to(v, __ldg(x + (static_cast<size_t>(t) * win + (row - o)) *
                                  cols4 + c));
      }
    } else {
      const float4 a = __ldg(x + i);
      v.x += 2.0f * a.x;
      v.y += 2.0f * a.y;
      v.z += 2.0f * a.z;
      v.w += 2.0f * a.w;
    }
  }
  out[i] = v;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// rows of cols4 16-byte vectors that one CTA of dyn_write / dyn_read owns
int rows_per_cta(int cols4) {
  return cols4 >= VEC_PER_CTA ? 1 : VEC_PER_CTA / cols4;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns its first CUDA error (0 = ok).

int probe_roll(const float* x, float* out, int rows, int cols, int shift,
               int axis, void* stream) {
  const int blocks = cdiv(rows * cols, THREADS);
  if (blocks > 0) {
    probe_roll_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, out, rows, cols, shift, axis);
  }
  return static_cast<int>(cudaGetLastError());
}

int probe_onehot(const float* seg, const float* cmat, float* out, int n_seg,
                 int cols, void* stream) {
  if (n_seg > 0 && cols > 0) {
    const bool vec16 = cols % 4 == 0 &&
        (reinterpret_cast<size_t>(cmat) & 15) == 0 &&
        (reinterpret_cast<size_t>(out) & 15) == 0;
    const int cols_v = vec16 ? cols / 4 : cols;
    const int per_cta = ONEHOT_VEC_PER_THREAD * THREADS;
    const int vec_cols = cols_v < per_cta ? cols_v : per_cta;
    const int rows = per_cta / vec_cols < ONEHOT_ROWS ? per_cta / vec_cols
                                                      : ONEHOT_ROWS;
    const dim3 grid(cdiv(n_seg, rows), cdiv(cols_v, vec_cols));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec16) {
      probe_onehot_kernel<float4><<<grid, THREADS, 0, st>>>(
          seg, reinterpret_cast<const float4*>(cmat),
          reinterpret_cast<float4*>(out), n_seg, cols_v, rows, vec_cols);
    } else {
      probe_onehot_kernel<float><<<grid, THREADS, 0, st>>>(
          seg, cmat, out, n_seg, cols_v, rows, vec_cols);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// win >= 1; cols a multiple of 4 (16-byte rows), src and out 16-byte
// aligned; (n_win + rows_per_cta) * 4 B of shared memory within 48 KB
int probe_dyn_write(const int* offs, float* out, int n_win, int win,
                    int rows, int cols, void* stream) {
  const int cols4 = cols / 4;
  if (rows > 0 && cols4 > 0) {
    const int per = rows_per_cta(cols4);
    probe_dyn_write_kernel<<<cdiv(rows, per), THREADS,
                             (n_win + per) * sizeof(int),
                             static_cast<cudaStream_t>(stream)>>>(
        offs, reinterpret_cast<float4*>(out), n_win, win, rows, cols4, per);
  }
  return static_cast<int>(cudaGetLastError());
}

int probe_dyn_read(const int* offs, const float* src, float* out, int n_win,
                   int win, int rows, int cols, void* stream) {
  const int cols4 = cols / 4;
  if (n_win > 0 && win > 0 && cols4 > 0) {
    const int per = rows_per_cta(cols4);
    probe_dyn_read_kernel<<<cdiv(n_win * win, per), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        offs, reinterpret_cast<const float4*>(src),
        reinterpret_cast<float4*>(out), n_win, win, rows, cols4, per);
  }
  return static_cast<int>(cudaGetLastError());
}

int probe_transpose(const float* x, float* out, int rows, int cols,
                    void* stream) {
  if (rows > 0 && cols > 0) {
    probe_transpose_kernel<<<dim3(cdiv(cols, 32), cdiv(rows, 32)),
                             dim3(32, 8), 0,
                             static_cast<cudaStream_t>(stream)>>>(
        x, out, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

// win >= 1; cols a multiple of 4 (16-byte rows), x and out 16-byte
// aligned; steps * 4 B of shared memory within 48 KB
int probe_vmem_dyn(const int* offs, const float* x, float* out, int steps,
                   int win, int cols, int buf_rows, int rmw, void* stream) {
  const int cols4 = cols / 4;
  const long long n_vec = static_cast<long long>(steps) * win * cols4;
  if (n_vec > 0) {
    probe_vmem_dyn_kernel<<<static_cast<unsigned>((n_vec + THREADS - 1) /
                                                  THREADS),
                            THREADS, steps * sizeof(int),
                            static_cast<cudaStream_t>(stream)>>>(
        offs, reinterpret_cast<const float4*>(x),
        reinterpret_cast<float4*>(out), steps, win, cols4, buf_rows, rmw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
