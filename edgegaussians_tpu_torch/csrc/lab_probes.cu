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
//   roll       out = x + 0.5 * roll(x, shift, axis): an index roll. One
//              16-byte vector of out a thread, 64 threads (2 rows) a CTA,
//              so 128 CTAs on the script's runs. The wrapper brings the
//              shift into [0, n_axis), so the source wraps with one compare
//              and the coordinates come from the grid (no division). Axis
//              0 moves whole rows: two aligned float4 loads. Axis 1 by
//              4q + M columns reads the two vectors that the source window
//              straddles and selects by M, one template instance a residue.
//              Rows that are no 16-byte multiple, or a pointer off a
//              16-byte boundary, take the same kernel with one float a
//              thread. x + 0.5 * y is rounded after each op, as the plain
//              version rounds (no FMA);
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
//   transpose  tiles of 32 rows x 16 columns of x, 128 threads a CTA
//              (64 CTAs on the script's [256, 128]): each thread loads one
//              16-byte row segment into shared memory and stores one
//              16-byte segment of an out row; an XOR swizzle of the tile's
//              16-byte chunks keeps both phases free of bank conflicts.
//              Rows or columns that are no multiple of 4, or a pointer off
//              a 16-byte boundary, move the same four floats one by one;
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
constexpr int ROLL_ROWS = 2;          // roll: rows a CTA, 32 elements each
constexpr int TRANSPOSE_ROWS = 32;    // transpose: a tile's rows of x
constexpr int TRANSPOSE_COLS = 16;    // and columns (128 threads)
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ int wrap_low(int i, int n) {
  return i < 0 ? i + n : i;   // i in [-n, n)
}

// x + 0.5 * y rounded after each op, as the plain version's two ops round
// (a contracted FMA would round once)
__device__ __forceinline__ float add_half(float x, float y) {
  return __fadd_rn(x, __fmul_rn(0.5f, y));
}
__device__ __forceinline__ float4 add_half(const float4& x, const float4& y) {
  return make_float4(add_half(x.x, y.x), add_half(x.y, y.y),
                     add_half(x.z, y.z), add_half(x.w, y.w));
}

// roll along axis 1 by 4q + M columns: out vector c of a row takes the
// source columns 4c - 4q - M .. + 3, which straddle vectors c - q - 1
// (its last M floats, "lo") and c - q (its first 4 - M, "hi"), wrapped
// at the row's end
template <int M>
__device__ __forceinline__ float4 window(const float4* __restrict__ row,
                                         int c, int q, int cols_v) {
  const float4 hi = __ldg(row + wrap_low(c - q, cols_v));
  if constexpr (M == 0) {
    return hi;
  } else {
    const float4 lo = __ldg(row + wrap_low(c - q - 1, cols_v));
    if constexpr (M == 1) {
      return make_float4(lo.w, hi.x, hi.y, hi.z);
    } else if constexpr (M == 2) {
      return make_float4(lo.z, lo.w, hi.x, hi.y);
    } else {
      static_assert(M == 3, "M is the shift's residue mod 4");
      return make_float4(lo.y, lo.z, lo.w, hi.x);
    }
  }
}
// the scalar path: one float, the shift in columns
template <int M>
__device__ __forceinline__ float window(const float* __restrict__ row, int c,
                                        int s, int cols) {
  return __ldg(row + wrap_low(c - s, cols));
}

// block (32, ROLL_ROWS), grid (cdiv(cols_v, 32), <= cdiv(rows, ROLL_ROWS)):
// thread (tx, ty) of CTA (bx, by) owns element bx * 32 + tx of row
// by * ROLL_ROWS + ty of out [rows, cols_v], and the rows a grid's height
// further on. An element is a 16-byte vector (V = float4) or, where rows
// are no 16-byte multiple or a pointer is off a 16-byte boundary, a float.
// `shift` is in [0, rows) rows (axis 0) or in [0, cols_v) elements (axis 1;
// float4: whole vectors, M the columns beyond them): the wrapper brings
// the shift into range, so the coordinates come from the grid and the
// source wraps with one compare; nothing divides.
template <typename V, int AXIS, int M>
__global__ void __launch_bounds__(32 * ROLL_ROWS)
probe_roll_kernel(const V* __restrict__ x, V* __restrict__ out, int rows,
                  int cols_v, int shift) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  if (c >= cols_v) return;
  for (int r = blockIdx.y * ROLL_ROWS + threadIdx.y; r < rows;
       r += gridDim.y * ROLL_ROWS) {
    const V* row = x + static_cast<size_t>(r) * cols_v;
    V y;
    if constexpr (AXIS == 0) {   // whole rows move: an aligned load
      y = __ldg(x + static_cast<size_t>(wrap_low(r - shift, rows)) * cols_v +
                c);
    } else {
      y = window<M>(row, c, shift, cols_v);
    }
    out[static_cast<size_t>(r) * cols_v + c] = add_half(__ldg(row + c), y);
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

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

// The chunk of the shared tile where tile row r's 16-byte chunk g (g = r *
// TC / 4 + column / 4, row-major) lives: g with its low 3 bits (a 128-byte
// line of 8 chunks, the 32 banks) XORed by r's group of 4 rows, spread
// over the 8 chunks. The loads' 8-thread phases store 8 neighbouring
// chunks of rows of one group (a permutation of one line); a warp of the
// stores reads one float of each of TR / 4 row groups at 32 / TR chunk
// columns, which the XOR sends to 32 distinct banks.
template <int TR>
__device__ __forceinline__ int swizzle(int g, int r) {
  return g ^ (((r >> 2) * (32 / TR)) & 7);
}

// out [cols, rows] = x [rows, cols]^T. grid (cdiv(cols, TC), <=
// cdiv(rows, TR)), TR * TC / 4 threads: CTA (bx, by) moves the tile of x
// rows [by * TR, + TR) and columns [bx * TC, + TC), and the tiles a grid's
// height further on. Each thread loads one 16-byte row segment of x (tile
// row i, chunk j) into the swizzled tile and, after one barrier, stores
// one 16-byte segment of an out row (out row c of the tile: four floats
// of one tile column, chunk k), the k fastest across a warp so that its
// stores fill whole segments of out rows. VEC False (rows or columns no
// multiple of 4, or a pointer off a 16-byte boundary) moves the same four
// floats one by one, each bounded by the array's edge.
template <int TR, int TC, bool VEC>
__global__ void __launch_bounds__(TR * TC / 4)
probe_transpose_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int rows, int cols) {
  constexpr int CV = TC / 4, RV = TR / 4;   // chunks of a tile row, column
  constexpr int CV_BITS = log2_of(CV), RV_BITS = log2_of(RV);
  static_assert((TR == 16 || TR == 32) && (TC == 16 || TC == 32),
                "the swizzle spreads 16 or 32 rows over 8 chunks");
  __shared__ float4 tile[TR * CV];
  const float* tf = reinterpret_cast<const float*>(tile);
  const int t = threadIdx.x;
  const int i = t >> CV_BITS, j = t & (CV - 1);   // load: row, chunk
  const int c = t >> RV_BITS, k = t & (RV - 1);   // store: row, chunk
  const int col = blockIdx.x * TC + 4 * j;   // x column of the load
  const int oc = blockIdx.x * TC + c;        // out row of the store
  for (int r0 = blockIdx.y * TR; r0 < rows; r0 += gridDim.y * TR) {
    const int r = r0 + i;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) {
      const float* src = x + static_cast<size_t>(r) * cols + col;
      if constexpr (VEC) {
        if (col < cols) v = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        if (col < cols) v.x = __ldg(src);
        if (col + 1 < cols) v.y = __ldg(src + 1);
        if (col + 2 < cols) v.z = __ldg(src + 2);
        if (col + 3 < cols) v.w = __ldg(src + 3);
      }
    }
    tile[swizzle<TR>(t, i)] = v;   // chunk t is row i's chunk j
    __syncthreads();
    const int orow = r0 + 4 * k;   // out column of the store's first float
    if (oc < cols && orow < rows) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tr = 4 * k + u;
        w[u] = tf[4 * swizzle<TR>(tr * CV + (c >> 2), tr) + (c & 3)];
      }
      float* dst = out + static_cast<size_t>(oc) * rows + orow;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (orow + u < rows) dst[u] = w[u];
      }
    }
    __syncthreads();   // the tile is read before the next one is stored
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

// a grid's height: the kernels loop over the rows beyond it
int grid_y(int n) { return n < MAX_GRID_Y ? n : MAX_GRID_Y; }

// rows of cols4 16-byte vectors that one CTA of dyn_write / dyn_read owns
int rows_per_cta(int cols4) {
  return cols4 >= VEC_PER_CTA ? 1 : VEC_PER_CTA / cols4;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns its first CUDA error (0 = ok).

// shift in [0, rows) (axis 0) or [0, cols) (axis 1); vec: cols a multiple
// of 4 and x and out 16-byte aligned (the wrapper brings the shift into
// range and decides vec)
int probe_roll(const float* x, float* out, int rows, int cols, int shift,
               int axis, int vec, void* stream) {
  if (rows > 0 && cols > 0) {
    const int cols_v = vec ? cols / 4 : cols;
    const dim3 grid(cdiv(cols_v, 32), grid_y(cdiv(rows, ROLL_ROWS)));
    const dim3 block(32, ROLL_ROWS);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* out4 = reinterpret_cast<float4*>(out);
    if (!vec) {
      if (axis == 0)
        probe_roll_kernel<float, 0, 0><<<grid, block, 0, st>>>(
            x, out, rows, cols_v, shift);
      else
        probe_roll_kernel<float, 1, 0><<<grid, block, 0, st>>>(
            x, out, rows, cols_v, shift);
    } else if (axis == 0) {
      probe_roll_kernel<float4, 0, 0><<<grid, block, 0, st>>>(
          x4, out4, rows, cols_v, shift);
    } else {
      const int q = shift / 4;   // whole vectors, then the residue
      switch (shift % 4) {
        case 0:
          probe_roll_kernel<float4, 1, 0><<<grid, block, 0, st>>>(
              x4, out4, rows, cols_v, q);
          break;
        case 1:
          probe_roll_kernel<float4, 1, 1><<<grid, block, 0, st>>>(
              x4, out4, rows, cols_v, q);
          break;
        case 2:
          probe_roll_kernel<float4, 1, 2><<<grid, block, 0, st>>>(
              x4, out4, rows, cols_v, q);
          break;
        default:
          probe_roll_kernel<float4, 1, 3><<<grid, block, 0, st>>>(
              x4, out4, rows, cols_v, q);
      }
    }
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

// vec: rows and cols multiples of 4 and x and out 16-byte aligned (the
// wrapper decides)
int probe_transpose(const float* x, float* out, int rows, int cols, int vec,
                    void* stream) {
  constexpr int TR = TRANSPOSE_ROWS, TC = TRANSPOSE_COLS;
  if (rows > 0 && cols > 0) {
    const dim3 grid(cdiv(cols, TC), grid_y(cdiv(rows, TR)));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
      probe_transpose_kernel<TR, TC, true><<<grid, TR * TC / 4, 0, st>>>(
          x, out, rows, cols);
    else
      probe_transpose_kernel<TR, TC, false><<<grid, TR * TC / 4, 0, st>>>(
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
