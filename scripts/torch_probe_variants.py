"""Write variants of the roll and transpose probe kernels for an A/B.

    python3 scripts/torch_probe_variants.py [NAME ...]

Each variant is a copy of ``edgegaussians_tpu_torch/`` under
``build/var_<name>/`` with ``csrc/lab_probes.cu`` edited, a tree that
``scripts/torch_kernel_ab.py --probes_only --trees ...`` times beside this
one:

- ``tr32x32``: transpose tiles of 32 x 32 (256 threads; 32 CTAs on the
  script's [256, 128]);
- ``tr16x16``: tiles of 16 x 16 (64 threads; 128 CTAs);
- ``roll4``: roll CTAs of 4 rows (128 threads; 64 CTAs on the script's
  runs);
- ``roll_staged``: axis 1 by a shift that is no multiple of 4 stages each
  CTA's source window of a row in shared memory (one 16-byte load a
  thread, and one more by a row's last lane) and reads the four floats
  from there, in place of two 16-byte loads and a register select.

No argument writes them all. The copies are git-ignored (``build/``).
"""

from __future__ import annotations

import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("edgegaussians_tpu_torch", "csrc", "lab_probes.cu")

STAGED_KERNEL = r'''
// axis 1 by 4q + M columns, M > 0: the CTA's window of each of its rows
// staged in shared memory, slot tx holding vector c - q - 1 and slot 32
// (or the one after a row's last vector) vector c - q
template <int M>
__global__ void __launch_bounds__(32 * ROLL_ROWS)
probe_roll_kernel_staged(const float4* __restrict__ x,
                         float4* __restrict__ out, int rows, int cols_v,
                         int q) {
  __shared__ float s[ROLL_ROWS][33 * 4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  for (int rb = blockIdx.y * ROLL_ROWS; rb < rows;
       rb += gridDim.y * ROLL_ROWS) {
    const int r = rb + ty;
    const float4* row = x + static_cast<size_t>(r) * cols_v;
    const bool live = r < rows && c < cols_v;
    if (live) {
      *reinterpret_cast<float4*>(&s[ty][4 * tx]) =
          __ldg(row + wrap_low(c - q - 1, cols_v));
      if (tx == 31 || c == cols_v - 1)
        *reinterpret_cast<float4*>(&s[ty][4 * tx + 4]) =
            __ldg(row + wrap_low(c - q, cols_v));
    }
    __syncthreads();
    if (live) {
      const float* w = &s[ty][4 * tx + 4 - M];
      out[static_cast<size_t>(r) * cols_v + c] =
          add_half(__ldg(row + c), make_float4(w[0], w[1], w[2], w[3]));
    }
    __syncthreads();
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }
'''

# name: [(old, new, count)] edits of csrc/lab_probes.cu
VARIANTS = {
    "tr32x32": [("constexpr int TRANSPOSE_COLS = 16;",
                 "constexpr int TRANSPOSE_COLS = 32;", 1)],
    "tr16x16": [("constexpr int TRANSPOSE_ROWS = 32;",
                 "constexpr int TRANSPOSE_ROWS = 16;", 1)],
    "roll4": [("constexpr int ROLL_ROWS = 2;",
               "constexpr int ROLL_ROWS = 4;", 1)],
    "roll_staged": [
        ("\nint cdiv(int a, int b) { return (a + b - 1) / b; }\n",
         STAGED_KERNEL, 1)] + [
        (f"probe_roll_kernel<float4, 1, {m}><<<",
         f"probe_roll_kernel_staged<{m}><<<", 1) for m in (1, 2, 3)],
}


def write(name: str) -> str:
    dst = os.path.join(REPO, "build", f"var_{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "edgegaussians_tpu_torch"),
                    os.path.join(dst, "edgegaussians_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new, count in VARIANTS[name]:
        if src.count(old) != count:
            raise SystemExit(f"{name}: {old!r} found {src.count(old)} "
                             f"times, expected {count}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return dst


def main() -> int:
    for name in sys.argv[1:] or VARIANTS:
        print(write(name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
