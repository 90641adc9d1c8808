"""The kernel lab's six lowering probes: the counterparts of the Pallas
probes of ``scripts/segpair_mosaic_probe.py``.

On the TPU each probe asked whether Mosaic lowers one construct that the
segmented compositor wanted; here each is that construct's Hopper form
(``csrc/lab_probes.cu``), held to the script's NumPy oracle:

- :func:`probe_roll`: ``x + 0.5 * roll(x, shift, axis)`` (:51), one
  16-byte vector of the result a thread, the shift brought into
  ``[0, n_axis)`` on the host (:func:`roll_plan`);
- :func:`probe_onehot`: a one-hot [J, J] from segment ids (row 0 of
  ``seg [8, J]``) times ``c [J, cols]``: a segmented sum (:66). The kernel
  computes it owner-first, as the sum over the rows of ``c`` whose id
  equals the output row's index, in ascending order, in one launch;
- :func:`probe_dyn_write`: window b of ``win`` rows at row ``offs[b]``
  of a ``[rows, cols]`` array gets ``(b + 1) + row``; the rest is zero
  here (undefined in the script, whose oracle reads the windows only)
  (:92). The kernel computes it owner-first: each output row takes the
  last fitting window that covers it, or 0, in one launch;
- :func:`probe_dyn_read`: ``2 * src[offs[b] : offs[b] + win]`` for each
  window, stacked, zero where a window does not fit (:128); one launch
  writes every element;
- :func:`probe_transpose`: a transpose (:163) through swizzled shared
  tiles, one 16-byte load and one 16-byte store a thread
  (:func:`transpose_vec`);
- :func:`probe_vmem_dyn`: a scratch buffer ``[buf_rows, cols]`` kept
  across the steps: step s reads (``rmw`` False: ``buf * 0 + 2 * x[s]``)
  or adds ``x[s]`` into (``rmw`` True) the window at row ``offs[s]``
  (:177). The kernel keeps no buffer: each output element walks the
  steps up to its own and adds, in step order, the x of each fitting
  window that covers its buffer row; a step whose window does not fit
  gives zeros. One launch.

Offsets are int32 tensors on the probe's device, read by the kernels at
run time; windows outside the array are skipped, and where two windows
of ``probe_dyn_write`` overlap the later one wins, as on the TPU's
in-order grid.

Each probe has a plain PyTorch version (``*_ref``), which the wrapper
takes for CPU tensors; CUDA tensors launch the kernel or raise, and each
launch adds one to ``launch_counts``. The wrappers allocate their results
with ``torch.empty``, as each kernel writes every element of its result:
each call is one launch and no fill. :data:`CASES` holds the script's
eight runs (its inputs and NumPy oracles, copied) and :func:`run_case`
runs one through the kernel or the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.segpair import check_tensor

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/lab_probes.cu"
PROBES = ("roll", "onehot", "dyn_write", "dyn_read", "transpose",
          "vmem_dyn")
# dyn_write and vmem_dyn keep the offsets in shared memory (dyn_write
# beside its rows' values), within the 48 KB a block has without
# cudaFuncSetAttribute
MAX_WINDOWS = 8192

# each entry's pointers, then its ints, then the stream
_V, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    "probe_roll": (_V,) * 2 + (_I,) * 5 + (_V,),
    "probe_onehot": (_V,) * 3 + (_I,) * 2 + (_V,),
    "probe_dyn_write": (_V,) * 2 + (_I,) * 4 + (_V,),
    "probe_dyn_read": (_V,) * 3 + (_I,) * 4 + (_V,),
    "probe_transpose": (_V,) * 2 + (_I,) * 3 + (_V,),
    "probe_vmem_dyn": (_V,) * 3 + (_I,) * 5 + (_V,),
}

# Launches of each kernel since the last reset_launch_counts(); only the
# kernel wrappers below add to these.
launch_counts = {f"probe_{p}": 0 for p in PROBES}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")
    return x.device.type == "cuda"


def _launch(name, args):
    _build.launch("lab_probes", name, ARGTYPES[name], args)
    launch_counts[name] += 1


def _check_offs(offs, device):
    if offs.dim() != 1:
        raise ValueError(f"offs: expected [n], got {tuple(offs.shape)}")
    check_tensor("offs", offs, torch.int32, offs.shape, device)


def _check_2d(name, x):
    if x.dim() != 2:
        raise ValueError(f"{name}: expected 2-D, got {tuple(x.shape)}")
    check_tensor(name, x, torch.float32, x.shape, x.device)


def _check_windows(win, cols):
    if win < 1 or cols % 4:
        raise ValueError(f"windows of {win} rows x {cols} columns: the "
                         f"kernels take windows of at least 1 row and "
                         f"16-byte rows (a multiple of 4 columns)")


def _check_aligned(name, x):
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte vectors, so its "
                         f"data must start on a 16-byte boundary")


def _fits(off: int, win: int, rows: int) -> bool:
    return 0 <= off <= rows - win


# -- roll ------------------------------------------------------------------

def roll_plan(shape, shift: int, axis: int, aligned: bool) -> tuple:
    """(16-byte vectors, the shift in [0, n_axis)) of the roll kernel's
    launch on an array of ``shape``: vectors where rows are 16-byte
    multiples and ``aligned`` (both pointers on a 16-byte boundary), else
    one float a thread. An empty axis keeps the shift 0."""
    n = shape[axis]
    return shape[1] % 4 == 0 and aligned, shift % n if n else 0


def probe_roll(x: torch.Tensor, shift: int = 2, axis: int = 0
               ) -> torch.Tensor:
    """``x + 0.5 * roll(x, shift, axis)`` for a 2-D f32 ``x``; any integer
    shift."""
    if not _on_cuda(x, "roll"):
        return probe_roll_ref(x, shift, axis)
    _check_2d("x", x)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    out = torch.empty_like(x)
    vec, s = roll_plan(x.shape, shift, axis,
                       x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _launch("probe_roll",
            (x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], s, axis,
             int(vec), _build.stream(x.device)))
    return out


def probe_roll_ref(x: torch.Tensor, shift: int = 2, axis: int = 0
                   ) -> torch.Tensor:
    return x + 0.5 * torch.roll(x, shift, axis)


# -- one-hot segment sum ---------------------------------------------------

def probe_onehot(seg: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``onehot(seg[0]) @ c``: seg [8, J] f32 segment ids (row 0 read),
    c [J, cols] f32 -> [J, cols]. c must be finite: the kernel adds only
    the rows of c that an output row's id names, so an inf or NaN in c
    reaches that row alone, where the product's ``0 * inf`` puts NaN in
    every row."""
    if not _on_cuda(seg, "onehot"):
        return probe_onehot_ref(seg, c)
    _check_2d("seg", seg)
    _check_2d("c", c)
    n_seg = seg.shape[1]
    if c.shape[0] != n_seg or c.device != seg.device:
        raise ValueError(f"c: expected [{n_seg}, cols] on {seg.device}, "
                         f"got {tuple(c.shape)} on {c.device}")
    out = torch.empty_like(c)
    _launch("probe_onehot",
            (seg.data_ptr(), c.data_ptr(), out.data_ptr(), n_seg,
             c.shape[1], _build.stream(c.device)))
    return out


def probe_onehot_ref(seg: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(seg.shape[1], device=seg.device,
                        dtype=torch.float32)
    onehot = (rows[:, None] == seg[0][None, :]).to(torch.float32)
    return onehot @ c


# -- windows at run-time offsets -------------------------------------------

def probe_dyn_write(offs: torch.Tensor, rows: int, cols: int,
                    win: int = 128) -> torch.Tensor:
    """A zero [rows, cols] f32 array whose window b, rows [offs[b],
    offs[b] + win), holds ``(b + 1) + row``; offs int32 on the device of
    the result. A window that does not fit is skipped; where two overlap,
    the later one wins."""
    if not _on_cuda(offs, "dyn_write"):
        return probe_dyn_write_ref(offs, rows, cols, win)
    _check_offs(offs, offs.device)
    _check_windows(win, cols)
    if offs.shape[0] > MAX_WINDOWS:
        raise ValueError(f"the kernel takes up to {MAX_WINDOWS} windows, "
                         f"got {offs.shape[0]}")
    out = torch.empty((rows, cols), dtype=torch.float32, device=offs.device)
    _launch("probe_dyn_write",
            (offs.data_ptr(), out.data_ptr(), offs.shape[0], win, rows, cols,
             _build.stream(offs.device)))
    return out


def probe_dyn_write_ref(offs: torch.Tensor, rows: int, cols: int,
                        win: int = 128) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=torch.float32, device=offs.device)
    vals = torch.arange(win, dtype=torch.float32, device=offs.device)
    for b, off in enumerate(offs.tolist()):
        if _fits(off, win, rows):
            out[off:off + win] = (float(b + 1) + vals)[:, None]
    return out


def probe_dyn_read(src: torch.Tensor, offs: torch.Tensor,
                   win: int = 128) -> torch.Tensor:
    """``2 * src[offs[b] : offs[b] + win]`` for each b, stacked:
    src [rows, cols] f32 -> [len(offs) * win, cols] (zero where a window
    does not fit)."""
    if not _on_cuda(src, "dyn_read"):
        return probe_dyn_read_ref(src, offs, win)
    _check_2d("src", src)
    _check_offs(offs, src.device)
    rows, cols = src.shape
    _check_windows(win, cols)
    _check_aligned("src", src)
    out = torch.empty((offs.shape[0] * win, cols), dtype=torch.float32,
                      device=src.device)
    _launch("probe_dyn_read",
            (offs.data_ptr(), src.data_ptr(), out.data_ptr(), offs.shape[0],
             win, rows, cols, _build.stream(src.device)))
    return out


def probe_dyn_read_ref(src: torch.Tensor, offs: torch.Tensor,
                       win: int = 128) -> torch.Tensor:
    out = src.new_zeros((offs.shape[0] * win, src.shape[1]))
    for b, off in enumerate(offs.tolist()):
        if _fits(off, win, src.shape[0]):
            out[b * win:(b + 1) * win] = src[off:off + win] * 2.0
    return out


# -- transpose -------------------------------------------------------------

def transpose_vec(shape, aligned: bool) -> bool:
    """Whether the transpose kernel moves 16-byte vectors on an array of
    ``shape``: rows and columns multiples of 4 and ``aligned`` (both
    pointers on a 16-byte boundary); else the same four floats one by
    one."""
    return shape[0] % 4 == 0 and shape[1] % 4 == 0 and aligned


def probe_transpose(x: torch.Tensor) -> torch.Tensor:
    """x [rows, cols] f32 -> [cols, rows]."""
    if not _on_cuda(x, "transpose"):
        return probe_transpose_ref(x)
    _check_2d("x", x)
    out = torch.empty((x.shape[1], x.shape[0]), dtype=torch.float32,
                      device=x.device)
    vec = transpose_vec(x.shape, x.data_ptr() % 16 == 0
                        and out.data_ptr() % 16 == 0)
    _launch("probe_transpose",
            (x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], int(vec),
             _build.stream(x.device)))
    return out


def probe_transpose_ref(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


# -- a scratch buffer kept across steps ------------------------------------

def probe_vmem_dyn(offs: torch.Tensor, x: torch.Tensor, buf_rows: int,
                   rmw: bool) -> torch.Tensor:
    """x [steps, win, cols] f32 -> [steps, win, cols]: a zero scratch
    buffer [buf_rows, cols] kept across the steps in order; step s's
    window starts at row offs[s] and is read (``buf * 0 + 2 * x[s]``) or,
    with ``rmw``, has ``x[s]`` added first and is then read. A step whose
    window does not fit is skipped and gives zeros."""
    if not _on_cuda(x, "vmem_dyn"):
        return probe_vmem_dyn_ref(offs, x, buf_rows, rmw)
    if x.dim() != 3:
        raise ValueError(f"x: expected [steps, win, cols], got "
                         f"{tuple(x.shape)}")
    check_tensor("x", x, torch.float32, x.shape, x.device)
    steps, win, cols = x.shape
    _check_offs(offs, x.device)
    if offs.shape[0] != steps:
        raise ValueError(f"offs: one per step ({steps}), got "
                         f"{offs.shape[0]}")
    if steps > MAX_WINDOWS:
        raise ValueError(f"the kernel takes up to {MAX_WINDOWS} steps, got "
                         f"{steps}")
    _check_windows(win, cols)
    _check_aligned("x", x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch("probe_vmem_dyn",
            (offs.data_ptr(), x.data_ptr(), out.data_ptr(), steps, win,
             cols, buf_rows, int(rmw), _build.stream(x.device)))
    return out


def probe_vmem_dyn_ref(offs: torch.Tensor, x: torch.Tensor, buf_rows: int,
                       rmw: bool) -> torch.Tensor:
    steps, win, cols = x.shape
    buf = x.new_zeros((buf_rows, cols))
    out = torch.zeros_like(x)
    for s, off in enumerate(offs.tolist()):
        if not _fits(off, win, buf_rows):
            continue
        if rmw:
            buf[off:off + win] += x[s]
            out[s] = buf[off:off + win]
        else:
            out[s] = buf[off:off + win] * 0.0 + x[s] * 2.0
    return out


KERNELS = {
    "roll": (probe_roll, probe_roll_ref),
    "onehot": (probe_onehot, probe_onehot_ref),
    "dyn_write": (probe_dyn_write, probe_dyn_write_ref),
    "dyn_read": (probe_dyn_read, probe_dyn_read_ref),
    "transpose": (probe_transpose, probe_transpose_ref),
    "vmem_dyn": (probe_vmem_dyn, probe_vmem_dyn_ref),
}


# -- the script's runs: inputs and NumPy oracles ---------------------------

class Case(NamedTuple):
    probe: str
    inputs: Callable[[], Dict[str, np.ndarray]]     # NumPy inputs
    call: Callable                                  # (fn, tensors) -> out
    error: Callable[[Dict[str, np.ndarray], np.ndarray], float]  # oracle


def _roll_case(axis, shape):
    def inputs():
        return {"x": np.arange(np.prod(shape), dtype=np.float32)
                .reshape(shape)}

    def error(a, out):
        ref = a["x"] + 0.5 * np.roll(a["x"], 2, axis=axis)
        return float(np.max(np.abs(out - ref)))
    return Case("roll", inputs, lambda fn, t: fn(t["x"], 2, axis), error)


def _onehot_case():
    def inputs():
        rng = np.random.default_rng(0)
        rloc = np.repeat(np.arange(16), 8).astype(np.float32)   # seg ids
        return {"r8": np.broadcast_to(rloc, (8, 128)).copy(),
                "c": rng.normal(size=(128, 256)).astype(np.float32)}

    def error(a, out):
        onehot = np.arange(128)[:, None] == a["r8"][0][None, :]
        ref = onehot.astype(np.float32) @ a["c"]
        return float(np.max(np.abs(out - ref)))
    return Case("onehot", inputs, lambda fn, t: fn(t["r8"], t["c"]), error)


def _dyn_write_case():
    def inputs():
        return {"offs": np.asarray([40, 200], np.int32)}   # 8-aligned

    def error(a, out):
        ref_rows = np.arange(128, dtype=np.float32)[:, None]
        e1 = np.max(np.abs(out[40:168] - (1.0 + ref_rows)))
        e2 = np.max(np.abs(out[200:328] - (2.0 + ref_rows)))
        return float(max(e1, e2))
    return Case("dyn_write", inputs,
                lambda fn, t: fn(t["offs"], 512, 256, 128), error)


def _dyn_read_case():
    def inputs():
        rng = np.random.default_rng(1)
        return {"src": rng.normal(size=(512, 512)).astype(np.float32),
                "offs": np.asarray([88, 16], np.int32)}

    def error(a, out):
        e1 = np.max(np.abs(out[:128] - 2 * a["src"][88:216]))
        e2 = np.max(np.abs(out[128:] - 2 * a["src"][16:144]))
        return float(max(e1, e2))
    return Case("dyn_read", inputs,
                lambda fn, t: fn(t["src"], t["offs"], 128), error)


def _transpose_case():
    def inputs():
        return {"x": np.arange(256 * 128, dtype=np.float32)
                .reshape(256, 128)}

    def error(a, out):
        return float(np.max(np.abs(out - a["x"].T)))
    return Case("transpose", inputs, lambda fn, t: fn(t["x"]), error)


VMEM_ROWS = 264           # the scratch buffer's rows (the script's SW)


def _vmem_dyn_case(rmw):
    def inputs():
        rng = np.random.default_rng(5)
        return {"x": rng.normal(size=(2, 128, 256)).astype(np.float32),
                "offs": np.asarray([8, 104], np.int32)}

    def error(a, out):
        x = a["x"]
        if rmw:
            buf = np.zeros((VMEM_ROWS, 256), np.float32)
            refs = []
            for b, off in enumerate([8, 104]):
                buf[off:off + 128] += x[b]
                refs.append(buf[off:off + 128].copy())
            return float(max(np.max(np.abs(out[b] - refs[b]))
                             for b in range(2)))
        return float(np.max(np.abs(out - 2 * x)))
    return Case("vmem_dyn", inputs,
                lambda fn, t: fn(t["offs"], t["x"], VMEM_ROWS, rmw), error)


# the script's runs, under its labels (segpair_mosaic_probe.py:222-235)
CASES = {
    "P1 roll-axis0-[128,256]": _roll_case(0, (128, 256)),
    "P2 roll-axis1-[256,128]": _roll_case(1, (256, 128)),
    "P3 onehot-matmul": _onehot_case(),
    "P4 dyn-offset-DMA-write": _dyn_write_case(),
    "P5 dyn-offset-DMA-read": _dyn_read_case(),
    "P6 transpose-256x128": _transpose_case(),
    "P7a vmem-dyn-read": _vmem_dyn_case(False),
    "P7b vmem-dyn-rmw-add": _vmem_dyn_case(True),
}
# the oracle's tolerance: 0 (every probe moves or adds once) but for the
# one-hot sum, whose 8-term sums the oracle's matmul orders otherwise
ONEHOT_ATOL = 1e-5


def case_tensors(name: str, device) -> Dict[str, torch.Tensor]:
    """The NumPy inputs of case ``name`` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in CASES[name].inputs().items()}


def run_case(name: str, device, plain: bool = False):
    """Run case ``name`` through its kernel (``plain``: its plain version)
    on ``device``: (output, the oracle's max-abs error, its tolerance)."""
    case = CASES[name]
    a = case.inputs()
    t = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
    out = case.call(KERNELS[case.probe][1 if plain else 0], t)
    tol = ONEHOT_ATOL if case.probe == "onehot" else 0.0
    return out, case.error(a, out.detach().cpu().numpy()), tol
