"""The port's launch path (edgegaussians_tpu_torch/ops/_build.py) and the
semantics the one-launch dyn_write / dyn_read probe kernels keep, on the
CPU (no nvcc, no card).

- ``_build.launch`` binds a C entry's prototype once and raises on a
  later call that names other ``argtypes``; a nonzero return raises as a
  CUDA error. Driven through libc's ``abs``, which returns its argument's
  magnitude where a kernel entry returns ``cudaGetLastError()``.
- ``_build.library_path`` hashes the headers a source includes: editing
  a header moves the library of every source that includes it (directly
  or through another header) and of no other, in a temporary ``CSRC``.
- ``probe_dyn_write_ref`` / ``probe_dyn_read_ref`` (lab/probes.py) on
  random windows (overlapping, out of range, at offsets that are not
  multiples of 8, up to 8 of them) against a NumPy oracle in the
  owner-computes form the kernels take: each output row takes the last
  fitting window that covers it, and every other row is 0. Exact: both
  sides write the same f32 values.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from edgegaussians_tpu_torch.lab import probes
from edgegaussians_tpu_torch.ops import _build

DRAWS = 25          # random window sets per seed


@pytest.fixture
def libc(monkeypatch):
    """``_build.load`` returning libc, with an empty binding table; the
    list of the libraries it was asked for."""
    asked = []

    def load(name):
        asked.append(name)
        return ctypes.CDLL(None)
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_bound", {})
    return asked


def test_launch_binds_each_entry_once(libc):
    argtypes = (ctypes.c_int,)
    _build.launch("libc", "abs", argtypes, (0,))
    fn = _build.bind("libc", "abs", argtypes)
    assert fn.restype is ctypes.c_int and tuple(fn.argtypes) == argtypes
    _build.launch("libc", "abs", (ctypes.c_int,), (0,))   # equal, not same
    assert libc == ["libc"]
    assert _build.bind("libc", "abs", argtypes) is fn


def test_launch_raises_on_a_nonzero_return(libc):
    argtypes = (ctypes.c_int,)
    _build.launch("libc", "abs", argtypes, (0,))
    with pytest.raises(RuntimeError, match="abs kernel launch failed: "
                                           "cudaError 5"):
        _build.launch("libc", "abs", argtypes, (5,))
    with pytest.raises(RuntimeError, match="cudaError 5"):
        _build.launch("libc", "abs", argtypes, (-5,))


def test_launch_raises_on_other_argtypes(libc):
    _build.launch("libc", "abs", (ctypes.c_int,), (0,))
    with pytest.raises(TypeError, match="libc.abs was bound with"):
        _build.launch("libc", "abs", (ctypes.c_long,), (0,))
    with pytest.raises(TypeError):
        _build.launch("libc", "abs", (ctypes.c_int, ctypes.c_int), (0, 0))
    # the first prototype stays bound
    _build.launch("libc", "abs", (ctypes.c_int,), (0,))
    assert libc == ["libc"]


def test_library_path_hashes_the_headers_a_source_includes(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "inner.cuh").write_text("constexpr int A = 1;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "direct.cu").write_text(
        '#include <cuda_runtime.h>\n#include "inner.cuh"\nint f();\n')
    (tmp_path / "nested.cu").write_text(
        '  #  include "outer.cuh"\n#include "inner.cuh"\nint g();\n')
    (tmp_path / "alone.cu").write_text("int h();\n")
    names = ("direct", "nested", "alone")
    assert [p.name for p in _build.sources("nested")] == [
        "nested.cu", "outer.cuh", "inner.cuh"]
    assert [p.name for p in _build.sources("alone")] == ["alone.cu"]
    before = {n: _build.library_path(n) for n in names}
    assert before == {n: _build.library_path(n) for n in names}
    (tmp_path / "inner.cuh").write_text("constexpr int A = 2;\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["direct"] != before["direct"]
    assert after["nested"] != before["nested"]
    assert after["alone"] == before["alone"]
    assert all(after[n].name.startswith(f"{n}-") for n in names)


def test_compositor_header_rebuilds_both_compositor_libraries(tmp_path,
                                                              monkeypatch):
    """The repository's own sources: csrc/segpair.cu, csrc/pair.cu,
    csrc/raster_v2.cu, csrc/raster_v1.cu and the lab's
    csrc/lab_chunked.cu share csrc/compositor.cuh; an edit of it moves
    those libraries and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    before = {n: _build.library_path(n) for n in names}
    with open(csrc / "compositor.cuh", "a") as f:
        f.write("// edited\n")
    moved = {n for n in names if _build.library_path(n) != before[n]}
    assert moved == {"lab_chunked", "pair", "raster_v1", "raster_v2",
                     "segpair"}


def test_wrappers_bind_constant_prototypes():
    """Every probe entry's argtypes are one tuple, built at import: the
    launch path's identity check then costs nothing."""
    assert set(probes.ARGTYPES) == set(probes.launch_counts)
    for argtypes in probes.ARGTYPES.values():
        assert isinstance(argtypes, tuple)
        assert argtypes[-1] is ctypes.c_void_p          # the stream


def _random_windows(rng):
    """rows, cols, win and 0-8 int32 offsets: about 60% inside the array
    where a window fits at all, the rest anywhere in [-win - 8, rows + 8)
    (mostly out of range)."""
    rows = int(rng.integers(1, 300))
    win = int(rng.choice([1, 5, 8, 16, 40, 128, 300]))
    n_win = int(rng.integers(0, 9))
    offs = rng.integers(-win - 8, rows + 8, n_win)
    if rows >= win:
        inside = rng.integers(0, rows - win + 1, n_win)
        offs = np.where(rng.random(n_win) < 0.6, inside, offs)
    cols = int(rng.choice([4, 8, 12]))
    return rows, cols, win, offs.astype(np.int32)


def _fits(off, win, rows):
    return 0 <= off <= rows - win


def _owner_write(offs, rows, cols, win):
    out = np.zeros((rows, cols), np.float32)
    for row in range(rows):
        for b in reversed(range(len(offs))):
            off = int(offs[b])
            if _fits(off, win, rows) and off <= row < off + win:
                out[row] = np.float32(b + 1) + np.float32(row - off)
                break
    return out


def _owner_read(src, offs, win):
    out = np.zeros((len(offs) * win, src.shape[1]), np.float32)
    for row in range(out.shape[0]):
        b = row // win
        off = int(offs[b])
        if _fits(off, win, src.shape[0]):
            out[row] = 2 * src[off + row - b * win]
    return out


def _overlap(offs, win, rows):
    fit = sorted(int(o) for o in offs if _fits(int(o), win, rows))
    return any(b - a < win for a, b in zip(fit, fit[1:]))


@pytest.mark.parametrize("seed", range(8))
def test_dyn_write_ref_is_the_owner_computes_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    overlaps = skipped = 0
    for _ in range(DRAWS):
        rows, cols, win, offs = _random_windows(rng)
        got = probes.probe_dyn_write_ref(torch.from_numpy(offs), rows, cols,
                                         win)
        np.testing.assert_array_equal(got.numpy(),
                                      _owner_write(offs, rows, cols, win))
        overlaps += _overlap(offs, win, rows)
        skipped += any(not _fits(int(o), win, rows) for o in offs)
    assert overlaps and skipped       # both cases were drawn


@pytest.mark.parametrize("seed", range(8))
def test_dyn_read_ref_is_the_owner_computes_oracle(seed):
    rng = np.random.default_rng(200 + seed)
    skipped = 0
    for _ in range(DRAWS):
        rows, cols, win, offs = _random_windows(rng)
        src = rng.normal(size=(rows, cols)).astype(np.float32)
        got = probes.probe_dyn_read_ref(torch.from_numpy(src),
                                        torch.from_numpy(offs), win)
        np.testing.assert_array_equal(got.numpy(),
                                      _owner_read(src, offs, win))
        skipped += any(not _fits(int(o), win, rows) for o in offs)
    assert skipped


@pytest.mark.parametrize("win,cols", [(0, 8), (16, 6)])
def test_window_wrappers_refuse_what_the_kernels_do_not_take(win, cols):
    with pytest.raises(ValueError, match="16-byte rows"):
        probes._check_windows(win, cols)
