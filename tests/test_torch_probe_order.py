"""The orders of the one-launch vmem_dyn and shard-sum kernels, on the CPU
(no nvcc, no card, no JAX).

- ``vmem_dyn_walk``, a NumPy model of ``csrc/lab_probes.cu``'s
  owner-computes vmem_dyn: no buffer is kept; each output element of a
  step whose window fits walks the steps up to its own, in order, and adds
  from 0 the x of each fitting window that covers its buffer row (``rmw``),
  or stores ``0 + 2 * x`` (read mode); a step whose window does not fit
  gives zeros. It is held bit for bit to ``probe_vmem_dyn_ref``, the
  sequential buffer, on seeded random steps (0-8 of them; overlapping,
  out-of-range and negative offsets) in both modes, and on the script's
  runs P7a / P7b. Exact: the walk makes the buffer's additions in the
  buffer's order.
- ``shard_sum_order``, a NumPy float32 model of ``csrc/shard_sum.cu``'s
  order: rows in blocks of ``ROWS_PER_CTA`` a CTA, warp w adding rows w,
  w + WARPS, ... of its block from 0, a tree over the warps, the partials
  in ``GROUPS`` contiguous groups in CTA order, a tree over the groups,
  then 2x. Within 1e-5 relative of the float64 sum (uniform draws, so no
  cancellation) at 0, 1, 63, 64, 65, 127, 1000 and 16384 rows; the kernel
  is held to it bit for bit on the card (tests/test_torch_kernels.py).
  The constants it reads from ``ops/shard_sum.py`` are the kernel
  source's.
- ``roll_model``, a NumPy model of the roll kernel's index map: the
  wrapper's plan (``probes.roll_plan``: 16-byte vectors where rows are
  16-byte multiples and the pointers aligned, the shift brought into
  ``[0, n_axis)`` on the host), one element of out a thread, the source
  wrapped with one compare, and for axis 1 by ``4q + M`` columns the two
  vectors the window straddles, selected as the kernel's ``window`` does
  (its ``make_float4`` lanes read from ``csrc/lab_probes.cu``). Bit for bit
  ``probe_roll_ref`` and ``np.roll`` on shifts -5..9, both axes, widths 1-9
  and 128-260, aligned or not, and on the script's runs P1 / P2.
- ``transpose_model``, a NumPy model of the tiled transpose: its tiles
  (the source's ``TRANSPOSE_ROWS`` x ``TRANSPOSE_COLS``), each thread's
  16-byte load into the swizzled tile and 16-byte store of an out row
  segment, the scalar path with its edges; ``x.T`` exactly on shapes from
  [1, 1] to [257, 131] and on P6, every element written once. The
  swizzle's two phases are free of bank conflicts for each tile shape the
  kernel's ``static_assert`` admits.
"""

import re

import numpy as np
import pytest
import torch

from edgegaussians_tpu_torch.lab import probes
from edgegaussians_tpu_torch.ops import _build, shard_sum

from test_torch_build import _overlap, _random_windows

_fits = probes._fits


def vmem_dyn_walk(offs, x, buf_rows, rmw):
    """out [steps, win, cols] of the owner-computes vmem_dyn kernel."""
    steps, win, cols = x.shape
    out = np.zeros_like(x)
    for s in range(steps):
        off = int(offs[s])
        if not _fits(off, win, buf_rows):
            continue
        if not rmw:
            out[s] = np.float32(0.0) + np.float32(2.0) * x[s]
            continue
        for r in range(win):
            acc = np.zeros(cols, np.float32)
            for t in range(s + 1):          # the steps in their order
                o = int(offs[t])
                if _fits(o, win, buf_rows) and o <= off + r < o + win:
                    acc = acc + x[t, off + r - o]
            out[s, r] = acc
    return out


@pytest.mark.parametrize("rmw", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_vmem_dyn_ref_is_the_owner_computes_walk(seed, rmw):
    """tests/test_torch_build.py's random windows, one a step, the array's
    rows the buffer's."""
    rng = np.random.default_rng(500 + seed)
    overlaps = skipped = 0
    for _ in range(12):
        buf_rows, cols, win, offs = _random_windows(rng)
        x = rng.normal(size=(len(offs), win, cols)).astype(np.float32)
        got = probes.probe_vmem_dyn_ref(torch.from_numpy(offs),
                                        torch.from_numpy(x), buf_rows, rmw)
        np.testing.assert_array_equal(got.numpy(),
                                      vmem_dyn_walk(offs, x, buf_rows, rmw))
        overlaps += _overlap(offs, win, buf_rows)
        skipped += any(not _fits(int(o), win, buf_rows) for o in offs)
    assert overlaps and skipped       # both cases were drawn


@pytest.mark.parametrize("name", ["P7a vmem-dyn-read", "P7b vmem-dyn-rmw-add"])
def test_vmem_dyn_walk_on_the_script_runs(name):
    """The script's runs: the walk gives the plain version's bits and the
    oracle's error 0."""
    case = probes.CASES[name]
    a = case.inputs()
    rmw = name.startswith("P7b")
    walk = vmem_dyn_walk(a["offs"], a["x"], probes.VMEM_ROWS, rmw)
    plain, _, _ = probes.run_case(name, torch.device("cpu"), plain=True)
    np.testing.assert_array_equal(plain.numpy(), walk)
    assert case.error(a, walk) == 0.0


def shard_sum_order(x):
    """[1, 128] float32: csrc/shard_sum.cu's sum of x [rows, 128], in its
    order. Padding rows are +0: a sum that starts at +0 never becomes -0,
    so adding +0 gives the bits of skipping the row."""
    R, W, G = shard_sum.ROWS_PER_CTA, shard_sum.WARPS, shard_sum.GROUPS
    rows = x.shape[0]
    n = shard_sum.blocks(rows)
    xp = np.zeros((n * R, 128), np.float32)
    xp[:rows] = x
    # row b * R + k * W + w goes to CTA b, warp w, as its k-th add
    blocks = xp.reshape(n, R // W, W, 128)
    acc = np.zeros((n, W, 128), np.float32)
    for k in range(R // W):
        acc = acc + blocks[:, k]
    partials = _tree(acc)                       # [n, 128]
    per = -(-n // G)
    pp = np.zeros((G * per, 128), np.float32)
    pp[:n] = partials
    groups = np.zeros((G, 128), np.float32)
    for j in range(per):
        groups = groups + pp.reshape(G, per, 128)[:, j]
    return (np.float32(2.0) * _tree(groups[None]))


def _tree(part):
    """[..., W, 128] -> [..., 128]: part[w] += part[w + half] for half =
    W/2, ..., 1."""
    part = part.copy()
    half = part.shape[-2] // 2
    while half:
        part[..., :half, :] = part[..., :half, :] + part[..., half:2 * half, :]
        half //= 2
    return part[..., 0, :]


@pytest.mark.parametrize("rows", [0, 1, 63, 64, 65, 127, 1000, 16384])
def test_shard_sum_order_model_against_float64(rows):
    x = np.random.default_rng(rows).random((rows, 128)).astype(np.float32)
    got = shard_sum_order(x)
    assert got.shape == (1, 128) and got.dtype == np.float32
    exact = 2.0 * x.astype(np.float64).sum(0, keepdims=True)
    if rows == 0:
        assert (got == 0).all()
        return
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=0)
    # the plain version sums in another order, within the same bound
    plain = shard_sum.shard_sum2x_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(plain, exact, rtol=1e-5, atol=0)


def test_shard_sum_constants_are_the_kernel_source():
    """The model's constants, and the wrapper's CTA count, are the ones
    csrc/shard_sum.cu compiles with."""
    src = (_build.CSRC / "shard_sum.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\w+);", src))
    assert int(const["ROWS_PER_CTA"]) == shard_sum.ROWS_PER_CTA
    assert int(const["WARPS"]) == shard_sum.WARPS
    assert const["GROUPS"] == "WARPS" and shard_sum.GROUPS == shard_sum.WARPS
    r = shard_sum.ROWS_PER_CTA
    assert [shard_sum.blocks(n) for n in (0, 1, r, r + 1, 128 * r)] == \
        [1, 1, 1, 2, 128]


# -- the roll kernel's index map --------------------------------------------

_SRC = _build.CSRC / "lab_probes.cu"


def _constants():
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", _SRC.read_text())}


def _roll_selects():
    """{M: [("lo" | "hi", lane)] * 4}: the lanes of each ``make_float4``
    of the kernel's axis-1 ``window``, M = 1, 2, 3 in source order."""
    src = _SRC.read_text()
    body = src[src.index("float4 window("):src.index("float window(")]
    picks = re.findall(r"make_float4\(([^)]*)\)", body)
    assert len(picks) == 3, picks
    return {m: [(a.split(".")[0].strip(), "xyzw".index(a.split(".")[1]
                                                      .strip()))
                for a in args.split(",")]
            for m, args in zip((1, 2, 3), picks)}


def _wrap(i, n):
    """The kernel's wrap_low: one compare, which suffices for i in [-n, n)."""
    i = np.asarray(i)
    assert ((i >= -n) & (i < n)).all()
    return np.where(i < 0, i + n, i)


def roll_model(x, shift, axis, aligned=True):
    """out of the roll kernel on ``x`` [rows, cols] float32."""
    rows, cols = x.shape
    vec, s = probes.roll_plan(x.shape, shift, axis, aligned)
    if x.size == 0:
        return x.copy()
    r = np.arange(rows)[:, None]
    if not vec:                           # one float a thread
        c = np.arange(cols)[None, :]
        y = x[_wrap(r - s, rows), c] if axis == 0 else x[r, _wrap(c - s,
                                                                   cols)]
    else:                                 # one 16-byte vector a thread
        cols_v = cols // 4
        xv = x.reshape(rows, cols_v, 4)
        c = np.arange(cols_v)[None, :]
        if axis == 0:
            y = xv[_wrap(r - s, rows), c]
        else:
            q, m = s // 4, s % 4          # the C entry's split, on the host
            hi = xv[r, _wrap(c - q, cols_v)]
            if m == 0:
                y = hi
            else:
                lo = xv[r, _wrap(c - q - 1, cols_v)]
                y = np.stack([(lo if v == "lo" else hi)[..., lane]
                              for v, lane in _roll_selects()[m]], -1)
        y = y.reshape(rows, cols)
    return x + np.float32(0.5) * y        # two roundings, as add_half


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


ROLL_WIDTHS = list(range(1, 10)) + list(range(128, 261))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shift", range(-5, 10))
def test_roll_model_is_the_plain_version(shift, axis):
    """Every width of ROLL_WIDTHS at 1, 3 and 8 rows, vectors where the
    plan allows and the scalar path (misaligned) always."""
    rng = np.random.default_rng(1000 + 31 * shift + axis)
    for cols in ROLL_WIDTHS:
        for rows in (1, 3, 8):
            x = rng.normal(size=(rows, cols)).astype(np.float32)
            plain = probes.probe_roll_ref(torch.from_numpy(x), shift,
                                          axis).numpy()
            oracle = x + np.float32(0.5) * np.roll(x, shift, axis)
            np.testing.assert_array_equal(_bits(plain), _bits(oracle))
            for aligned in (True, False):
                got = roll_model(x, shift, axis, aligned)
                np.testing.assert_array_equal(
                    _bits(got), _bits(plain),
                    err_msg=f"{rows}x{cols} shift {shift} axis {axis} "
                    f"aligned {aligned}")


def test_roll_plan():
    """Vectors only for 16-byte rows and aligned pointers; the shift in
    [0, n_axis) for any integer, 0 on an empty axis."""
    assert probes.roll_plan((3, 8), -5, 1, True) == (True, 3)
    assert probes.roll_plan((3, 8), 2 ** 40 + 1, 0, True) == (True, 2)
    assert probes.roll_plan((3, 6), 2, 1, True) == (False, 2)
    assert probes.roll_plan((3, 8), 2, 1, False) == (False, 2)
    assert probes.roll_plan((0, 8), 7, 0, True) == (True, 0)


@pytest.mark.parametrize("name", ["P1 roll-axis0-[128,256]",
                                  "P2 roll-axis1-[256,128]"])
def test_roll_model_on_the_script_runs(name):
    case = probes.CASES[name]
    a = case.inputs()
    axis = 0 if name.startswith("P1") else 1
    got = roll_model(a["x"], 2, axis)
    plain, _, _ = probes.run_case(name, torch.device("cpu"), plain=True)
    np.testing.assert_array_equal(_bits(got), _bits(plain.numpy()))
    assert case.error(a, got) == 0.0


# -- the tiled transpose's map ----------------------------------------------

def _swizzle(g, r, tr):
    """The kernel's swizzle<TR>: chunk g of tile row r."""
    return g ^ (((r >> 2) * (32 // tr)) & 7)


def _threads(tr, tc):
    """Per thread of a CTA: (load row i, load chunk j, store row c, store
    chunk k), as the kernel splits threadIdx.x by shifts and masks."""
    cv, rv = tc // 4, tr // 4
    t = np.arange(tr * cv)
    return t, t // cv, t % cv, t // rv, t % rv


def transpose_model(x, aligned=True, tile=None):
    """out [cols, rows] of the transpose kernel on ``x``; NaN where no
    thread stores (the wrapper's torch.empty)."""
    const = _constants()
    tr, tc = tile or (const["TRANSPOSE_ROWS"], const["TRANSPOSE_COLS"])
    rows, cols = x.shape
    vec = probes.transpose_vec(x.shape, aligned)
    out = np.full((cols, rows), np.nan, np.float32)
    written = np.zeros((cols, rows), np.int64)
    cv = tc // 4
    t, i, j, c, k = _threads(tr, tc)
    for r0 in range(0, rows, tr):
        for c0 in range(0, cols, tc):
            tile_f = np.full(tr * tc, np.nan, np.float32)
            r, col = r0 + i, c0 + 4 * j
            v = np.zeros((t.size, 4), np.float32)
            for e in range(4):
                # VEC loads a whole chunk where col < cols (cols % 4 == 0)
                ok = (r < rows) & ((col < cols) if vec else (col + e < cols))
                v[ok, e] = x[r[ok], col[ok] + e]
            phys = _swizzle(t, i, tr)
            assert np.unique(phys).size == t.size     # a permutation
            for e in range(4):
                tile_f[4 * phys + e] = v[:, e]
            oc, orow = c0 + c, r0 + 4 * k
            w = np.stack([tile_f[4 * _swizzle((4 * k + u) * cv + (c >> 2),
                                              4 * k + u, tr) + (c & 3)]
                          for u in range(4)], -1)
            for u in range(4):
                ok = (oc < cols) & (orow < rows) & (
                    True if vec else orow + u < rows)
                if vec:
                    assert (orow[ok] + 4 <= rows).all()
                out[oc[ok], orow[ok] + u] = w[ok, u]
                written[oc[ok], orow[ok] + u] += 1
    assert (written == 1).all()                       # each element once
    return out


TRANSPOSE_SHAPES = [(1, 1), (1, 4), (4, 1), (4, 4), (3, 5), (31, 17),
                    (32, 16), (33, 16), (64, 64), (100, 260), (260, 100),
                    (256, 128), (257, 131)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", TRANSPOSE_SHAPES)
def test_transpose_model_is_the_transpose(shape, aligned):
    x = np.random.default_rng(shape[0] * 1000 + shape[1]).normal(
        size=shape).astype(np.float32)
    got = transpose_model(x, aligned)
    np.testing.assert_array_equal(_bits(got), _bits(x.T))
    plain = probes.probe_transpose_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(plain))


def test_transpose_model_on_the_script_run():
    name = "P6 transpose-256x128"
    case = probes.CASES[name]
    a = case.inputs()
    got = transpose_model(a["x"])
    plain, _, _ = probes.run_case(name, torch.device("cpu"), plain=True)
    np.testing.assert_array_equal(_bits(got), _bits(plain.numpy()))
    assert case.error(a, got) == 0.0


@pytest.mark.parametrize("tile", [(16, 16), (16, 32), (32, 16), (32, 32)])
def test_transpose_swizzle_is_free_of_bank_conflicts(tile):
    """Bank of float w of the tile: w % 32. The loads' 16-byte stores
    run in phases of 8 threads, each phase's 8 chunks one 128-byte line;
    each of a warp's four 4-byte reads of the store phase hits 32 distinct
    banks. The model at this tile is the transpose as well."""
    tr, tc = tile
    cv = tc // 4
    t, i, _, c, k = _threads(tr, tc)
    phys = _swizzle(t, i, tr)
    for p0 in range(0, t.size, 8):
        banks = (4 * (phys[p0:p0 + 8] % 8))
        assert np.unique(banks).size == 8
    for w0 in range(0, t.size, 32):
        cw, kw = c[w0:w0 + 32], k[w0:w0 + 32]
        for u in range(4):
            word = 4 * _swizzle((4 * kw + u) * cv + (cw >> 2), 4 * kw + u,
                                tr) + (cw & 3)
            assert np.unique(word % 32).size == 32, (tile, w0, u)
    x = np.random.default_rng(7).normal(size=(67, 45)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(transpose_model(x, tile=tile)), _bits(x.T))
