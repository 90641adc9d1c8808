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
