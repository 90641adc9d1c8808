"""The walk of the lab's chunked-scan kernels (csrc/lab_chunked.cu), as a
plain NumPy model in float32, against the plain versions
(``chunked_fwd_ref`` / ``chunked_bwd_ref``) and the JAX labs
(``scripts/kernel_lab.py`` ``fwd_v3`` / ``bwd_v3``,
``scripts/cumprod_lab.py`` ``fwd``, in Pallas interpret mode), on the
cases of ``lab_order_cases`` (tests/test_torch_kernels.py, where the same
cases hold the kernels to the plain versions on the card).

The model walks as the kernels do, each pixel on its own: the row's slots
in batches by position (the forward's the largest of 128, 96, 64, 32 that
divides ``chunk``, the backward's 64), each batch's live slots (the
constant term above -1e29) in depth order and in sub-chunks of 16, the
scan form's factors over a sub-chunk, the carry at each sub-chunk's end
(``noscan``: at each chunk's end, by the chunk's last slot by position);
the backward carries c_inc per pixel and reduces each sub-chunk's d log a
over the pixels. Dead slots are never walked. Gates as in
tests/test_torch_lab.py: image atol 1e-5 (``logsum`` 5e-5), ``t_out``
rtol 1e-5 where >= 1e-4, dfeats 1e-4 of max-abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu_torch.lab import chunked
from edgegaussians_tpu_torch.ops import tiles

from test_torch_kernels import _lab_planes, lab_order_cases
from test_torch_lab import (GRAD_RTOL_OF_MAX, IMG_ATOL,  # noqa: F401
                            LOGSUM_ATOL, _check_t_out, cumprod_lab,
                            interpret, kernel_lab)

torch.set_num_threads(2)

SUB = 16            # live slots of a sub-chunk (the kernels' SUB and MT)
BWD_BATCH = 64      # the backward's batch by position
F = np.float32
DEAD_MARK = F(-1e29)


@pytest.fixture(scope="module")
def cases():
    return lab_order_cases()


def fwd_batch(chunk):
    """The forward's batch: the largest of 128, 96, 64 and 32 slots that
    divides ``chunk``."""
    return next(32 * s for s in (4, 3, 2, 1) if (chunk // 32) % s == 0)


def _alpha(fs, basis):
    """alpha [S,256] of the slots fs [S,8] and where d log a is not zero."""
    la = (fs[:, :6] @ basis[:6]).astype(F)
    x = np.exp(la)
    ok = (la <= fs[:, 6:7] + F(1e-3)) & (x >= F(1.0 / 255.0))
    return np.where(ok, np.minimum(x, F(0.999)), F(0)), ok & (x < F(0.999))


def _factors(om, scan):
    """The inclusive factors of a sub-chunk's om [S,256] in ``scan``."""
    if scan == "v3":
        return np.cumprod(om, axis=0, dtype=F)
    if scan == "noscan":
        return om
    if scan == "twolevel":
        out, excl = np.empty_like(om), np.ones_like(om[0])
        for g0 in range(0, len(om), 8):
            x = np.cumprod(om[g0:g0 + 8], axis=0, dtype=F)
            out[g0:g0 + 8] = x * excl
            excl = excl * x[-1]
        return out
    return np.exp(np.cumsum(np.log(np.maximum(om, F(1e-30))), axis=0,
                            dtype=F))


def _live(fb):
    return ~(fb[:, 5] <= DEAD_MARK)


def walk_fwd(feats, basis, t_in, scan, chunk, carry="position"):
    """(img, t_out) [T,256] in the kernels' order. ``carry="last_live"``
    moves ``noscan``'s carry at a chunk's end by the last LIVE slot
    instead (wrong: the tests show the dead-end case tells them apart)."""
    T, K, _ = feats.shape
    chunk = chunked.resolve_chunk(K, chunk, scan)   # min(chunk, K)
    img = np.zeros((T, 256), F)
    t_out = np.empty((T, 256), F)
    batch = fwd_batch(chunk)
    for row in range(T):
        t = np.ones(256, F) if t_in is None else t_in[row].copy()
        acc = np.zeros(256, F)
        for base in range(0, K, batch):
            fb = feats[row, base:base + batch]
            live = _live(fb)
            fl = fb[live]
            om = None
            for m0 in range(0, len(fl), SUB):
                a, _ = _alpha(fl[m0:m0 + SUB], basis)
                om = F(1) - a
                fac = _factors(om, scan)
                for r in range(len(a)):
                    t_inc = t * fac[r]
                    acc = acc + np.where(t_inc >= F(1e-4), a[r],
                                         F(0)) * (t_inc / om[r])
                if scan != "noscan":
                    t = t * fac[-1]
            if scan == "noscan" and (base + len(fb)) % chunk == 0:
                moves = live[-1] if carry == "position" else len(fl) > 0
                if moves:
                    t = t * om[-1]
        img[row], t_out[row] = acc, t
    return img, t_out


def walk_bwd(feats, basis, g, t_in, prior, total):
    """dfeats [T,K,8] of the ``v3`` forward in the kernels' order."""
    T, K, _ = feats.shape
    dfeats = np.zeros_like(feats)
    for row in range(T):
        t = np.ones(256, F) if t_in is None else t_in[row].copy()
        c = np.zeros(256, F) if prior is None else prior[row].copy()
        for base in range(0, K, BWD_BATCH):
            fb = feats[row, base:base + BWD_BATCH]
            idx = base + np.flatnonzero(_live(fb))
            for m0 in range(0, len(idx), SUB):
                slots = idx[m0:m0 + SUB]
                a, takes = _alpha(feats[row, slots], basis)
                om = F(1) - a
                fac = _factors(om, "v3")
                dla = np.zeros_like(a)
                for r in range(len(a)):
                    t_inc = t * fac[r]
                    keep = t_inc >= F(1e-4)
                    t_prev = t_inc / om[r]
                    c = c + np.where(keep, a[r], F(0)) * t_prev
                    dla[r] = np.where(keep & takes[r], a[r] * (
                        (t_prev - (total[row] - c) / om[r]) * g[row]), F(0))
                t = t * fac[-1]
                dfeats[row, slots, :6] = dla @ basis[:6].T
    return dfeats


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _check_fwd(got, ref, scan):
    tol = LOGSUM_ATOL if scan == "logsum" else IMG_ATOL
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=tol)
    _check_t_out(got[1], ref[1], rtol=tol)


CASES = ["scene_l1", "scene_l2", "interleaved", "noscan_dead_end", "k384",
         "all_dead"]


@pytest.mark.parametrize("scan", list(chunked.SCANS))
@pytest.mark.parametrize("case", CASES)
def test_kernel_walk_matches_plain_forward(cases, case, scan):
    feats, t_in, chunk = cases[case]
    basis = tiles.pixel_basis(16).numpy()
    got = walk_fwd(feats, basis, t_in, scan, chunk)
    ref = [x.numpy() for x in chunked.chunked_fwd_ref(
        torch.from_numpy(feats), torch.from_numpy(basis), _t(t_in),
        scan=scan, chunk=chunk)]
    _check_fwd(got, ref, scan)
    empty = (feats[..., 5] <= DEAD_MARK).all(axis=1)
    assert (got[0][empty] == 0).all()
    t0 = np.ones((len(feats), 256), F) if t_in is None else t_in
    np.testing.assert_array_equal(got[1][empty], t0[empty])
    if case == "all_dead":
        assert empty.all()


@pytest.mark.parametrize("case", CASES)
def test_kernel_walk_matches_plain_backward(cases, case):
    feats, t_in, chunk = cases[case]
    g, prior, total = _lab_planes(15, len(feats))
    basis = tiles.pixel_basis(16).numpy()
    got = walk_bwd(feats, basis, g, t_in, prior, total)
    ref = chunked.chunked_bwd_ref(
        *(_t(x) for x in (feats, basis, g, t_in, prior, total)),
        chunk=chunk).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=GRAD_RTOL_OF_MAX * np.abs(ref).max())
    dead = feats[..., 5] <= DEAD_MARK
    assert (got[dead] == 0).all() and (ref[dead] == 0).all()
    if case == "all_dead":
        assert not ref.any()


def test_noscan_carry_moves_by_the_chunks_last_slot_by_position(cases):
    """A chunk ending on a dead slot leaves ``noscan``'s carry as it is;
    moving it by the last live slot instead misses the gate by far."""
    feats, t_in, chunk = cases["noscan_dead_end"]
    basis = tiles.pixel_basis(16).numpy()
    ref = [x.numpy() for x in chunked.chunked_fwd_ref(
        torch.from_numpy(feats), torch.from_numpy(basis), scan="noscan",
        chunk=chunk)]
    _check_fwd(walk_fwd(feats, basis, t_in, "noscan", chunk), ref, "noscan")
    wrong = walk_fwd(feats, basis, t_in, "noscan", chunk, carry="last_live")
    assert np.abs(wrong[0] - ref[0]).max() > 100 * IMG_ATOL
    assert np.abs(wrong[1] - ref[1]).max() > 1e-3
    # row 3, every slot live, cannot tell the two apart
    np.testing.assert_array_equal(wrong[0][3], walk_fwd(
        feats, basis, t_in, "noscan", chunk)[0][3])


@pytest.mark.parametrize("case", ["scene_l2", "interleaved", "k384"])
def test_kernel_walk_matches_jax_fwd_v3(cases, kernel_lab, interpret, case):
    """The model's ``v3`` and ``twolevel`` (the true cumulative product)
    against ``kernel_lab.fwd_v3``, a t_in padded to its tile_block."""
    feats, t_in, chunk = cases[case]
    basis = tiles.pixel_basis(16).numpy()
    t_pad = np.pad(t_in, ((0, (-len(feats)) % 16), (0, 0)),
                   constant_values=1.0)
    j = [np.asarray(x) for x in kernel_lab.fwd_v3(
        jnp.asarray(feats), jnp.asarray(basis), jnp.asarray(t_pad),
        chunk=chunk)]
    for scan in ("v3", "twolevel"):
        _check_fwd(walk_fwd(feats, basis, t_in, scan, chunk), j, scan)


@pytest.mark.parametrize("scan,jax_scan", [("v3", "v3"),
                                           ("noscan", "noscan"),
                                           ("logsum", "matmul")])
@pytest.mark.parametrize("case", ["scene_l1", "interleaved",
                                  "noscan_dead_end"])
def test_kernel_walk_matches_jax_cumprod_lab(cases, cumprod_lab, case, scan,
                                             jax_scan):
    """The model against ``cumprod_lab.fwd`` (transmittance 1 in)."""
    feats, _, chunk = cases[case]
    basis = tiles.pixel_basis(16).numpy()
    j = [np.asarray(x) for x in cumprod_lab.fwd(
        jnp.asarray(feats), jnp.asarray(basis), jax_scan, chunk=chunk)]
    _check_fwd(walk_fwd(feats, basis, None, scan, chunk), j, scan)


@pytest.mark.parametrize("case", ["scene_l2", "interleaved", "all_dead"])
def test_kernel_walk_matches_jax_bwd_v3(cases, kernel_lab, interpret, case):
    feats, t_in, chunk = cases[case]
    g, prior, total = _lab_planes(16, len(feats))
    basis = tiles.pixel_basis(16).numpy()
    ref = np.asarray(kernel_lab.bwd_v3(
        *(jnp.asarray(x) for x in (feats, basis, g, t_in, prior, total)),
        chunk=chunk))
    got = walk_bwd(feats, basis, g, t_in, prior, total)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=GRAD_RTOL_OF_MAX * np.abs(ref).max())
    assert (got[..., 6:] == 0).all()
