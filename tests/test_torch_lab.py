"""The port's kernel lab (edgegaussians_tpu_torch/lab/) against the JAX
lab harnesses, on the CPU: the plain versions of the chunked-scan
compositor against ``scripts/kernel_lab.py``'s ``fwd_v3`` / ``bwd_v3``
and ``scripts/cumprod_lab.py``'s ``fwd`` in Pallas interpret mode, the
lab scene against ``kernel_lab.bench_scene`` at a cut size, and the
probes' plain versions against ``scripts/segpair_mosaic_probe.py``'s
NumPy oracles.

The JAX scripts are imported by file path. ``kernel_lab`` and the probe
script call ``pl.pallas_call`` with no ``interpret=`` (they were written
for the TPU), so those tests patch it to interpret mode for their
duration; ``cumprod_lab.fwd`` picks interpret mode itself off the TPU.

Tolerances: images atol 1e-5 and ``t_out`` rtol 1e-5 where >= 1e-4
(both sides take the same f32 steps; a matmul and a roll scan order the
sums and products otherwise); ``logsum`` 5e-5 (a log-space sum rounds
differently from a product); dfeats 1e-4 of the JAX max-abs (the suffix
``(total - c_inc) / (1 - alpha)`` carries the running sums' last-bit
differences, up to 1000x at alpha near 0.999).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from edgegaussians_tpu_torch.lab import chunked, probes, scene
from edgegaussians_tpu_torch.ops import raster_v2, tiles

from test_torch_kernels import _onehot_in_order, _onehot_inputs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, K, CHUNK = 20, 256, 128     # 20 rows pad to 32 at the JAX tile_block 16
IMG_ATOL = 1e-5
LOGSUM_ATOL = 5e-5
GRAD_RTOL_OF_MAX = 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_lab_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kernel_lab():
    return _script("kernel_lab")


@pytest.fixture(scope="module")
def cumprod_lab():
    return _script("cumprod_lab")


@pytest.fixture
def interpret(monkeypatch):
    """Run the scripts' TPU-only pallas_calls in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _frame(seed=0, t=T, k=K):
    """A dense frame [t,k,8] (tests/test_pallas_raster.py's features):
    rows from empty to full, the -1e30 constant past each row's count and
    on ~10% of the slots below it; a carried transmittance with a row
    saturated on entry; a cotangent, a prior and a total."""
    r = np.random.default_rng(seed)
    a = r.uniform(0.05, 0.8, (t, k))
    c = r.uniform(0.05, 0.8, (t, k))
    b = r.uniform(-0.1, 0.1, (t, k)) * np.sqrt(a * c)
    mx, my = r.uniform(-4.0, 20.0, (2, t, k))
    logop = np.log(r.uniform(0.05, 0.95, (t, k)))
    counts = np.resize(np.asarray([0, 3, 64, 128, 130, 200, 256, 256]), t)
    valid = np.arange(k)[None, :] < counts[:, None]
    valid &= r.uniform(0, 1, (t, k)) < 0.9
    amx_bmy = a * mx + b * my
    bmx_cmy = b * mx + c * my
    const = -0.5 * (amx_bmy * mx + bmx_cmy * my) + logop
    const = np.where(valid, const, -1e30)
    feats = np.stack([-0.5 * a, -b, -0.5 * c, amx_bmy, bmx_cmy, const,
                      logop, np.zeros_like(a)], axis=-1).astype(np.float32)
    t_in = r.uniform(0.2, 1.0, (t, 256)).astype(np.float32)
    t_in[1] = 5e-5
    planes = [r.uniform(lo, hi, (t, 256)).astype(np.float32)
              for lo, hi in ((-1, 1), (0, 0.3), (0.3, 1.0))]
    return (feats, t_in, *planes)   # feats, t_in, g, prior, total


def _basis():
    return tiles.pixel_basis(16)


def _check_t_out(got, ref, rtol=1e-5):
    live = ref >= 1e-4
    np.testing.assert_allclose(got[live], ref[live], rtol=rtol, atol=0)
    assert (got[~live] < 1e-4).all()


def _fwd_both(scan, t_in=True, seed=0):
    """(port img, t_out), (JAX img, t_out) on one frame; ``t_in`` False
    enters with transmittance 1 (cumprod_lab.fwd takes no t_in)."""
    feats, tin = _frame(seed)[:2]
    tin_t = torch.from_numpy(tin) if t_in else None
    got = chunked.chunked_fwd_ref(torch.from_numpy(feats), _basis(), tin_t,
                                  scan=scan, chunk=CHUNK)
    return [x.numpy() for x in got], feats, tin


@pytest.mark.parametrize("t_in", [False, True], ids=["t_in_1", "t_in"])
def test_chunked_fwd_ref_matches_kernel_lab_fwd_v3(kernel_lab, interpret,
                                                    t_in):
    (img, t_out), feats, tin = _fwd_both("v3", t_in)
    basis = jnp.asarray(_basis().numpy())
    # the JAX wrapper pads the rows to its tile_block but not a given t_in
    tin_p = np.pad(tin, ((0, 32 - T), (0, 0)), constant_values=1.0)
    j_img, j_out = kernel_lab.fwd_v3(jnp.asarray(feats), basis,
                                     jnp.asarray(tin_p) if t_in else None,
                                     chunk=CHUNK)
    np.testing.assert_allclose(img, np.asarray(j_img), rtol=0,
                               atol=IMG_ATOL)
    _check_t_out(t_out, np.asarray(j_out))


@pytest.mark.parametrize("scan,jax_scan,atol", [
    ("v3", "v3", IMG_ATOL),
    ("noscan", "noscan", IMG_ATOL),
    ("logsum", "matmul", LOGSUM_ATOL),
])
def test_chunked_fwd_ref_matches_cumprod_lab(cumprod_lab, scan, jax_scan,
                                             atol):
    (img, t_out), feats, _ = _fwd_both(scan, t_in=False)
    j_img, j_out = cumprod_lab.fwd(jnp.asarray(feats),
                                   jnp.asarray(_basis().numpy()), jax_scan,
                                   chunk=CHUNK)
    np.testing.assert_allclose(img, np.asarray(j_img), rtol=0, atol=atol)
    _check_t_out(t_out, np.asarray(j_out), rtol=atol)


def test_chunked_bwd_ref_matches_kernel_lab_bwd_v3(kernel_lab, interpret):
    feats, tin, g, prior, total = _frame(1)
    got = chunked.chunked_bwd_ref(
        *(torch.from_numpy(x) for x in (feats,)), _basis(),
        *(torch.from_numpy(x) for x in (g, tin, prior, total)), chunk=CHUNK)
    ref = np.asarray(kernel_lab.bwd_v3(
        jnp.asarray(feats), jnp.asarray(_basis().numpy()),
        *(jnp.asarray(x) for x in (g, tin, prior, total)), chunk=CHUNK))
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=GRAD_RTOL_OF_MAX * scale)
    assert (got.numpy()[..., 6:] == 0).all()


def test_chunked_twolevel_equals_v3():
    """The port's two-level scan is the true cumulative product."""
    (img, t_out), _, _ = _fwd_both("twolevel", seed=2)
    (img3, t_out3), _, _ = _fwd_both("v3", seed=2)
    np.testing.assert_allclose(img, img3, rtol=0, atol=IMG_ATOL)
    _check_t_out(t_out, t_out3)


def test_jax_scan_twolevel_is_the_in_group_product(cumprod_lab):
    """Pins what the JAX ``_scan_twolevel`` computes (a deliberate
    divergence of the port): the cumulative product inside each group of
    8 only, far from the cumulative product over the chunk."""
    om = np.random.default_rng(3).uniform(0.5, 1.0, (1, 128, 4)).astype(
        np.float32)

    def kernel(x_ref, o_ref):
        o_ref[:] = cumprod_lab._scan_twolevel(x_ref[:], 128)

    out = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(om.shape, jnp.float32),
        interpret=True)(jnp.asarray(om)))
    in_group = np.cumprod(om.reshape(1, 16, 8, 4), axis=2).reshape(om.shape)
    np.testing.assert_allclose(out, in_group, rtol=1e-6)
    assert not np.allclose(out, np.cumprod(om, axis=1), rtol=1e-3)
    port = chunked.scan_transmittance(torch.from_numpy(om), "twolevel")
    np.testing.assert_allclose(port.numpy(), np.cumprod(om, axis=1),
                               rtol=1e-5)


def test_chunked_fwd_v3_matches_raster_v2_plain():
    """V3 computes raster_v2's forward (the lab's V0) on a frame whose
    dead slots carry the -1e30 constant."""
    feats, tin = _frame(4)[:2]
    counts = torch.full((T,), K, dtype=torch.int32)
    img, t_out = chunked.chunked_fwd_ref(torch.from_numpy(feats), _basis(),
                                         torch.from_numpy(tin))
    img0, t_out0 = raster_v2.composite_fwd_seg_ref(
        torch.from_numpy(feats), counts, _basis(), torch.from_numpy(tin))
    np.testing.assert_allclose(img.numpy(), img0.numpy(), rtol=0,
                               atol=IMG_ATOL)
    _check_t_out(t_out.numpy(), t_out0.numpy())


@pytest.mark.parametrize("k,chunk,scan", [(256, 96, "v3"), (64, 128, "v3"),
                                          (200, 100, "twolevel"),
                                          (128, 128, "cumsum")])
def test_chunk_refusals(k, chunk, scan):
    """K % chunk != 0 raises (the JAX lab drops the rest); ``chunk`` is
    ``min(chunk, K)`` first, as in JAX; the two-level scan needs whole
    groups of 8; an unknown scan raises."""
    feats = torch.from_numpy(_frame(5, t=2, k=k)[0])
    if k == 64:   # min(128, 64) = 64 tiles K: accepted, as in JAX
        img, _ = chunked.chunked_fwd(feats, _basis(), scan=scan, chunk=chunk)
        assert img.shape == (2, 256)
        return
    with pytest.raises(ValueError):
        chunked.chunked_fwd(feats, _basis(), scan=scan, chunk=chunk)
    if scan == "v3":
        with pytest.raises(ValueError, match="chunks of"):
            chunked.chunked_bwd(feats, _basis(), torch.ones(2, 256), None,
                                None, torch.ones(2, 256), chunk=chunk)


def test_lab_scene_matches_kernel_lab_bench_scene(kernel_lab, monkeypatch):
    """The lab scene at a cut size (2000 Gaussians, 128x128, k1 16, k2 32,
    t2 8) against kernel_lab.bench_scene with its globals cut alike: the
    counts exactly, the dead slots' -1e30 constant exactly, the live
    features within f32 rounding of the two projections."""
    cut = dict(N=2000, W=128, H=128, K1=16, K2=32, T2=8)
    for name, value in cut.items():
        monkeypatch.setattr(kernel_lab, name, value)
    j_feats, j_counts, j_basis = (np.asarray(x)
                                  for x in kernel_lab.bench_scene())
    sc = scene.bench_scene(n=2000, width=128, height=128, k1=16, k2=32, t2=8)
    np.testing.assert_array_equal(sc.counts1.numpy(), j_counts)
    assert sc.feats1.shape == j_feats.shape
    assert int(sc.counts1.sum()) > 100 and int(sc.counts2.sum()) > 0
    feats = sc.feats1.numpy()
    dead = j_feats[..., 5] == np.float32(-1e30)
    np.testing.assert_array_equal(feats[..., 5] == np.float32(-1e30), dead)
    live = ~dead
    scale = np.abs(j_feats[live][:, :5]).max(axis=0)
    np.testing.assert_allclose(feats[live][:, :5], j_feats[live][:, :5],
                               rtol=1e-4, atol=1e-5 * scale.max())
    np.testing.assert_allclose(feats[live][:, 5:7], j_feats[live][:, 5:7],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(sc.basis.numpy(), j_basis)
    # level 2: the busiest tiles' slots past k1
    assert sc.feats2.shape == (8, 32, 8)
    assert (sc.counts1[sc.rows2][sc.counts2 > 0] == 16).all()


@pytest.mark.parametrize("name", list(probes.CASES))
def test_probe_plain_versions_match_the_oracles(name):
    out, err, tol = probes.run_case(name, torch.device("cpu"))
    assert err <= tol, (name, err)
    # a CPU tensor takes the plain version: the same result
    out_ref, _, _ = probes.run_case(name, torch.device("cpu"), plain=True)
    assert torch.equal(out, out_ref)


def test_jax_probes_run_exactly_in_interpret_mode(interpret):
    """The script's own probes in interpret mode: every oracle error 0
    (the one-hot product within the port's tolerance), so the oracles the
    port copies hold for the JAX kernels too."""
    mod = _script("segpair_mosaic_probe")
    runs = {
        "P1": mod.probe_roll(0, (128, 256)),
        "P2": mod.probe_roll(1, (256, 128)),
        "P3": mod.probe_onehot(),
        "P4": mod.probe_dyn_write(),
        "P5": mod.probe_dyn_read(),
        "P6": mod.probe_transpose(),
        "P7a": mod.probe_vmem_dyn(False),
        "P7b": mod.probe_vmem_dyn(True),
    }
    for label, go in runs.items():
        err = go()
        assert err <= (probes.ONEHOT_ATOL if label == "P3" else 0.0), \
            (label, err)


@pytest.mark.parametrize("j,cols", [(128, 256), (97, 12), (300, 8),
                                    (33, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_onehot_product_is_a_segment_sum(j, cols, seed):
    """The algebra the onehot kernel relies on: onehot(seg[0]) @ c equals
    the sum, per output row, of the rows of c whose id equals its index,
    added in ascending j (the terms a one-hot product adds beside them are
    exact zeros); ids outside [0, J) and non-integer ids match no row.
    Against the plain version within the oracle's tolerance (a product
    orders its sums its own way), and bit for bit against an in-order sum
    in NumPy."""
    seg, c = _onehot_inputs(j, cols, seed)
    got = _onehot_in_order(torch.from_numpy(seg), torch.from_numpy(c))
    ref = probes.probe_onehot_ref(torch.from_numpy(seg), torch.from_numpy(c))
    torch.testing.assert_close(got, ref, rtol=0, atol=probes.ONEHOT_ATOL)
    in_order = np.zeros_like(c)
    for k, i in enumerate(seg[0]):
        if i == np.floor(i) and 0 <= i < j:
            in_order[int(i)] += c[k]
    np.testing.assert_array_equal(got.numpy(), in_order)
    named = set(int(i) for i in seg[0] if i == np.floor(i) and 0 <= i < j)
    assert named and len(named) < j     # some rows get sums, others stay 0
    assert (got.numpy()[sorted(set(range(j)) - named)] == 0).all()


def test_probe_windows_out_of_range_and_overlapping():
    """Windows that do not fit are skipped; of two overlapping writes the
    later one wins, as on the TPU's in-order grid."""
    offs = torch.tensor([40, 60, 500], dtype=torch.int32)
    out = probes.probe_dyn_write(offs, 256, 8, 128)
    assert (out[40:60, 0] == 1 + torch.arange(20.0)).all()
    assert (out[60:188, 0] == 2 + torch.arange(128.0)).all()
    assert (out[188:] == 0).all() and (out[:40] == 0).all()
    src = torch.arange(512 * 4, dtype=torch.float32).reshape(512, 4)
    read = probes.probe_dyn_read(src, torch.tensor([0, 400],
                                                   dtype=torch.int32))
    assert torch.equal(read[:128], 2 * src[:128])
    assert (read[128:] == 0).all()


def test_chunked_kernels_need_a_cuda_or_cpu_tensor():
    feats = torch.from_numpy(_frame(6, t=2, k=128)[0]).to("meta")
    with pytest.raises(ValueError, match="no lab kernel"):
        chunked.chunked_fwd(feats, _basis().to("meta"))
    with pytest.raises(ValueError, match="no roll kernel"):
        probes.probe_roll(torch.zeros(4, 4, device="meta"))


def test_lab_drivers_run_the_plain_versions_on_the_cpu():
    """The kernel-lab and cumprod-lab drivers on a CPU scene cut to 2000
    Gaussians at 128x128 (k1 32, k2 64, t2 8): their gates hold, nothing
    is timed."""
    from edgegaussians_tpu_torch.lab import harness
    cpu = torch.device("cpu")
    sc = scene.bench_scene(n=2000, width=128, height=128, k1=32, k2=64,
                           t2=8)
    out = harness.kernel_lab(sc, cpu)
    assert out["fwd_err"] <= IMG_ATOL and out["t_out_rel"] <= 1e-5
    assert out["bwd_rel"] <= GRAD_RTOL_OF_MAX
    assert set(out["ms"].values()) == {None}
    out = harness.cumprod_lab(sc, cpu)
    assert out["err_vs_v3"]["twolevel"] <= IMG_ATOL
    assert out["err_vs_v3"]["logsum"] <= LOGSUM_ATOL
    assert out["err_vs_v3"]["noscan"] > 0.1     # wrong by design


@pytest.mark.parametrize("name", ["torch_kernel_lab", "torch_cumprod_lab",
                                  "torch_segpair_probe"])
def test_lab_entry_points_need_the_card_or_ask_for_the_cpu(name):
    """Each lab script runs on the card by default and raises where torch
    sees no GPU; the probe script's ``--device cpu`` runs the plain
    versions against the oracles."""
    mod = _script(name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main([])
    if name == "torch_segpair_probe":
        out = mod.main(["--device", "cpu"])
        assert set(out) == set(probes.CASES)
        assert all(err <= probes.ONEHOT_ATOL for err in out.values())
