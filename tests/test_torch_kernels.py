"""The Hopper kernels of the port (edgegaussians_tpu_torch/csrc/segpair.cu,
csrc/raster_v2.cu, csrc/knn.cu, csrc/pair.cu, csrc/raster_v1.cu,
csrc/shard_sum.cu, csrc/rank_sum.cu, and the kernel lab's
csrc/lab_chunked.cu and csrc/lab_probes.cu) held to their plain PyTorch
versions, on a GPU.

Every test here needs the card and skips where torch sees none. The file
imports no JAX (the machine with the card has none), so it runs there
without the JAX-side conftest:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

Tolerances: image atol 1e-5 (both sides take the same f32 steps; only
the order of the log-alpha sum and of the transmittance products
differs); per-pair and per-slot dfeats 1e-5 of the plain version's
max-abs (the seg and dense backwards sum their 256 pixels as 3xTF32
tensor-core products and 8 warp partials, the plain versions as an f32
matmul); the
dense kernels' t_out where the plain value is >= 1e-4 rtol 1e-5, and
below 1e-4 on both sides elsewhere (its value there depends on the
implementation, ops/raster_v2.py); whole-rasterizer gradients atol 3e-4,
rtol 2e-3 (tests/test_pallas_segpair.py's seg tolerances; the pair rows
reach [N,8] through the row sum, in the CPU path's order, so the sides
differ by the compositor kernels' last bits). The kNN kernel and its plain
version round every product and sum of d^2 alike and share the tie rule,
so they agree exactly, whatever the key slices and the live-key
compaction of the kernel. The fired view step: parameters rtol 1e-4 and
moments rtol 5e-3, both with atol 1e-6 of the group's max-abs
(tests/test_torch_orientation.py's tolerances and projection weight).
The v4 pair and v1 kernels: image atol 1e-5, dfeats 1e-4 of the plain
version's max-abs (their suffix ``(total - c_inc) / (1 - alpha)`` carries
the running sums' last-bit differences, up to 1000x at alpha near 0.999).
The shard-sum probe: rtol 1e-5 of a float64 sum (uniform draws, so no
cancellation; the kernel's per-thread sums and tree add in another order
than the plain version), the same bits on a second launch, the bits of
tests/test_torch_probe_order.py's model of its order (also across calls
of other row counts and on a second stream), one kernel a call after the
first. Band mode on
the seg path: GPU against CPU with the whole-rasterizer tolerances.
The lab's chunked-scan kernels: image atol 1e-5 and t_out rtol 1e-5 where
>= 1e-4 (5e-5 for the log-space ``logsum`` form, whose sums run in another
order than the plain cumsum), dfeats 1e-4 of the plain version's max-abs;
the probes exactly equal to their plain versions and oracles (the one-hot
sum within 1e-5); the one-launch dyn_write / dyn_read / vmem_dyn (read
and rmw) kernels exactly equal on random windows and over poisoned
allocations, one device kernel per call; the roll and transpose
kernels bit for bit their plain versions on random shapes and shifts,
aligned and misaligned, on two launches, over poisoned allocations, one
device kernel a call; the owner-computes onehot
kernel bit for bit the in-order sum of its rows (the one-hot product
adds exact zeros beside the same terms) on random ids, one device kernel
per call. The seg forward: image atol
1e-5 on runs around its 16-pair groups and 128-pair batches and on stops
at their edges, the same bits from two launches. The dense kernels at K =
16, 48, 128 and 640, with and without t_in: the image, t_out and dfeats
gates above on counts around their groups and batches, past K and
negative, on stops at group and batch edges and on rows saturated on
entry; exact zeros, t_out = t_in and the same bits from two launches
where the kernels' contract says so. The v4 pair kernels on runs around
their groups and batches, empty runs, pads of real features after every
run, stops on group and batch edges and a misaligned feats: the image and
dfeats gates above, the rows past a stop exactly zero, the same bits from
two launches. The row sum of the compositors' backwards (rank_sum): the
CPU plain version's bits exactly (both add each output's rows in row
order), also on one key of 5000 rows, runs of ~130, one output, every
row dropped and no rows, and across calls whose n and row count grow and
shrink; the same bits from two launches; at most 4 kernel launches a
call and no fill or copy; and within 1e-5 of max-abs of the plain
version on the card (index_add_ atomics); two backward passes
of the seg, v4 pair and two-level renders give the same dpacked and dsink
bits. The row sum as the backward of ``gather_rows`` (rank_sum_gather):
the CPU's bits on skewed int64 indices whose rows are mostly zeros, and
on all-zero and NaN rows (NaN outputs as NaN: the card's adds give the
canonical NaN), and
within 1e-5 of max-abs of autograd's backward of ``x[idx]`` on the card. Every one-kernel-a-call check counts the host's launch records
(_check_one_kernel_per_call).
"""

import numpy as np
import pytest
import torch

from edgegaussians_tpu_torch.lab import chunked, probes
from edgegaussians_tpu_torch.lab import scene as lab_scene
from edgegaussians_tpu_torch.ops import knn as knn_mod
from edgegaussians_tpu_torch.ops import (
    pair, raster_v1, raster_v2, segpair, shard_sum, tiles)
from edgegaussians_tpu_torch.ops.projection import project_gaussians
from edgegaussians_tpu_torch.ops.rasterize import rasterize

from test_torch_probe_order import shard_sum_order

pytestmark = pytest.mark.cuda

W, H = 64, 48


def _scene(seed=0, n=300, spread=0.5, depth=(2.0, 2.0), f=55.0,
           log_scales=(0.01, 0.06)):
    r = np.random.default_rng(seed)
    means = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    means[:, 2] = r.uniform(*depth, n)
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(log_scales[0]), np.log(log_scales[1]),
                              (n, 3))).astype(np.float32)
    opac = r.uniform(0.05, 0.9, n).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return means, quats, scales, opac, np.eye(4, dtype=np.float32), K


SCENES = {
    "scene": (dict(), 256, 2048),
    # one hot spot: runs of ~400 pairs cross the kernels' pair batches
    "cluster": (dict(seed=2, n=400, spread=0.02, depth=(2.0, 3.0),
                     log_scales=(0.01, 0.04)), 512, 2048),
    # budget below the pair count: zero-kept rows, truncated runs
    "overflow": (dict(seed=3), 256, 200),
    # every Gaussian behind the camera: no pairs at all
    "empty": (dict(seed=4, depth=(-3.0, -2.0)), 256, 512),
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU for the Hopper kernels")
    return torch.device("cuda")


def _inputs(name, device):
    kw, cap, budget = SCENES[name]
    arrays = [torch.from_numpy(a).to(device) for a in _scene(**kw)]
    with torch.no_grad():
        proj = project_gaussians(*arrays, W, H)
        pb = tiles.bin_pairs_frame_order(proj, W, H, 16, cap, budget)
        packed = tiles.pack_gaussian_render_data(proj)[pb.order]
        src, ox, oy = segpair.pair_inputs(
            packed, pb, tiles.tile_origins(W, H, 16, device=device))
        feats = segpair.build_pair_features(src, ox, oy).contiguous()
    return (feats, pb.s_f.to(torch.int32), tiles.pixel_basis(16, device=device),
            pb)


@pytest.mark.parametrize("name", list(SCENES))
def test_kernels_match_plain_versions(device, name):
    feats, s_f, basis, pb = _inputs(name, device)
    T = s_f.shape[0] - 1
    gen = torch.Generator(device=device).manual_seed(0)
    gt = torch.rand((T, 256), generator=gen, device=device)
    img_k = segpair.segpair_fwd(feats, s_f, basis)
    img_again = segpair.segpair_fwd(feats, s_f, basis)
    dfe_k = segpair.segpair_bwd(feats, s_f, basis, gt)
    torch.cuda.synchronize()
    assert torch.equal(img_k, img_again)     # no atomics in the image
    img_r = segpair.segpair_fwd_ref(feats, s_f, basis)
    dfe_r = segpair.segpair_bwd_ref(feats, s_f, basis, gt)
    torch.testing.assert_close(img_k, img_r, rtol=0, atol=1e-5)
    kept = int(s_f[-1])
    scale = float(dfe_r.abs().max()) if kept else 0.0
    torch.testing.assert_close(dfe_k[:kept], dfe_r[:kept], rtol=0,
                               atol=1e-5 * scale)
    assert torch.all(dfe_k[:kept, 6:] == 0)
    if name == "empty":
        assert kept == 0 and torch.all(img_k == 0)
    if name == "cluster":
        assert int(pb.counts_f.max()) > 256
    if name == "overflow":
        assert int(pb.num_pairs) > 200


def test_each_wrapper_counts_its_launches(device):
    feats, s_f, basis, _ = _inputs("scene", device)
    gt = torch.zeros((s_f.shape[0] - 1, 256), device=device)
    before = dict(segpair.launch_counts)
    segpair.segpair_fwd(feats, s_f, basis)
    segpair.segpair_fwd(feats, s_f, basis)
    segpair.segpair_bwd(feats, s_f, basis, gt)
    assert segpair.launch_counts["segpair_fwd"] == before["segpair_fwd"] + 2
    assert segpair.launch_counts["segpair_bwd"] == before["segpair_bwd"] + 1
    # the plain versions on CPU tensors launch nothing
    segpair.segpair_fwd(feats.cpu(), s_f.cpu(), basis.cpu())
    assert segpair.launch_counts["segpair_fwd"] == before["segpair_fwd"] + 2


def test_wrappers_reject_inputs_the_kernels_do_not_take(device):
    feats, s_f, basis, _ = _inputs("scene", device)
    T = s_f.shape[0] - 1
    with pytest.raises(TypeError):
        segpair.segpair_fwd(feats.double(), s_f, basis)
    with pytest.raises(TypeError):
        segpair.segpair_fwd(feats, s_f.long(), basis)
    with pytest.raises(ValueError):
        segpair.segpair_fwd(feats, s_f.cpu(), basis)
    with pytest.raises(ValueError):
        segpair.segpair_fwd(feats, s_f, basis[:, :128].contiguous())
    with pytest.raises(ValueError):
        segpair.segpair_fwd(feats.t().contiguous().t(), s_f, basis)
    with pytest.raises(ValueError):
        segpair.segpair_bwd(feats, s_f, basis,
                            torch.zeros((T + 1, 256), device=device))


@pytest.mark.parametrize("name", ["scene", "cluster", "overflow"])
def test_rasterize_on_gpu_matches_cpu_path(device, name):
    kw, cap, budget = SCENES[name]
    arrays = _scene(**kw)

    def grads(dev):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        params = [x.requires_grad_() for x in t[:4]]
        sink = torch.zeros((t[0].shape[0], 2), device=dev,
                           requires_grad=True)
        out = rasterize(*params, t[4], t[5], W, H, capacity=cap,
                        pair_budget=budget, pair_kernel="seg",
                        absgrad_sink=sink)
        img = torch.clamp(out.image, 0, 1)
        w = (torch.arange(img.numel(), device=dev, dtype=torch.float32)
             .reshape(img.shape) % 7) / 7.0 + 0.3
        g = torch.autograd.grad((img * w).sum(), params + [sink])
        return [out.image.detach().cpu()] + [x.cpu() for x in g]

    names = ("image", "means", "quats", "scales", "opacities", "absgrad")
    for nm, a, b in zip(names, grads(device), grads(torch.device("cpu"))):
        assert torch.isfinite(a).all(), nm
        if nm == "image":
            torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
        else:
            torch.testing.assert_close(a, b, rtol=2e-3, atol=3e-4, msg=nm)


def _random_frame(seed, t=16, k=256, counts=(0, 3, 64, 128, 130, 200, 256,
                                              256)):
    """Synthetic dense frame [t,k,8] (tests/test_pallas_raster.py's
    features): counts from empty rows to full ones, a -1e30 constant past
    each count and on ~10% of the slots below it, a carried transmittance
    with rows saturated on entry, and a cotangent."""
    r = np.random.default_rng(seed)
    a = r.uniform(0.05, 0.8, (t, k))
    c = r.uniform(0.05, 0.8, (t, k))
    b = r.uniform(-0.1, 0.1, (t, k)) * np.sqrt(a * c)
    mx, my = r.uniform(-4.0, 20.0, (2, t, k))
    logop = np.log(r.uniform(0.05, 0.95, (t, k)))
    counts = np.resize(np.asarray(counts), t)
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
    t_in[7, :128] = 2e-4
    g = r.uniform(-1, 1, (t, 256)).astype(np.float32)
    return feats, counts.astype(np.int32), t_in, g


FRAMES = {
    # level-1 shape: transmittance 1 in, rows up to k
    "level1": dict(seed=0, t=40, k=128, counts=(0, 5, 60, 128, 127, 90)),
    # level-2 shape: long rows cross both kernels' staging batches, a
    # carried t_in, counts past k (the walk stops at k)
    "level2": dict(seed=1, t=24, k=640, counts=(640, 0, 700, 300, 129, 640,
                                                 257, 520)),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_raster_v2_kernels_match_plain_versions(device, name):
    feats, counts, t_in, g = (torch.from_numpy(x).to(device)
                              for x in _random_frame(**FRAMES[name]))
    if name == "level1":
        t_in = None
    basis = tiles.pixel_basis(16, device=device)
    img_k, tout_k = raster_v2.composite_fwd_seg(feats, counts, basis, t_in)
    torch.cuda.synchronize()
    img_r, tout_r = raster_v2.composite_fwd_seg_ref(feats, counts, basis,
                                                    t_in)
    torch.testing.assert_close(img_k, img_r, rtol=0, atol=1e-5)
    live = tout_r >= 1e-4
    torch.testing.assert_close(tout_k[live], tout_r[live], rtol=1e-5,
                               atol=1e-7)
    assert bool((tout_k[~live] < 1e-4).all())
    if t_in is not None:                    # rows saturated on entry
        assert bool((~live).any())

    total = torch.clamp(img_r + 0.1, max=1.0)
    d_k = raster_v2.composite_bwd_seg(feats, counts, basis, g, t_in, total)
    torch.cuda.synchronize()
    d_r = raster_v2.composite_bwd_seg_ref(feats, counts, basis, g, t_in,
                                          total)
    scale = float(d_r.abs().max())
    assert scale > 0
    torch.testing.assert_close(d_k, d_r, rtol=0, atol=1e-5 * scale)
    past = (torch.arange(feats.shape[1], device=device)[None, :]
            >= counts[:, None])
    assert bool((d_k[past] == 0).all()) and bool((d_k[..., 6:] == 0).all())


def test_raster_v2_wrappers_count_launches_and_check_inputs(device):
    feats, counts, t_in, g = (torch.from_numpy(x).to(device)
                              for x in _random_frame(2, t=8, k=128))
    basis = tiles.pixel_basis(16, device=device)
    before = dict(raster_v2.launch_counts)
    img, _ = raster_v2.composite_fwd_seg(feats, counts, basis, t_in)
    raster_v2.composite_fwd(feats, counts, basis)
    raster_v2.composite_bwd_seg(feats, counts, basis, g, t_in, img)
    assert raster_v2.launch_counts["raster_v2_fwd"] == \
        before["raster_v2_fwd"] + 2
    assert raster_v2.launch_counts["raster_v2_bwd"] == \
        before["raster_v2_bwd"] + 1
    raster_v2.composite_fwd_seg(feats.cpu(), counts.cpu(), basis.cpu())
    assert raster_v2.launch_counts["raster_v2_fwd"] == \
        before["raster_v2_fwd"] + 2
    with pytest.raises(TypeError):
        raster_v2.composite_fwd_seg(feats.double(), counts, basis)
    with pytest.raises(TypeError):
        raster_v2.composite_fwd_seg(feats, counts.long(), basis)
    with pytest.raises(ValueError):
        raster_v2.composite_fwd_seg(feats, counts.cpu(), basis)
    with pytest.raises(ValueError):
        raster_v2.composite_fwd_seg(feats, counts, basis, t_in[:4])
    with pytest.raises(ValueError):
        raster_v2.composite_fwd_seg(feats[:, ::2], counts, basis)


@pytest.mark.parametrize("kw", [
    dict(capacity=64, dense_capacity=16, overflow_tiles=3,
         occupancy_sort=True),
    dict(capacity=64, dense_capacity=16, overflow_tiles=4),
    dict(capacity=48)], ids=["two_level_occ", "two_level", "single"])
def test_dense_rasterize_on_gpu_matches_cpu_path(device, kw):
    arrays = _scene(**SCENES["cluster"][0])

    def grads(dev):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        params = [x.requires_grad_() for x in t[:4]]
        sink = torch.zeros((t[0].shape[0], 2), device=dev,
                           requires_grad=True)
        out = rasterize(*params, t[4], t[5], W, H, pair_budget=0,
                        absgrad_sink=sink, **kw)
        img = torch.clamp(out.image, 0, 1)
        w = (torch.arange(img.numel(), device=dev, dtype=torch.float32)
             .reshape(img.shape) % 7) / 7.0 + 0.3
        g = torch.autograd.grad((img * w).sum(), params + [sink])
        return [out.image.detach().cpu()] + [x.cpu() for x in g]

    before = dict(raster_v2.launch_counts)
    on_gpu = grads(device)
    levels = 2 if "dense_capacity" in kw else 1
    for name in ("raster_v2_fwd", "raster_v2_bwd"):
        assert raster_v2.launch_counts[name] == before[name] + levels
    names = ("image", "means", "quats", "scales", "opacities", "absgrad")
    for nm, a, b in zip(names, on_gpu, grads(torch.device("cpu"))):
        assert torch.isfinite(a).all(), nm
        if nm == "image":
            torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
        else:
            torch.testing.assert_close(a, b, rtol=2e-3, atol=3e-4, msg=nm)


@pytest.mark.parametrize("n", [257, 4099, 16384])
@pytest.mark.parametrize("k", [6, 11, 15])
def test_knn_kernel_matches_plain_version(device, n, k):
    """Dead rows (every 4th, and a tail past 3/4 of the rows, as a
    fixed-capacity state has), NaN rows and duplicate rows (ties)."""
    r = np.random.default_rng(n + k)
    pts = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[1::50] = pts[::50][: len(pts[1::50])]          # exact duplicates
    pts[7, 1] = np.nan
    mask = np.ones(n, bool)
    mask[::4] = False
    mask[3 * n // 4:] = False
    p, m = torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)
    before = knn_mod.launch_counts["knn"]
    d_k, i_k = knn_mod.knn(p, k, mask=m)
    torch.cuda.synchronize()
    assert knn_mod.launch_counts["knn"] == before + 1
    d_r, i_r = knn_mod.knn_ref(p, k, mask=m)
    assert torch.equal(i_k, i_r)
    assert torch.equal(d_k, d_r)
    assert bool(m[i_k].all())
    assert not bool((i_k == torch.arange(n, device=device)[:, None]).any())


def test_knn_kernel_dry_slots_and_input_checks(device):
    pts = torch.rand((40, 3), device=device)
    mask = torch.zeros(40, dtype=torch.bool, device=device)
    mask[[2, 9, 33]] = True
    d, i = knn_mod.knn(pts, 6, mask=mask)
    torch.cuda.synchronize()
    d_r, i_r = knn_mod.knn_ref(pts, 6, mask=mask)
    assert torch.equal(d, d_r) and torch.equal(i, i_r)
    # live rows find 2 neighbours, dead rows 3; the rest are dry
    assert bool((d[mask, 2:] == knn_mod.F32_MAX).all())
    assert bool((i[mask, 2:] == 0).all())
    assert bool((d[~mask, :3] < 2).all()) and bool((d[~mask, 3:] ==
                                                     knn_mod.F32_MAX).all())
    with pytest.raises(ValueError):
        knn_mod.knn(pts, 17)
    with pytest.raises(TypeError):
        knn_mod.knn(pts.double(), 6)
    with pytest.raises(TypeError):
        knn_mod.knn(pts, 6, mask=mask.int())
    with pytest.raises(ValueError):
        knn_mod.knn(pts, 6, mask=mask.cpu())
    with pytest.raises(ValueError):
        knn_mod.knn(pts.t().contiguous().t(), 6)


def test_fired_view_step_on_gpu_matches_cpu(device):
    """One view step at render 5 with both orientation branches firing:
    the segpair and knn kernels launch once each, and the state matches
    the CPU path's."""
    from edgegaussians_tpu_torch.config import config_from_dict
    from edgegaussians_tpu_torch.models.gaussians import GROUPS
    from edgegaussians_tpu_torch.train import optim, trainer
    cfg = config_from_dict({
        "model": {"init_min_num_gaussians": 300, "max_num_gaussians": 384,
                  "init_scales_val": 0.03, "init_opacity_val": 0.3,
                  "tile_gaussian_capacity": 256, "tile_pair_budget": 4096,
                  "tile_pair_kernel": "seg"},
        "training": {"loss": {
            "orientation_losses": {"start_dir_loss_at_epoch": -1,
                                   "start_ratio_loss_at_epoch": -1,
                                   "dir_loss_num_nn": 5},
            "projection_losses": {"lambda_start": 1e-6,
                                  "lambda_end": 1e-6}}}})
    means, *_ = _scene(seed=5, n=300)
    r = np.random.default_rng(6)
    image = (r.uniform(size=(1, H, W)) > 0.85).astype(np.float32)
    states = {}
    for dev in (device, torch.device("cpu")):
        state = trainer.init_train_state(means, cfg, device=dev)
        state.step = 4
        images = torch.from_numpy(image).to(dev)
        vms = torch.eye(4, device=dev)[None]
        Ks = torch.tensor([[[55.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]]],
                          device=dev)
        before = (segpair.launch_counts["segpair_fwd"],
                  knn_mod.launch_counts["knn"])
        trainer.view_step(
            state, 0, images, images >= 0.5, vms, Ks,
            proj_grad=trainer.make_proj_grad_fn(cfg, W, H),
            lrs=optim.all_lrs(cfg.training.optim, 60), lambda_proj=1e-6,
            bg_ratio=1.0, strategy_idx=0,
            run_sum=torch.zeros((), device=dev),
            ol_cfg=cfg.training.loss.orientation_losses, apply_dir=True,
            apply_ratio=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (segpair.launch_counts["segpair_fwd"],
                    knn_mod.launch_counts["knn"]) == (before[0] + 1,
                                                      before[1] + 1)
        states[dev.type] = state
    gpu, cpu = states["cuda"], states["cpu"]
    assert gpu.opt.counts == cpu.opt.counts == {
        "means": 3, "scales": 3, "quats": 3, "opacities": 1}
    for g in GROUPS:
        for what, a, b in (("param", getattr(gpu.model, g),
                            getattr(cpu.model, g)),
                           ("mu", gpu.opt.moments[g][0],
                            cpu.opt.moments[g][0]),
                           ("nu", gpu.opt.moments[g][1],
                            cpu.opt.moments[g][1])):
            a, b = a.detach().cpu(), b.detach()
            torch.testing.assert_close(
                a, b, rtol=1e-4 if what == "param" else 5e-3,
                atol=1e-6 * max(float(b.abs().max()), 1e-30),
                msg=f"{what} {g}")


def _pair_runs(seed, counts, pads=(0, 3, 0, 77, 1)):
    """Features [B,8] of runs with the given lengths, each followed by pad
    rows that hold an opaque Gaussian at the tile's centre: a kernel that
    read past a run's count would show it in the image. Returns (feats,
    sfp, counts, walked-row mask)."""
    r = np.random.default_rng(seed)
    pads = np.resize(np.asarray(pads), len(counts))
    starts = np.concatenate([[0], np.cumsum(np.asarray(counts) + pads)])
    B = int(starts[-1]) + 5
    a = r.uniform(0.05, 0.8, B)
    c = r.uniform(0.05, 0.8, B)
    b = r.uniform(-0.1, 0.1, B) * np.sqrt(a * c)
    mx, my = r.uniform(-4.0, 20.0, (2, B))
    logop = np.log(r.uniform(0.05, 0.95, B))
    walked = np.zeros(B, bool)
    for s0, n in zip(starts[:-1], counts):
        walked[s0:s0 + n] = True
    a[~walked], c[~walked], b[~walked] = 0.01, 0.01, 0.0
    mx[~walked], my[~walked], logop[~walked] = 8.0, 8.0, np.log(0.99)
    amx_bmy = a * mx + b * my
    bmx_cmy = b * mx + c * my
    const = -0.5 * (amx_bmy * mx + bmx_cmy * my) + logop
    feats = np.stack([-0.5 * a, -b, -0.5 * c, amx_bmy, bmx_cmy, const,
                      logop, np.zeros(B)], axis=-1).astype(np.float32)
    return (feats, starts[:-1].astype(np.int32),
            np.asarray(counts, np.int32), walked)


# run lengths 0, 1, 127, 128 and 769 (past the cap of 768), long runs
# that saturate pixels, pads between runs
PAIR_RUNS = {"edges": (0, [0, 1, 127, 128, 769]),
             "long": (1, [640, 300, 0, 768, 2, 513, 129])}


@pytest.mark.parametrize("name", list(PAIR_RUNS))
def test_pair_kernels_match_plain_versions(device, name):
    seed, runs = PAIR_RUNS[name]
    feats, sfp, counts, walked = (torch.from_numpy(x).to(device)
                                  for x in _pair_runs(seed, runs))
    basis = tiles.pixel_basis(16, device=device)
    R = sfp.shape[0]
    img_k = pair.pair_fwd(feats, sfp, counts, basis)
    torch.cuda.synchronize()
    img_r = pair.pair_fwd_ref(feats, sfp, counts, basis)
    torch.testing.assert_close(img_k, img_r, rtol=0, atol=1e-5)
    assert bool((img_k[counts == 0] == 0).all())
    assert float(img_k.max()) > 0.999            # saturated pixels
    gen = torch.Generator(device=device).manual_seed(0)
    g = torch.rand((R, 256), generator=gen, device=device) - 0.5
    d_k = pair.pair_bwd(feats, sfp, counts, basis, g, img_r)
    torch.cuda.synchronize()
    d_r = pair.pair_bwd_ref(feats, sfp, counts, basis, g, img_r)
    scale = float(d_r.abs().max())
    assert scale > 0
    torch.testing.assert_close(d_k[walked], d_r[walked], rtol=0,
                               atol=1e-4 * scale)
    assert bool((d_k[walked][:, 6:] == 0).all())


def test_pair_wrappers_count_launches_and_check_inputs(device):
    feats, sfp, counts, _ = (torch.from_numpy(x).to(device)
                             for x in _pair_runs(2, [5, 40, 0]))
    basis = tiles.pixel_basis(16, device=device)
    g = torch.zeros((3, 256), device=device)
    before = dict(pair.launch_counts)
    img = pair.pair_fwd(feats, sfp, counts, basis)
    pair.pair_bwd(feats, sfp, counts, basis, g, img)
    pair.pair_fwd(feats.cpu(), sfp.cpu(), counts.cpu(), basis.cpu())
    assert pair.launch_counts == {"pair_fwd": before["pair_fwd"] + 1,
                                  "pair_bwd": before["pair_bwd"] + 1}
    with pytest.raises(TypeError):
        pair.pair_fwd(feats.double(), sfp, counts, basis)
    with pytest.raises(TypeError):
        pair.pair_fwd(feats, sfp, counts.long(), basis)
    with pytest.raises(ValueError):
        pair.pair_fwd(feats, sfp, counts[:2], basis)
    with pytest.raises(ValueError):
        pair.pair_fwd(feats, sfp.cpu(), counts, basis)
    with pytest.raises(ValueError):
        pair.pair_bwd(feats, sfp, counts, basis, g[:2], img)


# (seed, tiles, K, counts of valid slots): K below, at and past the
# kernels' staging batches, 769 as past the fixture's cap of 768
V1_FRAMES = {"k64": dict(seed=3, t=12, k=64, counts=(0, 1, 64, 30)),
             "k300": dict(seed=4, t=10, k=300, counts=(300, 0, 127, 128,
                                                      257)),
             "k769": dict(seed=5, t=8, k=769, counts=(769, 500, 1))}


@pytest.mark.parametrize("name", list(V1_FRAMES))
def test_raster_v1_kernels_match_plain_versions(device, name):
    feats, _, _, g = (torch.from_numpy(x).to(device)
                      for x in _random_frame(**V1_FRAMES[name]))
    basis = tiles.pixel_basis(16, device=device)
    img_k = raster_v1.composite_fwd(feats, basis)
    torch.cuda.synchronize()
    img_r = raster_v1.composite_fwd_ref(feats, basis)
    torch.testing.assert_close(img_k, img_r, rtol=0, atol=1e-5)
    d_k = raster_v1.composite_bwd(feats, basis, g, img_r)
    torch.cuda.synchronize()
    d_r = raster_v1.composite_bwd_ref(feats, basis, g, img_r)
    scale = float(d_r.abs().max())
    assert scale > 0
    torch.testing.assert_close(d_k, d_r, rtol=0, atol=1e-4 * scale)
    assert bool((d_k[..., 6:] == 0).all())
    if name == "k769":
        assert float(img_k.max()) > 0.999


def test_raster_v1_wrappers_count_launches_and_check_inputs(device):
    feats, _, _, g = (torch.from_numpy(x).to(device)
                      for x in _random_frame(6, t=8, k=64))
    basis = tiles.pixel_basis(16, device=device)
    before = dict(raster_v1.launch_counts)
    img = raster_v1.composite_fwd(feats, basis)
    raster_v1.composite_bwd(feats, basis, g, img)
    raster_v1.composite_fwd(feats.cpu(), basis.cpu())
    assert raster_v1.launch_counts == {
        "raster_v1_fwd": before["raster_v1_fwd"] + 1,
        "raster_v1_bwd": before["raster_v1_bwd"] + 1}
    with pytest.raises(TypeError):
        raster_v1.composite_fwd(feats.double(), basis)
    with pytest.raises(ValueError):
        raster_v1.composite_fwd(feats[:, ::2], basis)
    with pytest.raises(ValueError):
        raster_v1.composite_fwd(feats, basis.cpu())
    with pytest.raises(ValueError):
        raster_v1.composite_bwd(feats, basis, g[:2], img)


# the three paths of this slice: the v4 pair kernel, the v1 single-level
# compositor and the two-level frame from the pair-prefix tables
NEW_PATHS = {
    "pair_v4": (dict(capacity=256, pair_budget=2048, pair_kernel=True),
                {"pair_fwd": 1, "pair_bwd": 1}),
    "single_v1": (dict(capacity=64, pair_budget=0, backend="pallas_v1"),
                  {"raster_v1_fwd": 1, "raster_v1_bwd": 1}),
    "pair_prefix": (dict(capacity=64, dense_capacity=16, overflow_tiles=3,
                         occupancy_sort=True, pair_budget=2048,
                         pair_kernel=False),
                    {"raster_v2_fwd": 2, "raster_v2_bwd": 2}),
}


@pytest.mark.parametrize("path", list(NEW_PATHS))
def test_new_paths_on_gpu_match_cpu_path(device, path):
    kw, launches = NEW_PATHS[path]
    arrays = _scene(**SCENES["cluster"][0])

    def grads(dev):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        params = [x.requires_grad_() for x in t[:4]]
        sink = torch.zeros((t[0].shape[0], 2), device=dev,
                           requires_grad=True)
        out = rasterize(*params, t[4], t[5], W, H, absgrad_sink=sink, **kw)
        img = torch.clamp(out.image, 0, 1)
        w = (torch.arange(img.numel(), device=dev, dtype=torch.float32)
             .reshape(img.shape) % 7) / 7.0 + 0.3
        g = torch.autograd.grad((img * w).sum(), params + [sink])
        return [out.image.detach().cpu()] + [x.cpu() for x in g]

    mods = (pair, raster_v1, raster_v2, segpair)
    before = {k: v for m in mods for k, v in m.launch_counts.items()}
    on_gpu = grads(device)
    after = {k: v for m in mods for k, v in m.launch_counts.items()}
    assert {k: after[k] - before[k] for k in after} == dict(
        {k: 0 for k in after}, **launches)
    names = ("image", "means", "quats", "scales", "opacities", "absgrad")
    for nm, a, b in zip(names, on_gpu, grads(torch.device("cpu"))):
        assert torch.isfinite(a).all(), nm
        if nm == "image":
            torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
        else:
            torch.testing.assert_close(a, b, rtol=2e-3, atol=3e-4, msg=nm)


def _shard(rows, seed=None):
    return np.random.default_rng(rows if seed is None else seed).random(
        (rows, 128)).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 127, 128, 1000, 16384, 0, 63, 64, 65,
                                  40000])
def test_shard_sum_kernel_matches_plain_version(device, rows):
    """Rows 1, 63, 65, 127 and 1000 leave the kernel's last block of rows
    ragged; 0 gives zeros. The kernel's bits are those of
    tests/test_torch_probe_order.py's NumPy model of its order (blocks of
    rows a CTA, warps, trees, the partials in CTA order), on two
    launches."""
    xn = _shard(rows)
    x = torch.from_numpy(xn).to(device)
    before = shard_sum.launch_counts["shard_sum"]
    got = shard_sum.shard_sum2x(x)
    again = shard_sum.shard_sum2x(x)
    torch.cuda.synchronize()
    assert shard_sum.launch_counts["shard_sum"] == before + 2
    assert got.shape == (1, 128)
    assert torch.equal(got, again), "the sum changed between launches"
    assert np.array_equal(got.cpu().numpy(), shard_sum_order(xn))
    exact = (2.0 * x.double()).sum(0, keepdim=True)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=0)
    torch.testing.assert_close(shard_sum.shard_sum2x_ref(x).double(), exact,
                               rtol=1e-5, atol=0)


def test_shard_sum_ticket_resets_across_row_counts(device):
    """Calls of other grid sizes in a row (16384 rows, then 1, 0, 16384,
    300 and 16384 again), each the order model's bits: every launch finds
    the ticket at 0 and leaves it there. A second stream has its own
    workspace and gives the same bits."""
    for i, rows in enumerate((16384, 1, 0, 16384, 300, 16384)):
        x = _shard(rows, seed=i)
        got = shard_sum.shard_sum2x(torch.from_numpy(x).to(device))
        assert np.array_equal(got.cpu().numpy(), shard_sum_order(x)), rows
    x = _shard(5000)
    xt = torch.from_numpy(x).to(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        got = shard_sum.shard_sum2x(xt)
    side.synchronize()
    assert np.array_equal(got.cpu().numpy(), shard_sum_order(x))
    assert np.array_equal(shard_sum.shard_sum2x(xt).cpu().numpy(),
                          shard_sum_order(x))


def test_shard_sum_launches_one_kernel_per_call(device):
    """After the first call (which zeroes the stream's ticket), each call
    is the kernel alone: no fill, no copy (_check_one_kernel_per_call)."""
    x = torch.from_numpy(_shard(16384)).to(device)
    _check_one_kernel_per_call(lambda: shard_sum.shard_sum2x(x),
                               shard_sum.launch_counts, "shard_sum",
                               "shard_sum2x_kernel")


def test_shard_sum_wrapper_checks_inputs(device):
    x = torch.ones((8, 128), device=device)
    with pytest.raises(TypeError):
        shard_sum.shard_sum2x(x.double())
    with pytest.raises(ValueError):
        shard_sum.shard_sum2x(torch.ones((8, 64), device=device))
    with pytest.raises(ValueError):
        shard_sum.shard_sum2x(torch.ones((128, 8), device=device).t())
    with pytest.raises(ValueError, match="16-byte boundary"):
        shard_sum.shard_sum2x(torch.ones(9 * 128 + 1, device=device)[1:]
                              .view(9, 128))
    assert torch.equal(shard_sum.shard_sum2x(torch.ones((0, 128),
                                                        device=device)),
                       torch.zeros((1, 128), device=device))


@pytest.mark.parametrize("band", [0, 1])
def test_band_render_on_gpu_matches_cpu_path(device, band):
    """A band of 2 tile rows of the 3-row image (band 1 pads one row) on
    the seg path, GPU against CPU."""
    arrays = _scene(**SCENES["cluster"][0])

    def grads(dev):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        params = [x.requires_grad_() for x in t[:4]]
        sink = torch.zeros((t[0].shape[0], 2), device=dev,
                           requires_grad=True)
        out = rasterize(*params, t[4], t[5], W, H, capacity=512,
                        pair_budget=2048, pair_kernel="seg",
                        absgrad_sink=sink, band_row0=2 * band,
                        band_tile_rows=2)
        img = torch.clamp(out.image, 0, 1)
        w = (torch.arange(img.numel(), device=dev, dtype=torch.float32)
             .reshape(img.shape) % 7) / 7.0 + 0.3
        g = torch.autograd.grad((img * w).sum(), params + [sink])
        return [out.image.detach().cpu()] + [x.cpu() for x in g]

    before = segpair.launch_counts["segpair_fwd"]
    on_gpu = grads(device)
    assert segpair.launch_counts["segpair_fwd"] == before + 1
    assert on_gpu[0].shape == (32, W)
    names = ("image", "means", "quats", "scales", "opacities", "absgrad")
    for nm, a, b in zip(names, on_gpu, grads(torch.device("cpu"))):
        assert torch.isfinite(a).all(), nm
        if nm == "image":
            torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
        else:
            torch.testing.assert_close(a, b, rtol=2e-3, atol=3e-4, msg=nm)


def _lab_planes(seed, t):
    """A cotangent, a prior and a total [t,256] for the lab backward."""
    r = np.random.default_rng(seed)
    return [r.uniform(lo, hi, (t, 256)).astype(np.float32)
            for lo, hi in ((-1, 1), (0, 0.3), (0.3, 1.0))]


def _check_lab_fwd(got, ref, scan):
    tol = 5e-5 if scan == "logsum" else 1e-5
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=tol)
    live = ref[1] >= 1e-4
    torch.testing.assert_close(got[1][live], ref[1][live], rtol=tol, atol=0)
    assert bool((got[1][~live] < 1e-4).all())


def _flat_frame(t, k, alpha, dead):
    """[t,k,8] of slots whose alpha is ``alpha`` on every pixel (log a is
    the constant term, the guard sits at it), the -1e30 marker where
    ``dead`` [t,k] is set."""
    feats = np.zeros((t, k, 8), np.float32)
    feats[..., 5] = feats[..., 6] = np.log(alpha)
    feats[..., 5][dead] = -1e30
    return feats


def lab_order_cases():
    """The frames the lab kernels' walk is held on (here on the card, in
    tests/test_torch_lab_order.py by a CPU model of the walk), each
    (feats, t_in or None, chunk) in NumPy:

    - ``scene_l1`` / ``scene_l2``: the lab scene cut to 2000 Gaussians at
      128x128 (k1 32, k2 64, t2 8), level 2 fed level 1's plain t_out:
      K = 32 and 64, dead slots a tail of each row;
    - ``interleaved``: ~10% dead slots among the live ones, rows with no
      live slot (count 0), rows entering saturated;
    - ``noscan_dead_end``: chunks of 32 whose last slot is dead (rows 0-1;
      row 1 also the three before it; row 2 random slots with slot 31
      dead; row 3 every slot live), so that the ``noscan`` carry, which
      moves by the chunk's last slot by position, stays as it is there;
    - ``k384``: K = 384, the lab's level-2 width, over three chunks;
    - ``all_dead``: every slot dead, t_in random: img 0, t_out = t_in,
      dfeats 0.
    """
    sc = lab_scene.bench_scene(n=2000, width=128, height=128, k1=32, k2=64,
                               t2=8)
    _, tout1 = chunked.chunked_fwd_ref(sc.feats1, sc.basis)
    feats, _, t_in, _ = _random_frame(11, t=16, k=256)
    dead = np.zeros((4, 64), bool)
    dead[:2, [31, 63]] = True
    dead[1, 28:31] = True
    end = _flat_frame(4, 64, 0.05, dead)
    end[2] = _random_frame(13, t=8, k=64, counts=(64,))[0][0]
    end[2, 31, 5] = -1e30
    r = np.random.default_rng(14)
    return {
        "scene_l1": (sc.feats1.numpy(), None, 128),
        "scene_l2": (sc.feats2.numpy(), tout1[sc.rows2].numpy(), 128),
        "interleaved": (feats, t_in, 128),
        "noscan_dead_end": (end, None, 32),
        "k384": (_random_frame(12, t=8, k=384, counts=(
            0, 5, 200, 384, 300, 383, 17, 256))[0],
                 r.uniform(0.2, 1.0, (8, 256)).astype(np.float32), 128),
        "all_dead": (_flat_frame(3, 64, 0.5, np.ones((3, 64), bool)),
                     r.uniform(0.2, 1.0, (3, 256)).astype(np.float32), 64),
    }


@pytest.mark.parametrize("case", ["scene_l1", "scene_l2", "interleaved",
                                  "noscan_dead_end", "k384", "all_dead"])
def test_lab_kernels_skip_dead_slots_exactly(device, case):
    """Every lab entry on the dead-slot cases of lab_order_cases against
    its plain version (the gates of _check_lab_fwd; dfeats 1e-4 of
    max-abs), two launches bit-equal; rows with no live slot give img 0,
    t_out = t_in and dfeats 0 exactly."""
    feats, t_in, chunk = lab_order_cases()[case]
    t = feats.shape[0]
    feats = torch.from_numpy(feats).to(device)
    t_in = None if t_in is None else torch.from_numpy(t_in).to(device)
    g, prior, total = (torch.from_numpy(x).to(device)
                       for x in _lab_planes(15, t))
    basis = tiles.pixel_basis(16, device=device)
    empty = (feats[..., 5] <= -1e29).all(dim=1)
    ones = torch.ones((t, 256), device=device)
    for scan in chunked.SCANS:
        got = chunked.chunked_fwd(feats, basis, t_in, scan=scan, chunk=chunk)
        again = chunked.chunked_fwd(feats, basis, t_in, scan=scan,
                                    chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])
        _check_lab_fwd(got, chunked.chunked_fwd_ref(
            feats, basis, t_in, scan=scan, chunk=chunk), scan)
        assert bool((got[0][empty] == 0).all())
        assert torch.equal(got[1][empty],
                           (ones if t_in is None else t_in)[empty])
    got = chunked.chunked_bwd(feats, basis, g, t_in, prior, total,
                              chunk=chunk)
    again = chunked.chunked_bwd(feats, basis, g, t_in, prior, total,
                                chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "dfeats changed between launches"
    ref = chunked.chunked_bwd_ref(feats, basis, g, t_in, prior, total,
                                  chunk=chunk)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    assert bool((got[feats[..., 5] <= -1e29] == 0).all())
    assert bool((got[..., 6:] == 0).all())
    if case == "all_dead":
        assert bool(empty.all())


@pytest.mark.parametrize("scan", list(chunked.SCANS))
@pytest.mark.parametrize("with_t_in", [False, True])
def test_lab_chunked_fwd_kernels_match_plain_versions(device, scan,
                                                      with_t_in):
    """tests/test_torch_lab.py's shapes: 20 rows of 256 slots (two
    128-slot chunks, so the carry runs), dead slots at -1e30."""
    feats, _, t_in, _ = (torch.from_numpy(x).to(device) for x in
                         _random_frame(7, t=20, k=256))
    t_in = t_in if with_t_in else None
    basis = tiles.pixel_basis(16, device=device)
    key = f"lab_fwd_{scan}"
    before = chunked.launch_counts[key]
    got = chunked.chunked_fwd(feats, basis, t_in, scan=scan)
    again = chunked.chunked_fwd(feats, basis, t_in, scan=scan)
    torch.cuda.synchronize()
    assert chunked.launch_counts[key] == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _check_lab_fwd(got, chunked.chunked_fwd_ref(feats, basis, t_in,
                                                scan=scan), scan)


def test_lab_chunked_bwd_kernel_matches_plain_version(device):
    feats, _, t_in, _ = (torch.from_numpy(x).to(device) for x in
                         _random_frame(8, t=20, k=256))
    g, prior, total = (torch.from_numpy(x).to(device)
                       for x in _lab_planes(8, 20))
    basis = tiles.pixel_basis(16, device=device)
    before = chunked.launch_counts["lab_bwd_v3"]
    for args in ((None, None), (t_in, prior)):
        got = chunked.chunked_bwd(feats, basis, g, *args, total)
        again = chunked.chunked_bwd(feats, basis, g, *args, total)
        torch.cuda.synchronize()
        ref = chunked.chunked_bwd_ref(feats, basis, g, *args, total)
        assert torch.equal(got, again), "dfeats changed between launches"
        scale = ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * scale)
        assert bool((got[..., 6:] == 0).all())
    assert chunked.launch_counts["lab_bwd_v3"] == before + 4


def test_lab_kernels_on_the_full_lab_frame(device):
    """The JAX labs' scene: the level-1 frame [2500,128,8] and the level-2
    frame [625,384,8] fed level 1's t_out, every form and the backward."""
    sc = lab_scene.bench_scene(device=device)
    basis, rows = sc.basis, sc.rows2
    assert sc.feats1.shape == (2500, 128, 8)
    assert sc.feats2.shape == (625, 384, 8)
    ref1, tref1 = chunked.chunked_fwd_ref(sc.feats1, basis)
    tin2 = tref1[rows].contiguous()
    ref2, _ = chunked.chunked_fwd_ref(sc.feats2, basis, tin2)
    for scan in chunked.SCANS:
        _check_lab_fwd(chunked.chunked_fwd(sc.feats1, basis, scan=scan),
                       chunked.chunked_fwd_ref(sc.feats1, basis, scan=scan),
                       scan)
        _check_lab_fwd(chunked.chunked_fwd(sc.feats2, basis, tin2,
                                           scan=scan),
                       chunked.chunked_fwd_ref(sc.feats2, basis, tin2,
                                               scan=scan), scan)
    total = ref1.clone()
    total[rows] += ref2
    g1 = torch.ones_like(ref1)
    for args in ((sc.feats1, basis, g1, None, None, total),
                 (sc.feats2, basis, g1[rows].contiguous(), tin2,
                  ref1[rows].contiguous(), total[rows].contiguous())):
        got = chunked.chunked_bwd(*args)
        ref = chunked.chunked_bwd_ref(*args)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * ref.abs().max().item())


def test_lab_chunked_wrappers_check_inputs(device):
    feats = torch.zeros((4, 128, 8), device=device)
    basis = tiles.pixel_basis(16, device=device)
    with pytest.raises(ValueError, match="chunks of 48"):
        chunked.chunked_fwd(feats, basis, chunk=48)   # 128 % 48 != 0
    with pytest.raises(ValueError, match="multiple"):
        chunked.chunked_fwd(torch.zeros((4, 64, 8), device=device), basis,
                            chunk=16)
    with pytest.raises(TypeError):
        chunked.chunked_fwd(feats.double(), basis)
    with pytest.raises(ValueError, match="contiguous"):
        chunked.chunked_fwd(torch.zeros((4, 8, 128), device=device)
                            .transpose(1, 2), basis)
    with pytest.raises(ValueError, match="all inputs"):
        chunked.chunked_fwd(feats, basis.cpu())
    with pytest.raises(ValueError):
        chunked.chunked_bwd(feats, basis, torch.zeros((3, 256),
                                                      device=device),
                            None, None, torch.zeros((4, 256),
                                                    device=device))


@pytest.mark.parametrize("name", list(probes.CASES))
def test_lab_probe_kernels_match_plain_versions_and_oracles(device, name):
    key = f"probe_{probes.CASES[name].probe}"
    before = probes.launch_counts[key]
    out, err, tol = probes.run_case(name, device)
    torch.cuda.synchronize()
    assert probes.launch_counts[key] == before + 1
    assert err <= tol, (name, err)
    ref, _, _ = probes.run_case(name, device, plain=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


def test_lab_probe_windows_overlap_and_out_of_range(device):
    """Of two overlapping window writes the later wins; a window past the
    array is skipped (write and read)."""
    offs = torch.tensor([40, 60, 500], dtype=torch.int32, device=device)
    got = probes.probe_dyn_write(offs, 256, 8, 128)
    torch.testing.assert_close(got, probes.probe_dyn_write_ref(offs, 256, 8,
                                                               128))
    src = torch.arange(512 * 4, dtype=torch.float32,
                       device=device).reshape(512, 4)
    roffs = torch.tensor([0, 400], dtype=torch.int32, device=device)
    torch.testing.assert_close(probes.probe_dyn_read(src, roffs),
                               probes.probe_dyn_read_ref(src, roffs))


# -- the one-launch dyn_write / dyn_read kernels -----------------------------

def _random_windows(rng):
    """rows, cols, win and 0-8 int32 offsets: about 60% inside the array
    where a window fits at all, the rest mostly out of range; columns past
    2048 give the kernels CTAs of one row (tests/test_torch_build.py's
    draws, with wider rows)."""
    rows = int(rng.integers(1, 300))
    win = int(rng.choice([1, 5, 8, 16, 40, 128, 300]))
    n_win = int(rng.integers(0, 9))
    offs = rng.integers(-win - 8, rows + 8, n_win)
    if rows >= win:
        inside = rng.integers(0, rows - win + 1, n_win)
        offs = np.where(rng.random(n_win) < 0.6, inside, offs)
    cols = int(rng.choice([4, 8, 12, 256, 2052]))
    return rows, cols, win, offs.astype(np.int32)


WINDOW_PROBES = ["dyn_write", "dyn_read", "vmem_dyn_read", "vmem_dyn_rmw"]
# the roll and transpose kernels on 16-byte rows (vectors) and on rows
# that are not (the scalar path): (shape, shift, axis) of the roll
ELEMENT_PROBES = {"roll_vec_axis0": ((128, 256), 2, 0),
                  "roll_vec_axis1": ((256, 128), 2, 1),
                  "roll_odd_axis1": ((37, 131), -5, 1),
                  "transpose_vec": ((256, 128), None, None),
                  "transpose_odd": ((257, 131), None, None)}


def _window_key(probe):
    """The launch count (and kernel name stem) of a WINDOW_PROBES or
    ELEMENT_PROBES entry."""
    if probe in ELEMENT_PROBES:
        return f"probe_{probe.split('_')[0]}"
    return "probe_vmem_dyn" if probe.startswith("vmem") else f"probe_{probe}"


def _window_call(probe, device, offs, rows=512, cols=256, win=128, seed=0):
    """(kernel call, plain call, result shape) of one window probe; for
    vmem_dyn ``rows`` is the buffer's and one step a window, x seeded. An
    ELEMENT_PROBES entry takes its own seeded x and ignores the rest."""
    if probe in ELEMENT_PROBES:
        shape, shift, axis = ELEMENT_PROBES[probe]
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=shape).astype(np.float32)).to(device)
        if probe.startswith("roll"):
            return (lambda: probes.probe_roll(x, shift, axis),
                    lambda: probes.probe_roll_ref(x, shift, axis), shape)
        return (lambda: probes.probe_transpose(x),
                lambda: probes.probe_transpose_ref(x), shape[::-1])
    offs = torch.as_tensor(offs, dtype=torch.int32, device=device)
    if probe == "dyn_write":
        return (lambda: probes.probe_dyn_write(offs, rows, cols, win),
                lambda: probes.probe_dyn_write_ref(offs, rows, cols, win),
                (rows, cols))
    if probe.startswith("vmem"):
        rmw = probe == "vmem_dyn_rmw"
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(offs.shape[0], win, cols)).astype(np.float32)).to(device)
        return (lambda: probes.probe_vmem_dyn(offs, x, rows, rmw),
                lambda: probes.probe_vmem_dyn_ref(offs, x, rows, rmw),
                tuple(x.shape))
    src = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(rows, cols)).astype(np.float32)).to(device)
    return (lambda: probes.probe_dyn_read(src, offs, win),
            lambda: probes.probe_dyn_read_ref(src, offs, win),
            (offs.shape[0] * win, cols))


@pytest.mark.parametrize("poison", ["freed_block", "nan_empty"])
@pytest.mark.parametrize("probe", WINDOW_PROBES + list(ELEMENT_PROBES))
def test_lab_window_probes_write_every_element(device, monkeypatch, probe,
                                               poison):
    """The wrappers allocate with torch.empty, so a kernel that skips an
    element leaves whatever the memory held. Poisoned allocations: a freed
    block of NaNs of the result's size (the caching allocator hands such a
    block back when nothing fits better), or torch.empty itself returning
    NaNs. Every element outside the windows (vmem_dyn: of the steps whose
    window does not fit) must still come out 0; the roll and transpose
    results (ELEMENT_PROBES) must equal the plain version's, NaN-free."""
    kern, plain, shape = _window_call(probe, device, [40, 200, 300, -3, 450])
    if poison == "freed_block":
        torch.cuda.empty_cache()
        block = torch.full(shape, float("nan"), device=device)
        del block
    else:
        empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(
            *a, **k).fill_(float("nan")))
    out = kern()
    monkeypatch.undo()
    torch.cuda.synchronize()
    ref = plain()
    assert torch.equal(out, ref)
    if probe not in ELEMENT_PROBES:
        assert (out[ref == 0] == 0).all() and (ref == 0).any()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("probe", WINDOW_PROBES)
def test_lab_window_probes_on_random_windows(device, probe, seed):
    """Random, overlapping and out-of-range windows: kernel and plain
    version exactly equal."""
    rng = np.random.default_rng(300 + seed)
    for i in range(25):
        rows, cols, win, offs = _random_windows(rng)
        kern, plain, _ = _window_call(probe, device, offs, rows, cols, win,
                                      seed=i)
        got = kern()
        torch.cuda.synchronize()
        assert torch.equal(got, plain()), (rows, cols, win, offs)


def _check_one_kernel_per_call(call, counts, key, kernel, calls=10):
    """``calls`` calls of ``call`` in one torch.profiler window, read once:
    each adds one to ``counts[key]``; the host side of the window holds
    exactly one runtime launch record a call and no memset or memcpy
    record; every device record that comes through is ``kernel``. The
    launches are counted on the host's records, not the device's: on an
    H100 the profiler loses a window's device records now and then, for
    tens of milliseconds at a time (0 or 9 of 10 in windows next to each
    other, kernels stamped before their launches), while the host's
    launch records were all there in every one of 216 windows read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    before = counts[key]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    assert counts[key] == before + calls
    on_host = [e.name for e in prof.events()
               if e.device_type != DeviceType.CUDA]
    launches = [n for n in on_host if "LaunchKernel" in n]
    moves = [n for n in on_host if "Memset" in n or "Memcpy" in n]
    assert len(launches) == calls and not moves, (launches, moves)
    on_device = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    assert len(on_device) <= calls, on_device
    assert all(kernel in name for name in on_device), on_device


@pytest.mark.parametrize("probe", WINDOW_PROBES + list(ELEMENT_PROBES))
def test_lab_window_probes_launch_one_kernel_per_call(device, probe):
    """Each call launches one kernel, the probe's, and no fill or copy,
    and adds one to the launch count (counted on the host's launch
    records: _check_one_kernel_per_call)."""
    kern, _, _ = _window_call(probe, device, [40, 200])
    key = _window_key(probe)
    _check_one_kernel_per_call(kern, probes.launch_counts, key,
                               f"{key}_kernel")


def _misaligned(x):
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("seed", range(4))
def test_lab_roll_and_transpose_on_random_shapes(device, seed):
    """Random shapes (odd widths, one row or column, 16-byte rows) and
    shifts (negative, past the axis): roll and transpose bit for bit the
    plain version, aligned and misaligned (the scalar path), and two
    launches bit-equal."""
    rng = np.random.default_rng(700 + seed)
    for i in range(30):
        rows = int(rng.choice([1, 2, 3, 4, 7, 64, 129, 300]))
        cols = int(rng.choice([1, 3, 4, 5, 8, 36, 131, 256, 1028]))
        x = torch.from_numpy(rng.normal(size=(rows, cols)).astype(
            np.float32)).to(device)
        shift = int(rng.integers(-3 * max(rows, cols), 3 * max(rows, cols)))
        for xin in (x, _misaligned(x)):
            for axis in (0, 1):
                got = probes.probe_roll(xin, shift, axis)
                again = probes.probe_roll(xin, shift, axis)
                torch.cuda.synchronize()
                ref = probes.probe_roll_ref(x, shift, axis)
                assert torch.equal(got.view(torch.int32),
                                   ref.view(torch.int32)), (
                    rows, cols, shift, axis, xin.data_ptr() % 16)
                assert torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))
            got = probes.probe_transpose(xin)
            again = probes.probe_transpose(xin)
            torch.cuda.synchronize()
            assert torch.equal(got, x.t().contiguous()), (rows, cols)
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_lab_roll_and_transpose_empty_and_tall(device):
    """Empty arrays (no kernel runs; the call still counts), and arrays
    taller than a grid's height (the kernels loop over the rows beyond
    it)."""
    for shape in ((0, 8), (5, 0)):
        x = torch.zeros(shape, device=device)
        assert probes.probe_roll(x, 3, 0).shape == shape
        assert probes.probe_transpose(x).shape == shape[::-1]
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(70000 * 32 + 5, 4)).astype(np.float32)).to(device)
    for axis, shift in ((0, 12345), (1, 3)):
        assert torch.equal(probes.probe_roll(x, shift, axis),
                           probes.probe_roll_ref(x, shift, axis))
    assert torch.equal(probes.probe_transpose(x), x.t().contiguous())
    y = x[:70000 * 32].contiguous()
    assert torch.equal(probes.probe_transpose(y), y.t().contiguous())


def test_lab_window_probes_check_inputs(device):
    offs = torch.tensor([0], dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="16-byte rows"):
        probes.probe_dyn_write(offs, 64, 6, 16)
    with pytest.raises(ValueError, match="16-byte rows"):
        probes.probe_dyn_read(torch.zeros((64, 8), device=device), offs, 0)
    with pytest.raises(ValueError, match="windows"):
        probes.probe_dyn_write(
            torch.zeros(probes.MAX_WINDOWS + 1, dtype=torch.int32,
                        device=device), 64, 8, 16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        probes.probe_dyn_read(torch.zeros(64 * 8 + 1, device=device)[1:]
                              .view(64, 8), offs, 16)
    with pytest.raises(TypeError):
        probes.probe_dyn_write(offs.long(), 64, 8, 16)
    x = torch.zeros((1, 16, 8), device=device)
    with pytest.raises(ValueError, match="16-byte rows"):
        probes.probe_vmem_dyn(offs, torch.zeros((1, 16, 6), device=device),
                              64, True)
    with pytest.raises(ValueError, match="16-byte boundary"):
        probes.probe_vmem_dyn(offs, torch.zeros(16 * 8 + 1, device=device)
                              [1:].view(1, 16, 8), 64, True)
    with pytest.raises(ValueError, match="steps"):
        probes.probe_vmem_dyn(
            torch.zeros(probes.MAX_WINDOWS + 1, dtype=torch.int32,
                        device=device),
            x.expand(probes.MAX_WINDOWS + 1, 16, 8).contiguous(), 64, False)
    with pytest.raises(ValueError, match="one per step"):
        probes.probe_vmem_dyn(offs, x.expand(2, 16, 8).contiguous(), 64,
                              False)


# -- the seg backward's batches and tensor-core reduction --------------------

SEG_BATCH = 64      # pairs per staged batch of csrc/segpair.cu's backward
SEG_RUNS = {
    # around the MMA tile (16 pairs), the batch and the 768-pair cap
    "lengths": [0, 1, 15, 16, 17, 31, 32, 33, SEG_BATCH - 1, SEG_BATCH,
                SEG_BATCH + 1, 0, 768],
    # one pixel saturates at pairs 40-42 of a 100-pair run
    "pixel_saturates": [100, 7],
    # every pixel saturates at pair 101 of 200: rows 102-199 are zero
    "all_saturate": [200, 3],
}


def _seg_run_features(name, seed=0):
    """(feats [B+5,8], s_f [T+1] int32) for SEG_RUNS[name]: broad, faint
    Gaussians in tile-local coordinates, so that the 768-pair run keeps
    most pixels alive; 5 rows past the last run belong to no run. In
    'pixel_saturates' three narrow opaque pairs sit on pixel (3, 7); in
    'all_saturate' pairs 100 and 101 have alpha 0.999 on every pixel."""
    counts = SEG_RUNS[name]
    r = np.random.default_rng(seed)
    b = sum(counts) + 5
    src = np.zeros((b, 8), np.float32)
    src[:, 0] = r.uniform(0.004, 0.05, b)
    src[:, 2] = r.uniform(0.004, 0.05, b)
    src[:, 1] = r.uniform(-0.5, 0.5, b) * np.sqrt(src[:, 0] * src[:, 2])
    src[:, 3:5] = r.uniform(-6.0, 22.0, (b, 2))
    src[:, 5] = np.log(r.uniform(0.004, 0.03, b))
    src[:, 6] = 1.0
    if name == "pixel_saturates":
        src[40:43, :6] = [2.0, 0.0, 2.0, 3.5, 7.5, np.log(0.995)]
    if name == "all_saturate":
        src[100:102, :6] = [0.0, 0.0, 0.0, 0.0, 0.0, np.log(0.9999)]
    s_f = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    src = torch.from_numpy(src)
    zero = torch.zeros(b)
    return (segpair.build_pair_features(src, zero, zero).contiguous(),
            torch.from_numpy(s_f))


@pytest.mark.parametrize("poison", [None, "freed_block", "nan_empty"])
@pytest.mark.parametrize("name", list(SEG_RUNS))
def test_seg_bwd_kernel_on_run_lengths_and_saturation(device, monkeypatch,
                                                      name, poison):
    """The backward against its plain version: runs of every length
    around the 16-pair MMA tile and the 64-pair batch, up to the cap; a
    pixel done in the middle of a batch; every pixel done in the middle
    of a batch (later rows zero); and allocations poisoned with NaNs (a
    freed block of the result's size, or torch.empty_like filling NaNs),
    so that a row of a run the kernel left unwritten shows."""
    feats, s_f = (x.to(device) for x in _seg_run_features(name))
    basis = tiles.pixel_basis(16, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    gt = torch.rand((s_f.shape[0] - 1, 256), generator=gen, device=device)
    if poison == "freed_block":
        torch.cuda.empty_cache()
        block = torch.full(feats.shape, float("nan"), device=device)
        del block
    elif poison == "nan_empty":
        empty_like = torch.empty_like
        monkeypatch.setattr(torch, "empty_like", lambda *a, **k: empty_like(
            *a, **k).fill_(float("nan")))
    got = segpair.segpair_bwd(feats, s_f, basis, gt)
    monkeypatch.undo()
    torch.cuda.synchronize()
    ref = segpair.segpair_bwd_ref(feats, s_f, basis, gt)
    kept = int(s_f[-1])
    assert bool(torch.isfinite(got[:kept]).all())
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(got[:kept], ref[:kept], rtol=0,
                               atol=1e-5 * scale)
    assert bool((got[:kept, 6:] == 0).all())
    img = segpair.segpair_fwd_ref(feats, s_f, basis)
    if name == "pixel_saturates":
        assert bool((ref[43:100] != 0).any())
    if name == "all_saturate":
        assert bool((got[102:200] == 0).all()) and bool((img[0] > 0.99).all())


# -- the key-split, live-compacted kNN ---------------------------------------

KNN_SLICES = 8      # contiguous key slices per CTA of csrc/knn.cu

def _knn_case(case, n):
    """(points [n,3], mask [n]) for one kNN case."""
    r = np.random.default_rng(n)
    pts = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    if case == "duplicates":        # copies in other key slices
        src = r.choice(n, n // 3, replace=False)
        pts[(src + n // 2) % n] = pts[src]
        pts[n - 1] = pts[0]
        pts[n // 8 + 1] = pts[1]
        mask[::5] = False
    elif case == "all_dead":
        mask[:] = False
    elif case == "one_live":
        mask[:] = False
        mask[n // 3] = True
    elif case == "one_slice_live":
        s = 3 * n // KNN_SLICES
        mask[:] = False
        mask[s:4 * n // KNN_SLICES] = True
        pts[s + 2] = pts[s]          # a tie inside the slice
    return pts, mask


@pytest.mark.parametrize("k", [1, 6, 15, 16])
@pytest.mark.parametrize("case,n", [
    ("duplicates", 1000), ("duplicates", 16461), ("random", 5),
    ("random", 4133), ("all_dead", 300), ("one_live", 300),
    ("one_slice_live", 2051)])
def test_knn_kernel_slices_and_compaction(device, case, n, k):
    """Bit-equal to the plain version: duplicate points whose copies lie
    in other key slices (the lower index wins), n not a multiple of the
    slice count or of the 128-key tile (5 rows leave slices empty), every
    key dead, one live key, live keys in one slice only."""
    pts, mask = _knn_case(case, n)
    p, m = torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)
    d_k, i_k = knn_mod.knn(p, k, mask=m)
    torch.cuda.synchronize()
    d_r, i_r = knn_mod.knn_ref(p, k, mask=m)
    assert torch.equal(i_k, i_r)
    assert torch.equal(d_k, d_r)
    if case == "all_dead":
        assert bool((d_k == knn_mod.F32_MAX).all()) and bool((i_k == 0).all())
    if case == "one_live":
        live = n // 3
        others = torch.arange(n, device=device) != live
        assert bool((i_k[others, 0] == live).all())
        assert float(d_k[live, 0]) == knn_mod.F32_MAX


# -- the seg forward's batches, t-free groups and stops ----------------------

SEG_FWD_BATCH = 128     # pairs per staged batch of csrc/segpair.cu's forward
SEG_GROUP = 16          # pairs whose t-free terms it computes side by side
STOP_PIXEL = 7 * 16 + 3     # pixel (3, 7) of the tile, row-major
# (run lengths, stops): a stop (row, k, pixel) puts two opaque pairs at
# pairs k - 1 and k of the row (alpha 0.995 on the pixel, or on every
# pixel for pixel None), so that the pixel stops exactly at pair k
SEG_FWD_RUNS = {
    "lengths": ([0, 1, 15, 16, 17, SEG_FWD_BATCH - 1, SEG_FWD_BATCH,
                 SEG_FWD_BATCH + 1, 255, 256, 257, 0, 768], []),
    "empty_rows": ([0, 0, 40, 0, 300, 0, 0, 1, 0, 0], []),
    "pixel_stops_at_group_edges": (
        [100, 100, 100], [(0, SEG_GROUP - 1, STOP_PIXEL),
                          (1, SEG_GROUP, STOP_PIXEL),
                          (2, 3 * SEG_GROUP, STOP_PIXEL)]),
    "pixel_stops_at_batch_edges": (
        [200, 200, 300], [(0, SEG_FWD_BATCH - 1, STOP_PIXEL),
                          (1, SEG_FWD_BATCH, STOP_PIXEL),
                          (2, 2 * SEG_FWD_BATCH, STOP_PIXEL)]),
    # every pixel stops: the CTA leaves at the end of that batch
    "all_stop_at_batch_edges": (
        [200, 200, 400, 30], [(0, SEG_FWD_BATCH - 1, None),
                              (1, SEG_FWD_BATCH, None),
                              (2, 2 * SEG_FWD_BATCH + SEG_GROUP, None)]),
    "all_stop_inside_a_batch": ([300, 30], [(0, 70, None)]),
}


def _seg_fwd_features(name, seed=0):
    """(feats [B,8], s_f [T+1] int32, stops) for SEG_FWD_RUNS[name]:
    broad, faint Gaussians in tile-local coordinates (as
    _seg_run_features), plus the opaque pairs of each stop."""
    counts, stops = SEG_FWD_RUNS[name]
    r = np.random.default_rng(seed)
    b = sum(counts)
    src = np.zeros((b, 8), np.float32)
    src[:, 0] = r.uniform(0.004, 0.05, b)
    src[:, 2] = r.uniform(0.004, 0.05, b)
    src[:, 1] = r.uniform(-0.5, 0.5, b) * np.sqrt(src[:, 0] * src[:, 2])
    src[:, 3:5] = r.uniform(-6.0, 22.0, (b, 2))
    src[:, 5] = np.log(r.uniform(0.004, 0.02, b))
    src[:, 6] = 1.0
    s_f = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    for row, k, pixel in stops:
        at = s_f[row] + k
        if pixel is None:
            src[at - 1:at + 1, :6] = [0.0, 0.0, 0.0, 0.0, 0.0, np.log(0.995)]
        else:
            src[at - 1:at + 1, :6] = [2.0, 0.0, 2.0, 3.5, 7.5, np.log(0.995)]
    zero = torch.zeros(b)
    feats = segpair.build_pair_features(torch.from_numpy(src), zero, zero)
    return feats.contiguous(), torch.from_numpy(s_f), stops


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    start = (-(buf.data_ptr() // 4) + 1) % 4
    view = buf[start:start + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    return view


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", list(SEG_FWD_RUNS))
def test_seg_fwd_kernel_on_run_lengths_and_stops(device, name, aligned):
    """The forward against its plain version (image atol 1e-5): runs of
    every length around the 16-pair group and the 128-pair batch, up to
    the 768 cap; empty rows among full ones and at the end; a pixel, or
    every pixel, whose stop falls on the last or first pair of a group or
    of a batch, or inside a batch with more batches after it (checked on
    the plain version's transmittance); a feats view that is not 16-byte
    aligned (the 4-byte staging path). Two launches give the same
    bits."""
    feats, s_f, stops = (x.to(device) if torch.is_tensor(x) else x
                         for x in _seg_fwd_features(name))
    if not aligned:
        feats = _misaligned(feats)
    basis = tiles.pixel_basis(16, device=device)
    img = segpair.segpair_fwd(feats, s_f, basis)
    again = segpair.segpair_fwd(feats, s_f, basis)
    torch.cuda.synchronize()
    ref = segpair.segpair_fwd_ref(feats, s_f, basis)
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-5)
    assert torch.equal(img, again)
    counts = (s_f[1:] - s_f[:-1]).tolist()
    assert all(bool((img[r] == 0).all()) for r, c in enumerate(counts)
               if c == 0)
    _, _, _, keep, _, slot_valid = segpair._padded_alpha(feats, s_f, basis)
    for row, k, pixel in stops:
        pixels = [pixel] if pixel is not None else list(range(256))
        for p in pixels:
            stopped = (~keep[row, :, p]) & slot_valid[row]
            assert int(stopped.float().argmax()) == k and bool(stopped[k])


# -- the owner-computes onehot probe -----------------------------------------

def _onehot_inputs(j, cols, seed):
    """(seg [8, J], c [J, cols]) in NumPy. Row 0 of seg holds random ids:
    integers in [0, J/3) drawn unsorted (some rows named often, most
    never), integers outside [0, J) and non-integers (near an index and
    halfway); c is normal. tests/test_torch_lab.py shares it."""
    rng = np.random.default_rng(70 + seed)
    ids = rng.integers(0, max(1, j // 3), j).astype(np.float32)
    kind = rng.random(j)
    past = kind < 0.1
    ids[past] = rng.integers(j, 2 * j + 2, int(past.sum()))
    below = (kind >= 0.1) & (kind < 0.2)
    ids[below] = -rng.integers(1, 5, int(below.sum()))
    frac = (kind >= 0.2) & (kind < 0.3)
    ids[frac] += rng.choice([0.5, 1e-3, -2e-3], int(frac.sum()))
    c = rng.normal(size=(j, cols)).astype(np.float32)
    return np.broadcast_to(ids, (8, j)).copy(), c


def _onehot_in_order(seg, c):
    """The one-hot product as the onehot kernel computes it: a zero row
    per output row, then, in ascending j, c[j] added to the row that
    seg[0, j] names when the id is an integer in [0, J) (a sequential
    index_add_ on the CPU). tests/test_torch_lab.py shares it."""
    ids = seg[0].cpu()
    named = (ids == torch.floor(ids)) & (ids >= 0) & (ids < seg.shape[1])
    out = torch.zeros_like(c.cpu())
    out.index_add_(0, ids[named].long(), c.cpu()[named])
    return out


@pytest.mark.parametrize("j,cols", [(128, 256), (97, 12), (33, 5),
                                    (600, 64), (40, 2052), (1, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_onehot_kernel_on_random_ids(device, j, cols, seed):
    """Random unsorted ids, ids outside [0, J) and non-integer ids; J not
    a multiple of 32, more than one round of 256 ids, rows wider than one
    CTA's vectors, rows that are not 16-byte (the float path): bit for bit
    the in-order sum, and within the oracle's tolerance of the plain
    one-hot product."""
    seg_np, c_np = _onehot_inputs(j, cols, seed)
    seg = torch.from_numpy(seg_np).to(device)
    c = torch.from_numpy(c_np).to(device)
    got = probes.probe_onehot(seg, c)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _onehot_in_order(seg, c))
    torch.testing.assert_close(got, probes.probe_onehot_ref(seg, c), rtol=0,
                               atol=probes.ONEHOT_ATOL)


def test_onehot_kernel_on_a_misaligned_c(device):
    """c starting 4 bytes past a 16-byte boundary takes the float path."""
    seg_np, c_np = _onehot_inputs(128, 256, 3)
    seg = torch.from_numpy(seg_np).to(device)
    c = _misaligned(torch.from_numpy(c_np).to(device))
    got = probes.probe_onehot(seg, c)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _onehot_in_order(seg, c))


def test_onehot_kernel_writes_every_element(device, monkeypatch):
    """torch.empty returning NaNs: the rows that no id names still come
    out 0."""
    seg_np, c_np = _onehot_inputs(200, 256, 4)
    seg = torch.from_numpy(seg_np).to(device)
    c = torch.from_numpy(c_np).to(device)
    empty_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like", lambda *a, **k: empty_like(
        *a, **k).fill_(float("nan")))
    got = probes.probe_onehot(seg, c)
    monkeypatch.undo()
    torch.cuda.synchronize()
    ref = _onehot_in_order(seg, c)
    assert torch.equal(got.cpu(), ref) and bool((ref == 0).any())


def test_onehot_kernel_launches_one_kernel_per_call(device):
    """Each call launches one kernel, the probe's, and no fill or copy,
    and adds one to the launch count (counted on the host's launch
    records: _check_one_kernel_per_call)."""
    t = probes.case_tensors("P3 onehot-matmul", device)
    key = "probe_onehot"
    _check_one_kernel_per_call(lambda: probes.probe_onehot(t["r8"], t["c"]),
                               probes.launch_counts, key, f"{key}_kernel")


# -- the dense kernels' batches, t-free groups, stops and entries ------------

DENSE_FWD_BATCH = 128   # slots per staged batch of csrc/raster_v2.cu's forward
DENSE_BWD_BATCH = 64    # ... and of its backward
DENSE_GROUP = 16        # slots whose t-free terms both compute side by side
# a row for each count: around the groups and both batches, up to level 2's
# K, past every K, negative
DENSE_COUNTS = [0, 1, DENSE_GROUP - 1, DENSE_GROUP, DENSE_GROUP + 1,
                DENSE_BWD_BATCH - 1, DENSE_BWD_BATCH, DENSE_BWD_BATCH + 1,
                DENSE_FWD_BATCH - 1, DENSE_FWD_BATCH, DENSE_FWD_BATCH + 1,
                255, 256, 257, 640, 1000, -3]
# a full row for each stop (k, pixel, alpha) with k < K: two slots of that
# alpha at k - 1 and k on the pixel (every pixel for None), so that it stops
# exactly at slot k; 0.9999 is clamped to 0.999
DENSE_STOPS = [(DENSE_GROUP - 1, STOP_PIXEL, 0.995),
               (DENSE_GROUP, STOP_PIXEL, 0.995),
               (3 * DENSE_GROUP, STOP_PIXEL, 0.995),
               (DENSE_BWD_BATCH - 1, STOP_PIXEL, 0.995),
               (DENSE_BWD_BATCH, STOP_PIXEL, 0.995),
               (DENSE_FWD_BATCH - 1, STOP_PIXEL, 0.995),
               (DENSE_FWD_BATCH, STOP_PIXEL, 0.995),
               (256, STOP_PIXEL, 0.995),
               (DENSE_BWD_BATCH, None, 0.995),
               (DENSE_FWD_BATCH + DENSE_GROUP, None, 0.995),
               (70, None, 0.9999)]
DENSE_KS = [16, 48, 128, 640]


def _dense_frame(k, seed=0):
    """(feats [T,K,8], counts [T] int32, t_in [T,256], g, total, rows):
    broad, faint Gaussians in tile-local coordinates (as
    _seg_fwd_features) in every slot, past the count too (the kernels must
    not read there); a row per DENSE_COUNTS entry, a full row per stop of
    DENSE_STOPS below K, then three full rows whose t_in is below 1e-4 on
    every pixel (5e-5; 0; just below 1e-4) and one below it on half its
    pixels. Other rows enter at t_in in [0.5, 1). ``rows`` maps "stops"
    to [(row, k, pixel)] and "saturated" to the first three extra rows."""
    stops = [(kk, px, a) for kk, px, a in DENSE_STOPS if kk < k]
    counts = DENSE_COUNTS + [k] * (len(stops) + 4)
    t = len(counts)
    r = np.random.default_rng(seed)
    src = np.zeros((t, k, 8), np.float32)
    src[..., 0] = r.uniform(0.004, 0.05, (t, k))
    src[..., 2] = r.uniform(0.004, 0.05, (t, k))
    src[..., 1] = r.uniform(-0.5, 0.5, (t, k)) * np.sqrt(
        src[..., 0] * src[..., 2])
    src[..., 3:5] = r.uniform(-6.0, 22.0, (t, k, 2))
    src[..., 5] = np.log(r.uniform(0.004, 0.02, (t, k)))
    src[..., 6] = 1.0
    stop_rows = []
    for i, (kk, px, alpha) in enumerate(stops):
        row = len(DENSE_COUNTS) + i
        peak = [0.0, 0.0, 0.0, 0.0, 0.0] if px is None else \
            [2.0, 0.0, 2.0, 3.5, 7.5]
        src[row, kk - 1:kk + 1, :6] = peak + [np.log(alpha)]
        stop_rows.append((row, kk, px))
    t_in = r.uniform(0.5, 1.0, (t, 256)).astype(np.float32)
    sat = len(DENSE_COUNTS) + len(stops)
    t_in[sat] = 5e-5
    t_in[sat + 1] = 0.0
    t_in[sat + 2] = np.float32(1e-4) * (1 - 2 ** -20)
    t_in[sat + 3, 128:] = 5e-5
    g = r.uniform(-1, 1, (t, 256)).astype(np.float32)
    total = r.uniform(0, 1, (t, 256)).astype(np.float32)
    zero = torch.zeros(t * k)
    feats = segpair.build_pair_features(
        torch.from_numpy(src.reshape(-1, 8)), zero, zero).reshape(t, k, 8)
    return (feats.contiguous(), torch.tensor(counts, dtype=torch.int32),
            torch.from_numpy(t_in), torch.from_numpy(g),
            torch.from_numpy(total),
            {"stops": stop_rows, "saturated": [sat, sat + 1, sat + 2]})


def _dense_both(feats, counts, basis, t_in, g, total):
    """(img, t_out, dfeats) of the dense kernels."""
    img, t_out = raster_v2.composite_fwd_seg(feats, counts, basis, t_in)
    d = raster_v2.composite_bwd_seg(feats, counts, basis, g, t_in, total)
    return img, t_out, d


def _check_dense(got, feats, counts, basis, t_in, g, total):
    """The dense kernels' (img, t_out, dfeats) against the plain versions:
    image atol 1e-5, t_out rtol 1e-5 where the plain value is >= 1e-4 and
    below 1e-4 where it is, dfeats 1e-5 of max-abs; exact zeros in
    columns 6-7 and past each row's count."""
    img, t_out, d = got
    img_r, tout_r = raster_v2.composite_fwd_seg_ref(feats, counts, basis,
                                                    t_in)
    torch.testing.assert_close(img, img_r, rtol=0, atol=1e-5)
    live = tout_r >= 1e-4
    torch.testing.assert_close(t_out[live], tout_r[live], rtol=1e-5,
                               atol=1e-7)
    assert bool((t_out[~live] < 1e-4).all())
    d_r = raster_v2.composite_bwd_seg_ref(feats, counts, basis, g, t_in,
                                          total)
    scale = float(d_r.abs().max())
    assert scale > 0
    torch.testing.assert_close(d, d_r, rtol=0, atol=1e-5 * scale)
    past = (torch.arange(feats.shape[1], device=feats.device)[None, :]
            >= counts[:, None])
    assert bool((d[past] == 0).all()) and bool((d[..., 6:] == 0).all())


@pytest.mark.parametrize("with_t_in", [False, True])
@pytest.mark.parametrize("k", DENSE_KS)
def test_raster_v2_kernels_on_counts_stops_and_entries(device, k,
                                                       with_t_in):
    """Both dense kernels against their plain versions at K = 16, 48, 128
    and 640: counts around the 16-slot groups and the 64- and 128-slot
    batches, above K and negative; a pixel, or every pixel, stopping on
    the last or first slot of a group or of a batch, or inside a batch
    (checked on the plain version's transmittance); with t_in, rows whose
    every pixel enters below 1e-4 (the image 0, t_out = t_in, dfeats 0)
    and a row where half the pixels do. Rows with no live slot write a
    zero image and t_out = t_in; every slot after a stop of every pixel
    gets exact zero dfeats. Two launches give the same bits."""
    feats, counts, t_in, g, total, rows = (
        x.to(device) if torch.is_tensor(x) else x for x in _dense_frame(k))
    if not with_t_in:
        t_in = None
    basis = tiles.pixel_basis(16, device=device)
    got = _dense_both(feats, counts, basis, t_in, g, total)
    again = _dense_both(feats, counts, basis, t_in, g, total)
    torch.cuda.synchronize()
    _check_dense(got, feats, counts, basis, t_in, g, total)
    assert all(map(torch.equal, got, again))
    img, t_out, d = got
    entered = torch.ones_like(img) if t_in is None else t_in
    empty = counts <= 0
    assert bool((img[empty] == 0).all())
    assert torch.equal(t_out[empty], entered[empty])
    if t_in is not None:
        sat = rows["saturated"]
        assert bool((img[sat] == 0).all()) and bool((d[sat] == 0).all())
        assert torch.equal(t_out[sat], t_in[sat])
    t0 = entered if t_in is None else t_in
    _, _, t_inc = raster_v2._chunk_alpha(feats, counts, basis, t0)
    keep = t_inc >= 1e-4
    slot = torch.arange(k, device=device)
    for row, kk, pixel in rows["stops"]:
        pixels = [pixel] if pixel is not None else list(range(256))
        for p in pixels:
            stopped = ~keep[row, :, p] & (slot < counts[row])
            assert int(stopped.float().argmax()) == kk and bool(stopped[kk])
        if pixel is None:
            assert bool((d[row, kk:] == 0).all())


@pytest.mark.parametrize("k", [128, 640])
def test_raster_v2_kernels_on_a_misaligned_feats(device, k):
    """feats starting 4 bytes past a 16-byte boundary: both kernels take
    the 4-byte staging path and agree with their plain versions and with
    the aligned launch bit for bit."""
    feats, counts, t_in, g, total, _ = (
        x.to(device) if torch.is_tensor(x) else x for x in _dense_frame(k, 1))
    basis = tiles.pixel_basis(16, device=device)
    odd = _misaligned(feats)
    got = _dense_both(odd, counts, basis, t_in, g, total)
    torch.cuda.synchronize()
    _check_dense(got, odd, counts, basis, t_in, g, total)
    assert all(map(torch.equal, got,
                   _dense_both(feats, counts, basis, t_in, g, total)))


@pytest.mark.parametrize("k", [128, 640])
def test_raster_v2_kernels_write_every_element(device, monkeypatch, k):
    """torch.empty and torch.empty_like returning NaNs: every element of
    img, t_out and dfeats is still written (the zeros of rows and slots the
    walk never reaches included)."""
    feats, counts, t_in, g, total, _ = (
        x.to(device) if torch.is_tensor(x) else x for x in _dense_frame(k, 2))
    basis = tiles.pixel_basis(16, device=device)
    for name in ("empty", "empty_like"):
        alloc = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _alloc=alloc, **kw:
                            _alloc(*a, **kw).fill_(float("nan")))
    got = _dense_both(feats, counts, basis, t_in, g, total)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _check_dense(got, feats, counts, basis, t_in, g, total)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_raster_v2_wrappers_launch_one_kernel_per_call(device, kernel):
    """Each call of a dense wrapper launches its kernel and nothing else:
    the backward folds the cotangent g * (1 - total) in the kernel
    (counted on the host's launch records: _check_one_kernel_per_call)."""
    feats, counts, t_in, g, total, _ = (
        x.to(device) if torch.is_tensor(x) else x for x in _dense_frame(48))
    basis = tiles.pixel_basis(16, device=device)
    if kernel == "fwd":
        def call():
            raster_v2.composite_fwd_seg(feats, counts, basis, t_in)
    else:
        def call():
            raster_v2.composite_bwd_seg(feats, counts, basis, g, t_in, total)
    key = f"raster_v2_{kernel}"
    _check_one_kernel_per_call(call, raster_v2.launch_counts, key,
                               f"{key}_kernel")


# -- the v1 kernels' find, batches, t-free groups and stops -----------------

V1_GROUP = 16           # slots whose t-free terms the v1 kernels take at once
V1_BWD_BATCH = 64       # live slots per staged batch of csrc/raster_v1.cu's
V1_FWD_BATCH = 128      # backward and forward
V1_CHUNK = 1024         # slots whose markers its find reads at once
V1_KS = [16, 64, 300, 768, 770, V1_CHUNK + 76]     # the last: two chunks
V1_FRACS = [0.0, 0.02, 1.0]
# live counts that end the live list on and around group and batch edges
V1_EDGE_COUNTS = [1, V1_GROUP - 1, V1_GROUP, V1_GROUP + 1, V1_BWD_BATCH - 1,
                  V1_BWD_BATCH, V1_BWD_BATCH + 1, V1_FWD_BATCH - 1,
                  V1_FWD_BATCH, V1_FWD_BATCH + 1, 255, 256, 257]
# (position in the live list, pixel): two opaque slots at live positions
# e - 1 and e (alpha 0.995 on the pixel, or on every pixel for None), so
# that the pixel stops exactly at the e-th live slot
V1_STOPS = [(V1_GROUP - 1, None), (V1_GROUP, None), (V1_BWD_BATCH - 1, None),
            (V1_BWD_BATCH, None), (V1_FWD_BATCH - 1, None),
            (V1_FWD_BATCH, None), (256, None), (V1_GROUP, STOP_PIXEL),
            (V1_FWD_BATCH, STOP_PIXEL)]


def _spread(k, n):
    """n distinct slots of [0, k) spread evenly over it (markers between)."""
    return np.unique(np.linspace(0, k - 1, n).round().astype(int))


def _v1_frame(k, frac, seed=0):
    """(feats [T,K,8], g [T,256], rows) of a v1 frame at K = k: broad, faint
    Gaussians in tile-local coordinates (as _seg_fwd_features) in every
    slot, and the -1e30 marker on the dead ones. Four rows live at
    ``frac`` at random; for 0 < frac, a row per V1_EDGE_COUNTS entry n <= k
    with n live slots spread over it, and a row per V1_STOPS entry whose
    2 e + 2 live slots (all k if fewer) are spread over it, stopping at
    its e-th live slot; for frac > 0 also a saturated row, every slot live
    at alpha 0.5 on every pixel (every pixel stops at its 14th slot, 13).
    ``rows`` maps "stops" to [(row, slot, pixel)] (slot: the row's slot
    where the pixel stops) and "saturated" to that row."""
    r = np.random.default_rng(seed)
    live = [r.uniform(0, 1, k) < frac for _ in range(4)]
    stops, sat = [], None
    if frac > 0:
        for n in V1_EDGE_COUNTS:
            if n <= k:
                live.append(np.isin(np.arange(k), _spread(k, n)))
        for e, pixel in V1_STOPS:
            at = _spread(k, min(k, 2 * e + 2))
            if e < len(at):
                live.append(np.isin(np.arange(k), at))
                stops.append((len(live) - 1, at[e - 1], at[e], pixel))
        live.append(np.ones(k, bool))
        sat = len(live) - 1
    live = np.stack(live)
    t = live.shape[0]
    src = np.zeros((t, k, 8), np.float32)
    src[..., 0] = r.uniform(0.004, 0.05, (t, k))
    src[..., 2] = r.uniform(0.004, 0.05, (t, k))
    src[..., 1] = r.uniform(-0.5, 0.5, (t, k)) * np.sqrt(
        src[..., 0] * src[..., 2])
    src[..., 3:5] = r.uniform(-6.0, 22.0, (t, k, 2))
    src[..., 5] = np.log(r.uniform(0.004, 0.02, (t, k)))
    src[..., 6] = 1.0
    for row, k0, k1, pixel in stops:
        peak = [0.0] * 5 if pixel is None else [2.0, 0.0, 2.0, 3.5, 7.5]
        src[row, [k0, k1], :6] = peak + [np.log(0.995)]
    if sat is not None:
        src[sat, :, :6] = [0.0] * 5 + [np.log(0.5)]
    zero = torch.zeros(t * k)
    feats = segpair.build_pair_features(
        torch.from_numpy(src.reshape(-1, 8)), zero, zero).reshape(t, k, 8)
    feats[..., 5][torch.from_numpy(~live)] = -1e30
    g = torch.from_numpy(r.uniform(-1, 1, (t, 256)).astype(np.float32))
    return (feats.contiguous(), g,
            {"stops": [(row, k1, px) for row, _, k1, px in stops],
             "saturated": sat})


def _v1_both(feats, basis, g, total):
    """(img, dfeats) of the v1 kernels, the backward on ``total``."""
    return (raster_v1.composite_fwd(feats, basis),
            raster_v1.composite_bwd(feats, basis, g, total))


def _check_v1(got, feats, basis, g, total):
    """The v1 kernels' (img, dfeats) against the plain versions: image atol
    1e-5, dfeats 1e-4 of max-abs (exact zeros where the plain dfeats are
    all zero); exact zeros on every marked slot and in columns 6-7."""
    img, d = got
    torch.testing.assert_close(img, raster_v1.composite_fwd_ref(feats, basis),
                               rtol=0, atol=1e-5)
    d_r = raster_v1.composite_bwd_ref(feats, basis, g, total)
    scale = float(d_r.abs().max())
    torch.testing.assert_close(d, d_r, rtol=0, atol=1e-4 * scale)
    marked = ~raster_v1.live_slots(feats)
    assert bool((d[marked] == 0).all()) and bool((d[..., 6:] == 0).all())


@pytest.mark.parametrize("frac", V1_FRACS)
@pytest.mark.parametrize("k", V1_KS)
def test_raster_v1_kernels_on_live_lists_and_stops(device, k, frac):
    """Both v1 kernels against their plain versions at K = 16, 64, 300,
    768, 770 and 1100 (two chunks of the find) and live fractions 0, 0.02
    and 1: live lists ending on and around the 16-slot groups and the 64-
    and 128-slot batches, the markers between the live slots; a pixel, or
    every pixel, stopping on the last or first live slot of a group or a
    batch (checked on the plain version's log transmittance); a row of
    every slot live (K = 768: the longest walk), and a saturated one. Rows
    with no live slot give a zero image and zero dfeats; every slot after
    a stop of every pixel gets exact zero dfeats. Two launches give the
    same bits."""
    feats, g, rows = (x.to(device) if torch.is_tensor(x) else x
                      for x in _v1_frame(k, frac))
    basis = tiles.pixel_basis(16, device=device)
    total = raster_v1.composite_fwd_ref(feats, basis)
    got = _v1_both(feats, basis, g, total)
    again = _v1_both(feats, basis, g, total)
    torch.cuda.synchronize()
    _check_v1(got, feats, basis, g, total)
    assert all(map(torch.equal, got, again))
    img, d = got
    dead = (~raster_v1.live_slots(feats)).all(dim=1)
    assert bool((img[dead] == 0).all()) and bool((d[dead] == 0).all())
    if frac == 0.0:
        assert bool(dead.all())
    if frac == 1.0:                         # the random rows: all live
        assert bool(raster_v1.live_slots(feats[:4]).all())
    _, _, keep, _ = raster_v1._chunk_terms(feats, basis)
    slot = torch.arange(k, device=device)
    for row, at, pixel in rows["stops"]:
        for p in [pixel] if pixel is not None else range(256):
            stopped = ~keep[row, :, p] & raster_v1.live_slots(feats)[row]
            assert int(stopped.float().argmax()) == at
        if pixel is None:
            assert bool((d[row, at:] == 0).all())
    if rows["saturated"] is not None:
        s = rows["saturated"]
        assert bool(keep[s, :13].all()) and bool((~keep[s, 13:]).all())
        assert bool((d[s, 13:] == 0).all())
        assert float(img[s].min()) > 0.999 - 1e-4


@pytest.mark.parametrize("k", [768, 1100])
def test_raster_v1_kernels_on_a_misaligned_feats(device, k):
    """feats starting 4 bytes past a 16-byte boundary: both kernels gather
    the live slots with 4-byte copies and agree with their plain versions
    and with the aligned launch bit for bit."""
    feats, g, _ = (x.to(device) if torch.is_tensor(x) else x
                   for x in _v1_frame(k, 0.02, 1))
    basis = tiles.pixel_basis(16, device=device)
    total = raster_v1.composite_fwd_ref(feats, basis)
    odd = _misaligned(feats)
    got = _v1_both(odd, basis, g, total)
    torch.cuda.synchronize()
    _check_v1(got, odd, basis, g, total)
    assert all(map(torch.equal, got, _v1_both(feats, basis, g, total)))


@pytest.mark.parametrize("k", [768, 1100])
def test_raster_v1_kernels_write_every_element(device, monkeypatch, k):
    """torch.empty and torch.empty_like returning NaNs: every element of
    img and dfeats is still written (the zeros of marked slots, of live
    slots past every pixel's stop and of chunks the walk never reaches
    included)."""
    feats, g, _ = (x.to(device) if torch.is_tensor(x) else x
                   for x in _v1_frame(k, 0.02, 2))
    basis = tiles.pixel_basis(16, device=device)
    total = raster_v1.composite_fwd_ref(feats, basis)
    for name in ("empty", "empty_like"):
        alloc = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _alloc=alloc, **kw:
                            _alloc(*a, **kw).fill_(float("nan")))
    got = _v1_both(feats, basis, g, total)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _check_v1(got, feats, basis, g, total)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_raster_v1_wrappers_launch_one_kernel_per_call(device, kernel):
    """Each call of a v1 wrapper launches its kernel and nothing else: no
    zero fill of dfeats beside it (counted on the host's launch records:
    _check_one_kernel_per_call)."""
    feats, g, _ = (x.to(device) if torch.is_tensor(x) else x
                   for x in _v1_frame(300, 0.02))
    basis = tiles.pixel_basis(16, device=device)
    if kernel == "fwd":
        def call():
            raster_v1.composite_fwd(feats, basis)
    else:
        total = raster_v1.composite_fwd_ref(feats, basis)

        def call():
            raster_v1.composite_bwd(feats, basis, g, total)
    key = f"raster_v1_{kernel}"
    _check_one_kernel_per_call(call, raster_v1.launch_counts, key,
                               f"{key}_kernel")


# -- the v4 pair kernels' batches, groups, stops and pads -------------------

# run lengths around the 16-pair groups, the backward's 64-pair and the
# forward's 128-pair batches, up to the 768 cap
PAIR_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 300, 768]
# (run lengths, stops): a stop (row, k) makes every pixel of the row stop
# at its pair k, on and around group and batch edges
PAIR_SHAPES = {
    "lengths": (PAIR_LENGTHS, []),
    "empty": ([0, 5, 0, 0, 129, 0, 1], []),
    "stops": ([300, 200, 768, 64, 129, 70],
              [(0, 16), (1, 64), (2, 129), (3, 1), (4, 128), (5, 65)]),
}
PAIR_PADS = (3, 0, 77, 1)    # pad rows after each run, in turn


def _pair_shape(name, seed=0):
    """(feats [B,8], sfp [R] int32, counts [R] int32, walked [B] bool,
    stops) of PAIR_SHAPES[name]: runs of faint broad pairs (as the seg
    forward's tests), which pixels walk to the end unless stopped; each
    run followed by pad rows holding an opaque Gaussian over the whole
    tile, which a walk past counts[r] would show in the image; at each
    stop (row, k) two opaque pairs at k - 1 and k (alpha 0.995 on every
    pixel)."""
    counts, stops = PAIR_SHAPES[name]
    r = np.random.default_rng(seed)
    pads = np.resize(np.asarray(PAIR_PADS), len(counts))
    starts = np.concatenate([[0], np.cumsum(np.asarray(counts) + pads)])
    b = int(starts[-1]) + 5
    src = np.zeros((b, 8), np.float32)
    src[:, 0] = r.uniform(0.004, 0.05, b)
    src[:, 2] = r.uniform(0.004, 0.05, b)
    src[:, 1] = r.uniform(-0.5, 0.5, b) * np.sqrt(src[:, 0] * src[:, 2])
    src[:, 3:5] = r.uniform(-6.0, 22.0, (b, 2))
    src[:, 5] = np.log(r.uniform(0.004, 0.02, b))
    walked = np.zeros(b, bool)
    for s0, n in zip(starts[:-1], counts):
        walked[s0:s0 + n] = True
    src[~walked, :6] = [0.0, 0.0, 0.0, 8.0, 8.0, np.log(0.99)]
    for row, k in stops:
        at = starts[row] + k
        src[at - 1:at + 1, :6] = [0.0, 0.0, 0.0, 0.0, 0.0, np.log(0.995)]
    zero = torch.zeros(b)
    feats = segpair.build_pair_features(torch.from_numpy(src), zero, zero)
    return (feats.contiguous(), torch.from_numpy(starts[:-1].astype(np.int32)),
            torch.from_numpy(np.asarray(counts, np.int32)),
            torch.from_numpy(walked), stops)


def _pair_shape_on(name, device, seed=0):
    return tuple(x.to(device) if torch.is_tensor(x) else x
                 for x in _pair_shape(name, seed))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", list(PAIR_SHAPES))
def test_pair_kernels_on_batches_stops_and_pads(device, name, aligned):
    """Both v4 kernels against their plain versions (image atol 1e-5,
    dfeats 1e-4 of max-abs) on runs of every length around the groups and
    batches, empty runs, pad rows of real (opaque) features after every
    run that must not be read, rows whose every pixel stops on a group or
    batch edge (checked on the plain version's transmittance; the rows
    past the stop exactly zero), and a feats view that is not 16-byte
    aligned (the 4-byte staging path). Two launches give the same bits."""
    feats, sfp, counts, walked, stops = _pair_shape_on(name, device)
    if not aligned:
        feats = _misaligned(feats)
    basis = tiles.pixel_basis(16, device=device)
    img = pair.pair_fwd(feats, sfp, counts, basis)
    again = pair.pair_fwd(feats, sfp, counts, basis)
    torch.cuda.synchronize()
    ref = pair.pair_fwd_ref(feats, sfp, counts, basis)
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-5)
    assert torch.equal(img, again)
    assert bool((img[counts == 0] == 0).all())
    gen = torch.Generator(device=device).manual_seed(1)
    g = torch.rand((sfp.shape[0], 256), generator=gen, device=device) - 0.5
    d = pair.pair_bwd(feats, sfp, counts, basis, g, ref)
    d_again = pair.pair_bwd(feats, sfp, counts, basis, g, ref)
    torch.cuda.synchronize()
    d_r = pair.pair_bwd_ref(feats, sfp, counts, basis, g, ref)
    assert torch.equal(d[walked].view(torch.int32),
                       d_again[walked].view(torch.int32))
    scale = float(d_r.abs().max())
    assert scale > 0
    torch.testing.assert_close(d[walked], d_r[walked], rtol=0,
                               atol=1e-4 * scale)
    assert bool((d[walked][:, 6:] == 0).all())
    maxrun = int(counts.max())
    _, _, _, keep, _, slot_valid = segpair.run_alpha(feats, sfp, counts,
                                                     basis, maxrun)
    for row, k in stops:
        stopped = (~keep[row]) & slot_valid[row][:, None]     # [M,256]
        assert bool((stopped.float().argmax(0) == k).all())
        s0, n = int(sfp[row]), int(counts[row])
        assert bool((d[s0 + k:s0 + n] == 0).all())
        assert bool((d_r[s0 + k:s0 + n] == 0).all())


def test_pair_kernels_write_every_row_of_a_run_and_no_pad(device,
                                                          monkeypatch):
    """torch.empty and torch.empty_like returning NaNs: every image row
    (empty runs' zeros included) and every dfeats row inside a run (zeros
    past the stops included) is written; pad rows and the tail stay as
    allocated, since the caller masks them by pair validity."""
    feats, sfp, counts, walked, _ = _pair_shape_on("stops", device)
    basis = tiles.pixel_basis(16, device=device)
    g = torch.ones((sfp.shape[0], 256), device=device)
    total = pair.pair_fwd_ref(feats, sfp, counts, basis)
    for name in ("empty", "empty_like"):
        alloc = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _alloc=alloc, **kw:
                            _alloc(*a, **kw).fill_(float("nan")))
    img = pair.pair_fwd(feats, sfp, counts, basis)
    d = pair.pair_bwd(feats, sfp, counts, basis, g, total)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())
    assert bool(torch.isfinite(d[walked]).all())
    assert bool(torch.isnan(d[~walked]).all())


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_pair_wrappers_launch_one_kernel_per_call(device, kernel):
    """Each call of a v4 pair wrapper launches its kernel and nothing else
    (counted on the host's launch records: _check_one_kernel_per_call)."""
    feats, sfp, counts, _, _ = _pair_shape_on("lengths", device)
    basis = tiles.pixel_basis(16, device=device)
    if kernel == "fwd":
        def call():
            pair.pair_fwd(feats, sfp, counts, basis)
    else:
        g = torch.ones((sfp.shape[0], 256), device=device)
        total = pair.pair_fwd_ref(feats, sfp, counts, basis)

        def call():
            pair.pair_bwd(feats, sfp, counts, basis, g, total)
    # the forward is compositor.cuh's run_fwd_kernel, shared with the seg
    # forward
    key = f"pair_{kernel}"
    _check_one_kernel_per_call(call, pair.launch_counts, key,
                               {"fwd": "run_fwd_kernel",
                                "bwd": "pair_bwd_kernel"}[kernel])


# -- the deterministic per-Gaussian row sum ----------------------------------

# (seed, rows, outputs): collisions; the seg path's budget at the ABC
# capacity; a dense two-level frame's slot count; no rows at all
RANK_SUM_CASES = [(0, 4000, 300), (1, 49152, 16384), (2, 401920, 16384),
                  (3, 0, 16)]


@pytest.mark.parametrize("order", ["random", "reverse", "shuffled"])
@pytest.mark.parametrize("seed,b,n", RANK_SUM_CASES)
def test_rank_sum_kernel_is_the_cpu_plain_version_bit_for_bit(device, seed,
                                                              b, n, order):
    """The kernel adds each output's rows in row order, as the CPU's
    index_add_ does, so it gives the plain version's bits on the CPU, and
    the same bits on a second launch; the plain version on the card
    (index_add_ atomics) agrees within 1e-5 of its max-abs."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    from test_torch_rank_sum import _case
    rows, idx, valid = _case(seed, b, n, order=order)
    cpu = rs.rank_sum(rows, idx, n, valid)
    before = rs.launch_counts["rank_sum"]
    got = rs.rank_sum(rows.to(device), idx.to(device), n, valid.to(device))
    again = rs.rank_sum(rows.to(device), idx.to(device), n,
                        valid.to(device))
    torch.cuda.synchronize()
    assert rs.launch_counts["rank_sum"] == before + 2
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    plain = rs.rank_sum_ref(rows.to(device), idx.to(device), n,
                            valid.to(device))
    scale = max(float(cpu.abs().max()) if b else 0.0, 1e-30)
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dead", [0.0, 0.85])
def test_gather_rows_backward_is_the_cpu_sum_of_x_idx_autograd(device, dead):
    """``gather_rows`` (the direction loss's neighbour gather) on the card:
    the forward is ``x[idx]``; the backward, one ``rank_sum_gather``
    launch, gives the CPU's bits (row order, every row: the all-zero rows
    the kernel path drops change no bit) and a second backward's, and is
    within 1e-5 of max-abs of autograd's backward of ``x[idx]`` on the
    card. The indices are int64 [N, 5] and skewed as the direction loss's
    are: the rows marked dead (cotangent exactly +0 or -0, as the loss's
    dead query rows give) all name the same 5 rows."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    n, m = 16384, 5
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    idx = torch.from_numpy(r.integers(0, n, (n, m)))
    is_dead = torch.from_numpy(r.uniform(size=n) < dead)
    idx[is_dead] = torch.arange(5)
    g = torch.from_numpy(r.normal(size=(n, m, 3)).astype(np.float32))
    g[is_dead] = torch.where(torch.from_numpy(r.uniform(size=(n, m, 3))
                                              < 0.5)[is_dead], 0.0, -0.0)

    def grad(dev, fn):
        xd = x.to(dev).requires_grad_()
        y = fn(xd, idx.to(dev))
        (dx,) = torch.autograd.grad(y, [xd], g.to(dev))
        return y, dx

    y_cpu, cpu = grad("cpu", rs.gather_rows)
    before = dict(rs.launch_counts)
    y, got = grad(device, rs.gather_rows)
    _, again = grad(device, rs.gather_rows)
    torch.cuda.synchronize()
    assert rs.launch_counts == dict(before, rank_sum_gather=before[
        "rank_sum_gather"] + 2)
    assert torch.equal(y.cpu(), x[idx])
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _, aten = grad(device, lambda a, i: a[i])
    scale = float(cpu.abs().max())
    torch.testing.assert_close(got, aten, rtol=0, atol=1e-5 * scale)


def _same_bits(a, b):
    """The same bits, but where both are NaN (the card's adds give the
    canonical NaN, the CPU's keep the payload of the NaN they add)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def _edge_call(name, device):
    """(the CPU plain version's sum, a call of the kernel on the card, the
    job it counts under) of tests/test_torch_rank_sum.py's edge case."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    from test_torch_rank_sum import _edge_case
    rows, idx, n, valid, drop_zero = _edge_case(name)
    if drop_zero:
        return (rs.gather_backward(rows, idx, n),
                lambda: rs.gather_backward(rows.to(device), idx.to(device), n),
                "rank_sum_gather")
    dev = [x.to(device) for x in (rows, idx, valid)]
    return (rs.rank_sum(rows, idx, n, valid),
            lambda: rs.rank_sum(*dev[:2], n, dev[2]), "rank_sum")


@pytest.mark.parametrize("name", ["one_key_5000", "medium_runs", "n_one",
                                  "all_dropped", "empty",
                                  "gather_zeros_nan"])
def test_rank_sum_kernel_on_long_runs_and_empty_inputs(device, name):
    """The edge cases of tests/test_torch_rank_sum.py on the card: a run of
    5000 rows (sorted in the global workspace), runs of ~130 (in shared
    memory), one output, every row dropped, no rows, and the gather's
    all-zero and NaN rows (dropped and kept in the kernel): the CPU plain
    version's bits (NaN as NaN), the same bits from two launches, one
    count a call."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    cpu, call, job = _edge_call(name, device)
    before = rs.launch_counts[job]
    got, again = call(), call()
    torch.cuda.synchronize()
    assert rs.launch_counts[job] == before + 2
    assert got.shape == cpu.shape
    assert _same_bits(got, cpu), name
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_rank_sum_workspace_follows_n_and_b_up_and_down(device):
    """Calls back to back with n 16384 -> 131072 -> 16384 and the rows
    49152 -> 196608 -> 4000 -> 49152, as staged capacity and the other
    jobs interleave them: each the CPU plain version's bits, so no count
    or total is left over from a call before it."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    from test_torch_rank_sum import _case
    for seed, (b, n) in enumerate([(49152, 16384), (196608, 131072),
                                   (4000, 16384), (49152, 16384),
                                   (196608, 131072)]):
        rows, idx, valid = _case(20 + seed, b, n)
        cpu = rs.rank_sum(rows, idx, n, valid)
        got = rs.rank_sum(rows.to(device), idx.to(device), n,
                          valid.to(device))
        assert torch.equal(got.cpu().view(torch.int32),
                           cpu.view(torch.int32)), (b, n)


@pytest.mark.parametrize("job", ["rank_sum", "rank_sum_gather"])
def test_rank_sum_launches_at_most_four_kernels_a_call(device, job):
    """Ten calls in one torch.profiler window: one count a call under the
    job, at most 4 host launch records a call and no memset or memcpy (no
    sort, no fill of the output), and every device record that comes
    through is one of the row sum's stages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from edgegaussians_tpu_torch.ops import rank_sum as rs
    from test_torch_rank_sum import _case
    rows, idx, valid = (x.to(device) for x in _case(1, 49152, 16384))
    rows3 = rows[:, :3].contiguous()
    if job == "rank_sum":
        def call():
            rs.rank_sum(rows, idx, 16384, valid)
    else:
        def call():
            rs.gather_backward(rows3, idx, 16384)
    call()
    torch.cuda.synchronize()
    calls = 10
    before = rs.launch_counts[job]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    assert rs.launch_counts[job] == before + calls
    on_host = [e.name for e in prof.events()
               if e.device_type != DeviceType.CUDA]
    launches = [n for n in on_host if "LaunchKernel" in n]
    moves = [n for n in on_host if "Memset" in n or "Memcpy" in n]
    assert len(launches) <= 4 * calls and not moves, (launches, moves)
    on_device = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    assert len(on_device) <= 4 * calls, on_device
    assert all(any(k in name for k in rs.STAGES) for name in on_device), \
        on_device


def test_rank_sum_wrapper_checks_inputs(device):
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    rows = torch.ones((10, 10), device=device)
    idx = torch.zeros(10, dtype=torch.int64, device=device)
    with pytest.raises(TypeError):
        rs.rank_sum(rows.double(), idx, 4)
    with pytest.raises(ValueError):
        rs.rank_sum(rows.t(), idx, 4)
    with pytest.raises(ValueError):
        rs.rank_sum(rows, idx[:5], 4)
    with pytest.raises(ValueError):
        rs.rank_sum(rows, idx.cpu(), 4)


def _render_case(path, device):
    """(render(packed_sorted, sink) -> image, packed_sorted, ranks of the
    pairs or slots) of the cluster scene on one of the compositor paths
    whose backward ends in the row sum."""
    from edgegaussians_tpu_torch.ops import composite
    arrays = [torch.from_numpy(a).to(device)
              for a in _scene(**SCENES["cluster"][0])]
    with torch.no_grad():
        proj = project_gaussians(*arrays, W, H)
        packed = tiles.pack_gaussian_render_data(proj)
    origins = tiles.tile_origins(W, H, 16, device=device)
    basis = tiles.pixel_basis(16, device=device)
    if path == "two_level":
        bins2 = tiles.bin_gaussians_two_level(proj, W, H, 16, 16, 64, 4,
                                              occupancy_sort=True)
        origins_f = origins[bins2.tile_perm]
        ranks = torch.cat([bins2.ranks1[bins2.counts1[:, None] > torch.arange(
            16, device=device)], bins2.ranks2[bins2.counts2[:, None]
                                              > torch.arange(64,
                                                             device=device)]])
        return (lambda p, s: composite.TileRenderTwoLevel.apply(
            p, bins2, origins_f, basis, s), packed[bins2.order], ranks)
    pb = tiles.bin_pairs_frame_order(
        proj, W, H, 16, 512, 2048,
        block_tiles=pair.BLOCK_TILES if path == "pair_v4" else 0)
    fn = pair.PairRender if path == "pair_v4" else segpair.SegpairRender
    return (lambda p, s: fn.apply(p, pb, origins, basis, s),
            packed[pb.order], pb.pair_ranks[pb.pair_valid])


@pytest.mark.parametrize("path", ["seg", "pair_v4", "two_level"])
def test_backward_row_sums_are_bit_equal_across_launches(device, path):
    """Two backward passes of SegpairRender, PairRender and the two-level
    render on the same inputs give the same dpacked and dsink bits: the
    per-Gaussian sums of rows that collide on one rank (checked: some
    Gaussians have several) run through the row-sum kernel, one launch a
    backward, with no atomics."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    render, packed_sorted, ranks = _render_case(path, device)
    assert int(torch.bincount(ranks).max()) > 1
    n = packed_sorted.shape[0]

    def grads():
        p = packed_sorted.clone().requires_grad_()
        sink = torch.zeros((n, 2), device=device, requires_grad=True)
        img = render(p, sink)
        w = (torch.arange(img.numel(), device=device, dtype=torch.float32)
             .reshape(img.shape) % 7) / 7.0 + 0.3
        return torch.autograd.grad((img * w).sum(), [p, sink])

    before = rs.launch_counts["rank_sum"]
    first, second = grads(), grads()
    torch.cuda.synchronize()
    assert rs.launch_counts["rank_sum"] == before + 2
    for a, b in zip(first, second):
        assert float(a.abs().max()) > 0
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
