"""Per-stage timing of the rasterization hot path on the card.

The port's counterpart of ``scripts/profile_stages.py``: times each
pipeline stage of one forward + backward render on the bench workload
shape, so kernel work targets the real bottleneck. The stages are the JAX
script's, one for one, on the dense two-level path at its settings
(projection, the fused-key sort, the binning, the row gathers, the dense
kernels of both levels, the backward scatter, the composite, the full
step); with ``--fixture`` also the shipped recipe's seg path
(``configs/ABC_DexiNed.json``: cap 768, budget 49152), the port's real
hot path: the pair tables, the pair features, the seg kernels, the row
sum, the image assembly and the full seg step.

Each stage reports ``ms`` (CUDA events, median of 3 blocks), ``device_ms``
(its calls queued behind a sleeping kernel, or, for a call of more
launches than a stream holds pending, the profiler's device time),
``launches`` (host launch records per call) and ``kernels`` (the port's
kernel launches per call); see ``torch_common.measure``. The last line
is one JSON object. :func:`scene` cuts the fixture (``max_n``, ``size``)
for a run on the CPU, as the tests call it.

Usage: python scripts/torch_profile_stages.py [n_gaussians] [k1] [t2]
       python scripts/torch_profile_stages.py --fixture   # real ABC workload
       [--device cuda|cpu] [--reps N]

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` runs the plain versions on the CPU. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from torch_common import FIXTURE, RECIPE, card, measure, resolve_device

from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.ops import segpair
from edgegaussians_tpu_torch.ops import tiles as tiles_mod
from edgegaussians_tpu_torch.ops.composite import (
    TileRenderTwoLevel, scatter_slot_grads)
from edgegaussians_tpu_torch.ops.projection import project_gaussians
from edgegaussians_tpu_torch.ops.raster_v2 import (
    composite_bwd_seg, composite_fwd_seg)
from edgegaussians_tpu_torch.ops.rasterize import rasterize
from edgegaussians_tpu_torch.ops.tiles import (
    bin_gaussians_two_level, build_tile_features, pixel_basis,
    tile_origins)
from edgegaussians_tpu_torch.train.trainer import render_settings

WIDTH = HEIGHT = 800
TILE = 16
CAP, M = 512, 64
FIXTURE_SETTINGS = dict(cap=768, k1=128, t2=128, m=16)
# each kernel stage and the port's kernels it launches a call
STAGE_KERNELS = {
    "pallas fwd L1 kernel": {"raster_v2_fwd": 1},
    "pallas fwd L2 kernel": {"raster_v2_fwd": 1},
    "pallas bwd L1 kernel": {"raster_v2_bwd": 1},
    "pallas bwd L2 kernel": {"raster_v2_bwd": 1},
    "backward scatter": {"rank_sum": 1},
    "seg: segpair_fwd kernel": {"segpair_fwd": 1},
    "seg: segpair_bwd kernel": {"segpair_bwd": 1},
    "seg: pair_grads_to_packed (row sum)": {"rank_sum": 1},
}


def scene(fixture: bool, n: int = 20000, max_n: int = 0, size: int = 0):
    """The JAX script's inputs as NumPy arrays, and its generator for the
    sort stage's keys: the fixture's camera 0 (its first ``max_n``
    Gaussians when given, its intrinsics scaled to ``size`` x ``size``
    when given), or ``n`` random Gaussians at 800x800, f = 1111."""
    r = np.random.default_rng(0)
    if fixture:
        d = np.load(FIXTURE)
        cut = slice(0, max_n or None)
        w, h = int(d["width"]), int(d["height"])
        K = d["Ks"][0].astype(np.float32).copy()
        if size:
            K[:2] *= size / w
            w = h = size
        return dict(means=d["means"][cut], quats=d["quats"][cut],
                    scales=d["scales"][cut],
                    opac=d["opacities"].reshape(-1)[cut], K=K,
                    viewmat=d["viewmats"][0], width=w, height=h), r
    means = (r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
             + np.array([0, 0, 2.0], np.float32))
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.003), np.log(0.03),
                              (n, 3))).astype(np.float32)
    opac = r.uniform(0.2, 0.95, n).astype(np.float32)
    f = 1111.0
    K = np.array([[f, 0, WIDTH / 2], [0, f, HEIGHT / 2], [0, 0, 1]],
                 np.float32)
    return dict(means=means, quats=quats, scales=scales, opac=opac, K=K,
                viewmat=np.eye(4, dtype=np.float32), width=WIDTH,
                height=HEIGHT), r


def on_device(sc: dict, device) -> dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v, np.float32))
                .to(device) if isinstance(v, np.ndarray) else v)
            for k, v in sc.items()}


def l1_to_zero(image: torch.Tensor) -> torch.Tensor:
    """The JAX script's loss: mean |clip(image, 0, 1) - 0|."""
    return torch.mean(torch.abs(torch.clamp(image, 0, 1)))


def full_step(sc: dict, **render_kw):
    """Loss and the four groups' gradients of one render with
    ``render_kw`` (the JAX script's ``FULL fwd+bwd step``)."""
    params = [sc[k].detach().requires_grad_()
              for k in ("means", "quats", "scales", "opac")]

    def step():
        out = rasterize(*params, sc["viewmat"], sc["K"], sc["width"],
                        sc["height"], tile_size=TILE, **render_kw)
        loss = l1_to_zero(out.image)
        return (loss.detach(),) + torch.autograd.grad(loss, params)
    return step


def timed(stages: dict, label: str, fn, device, reps: int):
    """Measure ``fn`` into ``stages[label]``, print it and return the
    last call's output."""
    res, out = measure(fn, device, reps)
    stages[label] = res
    dev = res["device_ms"]
    print(f"{label:44s} {res['ms']:8.3f} ms  device "
          + ("-" if dev is None else f"{dev:.3f}") + " ms  launches "
          + ("-" if res["launches"] is None else f"{res['launches']:.0f}")
          + (f"  {res['kernels']}" if res["kernels"] else ""), flush=True)
    return out



def dense_stages(sc: dict, r, cap: int, k1: int, t2: int, m: int, device,
                 reps: int = 10):
    """The JAX script's stages on the dense two-level path: (stages by
    the JAX labels, the binning's counts, the full step's loss and
    gradients)."""
    W, H = sc["width"], sc["height"]
    means, quats, scales, opac = (sc[k] for k in
                                  ("means", "quats", "scales", "opac"))
    n = means.shape[0]
    vm, K = sc["viewmat"], sc["K"]
    num_tiles = tiles_mod.tile_grid(W, H, TILE)[2]
    t2 = t2 or max(num_tiles // 4, 8)
    k2 = cap - k1
    stages = {}

    # --- stage 1: projection fwd+bwd
    leaves = [x.detach().requires_grad_() for x in (means, quats, scales,
                                                     opac)]

    def proj_step():
        p = project_gaussians(*leaves, vm, K, W, H)
        loss = torch.sum(p.means2d * 1e-3) + torch.sum(p.conics) \
            + torch.sum(p.opacities)
        return torch.autograd.grad(loss, leaves)

    timed(stages, "projection fwd+bwd", proj_step, device, reps)

    # --- stage 2: binning pieces
    with torch.no_grad():
        proj = project_gaussians(means, quats, scales, opac, vm, K, W, H)
    _, _, counts, _, ntr = timed(
        stages, "binning: expand+sort+searchsorted",
        lambda: tiles_mod._sort_pairs(proj, W, H, TILE, m), device, reps)
    keys_flat = torch.from_numpy(
        r.integers(0, 2**30, n * m, dtype=np.int32)).to(device)
    timed(stages, "  torch.sort of N*M int32 alone",
          lambda: torch.sort(keys_flat), device, reps)
    bins2 = timed(stages, "binning TOTAL (incl. decode+topk)",
                  lambda: bin_gaussians_two_level(
                      proj, W, H, TILE, k1, k2, t2,
                      max_tiles_per_gaussian=m), device, reps)
    counts_out = {"pairs": int(counts.sum()),
                  "counts1_sum": int(bins2.counts1.sum()),
                  "counts2_sum": int(bins2.counts2.sum()),
                  "trunc": int(ntr)}
    print("    " + " ".join(f"{k}={v}" for k, v in counts_out.items()))

    # --- stage 3: gathers
    packed = tiles_mod.pack_gaussian_render_data(proj)
    packed_sorted = packed[bins2.order]
    g1, g2 = timed(stages, "row gathers [T,k1]+[t2,k2]",
                   lambda: (packed_sorted[bins2.ranks1],
                            packed_sorted[bins2.ranks2]), device, reps)
    origins = tile_origins(W, H, TILE, device=device)
    basis = pixel_basis(TILE, device=device)

    # --- stage 4: the composite kernels alone
    c1 = bins2.counts1.to(torch.int32)
    c2 = bins2.counts2.to(torch.int32)
    validf1 = (torch.arange(k1, device=device)[None, :]
               < c1[:, None]).to(torch.float32)
    feats1 = build_tile_features(g1, origins, validf1).contiguous()
    validf2 = (torch.arange(k2, device=device)[None, :]
               < c2[:, None]).to(torch.float32)
    feats2 = build_tile_features(g2, origins[bins2.ovf_ids],
                                 validf2).contiguous()
    with torch.no_grad():
        img1, tout1 = timed(stages, "pallas fwd L1 kernel",
                            lambda: composite_fwd_seg(feats1, c1, basis),
                            device, reps)
        tin2 = tout1[bins2.ovf_ids].contiguous()
        img2, _ = timed(stages, "pallas fwd L2 kernel",
                        lambda: composite_fwd_seg(feats2, c2, basis, tin2),
                        device, reps)
        images = img1.clone()
        images.index_add_(0, bins2.ovf_ids, img2)
        g_up = torch.ones_like(images)
        g_up2 = g_up[bins2.ovf_ids].contiguous()
        tot2 = images[bins2.ovf_ids].contiguous()
        timed(stages, "pallas bwd L1 kernel",
              lambda: composite_bwd_seg(feats1, c1, basis, g_up, None,
                                        images), device, reps)
        timed(stages, "pallas bwd L2 kernel",
              lambda: composite_bwd_seg(feats2, c2, basis, g_up2, tin2,
                                        tot2), device, reps)

    # --- stage 5: the backward scatter alone (the port's row sum)
    dg1, dg2 = g1 * 0.5, g2 * 0.5
    timed(stages, "backward scatter",
          lambda: scatter_slot_grads(
              [(dg1, validf1, bins2.ranks1), (dg2, validf2, bins2.ranks2)],
              bins2.order, n), device, reps)
    stages["backward scatter"]["rows"] = num_tiles * k1 + t2 * k2

    # --- stage 6: the full composite fwd+bwd (features, scatter)
    ps = packed_sorted.detach().requires_grad_()
    sink = torch.zeros((n, 2), device=device, requires_grad=True)

    def composite_step():
        img = TileRenderTwoLevel.apply(ps, bins2, origins, basis, sink,
                                       k1, k2)
        return torch.autograd.grad(torch.mean(torch.abs(img)), [ps, sink])

    timed(stages, "composite TOTAL fwd+bwd (feats+scatter)", composite_step,
          device, reps)

    # --- full step
    step = full_step(sc, capacity=cap, dense_capacity=k1, overflow_tiles=t2,
                     max_tiles_per_gaussian=m, pair_budget=0)
    full = timed(stages, "FULL fwd+bwd step", step, device, reps)
    return stages, counts_out, full


def seg_stages(sc: dict, device, reps: int = 10):
    """The shipped recipe's seg path, stage by stage: (stages, its pair
    counts, the full seg step's loss and gradients)."""
    cfg = load_config(RECIPE)
    rk = render_settings(cfg)
    W, H = sc["width"], sc["height"]
    means, quats, scales, opac = (sc[k] for k in
                                  ("means", "quats", "scales", "opac"))
    n = means.shape[0]
    cap = min(rk["capacity"], n)
    budget, m = rk["pair_budget"], rk["max_tiles_per_gaussian"]
    stages = {}
    with torch.no_grad():
        proj = project_gaussians(means, quats, scales, opac, sc["viewmat"],
                                 sc["K"], W, H,
                                 antialiased=rk["antialiased"])
        packed = tiles_mod.pack_gaussian_render_data(proj)
        origins = tile_origins(W, H, TILE, device=device)
        basis = pixel_basis(TILE, device=device)
        pb = timed(stages, "seg: tiles.bin_pairs_frame_order",
                   lambda: tiles_mod.bin_pairs_frame_order(
                       proj, W, H, TILE, cap, budget,
                       max_tiles_per_gaussian=m), device, reps)
        packed_sorted = packed[pb.order]

        def features():
            src, ox, oy = segpair.pair_inputs(packed_sorted, pb, origins)
            return (src, ox, oy,
                    segpair.build_pair_features(src, ox, oy).contiguous())

        src, ox, oy, feats = timed(
            stages, "seg: segpair.pair_inputs + pair features", features,
            device, reps)
        s_f = pb.s_f.to(torch.int32)
        img = timed(stages, "seg: segpair_fwd kernel",
                    lambda: segpair.segpair_fwd(feats, s_f, basis), device,
                    reps)
        gt = (1.0 - img).contiguous()         # g = 1 folded: g * (1 - img)
        dfeats = timed(stages, "seg: segpair_bwd kernel",
                       lambda: segpair.segpair_bwd(feats, s_f, basis, gt),
                       device, reps)
        timed(stages, "seg: pair_grads_to_packed (row sum)",
              lambda: segpair.pair_grads_to_packed(dfeats, src, ox, oy, pb,
                                                   n), device, reps)
        timed(stages, "seg: assemble_image",
              lambda: tiles_mod.assemble_image(
                  torch.zeros_like(img).index_copy(0, pb.perm, img), W, H,
                  TILE), device, reps)
    counts = {"pairs": int(pb.num_pairs), "kept": int(pb.s_f[-1]),
              "trunc": int(pb.num_truncated)}
    print("    seg " + " ".join(f"{k}={v}" for k, v in counts.items()))
    kw = {k: v for k, v in rk.items() if k != "tile_size"}
    full = timed(stages, "seg: FULL fwd+bwd step", full_step(sc, **kw),
                 device, reps)
    return stages, counts, full


def finite(stages: dict) -> bool:
    return all(np.isfinite(v["ms"]) for v in stages.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_gaussians", nargs="?", type=int, default=20000)
    ap.add_argument("k1", nargs="?", type=int, default=128)
    ap.add_argument("t2", nargs="?", type=int, default=0)
    ap.add_argument("--fixture", action="store_true",
                    help="the trained bench fixture at the shipped ABC "
                         "geometry, and the recipe's seg path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls per timing block")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.fixture:
        s = FIXTURE_SETTINGS
        cap, k1, t2, m = s["cap"], s["k1"], s["t2"], s["m"]
    else:
        cap, k1, t2, m = CAP, args.k1, args.t2, M
    sc_np, r = scene(args.fixture, args.n_gaussians)
    sc = on_device(sc_np, device)
    n = sc["means"].shape[0]
    num_tiles = tiles_mod.tile_grid(sc["width"], sc["height"], TILE)[2]
    t2_eff = t2 or max(num_tiles // 4, 8)
    platform = card()
    print(f"device={platform} N={n} K1={k1} k2={cap - k1} t2={t2_eff} "
          f"cap={cap} M={m} backend=pallas", flush=True)
    stages, counts, full = dense_stages(sc, r, cap, k1, t2, m, device,
                                        args.reps)
    out = dict(platform=platform, N=n, K1=k1, k2=cap - k1, t2=t2_eff,
               cap=cap, M=m, backend="pallas", width=sc["width"],
               height=sc["height"], **counts, loss=float(full[0]),
               stages=stages)
    if args.fixture:
        seg, seg_counts, seg_full = seg_stages(sc, device, args.reps)
        out["seg"] = dict(seg_counts, loss=float(seg_full[0]), stages=seg)
    out["finite"] = bool(
        finite(stages) and all(bool(torch.isfinite(g).all()) for g in full)
        and (not args.fixture or (
            finite(out["seg"]["stages"])
            and all(bool(torch.isfinite(g).all()) for g in seg_full))))
    print(json.dumps(out))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
