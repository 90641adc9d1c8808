"""Per-op device time of the pair compositors' render step, on the card.

The port's counterpart of ``scripts/segpair_profile.py``. Traces the
bench fixture's forward + backward step (the bench.py workload: render
-> clip to [0, 1] -> L1 to zeros, gradients of the four parameter
groups) under torch.profiler for each of ``--variants``:

  ``0``    ``pair_kernel=False``: with the fixture settings' pair budget
           and no dense capacity, the single-level frame (``raster_v2``);
  ``1``    ``pair_kernel=True``: the v4 block-window pair kernels;
  ``seg``  ``pair_kernel="seg"``: the seg kernels (the shipped recipe),

at the JAX script's tile settings (:25-26: tile 16, capacity 768, 16
tiles a Gaussian, pair budget 49152, occupancy sort). Per variant: 8 warm
steps, then ``--steps`` steps in one profiler window whose Chrome trace
goes to ``<out>_<variant>/trace.json``; ms a step and Mpx/s by wall
clock over the traced steps, the op table (ms a step, %, kernel records,
host launch records, op) read from the trace's kernel records by
``torch_common.trace_ops`` (a window short of kernel records is read
again), the total device ms a step and the port's kernel launches over
the window. Prints each table's ``--top`` ops and last a JSON object of
the whole tables.

One divergence from the JAX script, on purpose: it renders
``viewmats[v]`` for v in 0..7 and ``viewmats[i % 8]``, but the fixture
holds 5 cameras, and JAX clamps a gather past the end (a [5, 2] array
indexed at 7 returns row 4), so the JAX profile renders camera 4 in half
of its steps (i % 8 in 4..7); this script cycles ``i % n_cameras``.

Usage: python scripts/torch_segpair_profile.py [--steps 20] [--top 14]
       [--variants 1,seg] [--out build/harness/segpair_trace]
       [--device cuda|cpu]

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` runs the plain versions (no device records). Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch

from torch_common import (
    FIXTURE, OUT_ROOT, card, op_table, print_ops, resolve_device,
    traced_ops)

from edgegaussians_tpu_torch.ops.rasterize import rasterize

TILES = dict(tile_size=16, capacity=768, max_tiles_per_gaussian=16,
             pair_budget=49152, occupancy_sort=True)
WARM_STEPS = 8
PAIR_KERNELS = {"0": False, "1": True}


def pair_kernel(name: str):
    """The ``pair_kernel`` of a variant name (segpair_profile.py:54)."""
    return PAIR_KERNELS.get(name, name)


def fixture(device, max_n: int = 0, size: int = 0) -> dict:
    """The bench fixture's Gaussians and cameras (its first ``max_n``
    Gaussians, its intrinsics scaled to ``size`` x ``size``, when
    given)."""
    d = np.load(FIXTURE)
    cut = slice(0, max_n or None)
    w, h = int(d["width"]), int(d["height"])
    Ks = d["Ks"].astype(np.float32).copy()
    if size:
        Ks[:, :2] *= size / w
        w = h = size

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return {"params": [t(d["means"][cut]), t(d["quats"][cut]),
                       t(d["scales"][cut]),
                       t(d["opacities"].reshape(-1)[cut])],
            "viewmats": t(d["viewmats"]), "Ks": t(Ks), "width": w,
            "height": h}


def make_step(fx: dict, variant: str):
    """``step(cam) -> (loss, d means, d quats, d scales, d opacities)``:
    the JAX script's ``value_and_grad`` of ``loss_fn`` (:56-62) for one
    camera."""
    params = [p.detach().requires_grad_() for p in fx["params"]]
    target = torch.zeros((fx["height"], fx["width"]),
                         device=params[0].device)
    pk = pair_kernel(variant)

    def step(cam: int):
        out = rasterize(*params, fx["viewmats"][cam], fx["Ks"][cam],
                        fx["width"], fx["height"], pair_kernel=pk, **TILES)
        loss = torch.mean(torch.abs(torch.clamp(out.image, 0, 1) - target))
        return (loss.detach(),) + torch.autograd.grad(loss, params)
    return step


def profile_variant(fx: dict, variant: str, steps: int, out: str,
                    device) -> dict:
    """One variant: warm steps, then ``steps`` traced steps cycling the
    fixture's cameras; its wall time, top-op table and kernel launches."""
    step = make_step(fx, variant)
    n_cams = fx["viewmats"].shape[0]
    for v in range(WARM_STEPS):
        step(v % n_cams)
    if device.type == "cuda":
        torch.cuda.synchronize()
    it = itertools.count()
    ops, wall, counts = traced_ops(lambda: step(next(it) % n_cams), steps,
                                   f"{out}_{variant}", device)
    table = op_table(ops, steps)
    px = fx["width"] * fx["height"]
    return {"ms_per_step": wall * 1e3, "mpx_per_s": px / wall / 1e6,
            "total_device_ms": table["total_device_ms"],
            "rows": table["rows"],
            "kernels": {k: v for k, v in counts.items() if v},
            "trace": os.path.join(f"{out}_{variant}", "trace.json")}


def print_table(variant: str, res: dict, top: int) -> None:
    print(f"\n=== variant pair_kernel={variant}: {res['ms_per_step']:.2f} "
          f"ms/step ({res['mpx_per_s']:.1f} Mpx/s wall) ===")
    print_ops(res["rows"][:top])
    print(f"total device time: {res['total_device_ms']:.3f} ms/step; "
          f"port kernels launched {res['kernels']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "segpair_trace"))
    ap.add_argument("--variants", default="1,seg")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fx = fixture(device)
    out = {}
    for name in args.variants.split(","):
        out[name] = profile_variant(fx, name, args.steps, args.out, device)
        print_table(name, out[name], args.top)
    print(json.dumps({"steps": args.steps, "variants": out,
                      "platform": card()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
