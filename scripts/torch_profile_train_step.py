"""Per-component timing of the full in-train view step on the card.

The port's counterpart of ``scripts/profile_train_step.py``. A training
view step renders and backpropagates one view (the trainer's proj-grad:
projection, binning, compositor, loss), takes an Adam step on the four
parameter groups, and every 5th render refreshes the kNN and takes the
direction and ratio losses' gradients with a geometric Adam step each
(``train/trainer.py`` ``view_step``; reference cadence
train_gaussians.py:108-131). This script times each component at the
trained workload's shapes (the bench fixture's model padded into the
recipe's 16384 capacity, as the JAX script pads it) and prints the
expected steady-state step

    t_step = t_proj_grad + t_adam + (t_knn + t_dir + t_ratio
                                     + 2 t_geo_adam) / 5

and, built the same way from each component's launches,
``expected_launches_per_step``, the figure a training step's traced
launches read against. Every ``*_ms`` key (CUDA events, median of 3
blocks) has a ``*_device_ms`` (the calls queued behind a sleeping kernel,
or the profiler's sum of kernel durations for a call of more launches
than a stream holds pending) and a ``*_launches`` (host launch records
per call) beside it; ``device_ms_by`` says which kind each component's
device time is, and of the totals, which add times of one kind only: the
queued ones where every component was queued, else the profiler's sums
of every component. ``kernels`` gives the port's kernel launches per
call of each component; see ``torch_common.measure``. The last line is
one JSON object.

Usage: python scripts/torch_profile_train_step.py [--device cuda|cpu]
       [--reps N]

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` runs the plain versions. :func:`padded_model` cuts the
model and the view (``capacity``, ``max_n``, ``size``) for a run on the
CPU, as the tests call it. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from torch_common import FIXTURE, RECIPE, card, measure, resolve_device

from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.models import losses
from edgegaussians_tpu_torch.models.gaussians import GROUPS, GaussianModel
from edgegaussians_tpu_torch.train import optim, trainer

# the components, in the JAX script's order; those of the every-5th block
COMPONENTS = ("proj_grad", "proj_grad_bg_ratio", "adam", "knn", "dir_loss",
              "ratio_loss", "geo_adam")
EVERY5 = {"knn": 1, "dir_loss": 1, "ratio_loss": 1, "geo_adam": 2}


def padded_model(capacity: int = 0, max_n: int = 0, size: int = 0,
                 device="cpu"):
    """The fixture's model (its first ``max_n`` Gaussians when given) in a
    capacity of ``capacity`` rows (the recipe's, 16384, by default), the
    rows past it dead: zeros, identity quats (profile_train_step.py:58-74);
    camera 0 at ``size`` x ``size`` (its intrinsics scaled) when given.
    Returns (model, config, W, H, viewmat 0, K 0)."""
    cfg = load_config(RECIPE)
    d = np.load(FIXTURE)
    n = min(max_n or d["means"].shape[0], d["means"].shape[0])
    cap = capacity or cfg.model.max_num_gaussians
    cfg.model.max_num_gaussians = cap
    W, H = int(d["width"]), int(d["height"])
    K = d["Ks"][0].astype(np.float32).copy()
    if size:
        K[:2] *= size / W
        W = H = size

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x[:n]
        return out

    quats = np.zeros((cap, 4), np.float32)
    quats[:, 0] = 1.0
    quats[:n] = d["quats"][:n]
    op = d["opacities"].reshape(-1, 1)
    arrays = {"means": pad(d["means"]), "scales": pad(np.log(d["scales"])),
              "quats": quats, "opacities": pad(np.log(op / (1 - op)))}
    model = GaussianModel(cap, device=device)
    with torch.no_grad():
        for g in GROUPS:
            getattr(model, g).copy_(torch.from_numpy(arrays[g]))
        model.alive.copy_(torch.from_numpy(np.arange(cap) < n))
    vm = torch.from_numpy(d["viewmats"][0]).to(device)
    K = torch.from_numpy(K).to(device)
    return model, cfg, W, H, vm, K


def bg_scores(W: int, H: int, device) -> torch.Tensor:
    """The bg_edge_ratio call's [H*W] uniform draws, from a seed."""
    return torch.rand(W * H, generator=torch.Generator().manual_seed(0)
                      ).to(device)


def components(model, cfg, W: int, H: int, vm, K, device):
    """The step's components as calls on ``model``'s state: (calls by
    name, the values the tests compare: the proj-grad's loss and
    gradients, the kNN's indices, the model copy the Adam call steps).
    The two Adam calls step copies of the model, so every call reads the
    same state."""
    gt = torch.zeros((H, W), device=device)
    em = gt > 0.5
    scores = bg_scores(W, H, device)
    pg = trainer.make_proj_grad_fn(cfg, W, H)
    lrs = optim.all_lrs(cfg.training.optim, 100)
    opt = optim.init_opt_state(model)
    ol = cfg.training.loss.orientation_losses
    num_nn, enforce = ol.dir_loss_num_nn, ol.dir_loss_enforce_method
    geo = trainer.GEO_GROUPS

    def proj_grad():
        return pg(model, vm, K, gt, em, 0, 1.0)

    def proj_grad_bg_ratio():
        return pg(model, vm, K, gt, em, 1, 4.0, scores)

    def knn():
        return losses.update_nearest_neighbors(model.means, model.alive,
                                               num_nn, enforce)

    nn_idx = knn()
    params = [getattr(model, g) for g in geo]

    def dir_loss():
        val = losses.direction_loss(model.means, torch.exp(model.scales),
                                    model.quats, nn_idx, model.alive,
                                    num_nn, enforce)
        return (val.detach(),) + torch.autograd.grad(
            val, params, allow_unused=True, materialize_grads=True)

    def ratio_loss():
        val = losses.ratio_loss(torch.exp(model.scales), model.alive)
        return (val.detach(),) + torch.autograd.grad(
            val, params, allow_unused=True, materialize_grads=True)

    loss, _, grads, _ = proj_grad()
    dgrads = dict(zip(geo, dir_loss()[1:]))
    adam_model, adam_opt = copy.deepcopy(model), copy.deepcopy(opt)
    geo_model, geo_opt = copy.deepcopy(model), copy.deepcopy(opt)

    def adam():
        optim.apply_updates(adam_model, grads, adam_opt, lrs)

    def geo_adam():
        optim.apply_updates(geo_model, dgrads, geo_opt, lrs, geo)

    calls = dict(proj_grad=proj_grad, proj_grad_bg_ratio=proj_grad_bg_ratio,
                 adam=adam, knn=knn, dir_loss=dir_loss,
                 ratio_loss=ratio_loss, geo_adam=geo_adam)
    values = dict(loss=loss, grads=grads, nn_idx=nn_idx,
                  adam_model=adam_model)
    return calls, values


def profile(model, cfg, W: int, H: int, vm, K, device,
            reps: int = 20) -> dict:
    """Every component measured, then the JAX script's totals, with
    device ms and launches built the same way."""
    calls, _ = components(model, cfg, W, H, vm, K, device)
    res, kernels, by, prof = {}, {}, {}, {}
    for name in COMPONENTS:
        t, _ = measure(calls[name], device, reps)
        res[f"{name}_ms"] = t["ms"]
        res[f"{name}_device_ms"] = t["device_ms"]
        res[f"{name}_launches"] = t["launches"]
        kernels[name] = t["kernels"]
        by[name] = t.get("device_ms_by")
        prof[f"{name}_device_ms"] = t.get("profiler_device_ms")
        print(f"{name:20s} {t['ms']:8.3f} ms  device {t['device_ms']} ms "
              f"({by[name]})  launches {t['launches']}  {t['kernels']}",
              flush=True)

    def total(vals: dict, suffix: str, names, weights=None):
        got = [vals[f"{n}{suffix}"] for n in names]
        if None in got:
            return None
        return float(sum(v * (weights or {}).get(n, 1)
                         for n, v in zip(names, got)))

    # a device total adds times of one kind: the queued ones where every
    # component was queued, else the profiler's kernel sums of all
    kind = "queued" if set(by.values()) == {"queued"} else "profiler"
    by["totals"] = kind if device.type == "cuda" else None
    for suffix, every5_key, step_key in (
            ("_ms", "every5_total_ms", "expected_step_ms"),
            ("_device_ms", "every5_total_device_ms",
             "expected_step_device_ms"),
            ("_launches", "every5_total_launches",
             "expected_launches_per_step")):
        vals = prof if suffix == "_device_ms" and kind == "profiler" else res
        every5 = total(vals, suffix, EVERY5, EVERY5)
        res[every5_key] = every5
        base = total(vals, suffix, ("proj_grad", "adam"))
        res[step_key] = (None if every5 is None or base is None
                         else base + every5 / 5.0)
    res["expected_in_train_mpx_s"] = W * H / res["expected_step_ms"] / 1e3
    res = {k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in res.items()}
    res["platform"] = card()
    res["capacity"] = model.capacity
    res["kernels"] = kernels
    res["device_ms_by"] = by
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per timing block")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model, cfg, W, H, vm, K = padded_model(device=device)
    res = profile(model, cfg, W, H, vm, K, device, args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
