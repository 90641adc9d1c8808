"""The program under test, driven as its trainer drives itself.

:func:`build` makes a cell's run: the recipe's step from the trainer's own
``make_proj_grad_fn``, the state from its ``init_train_state`` (grown with
its ``grow_capacity`` where the traffic holds the recipe's largest
capacity), with the initial parameters the benchmark draws from the seed.
:func:`epoch` is the one call the window makes: the trainer's
``run_epoch`` at the traffic's fixed epoch, which ends in its own
``.tolist()``, so an epoch's end is a synchronised point. Density
control, staged growth, checkpoints and logs never run.

:class:`Spy` watches the first view steps of set-up for the correctness
check, without changing them: the loss each ``proj_grad`` call returns,
the state before the 2nd and the (K+1)-th call, and the neighbours the
first direction fire fetches.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from edgegaussians_tpu_torch.config import config_from_dict, resolve_capacity
from edgegaussians_tpu_torch.models import losses as program_losses
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.train import trainer

from . import scenes


class Run(NamedTuple):
    cfg: object
    state: object
    proj_grad: object
    epoch: int
    images: torch.Tensor
    edges: torch.Tensor
    viewmats: torch.Tensor
    Ks: torch.Tensor
    initial: Dict[str, torch.Tensor]   # the benchmark's arrays
    alive0: torch.Tensor
    capacity: int


def fixed_epoch(recipe: Dict, traffic: Dict) -> int:
    """The recipe epoch every epoch of the window runs at: the traffic's
    ``epoch``, or ``epoch_after_orientation_start`` epochs past the later
    of the two orientation losses' start epochs."""
    if "epoch" in traffic:
        return int(traffic["epoch"])
    ol = recipe["training"]["loss"]["orientation_losses"]
    return (max(ol["start_dir_loss_at_epoch"],
                ol["start_ratio_loss_at_epoch"])
            + int(traffic["epoch_after_orientation_start"]))


def initial_arrays(seeds: torch.Tensor, capacity: int, model: Dict,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The four groups at ``capacity`` rows by the recipe's init rule, the
    quats drawn uniform on SO(3) (u, v, w uniform) from ``gen``: means =
    the seeds (zeros past them), log scales = log(init_scales_val), logit
    opacities = logit(init_opacity_val)."""
    if (model["init_scales_type"], model["init_opacity_type"]) != \
            ("constant", "constant"):
        raise ValueError("the benchmark draws constant initial scales and "
                         "opacities only")
    dev = seeds.device
    n = seeds.shape[0]
    means = torch.zeros((capacity, 3), device=dev)
    means[:n] = seeds
    u, v, w = torch.rand((3, capacity), generator=gen, device=dev)
    quats = torch.stack([torch.sqrt(1 - u) * torch.sin(2 * math.pi * v),
                         torch.sqrt(1 - u) * torch.cos(2 * math.pi * v),
                         torch.sqrt(u) * torch.sin(2 * math.pi * w),
                         torch.sqrt(u) * torch.cos(2 * math.pi * w)], -1)
    op = model["init_opacity_val"]
    return {"means": means,
            "scales": torch.full((capacity, 3),
                                 math.log(model["init_scales_val"]),
                                 device=dev),
            "quats": quats,
            "opacities": torch.full((capacity, 1), math.log(op / (1 - op)),
                                    device=dev)}


def build(cell, seed: int, device: torch.device, root: str,
          cache_dir: str) -> Run:
    recipe = cell.recipe
    cfg = config_from_dict(recipe)
    cfg.training.seed = seed
    scene = scenes.load_scene(cell.scene, root, cache_dir)
    images = torch.from_numpy(scene.images).to(device)
    edges = images >= cfg.model.edge_detection_threshold
    viewmats = torch.from_numpy(scene.viewmats).to(device)
    Ks = torch.from_numpy(scene.Ks).to(device)

    gen = torch.Generator(device=device).manual_seed(seed)
    seeds = scenes.seed_points(scene, recipe["model"], gen, device)
    n = seeds.shape[0]
    max_cap = resolve_capacity(cfg.model, n)
    start_cap = (trainer.staged_start_capacity(n, cfg, max_cap)
                 if cfg.model.staged_capacity else max_cap)
    arrays = initial_arrays(seeds, start_cap, recipe["model"], gen)
    state = trainer.init_train_state(seeds.cpu().numpy(), cfg,
                                     capacity=start_cap, device=device)
    with torch.no_grad():
        for g in GROUPS:
            getattr(state.model, g).copy_(arrays[g])
    alive0 = state.model.alive.clone()
    cap = {"start": start_cap, "max": max_cap}[cell.traffic["capacity"]]
    trainer.grow_capacity(state, cap)
    E = fixed_epoch(recipe, cell.traffic)
    # the renders of every earlier epoch: the loss schedule and the
    # orientation fires read the render count
    state.step = E * scene.num_views
    return Run(cfg=cfg, state=state,
               proj_grad=trainer.make_proj_grad_fn(cfg, scene.width,
                                                   scene.height),
               epoch=E, images=images, edges=edges, viewmats=viewmats,
               Ks=Ks, initial=arrays, alive0=alive0, capacity=cap)


def epoch(run: Run, proj_grad=None):
    """One epoch of the trainer at the run's fixed epoch."""
    return trainer.run_epoch(run.state, run.epoch, run.images, run.edges,
                             run.viewmats, run.Ks, run.cfg,
                             proj_grad or run.proj_grad)


def snapshot(state) -> Dict:
    """A copy of every tensor of the trainer's state the check reads."""
    out = {g: getattr(state.model, g).detach().clone() for g in GROUPS}
    for g in GROUPS:
        mu, nu = state.opt.moments[g]
        out["m_" + g], out["v_" + g] = mu.clone(), nu.clone()
        out["c_" + g] = state.opt.counts[g]
    out["absgrads"] = state.model.absgrads.clone()
    out["alive"] = state.model.alive.clone()
    out["step"] = state.step
    return out


def steps_to_check(run: Run, fires: bool) -> int:
    """The view steps the reference follows: 3, or as far as the first
    orientation fire where the window's epochs fire. The first must not
    fire: its gradient is read from Adam's first moment."""
    if not fires:
        return 3
    j = next(j for j in range(1, 6) if (run.state.step + j) % 5 == 0)
    if j == 1:
        raise ValueError("the first view step of set-up fires the "
                         "orientation losses")
    return max(3, j)


class Spy:
    """Records the first ``k`` view steps of one epoch (see the module's
    docstring); :meth:`close` restores the program's function."""

    def __init__(self, run: Run, k: int):
        self.run, self.k = run, k
        self.calls = 0
        self.losses: List[torch.Tensor] = []
        self.after_1: Optional[Dict] = None
        self.after_k: Optional[Dict] = None
        self.knn: Optional[torch.Tensor] = None
        self._nn = program_losses.update_nearest_neighbors

        def nearest(*args, **kwargs):
            out = self._nn(*args, **kwargs)
            if self.knn is None:
                self.knn = out.clone()
            return out

        program_losses.update_nearest_neighbors = nearest

    def proj_grad(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        if i == 1:
            self.after_1 = snapshot(self.run.state)
        if i == self.k:
            self.after_k = snapshot(self.run.state)
        out = self.run.proj_grad(*args, **kwargs)
        if i < self.k:
            self.losses.append(out[0].detach().clone())
        return out

    def close(self) -> None:
        program_losses.update_nearest_neighbors = self._nn
