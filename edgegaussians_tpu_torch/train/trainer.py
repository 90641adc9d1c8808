"""Training orchestration: the per-view step and the epoch loop.

Counterpart of ``edgegaussians_tpu/train/trainer.py`` for the
single-device reference training loop (train_gaussians.py:17-222): one
Adam step per view in a shuffled view order, with the projection loss's
strategy chosen per render (train_gaussians.py:73-77), absgrad accumulated
after every backward (edge_gs.py:607-613), the direction and ratio losses
every 5 renders once their start epochs have passed (each its own Adam
step on the geometry groups, train_gaussians.py:108-131), density control
at its scheduled epochs, the pair-overflow watermark with its warn, error
and fallback actions, checkpoints in the JAX ``.npz`` key layout, and the
JAX trainer's epoch log line.

Multi-rank training (JAX trainer.py:576-617,641-664,716-738):
``train(mesh=...)`` splits every render over the ranks of a 'tiles' axis
(``parallel/train_sharded.py``) or a 'gauss' axis (``parallel/
train_tp.py``) with the per-view schedule unchanged, and ``step_mode:
"view_batch"`` runs the view-batch step of ``parallel/train_dp.py``, on a
('views', ...) mesh or, without one, in this process. The ranks run the
replicated work (Adam, orientation, density control) each on its own
copy; rank 0's copy is broadcast after every orientation fire and density
event, every epoch ends with a bit-for-bit check that the ranks agree,
and only rank 0 logs and writes checkpoints.

Staged capacity (trainer.py:472-514,566-572,672-686): a run with
``staged_capacity`` starts at the smallest power of two from 1024 up that
holds ``staged_capacity_start_factor`` x its seeds, and doubles, up to
``max_num_gaussians``, before any density event once the live count (or
twice it, on an epoch with a scheduled duplication) passes
``staged_capacity_grow_threshold`` of the capacity. Growing pads every
capacity-sized tensor in place; every step reads the capacity from the
model on each call, so nothing is rebuilt. ``train(log_dir=...)`` writes
the JAX trainer's TensorBoard scalars and images (trainer.py:741-759).

Random draws come from one CPU ``torch.Generator`` seeded with the
training seed: the per-epoch view permutation (injectable through
``view_orders``), the bg_edge_ratio scores (``bg_scores``) and the
duplication noise (``density_noise``). Torch cannot reproduce JAX's PRNG
streams, so runs agree with the JAX trainer in distribution, and
step-level tests inject the JAX draws.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from edgegaussians_tpu_torch.config import FrameworkConfig, resolve_capacity
from edgegaussians_tpu_torch import (
    backend_device, resolve_backend, resolve_compositor)
from edgegaussians_tpu_torch.models import density, losses
from edgegaussians_tpu_torch.models.gaussians import (
    GROUPS, GaussianModel, init_state, render_view)
from edgegaussians_tpu_torch.ops.tiles import tile_grid
from edgegaussians_tpu_torch.parallel import distributed
from edgegaussians_tpu_torch.train import optim
from edgegaussians_tpu_torch.train.optim import OptState, annealed
from edgegaussians_tpu_torch.utils import profiling

STRATEGIES = ("whole", "bg_edge_ratio", "weighted")


@dataclass
class TrainState:
    model: GaussianModel
    opt: OptState
    step: int                    # renders so far (the reference's model.step)
    generator: torch.Generator   # view permutations, bg_edge_ratio scores
    seed: int                    # training seed the generator started from
    # called after each replicated update that may differ in its last bits
    # between ranks (parallel/distributed.py: replicate); None in one process
    sync: Optional[Callable[["TrainState"], None]] = None


class EpochStats(NamedTuple):
    avg_loss: float
    num_alive: int
    max_tile_count: int
    max_overflow_tiles: int      # peak count of tiles past the dense budget
    max_truncated: int           # peak Gaussians truncated by
                                 # max_tiles_per_gaussian
    max_pairs: int               # peak per-view (tile, Gaussian) pair count


class ProjGradStats(NamedTuple):
    """Per-render diagnostics of a proj-grad call (device tensors)."""
    max_tile: torch.Tensor
    n_overflow: torch.Tensor
    num_truncated: torch.Tensor
    num_pairs: torch.Tensor


def _strategy_index(name: str) -> int:
    try:
        return STRATEGIES.index(name)
    except ValueError:
        raise ValueError(f"Unknown projection loss strategy: {name}")


def render_settings(cfg: FrameworkConfig) -> dict:
    """The model config's tile settings as ``rasterize`` keywords."""
    mcfg = cfg.model
    return dict(
        tile_size=mcfg.tile_size, capacity=mcfg.tile_gaussian_capacity,
        dense_capacity=mcfg.tile_dense_capacity,
        overflow_tiles=mcfg.tile_overflow_tiles,
        pair_budget=mcfg.tile_pair_budget,
        occupancy_sort=mcfg.tile_occupancy_sort,
        pair_kernel=mcfg.tile_pair_kernel,
        backend=resolve_compositor(mcfg.rasterizer_backend),
        max_tiles_per_gaussian=mcfg.max_tiles_per_gaussian,
        antialiased=(mcfg.rasterize_mode == "antialiased"))


def make_proj_grad_fn(cfg: FrameworkConfig, width: int, height: int):
    """Projection loss and its gradients for one view.

    Returns ``proj_grad(model, viewmat, K, gt, edge_mask, strategy_idx,
    bg_ratio, bg_scores) -> (loss, ProjGradStats, grads, sink_grads)``
    with ``grads`` a dict by parameter group, leaving the parameters'
    ``.grad`` untouched (the JAX version's value_and_grad contract).
    ``bg_scores`` ([H*W] uniform draws) is read only by bg_edge_ratio.
    """
    mcfg = cfg.model
    pl_cfg = cfg.training.loss.projection_losses
    render_kwargs = render_settings(cfg)

    def projection_loss(pred, gt, edge_mask, strategy_idx, bg_ratio,
                        bg_scores):
        if strategy_idx == 0:
            return losses.projection_loss_whole(pred, gt, pl_cfg.loss_type)
        if strategy_idx == 1:
            return losses.projection_loss_bg_edge_ratio(
                pred, gt, edge_mask, bg_ratio, bg_scores)
        return losses.projection_loss_weighted(
            pred, gt, losses.compute_weight_mask(edge_mask))

    def proj_grad(model: GaussianModel, viewmat, K, gt, edge_mask,
                  strategy_idx: int, bg_ratio: float, bg_scores=None):
        sink = torch.zeros((model.capacity, 2), dtype=torch.float32,
                           device=model.means.device, requires_grad=True)
        out = render_view(model, viewmat, K, width, height,
                          absgrad_sink=sink, **render_kwargs)
        pred = torch.clamp(out.image, 0.0, 1.0)   # edge_gs.py:279
        loss = projection_loss(pred, gt, edge_mask, strategy_idx, bg_ratio,
                               bg_scores)
        params = model.params()
        *gparams, gsink = torch.autograd.grad(
            loss, [params[g] for g in GROUPS] + [sink])
        stats = ProjGradStats(
            max_tile=out.tile_counts.max(),
            n_overflow=(out.tile_counts > mcfg.tile_dense_capacity).sum(),
            num_truncated=out.num_truncated,
            num_pairs=out.num_pairs)
        return loss.detach(), stats, dict(zip(GROUPS, gparams)), gsink

    return proj_grad


GEO_GROUPS = ("means", "scales", "quats")


def orientation_step(state: TrainState, run_sum: torch.Tensor, lrs,
                     ol_cfg, apply_dir: bool, apply_ratio: bool) -> None:
    """The direction and ratio branches of a firing view step
    (trainer.py:243-281), in place. Each is an Adam step on the geometry
    groups with the loss's gradient scaled by ``lam = run_sum *
    scale_factor / max(loss, 1e-12)`` (not differentiated; ``run_sum`` is
    the epoch's running sum of projection losses, bug-faithfully). The
    neighbours come from the means after the projection update; ``alive``
    does not change within a step. The ratio branch reads the parameters
    the direction branch left."""
    model = state.model
    alive = model.alive

    def step(loss_fn, scale_factor):
        params = [getattr(model, g) for g in GEO_GROUPS]
        val = loss_fn()
        grads = torch.autograd.grad(val, params, allow_unused=True,
                                    materialize_grads=True)
        lam = (run_sum * scale_factor) / torch.clamp(val.detach(), min=1e-12)
        optim.apply_updates(model, {g: lam * x for g, x in
                                    zip(GEO_GROUPS, grads)},
                            state.opt, lrs, GEO_GROUPS)

    if apply_dir:
        num_nn = ol_cfg.dir_loss_num_nn
        enforce = ol_cfg.dir_loss_enforce_method
        nn_idx = losses.update_nearest_neighbors(model.means, alive, num_nn,
                                                 enforce)
        step(lambda: losses.direction_loss(
            model.means, torch.exp(model.scales), model.quats, nn_idx,
            alive, num_nn, enforce), ol_cfg.dir_loss_scale_factor)
    if apply_ratio:
        step(lambda: losses.ratio_loss(torch.exp(model.scales), alive),
             ol_cfg.ratio_loss_scale_factor)


def view_step(state: TrainState, view_idx: int, images, edge_masks,
              viewmats, Ks, *, proj_grad, lrs, lambda_proj: float,
              bg_ratio: float, strategy_idx: int, run_sum: torch.Tensor,
              ol_cfg=None, apply_dir: bool = False,
              apply_ratio: bool = False, bg_scores=None):
    """One render + backward + Adam step on one view (trainer.py:212-241),
    then, every 5th render, the orientation branches.

    The reference backprops lambda * loss but logs the raw loss
    (train_gaussians.py:98-101). ``run_sum`` is the epoch's running sum of
    projection losses before this view; returns (stats, the sum with this
    view's loss). ``bg_scores`` replaces the bg_edge_ratio strategy's
    draw from ``state.generator``."""
    model = state.model
    if strategy_idx != 1:
        bg_scores = None
    elif bg_scores is None:
        bg_scores = torch.rand(images[view_idx].numel(),
                               generator=state.generator).to(
                                   images.device)
    loss, stats, grads, gsink = proj_grad(
        model, viewmats[view_idx], Ks[view_idx], images[view_idx],
        edge_masks[view_idx], strategy_idx, bg_ratio, bg_scores)
    grads = {g: lambda_proj * x for g, x in grads.items()}
    optim.apply_updates(model, grads, state.opt, lrs)
    with torch.no_grad():
        model.absgrads.add_(
            torch.linalg.vector_norm(gsink, dim=-1) * lambda_proj)
        model.absgrad_count.add_(1.0)
    state.step += 1
    run_sum = run_sum + loss
    if state.step % 5 == 0 and (apply_dir or apply_ratio):
        orientation_step(state, run_sum, lrs, ol_cfg, apply_dir, apply_ratio)
        if state.sync is not None:
            state.sync(state)
    return stats, run_sum


def run_epoch(state: TrainState, epoch: int, images, edge_masks, viewmats,
              Ks, cfg: FrameworkConfig, proj_grad,
              view_order: Optional[Sequence[int]] = None,
              bg_scores: Optional[Dict[int, torch.Tensor]] = None
              ) -> EpochStats:
    """One epoch: every view once, in ``view_order`` (default: a fresh
    permutation from ``state.generator``). ``bg_scores[r]``, when given,
    is render r's bg_edge_ratio draw (r counts renders over the run from
    0). Statistics stay on the device until one transfer at the end."""
    tcfg = cfg.training
    pl_cfg = tcfg.loss.projection_losses
    num_views = images.shape[0]
    if view_order is None:
        view_order = torch.randperm(num_views,
                                    generator=state.generator).tolist()
    strat_before = _strategy_index(pl_cfg.loss_before_alternating)
    strat_less = _strategy_index(pl_cfg.less_freq_loss)
    strat_more = _strategy_index(pl_cfg.more_freq_loss)
    sampling_ratio = max(int(pl_cfg.sampling_whole_num_epochs_ratio), 1)
    check_sampling = epoch > pl_cfg.start_alternating_at_epoch
    lrs = optim.all_lrs(tcfg.optim, epoch)
    bg_ratio = annealed(pl_cfg.bg_edge_pixel_ratio_start,
                        pl_cfg.bg_edge_pixel_ratio_end,
                        pl_cfg.bg_edge_pixel_ratio_annealing, epoch,
                        tcfg.num_epochs)
    lambda_proj = annealed(pl_cfg.lambda_start, pl_cfg.lambda_end,
                           pl_cfg.lambda_annealing, epoch, tcfg.num_epochs)
    ol_cfg = tcfg.loss.orientation_losses
    # the orientation losses apply at epochs past their start epoch
    # (trainer.py:309-310)
    apply_dir = epoch > ol_cfg.start_dir_loss_at_epoch
    apply_ratio = epoch > ol_cfg.start_ratio_loss_at_epoch

    run_sum = torch.zeros((), device=images.device)
    peaks = torch.zeros(4, dtype=torch.int64, device=images.device)
    for v in view_order:
        # strategy for this render (train_gaussians.py:73-77)
        if check_sampling:
            strategy_idx = (strat_less if state.step % sampling_ratio == 0
                            else strat_more)
        else:
            strategy_idx = strat_before
        stats, run_sum = view_step(
            state, v, images, edge_masks, viewmats, Ks, proj_grad=proj_grad,
            lrs=lrs, lambda_proj=lambda_proj, bg_ratio=bg_ratio,
            strategy_idx=strategy_idx, run_sum=run_sum, ol_cfg=ol_cfg,
            apply_dir=apply_dir, apply_ratio=apply_ratio,
            bg_scores=bg_scores.get(state.step) if bg_scores else None)
        peaks = torch.maximum(peaks, torch.stack(
            [stats.max_tile, stats.n_overflow, stats.num_truncated,
             stats.num_pairs]).to(torch.int64))
    avg, alive = (torch.stack([run_sum / len(view_order),
                               state.model.num_alive().to(run_sum.dtype)])
                  .tolist())
    max_tile, max_ovf, max_trunc, max_pairs = peaks.tolist()
    return EpochStats(avg_loss=avg, num_alive=int(alive),
                      max_tile_count=max_tile, max_overflow_tiles=max_ovf,
                      max_truncated=max_trunc, max_pairs=max_pairs)


def density_flags(epoch: int, cfg: FrameworkConfig) -> np.ndarray:
    """Host-side schedule: which density ops fire at this epoch
    (train_gaussians.py:186-219)."""
    m = cfg.model
    return np.array([
        m.if_duplicate_high_pos_grad and
        epoch in m.dup_high_pos_grads_at_epoch,
        m.if_cull_gaussians_not_projecting and
        epoch in m.cull_gaussians_not_projecting_at_epoch,
        m.if_cull_low_opacity and epoch in m.cull_opacity_at_epoch,
        m.if_cull_wayward and epoch in m.cull_wayward_at_epoch,
        m.if_reset_opacity and epoch in m.reset_opacity_at_epoch,
    ], dtype=bool)


@torch.no_grad()
def grow_capacity(state: TrainState, new_cap: int) -> None:
    """Pad every capacity-sized tensor of ``state`` to ``new_cap`` rows, in
    place (trainer.py:472-505): parameters with zeros and quats with unit-w
    rows [1, 0, 0, 0] (so the padding projects finitely), ``alive`` with
    False, absgrads and both Adam moments of every group with zeros. The
    groups' step counts stay. A capacity at or below the current one
    changes nothing."""
    model = state.model
    pad = new_cap - model.capacity
    if pad <= 0:
        return

    def padded(x, fill=0.0):
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    for g in GROUPS:
        grown = padded(getattr(model, g).detach())
        if g == "quats":
            grown[-pad:, 0] = 1.0
        setattr(model, g, torch.nn.Parameter(grown))
        mu, nu = state.opt.moments[g]
        state.opt.moments[g] = (padded(mu), padded(nu))
    model.alive = padded(model.alive, False)
    model.absgrads = padded(model.absgrads)


def staged_start_capacity(n_seed: int, cfg: FrameworkConfig,
                          max_cap: int) -> int:
    """The first stage (trainer.py:508-514): the smallest power of two from
    1024 up that reaches ``max(start_factor * n_seed, 1024)``, at most
    ``max_cap``."""
    target = max(int(cfg.model.staged_capacity_start_factor * n_seed), 1024)
    cap = 1024
    while cap < target:
        cap *= 2
    return min(cap, max_cap)


def staged_growth(state: TrainState, epoch: int, num_alive: int,
                  cfg: FrameworkConfig, max_cap: int, log_fn) -> bool:
    """The growth check before density control (trainer.py:672-686): while
    below ``max_cap``, double the capacity (at most to ``max_cap``) while
    the live count, or twice it on an epoch with a scheduled duplication
    (room for the clones), exceeds the grow threshold of the capacity.
    Returns whether it grew."""
    mcfg = cfg.model
    cap = state.model.capacity
    if not mcfg.staged_capacity or cap >= max_cap:
        return False
    dup = (mcfg.if_duplicate_high_pos_grad
           and epoch in mcfg.dup_high_pos_grads_at_epoch)
    want = 2 * num_alive if dup else num_alive
    new_cap = cap
    while (want > mcfg.staged_capacity_grow_threshold * new_cap
           and new_cap < max_cap):
        new_cap = min(new_cap * 2, max_cap)
    if new_cap == cap:
        return False
    grow_capacity(state, new_cap)
    log_fn(f"epoch {epoch}: capacity {cap} -> {new_cap} "
           f"(alive {num_alive})")
    return True


def init_train_state(seed_points: np.ndarray, cfg: FrameworkConfig,
                     capacity: Optional[int] = None,
                     device=None) -> TrainState:
    model = init_state(seed_points, cfg.model, seed=cfg.training.seed,
                       capacity=capacity, device=device)
    generator = torch.Generator().manual_seed(cfg.training.seed)
    return TrainState(model=model, opt=optim.init_opt_state(model), step=0,
                      generator=generator, seed=cfg.training.seed)


def run_density_control(state: TrainState, epoch: int, cfg: FrameworkConfig,
                        viewmats, Ks, edge_masks,
                        noise: Optional[torch.Tensor] = None) -> bool:
    """Epoch-scheduled densify/cull dispatch (trainer.py:352-427), in
    place on ``state``; returns whether anything fired. An event resets
    absgrads. ``noise`` replaces the duplication's draw from
    ``state.generator``."""
    flags = density_flags(epoch, cfg)
    if not flags.any():
        return False
    m, mcfg = state.model, cfg.model
    if flags[0]:
        density.duplicate_high_pos_gradients(
            m, state.opt, mcfg, noise=noise, generator=state.generator)
    if flags[1]:
        density.cull_not_projecting(m, mcfg, viewmats, Ks, edge_masks)
    if flags[2]:
        density.cull_low_opacity(m, mcfg)
    if flags[3]:
        density.cull_wayward(m, mcfg)
    if flags[4]:
        density.reset_opacities(m, mcfg.reset_opacity_value)
    m.absgrads.zero_()
    m.absgrad_count.fill_(1.0)
    return True


def _pair_overflow(epoch: int, stats: EpochStats, cfg: FrameworkConfig,
                   log_fn) -> bool:
    """The pair-overflow watermark (trainer.py:705-740): a render whose
    pair count exceeded tile_pair_budget dropped pairs. Returns True when
    the run must switch to the dense frame path ('fallback'); the
    overflowed epoch itself stays truncated."""
    budget = cfg.model.tile_pair_budget
    if stats.max_pairs <= budget:
        return False
    msg = (f"epoch {epoch}: {stats.max_pairs} (tile, Gaussian) pairs "
           f"exceed tile_pair_budget={budget}; pairs past the budget were "
           "DROPPED from this epoch's renders")
    action = cfg.model.tile_pair_overflow_action
    if action == "error":
        raise RuntimeError(msg + " — raise the budget "
                                 "(tile_pair_overflow_action='error')")
    if action == "fallback":
        log_fn("WARNING: " + msg + "; switching to the dense frame path "
               "for the remaining epochs "
               "(tile_pair_overflow_action='fallback')")
        return True
    log_fn("WARNING: " + msg + " — raise the budget")
    return False


def _reports_pairs(mcfg, capacity: int) -> bool:
    """Whether the render path counts pairs: the JAX package sets
    ``num_pairs`` on the pair and two-level paths only, and its log line
    prints ``pairs=`` where it is set (trainer.py:699-702)."""
    cap = min(mcfg.tile_gaussian_capacity, capacity)
    return ((bool(mcfg.tile_pair_kernel) and mcfg.tile_pair_budget > 0)
            or 0 < mcfg.tile_dense_capacity < cap)


def _step_factory(cfg: FrameworkConfig, scene, mesh,
                       mesh_strategy: str):
    """``build(cfg)`` of the run's step: the proj-grad of run_epoch (one
    device, or split over ``mesh``'s 'tiles' or 'gauss' axis), or, with
    ``step_mode: "view_batch"``, the view-batch step; and the view-batch
    mesh (None in per-view mode)."""
    w, h = scene.width, scene.height
    if cfg.training.step_mode == "view_batch":
        from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
        from edgegaussians_tpu_torch.parallel import train_dp
        if mesh is not None and "views" not in mesh.shape:
            raise ValueError(
                "step_mode='view_batch' needs a mesh with a 'views' axis; "
                f"got {mesh} — pass --mesh_views (with --mesh_tiles or "
                "--mesh_gauss for the inner axis)")
        dp_mesh = mesh if mesh is not None else mesh_mod.make_mesh(1, 1)
        return (lambda c: train_dp.make_dp_train_step(c, w, h, dp_mesh),
                dp_mesh)
    if mesh is None:
        return (lambda c: make_proj_grad_fn(c, w, h)), None
    if mesh_strategy == "tiles":
        from edgegaussians_tpu_torch.parallel.train_sharded import \
            make_sharded_proj_grad_fn as make_fn
    elif mesh_strategy == "gauss":
        from edgegaussians_tpu_torch.parallel.train_tp import \
            make_tp_proj_grad_fn as make_fn
    else:
        raise ValueError(f"unknown mesh_strategy {mesh_strategy!r}")
    if mesh_strategy not in mesh.shape:
        raise ValueError(f"mesh_strategy {mesh_strategy!r} needs a mesh "
                         f"with that axis; got {mesh}")
    return (lambda c: make_fn(c, w, h, mesh, mesh_strategy)), None


def run_view_batch_epoch(state: TrainState, epoch: int, dp_step, dp_rng,
                         batch_size: int, images, edge_masks, viewmats, Ks,
                         bg_scores: Optional[Dict[int, torch.Tensor]] = None
                         ) -> EpochStats:
    """One epoch of view batches (trainer.py:641-664): ``dp_rng``'s
    permutation of the views (NumPy, so the same batches as the JAX
    trainer's ``default_rng(seed + 977)``) cut into ``batch_size`` views
    per batch step, each batch sorted. ``bg_scores[s]``, when given, is
    batch step s's [batch_size, H*W] bg_edge_ratio draws."""
    nv = images.shape[0]
    nb = max(nv // batch_size, 1)
    perm = dp_rng.permutation(nv)[:nb * batch_size]
    loss_sum = torch.zeros((), device=images.device)
    peaks = torch.zeros(4, dtype=torch.int64, device=images.device)
    for i in range(nb):
        sel = torch.from_numpy(np.sort(perm[i * batch_size:
                                            (i + 1) * batch_size])).to(
                                                images.device)
        loss, st = dp_step(state, epoch, images[sel], edge_masks[sel],
                           viewmats[sel], Ks[sel],
                           bg_scores=bg_scores.get(state.step)
                           if bg_scores else None)
        loss_sum = loss_sum + loss
        peaks = torch.maximum(peaks, torch.stack(list(st)).to(torch.int64))
    avg, alive = (torch.stack([loss_sum / nb,
                               state.model.num_alive().to(loss_sum.dtype)])
                  .tolist())
    max_tile, max_ovf, max_trunc, max_pairs = peaks.tolist()
    return EpochStats(avg_loss=avg, num_alive=int(alive),
                      max_tile_count=max_tile, max_overflow_tiles=max_ovf,
                      max_truncated=max_trunc, max_pairs=max_pairs)


def train(scene, seed_points: np.ndarray, cfg: FrameworkConfig,
          backend: str = "auto", log_fn=print,
          checkpoint_dir: Optional[str] = None,
          log_dir: Optional[str] = None,
          initial_state: Optional[TrainState] = None,
          profile_dir: Optional[str] = None, profile_epochs: int = 1,
          view_orders: Optional[List[Sequence[int]]] = None,
          density_noise: Optional[Dict[int, torch.Tensor]] = None,
          bg_scores: Optional[Dict[int, torch.Tensor]] = None,
          mesh=None, mesh_strategy: str = "tiles") -> TrainState:
    """Full training run on one scene (train_gaussians.py:144-222).

    ``scene`` is a SceneViews. ``backend`` resolves as
    :func:`edgegaussians_tpu_torch.resolve_backend` does: ``"auto"``
    trains on the card and raises where torch sees none; ``"torch"``
    trains on the CPU. ``view_orders[e]``, when given, replaces
    epoch e's random view permutation, ``density_noise[e]`` epoch e's
    duplication noise and ``bg_scores[r]`` render r's bg_edge_ratio
    scores (in view-batch mode: batch step r's, one row per view of the
    batch). ``profile_dir`` writes a torch.profiler Chrome
    trace of epochs [2, 2 + profile_epochs). ``log_dir`` writes
    TensorBoard logs where tensorboardX is installed (else one line says
    they are off): each epoch's "Projection loss" and "num_gaussians",
    and every 5th epoch's "Output Image", view 0 rendered on the run's
    own path and device, clipped to [0, 1].

    ``mesh`` (``parallel/mesh.py``) splits every render over its
    ``mesh_strategy`` axis: 'tiles' bands of tile rows, or 'gauss' shards
    of the Gaussians (each rank compositing a band too). With
    ``step_mode: "view_batch"`` the mesh needs a 'views' axis, and no mesh
    means one rank. Every rank calls this with the same arguments; only
    rank 0 logs and writes checkpoints.
    """
    lead = distributed.rank() == 0
    if not lead:
        def log_fn(*_):
            return None
    device = backend_device(
        resolve_backend(backend, cfg.model.rasterizer_backend))
    images = torch.from_numpy(np.asarray(scene.images, np.float32)).to(device)
    edge_masks = images >= cfg.model.edge_detection_threshold
    viewmats = torch.from_numpy(np.asarray(scene.viewmats, np.float32)).to(
        device)
    Ks = torch.from_numpy(np.asarray(scene.Ks, np.float32)).to(device)

    max_cap = resolve_capacity(cfg.model, len(seed_points))
    if initial_state is not None:
        state = initial_state
    elif cfg.model.staged_capacity:
        state = init_train_state(
            seed_points, cfg, device=device,
            capacity=staged_start_capacity(len(seed_points), cfg, max_cap))
    else:
        state = init_train_state(seed_points, cfg, device=device)
    if distributed.is_distributed():
        state.sync = distributed.replicate
        distributed.replicate(state)
    build_step, dp_mesh = _step_factory(cfg, scene, mesh,
                                             mesh_strategy)
    step_fn = build_step(cfg)
    if dp_mesh is not None:
        batch_size = min(cfg.training.view_batch_size or scene.num_views,
                         scene.num_views)
        if batch_size % dp_mesh.size("views"):
            raise ValueError(
                f"view_batch_size {batch_size} must divide by the 'views' "
                f"mesh axis size {dp_mesh.size('views')}")
        dp_rng = np.random.default_rng(cfg.training.seed + 977)
    pair_mode = bool(cfg.model.tile_pair_budget)
    step_cfg = cfg              # the dense frame's after a fallback
    writer = _summary_writer(log_dir, log_fn) if lead and log_dir else None
    px_per_epoch = scene.num_views * scene.width * scene.height
    num_tiles = tile_grid(scene.width, scene.height, cfg.model.tile_size)[2]
    ovf_budget = cfg.model.tile_overflow_tiles or max(num_tiles // 4, 8)
    prof_epochs = range(2, 2 + max(profile_epochs, 1)) \
        if profile_dir and lead else range(0)
    prof = None
    t0 = time.time()
    t_prev = t0
    for epoch in range(cfg.training.num_epochs):
        if epoch == prof_epochs.start and prof_epochs:
            prof = profiling.start_profiler(device)
        if dp_mesh is not None:
            stats = run_view_batch_epoch(
                state, epoch, step_fn, dp_rng, batch_size, images,
                edge_masks, viewmats, Ks, bg_scores=bg_scores)
        else:
            stats = run_epoch(
                state, epoch, images, edge_masks, viewmats, Ks, cfg, step_fn,
                view_order=view_orders[epoch] if view_orders else None,
                bg_scores=bg_scores)
        if prof is not None and epoch + 1 == prof_epochs.stop:
            prof.stop()
            profiling.export_trace(prof, profile_dir)
            with open(os.path.join(profile_dir, "key_averages.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_device_time_total"
                    if device.type == "cuda" else "self_cpu_time_total",
                    row_limit=40))
            prof = None
            log_fn(f"profiler trace and key_averages.txt written to "
                   f"{profile_dir}")
        grew = staged_growth(state, epoch, stats.num_alive, cfg, max_cap,
                             log_fn)
        fired = run_density_control(
            state, epoch, cfg, viewmats, Ks, edge_masks,
            noise=density_noise.get(epoch) if density_noise else None)
        if (fired or grew) and state.sync is not None:
            state.sync(state)
        distributed.check_lockstep(state, f"after epoch {epoch}")
        if epoch % max(cfg.training.log_interval, 1) == 0:
            now = time.time()
            dt = max(now - t_prev, 1e-9)
            t_prev = now
            log_fn(f"epoch {epoch}: loss={stats.avg_loss:.5f} "
                   f"alive={stats.num_alive} "
                   f"max_tile={stats.max_tile_count} "
                   f"ovf={stats.max_overflow_tiles}/{ovf_budget} "
                   f"trunc={stats.max_truncated} "
                   + (f"pairs={stats.max_pairs}"
                      + (f"/{cfg.model.tile_pair_budget} "
                         if cfg.model.tile_pair_budget else " ")
                      if _reports_pairs(step_cfg.model, state.model.capacity)
                      else "")
                   + f"px/s={px_per_epoch / dt / 1e6:.1f}M "
                   f"t={now - t0:.1f}s")
        if pair_mode and _pair_overflow(epoch, stats, cfg, log_fn):
            # rebuild the step on the dense frame path for the rest of
            # the run (trainer.py:716-738)
            step_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, tile_pair_budget=0))
            step_fn = build_step(step_cfg)
            pair_mode = False
        if writer is not None:
            _log_epoch(writer, epoch, stats, state, step_cfg, scene,
                       viewmats[0], Ks[0])
        if (lead and checkpoint_dir and cfg.training.checkpoint_interval
                and (epoch + 1) % cfg.training.checkpoint_interval == 0):
            save_checkpoint(state, checkpoint_dir, epoch)
    if writer is not None:
        writer.close()
    return state


def _summary_writer(log_dir: str, log_fn):
    """A tensorboardX writer on ``log_dir``; where tensorboardX is not
    installed, None, and one line saying that the logs are off."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        log_fn(f"TensorBoard logs are off: tensorboardX is not installed "
               f"({log_dir} is not written)")
        return None
    return SummaryWriter(log_dir)


@torch.no_grad()
def _log_epoch(writer, epoch: int, stats: EpochStats, state: TrainState,
               cfg: FrameworkConfig, scene, viewmat, K) -> None:
    """The JAX trainer's TensorBoard record of an epoch
    (trainer.py:741-759), view 0 rendered on the run's own path."""
    writer.add_scalar("Projection loss", stats.avg_loss, epoch)
    writer.add_scalar("num_gaussians", stats.num_alive, epoch)
    if epoch % 5 == 0:
        out = render_view(state.model, viewmat, K, scene.width,
                          scene.height, **render_settings(cfg))
        writer.add_image("Output Image", torch.clamp(
            out.image, 0.0, 1.0)[None].cpu().numpy(), epoch)


def save_checkpoint(state: TrainState, out_dir: str, epoch: int) -> str:
    """Checkpoint params + optimizer state + step as ``epoch<k>.npz`` in
    the JAX package's key layout (trainer.py:763-787), so either package
    can load it (see convert.py)."""
    from edgegaussians_tpu_torch import convert
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"epoch{epoch}.npz")
    if os.path.exists(path):
        path = os.path.join(out_dir,
                            f"epoch{epoch}_{time.strftime('%m%d%H%M%S')}.npz")
    np.savez(path, **convert.state_to_arrays(state))
    return path


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a checkpoint written by either package onto the template's
    device, at the checkpoint's own capacity (a staged run's is below the
    maximum; the JAX ``load_checkpoint`` takes each array's shape from the
    file). Raises KeyError on a missing field and ValueError on a capacity
    above the template's, the run's maximum."""
    from edgegaussians_tpu_torch import convert
    with np.load(path) as data:
        state = convert.state_from_arrays(
            dict(data), device=template.model.means.device)
    if state.model.capacity > template.model.capacity:
        raise ValueError(
            f"checkpoint {path} has capacity {state.model.capacity}, above "
            f"the run's maximum {template.model.capacity}")
    return state
