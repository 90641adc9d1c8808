"""Per-group Adam with the reference's learning-rate schedules.

Counterpart of ``edgegaussians_tpu/train/optim.py:27-133``: four
independent Adam groups with per-group step counts, MultiStepLR on means
and 'zero until start epoch, then constant' on the others (reference:
edgegaussians/utils/train_utils.py:15-65). Torch-Adam details kept:
moments update even while lr == 0, bias correction uses the group's own
count, beta=(0.9, 0.999), eps=1e-8.

The update is done IN PLACE, under ``torch.no_grad()``, on the model's
parameters and on the moment tensors of :class:`OptState` (the JAX
version returns new arrays). The arithmetic is the JAX version's, term for
term. Moments stay explicit tensors, not ``torch.optim.Adam`` state, so
density control can zero clone rows and checkpoints keep the JAX layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from edgegaussians_tpu_torch.config import OptimConfig, OptimGroupConfig
from edgegaussians_tpu_torch.models.gaussians import GROUPS, GaussianModel

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclass
class OptState:
    moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]]   # group -> (mu, nu)
    counts: Dict[str, int]                                  # group -> steps


def init_opt_state(model: GaussianModel) -> OptState:
    return OptState(
        moments={g: (torch.zeros_like(p), torch.zeros_like(p))
                 for g, p in model.params().items()},
        counts={g: 0 for g in GROUPS})


def group_lr(cfg: OptimGroupConfig, epoch: int) -> float:
    """Learning rate of one group during ``epoch``: 'step' is MultiStepLR,
    start_lr * gamma^(#milestones <= epoch) (train_utils.py:51);
    'start_at' is 0 before start_at_epoch, start_lr after."""
    if cfg.type == "step":
        n_passed = sum(1 for m in cfg.milestones if m <= epoch)
        return cfg.start_lr * cfg.gamma ** n_passed
    return 0.0 if epoch < cfg.start_at_epoch else cfg.start_lr


def all_lrs(cfg: OptimConfig, epoch: int) -> Dict[str, float]:
    return {g: group_lr(getattr(cfg, g), epoch) for g in GROUPS}


@torch.no_grad()
def apply_updates(model: GaussianModel, grads: Dict[str, torch.Tensor],
                  opt: OptState, lrs: Dict[str, float],
                  groups: Tuple[str, ...] = GROUPS) -> None:
    """One Adam step, in place, on the selected groups (others untouched:
    the reference's partial opt.step(), train_gaussians.py:116-119)."""
    for g in groups:
        param = getattr(model, g)
        mu, nu = opt.moments[g]
        grad = grads[g]
        opt.counts[g] += 1
        count = opt.counts[g]
        mu.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * grad)
        nu.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * grad * grad)
        # bias corrections in f32, as the JAX version computes them
        cf = torch.tensor(float(count), dtype=torch.float32)
        mu_hat = mu / (1.0 - torch.pow(torch.tensor(ADAM_B1), cf))
        nu_hat = nu / (1.0 - torch.pow(torch.tensor(ADAM_B2), cf))
        param.sub_(lrs[g] * mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))


def annealed(value_start: float, value_end: float, mode: str, step: int,
             max_steps: int) -> float:
    """constant/linear annealing (train_utils.py:28-45)."""
    if mode == "constant":
        return value_start
    if mode == "linear":
        return value_start + (value_end - value_start) * (step / max_steps)
    raise ValueError(f"Unsupported annealing mode: {mode}")
