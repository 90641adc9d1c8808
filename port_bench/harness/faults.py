"""Faults planted in the program's timed path, to show that the check
catches them (``tests/``, and ``readings.py`` on the card at a cell's
own size). Each is a context manager that patches the program's module
attribute its trainer calls through, and restores it on exit.

- ``unchanged``: Adam leaves every parameter as it was (a step that
  returns its state unchanged);
- ``half_batch``: the projection loss takes the mean over the first half
  of the image's rows only (half of the step's batch of pixels left out);
- ``altered``: the seg compositor's backward gives every pair's gradient
  1% high (an answer altered where it is produced);
- ``nan_opacity``: Adam writes NaN into one opacity on every step (a
  non-finite answer in the last group, which a worst-of that skipped NaN
  would miss).
"""

from __future__ import annotations

import contextlib

import torch

from edgegaussians_tpu_torch.models import losses
from edgegaussians_tpu_torch.ops import segpair
from edgegaussians_tpu_torch.train import optim


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def unchanged():
    return _patched(optim, "apply_updates",
                    lambda orig: (lambda *a, **k: None))


@contextlib.contextmanager
def half_batch():
    def whole(orig):
        def f(pred, gt, *a, **k):
            h = pred.shape[0] // 2
            return orig(pred[:h], gt[:h], *a, **k)
        return f

    def ratio(orig):
        def f(pred, gt, edge_mask, ratio_, scores):
            h = pred.shape[0] // 2
            return orig(pred[:h], gt[:h], edge_mask[:h], ratio_,
                        scores[:h * pred.shape[1]])
        return f

    with _patched(losses, "projection_loss_whole", whole), \
            _patched(losses, "projection_loss_bg_edge_ratio", ratio):
        yield


def altered():
    return _patched(segpair, "segpair_bwd",
                    lambda orig: (lambda *a, **k: orig(*a, **k) * 1.01))


def nan_opacity():
    def make(orig):
        def f(model, grads, opt, lrs, groups=optim.GROUPS):
            orig(model, grads, opt, lrs, groups)
            if "opacities" in groups:
                with torch.no_grad():
                    model.opacities.view(-1)[0] = float("nan")
        return f
    return _patched(optim, "apply_updates", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "nan_opacity": nan_opacity}
