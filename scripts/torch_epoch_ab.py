"""In-program component costs of the training step by an epoch-level A/B.

The port's counterpart of ``scripts/epoch_ab.py``. Times of single calls
(``torch_profile_train_step.py``) miss what a step costs inside an epoch
(the host's launch queue, the allocator's reuse), so this script
differences the steady-state epoch times of two variant configs trained
on the same scan through the port's ``cli.train``:

  A ``full``: dir/ratio fire from epoch -1   t_A = render + adam
                                                   + every5/5 + eps
  B ``noorient``: dir/ratio off (99999)      t_B = render + adam + eps
  A - B                                      (kNN + dir + ratio
                                              + 2 geo-Adam) / 5

Each variant empties the density events and logs every epoch, as the JAX
script does; a view's ms comes from the epoch line's ``px/s`` and the
scan's own W x H (the JAX script assumed 800x800). The host's clock
spreads (PERF.md section 5: +-30% within a call), so ``--turns N`` runs
the variants A B B A A B ...; each variant's time is the median over its
steady epochs (epoch >= 1) of every turn, with its spread. The default of
one turn is the JAX script's order, A then B. The output adds, per
variant, the port's kernel launches over its runs: ``full`` launches the
kNN, ``noorient`` does not.

Usage: python scripts/torch_epoch_ab.py [--epochs 12] [--turns 1]
       [--config configs/ABC_DexiNed.json] [--data_dir DIR]
       [--scene_name 00004926] [--device cuda|cpu]

``--device cuda`` (the default) trains on the card and raises without
one; ``--device cpu`` trains on the CPU (``--backend torch``). Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

from torch_common import (
    OUT_ROOT, add_scan_args, card, derive_config, resolve_device,
    train_cli)

from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.data import parsers

EPOCH_LINE = re.compile(r"^epoch (\d+): .*px/s=([0-9.]+)M", re.M)
LOSS = re.compile(r"^epoch \d+: loss=(\S+)", re.M)


def full(raw):
    # fire dir/ratio from epoch 0 so the A window includes them
    ol = raw["training"]["loss"]["orientation_losses"]
    ol["start_dir_loss_at_epoch"] = -1
    ol["start_ratio_loss_at_epoch"] = -1


def no_orient(raw):
    ol = raw["training"]["loss"]["orientation_losses"]
    ol["start_dir_loss_at_epoch"] = 99999
    ol["start_ratio_loss_at_epoch"] = 99999


VARIANTS = {"full": full, "noorient": no_orient}


def steady_ms(log: str, width: int, height: int):
    """ms a view of each steady epoch (epoch >= 1) of a training log; an
    epoch whose rate prints as 0.0M (a tiny scan) has none."""
    return [width * height / (float(rate) * 1e6) * 1e3
            for epoch, rate in EPOCH_LINE.findall(log)
            if int(epoch) >= 1 and float(rate) > 0]


def run_variant(tag: str, epochs: int, out_root: str, config: str,
                scan: str, device, data_dir=None, turn: int = 0):
    """Train variant ``tag`` for ``epochs`` epochs: (ms a view of its
    steady epochs, its kernel launches, its log)."""

    def mutate(raw):
        raw["training"]["num_epochs"] = epochs
        raw["training"]["log_interval"] = 1
        # steady-state from epoch 0: no density events in the window
        for k in ("dup_high_pos_grads_at_epoch", "cull_opacity_at_epoch",
                  "cull_gaussians_not_projecting_at_epoch",
                  "reset_opacity_at_epoch"):
            raw["model"][k] = []
        VARIANTS[tag](raw)

    cfg_path = derive_config(config, os.path.join(out_root, f"{tag}{turn}"),
                             tag, data_dir, mutate)
    cfg = load_config(cfg_path)
    scene = parsers.load_scene(cfg.data, scan)
    log, launches, _ = train_cli(cfg_path, scan, device)
    return steady_ms(log, scene.width, scene.height), launches, log


def epoch_ab(epochs: int, turns: int, out_root: str, config: str, scan: str,
             device, data_dir=None) -> dict:
    """The variants A B B A ... for ``turns`` turns; the JAX script's keys
    and, per variant, its steady epochs' ms, their spread, its epochs'
    losses and its kernel launches."""
    ms = {t: [] for t in VARIANTS}
    losses = {t: [] for t in VARIANTS}
    launches = {t: {} for t in VARIANTS}
    order = []
    for turn in range(turns):
        tags = list(VARIANTS) if turn % 2 == 0 else list(VARIANTS)[::-1]
        for tag in tags:
            got, counts, log = run_variant(tag, epochs, out_root, config,
                                           scan, device, data_dir, turn)
            ms[tag] += got
            losses[tag] += [float(v) for v in LOSS.findall(log)]
            for k, v in counts.items():
                launches[tag][k] = launches[tag].get(k, 0) + v
            order.append(tag)

    def med(tag):
        return float(np.median(ms[tag])) if ms[tag] else float("nan")

    t_a, t_b = med("full"), med("noorient")
    out = {
        "t_full_ms_per_view": round(t_a, 3),
        "t_noorient_ms_per_view": round(t_b, 3),
        "every5_block_ms": round((t_a - t_b) * 5, 3),
        "note": "every5 = kNN + dir + ratio + 2 geo-Adam, in-program"}
    for tag in VARIANTS:
        out[f"t_{tag}_spread_ms"] = ([round(min(ms[tag]), 3),
                                      round(max(ms[tag]), 3)]
                                     if ms[tag] else None)
        out[f"{tag}_epoch_ms"] = [round(v, 3) for v in ms[tag]]
        out[f"{tag}_losses"] = losses[tag]
        out[f"{tag}_launches"] = launches[tag]
    out.update(turns=turns, order=order, platform=card())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--out_root", default=os.path.join(OUT_ROOT,
                                                       "epoch_ab"))
    ap.add_argument("--turns", type=int, default=1,
                    help="turns of the variants, A B then B A ...")
    add_scan_args(ap, gt_base=False)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(epoch_ab(args.epochs, args.turns, args.out_root,
                              args.config, args.scene_name, device,
                              args.data_dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
