"""In-train A/B of the pair compositors against the dense frame, on the
card.

The port's counterpart of ``scripts/pair_kernel_ab.py``. Trains the scan
for a few epochs with the config (the density events emptied, every
epoch logged, as ``torch_epoch_ab.run_variant`` trains a variant) in
three variants of ``tile_pair_kernel``:

  ``dense``  false: the pair-prefix two-level frame (``raster_v2``),
  ``pairk``  true: the v4 block-window pair kernels (``pair``),
  ``segk``   "seg": the seg kernels (``segpair``; the shipped recipe),

and reports steady-state ms a view from the trainer's per-epoch ``px/s``
with the JAX script's keys; ``in_train_px_s_*`` use the scan's own width
x height (the JAX script assumed 800x800). ``--turns N`` runs the
variants in turns, in order then reversed, as ``torch_epoch_ab.py`` does;
each variant's time is the median over its steady epochs (epoch >= 1) of
every turn, with its spread. Beside them, per variant, its epochs'
losses and its kernel launches: ``dense`` launches ``raster_v2`` and no
pair or seg kernel, ``pairk`` the v4 pair kernels, ``segk`` the seg
kernels.

Usage: python scripts/torch_pair_kernel_ab.py [--epochs 12] [--turns 1]
       [--config configs/ABC_DexiNed.json] [--data_dir DIR]
       [--scene_name 00004926] [--device cuda|cpu]

``--device cuda`` (the default) trains on the card and raises without
one; ``--device cpu`` trains on the CPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os

from torch_common import OUT_ROOT, add_scan_args, card, resolve_device
from torch_epoch_ab import median_ms, per_variant, run_turns

from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.data import parsers


def _pair_kernel(value):
    def mutate(raw):
        raw["model"]["tile_pair_kernel"] = value
    return mutate


# pair_kernel_ab.py:25-32
VARIANTS = {"dense": _pair_kernel(False), "pairk": _pair_kernel(True),
            "segk": _pair_kernel("seg")}


def scan_size(config: str, scan: str, data_dir=None):
    cfg = load_config(config)
    if data_dir:
        cfg.data.base_dir = os.path.join(data_dir, "")
    sc = parsers.load_scene(cfg.data, scan)
    return sc.width, sc.height


def pair_kernel_ab(epochs: int, turns: int, out_root: str, config: str,
                   scan: str, device, data_dir=None) -> dict:
    """The three variants in turns: the JAX script's keys (:36-43) and
    each variant's steady epochs, spread, losses and kernel launches."""
    width, height = scan_size(config, scan, data_dir)
    ms, losses, launches, order = run_turns(VARIANTS, epochs, turns,
                                            out_root, config, scan, device,
                                            data_dir)
    t_base, t_pair, t_seg = (median_ms(ms[t]) for t in VARIANTS)
    out = {
        "t_dense_ms_per_view": round(t_base, 3),
        "t_pair_kernel_ms_per_view": round(t_pair, 3),
        "t_seg_kernel_ms_per_view": round(t_seg, 3),
        "speedup_pair": round(t_base / t_pair, 3),
        "speedup_seg": round(t_base / t_seg, 3),
        "in_train_px_s_pair": round(width * height / (t_pair * 1e-3), 1),
        "in_train_px_s_seg": round(width * height / (t_seg * 1e-3), 1)}
    out.update(per_variant(ms, losses, launches))
    out.update(width=width, height=height, turns=turns, order=order,
               platform=card())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--out_root", default=os.path.join(OUT_ROOT,
                                                       "pair_kernel_ab"))
    ap.add_argument("--turns", type=int, default=1,
                    help="turns of the variants, in order then reversed")
    add_scan_args(ap, gt_base=False)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(pair_kernel_ab(args.epochs, args.turns, args.out_root,
                                    args.config, args.scene_name, device,
                                    args.data_dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
