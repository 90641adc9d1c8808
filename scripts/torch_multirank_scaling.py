"""Training throughput of the PyTorch port on several cards, one NCCL rank
per card, against one process on one card.

    python3 scripts/torch_multirank_scaling.py [--ranks 4] [--epochs 5]

Needs as many CUDA cards as ranks. Builds the kernels, makes the
10-view 800x800 synthetic scan of ``chip_smoke.py`` and trains the
``configs/ABC_DexiNed.json`` recipe cut as phase 7c cuts it (ratio loss
fires, a ``top_fraction`` duplication after epoch 1) for ``--epochs``
epochs: in one process per view and in view batches of ``--ranks``
views, then through ``torch.distributed.run`` with ``--mesh_tiles N``,
``--mesh_views N`` and ``--mesh_views 2 --mesh_tiles N/2`` (NCCL). Each
multi-rank run must leave every rank's state bit-equal and its epoch
losses within 2e-3 relative (plus the log's last digit) of the
one-process run of the same step mode. Prints each run's steady-epoch
Mpx/s, the card's name and power limit, and last a JSON line of the runs.
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch

import chip_smoke as smoke


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args()
    n = args.ranks
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"needs {n} CUDA cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if n % 2:
        raise SystemExit("--ranks must be even (the views x tiles run "
                         "puts 2 rows of n/2 ranks)")
    card = smoke.phase_environment()
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    batches = dict(step_mode="view_batch", view_batch_size=n)
    runs = {
        "tiles": ({}, ["--mesh_tiles", str(n)], 1),
        "views": (batches, ["--mesh_views", str(n)], n),
        "views_tiles": (batches, ["--mesh_views", "2", "--mesh_tiles",
                                  str(n // 2)], 2),
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scan = "synth0"
        generate_scene(tmp, scan, seed=0, n_views=smoke.VIEWS, width=800,
                       height=800)
        single = {}
        for tag, training in (("one_per_view", {}),
                              ("one_batches", batches)):
            smoke.log(f"== one process, {tag}")
            text, _, _, _ = smoke.train_cli_run(
                tmp, scan, args.epochs, tag, orient=smoke.MULTI_ORIENT,
                training=training, **smoke.MULTI_MODEL)
            single[tag] = smoke.epoch_lines(text, args.epochs)
            out[tag] = [r[2] for r in single[tag][1:]]
        for name, (training, flags, n_views) in runs.items():
            smoke.log(f"== {n} NCCL ranks, {' '.join(flags)}")
            cfg, cfg_path = smoke.write_config(
                tmp, args.epochs, f"ranks_{name}", orient=smoke.MULTI_ORIENT,
                training=training, **smoke.MULTI_MODEL)
            t0 = time.time()
            text, results = smoke.run_ranks(
                n, name, os.path.join(tmp, f"out_{name}"),
                ["--config_file", cfg_path, "--scene_name", scan,
                 "--backend", "cuda", "--force_rerun"] + flags)
            rows = smoke.epoch_lines(text, args.epochs)
            smoke.check_ranks_agree(results, name)
            ref = single["one_batches" if training else "one_per_view"]
            rel = smoke.check_losses_match(rows, ref, name)
            launches = json.loads(str(results[0]["launches"]))
            expected = args.epochs * smoke.VIEWS // n_views
            if training:
                expected = args.epochs * (smoke.VIEWS // n) * n // n_views
            if launches["segpair_fwd"] != expected:
                raise AssertionError(f"{name}: {launches} per rank, "
                                     f"expected {expected} seg launches")
            out[name] = [r[2] for r in rows[1:]]
            smoke.log(f"{name} ok in {time.time() - t0:.1f}s: losses "
                      f"{[r[0] for r in rows]} (one process "
                      f"{[r[0] for r in ref]}, worst rel {rel:.3g}), ranks "
                      f"bit-equal, {launches['segpair_fwd']} seg launches "
                      f"per rank, steady epochs {out[name]} Mpx/s; nccl: "
                      f"{str(results[0]['collectives'])}")
    smoke.log(card)
    print(json.dumps({"ranks": n, "epochs": args.epochs,
                      "steady_mpx_s": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
