"""Quality spread of the PyTorch port's whole ABC recipe on one GPU.

    python3 scripts/torch_quality_spread.py [--train_seeds 1 2 3]
        [--cluster_seeds 0 1 2]
    python3 scripts/torch_quality_spread.py --repeat_seed S --until_epoch E

Generates SYN01, a 50-view 800x800 synthetic scan, as
``cli/make_synthetic.py --seed 11`` does (scan i of ``--seed s`` uses seed
s + i), the scan of the JAX package's quality figures (docs/RESULTS.md),
then per training seed trains the unmodified
``configs/ABC_DexiNed.json`` (only ``training.seed`` replaced) through
``edgegaussians_tpu_torch.cli.train --backend cuda`` and, per clustering
seed, runs the port's ``cli.fit_edges --seed`` and ``cli.evaluate``. Prints
one line per (training seed, clustering seed), then the mean and standard
deviation of chamfer and F@5/10/20 over all of them and over the training
seeds' first clustering seed, and the card's name and power limit. Each
training seed's line also gives the final live Gaussian count (the
``Exported N Gaussians`` of the CLI) and its last epoch line.

``--repeat_seed S --until_epoch E`` asks whether training is deterministic
on the card instead: it trains seed S twice, in this process, through the
CLI and the unmodified recipe, to the end of epoch E (the first
duplication is at epoch 40), takes the whole training state at the end of
every epoch (the checkpoint's arrays: ``alive``, every parameter, the Adam
moments, absgrads, step, generator) and compares the two runs bit for bit,
epoch by epoch. It prints "bit-equal" or the first epoch and tensor that
differ and by how much. If they differ, it trains that seed twice more to
the end of that epoch with every ATen op of the epoch's view steps
recorded (a checksum of its inputs and of its outputs on the device, and
the port's file:line that called it), and prints the first op whose
outputs differ between the two runs, and the first whose inputs were
equal. The kernels of ``csrc/`` are not ATen ops: a difference they made
shows as the inputs of the op that reads their output.

Needs a CUDA GPU; imports nothing of JAX. Training and scoring are
``chip_smoke.py``'s ``train_cli_run`` and ``downstream``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repo root is on sys.path only now)

KEYS = ("chamfer", "F@5", "F@10", "F@20")
SCAN, SCAN_SEED = "SYN01", 11


def score(tmp: str, scan: str, cfg_path: str, out_dir: str,
          cluster_seed: int) -> dict:
    with contextlib.redirect_stdout(io.StringIO()):
        _, per_scan, pr = chip_smoke.downstream(
            tmp, scan, cfg_path, out_dir, "metrics", cluster_seed)
    if per_scan is None:
        raise RuntimeError(f"no predictions for {scan}")
    return {"chamfer": per_scan["chamfer_dist"], "acc": per_scan["acc"],
            "comp": per_scan["comp"],
            **{f"F@{int(t * 1000)}": pr[f"fscore_{t}"][0]
               for t in (0.005, 0.01, 0.02)}}


class _Stop(Exception):
    """Ends a training run at the end of the epoch asked for."""


def train_to_epoch(tmp: str, seed: int, until: int, tag: str,
                   on_epoch=None) -> dict:
    """Train ``seed`` through the CLI to the end of epoch ``until``; returns
    {epoch: the state's checkpoint arrays at that epoch's end}. The recipe
    is unchanged but for ``checkpoint_interval`` 1, whose checkpoints are
    taken in memory (trainer.save_checkpoint replaced) and change nothing
    of the run. ``on_epoch(epoch)`` runs before each epoch's view steps
    (trainer.run_epoch wrapped) and returns a context to run them in."""
    from edgegaussians_tpu_torch import convert
    from edgegaussians_tpu_torch.train import trainer
    states = {}

    def save(state, out_dir, epoch):
        states[epoch] = convert.state_to_arrays(state)
        if epoch >= until:
            raise _Stop()

    run_epoch = trainer.run_epoch

    def traced_epoch(state, epoch, *a, **kw):
        with on_epoch(epoch):
            return run_epoch(state, epoch, *a, **kw)

    saved = (trainer.save_checkpoint, trainer.run_epoch)
    trainer.save_checkpoint = save
    if on_epoch is not None:
        trainer.run_epoch = traced_epoch
    try:
        chip_smoke.train_cli_run(tmp, SCAN, None, tag,
                                 views=chip_smoke.FULL_VIEWS, echo=False,
                                 seed=seed,
                                 training={"checkpoint_interval": 1})
    except _Stop:
        pass
    finally:
        trainer.save_checkpoint, trainer.run_epoch = saved
    return states


def differences(a: dict, b: dict) -> list:
    """[(key, elements that differ, max abs difference)] of every state
    tensor where the arrays ``a`` and ``b`` of one epoch differ."""
    out = []
    for key in sorted(a):
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.shape != y.shape:
            out.append((key, f"shapes {x.shape} {y.shape}", float("nan")))
        elif not np.array_equal(x, y, equal_nan=True):
            big = np.abs(x.astype(np.float64) - y.astype(np.float64))
            out.append((key, int((x != y).sum()), float(np.nanmax(big))))
    return out


def _checksum(obj):
    """One int64 on the device: the sum of the bit patterns of every
    tensor in ``obj`` (exact, so it does not depend on the sum's order)."""
    from torch.utils._pytree import tree_leaves
    total = None
    for t in tree_leaves(obj):
        if not isinstance(t, torch.Tensor) or t.numel() == 0:
            continue
        t = t.detach().reshape(-1)
        if t.dtype.is_floating_point:
            t = t.contiguous().view({2: torch.int16, 4: torch.int32,
                                     8: torch.int64}[t.element_size()])
        s = t.to(torch.int64).sum()
        total = s if total is None else total + s
    return total


def _site() -> str:
    """The innermost frame of the port that called the op (file:line)."""
    for f in reversed(traceback.extract_stack()[:-3]):
        if "edgegaussians_tpu_torch" in f.filename:
            return f"{f.filename.split('edgegaussians_tpu_torch')[-1]}" \
                f":{f.lineno}"
    return "?"


def op_recorder():
    """A TorchDispatchMode recording (op, site, input checksum, output
    checksum) of every ATen op it sees; outputs of allocations (empty*)
    hold no values yet and are not summed."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = _checksum((args, kwargs))
            out = func(*args, **kwargs)
            name = str(func)
            outs = None if "empty" in name else _checksum(out)
            self.ops.append((name, _site(), ins, outs))
            return out

    return Recorder()


def first_op_difference(tmp: str, seed: int, epoch: int) -> None:
    """Train ``seed`` twice to the end of ``epoch`` with that epoch's view
    steps under op_recorder; print the first op whose outputs differ and
    the first whose inputs were equal while its outputs differed."""
    runs = []
    for i in range(2):
        rec = op_recorder()

        def on_epoch(e, rec=rec):
            return rec if e == epoch else contextlib.nullcontext()
        train_to_epoch(tmp, seed, epoch, f"trace{seed}_{i}", on_epoch)
        runs.append([(name, site,
                      None if x is None else int(x),
                      None if y is None else int(y))
                     for name, site, x, y in rec.ops])
    a, b = runs
    print(f"epoch {epoch}: {len(a)} and {len(b)} ops recorded", flush=True)
    first = None
    for i, (x, y) in enumerate(zip(a, b)):
        if x[:2] != y[:2]:
            print(f"op {i}: the runs part ways: {x[:2]} against {y[:2]}")
            break
        if x[3] != y[3]:
            if first is None:
                first = i
                print(f"first op whose outputs differ: op {i} {x[0]} at "
                      f"{x[1]} (inputs {'equal' if x[2] == y[2] else 'differ'})",
                      flush=True)
            if x[2] == y[2]:
                print(f"first op with equal inputs and different outputs: "
                      f"op {i} {x[0]} at {x[1]}", flush=True)
                return
    if first is None:
        print("no op's outputs differ in the traced epoch")


def repeat_seed(seed: int, until: int) -> None:
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    with tempfile.TemporaryDirectory() as tmp:
        generate_scene(tmp, SCAN, seed=SCAN_SEED,
                       n_views=chip_smoke.FULL_VIEWS, width=800, height=800)
        t0 = time.time()
        a = train_to_epoch(tmp, seed, until, f"repeat{seed}_a")
        b = train_to_epoch(tmp, seed, until, f"repeat{seed}_b")
        alive = [int(np.asarray(r[until][k]).sum()) for r in (a, b)
                 for k in r[until] if k.endswith("alive")]
        print(f"seed {seed} trained twice to the end of epoch {until} in "
              f"{time.time() - t0:.1f}s; alive {alive}", flush=True)
        first = None
        for e in sorted(set(a) & set(b)):
            diff = differences(a[e], b[e])
            if diff and first is None:
                first = e
            if first is not None:
                print(f"epoch {e}: " + ("equal" if not diff else "; ".join(
                    f"{k} {n} elements differ, max abs {big:.3g}"
                    for k, n, big in diff)), flush=True)
        if first is None:
            print(f"bit-equal: every state tensor at the end of every epoch "
                  f"0..{until}")
            return
        print(f"first difference at the end of epoch {first}", flush=True)
        first_op_difference(tmp, seed, first)


def summary(rows, what: str) -> None:
    vals = {k: np.array([r[k] for r in rows]) for k in KEYS}
    print(f"{what} (n={len(rows)}): " + ", ".join(
        f"{k} {vals[k].mean():.5f} +- {vals[k].std():.5f}" for k in KEYS))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--cluster_seeds", type=int, nargs="+",
                    default=[0, 1, 2])
    ap.add_argument("--repeat_seed", type=int, default=None,
                    help="train this seed twice and compare the runs")
    ap.add_argument("--until_epoch", type=int, default=40,
                    help="with --repeat_seed: the last epoch compared")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.repeat_seed is not None:
        repeat_seed(args.repeat_seed, args.until_epoch)
        print(card_line())
        return 0
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    rows, firsts = [], []
    with tempfile.TemporaryDirectory() as tmp:
        generate_scene(tmp, SCAN, seed=SCAN_SEED,
                       n_views=chip_smoke.FULL_VIEWS, width=800, height=800)
        for seed in args.train_seeds:
            t0 = time.time()
            text, _, out_dir, cfg_path = chip_smoke.train_cli_run(
                tmp, SCAN, None, f"seed{seed}", views=chip_smoke.FULL_VIEWS,
                echo=False, seed=seed)
            wall = time.time() - t0
            last = [x for x in text.splitlines() if x.startswith("epoch ")][-1]
            live = re.search(r"Exported (\d+) Gaussians", text).group(1)
            for cs in args.cluster_seeds:
                r = score(tmp, SCAN, cfg_path, out_dir, cs)
                rows.append(r)
                if cs == args.cluster_seeds[0]:
                    firsts.append(r)
                print(f"train seed {seed} cluster seed {cs}: " + ", ".join(
                    f"{k} {v:.5f}" for k, v in r.items())
                    + f" (final live Gaussians {live}; train wall "
                    f"{wall:.1f}s; {last})", flush=True)
    summary(rows, "all runs")
    summary(firsts, "per training seed")
    print(card_line())
    return 0


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
