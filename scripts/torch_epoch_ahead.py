"""One epoch ahead from the JAX trainer's own states: at chosen epochs of
the JAX package's trajectory, the port starts from the JAX state and runs
that epoch and its density event with the JAX draws injected, on the CPU
and on the card. Two whole runs part after the first duplication whose
threshold a rounding crosses; one epoch from the same state shows what
each epoch does differently, without that chaos.

    python3 scripts/torch_epoch_ahead.py save [--epochs 0,40,...]
        [--views 10] [--size 800] [--train_seed 1] [--out DIR]
    python3 scripts/torch_epoch_ahead.py run [--devices cpu cuda]
        [--out DIR]

``save`` (the JAX package, on the CPU; ``JAX_PLATFORMS=cpu`` is set
before JAX loads) writes the scan of ``scripts/torch_quality_cut.py``
(SYN01, ``make_synthetic --seed 11``, cut to ``--views`` views of
``--size`` pixels) with the JAX package's generator, trains the
unmodified ``configs/ABC_DexiNed.json`` with ``training.seed`` set to
``--train_seed`` through the JAX trainer's epoch and density functions
on the XLA compositor (what ``backend="auto"`` picks on the CPU), and at
each listed epoch writes ``ep<e>.npz``: the state before the epoch in the
checkpoint key layout, the epoch's view order, the bg_edge_ratio scores
of the renders that use them, the duplication noise, and the JAX epoch's
mean loss, its state after the epoch (before density control) and
``alive`` after density control. The draws are the JAX trainer's
(trainer.py:297-299, :217, :671), as tests/test_torch_trajectory.py
draws them.

``run`` (the port; imports nothing of JAX) loads each ``ep<e>.npz`` on
each of ``--devices``, runs the port's ``run_epoch`` and
``run_density_control`` with those draws, and prints one JSON line per
epoch and device: the loss against JAX's (relative), each parameter
group's largest and mean move apart from JAX's after the epoch in units
of the group's learning rate (over the rows JAX has alive), the summed
absgrads against JAX's, and the live count after density control beside
JAX's with the number of ``alive`` slots that differ. With two devices it
also prints the same numbers of the second against the first.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RECIPE = os.path.join(REPO, "configs", "ABC_DexiNed.json")
SCAN, SCAN_SEED = "SYN01", 11
GROUPS = ("means", "scales", "quats", "opacities")
# the recipe's events: the duplications, the opacity reset and the ratio
# loss's start (100), the culls, the direction loss's start (250)
EPOCHS = "0,40,50,60,100,101,125,145,160,210,250,251,310,350,375,399"


def recipe(out: str, seed: int) -> dict:
    with open(RECIPE) as f:
        d = json.load(f)
    d["training"]["seed"] = seed
    d["data"]["base_dir"] = os.path.join(out, "scan", "data") + "/"
    return d


def save(args) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from edgegaussians_tpu.config import config_from_dict
    from edgegaussians_tpu.data import parsers
    from edgegaussians_tpu.data import seed_points as seeds_mod
    from edgegaussians_tpu.data.synthetic import generate_scene
    from edgegaussians_tpu.train import trainer as jtrainer
    os.makedirs(args.out, exist_ok=True)
    generate_scene(os.path.join(args.out, "scan"), SCAN, seed=SCAN_SEED,
                   n_views=args.views, width=args.size, height=args.size)
    d = recipe(args.out, args.train_seed)
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(d, f)
    cfg = config_from_dict(d)
    scene = parsers.load_scene(cfg.data, SCAN)
    w, h, views = scene.width, scene.height, scene.num_views
    # the seeds as the JAX training CLI draws them (cli/train.py:78-85)
    seeds = seeds_mod.init_seed_points_random(
        cfg.model.init_min_num_gaussians, cfg.model.random_init_box_center,
        cfg.model.random_init_box_size,
        np.random.default_rng(cfg.training.seed))
    images = np.asarray(scene.images, np.float32)
    edges = images >= cfg.model.edge_detection_threshold
    jimg, jedge, jvm, jk = (jnp.asarray(a) for a in (
        images, edges, scene.viewmats, scene.Ks))
    ts = jtrainer.init_train_state(seeds, cfg)
    epoch_fn = jtrainer.make_epoch_fn(cfg, w, h, "jax")
    density_fn = jtrainer.make_density_fn(cfg)
    dkey = jax.random.PRNGKey(cfg.training.seed + 1)
    n_copies = cfg.model.dup_factor - 1
    pl_cfg = cfg.training.loss.projection_losses
    ratio = max(int(pl_cfg.sampling_whole_num_epochs_ratio), 1)
    wanted = sorted(int(e) for e in args.epochs.split(","))

    def arrays(state, prefix):
        return {prefix + jtrainer._ckpt_field_key(p): np.asarray(leaf)
                for p, leaf in jax.tree_util.tree_flatten_with_path(
                    state)[0]}

    for epoch in range(wanted[-1] + 1):
        keep = epoch in wanted
        if keep:
            rec = arrays(ts, "s:")
            step = int(ts.step)
            key, k_perm = jax.random.split(ts.key)
            rec["order"] = np.asarray(jax.random.permutation(k_perm, views))
            bg_steps = []
            for i in range(views):
                _, k_bg, key = jax.random.split(key, 3)
                # only bg_edge_ratio renders read their scores
                if (epoch > pl_cfg.start_alternating_at_epoch
                        and (step + i) % ratio == 0):
                    rec[f"bg:{step + i}"] = np.asarray(
                        jax.random.uniform(k_bg, (h * w,)))
                    bg_steps.append(step + i)
        ts, stats = epoch_fn(ts, jnp.int32(epoch), jimg, jedge, jvm, jk)
        dkey, sub = jax.random.split(dkey)
        if keep:
            rec["loss"] = np.float64(stats.avg_loss)
            rec.update(arrays(ts, "m:"))
            rec["noise"] = np.asarray(jax.random.normal(
                sub, (n_copies, ts.gaussians.capacity, 3)))
        ts, _ = jtrainer.run_density_control(ts, epoch, cfg, jvm, jk, jedge,
                                             sub, density_fn=density_fn)
        if keep:
            rec["alive_after"] = np.asarray(ts.gaussians.alive)
            np.savez(os.path.join(args.out, f"ep{epoch}.npz"), **rec)
            print(f"epoch {epoch}: saved (loss {float(stats.avg_loss):.6f}, "
                  f"alive {int(rec['alive_after'].sum())}, bg renders "
                  f"{bg_steps})", flush=True)
    return 0


def run(args) -> int:
    import torch

    from edgegaussians_tpu_torch import convert
    from edgegaussians_tpu_torch.config import config_from_dict
    from edgegaussians_tpu_torch.data import parsers
    from edgegaussians_tpu_torch.train import trainer
    if "cuda" in args.devices and not torch.cuda.is_available():
        raise SystemExit("--devices cuda: torch sees no CUDA device")
    with open(os.path.join(args.out, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    scene = parsers.load_scene(cfg.data, SCAN)
    w, h = scene.width, scene.height
    lrs = {g: getattr(cfg.training.optim, g).start_lr for g in GROUPS}
    proj = trainer.make_proj_grad_fn(cfg, w, h)

    def epoch_ahead(z, epoch: int, device: str):
        dev = torch.device(device)
        state = convert.state_from_arrays(
            {k[2:]: v for k, v in z.items() if k.startswith("s:")},
            device=dev)
        images = torch.from_numpy(np.asarray(scene.images, np.float32)).to(
            dev)
        edges = images >= cfg.model.edge_detection_threshold
        vms = torch.from_numpy(np.asarray(scene.viewmats, np.float32)).to(
            dev)
        ks = torch.from_numpy(np.asarray(scene.Ks, np.float32)).to(dev)
        bg = {int(k[3:]): torch.from_numpy(v).to(dev)
              for k, v in z.items() if k.startswith("bg:")}
        stats = trainer.run_epoch(state, epoch, images, edges, vms, ks, cfg,
                                  proj, view_order=z["order"].tolist(),
                                  bg_scores=bg)
        mid = {g: getattr(state.model, g).detach().cpu().clone()
               for g in GROUPS}
        mid["absgrads"] = state.model.absgrads.detach().cpu().clone()
        trainer.run_density_control(
            state, epoch, cfg, vms, ks, edges,
            noise=torch.from_numpy(z["noise"]).to(dev))
        return stats.avg_loss, mid, state.model.alive.cpu()

    def compare(loss, mid, alive, loss_ref, mid_ref, alive_ref, rows):
        out = {"loss_rel": abs(loss - loss_ref) / abs(loss_ref)}
        for g in GROUPS:
            gap = (mid[g][rows] - mid_ref[g][rows]).abs()
            out[f"{g}_max_lr"] = float(gap.max()) / lrs[g]
            out[f"{g}_mean_lr"] = float(gap.mean()) / lrs[g]
        ref_sum = float(mid_ref["absgrads"][rows].sum())
        out["absgrad_sum_ratio"] = (float(mid["absgrads"][rows].sum())
                                    / ref_sum if ref_sum else None)
        out["alive"] = int(alive.sum())
        out["alive_ref"] = int(alive_ref.sum())
        out["alive_slots_differ"] = int((alive != alive_ref).sum())
        return out

    paths = sorted(glob.glob(os.path.join(args.out, "ep*.npz")),
                   key=lambda p: int(os.path.basename(p)[2:-4]))
    for path in paths:
        epoch = int(os.path.basename(path)[2:-4])
        with np.load(path) as npz:
            z = {k: npz[k] for k in npz.files}
        jmid = {g: torch.from_numpy(z[f"m:f:.gaussians.params.{g}"])
                for g in GROUPS}
        jmid["absgrads"] = torch.from_numpy(z["m:f:.gaussians.absgrads"])
        jalive = torch.from_numpy(z["alive_after"])
        rows = torch.from_numpy(z["m:f:.gaussians.alive"])
        done = {}
        for device in args.devices:
            done[device] = epoch_ahead(z, epoch, device)
            print(json.dumps({"epoch": epoch, "device": device,
                              "against": "jax", **compare(
                                  *done[device], float(z["loss"]), jmid,
                                  jalive, rows)}), flush=True)
        if len(args.devices) == 2:
            a, b = args.devices
            print(json.dumps({"epoch": epoch, "device": b, "against": a,
                              **compare(*done[b], *done[a], rows)}),
                  flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("save", "run"))
    ap.add_argument("--epochs", default=EPOCHS)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--train_seed", type=int, default=1)
    ap.add_argument("--devices", nargs="+", default=["cpu", "cuda"],
                    choices=("cpu", "cuda"))
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "epoch_ahead"))
    args = ap.parse_args(argv)
    return save(args) if args.mode == "save" else run(args)


if __name__ == "__main__":
    raise SystemExit(main())
