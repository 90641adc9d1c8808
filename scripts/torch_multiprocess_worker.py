"""One rank of a multi-process run of the PyTorch port.

The counterpart of ``scripts/multiprocess_worker.py`` for
``edgegaussians_tpu_torch``: every rank runs this file with the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; torchrun sets them, tests/test_torch_parallel.py sets
them by hand), joins the group, runs its tasks and writes
``<out>/rank<r>.npz``. Inputs come from one ``.npz`` (``--inputs``) that
every rank reads, so the ranks start from the same bytes.

Tasks (``--tasks``, comma-separated):

- ``proj``: the tile-band and Gaussian-axis proj-grads of view 0 for the
  three loss strategies, on ('tiles', world) and ('gauss', world) meshes,
  and the tile-sharded 'whole' loss of view 0's top 64 rows
  (``train_dp.make_tile_sharded_render``);
- ``dp``: view-batch steps on a flat ('views', world) mesh and, at world
  4, on 2x2 views x tiles and views x gauss meshes;
- ``probe``: the shard-sum probe (``parallel/distributed.sharded_sum2x``)
  on this rank's shard of one array, and the all-gather's backward on
  per-rank cotangents;
- ``train``: ``trainer.train`` for the inputs' epochs on a ('tiles',
  world) mesh, then in view batches on a ('views', world) mesh, then
  those view batches with staged capacity (a growth at the duplication);
- ``cli``: the probe on the device of ``--device``, a probe of which
  collectives the backend takes on that device, then the port's training
  CLI with the arguments after ``--`` in the same group (the
  ``chip_smoke.py`` phase 7c run).

``--device`` is ``cuda`` unless the caller asks for the CPU: without a GPU
the worker exits with an error that names ``--device cpu``, and never
falls back to the CPU. ``proj``, ``dp`` and ``train`` are the CPU
harnesses that tests/test_torch_parallel.py holds to the JAX package, and
refuse ``--device cuda``; ``probe`` and ``cli`` run on either device.

    torchrun --standalone --nproc_per_node 2 \\
        scripts/torch_multiprocess_worker.py --tasks cli \\
        --dist_backend gloo --out DIR -- --config_file ... --mesh_tiles 2
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from edgegaussians_tpu_torch import convert
from edgegaussians_tpu_torch.config import config_from_dict
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.parallel import distributed, mesh as mesh_mod

# the tasks that run on the CPU only (held to the JAX package there)
CPU_TASKS = ("proj", "dp", "train")
# the probe's array: ROWS_PER_RANK rows of 128 lanes per rank
PROBE_ROWS_PER_RANK = 16384
PROBE_SEED = 5
TILE_RENDER_H = 64          # 4 tile rows: one per rank at world 4


def probe_array(world: int, device) -> torch.Tensor:
    """The whole [world * PROBE_ROWS_PER_RANK, 128] probe array of uniform
    draws in [0, 1), the same on every rank (NumPy seed)."""
    x = np.random.default_rng(PROBE_SEED).random(
        (world * PROBE_ROWS_PER_RANK, 128)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def load_inputs(path):
    with np.load(path, allow_pickle=False) as d:
        data = {k: d[k] for k in d.files}
    cfg = config_from_dict(json.loads(str(data["cfg_json"])))
    state_arrays = {k: v for k, v in data.items() if k.startswith("f:")}
    return cfg, data, state_arrays


def fresh_state(state_arrays):
    return convert.state_from_arrays(state_arrays, device="cpu")


def scene_tensors(data):
    images = torch.from_numpy(data["images"])
    return (images, images >= float(data["edge_threshold"]),
            torch.from_numpy(data["viewmats"]), torch.from_numpy(data["Ks"]))


def task_proj(cfg, data, state_arrays, out):
    from edgegaussians_tpu_torch.parallel.train_sharded import \
        make_sharded_proj_grad_fn
    from edgegaussians_tpu_torch.parallel.train_tp import make_tp_proj_grad_fn
    images, edge_masks, vms, Ks = scene_tensors(data)
    h, w = images.shape[1:]
    world = distributed.world_size()
    state = fresh_state(state_arrays)
    scores = torch.from_numpy(data["bg_scores"][0])
    for axis, make in (("tiles", make_sharded_proj_grad_fn),
                       ("gauss", make_tp_proj_grad_fn)):
        fn = make(cfg, w, h, mesh_mod.axis_mesh(axis, world), axis)
        for s in (0, 1, 2):
            loss, stats, grads, gsink = fn(state.model, vms[0], Ks[0],
                                           images[0], edge_masks[0], s,
                                           float(data["bg_ratio"]), scores)
            key = f"proj_{axis}_s{s}"
            out[f"{key}_loss"] = loss.numpy()
            out[f"{key}_stats"] = torch.stack(list(stats)).numpy()
            out[f"{key}_sink"] = gsink.numpy()
            for g in GROUPS:
                out[f"{key}_{g}"] = grads[g].numpy()
    # a capacity the 'gauss' axis does not divide is refused, on every
    # rank alike, before any collective
    from edgegaussians_tpu_torch.models.gaussians import GaussianModel
    try:
        fn(GaussianModel(state.model.capacity - 2), vms[0], Ks[0], images[0],
           edge_masks[0], 0, 1.0)
        out["tp_indivisible_error"] = np.array("")
    except ValueError as e:
        out["tp_indivisible_error"] = np.array(str(e))
    from edgegaussians_tpu_torch.parallel.train_dp import \
        make_tile_sharded_render
    fn = make_tile_sharded_render(cfg, w, TILE_RENDER_H,
                                  mesh_mod.axis_mesh("tiles", world))
    loss, grads, gsink = fn(state.model, vms[0], Ks[0],
                            images[0, :TILE_RENDER_H])
    out["tile_render_loss"] = loss.numpy()
    out["tile_render_sink"] = gsink.numpy()
    for g in GROUPS:
        out[f"tile_render_{g}"] = grads[g].numpy()


def dp_meshes(world):
    meshes = [("flat", lambda: mesh_mod.make_mesh(world, 1))]
    if world == 4:
        meshes += [("tiles", lambda: mesh_mod.make_mesh(2, 2)),
                   ("gauss", lambda: mesh_mod.make_views_gauss_mesh(2, 2))]
    return meshes


def task_dp(cfg, data, state_arrays, out):
    from edgegaussians_tpu_torch.parallel.train_dp import make_dp_train_step
    images, edge_masks, vms, Ks = scene_tensors(data)
    h, w = images.shape[1:]
    world = distributed.world_size()
    for name, make in dp_meshes(world):
        state = fresh_state(state_arrays)
        step = make_dp_train_step(cfg, w, h, make())
        for i, epoch in enumerate(data["dp_epochs"].tolist()):
            scores = [torch.from_numpy(x)
                      for x in data[f"dp_bg_scores_{name}"][i]]
            loss, stats = step(state, epoch, images, edge_masks, vms, Ks,
                               bg_scores=scores)
            out[f"dp_{name}_loss{i}"] = loss.numpy()
            out[f"dp_{name}_stats{i}"] = torch.stack(list(stats)).numpy()
        for k, v in convert.state_to_arrays(state).items():
            out[f"dp_{name}:{k}"] = v


def task_probe(out, device="cpu"):
    """The shard-sum probe on this rank's rows of the probe array, and
    the all-gather's backward: rank r's loss is sum(w_r * gathered) with
    w_r = (r + 1) * (1 + arange), so each shard's gradient must be the sum
    over the ranks' w_r on its rows, (world (world + 1) / 2) times w_0's,
    not world times its own."""
    from edgegaussians_tpu_torch.ops import shard_sum
    from edgegaussians_tpu_torch.parallel.train_tp import all_gather_rows
    world, r = distributed.world_size(), distributed.rank()
    mesh = mesh_mod.axis_mesh("tiles", world)
    x = probe_array(world, device)
    mine = x[r * PROBE_ROWS_PER_RANK:(r + 1) * PROBE_ROWS_PER_RANK]
    shard_sum.reset_launch_counts()
    out["probe_sum"] = distributed.sharded_sum2x(
        mine.contiguous(), mesh, ["tiles"]).cpu().numpy()
    out["probe_launches"] = np.int64(shard_sum.launch_counts["shard_sum"])
    out["probe_plain"] = shard_sum.shard_sum2x_ref(x).cpu().numpy()
    rows = 3
    shard = (torch.arange(rows * 8, dtype=torch.float32, device=device)
             .reshape(rows, 8) + 100.0 * r).requires_grad_()
    gathered = all_gather_rows(shard, mesh, "tiles")
    wr = (r + 1) * (1.0 + torch.arange(gathered.numel(), dtype=torch.float32,
                                       device=device)
                    .reshape(gathered.shape))
    (grad,) = torch.autograd.grad((wr * gathered).sum(), [shard])
    out["gather_value"] = gathered.detach().cpu().numpy()
    out["gather_grad"] = grad.cpu().numpy()


def staged_config(cfg):
    """``cfg`` with staged capacity up to 4096 rows, its threshold cut so
    that a duplication epoch grows the capacity."""
    import dataclasses
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, staged_capacity=True, max_num_gaussians=4096,
        staged_capacity_grow_threshold=0.15))


def task_train(cfg, data, out):
    """Epoch losses and final states of a tile-band run, a view-batch run
    and a staged-capacity view-batch run on this rank."""
    import dataclasses

    from edgegaussians_tpu_torch.data.parsers import SceneViews
    from edgegaussians_tpu_torch.train import trainer
    world = distributed.world_size()
    scene = SceneViews(images=data["images"], Ks=data["Ks"],
                       viewmats=data["viewmats"],
                       height=int(data["images"].shape[1]),
                       width=int(data["images"].shape[2]), cameras=None)
    seeds = data["seeds"]
    batched = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, step_mode="view_batch",
        view_batch_size=int(data["view_batch_size"])))
    runs = (("tiles", cfg, mesh_mod.axis_mesh("tiles", world)),
            ("views", batched, mesh_mod.make_mesh(world, 1)),
            ("staged", staged_config(batched), mesh_mod.make_mesh(world, 1)))
    for name, run_cfg, mesh in runs:
        lines = []
        state = trainer.train(scene, seeds, run_cfg, backend="torch",
                              log_fn=lines.append, mesh=mesh)
        out[f"train_{name}_log"] = np.array("\n".join(lines))
        for k, v in convert.state_to_arrays(state).items():
            out[f"train_{name}:{k}"] = v


COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor")


def probe_collectives(device) -> dict:
    """Which collectives the group's backend takes on ``device``: each is
    called once on tensors there; the answer is ok or the error's first
    line."""
    import torch.distributed as dist
    world = distributed.world_size()
    x = torch.ones(8, device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=device), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8, device=device), torch.ones(8 * world,
                                                       device=device)),
    }
    result = {}
    for name in COLLECTIVES:
        try:
            calls[name]()
            if device.type == "cuda":
                torch.cuda.synchronize()
            result[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            result[name] = f"{type(e).__name__}: " + \
                str(e).strip().splitlines()[0][:160]
        # a rank that failed a collective may leave its peers waiting:
        # realign before the next one
        dist.barrier()
    return result


def task_cli(args, out):
    """The probe and the collective probe on ``args.device``, then the
    training CLI in this group, each rank's launches and final state."""
    from edgegaussians_tpu_torch.cli import train as train_cli
    from edgegaussians_tpu_torch.ops import (
        knn, pair, rank_sum, raster_v1, raster_v2, segpair, shard_sum)
    device = torch.device(args.device)
    task_probe(out, device)
    out["collectives"] = np.array(json.dumps(probe_collectives(device)))
    mods = (segpair, raster_v2, knn, pair, raster_v1, rank_sum, shard_sum)
    for mod in mods:
        mod.reset_launch_counts()
    t0 = time.time()
    state = train_cli.run(args.cli_args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["cli_seconds"] = np.float64(time.time() - t0)
    out["launches"] = np.array(json.dumps(
        {k: v for mod in mods for k, v in mod.launch_counts.items()}))
    for k, v in convert.state_to_arrays(state).items():
        out[f"cli:{k}"] = v


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cli_args = []
    if "--" in argv:
        i = argv.index("--")
        argv, cli_args = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", required=True)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--dist_backend", default=None,
                    choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    args.cli_args = cli_args
    tasks = args.tasks.split(",")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_multiprocess_worker: torch sees no CUDA "
                             "device; pass --device cpu to run on the CPU")
        cpu_only = [t for t in tasks if t in CPU_TASKS]
        if cpu_only:
            raise SystemExit(f"torch_multiprocess_worker: tasks {cpu_only} "
                             "run on the CPU only; pass --device cpu")
    torch.set_num_threads(1)
    if not distributed.initialize(args.dist_backend,
                                  device_type=args.device):
        raise SystemExit("run this worker under torchrun (or with its "
                         "environment): no process group to join")
    out = {}
    try:
        if args.inputs:
            cfg, data, state_arrays = load_inputs(args.inputs)
        if "proj" in tasks:
            task_proj(cfg, data, state_arrays, out)
        if "dp" in tasks:
            task_dp(cfg, data, state_arrays, out)
        if "probe" in tasks:
            task_probe(out, torch.device(args.device))
        if "train" in tasks:
            task_train(cfg, data, out)
        if "cli" in tasks:
            task_cli(args, out)
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{distributed.rank()}.npz"),
                 **out)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
