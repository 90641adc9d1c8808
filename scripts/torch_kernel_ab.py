"""Time the compositor kernels and the kNN kernel of several trees of the
port in turns on one card: an A/B in one call.

    python3 scripts/torch_kernel_ab.py --trees OLD NEW NEW OLD

Each turn runs in its own process from the tree it names: that tree's
``edgegaussians_tpu_torch`` builds its kernels (into the tree's own
``build/torch_kernels/``) and is timed on the same inputs, made by this
repository's ``chip_smoke.py`` helpers:

- the 5 fixture cameras at the seg recipe's settings: both seg kernels,
  ms per camera, one CTA of each alone on each camera's longest run, and
  a digest of their outputs (equal between trees whose seg kernels
  compute the same bits);
- the same cameras at the recipe's dense two-level settings: both dense
  kernels, ms per camera over both levels and per level, one CTA of each
  alone on each camera's longest row of each level, level 1's backward
  with every pixel entering done (its zero fill alone), one CTA of each
  alone on faint level-2 rows of 64 and 640 slots that every pixel walks
  (their difference over 576 slots is what a slot adds), and digests;
- the same cameras' v1 single-level frames at capacity 768 (chip_smoke.py's
  v1_cases): both v1 kernels, ms per camera, one CTA of each alone on
  each camera's longest row (the most slots without the -1e30 marker; its
  bits checked against that row of the whole launch), and digests;
- the same cameras' v4 block-window tables at cap 768, budget 49152,
  block_tiles 8 (chip_smoke.py's pair_cases): both v4 pair kernels, ms
  per camera, one CTA of each alone on each camera's longest run (its
  bits checked against that row of the whole launch), and digests (the
  backward's over the rows inside runs, the only rows it writes);
- the fixture's 12740 means padded to 16384 rows (k = 6, 11, 15) and the
  131072-row cloud (k = 6);
- the onehot probe on the script's run beside ``onehot @ c`` (both also
  by their device time from torch.profiler);
- the roll probe on the script's runs P1 and P2 and the transpose probe
  on P6 (events, device time of queued calls and from torch.profiler,
  the launch floor: the profiler's device time of the same runs at one
  16-byte vector each, and digests; PR 16 on);
- the vmem_dyn probe on the script's runs P7a and P7b, summed, and the
  shard-sum kernel on chip_smoke.py's phase-7 shard, warm (the
  same shard, in L2) and cold (chip_smoke.py's COLD_SHARDS shards
  cycled): events, device time of queued calls, device time from
  torch.profiler (the kernel's and, for vmem_dyn, every activity of the
  call: the parent tree's fill too), and a digest of the outputs;
- the row sum (``ops/rank_sum.py``) on chip_smoke.py's phase-2 rank_sum
  inputs: the 5 fixture cameras' seg backward rows (ms per camera), the
  seg main path's case, the gather's backward at phase 5's shape (through
  ``gather_backward``) and a seeded case of a DTU view's shape (196608
  rows, 91373 kept, into 131072 outputs, 31790 of them reached); events
  and device time of queued calls, and one digest of its outputs on every
  phase-2 case, edge cases included, which must be equal in every turn
  (the run fails otherwise);
- the kernel lab's scene (chip_smoke.py's phase 8 inputs, PR 14 on): the
  chunked-scan kernels (csrc/lab_chunked.cu: one thread per pixel, each
  batch's live slots in sub-chunks of 16 with the scan form in
  registers), each of the four forward forms and the backward over both
  levels and per level, and a digest of each entry's outputs, beside V0,
  the production raster_v2 kernels, on the same frame. Their bits are
  held elsewhere: tests/test_torch_lab.py and tests/test_torch_lab_order.py
  on the CPU, the ``lab`` tests of tests/test_torch_kernels.py (run with
  ``--noconftest``) and chip_smoke.py phase 8 on the card.

CUDA events, median of 5 blocks; the ``*_device_ms`` and ``*_alone_ms``
keys are device time of calls queued behind a sleeping kernel
(chip_smoke.py's queued_ms), which the wrappers' ~20 us of host work a
call does not pace. Each turn prints one JSON line with its times and the
compiler's register and shared-memory report of the eight sources; the
run ends with a table of the turns and the card's name and power limit.
``--probes_only`` times the probes' part alone (a kernel variant's quick
turn; ``scripts/torch_probe_variants.py`` writes the roll and transpose
variants this repository measured); ``--rank_sum_only`` the row sum's
part alone.
A tree is a checkout of the repository, e.g. the parent commit unpacked
with ``git archive`` into a git-ignored directory, or a directory holding
a copy of ``edgegaussians_tpu_torch/`` (a variant of a kernel). Needs a
CUDA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONEHOT_CASE = "P3 onehot-matmul"
# the row sum's case of a DTU view's shape: the recipe's pair budget, the
# kept pairs and reached rows of PR 13's phase-9 view, its capacity
DTU_ROWS, DTU_KEPT, DTU_OUTPUTS, DTU_REACHED = 196608, 91373, 131072, 31790
# one CTA alone on faint level-2 rows of these lengths
DENSE_CHAIN_SLOTS = (64, 640)


def turn(root: str, probes_only: bool = False,
         rank_sum_only: bool = False) -> dict:
    """Build and time ``root``'s kernels (``probes_only``: the roll,
    transpose, vmem_dyn and shard-sum part alone; ``rank_sum_only``: the
    row sum's part alone); this repository's chip_smoke.py makes the
    inputs."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import edgegaussians_tpu_torch
    from edgegaussians_tpu_torch.lab import probes
    from edgegaussians_tpu_torch.ops import knn, segpair
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: torch sees no CUDA device")
    device = torch.device("cuda")
    out = {"root": root, "package": edgegaussians_tpu_torch.__file__}
    if probes_only:
        with torch.no_grad():
            return {**out, **probe_turn(cs, device)}
    if rank_sum_only:
        with torch.no_grad():
            return {**out, **rank_sum_turn(cs, device)}
    with torch.no_grad():
        cases, basis = cs.seg_cases(device)
        for c in cases:
            c["gt"] = (c["g"] * 0.5).contiguous()
        out["segpair_fwd_ms"] = cs.cuda_ms(lambda: [
            segpair.segpair_fwd(c["feats"], c["s_f"], basis)
            for c in cases], 20) / len(cases)
        out["segpair_bwd_ms"] = cs.cuda_ms(lambda: [
            segpair.segpair_bwd(c["feats"], c["s_f"], basis, c["gt"])
            for c in cases], 20) / len(cases)
        out["segpair_fwd_device_ms"] = cs.queued_ms(lambda: [
            segpair.segpair_fwd(c["feats"], c["s_f"], basis)
            for c in cases], 20) / len(cases)
        out["segpair_bwd_device_ms"] = cs.queued_ms(lambda: [
            segpair.segpair_bwd(c["feats"], c["s_f"], basis, c["gt"])
            for c in cases], 20) / len(cases)
        pts, mask, _ = cs.knn_inputs(device)
        for k in cs.KNN_KS:
            out[f"knn_{pts.shape[0]}_k{k}_ms"] = cs.cuda_ms(
                lambda: knn.knn(pts, k, mask), 20)
        pts, mask = cs.knn_cloud(device, cs.KNN_BIG)
        out[f"knn_{pts.shape[0]}_k{cs.KNN_BIG_K}_ms"] = cs.cuda_ms(
            lambda: knn.knn(pts, cs.KNN_BIG_K, mask), 3)
        longest = cs.longest_runs(cases, device)
        for k in ("fwd", "bwd"):
            out[f"segpair_{k}_longest_run_alone_ms"] = cs.own_run_ms(
                k, longest, basis)
        out["segpair_digest"] = digest(
            [segpair.segpair_fwd(c["feats"], c["s_f"], basis) for c in cases]
            + [segpair.segpair_bwd(c["feats"], c["s_f"], basis,
                                   c["gt"])[:int(c["s_f"][-1])]
               for c in cases])
        out.update(dense_turn(cs, device))
        out.update(v1_turn(cs, device))
        out.update(pair_turn(cs, device))
        out.update(lab_turn(cs, device))
        out.update(rank_sum_turn(cs, device))
        t = probes.case_tensors(ONEHOT_CASE, device)
        lib = cs.probe_library(ONEHOT_CASE, t)
        out["probe_onehot_ms"] = cs.cuda_ms(
            lambda: probes.probe_onehot(t["r8"], t["c"]), 200)
        out["probe_onehot_library_ms"] = cs.cuda_ms(lib, 200)
    # device times last, each in its own profiler window (chip_smoke.py's
    # profiled_device)
    out["probe_onehot_device_ms"] = cs.profiled_device(
        lambda: probes.probe_onehot(t["r8"], t["c"]),
        "probe_onehot_kernel")[0]
    out["probe_onehot_library_device_ms"] = cs.profiled_device(lib, "")[0]
    for name in ("segpair", "raster_v2", "raster_v1", "pair", "knn",
                 "lab_chunked"):
        out[f"{name}_ptxas"] = ptxas(name)
    with torch.no_grad():   # its profiler windows last, as the onehot's
        out.update(probe_turn(cs, device))
    return out


def ptxas(name: str) -> list:
    """The compiler's register, shared-memory and spill lines of
    ``csrc/<name>.cu`` as built for this turn."""
    from edgegaussians_tpu_torch.ops import _build
    log = str(_build.library_path(name)) + ".log"
    return [ln.strip() for ln in open(log)
            if "registers" in ln or "Compiling" in ln or "spill" in ln]


def probe_runs(probe: str, device):
    """A call of the script's runs of ``probe`` (all of them a call, as
    chip_smoke.py's phase 8 sums them); returns their outputs."""
    from edgegaussians_tpu_torch.lab import probes
    runs = [(case, probes.case_tensors(name, device))
            for name, case in probes.CASES.items() if case.probe == probe]
    kern = probes.KERNELS[probe][0]
    return lambda: [case.call(kern, t) for case, t in runs]


def probe_turn(cs, device) -> dict:
    """The roll probe on the script's runs P1 and P2, the transpose probe
    on P6, the vmem_dyn probe on P7a and P7b (each probe's runs a call),
    and the shard-sum kernel on phase 7's shard, warm and cold: events,
    device time of queued calls and of the profiler, and digests; for
    roll and transpose also the launch floor, the profiler's device time
    of the same runs at one 16-byte vector each (chip_smoke.py's
    probe_floor_call)."""
    import torch
    from edgegaussians_tpu_torch.ops import shard_sum
    calls = {p: probe_runs(p, device)
             for p in ("roll", "transpose", "vmem_dyn")}
    vmem = calls["vmem_dyn"]
    xs = cs.shards(device, cs.COLD_SHARDS)
    kern = shard_sum.shard_sum2x
    out = {}
    for p in cs.FLOOR_PROBES:
        out[f"probe_{p}_ms"] = cs.cuda_ms(calls[p], 200)
        out[f"probe_{p}_device_ms"] = cs.queued_ms(calls[p], 50)
        out[f"probe_{p}_digest"] = digest(calls[p]())
    out.update({
        "probe_vmem_dyn_ms": cs.cuda_ms(vmem, 200),
        "probe_vmem_dyn_device_ms": cs.queued_ms(vmem, 50),
        "probe_vmem_dyn_digest": digest(vmem()),
        "shard_sum_ms": cs.cuda_ms(lambda: kern(xs[0]), 200),
        "shard_sum_device_ms": cs.queued_ms(lambda: kern(xs[0]), 50),
        "shard_sum_cold_ms": cs.cuda_ms(cs.cycling(kern, xs), 200),
        "shard_sum_cold_device_ms": cs.queued_ms(cs.cycling(kern, xs), 50),
        "shard_sum_digest": digest(kern(x) for x in xs)})
    # the profiler's windows: the kernel's device time, and every
    # activity of the call
    for p in cs.FLOOR_PROBES:
        name = f"probe_{p}_kernel"
        out[f"probe_{p}_profiler_device_ms"] = cs.profiled_device(
            calls[p], name)[0]
        out[f"probe_{p}_floor_device_ms"] = cs.launch_floor_ms(p, device)
    out["probe_vmem_dyn_profiler_device_ms"] = cs.profiled_device(
        vmem, "probe_vmem_dyn_kernel")[0]
    out["probe_vmem_dyn_call_device_ms"], out[
        "probe_vmem_dyn_call_activities"] = cs.profiled_device(vmem, "")
    out["shard_sum_profiler_device_ms"] = cs.profiled_device(
        lambda: kern(xs[0]), "shard_sum")[0]
    out["shard_sum_profiler_cold_device_ms"] = cs.profiled_device(
        cs.cycling(kern, xs), "shard_sum")[0]
    torch.cuda.synchronize()
    for name in ("lab_probes", "shard_sum"):
        out[f"{name}_ptxas"] = ptxas(name)
    return out


def rank_sum_turn(cs, device) -> dict:
    """The row sum on chip_smoke.py's phase-2 rank_sum cases and a seeded
    case of a DTU view's shape (DTU_ROWS rows, DTU_KEPT kept, into
    DTU_OUTPUTS outputs of which DTU_REACHED are reached; PR 13's phase-9
    view): events and device time of queued calls (per camera over the
    fixture's cameras, each queued on its own, as phase 2 times them),
    and a digest of the outputs of every case."""
    import torch
    from edgegaussians_tpu_torch.ops import rank_sum as rs

    def call_of(case):
        _, rows, idx, n, valid, gather = case
        if gather:
            return lambda: rs.gather_backward(rows, idx, n)
        return lambda: rs.rank_sum(rows, idx, n, valid)
    cases = cs.rank_sum_cases(device)
    gen = torch.Generator(device=device).manual_seed(21)
    live = torch.randperm(DTU_OUTPUTS, generator=gen,
                          device=device)[:DTU_REACHED]
    idx = live[torch.randint(0, DTU_REACHED, (DTU_ROWS,), generator=gen,
                             device=device)]
    valid = torch.zeros(DTU_ROWS, dtype=torch.bool, device=device)
    valid[torch.randperm(DTU_ROWS, generator=gen,
                         device=device)[:DTU_KEPT]] = True
    rows = torch.randn((DTU_ROWS, 10), generator=gen, device=device)
    cases.append(("dtu shape", rows, idx, DTU_OUTPUTS, valid, False))
    calls = {c[0]: call_of(c) for c in cases}
    cams = [f for name, f in calls.items() if name.startswith("camera")]
    out = {"rank_sum_camera_ms": float(sum(
        cs.cuda_ms(f, 20) for f in cams)) / len(cams),
        "rank_sum_camera_device_ms": float(sum(
            cs.queued_ms(f, 20) for f in cams)) / len(cams)}
    for name in ("main path", "gather", "dtu shape"):
        key = "rank_sum_" + name.replace(" ", "_")
        out[f"{key}_ms"] = cs.cuda_ms(calls[name], 20)
        out[f"{key}_device_ms"] = cs.queued_ms(calls[name], 20)
    out["rank_sum_digest"] = digest(f() for f in calls.values())
    torch.cuda.synchronize()
    out["rank_sum_ptxas"] = ptxas("rank_sum")
    return out


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (16 hex digits)."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dense_turn(cs, device) -> dict:
    """The dense kernels on the fixture's two-level frames (chip_smoke.py's
    phase 2 dense inputs): ms per camera over both levels and per level,
    level 1's backward zero fill alone (fill_args), one CTA alone on each
    camera's longest row of each level and on faint level-2 rows of
    DENSE_CHAIN_SLOTS, and a digest of each kernel's outputs."""
    import torch
    from edgegaussians_tpu_torch.ops import tiles
    cases = cs.dense_cases(device)
    basis = tiles.pixel_basis(16, device=device)
    cs.dense_timing_inputs(cases, basis)
    out = {}
    for k in ("fwd", "bwd"):
        def calls(levels):
            return lambda: [cs.dense_call(k, cs.dense_level_args(c, lv),
                                          basis)
                            for c in cases for lv in levels]
        out[f"raster_v2_{k}_ms"] = cs.cuda_ms(calls((1, 2)), 20) / len(cases)
        out[f"raster_v2_{k}_device_ms"] = cs.queued_ms(
            calls((1, 2)), 20) / len(cases)
        for lv in (1, 2):
            out[f"raster_v2_{k}_level{lv}_device_ms"] = cs.queued_ms(
                calls((lv,)), 20) / len(cases)
        out[f"raster_v2_{k}_digest"] = digest(
            x for c in cases for lv in (1, 2)
            for x in cs.as_tuple(cs.dense_call(
                k, cs.dense_level_args(c, lv), basis)))
    fill = fill_args(cs, cases)
    out["raster_v2_bwd_level1_fill_device_ms"] = cs.queued_ms(
        lambda: [cs.dense_call("bwd", a, basis) for a in fill], 20) / len(
            cases)
    for lv in (1, 2):
        rows = cs.longest_rows(cases, lv)
        for k in ("fwd", "bwd"):
            out[f"raster_v2_{k}_level{lv}_longest_row_alone_ms"] = [
                cs.queued_ms(lambda: cs.dense_call(k, a, basis), 20)
                for a in rows]
    for s in DENSE_CHAIN_SLOTS:
        args = cs.dense_chain_case(s, device)
        for k in ("fwd", "bwd"):
            out[f"raster_v2_{k}_faint_{s}_alone_ms"] = cs.queued_ms(
                lambda: cs.dense_call(k, args, basis), 20)
    torch.cuda.synchronize()
    return out


def v1_turn(cs, device) -> dict:
    """The v1 kernels on the fixture's single-level frames (chip_smoke.py's
    phase 2 v1 inputs, the backward on its total): ms per camera, one CTA
    of each alone on each camera's longest row, and a digest of each
    kernel's outputs."""
    import torch
    from edgegaussians_tpu_torch.ops import raster_v1, tiles
    # the dead-slot rule of this repository's ops/raster_v1.py, loaded from
    # its file, so that every turn picks the same rows whatever tree it
    # times (the module's imports resolve in the tree)
    spec = importlib.util.spec_from_file_location(
        "raster_v1_rule", os.path.join(REPO, "edgegaussians_tpu_torch",
                                       "ops", "raster_v1.py"))
    rule = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rule)
    live_slots = rule.live_slots
    cases = cs.v1_cases(device)
    basis = tiles.pixel_basis(16, device=device)
    for c in cases:
        c["total"] = (0.5 + 0.5 * c["g"]).contiguous()

    def call(kernel, feats, g, total):
        if kernel == "fwd":
            return raster_v1.composite_fwd(feats, basis)
        return raster_v1.composite_bwd(feats, basis, g, total)

    out = {}
    # per camera, the row with the most live slots and its one-row frame
    longest = []
    for c in cases:
        r = int(live_slots(c["feats"]).sum(1).argmax())
        longest.append((r, c["feats"][r:r + 1].contiguous()))
    for k in ("fwd", "bwd"):
        def calls():
            return [call(k, c["feats"], c["g"], c["total"]) for c in cases]
        out[f"raster_v1_{k}_ms"] = cs.cuda_ms(calls, 20) / len(cases)
        out[f"raster_v1_{k}_device_ms"] = cs.queued_ms(calls, 20) / len(
            cases)
        out[f"raster_v1_{k}_digest"] = digest(calls())
        alone = []
        for c, (r, one) in zip(cases, longest):
            args = (one, c["g"][r:r + 1].contiguous(),
                    c["total"][r:r + 1].contiguous())
            if not torch.equal(call(k, *args)[0],
                               call(k, c["feats"], c["g"], c["total"])[r]):
                raise AssertionError(f"raster_v1_{k}: the longest row alone "
                                     "differs from that row of the launch")
            alone.append(cs.queued_ms(lambda: call(k, *args), 20))
        out[f"raster_v1_{k}_longest_row_alone_ms"] = alone
    out["raster_v1_longest_row_live"] = [
        int(live_slots(one).sum()) for _, one in longest]
    torch.cuda.synchronize()
    return out


def pair_turn(cs, device) -> dict:
    """The v4 pair kernels on the fixture's block-window tables
    (chip_smoke.py's phase 2 pair inputs, the backward on its total): ms
    per camera, one CTA of each alone on each camera's longest run, and a
    digest of each kernel's outputs."""
    import torch
    from edgegaussians_tpu_torch.ops import tiles
    cases = cs.pair_cases(device)
    basis = tiles.pixel_basis(16, device=device)
    for c in cases:
        c["total"] = (0.5 + 0.5 * c["g"]).contiguous()
    out = {}
    rows = cs.pair_longest_rows(cases, device)
    for k in ("fwd", "bwd"):
        def calls():
            return [cs.pair_call(k, cs.pair_args(c), basis) for c in cases]
        out[f"pair_{k}_ms"] = cs.cuda_ms(calls, 20) / len(cases)
        out[f"pair_{k}_device_ms"] = cs.queued_ms(calls, 20) / len(cases)
        out[f"pair_{k}_digest"] = digest(
            x if k == "fwd" else x[c["pbins"].pair_valid]
            for c, x in zip(cases, calls()))
        alone = []
        for c, (r, one) in zip(cases, rows):
            whole = cs.pair_call(k, cs.pair_args(c), basis)
            s0, n = int(c["sfp"][r]), int(c["counts"][r])
            mine = whole[r:r + 1] if k == "fwd" else whole[s0:s0 + n]
            if not torch.equal(cs.pair_call(k, one, basis), mine):
                raise AssertionError(f"pair_{k}: the longest run alone "
                                     "differs from its rows of the launch")
            alone.append(cs.queued_ms(lambda: cs.pair_call(k, one, basis),
                                      20))
        out[f"pair_{k}_longest_run_alone_ms"] = alone
    out["pair_longest_run"] = [int(one[2]) for _, one in rows]
    torch.cuda.synchronize()
    return out


def lab_turn(cs, device) -> dict:
    """The lab's chunked-scan kernels on the lab scene (chip_smoke.py's
    phase 8 inputs: level 1, then level 2 fed the plain level 1's t_out;
    the backward on the plain total and a seeded cotangent): each of the
    four forward forms and the backward over both levels, by events and
    device time, each level's device time alone, and a digest of each
    entry's outputs; beside them V0, the production raster_v2 kernels, on
    the same frame (the lab's own comparison)."""
    import torch
    from edgegaussians_tpu_torch.lab import chunked, scene
    from edgegaussians_tpu_torch.ops import raster_v2
    sc = scene.bench_scene(device=device)
    basis, f1, f2, rows = sc.basis, sc.feats1, sc.feats2, sc.rows2
    c1, c2 = sc.counts1, sc.counts2
    gen = torch.Generator(device=device).manual_seed(8)
    g1 = torch.rand((f1.shape[0], 256), generator=gen, device=device)
    ref1, tref1 = chunked.chunked_fwd_ref(f1, basis)
    tin2 = tref1[rows].contiguous()
    ref2, _ = chunked.chunked_fwd_ref(f2, basis, tin2)
    total = ref1.clone()
    total[rows] += ref2
    g2, prior2, total2 = (x[rows].contiguous() for x in (g1, ref1, total))
    levels = {
        "fwd_v0": (lambda: raster_v2.composite_fwd_seg(f1, c1, basis),
                   lambda: raster_v2.composite_fwd_seg(f2, c2, basis, tin2)),
        "bwd_v0": (lambda: raster_v2.composite_bwd_seg(f1, c1, basis, g1,
                                                       None, total),
                   lambda: raster_v2.composite_bwd_seg(f2, c2, basis, g2,
                                                       tin2, total2)),
        "bwd_v3": (lambda: chunked.chunked_bwd(f1, basis, g1, None, None,
                                               total),
                   lambda: chunked.chunked_bwd(f2, basis, g2, tin2, prior2,
                                               total2)),
    }
    for scan in chunked.SCANS:
        levels[f"fwd_{scan}"] = (
            lambda scan=scan: chunked.chunked_fwd(f1, basis, scan=scan),
            lambda scan=scan: chunked.chunked_fwd(f2, basis, tin2,
                                                  scan=scan))
    out = {}
    for name, (l1, l2) in levels.items():
        def both(l1=l1, l2=l2):
            return l1(), l2()
        out[f"lab_{name}_ms"] = cs.cuda_ms(both, 20)
        out[f"lab_{name}_device_ms"] = cs.queued_ms(both, 20)
        for lv, fn in ((1, l1), (2, l2)):
            out[f"lab_{name}_level{lv}_device_ms"] = cs.queued_ms(fn, 20)
        out[f"lab_{name}_digest"] = digest(
            x for call in (l1, l2) for x in cs.as_tuple(call()))
    torch.cuda.synchronize()
    return out


def fill_args(cs, cases) -> list:
    """Per camera, level 1's dense_level_args with every pixel entering
    done (t_in 0): no row walks, the backward writes every row as zeros,
    so its time is the fill's alone."""
    import torch
    out = []
    for c in cases:
        feats, counts, _, g, total = cs.dense_level_args(c, 1)
        out.append((feats, counts, torch.zeros_like(g), g, total))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", help="trees, timed in this order")
    ap.add_argument("--probes_only", action="store_true",
                    help="time the roll, transpose, vmem_dyn and shard-sum "
                    "part alone")
    ap.add_argument("--rank_sum_only", action="store_true",
                    help="time the row sum's part alone")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.probes_only,
                              args.rank_sum_only)), flush=True)
        return 0
    rows = []
    for root in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root]
                              + ["--probes_only"] * args.probes_only
                              + ["--rank_sum_only"] * args.rank_sum_only,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    keys = [k for k in rows[0] if k.endswith("_ms")]
    print("turn  " + "  ".join(keys))
    for i, r in enumerate(rows):
        print(f"{i} {r['root']}  " + "  ".join(
            "/".join(f"{x:.4f}" for x in r[k]) if isinstance(r[k], list)
            else f"{r[k]:.4f}" for k in keys))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sums = {r.get("rank_sum_digest") for r in rows}
    if len(sums) > 1:
        print(f"torch_kernel_ab: the row sum's digests differ between the "
              f"trees: {sums}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
