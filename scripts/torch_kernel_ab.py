"""Time the seg kernels and the kNN kernel of several trees of the port in
turns on one card: an A/B in one call.

    python3 scripts/torch_kernel_ab.py --trees OLD NEW NEW OLD

Each turn runs in its own process from the tree it names: that tree's
``edgegaussians_tpu_torch`` builds its kernels (into the tree's own
``build/torch_kernels/``) and is timed on the same inputs, made by this
repository's ``chip_smoke.py`` helpers: the 5 fixture cameras at the seg
recipe's settings (both seg kernels, ms per camera, and one CTA of each
alone on each camera's longest run, device time of calls queued behind a
sleeping kernel), the fixture's 12740 means padded to 16384 rows (k = 6,
11, 15), the 131072-row cloud (k = 6), and the onehot probe on the
script's run beside ``onehot @ c`` (both also by their device time from
torch.profiler). CUDA events, median of 5 blocks. Each turn prints one
JSON line with its times and the compiler's register and shared-memory
report of the three sources; the run ends with a table of the turns and
the card's name and power limit. A tree is a checkout of the repository,
e.g. the parent commit unpacked with ``git archive`` into a git-ignored
directory.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONEHOT_CASE = "P3 onehot-matmul"


def turn(root: str) -> dict:
    """Build and time ``root``'s kernels; this repository's chip_smoke.py
    makes the inputs."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import edgegaussians_tpu_torch
    from edgegaussians_tpu_torch.lab import probes
    from edgegaussians_tpu_torch.ops import _build, knn, segpair
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: torch sees no CUDA device")
    device = torch.device("cuda")
    out = {"root": root, "package": edgegaussians_tpu_torch.__file__}
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
    for name in ("segpair", "knn", "lab_probes"):
        log = str(_build.library_path(name)) + ".log"
        out[f"{name}_ptxas"] = [ln.strip() for ln in open(log)
                                if "registers" in ln or "Compiling" in ln]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", help="trees, timed in this order")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return 0
    rows = []
    for root in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root], capture_output=True,
                              text=True, timeout=900)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
