"""Drivers of the kernel lab's entry points: ``scripts/torch_kernel_lab.py``
(:func:`kernel_lab`), ``scripts/torch_cumprod_lab.py`` (:func:`cumprod_lab`)
and ``scripts/torch_segpair_probe.py`` (:func:`probe_lab`), the
counterparts of the JAX ``main()`` functions of ``scripts/kernel_lab.py``,
``scripts/cumprod_lab.py`` and ``scripts/segpair_mosaic_probe.py``.

They run on the card by default: each wrapper launches its kernel there.
``--device cpu`` runs the plain versions instead (no times are taken
then); with no GPU and no ``--device cpu`` they raise. Times are CUDA
events, the median of 5 blocks of 20 calls, in ms per call.

Every driver returns a dict of what it measured, so ``chip_smoke.py``
can hold the results to their gates.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from edgegaussians_tpu_torch.lab import chunked, probes, scene
from edgegaussians_tpu_torch.ops import raster_v2

TIMING_BLOCKS = 5
REPS = 20                 # calls per timing block
EPS_T = 1e-4              # transmittance below which a walk stops


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn: Callable, reps: int) -> float:
    """Median over TIMING_BLOCKS blocks of ``reps`` calls, in ms per call
    (``chip_smoke.py`` times with this too)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_BLOCKS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): the kernels on the card; cpu: "
                         "the plain versions")


def lab_device(name: str) -> torch.device:
    """The device the lab runs on; 'cuda' raises where torch sees none."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the lab runs its kernels on the card and torch "
                           "sees no GPU; pass --device cpu for the plain "
                           "versions")
    return torch.device("cuda")


def _timed(fn: Callable, device, label: str) -> Optional[float]:
    """``fn``'s time on the card, printed under ``label``; None on the
    CPU, where nothing is timed."""
    if device.type != "cuda":
        log(f"{label:46s} not timed (CPU, plain version)")
        return None
    ms = cuda_ms(fn, REPS)
    log(f"{label:46s} {ms:8.4f} ms")
    return ms


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max-abs error of ``a`` against ``b``, relative to ``b``'s max-abs."""
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def t_out_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative error of t_out ``a`` against ``b`` where ``b`` >= EPS_T
    (below it the value depends on where a walk stops); inf where ``b`` is
    below and ``a`` not."""
    live = b >= EPS_T
    if not bool((a[~live] < EPS_T).all()):
        return float("inf")
    if not bool(live.any()):
        return 0.0
    return ((a[live] - b[live]).abs() / b[live]).max().item()


def describe(sc: scene.LabScene) -> None:
    k1, k2 = sc.feats1.shape[1], sc.feats2.shape[1]
    log(f"L1 shape {tuple(sc.feats1.shape)}, occupied tiles "
        f"{int((sc.counts1 > 0).sum())}/{sc.counts1.shape[0]}, mean count "
        f"{float(sc.counts1.float().mean()):.1f}, live slot-pixel "
        f"evaluations {scene.live_evaluations(sc.counts1, k1)}")
    log(f"L2 shape {tuple(sc.feats2.shape)}, occupied rows "
        f"{int((sc.counts2 > 0).sum())}/{sc.counts2.shape[0]}, live "
        f"slot-pixel evaluations {scene.live_evaluations(sc.counts2, k2)}")


def kernel_lab(sc: scene.LabScene, device) -> Dict:
    """``kernel_lab.main()``: V0, the production ``raster_v2`` kernels, and
    V3, the chunked-scan kernels, forward and backward on level 1 and on
    level 2 fed level 1's ``t_out``; the V3-vs-V0 errors. Both backwards
    take V0's image as the total (the JAX ``main()`` gives V0 a total of
    1, whose cotangent ``g * (1 - total)`` is zero)."""
    describe(sc)
    basis = sc.basis
    f1, c1, f2, c2 = sc.feats1, sc.counts1, sc.feats2, sc.counts2
    g1 = torch.ones((f1.shape[0], 256), dtype=torch.float32, device=device)
    out: Dict = {"ms": {}}
    with torch.no_grad():
        img0, tout0 = raster_v2.composite_fwd_seg(f1, c1, basis)
        # level 2's carried transmittance, cotangent and prior (the
        # level-1 image on its rows)
        tin2, g2, prior2 = (x[sc.rows2].contiguous()
                            for x in (tout0, g1, img0))
        img0_2, tout0_2 = raster_v2.composite_fwd_seg(f2, c2, basis, tin2)
        total = img0.clone()
        total[sc.rows2] += img0_2
        total2 = total[sc.rows2].contiguous()
        img3, tout3 = chunked.chunked_fwd(f1, basis)
        img3_2, tout3_2 = chunked.chunked_fwd(f2, basis, tin2)
        d0 = raster_v2.composite_bwd_seg(f1, c1, basis, g1, None, total)
        d0_2 = raster_v2.composite_bwd_seg(f2, c2, basis, g2, tin2, total2)
        d3 = chunked.chunked_bwd(f1, basis, g1, None, None, total)
        d3_2 = chunked.chunked_bwd(f2, basis, g2, tin2, prior2, total2)
        calls = {
            "V0 fwd (raster_v2) L1": lambda: raster_v2.composite_fwd_seg(
                f1, c1, basis),
            "V0 fwd (raster_v2) L2": lambda: raster_v2.composite_fwd_seg(
                f2, c2, basis, tin2),
            "V0 bwd (raster_v2) L1": lambda: raster_v2.composite_bwd_seg(
                f1, c1, basis, g1, None, total),
            "V0 bwd (raster_v2) L2": lambda: raster_v2.composite_bwd_seg(
                f2, c2, basis, g2, tin2, total2),
            "V3 fwd (chunked scan) L1": lambda: chunked.chunked_fwd(
                f1, basis),
            "V3 fwd (chunked scan) L2": lambda: chunked.chunked_fwd(
                f2, basis, tin2),
            "V3 bwd (chunked scan) L1": lambda: chunked.chunked_bwd(
                f1, basis, g1, None, None, total),
            "V3 bwd (chunked scan) L2": lambda: chunked.chunked_bwd(
                f2, basis, g2, tin2, prior2, total2),
        }
        for label, fn in calls.items():
            out["ms"][label] = _timed(fn, device, label)
    out["fwd_err"] = max((img3 - img0).abs().max().item(),
                         (img3_2 - img0_2).abs().max().item())
    out["t_out_rel"] = max(t_out_rel(tout3, tout0),
                           t_out_rel(tout3_2, tout0_2))
    out["bwd_rel"] = max(_rel(d3, d0), _rel(d3_2, d0_2))
    log(f"V3 vs V0 fwd max abs err: {out['fwd_err']:.2e} (t_out rel "
        f"{out['t_out_rel']:.2e})")
    err = max((d3 - d0).abs().max().item(), (d3_2 - d0_2).abs().max().item())
    scale = max(d0.abs().max().item(), d0_2.abs().max().item())
    log(f"V3 vs V0 bwd max abs err: {err:.2e} (scale {scale:.2e}; "
        f"relative {out['bwd_rel']:.2e})")
    return out


def cumprod_lab(sc: scene.LabScene, device) -> Dict:
    """``cumprod_lab.main()``: the chunked forward in each scan form on
    level 1, and on level 2 fed the ``v3`` form's level-1 ``t_out``; each
    form's errors against ``v3`` (``noscan`` is wrong by design)."""
    describe(sc)
    basis = sc.basis
    f1, f2 = sc.feats1, sc.feats2
    out: Dict = {"ms": {}, "err_vs_v3": {}}
    with torch.no_grad():
        ref1, tref1 = chunked.chunked_fwd(f1, basis, scan="v3")
        tin2 = tref1[sc.rows2].contiguous()
        ref2, _ = chunked.chunked_fwd(f2, basis, tin2, scan="v3")
        for name in chunked.SCANS:
            def both(name=name):
                return (chunked.chunked_fwd(f1, basis, scan=name),
                        chunked.chunked_fwd(f2, basis, tin2, scan=name))
            out["ms"][name] = _timed(both, device, f"fwd L1+L2 scan={name}")
            (img1, _), (img2, _) = both()
            err = max((img1 - ref1).abs().max().item(),
                      (img2 - ref2).abs().max().item())
            out["err_vs_v3"][name] = err
            if name != "v3":
                log(f"   max err vs v3: {err:.2e}"
                    + (" (no scan: wrong by design)" if name == "noscan"
                       else ""))
    return out


def probe_lab(device) -> Dict:
    """``segpair_mosaic_probe``'s runs: each probe's kernel (on the CPU its
    plain version) against the script's oracle; PASS or FAIL with the max
    error, as the script prints them (inf for a FAIL). A probe whose
    kernel does not build or launch raises."""
    log(f"device: {device}")
    out: Dict = {}
    for name in probes.CASES:
        _, err, tol = probes.run_case(name, device)
        ok = err <= tol
        log(f"{name}: {'PASS' if ok else 'FAIL'} (maxerr {err:.2e})")
        out[name] = err if ok else float("inf")
    return out
