"""Kernel lab on the card: the production dense compositor (V0,
``csrc/raster_v2.cu``) beside the chunked-scan compositor (V3,
``csrc/lab_chunked.cu``) on the lab scene's two-level frame, forward and
backward; the PyTorch port's counterpart of ``scripts/kernel_lab.py``.

    python3 scripts/torch_kernel_lab.py [--device cuda|cpu]

The scene is the JAX lab's: 20000 random Gaussians (``default_rng(0)``)
at 800x800, f = 1111, 16-pixel tiles, binned into 128 slots per tile and
384 more for the 625 busiest. Prints each kernel's time on level 1 and
on level 2 (fed level 1's t_out): CUDA events, median of 5 blocks of 20
calls; then the V3-vs-V0 errors. ``--device cpu`` runs the plain
versions (untimed, under a minute); with no GPU and no ``--device cpu``
it raises.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from edgegaussians_tpu_torch.lab import harness, scene  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    harness.add_device_arg(ap)
    device = harness.lab_device(ap.parse_args(argv).device)
    return harness.kernel_lab(scene.bench_scene(device=device), device)


if __name__ == "__main__":
    main()
