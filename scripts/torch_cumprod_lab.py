"""The transmittance scan's forms inside the chunked-scan compositor
forward (``csrc/lab_chunked.cu``), on the card; the PyTorch port's
counterpart of ``scripts/cumprod_lab.py``.

    python3 scripts/torch_cumprod_lab.py [--device cuda|cpu]

Scans: ``v3`` (a warp's product scan), ``noscan`` (none: wrong by design,
the scan's cost floor), ``twolevel`` (groups of 8, then the group tails'
prefix: the true cumulative product, where the JAX form returns the
in-group product only) and ``logsum`` (a log-space sum scan, then exp: the
JAX ``matmul`` form). Prints each form's time over level 1 and level 2
(fed the v3 level-1 t_out) of the lab scene (``torch_kernel_lab.py``'s),
CUDA events, median of 5 blocks of 20 calls, and its error against
``v3``. ``--device cpu``
runs the plain versions (untimed); with no GPU and no ``--device cpu`` it
raises.
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
    return harness.cumprod_lab(scene.bench_scene(device=device), device)


if __name__ == "__main__":
    main()
