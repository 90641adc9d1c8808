"""The six lowering probes as Hopper kernels (``csrc/lab_probes.cu``),
each against the NumPy oracle of ``scripts/segpair_mosaic_probe.py``; the
PyTorch port's counterpart of that script.

    python3 scripts/torch_segpair_probe.py [--device cuda|cpu]

Prints ``<probe>: PASS (maxerr ...)`` or ``FAIL`` for each of the
script's eight runs (roll on both axes, the one-hot segment sum, window
write and read at offsets read on the device, transpose, and the scratch
buffer kept across steps, read and read-modify-write); exits 1 if any
result is wrong, and raises if a kernel does not build or launch.
``--device cpu`` runs the plain versions; with no GPU and no
``--device cpu`` it raises.
"""

import argparse
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from edgegaussians_tpu_torch.lab import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    harness.add_device_arg(ap)
    return harness.probe_lab(harness.lab_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    sys.exit(0 if all(math.isfinite(e) for e in main().values()) else 1)
