"""The port's dry-run entry (``edgegaussians_tpu_torch/graft_entry.py``)
held to ``__graft_entry__.py`` on the CPU.

- ``entry("cpu")``'s 128x128 image against the JAX ``entry()`` under
  ``jax.jit``, whose seg kernel runs in interpret mode on the CPU (its
  ``backend="jax"``), as tests/test_graft_entry.py runs it: within 1e-5 of
  the JAX image's max-abs (the tolerance of tests/test_torch_segpair.py's
  forward images, which the JAX kernel's bf16 one-hot passes sit under);
- one spawn of ``dryrun_multichip(4, "cpu")``: 4 Gloo ranks, each a
  process, 300 s at most; every rank passes its own checks (the
  compositions against the flat view batch and the Gaussian-sharded epochs
  against the tile-sharded ones within 1e-4, alive equal, density control
  fired without a fall), and the ranks agree;
- ``--device cuda`` (the default) refuses where torch sees no GPU.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from edgegaussians_tpu_torch import graft_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_RTOL_OF_MAX = 1e-5


def test_entry_image_matches_the_jax_entry():
    fn, args = graft_entry.entry("cpu")
    img = fn(*args)
    jfn, jargs = jentry.entry()
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    jimg = np.asarray(jax.jit(jfn)(*jargs))
    assert img.shape == jimg.shape == (128, 128)
    assert torch.isfinite(img).all() and float(img.sum()) > 0
    err = float(np.abs(img.numpy() - jimg).max())
    assert err <= IMG_RTOL_OF_MAX * float(np.abs(jimg).max()), err


def test_dryrun_multichip_on_four_cpu_ranks(tmp_path):
    results = graft_entry.dryrun_multichip(4, "cpu", out_dir=str(tmp_path))
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    r0 = results[0]
    for r in results[1:]:
        for key in ("epoch_losses", "alive", "dp_loss", "flat_loss",
                    "dp_tp_loss", "tile_loss", "tp_losses"):
            assert r[key] == r0[key], key
    n0, n1, fired = r0["alive"][0]
    assert fired and n1 >= n0
    assert len(r0["epoch_losses"]) == len(r0["tp_losses"]) == 4
    assert all(np.isfinite(r0["epoch_losses"] + r0["tp_losses"]))
    # the plain versions run on the CPU: no kernel launches
    assert not any(r0["launches"].values())
    assert "dryrun_multichip OK on 4 ranks" in \
        (tmp_path / "rank0.log").read_text()


def test_graft_entry_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("torch sees a GPU: --device cuda runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        graft_entry.entry()
    proc = subprocess.run(
        [sys.executable, "-m", "edgegaussians_tpu_torch.graft_entry"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
