"""EdgeGaussians in PyTorch, with hand-written Hopper kernels.

The port of ``edgegaussians_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100. Module names mirror the JAX
package so each module's counterpart is easy to find. The port imports
nothing of the JAX package: the NumPy-only modules it needs (``config``,
``cameras``, ``io.ply``, ``io.colmap``, ``data.parsers``,
``data.seed_points``, ``data.synthetic``, ``eval.*``, ``extract.*``) are
copies of their JAX-package namesakes, held equal to them by
tests/test_torch_common.py.

Two backends:

- ``"cuda"``: tensors live on the GPU and the compositors and the kNN
  run the CUDA kernels in ``csrc/`` (built at first use by
  ``ops/_build.py``);
- ``"torch"``: tensors live on the CPU and every kernel's plain PyTorch
  version runs instead. This is the path the CPU tests hold to JAX.

A kernel wrapper chooses by the device of the tensor it is given: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain
version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

BACKENDS = ("cuda", "torch")


def resolve_backend(backend: str = "auto", configured: str = "auto") -> str:
    """Resolve a backend name as the JAX trainer does (trainer.py:548-551).

    ``backend`` is the caller's choice (the CLI flag); ``"auto"`` defers to
    ``configured`` (``model.rasterizer_backend``), and ``"auto"`` there
    picks ``"cuda"`` when a GPU is present and ``"torch"`` otherwise.
    """
    if backend == "auto":
        backend = configured
    if backend == "auto":
        backend = "cuda" if torch.cuda.is_available() else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port runs "
                         f"{BACKENDS} (or 'auto')")
    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("backend 'cuda' requested but torch sees no GPU")
    return backend


def backend_device(backend: str) -> torch.device:
    """The device a resolved backend's tensors live on."""
    return torch.device("cuda" if backend == "cuda" else "cpu")
