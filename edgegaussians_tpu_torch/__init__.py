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

``"auto"`` (the CLI's and ``train()``'s default, and every shipped
config's ``rasterizer_backend``) means the card: it resolves to
``"cuda"``, and raises where torch sees no GPU. The CPU runs only when
the caller names ``"torch"``.

A kernel wrapper chooses by the device of the tensor it is given: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain
version. Nothing falls back from one to the other.

``model.rasterizer_backend`` may also name the JAX package's compositor
choice, ``"pallas"`` or ``"pallas_v1"``: the device then resolves as for
``"auto"`` (the card), and the name selects the single-level frame's compositor
(``raster_v2`` or the v1 log-space ``raster_v1``). The JAX package's XLA
oracle (``"jax"``, ``"reference"``) has no counterpart and is refused.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

BACKENDS = ("cuda", "torch")
# configured rasterizer_backend values that choose a compositor
COMPOSITORS = ("pallas", "pallas_v1")


def resolve_backend(backend: str = "auto", configured: str = "auto") -> str:
    """Resolve a backend name as the JAX trainer does (trainer.py:548-551).

    ``backend`` is the caller's choice (the CLI flag); ``"auto"`` defers to
    ``configured`` (``model.rasterizer_backend``), and ``"auto"`` there,
    or a compositor name (see :func:`resolve_compositor`), picks
    ``"cuda"``. A backend that resolves to ``"cuda"`` raises where torch
    sees no GPU: the CPU (``"torch"``) runs only when asked for by name.
    """
    resolve_compositor(configured)          # refuses the XLA oracle
    if backend == "auto":
        backend = "auto" if configured in COMPOSITORS else configured
    if backend == "auto":
        backend = "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port runs "
                         f"{BACKENDS} (or 'auto')")
    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend 'cuda' (what 'auto' and the compositor names resolve "
            "to) but torch sees no GPU; pass --backend torch (backend="
            "'torch') to run on the CPU")
    return backend


def resolve_compositor(configured: str = "auto") -> str:
    """The compositor a configured ``model.rasterizer_backend`` selects:
    itself when it names one of :data:`COMPOSITORS`, else ``"pallas"``;
    the JAX package's XLA oracle is refused."""
    if configured in ("jax", "reference"):
        raise ValueError(
            f"rasterizer_backend {configured!r} names the JAX package's XLA "
            "oracle, which the port does not have; use 'pallas' or "
            "'pallas_v1' (compositors) or 'auto'/'cuda'/'torch' (devices)")
    return configured if configured in COMPOSITORS else "pallas"


def backend_device(backend: str) -> torch.device:
    """The device a resolved backend's tensors live on."""
    return torch.device("cuda" if backend == "cuda" else "cpu")
