"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use with ``nvcc`` into ``build/torch_kernels/<name>-<hash>.so`` at the
repository root (``build/`` is git-ignored), then loaded with ``ctypes``.
The hash covers the source, the headers of ``csrc/`` it includes (``#include
"..."``, followed into nested includes) and the compiler flags, so an edited
source or header rebuilds every library that uses it, and an unchanged one
is loaded as it is. No PyTorch headers are
involved, which keeps a build to seconds.

The wrappers import this module when they are imported, which compiles
nothing; the first launch of a library's kernel builds and loads it. Each
C entry gets its prototype once, at its first launch (:func:`bind`), and
every later launch calls the bound function as it is: setting ``argtypes``
rebuilds ctypes' converters, which a launch should not pay for each time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the headers it includes with ``#include
    "..."`` (each resolved beside the file that names it, as nvcc does),
    each once, in the order first named."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    Returns the library path. The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is written beside the
    library as ``<library>.log``.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(str(build(name)))


# (library, entry) -> (the entry with its prototype set, its argtypes)
_bound: Dict[Tuple[str, str], tuple] = {}


def bind(lib: str, fn_name: str, argtypes: tuple):
    """The C entry ``fn_name`` of ``csrc/<lib>.cu``, its ``restype`` and
    ``argtypes`` set once, at the first call; later calls return the same
    bound function. Raise if a later call names other ``argtypes``."""
    hit = _bound.get((lib, fn_name))
    if hit is None:
        fn = getattr(load(lib), fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        hit = _bound[(lib, fn_name)] = (fn, tuple(argtypes))
    elif hit[1] is not argtypes and hit[1] != tuple(argtypes):
        raise TypeError(f"{lib}.{fn_name} was bound with argtypes "
                        f"{hit[1]}, called with {tuple(argtypes)}")
    return hit[0]


def launch(lib: str, fn_name: str, argtypes: tuple, args) -> None:
    """Call the C entry ``fn_name`` of ``csrc/<lib>.cu`` (bound by
    :func:`bind`), which launches its kernel and returns
    cudaGetLastError(); raise unless that is 0."""
    err = bind(lib, fn_name, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on the CUDA ``device`` (with
    its index), the stream every kernel launches on: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a ``torch.cuda.Stream`` object (0.2-0.4 us against 3.8-7.3 us
    per call on an H100's host, ``chip_smoke.py`` phase 8)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
