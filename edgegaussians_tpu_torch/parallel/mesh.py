"""Named device meshes over the ranks of the process group.

Counterpart of ``edgegaussians_tpu/parallel/mesh.py``. A mesh names the
axes the sharded trainers reduce over, on
``torch.distributed.device_mesh.init_device_mesh`` with dim names
``("views", "tiles")``, ``("views", "gauss")``, ``("tiles",)`` or
``("gauss",)``:

- ``views``: view data parallelism (``parallel/train_dp.py``): each rank
  renders its share of a view batch;
- ``tiles``: tile-band sharding of one render (``parallel/
  train_sharded.py``): each rank renders a band of tile rows of the same
  view;
- ``gauss``: Gaussian-axis sharding (``parallel/train_tp.py``): each rank
  projects its share of the Gaussians and composites its band.

A mesh covers the whole process group, rank r at row-major position r. A
mesh of one rank may exist without a process group (a single process's
view-batch trainer): its collectives are then the identity.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """Axis sizes by name, this rank's coordinate on each, and the
    process group of each axis (None without a process group)."""

    def __init__(self, shape: Dict[str, int], device_type: str = "cpu"):
        self.shape = dict(shape)
        size = math.prod(self.shape.values())
        self.device_mesh = None
        if not dist.is_initialized():
            if size != 1:
                raise RuntimeError(
                    f"a mesh of {size} ranks needs a process group: launch "
                    f"{size} ranks with torchrun (parallel/distributed.py)")
            return
        world = dist.get_world_size()
        if size != world:
            raise ValueError(f"mesh {self.shape} holds {size} ranks, the "
                             f"process group {world}")
        from torch.distributed.device_mesh import init_device_mesh
        self.device_mesh = init_device_mesh(
            device_type, tuple(self.shape.values()),
            mesh_dim_names=tuple(self.shape))

    @property
    def dim_names(self):
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an axis it lacks)."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axes: Sequence[str]) -> Optional[dist.ProcessGroup]:
        """The process group spanning ``axes`` (all of them: the world)."""
        if self.device_mesh is None:
            return None
        axes = [a for a in axes if a in self.shape]
        if set(axes) == set(self.shape):
            return dist.group.WORLD
        if len(axes) != 1:
            raise ValueError(f"no group for axes {axes} of {self.shape}")
        return self.device_mesh.get_group(axes[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _device_type() -> str:
    """The rank's device type: ``cuda`` when this process has a current
    card (``distributed.initialize`` set it), else ``cpu``."""
    return "cuda" if torch.cuda.is_available() and \
        torch.cuda.is_initialized() else "cpu"


def make_mesh(view_axis: int = 1, tile_axis: int = 1) -> Mesh:
    """A ('views', 'tiles') mesh: view data parallelism, each render
    band-sharded over 'tiles' when ``tile_axis`` > 1."""
    return Mesh({"views": view_axis, "tiles": tile_axis}, _device_type())


def make_views_gauss_mesh(view_axis: int, gauss_axis: int) -> Mesh:
    """A ('views', 'gauss') mesh: view data parallelism composed with
    Gaussian-axis sharding inside each view row."""
    return Mesh({"views": view_axis, "gauss": gauss_axis}, _device_type())


def axis_mesh(axis: str, n: int) -> Mesh:
    """A one-axis mesh, ('tiles',) or ('gauss',), of ``n`` ranks."""
    if axis not in ("tiles", "gauss"):
        raise ValueError(f"unknown mesh axis {axis!r}: 'tiles' or 'gauss'")
    return Mesh({axis: n}, _device_type())
