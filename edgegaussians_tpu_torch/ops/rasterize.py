"""Differentiable tile-based Gaussian rasterization.

Counterpart of ``edgegaussians_tpu/ops/rasterize.py``. One call renders one
camera's edge-intensity image and backpropagates to means / quats /
scales / opacities, with the gsplat 'antialiased' opacity compensation and
the absgrad signal:

    project (autograd) -> bin (no grad) -> composite (autograd.Function)
    -> frame order to tile order -> assemble [H, W]

The dispatch of rasterize.py:156-222, four paths:

- a pair budget with ``pair_kernel="seg"``: the seg pair path
  (``SegpairRender`` on ``csrc/segpair.cu``), what the shipped recipes
  start on;
- a pair budget with ``pair_kernel=True`` (or ``"block"``): the v4
  block-window pair path (``PairRender`` on ``csrc/pair.cu``, tables
  binned with ``block_tiles=8``);
- ``0 < dense_capacity < capacity``: the dense two-level frame
  (``TileRenderTwoLevel`` on ``csrc/raster_v2.cu``), where the recipes'
  'fallback' overflow action goes; with a pair budget and the pair kernel
  off its frame is built from the pair-prefix tables;
- otherwise: the dense single-level frame (``TileRender``), on
  ``raster_v2`` or, with ``backend="pallas_v1"``, on the v1 log-space
  kernels of ``csrc/raster_v1.cu``.

``backend`` names the JAX package's compositor choice: ``"pallas"`` (the
default) or ``"pallas_v1"``. It changes only the single-level frame, as in
the JAX package, whose two-level and pair paths never reach the v1 kernel
(composite.py:336,384). ``"jax"`` and ``"reference"`` name the JAX
package's XLA oracle, which has no counterpart here, and are refused; so
is an unknown ``pair_kernel`` value (the JAX package falls through to the
v4 kernel there). Colours are implicitly all-ones, so the rendered
intensity is the accumulated alpha.

Band mode (``band_row0`` and ``band_tile_rows``, rasterize.py:79-88,
136-142): render only the ``band_tile_rows`` tile rows from tile row
``band_row0`` on, the unit of every sharded render (``parallel/``). The
screen-space centres shift up by ``band_row0 * tile_size`` pixels, in the
binning copy and, through autograd, in the packed rows, so gradients reach
the unshifted centres. Gaussians outside the band bin to no tile, so each
band tile holds the pairs of the full render's tile and the band image is
those rows of the full image, on all four paths. ``image`` is then
``[band_tile_rows * tile_size, W]`` and the per-tile diagnostics cover
the band only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from edgegaussians_tpu_torch import COMPOSITORS
from edgegaussians_tpu_torch.ops import tiles as tiles_mod
from edgegaussians_tpu_torch.ops.composite import (
    TileRender, TileRenderTwoLevel)
from edgegaussians_tpu_torch.ops.pair import BLOCK_TILES, PairRender
from edgegaussians_tpu_torch.ops.projection import project_gaussians
from edgegaussians_tpu_torch.ops.segpair import SegpairRender
from edgegaussians_tpu_torch.ops.tiles import (
    assemble_image, pixel_basis, tile_origins)


class RenderResult(NamedTuple):
    image: torch.Tensor          # [H,W] edge intensity in [0,1+] (pre-clamp)
    tile_counts: torch.Tensor    # [T] per-tile Gaussian counts (diagnostics)
    num_visible: torch.Tensor    # scalar: Gaussians surviving projection
    num_truncated: torch.Tensor  # scalar: Gaussians whose tile footprint
                                 # exceeded max_tiles_per_gaussian
    num_pairs: torch.Tensor      # scalar: true (tile, Gaussian) pair count
                                 # (the pair paths drop pairs past
                                 # pair_budget)


def rasterize(
    means: torch.Tensor,            # [N,3]
    quats: torch.Tensor,            # [N,4] wxyz
    scales: torch.Tensor,           # [N,3] linear
    opacities: torch.Tensor,        # [N] linear
    viewmat: torch.Tensor,          # [4,4]
    K: torch.Tensor,                # [3,3]
    width: int,
    height: int,
    *,
    tile_size: int = 16,
    capacity: int = 512,
    max_tiles_per_gaussian: int = 64,
    dense_capacity: int = 0,
    overflow_tiles: int = 0,
    pair_budget: int = 0,
    pair_kernel="seg",
    backend: str = "pallas",
    occupancy_sort: bool = False,
    antialiased: bool = True,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    alive: Optional[torch.Tensor] = None,
    absgrad_sink: Optional[torch.Tensor] = None,   # [N,2] zeros
    band_row0=None,
    band_tile_rows: Optional[int] = None,
) -> RenderResult:
    """Render one view on the device of ``means``. Differentiable in
    means/quats/scales/opacities and, through ``absgrad_sink``'s gradient,
    reports accumulated |d means2d|."""
    proj = project_gaussians(
        means, quats, scales, opacities, viewmat, K, width, height,
        near_plane=near_plane, far_plane=far_plane,
        antialiased=antialiased, alive=alive)
    packed = tiles_mod.pack_gaussian_render_data(proj)    # [N,8]
    return rasterize_packed(
        proj, packed, width, height, tile_size=tile_size,
        capacity=capacity, dense_capacity=dense_capacity,
        overflow_tiles=overflow_tiles, pair_budget=pair_budget,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        pair_kernel=pair_kernel, backend=backend,
        occupancy_sort=occupancy_sort, absgrad_sink=absgrad_sink,
        band_row0=band_row0, band_tile_rows=band_tile_rows)


def rasterize_packed(
    proj,                           # ProjectedGaussians (binning; no grad)
    packed: torch.Tensor,           # [N,8] packed rows (differentiable)
    width: int,
    height: int,
    *,
    tile_size: int = 16,
    capacity: int = 512,
    dense_capacity: int = 0,        # 0 = single-level; else two-level k1
    overflow_tiles: int = 0,        # 0 = auto max(T//4, 8) level-2 tiles
    pair_budget: int = 0,
    max_tiles_per_gaussian: int = 64,
    pair_kernel="seg",
    backend: str = "pallas",
    occupancy_sort: bool = False,
    absgrad_sink: Optional[torch.Tensor] = None,
    band_row0=None,
    band_tile_rows: Optional[int] = None,
) -> RenderResult:
    """Bin + composite pre-projected, pre-packed Gaussians.

    The entry point of Gaussian-axis sharding (``parallel/train_tp.py``):
    gradients flow through ``packed`` only; ``proj`` feeds the binning.
    ``band_row0`` (a Python int or a 0-d tensor) and ``band_tile_rows``
    select band mode (module docstring)."""
    if (band_row0 is None) != (band_tile_rows is None):
        raise ValueError("band mode takes both band_row0 and band_tile_rows")
    if pair_kernel not in (False, 0, None, True, "block", "seg"):
        raise ValueError(f"unknown pair_kernel {pair_kernel!r} "
                         "(expected 'seg', True/'block' or False)")
    if backend not in COMPOSITORS:
        raise ValueError(
            f"backend {backend!r}: the port composites with 'pallas' (the "
            "dense v2 kernels) or 'pallas_v1' (the v1 log-space kernels); "
            "the JAX package's XLA oracle ('jax', 'reference') has no "
            "counterpart here")
    pair_path = bool(pair_kernel) and pair_budget > 0

    n = packed.shape[0]
    dev = packed.device
    if band_tile_rows is not None:
        height = band_tile_rows * tile_size
        shift = torch.as_tensor(band_row0 * tile_size, device=dev).to(
            torch.float32)
        off = torch.stack([torch.zeros_like(shift), shift])
        proj = proj._replace(means2d=proj.means2d - off)
        # columns 3:5 of a packed row are the screen-space centre
        packed = packed - torch.nn.functional.pad(off, (3, 3))
    origins = tile_origins(width, height, tile_size, device=dev)
    basis = pixel_basis(tile_size, device=dev)
    if absgrad_sink is None:
        absgrad_sink = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    num_tiles = tiles_mod.tile_grid(width, height, tile_size)[2]
    capacity = min(capacity, n) if n > 0 else capacity
    two_level = 0 < dense_capacity < capacity

    if pair_path:
        seg = pair_kernel == "seg"
        bins = tiles_mod.bin_pairs_frame_order(
            proj, width, height, tile_size, capacity, pair_budget,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            block_tiles=0 if seg else BLOCK_TILES)
        render = SegpairRender if seg else PairRender
        img_f = render.apply(packed[bins.order], bins, origins, basis,
                             absgrad_sink)
        perm, counts, num_pairs = bins.perm, bins.counts, bins.num_pairs
    elif two_level:
        t2 = min(overflow_tiles or max(num_tiles // 4, 8), num_tiles)
        k1, k2 = dense_capacity, capacity - dense_capacity
        bins = tiles_mod.bin_gaussians_two_level(
            proj, width, height, tile_size, k1, k2, t2,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            occupancy_sort=occupancy_sort, pair_budget=pair_budget)
        perm = bins.tile_perm
        img_f = TileRenderTwoLevel.apply(
            packed[bins.order], bins,
            origins if perm is None else origins[perm], basis, absgrad_sink,
            k1, k2)
        counts, num_pairs = bins.counts, bins.num_pairs
    else:
        bins = tiles_mod.bin_gaussians(
            proj, width, height, tile_size, capacity,
            max_tiles_per_gaussian=max_tiles_per_gaussian)
        img_f = TileRender.apply(packed[bins.order], bins, origins, basis,
                                 absgrad_sink, backend)
        perm, counts, num_pairs = None, bins.counts, bins.counts.sum()
    # frame order -> tile order (autograd turns this into the gather)
    tile_imgs = img_f if perm is None else \
        torch.zeros_like(img_f).index_copy(0, perm, img_f)
    image = assemble_image(tile_imgs, width, height, tile_size)
    return RenderResult(
        image=image, tile_counts=counts,
        num_visible=proj.valid.sum(),
        num_truncated=bins.num_truncated,
        num_pairs=num_pairs)
