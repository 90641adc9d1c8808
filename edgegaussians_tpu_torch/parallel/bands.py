"""Tile-band geometry and band-partial projection losses.

Counterpart of ``edgegaussians_tpu/parallel/bands.py``. One view's tile
grid splits into horizontal bands of tile rows, one per rank of a band
axis ('tiles', or 'gauss' in the Gaussian-axis modes). Each rank renders
only its band (``ops/rasterize.py`` band mode) and computes a band-PARTIAL
loss; the SUM of the partials over the band axis is the full image's loss.
Every denominator is a global quantity each rank computes from the full
edge mask it holds, so no collective runs inside the differentiated
function: the caller all-reduces the loss and the gradients once, after
the backward (a reduction inside would be a second one on the gradients,
the double-reduction class the JAX package guarded against).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from edgegaussians_tpu_torch.ops.tiles import cdiv, tile_grid


def band_geometry(width: int, height: int, tile_size: int, n_shards: int):
    """(tile rows per band, band pixel height, padded image height)."""
    _, nty, _ = tile_grid(width, height, tile_size)
    rows_per = cdiv(nty, n_shards)
    band_h = rows_per * tile_size
    return rows_per, band_h, band_h * n_shards


def _band_rows(img: torch.Tensor, y0: int, band_h: int, pad_h: int):
    """Rows [y0, y0 + band_h) of ``img`` zero-padded to ``pad_h`` rows."""
    return F.pad(img, (0, 0, 0, pad_h - img.shape[0]))[y0:y0 + band_h]


def band_inputs(gt: torch.Tensor, edge_mask: torch.Tensor, y0: int,
                band_h: int, pad_h: int, height: int, width: int):
    """This rank's band of the ground truth and edge mask.

    Returns (gt_b [band_h,W], em_b [band_h,W] f32, valid_b [band_h,W] f32
    masking the rows past the true image height)."""
    gt_b = _band_rows(gt, y0, band_h, pad_h)
    em_b = _band_rows(edge_mask.to(torch.float32), y0, band_h, pad_h)
    rows = torch.arange(band_h, device=gt.device) + y0
    valid_b = (rows < height).to(torch.float32)[:, None].expand(band_h,
                                                                width)
    return gt_b, em_b, valid_b


def band_partial_loss(pred: torch.Tensor, gt_b: torch.Tensor,
                      em_b: torch.Tensor, valid_b: torch.Tensor,
                      edge_mask: torch.Tensor, strategy_idx: int,
                      bg_ratio: float, bg_scores: Optional[torch.Tensor],
                      *, loss_type: str, height: int, width: int, y0: int,
                      band_h: int, pad_h: int) -> torch.Tensor:
    """Band-PARTIAL loss of the selected strategy (0 whole, 1
    bg_edge_ratio, 2 weighted); the full loss is the SUM over bands.

    - whole: the band's sum of |pred - gt| (or its square) over H*W;
    - bg_edge_ratio: the edge term over the global edge count; the
      background sample is the reference's flat-index draw (SURVEY §6.5.2),
      which needs the FULL image's order statistic: every rank takes it
      from the full ``[H*W]`` ``bg_scores`` with ``kthvalue``, exactly as
      ``losses.projection_loss_bg_edge_ratio`` does, then slices its band;
    - weighted: inverse-frequency weights from the global edge count.
    """
    hw = float(height * width)
    adiff = torch.abs(pred - gt_b) * valid_b
    if strategy_idx == 0:
        if loss_type == "l2":
            return torch.sum(((pred - gt_b) ** 2) * valid_b) / hw
        if loss_type != "l1":
            raise ValueError(f"Unknown loss_type {loss_type}")
        return torch.sum(adiff) / hw
    num_edge = edge_mask.sum()
    if strategy_idx == 1:
        edge_cnt = torch.clamp(num_edge.to(torch.float32), min=1.0)
        edge_loss = torch.sum(adiff * em_b) / edge_cnt
        num_bg_all = height * width - num_edge
        num_bg_sample = int(bg_ratio * num_edge.item())
        flat = torch.arange(height * width, device=pred.device)
        support = flat < num_bg_all
        if num_bg_sample > 0:
            restricted = torch.where(support, bg_scores,
                                     torch.full_like(bg_scores, 2.0))
            kth = torch.kthvalue(restricted,
                                 min(num_bg_sample, height * width)).values
            smask = (restricted <= kth) & support
        else:
            smask = torch.zeros_like(support)
        smask = smask.to(torch.float32).reshape(height, width)
        denom = torch.clamp(smask.sum(), min=1.0)
        sm_b = _band_rows(smask, y0, band_h, pad_h)
        return edge_loss + torch.sum(adiff * sm_b) / denom
    if strategy_idx == 2:
        nef = num_edge.to(torch.float32)
        w_b = torch.where(em_b > 0, (hw - nef) / hw, nef / hw)
        return torch.sum(w_b * adiff) / hw
    raise ValueError(f"unknown strategy index {strategy_idx}")
