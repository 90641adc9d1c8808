"""Training losses (plain PyTorch).

Counterpart of ``edgegaussians_tpu/models/losses.py``: masked and weighted
L1 and the three pixel-sampling strategies ``whole`` / ``bg_edge_ratio`` /
``weighted`` (reference: edge_gs.py:288-324), and the geometric edge
priors: the direction loss (major axis vs. neighbour directions,
``enforce_full`` / ``enforce_half``, edge_gs.py:346-373), the scale-ratio
loss (edge_gs.py:375-380) and the neighbour refresh they use. The
``bg_edge_ratio`` sampler keeps the reference's flat-index quirk (SURVEY.md
§6.5.2); its random scores are passed in, so a test can hand both
packages the same draws.
"""

from __future__ import annotations

import torch

from edgegaussians_tpu_torch.ops.knn import knn
from edgegaussians_tpu_torch.ops.rank_sum import gather_rows
from edgegaussians_tpu_torch.ops.transforms import major_directions


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred-target| over mask (reference MaskedL1Loss)."""
    m = mask.to(pred.dtype)
    total = torch.sum(torch.abs(pred - target) * m)
    return total / torch.clamp(torch.sum(m), min=1.0)


def weighted_l1(pred: torch.Tensor, target: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Mean of weights * |pred-target| (reference WeightedL1Loss)."""
    return torch.mean(weights * torch.abs(pred - target))


def compute_weight_mask(edge_mask: torch.Tensor) -> torch.Tensor:
    """Inverse-frequency class weights (edge_gs.py:177-193)."""
    num_edge = edge_mask.sum()
    total = edge_mask.numel()
    edge_w = (total - num_edge) / total
    bg_w = num_edge / total
    return torch.where(edge_mask, edge_w, bg_w).to(torch.float32)


def projection_loss_whole(pred, gt, loss_type: str = "l1"):
    """'whole' strategy (edge_gs.py:290-296)."""
    if loss_type == "l1":
        return torch.mean(torch.abs(pred - gt))
    if loss_type == "l2":
        return torch.mean((pred - gt) ** 2)
    raise ValueError(f"Unknown loss_type {loss_type}")


def projection_loss_bg_edge_ratio(pred, gt, edge_mask, bg_edge_pixel_ratio,
                                  scores: torch.Tensor) -> torch.Tensor:
    """'bg_edge_ratio' strategy (edge_gs.py:298-314), bug-faithful.

    edge term: masked L1 over edge pixels. bg term: masked L1 over
    ``ratio * #edge`` flat indices drawn without replacement from
    [0, #bg): the ``k`` smallest of ``scores`` (``[H*W]`` uniform draws)
    among the first #bg flat pixels, unravelled over the full image.
    """
    h, w = pred.shape
    num_edge = edge_mask.sum()
    num_bg_all = h * w - num_edge
    num_bg_sample = int(bg_edge_pixel_ratio * num_edge.item())
    edge_loss = masked_l1(pred, gt, edge_mask)
    flat = torch.arange(h * w, device=pred.device)
    support = flat < num_bg_all
    if num_bg_sample > 0:
        restricted = torch.where(support, scores,
                                 torch.full_like(scores, 2.0))
        k = min(num_bg_sample, h * w)
        kth = torch.kthvalue(restricted, k).values
        sample_mask = (restricted <= kth) & support
    else:
        sample_mask = torch.zeros_like(support)
    bg_loss = masked_l1(pred, gt, sample_mask.reshape(h, w))
    return edge_loss + bg_loss


def projection_loss_weighted(pred, gt, weight_mask) -> torch.Tensor:
    """'weighted' strategy (edge_gs.py:316-319)."""
    return weighted_l1(pred, gt, weight_mask)


def direction_loss(means: torch.Tensor, scales: torch.Tensor,
                   quats: torch.Tensor, nn_indices: torch.Tensor,
                   alive: torch.Tensor, num_nn: int,
                   enforce_method: str = "enforce_full") -> torch.Tensor:
    """Major-axis vs. neighbour-direction alignment (losses.py:132-169):
    1 - the mean over live rows of the mean |cos| between each row's major
    direction and the unit vectors to its neighbours ``nn_indices [N,m]``
    (m = k for enforce_full; 2k, of which the k best aligned count, for
    enforce_half). ``scales`` are linear. A neighbour at the row's own
    position has an infinite sqrt derivative in both packages. The
    neighbours' gradient adds into ``means`` in row order
    (``ops/rank_sum.gather_rows``), so a fired step repeats bit for bit."""
    majors = major_directions(scales, quats)                      # [N,3]
    d = means[:, None, :] - gather_rows(means, nn_indices)        # [N,m,3]
    norm = torch.sqrt(torch.sum(d * d, dim=-1))
    d = d / torch.clamp(norm, min=1e-12)[..., None]
    align = torch.abs(torch.sum(majors[:, None, :] * d, dim=-1))  # [N,m]
    if enforce_method == "enforce_half":
        align = torch.sort(align, dim=-1, descending=True).values[:, :num_nn]
    mean_align = torch.mean(align, dim=-1)
    af = alive.to(torch.float32)
    return 1.0 - torch.sum(mean_align * af) / torch.clamp(af.sum(), min=1.0)


def ratio_loss(scales: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Second-largest / largest scale, averaged over live rows
    (losses.py:172-186), by the JAX version's max/sum identities.
    ``amax``/``amin`` split the gradient equally among tied scales, as
    ``jnp.max``/``jnp.min`` do (``torch.max(dim=...)`` would not)."""
    s_max = torch.amax(scales, dim=-1)
    s_min = torch.amin(scales, dim=-1)
    s_med = torch.sum(scales, dim=-1) - s_max - s_min
    ratio = s_med / torch.clamp(s_max, min=1e-12)
    af = alive.to(torch.float32)
    return torch.sum(ratio * af) / torch.clamp(af.sum(), min=1.0)


@torch.no_grad()
def update_nearest_neighbors(means: torch.Tensor, alive: torch.Tensor,
                             num_nn: int,
                             enforce_method: str = "enforce_full"
                             ) -> torch.Tensor:
    """Neighbour indices for the direction loss (losses.py:189-204):
    fetches k+1 (2k+1 for enforce_half) nearest live rows and drops the
    closest, as the reference slices ``indices[:, 1:]``."""
    fetch = 2 * num_nn + 1 if enforce_method == "enforce_half" \
        else num_nn + 1
    return knn(means.detach(), fetch, mask=alive)[1][:, 1:]
