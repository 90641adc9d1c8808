"""Segmented pair compositor: the counterpart of ``ops/pallas_segpair.py``.

Each frame row of :class:`~edgegaussians_tpu_torch.ops.tiles.PairBins`
owns one contiguous, depth-ordered run of (tile, Gaussian) pairs. The
forward composites every run front to back into its tile's 256 pixels
(gsplat rules: sigma guard, 1/255 skip, 0.999 clamp, stop below
transmittance 1e-4); the backward returns per-pair feature gradients from
the algebraic suffix of the all-ones-colour composite.

Two implementations of each direction, chosen by the device of the input:

- ``csrc/segpair.cu``, the Hopper kernels, for CUDA tensors. The wrappers
  :func:`segpair_fwd` / :func:`segpair_bwd` launch them or raise; each
  launch adds one to ``launch_counts``.
- :func:`segpair_fwd_ref` / :func:`segpair_bwd_ref`, plain PyTorch over a
  padded ``[T, maxrun, 256]`` block, for CPU tensors. They are also the
  yardstick the kernels are held to on the card.

:class:`SegpairRender` wraps both directions in a
``torch.autograd.Function`` with the contract of ``segpair_render``
(pallas_segpair.py:556-567).
"""

from __future__ import annotations

import ctypes

import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.projection import (
    ALPHA_CLAMP, ALPHA_THRESHOLD, SIGMA_GUARD_EPS, TRANSMITTANCE_EPS)
from edgegaussians_tpu_torch.ops.rank_sum import rank_sum
from edgegaussians_tpu_torch.ops.tiles import PairBins

PIXELS = 256        # one 16x16 tile; the kernels run one thread per pixel
KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/segpair.cu"

# Launches of each kernel since the last reset_launch_counts(); only the
# kernel wrappers below add to these.
launch_counts = {"segpair_fwd": 0, "segpair_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def build_pair_features(src8: torch.Tensor, ox: torch.Tensor,
                        oy: torch.Tensor) -> torch.Tensor:
    """[B,8] packed rows + per-pair tile origins -> [B,8] features
    (pallas_pair.py:79-97): G as in ops/tiles.py's docstring, with the
    log-opacity in column 6 for the sigma guard."""
    a, b, c = src8[:, 0], src8[:, 1], src8[:, 2]
    mx = src8[:, 3] - ox
    my = src8[:, 4] - oy
    lo = src8[:, 5]
    amx_bmy = a * mx + b * my
    bmx_cmy = b * mx + c * my
    const = -0.5 * (amx_bmy * mx + bmx_cmy * my) + lo
    z = torch.zeros_like(a)
    return torch.stack([-0.5 * a, -b, -0.5 * c, amx_bmy, bmx_cmy, const,
                        lo, z], dim=-1)


def build_pair_features_vjp(src8: torch.Tensor, ox: torch.Tensor,
                            oy: torch.Tensor,
                            dfeats: torch.Tensor) -> torch.Tensor:
    """Closed-form VJP of :func:`build_pair_features` w.r.t. ``src8``,
    in the chain order autodiff would take."""
    a, b, c = src8[:, 0], src8[:, 1], src8[:, 2]
    mx = src8[:, 3] - ox
    my = src8[:, 4] - oy
    d = [dfeats[:, j] for j in range(7)]
    amx_bmy = a * mx + b * my
    bmx_cmy = b * mx + c * my
    g_amx = d[3] - 0.5 * d[5] * mx       # total cotangent of a*mx + b*my
    g_bmx = d[4] - 0.5 * d[5] * my       # total cotangent of b*mx + c*my
    da = -0.5 * d[0] + g_amx * mx
    db = -d[1] + g_amx * my + g_bmx * mx
    dc = -0.5 * d[2] + g_bmx * my
    dmx = g_amx * a + g_bmx * b - 0.5 * d[5] * amx_bmy
    dmy = g_amx * b + g_bmx * c - 0.5 * d[5] * bmx_cmy
    dlo = d[5] + d[6]
    z = torch.zeros_like(a)
    return torch.stack([da, db, dc, dmx, dmy, dlo, z, z], dim=-1)


def check_tensor(name, x, dtype, shape, device):
    """Raise unless ``x`` has the dtype, shape, contiguity and device a
    kernel takes."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != device:
        raise ValueError(f"all inputs must be on {device}, "
                         f"got {name} on {x.device}")


def _check_inputs(feats, s_f, basis, device, gt=None):
    T = s_f.shape[0] - 1
    check_tensor("feats", feats, torch.float32, (feats.shape[0], 8), device)
    check_tensor("s_f", s_f, torch.int32, (T + 1,), device)
    check_tensor("basis", basis, torch.float32, (8, PIXELS), device)
    if gt is not None:
        check_tensor("gt", gt, torch.float32, (T, PIXELS), device)
    return T


# each entry's pointers, then rows and stream
_ARGTYPES = {
    "segpair_fwd": (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_void_p),
    "segpair_bwd": (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_void_p),
}


def _launch(name, *args):
    _build.launch("segpair", name, _ARGTYPES[name], args)
    launch_counts[name] += 1


def segpair_fwd(feats: torch.Tensor, s_f: torch.Tensor,
                basis: torch.Tensor) -> torch.Tensor:
    """Composite every frame row's run: feats [B,8] f32, s_f [T+1] int32,
    basis [8,256] f32 -> [T,256] f32. CUDA tensors launch the kernel;
    CPU tensors take :func:`segpair_fwd_ref`."""
    if feats.device.type == "cpu":
        return segpair_fwd_ref(feats, s_f, basis)
    if feats.device.type != "cuda":
        raise ValueError(f"no segpair kernel for device {feats.device}")
    T = _check_inputs(feats, s_f, basis, feats.device)
    img = torch.empty((T, PIXELS), dtype=torch.float32, device=feats.device)
    stream = _build.stream(feats.device)
    _launch("segpair_fwd", feats.data_ptr(), s_f.data_ptr(),
            basis.data_ptr(), img.data_ptr(), T, stream)
    return img


def segpair_bwd(feats: torch.Tensor, s_f: torch.Tensor, basis: torch.Tensor,
                gt: torch.Tensor) -> torch.Tensor:
    """Per-pair feature gradients [B,8] from the pre-folded cotangent
    gt = g * (1 - img) [T,256]. Rows outside every run are left
    undefined by the kernel (the caller masks them by pair validity);
    CPU tensors take :func:`segpair_bwd_ref`."""
    if feats.device.type == "cpu":
        return segpair_bwd_ref(feats, s_f, basis, gt)
    if feats.device.type != "cuda":
        raise ValueError(f"no segpair kernel for device {feats.device}")
    T = _check_inputs(feats, s_f, basis, feats.device, gt)
    dfeats = torch.empty_like(feats)
    stream = _build.stream(feats.device)
    _launch("segpair_bwd", feats.data_ptr(), s_f.data_ptr(),
            basis.data_ptr(), gt.data_ptr(), dfeats.data_ptr(), T, stream)
    return dfeats


def _padded_alpha(feats, s_f, basis):
    """Runs gathered into [T, maxrun] slots -> (alpha, ok, t_inc, keep,
    idx, slot_valid), each over [T, maxrun, P] (or [T, maxrun])."""
    counts_f = s_f[1:] - s_f[:-1]
    maxrun = int(counts_f.max()) if counts_f.shape[0] else 0
    return run_alpha(feats, s_f[:-1], counts_f, basis, maxrun)


def run_alpha(feats, starts, counts, basis, maxrun: int):
    """The runs ``[starts[r], starts[r] + counts[r])`` of ``feats``
    gathered into [R, maxrun] slots -> (alpha, ok, t_inc, keep, idx,
    slot_valid), each over [R, maxrun, P] (or [R, maxrun])."""
    slot = torch.arange(maxrun, device=feats.device)
    slot_valid = slot[None, :] < counts[:, None]                  # [R,M]
    idx = torch.where(slot_valid, starts[:, None].long() + slot[None, :],
                      torch.zeros_like(slot)[None, :])
    f = feats[idx]                                                # [T,R,8]
    logalpha = f @ basis                                          # [T,R,P]
    ok = (logalpha <= f[..., 6:7] + SIGMA_GUARD_EPS) & slot_valid[..., None]
    alpha = torch.exp(torch.where(ok, logalpha,
                                  torch.full_like(logalpha, -1e30)))
    ok = ok & (alpha >= ALPHA_THRESHOLD)
    alpha = torch.where(ok, torch.clamp(alpha, max=ALPHA_CLAMP),
                        torch.zeros_like(alpha))
    t_inc = torch.cumprod(1.0 - alpha, dim=1)
    keep = t_inc >= TRANSMITTANCE_EPS
    return alpha, ok, t_inc, keep, idx, slot_valid


def segpair_fwd_ref(feats: torch.Tensor, s_f: torch.Tensor,
                    basis: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward: a cumprod along each padded run."""
    alpha, _, t_inc, keep, _, _ = _padded_alpha(feats, s_f, basis)
    t_prev = t_inc / (1.0 - alpha)
    return torch.sum(alpha * t_prev * keep, dim=1)


def segpair_bwd_ref(feats: torch.Tensor, s_f: torch.Tensor,
                    basis: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: d log alpha = alpha * gt / (1 - alpha) on
    kept lanes (the algebraic suffix, pallas_segpair.py:47-57), reduced
    over pixels against the basis. Rows outside every run are zero."""
    alpha, ok, _, keep, idx, slot_valid = _padded_alpha(feats, s_f, basis)
    dalpha = gt[:, None, :] / (1.0 - alpha) * keep
    dla = torch.where(ok & (alpha < ALPHA_CLAMP), alpha * dalpha,
                      torch.zeros_like(alpha))
    dpad = dla @ basis.T                                          # [T,R,8]
    dpad = dpad * slot_valid[..., None]
    dfeats = torch.zeros_like(feats)
    dfeats[idx[slot_valid]] = dpad[slot_valid]
    return dfeats


def pair_inputs(packed_sorted: torch.Tensor, pbins: PairBins,
                origins: torch.Tensor):
    """Per-pair source rows and tile origins: (src [B,8], ox [B], oy [B])."""
    B = pbins.pair_ranks.shape[0]
    T = pbins.counts_f.shape[0]
    q = torch.arange(B, device=pbins.s_f.device)
    fr = torch.clamp(torch.searchsorted(pbins.s_f, q, right=True) - 1,
                     max=T - 1)
    org = origins[pbins.perm[fr]]                                 # [B,2]
    return packed_sorted[pbins.pair_ranks], org[:, 0], org[:, 1]


def pair_grads_to_packed(dfeats, src, ox, oy, pbins: PairBins, n: int):
    """Per-pair feature gradients -> (dpacked [N,8] in rank order,
    dsink [N,2] in Gaussian-id order), as _sp_bwd (pallas_segpair.py:
    609-624) does: VJP through the features, rows [dsrc, |dsrc[:,3:5]|],
    one deterministic sum of the valid pairs' rows by pair rank
    (ops/rank_sum.py). The |.| is taken per pair before the sum, which is
    what absgrad means."""
    valid = pbins.pair_valid[:, None]
    dfeats = torch.where(valid, dfeats, torch.zeros_like(dfeats))
    dsrc = build_pair_features_vjp(src, ox, oy, dfeats)
    rows = torch.cat([dsrc, torch.abs(dsrc[:, 3:5])], dim=-1)     # [B,10]
    acc = rank_sum(rows, pbins.pair_ranks, n, pbins.pair_valid)
    dsink = torch.zeros((n, 2), dtype=rows.dtype, device=rows.device)
    dsink[pbins.order] = acc[:, 8:10]
    return acc[:, :8], dsink


class SegpairRender(torch.autograd.Function):
    """Frame-ordered tile intensities [T,256] from the pair tables.

    ``apply(packed_sorted [N,8], pbins, origins [T,2], basis [8,256],
    sink [N,2])``: differentiable in ``packed_sorted``; ``sink`` is a zero
    gradient port whose cotangent reports each Gaussian's accumulated
    |d means2d| (absgrad). The |.| is summed per pair inside backward:
    autograd through a gather would sum signed values.
    """

    @staticmethod
    def forward(ctx, packed_sorted, pbins: PairBins, origins, basis, sink):
        src, ox, oy = pair_inputs(packed_sorted, pbins, origins)
        feats = build_pair_features(src, ox, oy).contiguous()
        s_f = pbins.s_f.to(torch.int32)
        img = segpair_fwd(feats, s_f, basis.contiguous())
        ctx.pbins = pbins
        ctx.n = packed_sorted.shape[0]
        ctx.save_for_backward(src, ox, oy, feats, s_f, basis, img)
        return img

    @staticmethod
    def backward(ctx, g):
        src, ox, oy, feats, s_f, basis, img = ctx.saved_tensors
        gt = (g * (1.0 - img)).contiguous()
        dfeats = segpair_bwd(feats, s_f, basis.contiguous(), gt)
        dpacked, dsink = pair_grads_to_packed(dfeats, src, ox, oy,
                                              ctx.pbins, ctx.n)
        return dpacked, None, None, None, dsink
