"""The chunked-scan dense compositor of the kernel lab: the counterpart of
``scripts/kernel_lab.py::fwd_v3`` (:116) and ``::bwd_v3`` (:206), and of
``scripts/cumprod_lab.py::fwd`` (:165) with its choice of scan.

It computes what ``ops/raster_v2.py`` computes on a frame ``feats
[T,K,8]``, in the lab's form: there are no counts (dead slots carry the
-1e30 constant term, so their alpha is 0), every slot is evaluated (no
early stop), and the front-to-back transmittance is a cumulative product
of (1 - alpha) over chunks of ``chunk`` slots, carried from one chunk to
the next. Per tile, pixel and slot:

    alpha = min(exp(log a), 0.999) where log a <= f_6 + 1e-3 and
            exp(log a) >= 1/255, else 0
    t_inc = t_carry * scan(1 - alpha);  keep = t_inc >= 1e-4
    img  += alpha * (t_inc / (1 - alpha)) * keep

and ``t_out`` is the product over all K slots. The scans (``scan=``):

- ``"v3"``: the cumulative product (kernel_lab.py:76, cumprod_lab.py:55);
- ``"noscan"``: (1 - alpha) as is (cumprod_lab.py:66): WRONG by design,
  the cost floor of the scan; the carry moves only at chunk ends;
- ``"twolevel"``: the product inside groups of 8, then a prefix over the
  group tails. The JAX ``_scan_twolevel`` (cumprod_lab.py:70-113) rolls
  the tail products by one group and so reads the previous group's head
  (always 1): it returns the product inside each group only. The port
  computes the two-level scan the script meant, which equals ``"v3"`` up
  to rounding (a deliberate divergence, pinned by tests/test_torch_lab.py);
- ``"logsum"``: a log-space cumulative sum, then exp (the script's
  ``matmul`` form, cumprod_lab.py:116).

The backward (``bwd_v3``) replays the forward with the ``"v3"`` scan,
carries the running sum of contributions from ``prior``, and uses the
algebraic suffix ``suffix = total - c_inc``, ``d alpha = (T_prev -
suffix / (1 - alpha)) * g`` on kept slots (kernel_lab.py:184-203); not
``raster_v2``'s folded ``g * (1 - total)`` form.

The JAX wrapper takes ``chunk = min(chunk, K)`` and then quietly drops
the slots past ``(K // chunk) * chunk`` (kernel_lab.py:92); the port
raises on ``K % chunk != 0`` instead. The TPU's ``tile_block`` (a VMEM
layout knob, with rows padded to its multiple) has no counterpart.

Two implementations, chosen by the device of the input:

- ``csrc/lab_chunked.cu``, the Hopper kernels, for CUDA tensors:
  :func:`chunked_fwd` / :func:`chunked_bwd` launch them or raise, and
  each launch adds one to ``launch_counts``. One CTA per frame row, one
  thread per pixel with its carry in registers; the row's slots staged
  by position in batches of whole 32-slot segments, each batch's live
  slots (the -1e30 marker leaves out the dead, which add exact zeros)
  walked in sub-chunks of 16 with the scan form in registers; the
  backward's pixel reduction on the tensor cores;
- :func:`chunked_fwd_ref` / :func:`chunked_bwd_ref`, plain PyTorch over
  chunks of rows and of slots, for CPU tensors, and the yardstick the
  kernels are held to on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.projection import (
    ALPHA_CLAMP, ALPHA_THRESHOLD, SIGMA_GUARD_EPS, TRANSMITTANCE_EPS)
from edgegaussians_tpu_torch.ops.raster_v2 import _row_chunks
from edgegaussians_tpu_torch.ops.segpair import PIXELS, check_tensor

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/lab_chunked.cu"
SCANS = ("v3", "noscan", "twolevel", "logsum")
GROUP = 8           # the two-level scan's group (cumprod_lab.py:70)
SEGMENT = 32        # the kernels stage batches of whole 32-slot segments
LOG_FLOOR = 1e-30   # log(max(1 - alpha, 1e-30)), cumprod_lab.py:118

# Launches of each kernel since the last reset_launch_counts(); only the
# kernel wrappers below add to these.
launch_counts = {**{f"lab_fwd_{s}": 0 for s in SCANS}, "lab_bwd_v3": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def resolve_chunk(k: int, chunk: int, scan: str = "v3") -> int:
    """``min(chunk, K)`` as the JAX wrappers take it; raise where the
    chunks do not tile the K slots (the JAX lab would drop the rest) or,
    for ``"twolevel"``, where a chunk does not hold whole groups."""
    if scan not in SCANS:
        raise ValueError(f"unknown scan {scan!r}; one of {SCANS}")
    chunk = min(chunk, k)
    if chunk < 1 or k % chunk:
        raise ValueError(f"K = {k} slots do not split into chunks of "
                         f"{chunk}: the JAX lab would drop the last "
                         f"{k % max(chunk, 1)}")
    if scan == "twolevel" and chunk % GROUP:
        raise ValueError(f"the two-level scan needs chunks of whole groups "
                         f"of {GROUP}, got {chunk}")
    return chunk


def _check_inputs(feats, basis, **planes):
    if feats.dim() != 3:
        raise ValueError(f"feats: expected [T,K,8], got {tuple(feats.shape)}")
    T, K, _ = feats.shape
    dev = feats.device
    check_tensor("feats", feats, torch.float32, (T, K, 8), dev)
    check_tensor("basis", basis, torch.float32, (8, PIXELS), dev)
    for name, x in planes.items():
        if x is not None:
            check_tensor(name, x, torch.float32, (T, PIXELS), dev)
    return T, K


def _device_kind(feats):
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lab kernel for device {feats.device}")
    return feats.device.type


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(name, argtypes, args):
    _build.launch("lab_chunked", name, argtypes, args)
    launch_counts[name] += 1


# feats, basis, t_in, img, t_out; rows, K, chunk; stream
_FWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
# feats, basis, g, t_in, prior, total, dfeats; rows, K; stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 2 + (
    ctypes.c_void_p,)


def chunked_fwd(feats: torch.Tensor, basis: torch.Tensor,
                t_in: Optional[torch.Tensor] = None, *, scan: str = "v3",
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [T,K,8] f32, basis [8,256] f32, t_in [T,256] f32 (None:
    transmittance 1) -> (img [T,256], t_out [T,256]). CUDA tensors launch
    the ``scan`` form's kernel (``chunk`` a multiple of the kernels' 32-slot
    segment); CPU tensors take :func:`chunked_fwd_ref`."""
    chunk = resolve_chunk(feats.shape[1], chunk, scan)
    if _device_kind(feats) == "cpu":
        return chunked_fwd_ref(feats, basis, t_in, scan=scan, chunk=chunk)
    T, K = _check_inputs(feats, basis, t_in=t_in)
    if chunk % SEGMENT:
        raise ValueError(f"the kernels stage batches of whole {SEGMENT}-slot "
                         f"segments: chunk {chunk} must be a multiple")
    img = torch.empty((T, PIXELS), dtype=torch.float32, device=feats.device)
    t_out = torch.empty_like(img)
    stream = _build.stream(feats.device)
    _launch(f"lab_fwd_{scan}", _FWD_ARGTYPES,
            (feats.data_ptr(), basis.data_ptr(), _ptr(t_in), img.data_ptr(),
             t_out.data_ptr(), T, K, chunk, stream))
    return img, t_out


def chunked_bwd(feats: torch.Tensor, basis: torch.Tensor, g: torch.Tensor,
                t_in: Optional[torch.Tensor], prior: Optional[torch.Tensor],
                total: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """VJP w.r.t. feats of the ``"v3"`` forward: upstream g [T,256], the
    entering transmittance t_in (None: 1), the contributions already
    composited in front, prior (None: 0), and the whole composite's total
    [T,256] -> dfeats [T,K,8] (columns 6-7 zero). CPU tensors take
    :func:`chunked_bwd_ref`."""
    chunk = resolve_chunk(feats.shape[1], chunk)
    if _device_kind(feats) == "cpu":
        return chunked_bwd_ref(feats, basis, g, t_in, prior, total,
                               chunk=chunk)
    T, K = _check_inputs(feats, basis, g=g, t_in=t_in, prior=prior,
                         total=total)
    dfeats = torch.empty_like(feats)
    stream = _build.stream(feats.device)
    _launch("lab_bwd_v3", _BWD_ARGTYPES,
            (feats.data_ptr(), basis.data_ptr(), g.data_ptr(), _ptr(t_in),
             _ptr(prior), total.data_ptr(), dfeats.data_ptr(), T, K, stream))
    return dfeats


def _slot_alpha(fc: torch.Tensor, basis: torch.Tensor):
    """alpha and the ok mask of a chunk fc [R,C,8], each [R,C,256]
    (kernel_lab.py:161-169)."""
    logalpha = fc @ basis
    alpha = torch.exp(logalpha)
    ok = (logalpha <= fc[..., 6:7] + SIGMA_GUARD_EPS) & \
        (alpha >= ALPHA_THRESHOLD)
    return torch.where(ok, torch.clamp(alpha, max=ALPHA_CLAMP),
                       torch.zeros_like(alpha)), ok


def scan_transmittance(om: torch.Tensor, scan: str) -> torch.Tensor:
    """The chunk's inclusive transmittance factors along dim 1 of
    ``om = 1 - alpha`` [R,C,256], in the ``scan`` form."""
    if scan == "v3":
        return torch.cumprod(om, dim=1)
    if scan == "noscan":
        return om
    if scan == "twolevel":
        R, C, P = om.shape
        x = torch.cumprod(om.reshape(R, C // GROUP, GROUP, P), dim=2)
        tails = torch.cumprod(x[:, :, -1], dim=1)              # [R,G,P]
        excl = torch.cat([torch.ones_like(tails[:, :1]), tails[:, :-1]], 1)
        return (x * excl[:, :, None]).reshape(R, C, P)
    if scan == "logsum":
        return torch.exp(torch.cumsum(
            torch.log(torch.clamp(om, min=LOG_FLOOR)), dim=1))
    raise ValueError(f"unknown scan {scan!r}; one of {SCANS}")


def _ones(feats):
    return torch.ones((feats.shape[0], PIXELS), dtype=torch.float32,
                      device=feats.device)


def chunked_fwd_ref(feats: torch.Tensor, basis: torch.Tensor,
                    t_in: Optional[torch.Tensor] = None, *,
                    scan: str = "v3", chunk: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward, chunk by chunk as the JAX kernel walks
    (cumprod_lab.py:134-162), over chunks of rows."""
    T, K, _ = feats.shape
    chunk = resolve_chunk(K, chunk, scan)
    t_in = _ones(feats) if t_in is None else t_in
    img = torch.zeros((T, PIXELS), dtype=torch.float32, device=feats.device)
    t_out = t_in.clone()
    for r0, r1 in _row_chunks(T, chunk):
        t_carry = t_in[r0:r1]
        acc = img[r0:r1]
        for c0 in range(0, K, chunk):
            alpha, _ = _slot_alpha(feats[r0:r1, c0:c0 + chunk], basis)
            om = 1.0 - alpha
            t_inc = t_carry[:, None, :] * scan_transmittance(om, scan)
            keep = t_inc >= TRANSMITTANCE_EPS
            acc += torch.sum(alpha * (t_inc / om) * keep, dim=1)
            t_carry = t_inc[:, -1]
        t_out[r0:r1] = t_carry
    return img, t_out


def chunked_bwd_ref(feats: torch.Tensor, basis: torch.Tensor,
                    g: torch.Tensor, t_in: Optional[torch.Tensor],
                    prior: Optional[torch.Tensor], total: torch.Tensor, *,
                    chunk: int = 128) -> torch.Tensor:
    """Plain PyTorch backward: the fused replay and VJP of
    kernel_lab.py:172-203, chunk by chunk, over chunks of rows."""
    T, K, _ = feats.shape
    chunk = resolve_chunk(K, chunk)
    t_in = _ones(feats) if t_in is None else t_in
    prior = torch.zeros_like(t_in) if prior is None else prior
    dfeats = torch.zeros_like(feats)
    for r0, r1 in _row_chunks(T, chunk):
        t_carry, csum = t_in[r0:r1], prior[r0:r1]
        gg, tot = g[r0:r1, None, :], total[r0:r1, None, :]
        for c0 in range(0, K, chunk):
            alpha, ok = _slot_alpha(feats[r0:r1, c0:c0 + chunk], basis)
            om = 1.0 - alpha
            t_inc = t_carry[:, None, :] * torch.cumprod(om, dim=1)
            keep = t_inc >= TRANSMITTANCE_EPS
            t_prev = t_inc / om
            contrib = alpha * t_prev * keep
            c_inc = csum[:, None, :] + torch.cumsum(contrib, dim=1)
            suffix = tot - c_inc
            dalpha = (t_prev - suffix / om) * keep * gg
            dla = torch.where(ok & (alpha < ALPHA_CLAMP), alpha * dalpha,
                              torch.zeros_like(alpha))
            dfeats[r0:r1, c0:c0 + chunk] = dla @ basis.T
            t_carry, csum = t_inc[:, -1], c_inc[:, -1]
    return dfeats
