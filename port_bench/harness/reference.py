"""Plain PyTorch reference of the recipe's training step.

Written from the recipe's mathematics, it imports nothing of the program:
gsplat-style EWA projection (near/far cull, the 1.3x tan-FOV clamp of the
Jacobian, the +0.3 low-pass blur, the antialiased opacity compensation,
the 3-sigma radius), the 16x16 tile binning (each Gaussian's tile box,
at most ``max_tiles_per_gaussian`` of its tiles in row-major order, each
tile's Gaussians in depth order, at most ``tile_gaussian_capacity`` a
tile, at most ``tile_pair_budget`` pairs over the tiles in tile order),
front-to-back compositing of all-ones colours (alpha below 1/255 skipped,
alpha clamped at 0.999, a pixel stops before the contribution that takes
its transmittance below 1e-4), the projection loss ('whole' L1, or
'bg_edge_ratio' with the recipe's flat-index sampler), autograd for the
four parameter groups and for each (tile, Gaussian) pair's screen-space
centre (absgrad: the norm of the per-Gaussian sums of |d mean2d|), Adam
with per-group counts and the recipe's learning-rate schedules, and, every
5th render past their start epochs, the exact kNN over the live rows, the
direction and ratio losses and their Adam steps on the geometry groups.

Every tensor takes the dtype of the state it is given: float64 for the
reference, float32 with TF32 matmuls for the control (the program states
float32 with TF32 off). The contractions that a lower precision would
touch are written as matmuls: camera transforms, covariances, the
per-pixel log-alpha of each pair against the pixel basis, the kNN's
distances.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

GROUPS = ("means", "scales", "quats", "opacities")
GEO = ("means", "scales", "quats")
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_MIN = 1e-4
EPS2D = 0.3
TAN_CLAMP = 1.3
NEAR, FAR = 0.01, 1e10
# a pixel is skipped where its quadratic form is below -SIGMA_GUARD: the
# form is positive definite, so this only absorbs rounding
SIGMA_GUARD = 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8
KNN_BLOCK = 4096             # query rows a block of the kNN
SLOTS_PER_CHUNK = 32768      # padded (tile, slot) pairs composited at once


# ---------------------------------------------------------------- state


def initial_state(arrays: Dict[str, torch.Tensor], alive: torch.Tensor,
                  capacity: int, dtype) -> Dict:
    """The state before the first step: ``arrays`` (the four groups at
    their first capacity) padded to ``capacity`` (zeros, quats [1,0,0,0],
    dead), zero Adam moments and counts, zero absgrads, count 1."""
    st = {}
    for g in GROUPS:
        x = arrays[g].to(dtype)
        pad = capacity - x.shape[0]
        fill = x.new_zeros((pad, x.shape[1]))
        if g == "quats":
            fill[:, 0] = 1.0
        st[g] = torch.cat([x, fill])
        st["m_" + g] = torch.zeros_like(st[g])
        st["v_" + g] = torch.zeros_like(st[g])
        st["c_" + g] = 0
    st["alive"] = torch.cat([alive, alive.new_zeros(capacity
                                                    - alive.shape[0])])
    st["absgrads"] = st["means"].new_zeros(capacity)
    st["absgrad_count"] = 1.0
    st["step"] = 0
    return st


def group_lr(cfg: Dict, epoch: int) -> float:
    """'step': start_lr * gamma ** (milestones passed); 'start_at': 0
    before start_at_epoch, start_lr from it."""
    if cfg["type"] == "step":
        return cfg["start_lr"] * cfg["gamma"] ** sum(
            1 for m in cfg["milestones"] if m <= epoch)
    return 0.0 if epoch < cfg["start_at_epoch"] else cfg["start_lr"]


def adam(st: Dict, grads: Dict[str, torch.Tensor], lrs: Dict[str, float],
         groups) -> None:
    for g in groups:
        st["c_" + g] += 1
        c = st["c_" + g]
        st["m_" + g] = B1 * st["m_" + g] + (1 - B1) * grads[g]
        st["v_" + g] = B2 * st["v_" + g] + (1 - B2) * grads[g] ** 2
        mh = st["m_" + g] / (1 - B1 ** c)
        vh = st["v_" + g] / (1 - B2 ** c)
        st[g] = st[g] - lrs[g] * mh / (torch.sqrt(vh) + EPS)


# ----------------------------------------------------------- projection


def rotmats(quats: torch.Tensor) -> torch.Tensor:
    """[N,4] wxyz -> [N,3,3] rotation matrices of the normalised quats."""
    q = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=-1,
                                                     keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(p: Dict, alive, viewmat, K, width: int, height: int):
    """(means2d [N,2], conics [N,3], log opacities [N], depths [N], radii
    [N] (no grad), valid [N]) of one camera; differentiable in the four
    groups of ``p`` (log scales, logit opacities)."""
    dt = p["means"].dtype
    R, t = viewmat[:3, :3].to(dt), viewmat[:3, 3].to(dt)
    fx, fy, cx, cy = (K[0, 0].item(), K[1, 1].item(), K[0, 2].item(),
                      K[1, 2].item())
    pc = p["means"] @ R.T + t
    x, y, z = pc.unbind(-1)
    in_depth = (z > NEAR) & (z < FAR)
    zs = torch.where(in_depth, z, torch.ones_like(z))
    means2d = torch.stack([fx * x / zs + cx, fy * y / zs + cy], -1)

    M = rotmats(p["quats"]) * torch.exp(p["scales"])[:, None, :]
    cov_c = R @ (M @ M.transpose(1, 2)) @ R.T                    # [N,3,3]
    lim_x = TAN_CLAMP * 0.5 * width / fx
    lim_y = TAN_CLAMP * 0.5 * height / fy
    tx = zs * torch.clamp(x / zs, -lim_x, lim_x)
    ty = zs * torch.clamp(y / zs, -lim_y, lim_y)
    zero = torch.zeros_like(zs)
    J = torch.stack([torch.stack([fx / zs, zero, -fx * tx / zs ** 2], -1),
                     torch.stack([zero, fy / zs, -fy * ty / zs ** 2], -1)],
                    -2)                                          # [N,2,3]
    cov2 = J @ cov_c @ J.transpose(1, 2)
    c00, c01, c11 = cov2[:, 0, 0], cov2[:, 0, 1], cov2[:, 1, 1]
    det = c00 * c11 - c01 * c01
    b00, b11 = c00 + EPS2D, c11 + EPS2D
    det_b = b00 * b11 - c01 * c01
    comp = torch.sqrt(torch.clamp(det / det_b, min=0.0))
    inv = 1.0 / torch.where(det_b > 0, det_b, torch.ones_like(det_b))
    conics = torch.stack([b11 * inv, -c01 * inv, b00 * inv], -1)
    with torch.no_grad():
        mid = 0.5 * (b00 + b11)
        radii = torch.ceil(3.0 * torch.sqrt(
            mid + torch.sqrt(torch.clamp(mid * mid - det_b, min=0.01))))
    opac = torch.sigmoid(p["opacities"][:, 0]) * comp
    logop = torch.log(torch.clamp(opac, min=1e-12))
    mx, my = means2d[:, 0].detach(), means2d[:, 1].detach()
    valid = (in_depth & (det_b > 0) & (mx + radii > 0) & (mx - radii < width)
             & (my + radii > 0) & (my - radii < height) & alive)
    return means2d, conics, logop, z.detach(), radii, valid


# --------------------------------------------------------------- tiles


@torch.no_grad()
def bin_pairs(means2d, depths, radii, valid, width: int, height: int,
              tile: int, cap: int, budget: int, max_tiles: int):
    """Kept (tile, Gaussian) pairs in (tile, depth) order: (tile ids [P],
    Gaussian ids [P])."""
    n = depths.shape[0]
    dev = depths.device
    ntx, nty = -(-width // tile), -(-height // tile)
    order = torch.argsort(torch.where(valid, depths,
                                      torch.full_like(depths, math.inf)),
                          stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    mx, my = means2d[:, 0], means2d[:, 1]

    def span(lo, hi, nt):
        return (torch.clamp(torch.floor(lo / tile), 0, nt).long(),
                torch.clamp(torch.ceil(hi / tile), 0, nt).long())

    tx0, tx1 = span(mx - radii, mx + radii, ntx)
    ty0, ty1 = span(my - radii, my + radii, nty)
    sx = torch.clamp(tx1 - tx0, min=0)
    area = sx * torch.clamp(ty1 - ty0, min=0)
    mm = torch.arange(max_tiles, device=dev)[None, :]
    sx1 = torch.clamp(sx, min=1)[:, None]
    tx = tx0[:, None] + mm % sx1
    ty = ty0[:, None] + mm // sx1
    ok = valid[:, None] & (mm < area[:, None]) & (ty < nty)
    gid = torch.arange(n, device=dev)[:, None].expand_as(tx)[ok]
    tid = (ty * ntx + tx)[ok]
    key, srt = torch.sort(tid * n + rank[gid])
    tid, gid = tid[srt], gid[srt]
    pos = torch.arange(tid.shape[0], device=dev)
    first = torch.searchsorted(tid, tid)       # each pair's tile start
    kept = (pos - first < cap) & (pos < budget)
    return tid[kept], gid[kept]


def pixel_basis(tile: int, dtype, device) -> torch.Tensor:
    """[6, tile*tile]: px^2, px*py, py^2, px, py, 1 at the pixel centres
    (col + 0.5, row + 0.5), rows of pixels first."""
    r = torch.arange(tile, dtype=dtype, device=device) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    return torch.stack([px * px, px * py, py * py, px, py,
                        torch.ones_like(px)])


def composite(pm, conic, logop, tid, width: int, height: int, tile: int,
              count_only: bool = False):
    """[H,W] intensity of the kept pairs (pair centres ``pm`` [P,2],
    conics, log opacities, tile ids ``tid`` sorted), and the pair-pixel
    evaluations whose transmittance before the pair is still >= 1e-4.
    With ``count_only`` the image is None."""
    dt, dev = pm.dtype, pm.device
    ntx, nty = -(-width // tile), -(-height // tile)
    basis = pixel_basis(tile, dt, dev)
    ox = (tid % ntx).to(dt) * tile
    oy = (tid // ntx).to(dt) * tile
    mx, my = pm[:, 0] - ox, pm[:, 1] - oy
    a, b, c = conic.unbind(-1)
    amx = a * mx + b * my
    bmy = b * mx + c * my
    feats = torch.stack([-0.5 * a, -b, -0.5 * c, amx, bmy,
                         -0.5 * (amx * mx + bmy * my) + logop], -1)
    tiles, counts = torch.unique_consecutive(tid, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.argsort(counts, descending=True, stable=True)
    out_ids, out_img = [], []
    evals = 0
    i = 0
    nt = tiles.shape[0]
    while i < nt:
        L = int(counts[by_len[i]])
        j = min(nt, i + max(1, SLOTS_PER_CHUNK // L))
        sel = by_len[i:j]
        slot = torch.arange(L, device=dev)
        sv = slot[None, :] < counts[sel][:, None]                # [Tc,L]
        idx = torch.where(sv, starts[sel][:, None] + slot[None, :],
                          torch.zeros_like(slot)[None, :])
        la = feats[idx] @ basis                                  # [Tc,L,P]
        ok = (la <= logop[idx][..., None] + SIGMA_GUARD) & sv[..., None]
        alpha = torch.exp(torch.where(ok, la, torch.full_like(la, -1e30)))
        ok = ok & (alpha >= ALPHA_MIN)
        alpha = torch.where(ok, torch.clamp(alpha, max=ALPHA_MAX),
                            torch.zeros_like(alpha))
        t_inc = torch.cumprod(1.0 - alpha, dim=1)
        t_prev = torch.cat([torch.ones_like(t_inc[:, :1]), t_inc[:, :-1]], 1)
        evals += int(((t_prev >= T_MIN) & sv[..., None]).sum())
        if not count_only:
            keep = (t_inc >= T_MIN) & sv[..., None]
            out_img.append(torch.sum(alpha * t_prev * keep, dim=1))
            out_ids.append(tiles[sel])
        i = j
    if count_only:
        return None, evals
    flat = pm.new_zeros((ntx * nty, tile * tile))
    if out_img:
        flat = flat.index_copy(0, torch.cat(out_ids), torch.cat(out_img))
    img = flat.reshape(nty, ntx, tile, tile).permute(0, 2, 1, 3)
    return img.reshape(nty * tile, ntx * tile)[:height, :width], evals


def render(p: Dict, alive, viewmat, K, width: int, height: int, rs: Dict):
    """(image [H,W], per-pair centres [P,2] (a node of the graph, for
    absgrad), Gaussian id of each pair, evaluations)."""
    means2d, conics, logop, depths, radii, valid = project(
        p, alive, viewmat, K, width, height)
    tid, gid = bin_pairs(means2d.detach(), depths, radii, valid, width,
                         height, rs["tile_size"], rs["capacity"],
                         rs["pair_budget"], rs["max_tiles_per_gaussian"])
    pm = means2d[gid]
    img, evals = composite(pm, conics[gid], logop[gid], tid, width, height,
                           rs["tile_size"])
    return img, pm, gid, evals


@torch.no_grad()
def count_work(p: Dict, alive, viewmat, K, width: int, height: int,
               rs: Dict) -> Tuple[int, int]:
    """(kept pairs, pair-pixel evaluations needed) of one view."""
    means2d, conics, logop, depths, radii, valid = project(
        p, alive, viewmat, K, width, height)
    tid, gid = bin_pairs(means2d, depths, radii, valid, width, height,
                         rs["tile_size"], rs["capacity"], rs["pair_budget"],
                         rs["max_tiles_per_gaussian"])
    _, evals = composite(means2d[gid], conics[gid], logop[gid], tid, width,
                         height, rs["tile_size"], count_only=True)
    return int(tid.shape[0]), evals


# ---------------------------------------------------------------- losses


def masked_l1(pred, gt, mask):
    m = mask.to(pred.dtype)
    return torch.sum(torch.abs(pred - gt) * m) / torch.clamp(m.sum(), min=1.0)


def projection_loss(pred, gt, edge, strategy: str, ratio: float,
                    scores: Optional[torch.Tensor]):
    """'whole': mean |pred - gt|. 'bg_edge_ratio': L1 over the edge pixels
    plus L1 over the flat indices [0, #background) with the
    int(ratio * #edge) smallest ``scores`` (every index tied with the
    largest of them too), unravelled over the whole image."""
    if strategy == "whole":
        return torch.mean(torch.abs(pred - gt))
    if strategy != "bg_edge_ratio":
        raise ValueError(f"no reference of the {strategy!r} loss")
    h, w = pred.shape
    n_edge = int(edge.sum())
    k = int(ratio * n_edge)
    support = torch.arange(h * w, device=pred.device) < h * w - n_edge
    sample = torch.zeros(h * w, dtype=torch.bool, device=pred.device)
    if k > 0:
        kth = torch.sort(scores[support]).values[min(k, h * w) - 1]
        sample = support & (scores <= kth)
    return masked_l1(pred, gt, edge) + masked_l1(pred, gt,
                                                 sample.reshape(h, w))


@torch.no_grad()
def knn_live(means, alive, k: int) -> torch.Tensor:
    """[L,k] capacity ids of the k nearest other live rows of each live
    row (the row itself excluded, as the recipe's sklearn helper excludes
    it), by squared distance as |q|^2 - 2 q.x + |x|^2."""
    live = torch.nonzero(alive).squeeze(1)
    X = means[live]
    xx = (X * X).sum(-1)
    out = []
    for s in range(0, X.shape[0], KNN_BLOCK):
        q = X[s:s + KNN_BLOCK]
        d2 = (q * q).sum(-1)[:, None] - 2.0 * (q @ X.T) + xx[None, :]
        rows = torch.arange(q.shape[0], device=q.device)
        d2[rows, s + rows] = math.inf
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
    return live[torch.cat(out)]


def direction_loss(means, scales, quats, alive, nn):
    """1 - the mean over live rows of the mean |cos| between each row's
    major axis (the rotation's column at its largest linear scale, the
    first on ties) and the unit vectors to its neighbours ``nn``."""
    live = torch.nonzero(alive).squeeze(1)
    R = rotmats(quats[live])
    amax = torch.argmax(torch.abs(torch.exp(scales[live])), dim=-1)
    major = R[torch.arange(live.shape[0], device=R.device), :, amax]
    d = means[live][:, None, :] - means[nn]
    d = d / torch.clamp(torch.sqrt((d * d).sum(-1)), min=1e-12)[..., None]
    align = torch.abs((major[:, None, :] * d).sum(-1)).mean(-1)
    return 1.0 - align.sum() / max(live.shape[0], 1)


def ratio_loss(scales, alive):
    """Mean over live rows of the middle over the largest linear scale
    (ties share the max's and min's gradient equally)."""
    s = torch.exp(scales[alive])
    s_max, s_min = torch.amax(s, -1), torch.amin(s, -1)
    mid = s.sum(-1) - s_max - s_min
    return (mid / torch.clamp(s_max, min=1e-12)).sum() / max(s.shape[0], 1)


# ------------------------------------------------------------------ step


def view_step(st: Dict, img_gt, edge, viewmat, K, ctx: Dict,
              strategy: str, scores, run_sum: torch.Tensor, record: Dict
              ) -> torch.Tensor:
    """One render, backward and Adam step, absgrad, and every 5th render
    past the start epochs the orientation steps; in place on ``st``.
    Returns the running sum of projection losses with this step's.
    ``record`` gets this step's loss and, on a fired step, the kNN."""
    width, height = img_gt.shape[1], img_gt.shape[0]
    p = {g: st[g].detach().requires_grad_() for g in GROUPS}
    img, pm, gid, _ = render(p, st["alive"], viewmat, K, width, height,
                             ctx["render"])
    pred = torch.clamp(img, 0.0, 1.0)
    loss = projection_loss(pred, img_gt.to(pred.dtype), edge, strategy,
                           ctx["bg_ratio"], scores)
    *gp, gpm = torch.autograd.grad(loss, [p[g] for g in GROUPS] + [pm])
    lam = ctx["lambda_proj"]
    adam(st, {g: lam * x for g, x in zip(GROUPS, gp)}, ctx["lrs"], GROUPS)
    sink = gpm.new_zeros((st["means"].shape[0], 2)).index_add_(
        0, gid, gpm.abs())
    st["absgrads"] = st["absgrads"] + torch.linalg.vector_norm(
        sink, dim=-1) * lam
    st["absgrad_count"] += 1.0
    st["step"] += 1
    record.setdefault("loss", []).append(float(loss.detach()))
    run_sum = run_sum + loss.detach()
    if st["step"] % 5 == 0 and (ctx["apply_dir"] or ctx["apply_ratio"]):
        orientation_step(st, run_sum, ctx, record)
    return run_sum


def orientation_step(st: Dict, run_sum, ctx: Dict, record: Dict) -> None:
    ol = ctx["orientation"]

    def step(loss_fn, factor):
        p = {g: st[g].detach().requires_grad_() for g in GEO}
        val = loss_fn(p)
        grads = torch.autograd.grad(val, [p[g] for g in GEO],
                                    allow_unused=True)
        lam = run_sum * factor / torch.clamp(val.detach(), min=1e-12)
        adam(st, {g: lam * (torch.zeros_like(p[g]) if x is None else x)
                  for g, x in zip(GEO, grads)}, ctx["lrs"], GEO)

    if ctx["apply_dir"]:
        k = ol["dir_loss_num_nn"]
        if ol["dir_loss_enforce_method"] != "enforce_full":
            raise ValueError("the reference takes enforce_full")
        # k + 1 fetched and the nearest dropped, as the recipe slices
        # its neighbours [:, 1:]
        nn = knn_live(st["means"], st["alive"], k + 1)[:, 1:]
        record["knn"] = nn
        step(lambda p: direction_loss(p["means"], p["scales"], p["quats"],
                                      st["alive"], nn),
             ol["dir_loss_scale_factor"])
    if ctx["apply_ratio"]:
        step(lambda p: ratio_loss(p["scales"], st["alive"]),
             ol["ratio_loss_scale_factor"])


def epoch_context(recipe: Dict, epoch: int) -> Dict:
    """The schedule's values at ``epoch`` that a view step reads."""
    tr = recipe["training"]
    pl = tr["loss"]["projection_losses"]
    ol = tr["loss"]["orientation_losses"]
    m = recipe["model"]
    for key in ("lambda_annealing", "bg_edge_pixel_ratio_annealing"):
        if pl[key] != "constant":
            raise ValueError(f"the reference takes constant {key}")
    return {
        "lrs": {g: group_lr(tr["optim"][g], epoch) for g in GROUPS},
        "lambda_proj": pl["lambda_start"],
        "bg_ratio": pl["bg_edge_pixel_ratio_start"],
        "apply_dir": epoch > ol["start_dir_loss_at_epoch"],
        "apply_ratio": epoch > ol["start_ratio_loss_at_epoch"],
        "alternating": epoch > pl["start_alternating_at_epoch"],
        "strategies": (pl["loss_before_alternating"], pl["less_freq_loss"],
                       pl["more_freq_loss"]),
        "sampling": max(int(pl["sampling_whole_num_epochs_ratio"]), 1),
        "orientation": ol,
        "render": {"tile_size": m["tile_size"],
                   "capacity": m["tile_gaussian_capacity"],
                   "pair_budget": m["tile_pair_budget"],
                   "max_tiles_per_gaussian": m["max_tiles_per_gaussian"]},
    }


def strategy_of(ctx: Dict, step: int) -> str:
    """The projection loss of the render that starts at ``step``."""
    before, less, more = ctx["strategies"]
    if not ctx["alternating"]:
        return before
    return less if step % ctx["sampling"] == 0 else more


def follow(st: Dict, views: List[int], scene, ctx: Dict,
           scores: List[Optional[torch.Tensor]]) -> Dict:
    """Run the view steps of ``views`` in order from ``st`` (in place):
    ``scores[i]`` is step i's bg_edge_ratio draw (None on other steps).
    Returns the record: each step's loss and the first fire's kNN, and
    the state after step 1 under ``after_1``."""
    record: Dict = {}
    run_sum = st["means"].new_zeros(())
    images, edges, viewmats, Ks = scene
    for i, v in enumerate(views):
        run_sum = view_step(st, images[v], edges[v], viewmats[v], Ks[v],
                            ctx, strategy_of(ctx, st["step"]), scores[i],
                            run_sum, record)
        if i == 0:
            record["after_1"] = {k: (x.clone() if torch.is_tensor(x) else x)
                                 for k, x in st.items()}
    return record
