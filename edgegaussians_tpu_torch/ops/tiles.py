"""Tile binning and screen-space feature construction.

Counterpart of ``edgegaussians_tpu/ops/tiles.py``: the fused-key sort
(``_sort_pairs``), the frame-ordered pair tables of the seg path
(``bin_pairs_frame_order`` with ``block_tiles=0``) and of the v4
block-window path (``block_tiles > 0``: the re-key sort with brick
alignment pads), the dense per-tile slot lists of the single-level
(``bin_gaussians``) and two-level (``bin_gaussians_two_level``) frame
paths, the latter's pair-prefix tables (``pair_budget > 0``), the
per-slot features (``build_tile_features``), and the pixel basis, tile
origins, packed render rows and image assembly.

Pixel evaluation is a depth-8 contraction: for conic (a,b,c), centre
(mx,my) in TILE-LOCAL pixel coordinates and log-opacity lo,

    log alpha(px,py) = G . [px^2, px*py, py^2, px, py, 1, 0, 0]

with G = [-a/2, -b, -c/2, a*mx+b*my, b*mx+c*my,
          -(a*mx^2 + 2b*mx*my + c*my^2)/2 + lo, lo, 0].

The JAX version's TPU workarounds have no counterpart here: run starts are
one ``searchsorted`` (``_tile_run_starts``, not the histogram-bracketed
window search) and ranks decode with a plain index (not the one-hot row
gather).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from edgegaussians_tpu_torch.ops.projection import ProjectedGaussians

# Bits reserved for the depth rank inside the fused sort key: capacity for
# 2^18 = 262144 Gaussians; tile ids must satisfy T < 2^31 / 2^18 = 8192.
RANK_BITS = 18
RANK_MASK = (1 << RANK_BITS) - 1
# Max tiles one Gaussian may cover (its 3-sigma box is truncated beyond).
MAX_TILES_PER_GAUSSIAN = 64
INVALID_KEY = 2 ** 31 - 1


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_grid(width: int, height: int, tile_size: int):
    """(tiles_x, tiles_y, num_tiles)."""
    ntx, nty = cdiv(width, tile_size), cdiv(height, tile_size)
    return ntx, nty, ntx * nty


class TileBins(NamedTuple):
    """Depth-ordered per-tile slot lists of the single-level frame path:
    slot k of tile t holds the depth rank of the tile's k-th nearest
    Gaussian (tiles.py:40-55). Index tensors are int64."""
    ranks: torch.Tensor          # [T,K] depth ranks (clipped; any rank
                                 # where the slot is invalid)
    valid: torch.Tensor          # [T,K] bool: k < counts[t]
    counts: torch.Tensor         # [T] true per-tile occupancy
    order: torch.Tensor          # [N] depth rank -> Gaussian id
    num_truncated: torch.Tensor  # scalar (see PairBins)


class TileBinsTwoLevel(NamedTuple):
    """Two-level slot lists (tiles.py:58-90): every tile's first k1 slots,
    plus k2 more slots for the ``t2`` busiest tiles. Frame rows are tile
    order, or descending occupancy under ``tile_perm`` (then the overflow
    tiles are frame rows [0, t2)).

    With a pair budget B the slots are not decoded (``ranks1``/``ranks2``
    are None): ``pair_rows``/``pair_ranks`` map each of the first B
    sorted pairs to its row of the flattened ``[T*k1 + t2*k2]`` frame
    (rows past the frame are dropped pairs), see ``_pair_prefix_tables``.
    """
    ranks1: Optional[torch.Tensor]  # [T,k1] depth ranks, FRAME row order
    counts: torch.Tensor         # [T] true per-tile occupancy (tile order)
    counts1: torch.Tensor        # [T] min(counts, k1), FRAME row order
    ovf_ids: torch.Tensor        # [t2] busiest tile ids (descending count)
    counts2: torch.Tensor        # [t2] clip(counts[ovf] - k1, 0, k2)
    ranks2: Optional[torch.Tensor]  # [t2,k2] depth ranks
    order: torch.Tensor          # [N] depth rank -> Gaussian id
    num_truncated: torch.Tensor  # scalar (see PairBins)
    num_pairs: torch.Tensor      # scalar: true (tile, Gaussian) pair count
    tile_perm: Optional[torch.Tensor]  # [T] frame row -> tile id, or None
    pair_rows: Optional[torch.Tensor] = None   # [B] frame row of pair p
    pair_ranks: Optional[torch.Tensor] = None  # [B] depth rank of pair p


class PairBins(NamedTuple):
    """Frame-ordered pair tables of the pair compositors.

    Frame row ``fr``'s pairs are the contiguous, depth-ordered run
    ``[s_f[fr], s_f[fr] + counts_f[fr])`` of the pair arrays. For the seg
    compositor (``block_tiles=0``) frame rows order tiles by descending
    KEPT run length (zero-kept rows last) and runs are back to back. For
    the v4 block-window compositor (``block_tiles > 0``) they order tiles
    by descending raw occupancy, and each block's last row ends in pad
    pairs that align the next block to a 128-pair brick: there
    ``s_f[fr+1] - s_f[fr] - counts_f[fr]`` is the row's pad count. Index
    tensors are int64 (torch's index type); the kernel wrappers take int32
    copies.
    """
    pair_ranks: torch.Tensor   # [B] depth rank of pair q (clipped to
                               # n - 1; 0 where invalid on the seg path)
    pair_valid: torch.Tensor   # [B] bool: a real, composited pair
    s_f: torch.Tensor          # [T+1] run start of frame row fr
    counts_f: torch.Tensor     # [T] composited pairs in FRAME order
    perm: torch.Tensor         # [T] frame row -> tile id
    order: torch.Tensor        # [N] depth rank -> Gaussian id
    counts: torch.Tensor       # [T] true occupancy (tile order)
    num_pairs: torch.Tensor    # scalar: true pair count (audit vs B)
    num_truncated: torch.Tensor  # scalar: Gaussians whose tile box
                                 # exceeded max_tiles_per_gaussian


@torch.no_grad()
def _sort_pairs(proj: ProjectedGaussians, width: int, height: int,
                tile_size: int, m: int):
    """Expand Gaussians into (tile, depth-rank) pairs and sort by the fused
    int32 key ``tile_id << RANK_BITS | rank`` (invalid pairs get INT32_MAX
    and sort to the tail).

    Returns (sorted_keys [N*M], starts [T+1], counts [T], order [N],
    num_truncated scalar)."""
    n = proj.depths.shape[0]
    dev = proj.depths.device
    ntx, nty, num_tiles = tile_grid(width, height, tile_size)
    if num_tiles << RANK_BITS >= 2 ** 31:
        raise ValueError(
            f"{num_tiles} tiles overflow the int32 fused sort key; "
            "raise tile_size or shard the image")
    if n > (1 << RANK_BITS):
        raise ValueError(f"{n} Gaussians exceed the {1 << RANK_BITS} "
                         "rank capacity of the fused sort key")

    # global depth-ascending order (stable), invalid entries last
    inf = torch.full_like(proj.depths, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depths, inf),
                          stable=True)
    m2d = proj.means2d[order]
    radii = proj.radii[order].to(torch.float32)
    valid = proj.valid[order]

    inv_ts = 1.0 / tile_size

    def span(lo, hi, nt):
        t0 = torch.clamp(torch.floor(lo * inv_ts), 0, nt).to(torch.int32)
        t1 = torch.clamp(torch.ceil(hi * inv_ts), 0, nt).to(torch.int32)
        return t0, t1

    tx0, tx1 = span(m2d[:, 0] - radii, m2d[:, 0] + radii, ntx)
    ty0, ty1 = span(m2d[:, 1] - radii, m2d[:, 1] + radii, nty)
    span_x = torch.clamp(tx1 - tx0, min=0)
    span_y = torch.clamp(ty1 - ty0, min=0)

    # expand to [N, M] candidate tiles (row-major within the span box)
    mm = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    sx = torch.clamp(span_x, min=1)[:, None]
    tx = tx0[:, None] + mm % sx
    ty = ty0[:, None] + torch.div(mm, sx, rounding_mode="floor")
    pair_valid = (valid[:, None] & (mm < (span_x * span_y)[:, None])
                  & (ty < nty))
    tile_id = ty * ntx + tx
    rank = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    keys = torch.where(pair_valid, (tile_id << RANK_BITS) | rank,
                       torch.full_like(tile_id, INVALID_KEY))

    sorted_keys = torch.sort(keys.reshape(-1)).values              # [N*M]
    starts = _tile_run_starts(sorted_keys, num_tiles)              # [T+1]
    counts = starts[1:] - starts[:-1]
    num_trunc = (valid & (span_x * span_y > m)).sum()
    return sorted_keys, starts, counts, order, num_trunc


def step_over_pairs(pos: torch.Tensor, vals: torch.Tensor, budget: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Stepwise-constant [budget] array (tiles.py:338-352): ``vals[i]`` on
    [pos[i], pos[i+1]); 0 before pos[0] and from pos[len(vals)] on.
    Coincident positions telescope; positions at or past ``budget`` are
    dropped."""
    vals = vals.to(dtype)
    zero = vals.new_zeros(1)
    deltas = torch.cat([vals, zero]) - torch.cat([zero, vals])
    out = torch.zeros(budget + 1, dtype=dtype, device=vals.device)
    out.index_add_(0, torch.clamp(pos, 0, budget).long(), deltas)
    return torch.cumsum(out[:budget], 0, dtype=dtype)


def _tile_run_starts(sorted_keys: torch.Tensor,
                     num_tiles: int) -> torch.Tensor:
    """[T+1] run starts of the tile prefixes ``t << RANK_BITS`` in a
    fused-key sort (tiles.py:491-531): one ``searchsorted``."""
    bounds = torch.arange(num_tiles + 1, dtype=sorted_keys.dtype,
                          device=sorted_keys.device) << RANK_BITS
    return torch.searchsorted(sorted_keys, bounds)


@torch.no_grad()
def bin_pairs_frame_order(proj: ProjectedGaussians, width: int, height: int,
                          tile_size: int, cap: int, budget: int,
                          max_tiles_per_gaussian: int = MAX_TILES_PER_GAUSSIAN,
                          block_tiles: int = 0) -> PairBins:
    """Bin into frame-ordered pair runs (see :class:`PairBins`).

    ``block_tiles=0``, the seg compositor's tables: position p of tile t's
    sort-1 run survives iff p < budget (prefix slice), p - s_t < cap (slot
    filter) and p - s_t < counts_t (real pair), so per-tile kept counts
    are ``min(count, cap, clip(budget - s, 0))``, laid out sort-free.

    ``block_tiles > 0``, the v4 block-window compositor's tables
    (tiles.py:422-488): the budget prefix is re-keyed by
    ``frame_row << RANK_BITS | rank`` in raw-occupancy frame order, with
    per-block pads (ranks ``RANK_MASK - j``) that sort at the end of each
    block's last row, and sorted again.
    """
    T = tile_grid(width, height, tile_size)[2]
    n = proj.depths.shape[0]
    sorted_keys, starts, counts, order, num_trunc = _sort_pairs(
        proj, width, height, tile_size, max_tiles_per_gaussian)
    if block_tiles > 0:
        return _block_pair_tables(sorted_keys, starts, counts, order,
                                  num_trunc, n, cap, budget, block_tiles)
    s = starts[:-1]
    kept = torch.minimum(torch.clamp(counts, max=cap),
                         torch.clamp(budget - s, min=0))
    # frame rows by descending KEPT count, stable: zero-kept rows last even
    # when a high-occupancy tile's run starts past the budget
    perm = torch.sort(-kept, stable=True).indices
    kept_f = kept[perm]
    s_f = torch.cat([kept_f.new_zeros(1), torch.cumsum(kept_f, 0)])

    # pair q of frame row fr sits at sort-1 position s[perm[fr]] + q - s_f[fr]
    q = torch.arange(budget, dtype=s_f.dtype, device=s_f.device)
    fr = torch.clamp(torch.searchsorted(s_f, q, right=True) - 1, max=T - 1)
    pair_valid = q < s_f[-1]
    in_pos = torch.where(pair_valid, s[perm][fr] + q - s_f[fr],
                         torch.zeros_like(q))
    ranks = torch.clamp(sorted_keys[in_pos] & RANK_MASK, max=max(n - 1, 0))
    ranks = torch.where(pair_valid, ranks.to(torch.int64),
                        torch.zeros_like(q))
    return PairBins(
        pair_ranks=ranks, pair_valid=pair_valid, s_f=s_f, counts_f=kept_f,
        perm=perm, order=order, counts=counts, num_pairs=starts[-1],
        num_truncated=num_trunc)


def _budget_prefix(sorted_keys: torch.Tensor, budget: int) -> torch.Tensor:
    """The first ``budget`` sorted keys as int64, INVALID_KEY past the
    end."""
    pk = sorted_keys[:budget].long()
    return torch.cat([pk, pk.new_full((budget - pk.shape[0],), INVALID_KEY)])


def _block_pair_tables(sorted_keys, starts, counts, order, num_trunc,
                       n: int, cap: int, budget: int,
                       block_tiles: int) -> PairBins:
    """The v4 tables of :func:`bin_pairs_frame_order` (tiles.py:422-488):
    ``len(pair_ranks) = budget + 127 * ceil(T / block_tiles)``."""
    if n > RANK_MASK - 127:
        raise ValueError(
            f"{n} Gaussians leave no rank headroom for brick pads")
    T = counts.shape[0]
    dev = counts.device
    perm = torch.sort(-counts, stable=True).indices     # raw occupancy
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(T, device=dev)
    pk = _budget_prefix(sorted_keys, budget)
    pp = torch.arange(budget, device=dev)
    bounds = starts.long()
    # per-pair frame row and slot as step functions of the sort-1 position
    fr_of_p = step_over_pairs(bounds, inv_perm, budget, torch.int64)
    slot_of_p = pp + step_over_pairs(bounds, -bounds[:-1], budget,
                                     torch.int64)
    valid = (pp < bounds[-1]) & (slot_of_p < cap)
    new_key = torch.where(valid, (fr_of_p << RANK_BITS) | (pk & RANK_MASK),
                          torch.full_like(pk, INVALID_KEY))

    # per-block pads: block b's kept length is known before the re-sort,
    # so its pads (to the next 128-pair brick) get keys that sort at the
    # end of its last frame row, with ranks above every real rank
    Tp = cdiv(T, block_tiles) * block_tiles
    kept_f = torch.zeros(Tp, dtype=torch.int64, device=dev)
    kept_f[:T] = torch.clamp(counts[perm], max=cap)
    pads_b = torch.remainder(-kept_f.reshape(-1, block_tiles).sum(1), 128)
    G = pads_b.shape[0]
    last_fr = torch.clamp(torch.arange(G, device=dev) * block_tiles
                          + block_tiles - 1, max=T - 1)
    jj = torch.arange(127, device=dev)[None, :]
    pad_keys = torch.where(jj < pads_b[:, None],
                           (last_fr[:, None] << RANK_BITS) | (RANK_MASK - jj),
                           torch.full_like(jj, INVALID_KEY))
    pads_f = torch.zeros(T, dtype=torch.int64, device=dev)
    pads_f.index_add_(0, last_fr, pads_b)

    rk = torch.sort(torch.cat([new_key, pad_keys.reshape(-1)])
                    .to(torch.int32)).values
    s_f = _tile_run_starts(rk, T)
    counts_f = s_f[1:] - s_f[:-1] - pads_f
    rank = (rk & RANK_MASK).long()
    return PairBins(
        pair_ranks=torch.clamp(rank, 0, max(n - 1, 0)),
        pair_valid=(rk != INVALID_KEY) & (rank < max(n, 1)),
        s_f=s_f, counts_f=counts_f, perm=perm, order=order, counts=counts,
        num_pairs=starts[-1], num_truncated=num_trunc)


def _decode_ranks(sorted_keys: torch.Tensor, gidx: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Depth ranks at sorted-pair positions ``gidx`` (tiles.py:594-607):
    a plain clipped index. Positions past the end read the INVALID_KEY
    padding the JAX version's 8-wide rows add, so even invalid slots
    decode to the same (clipped) rank on both sides."""
    pad = (-sorted_keys.shape[0]) % 8
    if pad:
        sorted_keys = torch.cat([sorted_keys, sorted_keys.new_full(
            (pad,), INVALID_KEY)])
    gidx = torch.clamp(gidx, 0, sorted_keys.shape[0] - 1)
    return torch.clamp(sorted_keys[gidx] & RANK_MASK, 0,
                       max(n - 1, 0)).to(torch.int64)


@torch.no_grad()
def bin_gaussians(proj: ProjectedGaussians, width: int, height: int,
                  tile_size: int, capacity: int,
                  max_tiles_per_gaussian: int = MAX_TILES_PER_GAUSSIAN
                  ) -> TileBins:
    """Fixed-capacity per-tile lists (tiles.py:110-142): tiles past
    ``capacity`` keep their nearest ``capacity`` Gaussians; ``counts``
    keeps the true occupancy."""
    n = proj.depths.shape[0]
    capacity = min(capacity, n) if n > 0 else capacity
    sorted_keys, starts, counts, order, num_trunc = _sort_pairs(
        proj, width, height, tile_size, max_tiles_per_gaussian)
    kk = torch.arange(capacity, device=starts.device)[None, :]
    ranks = _decode_ranks(sorted_keys, starts[:-1, None] + kk, n)
    return TileBins(ranks=ranks, valid=kk < counts[:, None], counts=counts,
                    order=order, num_truncated=num_trunc)


@torch.no_grad()
def bin_gaussians_two_level(
        proj: ProjectedGaussians, width: int, height: int, tile_size: int,
        k1: int, k2: int, t2: int,
        max_tiles_per_gaussian: int = MAX_TILES_PER_GAUSSIAN,
        occupancy_sort: bool = False,
        pair_budget: int = 0) -> TileBinsTwoLevel:
    """Two-level lists (tiles.py:148-219): k1 slots for every tile and k2
    more for the ``t2`` busiest, decoded straight from the sorted keys at
    ``starts[ovf] + k1``; with ``pair_budget`` > 0, the pair-prefix
    tables instead of the decoded slots.

    The busiest tiles are those of the descending-count stable sort (ties
    by tile id, as ``lax.top_k`` and ``lax.sort_key_val`` break them);
    ``occupancy_sort`` also orders the frame rows that way.
    """
    n = proj.depths.shape[0]
    sorted_keys, starts, counts, order, num_trunc = _sort_pairs(
        proj, width, height, tile_size, max_tiles_per_gaussian)
    by_count = torch.sort(-counts, stable=True).indices
    ovf_ids = by_count[:t2]
    perm = by_count if occupancy_sort else None
    counts_f = counts if perm is None else counts[perm]
    common = dict(
        counts=counts, counts1=torch.clamp(counts_f, max=k1),
        ovf_ids=ovf_ids, counts2=torch.clamp(counts[ovf_ids] - k1, 0, k2),
        order=order, num_truncated=num_trunc, num_pairs=starts[-1],
        tile_perm=perm)
    if pair_budget > 0:
        pair_rows, pair_ranks = _pair_prefix_tables(
            sorted_keys, starts, counts, ovf_ids, k1, k2, pair_budget, perm)
        return TileBinsTwoLevel(ranks1=None, ranks2=None,
                                pair_rows=pair_rows, pair_ranks=pair_ranks,
                                **common)
    starts_f = starts[:-1] if perm is None else starts[:-1][perm]
    dev = starts.device
    kk1 = torch.arange(k1, device=dev)[None, :]
    kk2 = torch.arange(k2, device=dev)[None, :]
    starts2 = starts[:-1][ovf_ids] + k1
    return TileBinsTwoLevel(
        ranks1=_decode_ranks(sorted_keys, starts_f[:, None] + kk1, n),
        ranks2=_decode_ranks(sorted_keys, starts2[:, None] + kk2, n),
        **common)


# Frame-row offset of pairs that must not land in the frame (past a
# tile's composited slots or the pair budget, or invalid): every
# p + PAIR_DROP_OFF lies past any frame.
PAIR_DROP_OFF = 2 ** 30


def _pair_prefix_tables(sorted_keys, starts, counts, ovf_ids, k1: int,
                        k2: int, budget: int, tile_perm=None):
    """(pair_rows [B], pair_ranks [B]) of the first B sorted pairs
    (tiles.py:229-299): within tile t's run [s_t, s_t + counts_t), slots
    [0, k1) land at frame row ``f(t)*k1 + slot`` (f(t) = t, or the tile's
    frame row under occupancy sorting), slots [k1, k1+k2) of an overflow
    tile at ``T*k1 + j*k2 + slot - k1`` (j its place in the overflow
    list); everything else at ``p + PAIR_DROP_OFF``. The row is p plus a
    per-segment offset, built from [T]-sized deltas and one cumsum.
    ``pair_ranks`` are the keys' raw rank bits (not clipped)."""
    T = counts.shape[0]
    t2 = ovf_ids.shape[0]
    dev = counts.device
    s = starts[:-1].long()
    counts = counts.long()
    total = starts[-1].long()
    tt = torch.arange(T, device=dev)
    if tile_perm is None:
        frame_of = tt
        ovf_pos = torch.full((T,), -1, dtype=torch.int64, device=dev)
        ovf_pos[ovf_ids] = torch.arange(t2, device=dev)
        has_ovf = ovf_pos >= 0
    else:
        # occupancy sort: the overflow list is frame rows [0, t2)
        frame_of = torch.empty_like(tt)
        frame_of[tile_perm] = tt
        has_ovf = frame_of < t2
        ovf_pos = torch.where(has_ovf, frame_of, -1)
    drop = torch.full_like(s, PAIR_DROP_OFF)
    off_a = frame_of * k1 - s
    off_b = torch.where(has_ovf, T * k1 + ovf_pos * k2 - k1 - s, drop)
    # each run's last offset, which the next run's delta telescopes from
    endv = torch.where(counts <= k1, off_a,
                       torch.where(has_ovf & (counts <= k1 + k2), off_b,
                                   drop))
    prev_end = torch.cat([endv.new_zeros(1), endv[:-1]])
    no_pos = torch.full_like(s, budget)
    pos = torch.cat([s, torch.where(counts > k1, s + k1, no_pos),
                     torch.where(has_ovf & (counts > k1 + k2), s + k1 + k2,
                                 no_pos), total[None]])
    deltas = torch.cat([off_a - prev_end, off_b - off_a, drop - off_b,
                        (PAIR_DROP_OFF - endv[-1])[None]])
    acc = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    acc.index_add_(0, torch.clamp(pos, max=budget), deltas)
    pair_rows = torch.arange(budget, device=dev) + torch.cumsum(acc[:budget],
                                                                0)
    return pair_rows, _budget_prefix(sorted_keys, budget) & RANK_MASK


def build_tile_features(gathered: torch.Tensor, origins: torch.Tensor,
                        slot_validf: torch.Tensor) -> torch.Tensor:
    """[T,K,8] gathered packed rows -> [T,K,8] features G (tiles.py:
    647-672): the pair features of ops/segpair.py per slot, with the
    constant term forced to -1e30 on invalid slots (slot past the count,
    or an invalid Gaussian) so their alpha is exactly 0."""
    a, b, c = gathered[..., 0], gathered[..., 1], gathered[..., 2]
    mx = gathered[..., 3] - origins[:, None, 0]
    my = gathered[..., 4] - origins[:, None, 1]
    lo = gathered[..., 5]
    validf = slot_validf * gathered[..., 6]
    amx_bmy = a * mx + b * my
    bmx_cmy = b * mx + c * my
    const = -0.5 * (amx_bmy * mx + bmx_cmy * my) + lo
    const = torch.where(validf > 0, const, torch.full_like(const, -1e30))
    z = torch.zeros_like(a)
    return torch.stack([-0.5 * a, -b, -0.5 * c, amx_bmy, bmx_cmy, const,
                        lo, z], dim=-1)


def tile_origins(width: int, height: int, tile_size: int,
                 device=None) -> torch.Tensor:
    """[T,2] pixel coordinates of each tile's top-left corner."""
    ntx, nty, _ = tile_grid(width, height, tile_size)
    t = torch.arange(ntx * nty, device=device)
    return torch.stack([(t % ntx) * tile_size, (t // ntx) * tile_size],
                       dim=-1).to(torch.float32)


def pixel_basis(tile_size: int, device=None) -> torch.Tensor:
    """[8, P] per-pixel monomial basis in tile-local coordinates.

    Pixel centres at (col + 0.5, row + 0.5), row-major flattening.
    """
    r = torch.arange(tile_size, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    px = px.reshape(-1)
    py = py.reshape(-1)
    zeros = torch.zeros_like(px)
    return torch.stack([px * px, px * py, py * py, px, py,
                        torch.ones_like(px), zeros, zeros], dim=0)


def pack_gaussian_render_data(proj: ProjectedGaussians) -> torch.Tensor:
    """Pack per-Gaussian screen data into one [N,8] row matrix.

    Columns: (a, b, c, mx, my, log_opacity, validf, 0).
    """
    logop = torch.log(torch.clamp(proj.opacities, min=1e-12))
    return torch.stack([
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        proj.means2d[:, 0], proj.means2d[:, 1], logop,
        proj.valid.to(torch.float32), torch.zeros_like(logop)], dim=-1)


def assemble_image(tile_images: torch.Tensor, width: int, height: int,
                   tile_size: int) -> torch.Tensor:
    """[T,P] tile pixels -> [H,W] image (cropping any right/bottom padding)."""
    ntx, nty, _ = tile_grid(width, height, tile_size)
    img = tile_images.reshape(nty, ntx, tile_size, tile_size)
    img = img.permute(0, 2, 1, 3).reshape(nty * tile_size, ntx * tile_size)
    return img[:height, :width]
