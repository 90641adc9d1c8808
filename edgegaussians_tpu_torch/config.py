"""Typed configuration system.

The port's own copy of ``edgegaussians_tpu/config.py`` (NumPy only): the
port imports nothing of the JAX package, so the two stay in step by
tests/test_torch_common.py's parity tests, not by import.

Loads the same JSON config layout as the reference (sections ``model``,
``training``, ``data``, ``output``, ``filtering``, ``parametric_fitting`` —
reference: edgegaussians/utils/parse_utils.py:8-17, configs/ABC_DexiNed.json)
into typed dataclasses. Unknown keys are tolerated and missing keys take
dataclass defaults, mirroring the reference's ``dacite.from_dict`` behavior
(reference: edgegaussians/models/edge_gs.py:73).

TPU-specific additions (capacity, sharding, precision) live in their own
fields with defaults chosen so that unmodified reference configs run.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List


def _from_dict(cls, data: Dict[str, Any]):
    """Build a dataclass from a dict, ignoring unknown keys (dacite-style)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in names:
            continue
        f = next(f for f in dataclasses.fields(cls) if f.name == k)
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            v = _from_dict(f.type, v)
        kwargs[k] = v
    return cls(**kwargs)


@dataclass
class ModelConfig:
    """Gaussian model + density-control config.

    Field names and defaults mirror ``EdgeGaussianSplattingConfig``
    (reference: edgegaussians/models/edge_gs.py:16-54) so reference JSON
    configs load unchanged.
    """

    if_duplicate_high_pos_grad: bool = True
    # 'absolute' / 'percentile_top' mirror the reference (edge_gs.py:544-576);
    # 'top_fraction' is a TPU-native addition: duplicate the top
    # dup_threshold_value fraction of alive Gaussians by absgrad
    # (count-deterministic; see models/density.py)
    dup_threshold_type: str = "percentile"
    dup_threshold_value: float = 0.95
    dup_factor: int = 2
    dup_high_pos_grads_at_epoch: List[int] = field(
        default_factory=lambda: [36, 46, 51, 76, 101, 126, 151])

    if_cull_low_opacity: bool = True
    cull_opacity_type: str = "absolute"
    cull_opacity_value: float = 0.05
    cull_opacity_at_epoch: List[int] = field(default_factory=lambda: [80, 160])

    if_cull_wayward: bool = True
    cull_wayward_method: str = "mean_distance"
    cull_wayward_num_neighbors: int = 10
    cull_wayward_threshold_type: str = "percentile_top"
    cull_wayward_threshold_value: float = 0.05
    cull_wayward_at_epoch: List[int] = field(default_factory=lambda: [51, 101, 151])
    # The reference computes the wayward cull mask but never applies it
    # (edge_gs.py:498-542 lacks the cull call). Default reproduces that no-op;
    # set to True to apply the intended cull.
    cull_wayward_apply: bool = False

    init_random_init: bool = False
    init_dup_rand_noise_scale: float = 0.05
    init_min_num_gaussians: int = 5000
    init_scales_type: str = "constant"
    init_scales_val: float = 0.005
    init_opacity_type: str = "constant"
    init_opacity_val: float = 0.08
    random_init_box_center: float = 0.5
    random_init_box_size: float = 1.0

    if_cull_gaussians_not_projecting: bool = True
    cull_gaussians_not_projecting_at_epoch: List[int] = field(
        default_factory=lambda: [50, 100, 150])
    cull_gaussians_not_projecting_threshold: float = 0.35

    edge_detection_threshold: float = 0.5
    # Plain class attr in the reference (edge_gs.py:50): configs can never
    # override it there; we honor it as a real config field.
    rasterize_mode: str = "antialiased"

    if_reset_opacity: bool = False
    reset_opacity_at_epoch: List[int] = field(default_factory=lambda: [100])
    reset_opacity_value: float = 0.08

    # --- TPU-native additions ------------------------------------------------
    # Fixed Gaussian capacity for jit-safe densification. 0 = auto
    # (next power of two >= 4x the seed count).
    max_num_gaussians: int = 0
    # Staged capacity growth: start at a small power-of-two capacity
    # (>= start_factor x seeds) and double whenever occupancy crosses
    # grow_threshold, up to the resolved maximum. Early epochs then stop
    # paying the full-capacity projection/sort cost; each growth stage
    # costs one re-jit of the epoch function.
    staged_capacity: bool = False
    staged_capacity_start_factor: float = 2.0
    staged_capacity_grow_threshold: float = 0.85
    # Per-tile Gaussian capacity of the rasterizer (depth-ordered truncation).
    tile_gaussian_capacity: int = 512
    # Two-level capacity: dense per-tile budget (0 disables) + static count
    # of overflow tiles finished at full capacity (0 = auto, tiles/4).
    tile_dense_capacity: int = 128
    tile_overflow_tiles: int = 0
    # Max tiles one Gaussian's 3-sigma box may cover before truncation;
    # drives the [N*M] binning sort size. Trained edge scenes rarely
    # exceed 4 (needles) — RenderResult.num_truncated / the trainer's
    # 'trunc=' log shows violations.
    max_tiles_per_gaussian: int = 64
    # Sorted-pair-prefix budget (0 disables): renders gather/scatter only
    # this many (tile, Gaussian) pairs instead of every dense frame slot —
    # ~8x fewer rows on sparse edge scenes. Must cover the peak per-view
    # pair count (the trainer's 'pairs=' log / RenderResult.num_pairs);
    # pairs past it are dropped from the render like tiles past the
    # overflow budget.
    tile_pair_budget: int = 0
    # What the trainer does when a render's pair count exceeds
    # tile_pair_budget (that render already dropped pairs): 'fallback'
    # rebuilds the epoch program on the dense frame path for the rest of
    # the run (one re-jit; every later render is exact), 'error' raises,
    # 'warn' only logs (the pre-round-3 behavior). Budgets shipped in
    # configs are whole-run audited (scripts/pair_budget_audit.py), so
    # this triggers only on scenes denser than the audited set.
    tile_pair_overflow_action: str = "fallback"
    # Pair-domain DMA compositor selection. False = dense-frame two-level
    # path; True (or "block") = v4 block-window kernel (ops/pallas_pair.py,
    # measured 1.5x the dense path); "seg" = v5 segmented pair-dense kernel
    # (ops/pallas_segpair.py — what every shipped config runs). Needs
    # tile_pair_budget > 0. Single-level per-tile capacity semantics:
    # every tile composites min(count, tile_gaussian_capacity) pairs
    # (strictly MORE complete than the two-level k1/t2/k2 truncation).
    # Values are normalized/validated at config load (__post_init__).
    tile_pair_kernel: bool | str = False
    # Order compositor frame rows by descending tile occupancy: the kernels
    # predicate per TILE_BLOCK on the block max, so homogeneous blocks cut
    # predicated slot work ~2x on sparse edge scenes. Bitwise-identical
    # renders (tests/test_rasterize.py).
    tile_occupancy_sort: bool = True
    # Rasterizer tile size in pixels (reference BLOCK_WIDTH=16, edge_gs.py:233).
    tile_size: int = 16
    # 'pallas' on TPU, 'jax' pure-XLA fallback, 'reference' per-pixel oracle.
    rasterizer_backend: str = "auto"

    def __post_init__(self):
        pk = self.tile_pair_kernel
        if isinstance(pk, str):
            norm = {"0": False, "false": False, "off": False,
                    "1": True, "true": True, "block": True,
                    "2": "seg", "seg": "seg"}
            if pk.lower() not in norm:
                raise ValueError(
                    f"tile_pair_kernel: unknown value {pk!r} "
                    "(expected false/true/'block'/'seg')")
            self.tile_pair_kernel = norm[pk.lower()]
        elif isinstance(pk, int) and not isinstance(pk, bool):
            if pk not in (0, 1, 2):
                raise ValueError(
                    f"tile_pair_kernel: unknown value {pk!r}")
            self.tile_pair_kernel = (False, True, "seg")[pk]


@dataclass
class OptimGroupConfig:
    """One Adam group (reference: train_utils.py:48-65)."""
    type: str = "start_at"          # 'step' (MultiStepLR) | 'start_at'
    start_lr: float = 1e-3
    milestones: List[int] = field(default_factory=list)
    gamma: float = 1.0
    start_at_epoch: int = 0


@dataclass
class OptimConfig:
    means: OptimGroupConfig = field(default_factory=lambda: OptimGroupConfig(
        type="step", start_lr=2e-3))
    scales: OptimGroupConfig = field(default_factory=lambda: OptimGroupConfig(
        start_lr=1e-4, start_at_epoch=30))
    quats: OptimGroupConfig = field(default_factory=lambda: OptimGroupConfig(
        start_lr=1e-3, start_at_epoch=30))
    opacities: OptimGroupConfig = field(default_factory=lambda: OptimGroupConfig(
        start_lr=0.03, start_at_epoch=20))


@dataclass
class OrientationLossConfig:
    """reference: train_gaussians.py:37-40, configs/*.json orientation_losses."""
    start_dir_loss_at_epoch: int = 250
    start_ratio_loss_at_epoch: int = 100
    dir_loss_num_nn: int = 5
    dir_loss_enforce_method: str = "enforce_full"   # | 'enforce_half'
    lambda_dir_loss: str = "scale_to_projection_loss"
    lambda_ratio_loss: str = "scale_to_projection_loss"
    dir_loss_scale_factor: float = 0.01
    ratio_loss_scale_factor: float = 0.01


@dataclass
class ProjectionLossConfig:
    """reference: train_gaussians.py:57-77, train_utils.py:28-45."""
    loss_type: str = "l1"
    start_at_epoch: int = 0
    lambda_annealing: str = "constant"
    lambda_start: float = 1.0
    lambda_end: float = 1.0
    loss_before_alternating: str = "whole"
    less_freq_loss: str = "bg_edge_ratio"
    more_freq_loss: str = "whole"
    start_alternating_at_epoch: int = 50
    bg_edge_pixel_ratio_annealing: str = "constant"
    bg_edge_pixel_ratio_start: float = 1.0
    bg_edge_pixel_ratio_end: float = 1.0
    sampling_whole_num_epochs_ratio: int = 5


@dataclass
class LossConfig:
    orientation_losses: OrientationLossConfig = field(
        default_factory=OrientationLossConfig)
    projection_losses: ProjectionLossConfig = field(
        default_factory=ProjectionLossConfig)


@dataclass
class TrainingConfig:
    num_epochs: int = 400
    weights_update_freq: int = 1    # threaded but unused in the reference
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    # --- TPU-native additions ---
    # 'per_view': one optimizer step per view (reference-faithful;
    #  train_gaussians.py:71-106). 'view_batch': average grads over a view
    #  batch per step (enables data parallelism over views).
    step_mode: str = "per_view"
    view_batch_size: int = 0         # 0 = all views (view_batch mode)
    seed: int = 0
    checkpoint_interval: int = 0     # epochs; 0 = only final (reference saves once)
    log_interval: int = 1
    # TPU-native approximate top-k (recall 0.99) for the direction-loss kNN;
    # set False for sklearn-exact neighbor sets (reference behavior).
    approx_knn: bool = True


@dataclass
class DataConfig:
    parser_type: str = "emap"
    dataset_name: str = "ABC"
    base_dir: str = "data/ABC-NEF_Edge/data/"
    edge_detection_method: str = "DexiNed"
    new_extension: str = ""
    image_res_scaling_factor: float = 1.0
    scale_scene_unit: bool = False


@dataclass
class OutputConfig:
    output_dir: str = "output/ABC/"
    checkpoint_dir: str = ""
    export_ply: bool = True
    log_dir: str = "logs/ABC/"
    checkpoint_interval: int = 5
    log_interval: int = 1
    exp_name: str = "release"


@dataclass
class FilteringConfig:
    """reference: fit_edges.py:20-45, configs *filtering* section."""
    filter_by_opacity: bool = True
    filter_opacity_min: float = 0.2
    filter_stat_outliers: bool = True
    filter_stat_outlier_num_nn: int = 25
    filter_stat_outlier_std_mult: float = 2.0
    filter_by_projection: bool = True
    # NOTE: the reference reads this key from configs but never forwards it
    # (fit_edges.py:42 calls filter_by_projection without it, so the
    # hardcoded 0.1 default applies — filtering.py:83). We forward it.
    filter_visib_thresh: float = 0.1


@dataclass
class ParametricFittingConfig:
    """reference: fit_edges.py:88-93, configs *parametric_fitting* section."""
    angle_thresh: float = 0.8
    line_ransac_thresh: float = 0.005
    line_curve_residual_comp_factor: float = 0.4
    min_cluster_size: int = 10
    sample_resolution: float = 0.005


@dataclass
class ParallelConfig:
    """TPU scale-out config — no reference counterpart (single-GPU there)."""
    # Mesh axis sizes; 0 = use all local devices on the 'data' axis.
    data_axis: int = 0        # shards views (DP)
    tile_axis: int = 1        # shards image tiles within a view (CP analog)


@dataclass
class FrameworkConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    filtering: FilteringConfig = field(default_factory=FilteringConfig)
    parametric_fitting: ParametricFittingConfig = field(
        default_factory=ParametricFittingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


def load_config(path: str) -> FrameworkConfig:
    """Load a reference-layout JSON config file into typed dataclasses."""
    with open(path, "r") as f:
        raw = json.load(f)
    return config_from_dict(raw)


def config_from_dict(raw: Dict[str, Any]) -> FrameworkConfig:
    cfg = FrameworkConfig()
    if "model" in raw:
        cfg.model = _from_dict(ModelConfig, raw["model"])
    if "training" in raw:
        t = dict(raw["training"])
        optim_raw = t.pop("optim", None)
        loss_raw = t.pop("loss", None)
        cfg.training = _from_dict(TrainingConfig, t)
        if optim_raw is not None:
            cfg.training.optim = OptimConfig(**{
                k: _from_dict(OptimGroupConfig, v)
                for k, v in optim_raw.items()
                if k in ("means", "scales", "quats", "opacities")})
        if loss_raw is not None:
            cfg.training.loss = LossConfig(
                orientation_losses=_from_dict(
                    OrientationLossConfig, loss_raw.get("orientation_losses", {})),
                projection_losses=_from_dict(
                    ProjectionLossConfig, loss_raw.get("projection_losses", {})),
            )
    if "data" in raw:
        cfg.data = _from_dict(DataConfig, raw["data"])
    if "output" in raw:
        cfg.output = _from_dict(OutputConfig, raw["output"])
    if "filtering" in raw:
        cfg.filtering = _from_dict(FilteringConfig, raw["filtering"])
    if "parametric_fitting" in raw:
        cfg.parametric_fitting = _from_dict(
            ParametricFittingConfig, raw["parametric_fitting"])
    if "parallel" in raw:
        cfg.parallel = _from_dict(ParallelConfig, raw["parallel"])
    return cfg


def resolve_capacity(cfg: ModelConfig, num_seed: int) -> int:
    """Fixed Gaussian capacity: explicit, or next pow2 >= 4x seeds."""
    if cfg.max_num_gaussians > 0:
        return cfg.max_num_gaussians
    cap = 1
    while cap < 4 * num_seed:
        cap *= 2
    return max(cap, 1024)
