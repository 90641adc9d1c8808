"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile_dir DIR] [--full]

Phases, in order; any failure exits non-zero:

1. Environment and build: torch / CUDA / triton / nvcc versions, the card's
   name and power limit, then every kernel source of
   ``edgegaussians_tpu_torch/csrc/`` built at once, one nvcc each (timed,
   with the compiler's register and shared-memory report). The smoke's
   training runs write no TensorBoard logs (tensorboardX is made
   unimportable), so no path's launches or epochs include the trainer's
   view-0 render of every 5th epoch, whatever is installed.
2. The seg compositor kernels against their plain PyTorch versions at full
   size: the 5 cameras of ``bench_fixture/abc_00004926.npz`` (12740
   Gaussians, 800x800, cap 768, pair budget 49152), forward and backward.
   2 (dense): the dense compositor kernels against theirs on the same
   cameras at the recipe's two-level settings (k1 128, k2 640, t2 128,
   occupancy sort, pair budget 0), both levels, level 2 fed level 1's
   t_out. Both print errors and fwd/bwd times per camera (CUDA events,
   median of 5 blocks; beside the kernel's, its device time: calls queued
   behind a sleeping kernel) beside each kernel's bound; two launches of
   each kernel must give the same bits.
   The dense kernels' chain, timed one CTA alone on each camera's
   longest row of each level (its own slots, the same bits as in the
   whole launch) beside the level's launch; a faint level-2 row of 640
   slots that every pixel walks, held to the plain versions. Then the
   seg kernels' chain, timed: frames
   whose runs are all of one length, queued behind a sleeping kernel so
   the events time the device alone: one CTA of each kernel on each
   camera's longest run (its own pairs; its image held to the plain
   version), beside the launch's time per camera; one backward CTA on
   faint pairs of those lengths; one CTA of each kernel on 64 and 768
   faint pairs that every pixel walks to the end (the time a pair adds);
   and 768-pair backward runs at 1, 2 and 4 CTAs an SM.
   2 (knn): the kNN kernel against its plain version, bit for bit, at the
   recipe's capacity: the fixture's 12740 means as live rows padded with
   dead rows to 16384, k = 6 (the ABC fetch), 11 and 15, plus a mask with
   4 live rows for the dry slots; times of the kernel, the plain version
   and a cdist + topk yardstick beside the bound and the instruction
   floor. Then at the DTU / Replica capacity: 131072 rows uniform in the
   unit box from a seed, every other row live, k = 6, bit-equal to the
   plain version on 2048 seeded query rows, timed beside its bound and
   cdist + topk over chunks of 8192 query rows.
   2 (pair): the v4 block-window pair kernels against their plain versions
   on the same cameras at the recipe's cap 768 and budget 49152, binned
   with block_tiles 8 (brick-alignment pads present), forward and
   backward, two launches bit-equal; beside each launch's device time,
   one CTA alone on each camera's longest run (the same bits as that row
   of the whole launch).
   2 (v1): the v1 log-space kernels against theirs on the cameras'
   single-level frame at capacity 768, forward and backward, two launches
   bit-equal; per camera the slots the kernels' find keeps (those without
   the -1e30 marker) against the marked ones it skips, and the longest
   row's live count.
   2 (rank_sum): the deterministic row sum of the compositors' backwards
   on each fixture camera's seg backward rows and on rows at the seg main
   path's size: bit for bit the CPU plain version's, two launches
   bit-equal, within the gradient gate of the plain version on the card
   (index_add_ atomics), timed beside that index_add_ alone (events and
   device time, the sort and the sum kernel apart).
   2b: the whole rasterizer on the GPU against the CPU path on a small
   scene, through the seg, two-level and single-level dispatch, the v4
   pair path, the v1 single-level path and the pair-prefix two-level
   path.
3. The seg main path: a synthetic 10-view 800x800 scan trained for 3
   epochs of the ``configs/ABC_DexiNed.json`` recipe through
   ``edgegaussians_tpu_torch.cli.train --backend cuda``, with both seg
   kernels' launch counts held to epochs x views.
   3b: determinism: the same recipe for 2 epochs, its view step 13 run
   twice from the same state (restored in place): the gradients, and the
   parameters, Adam moments and absgrads after the step, bit for bit
   equal.
4. The fallback path: the same scan and recipe for 5 epochs with the pair
   budget cut below epoch 0's pair count and a duplication moved to epoch
   2. Epoch 0 overflows and the run switches to the dense two-level path:
   seg launches = views, dense launches = 2 levels x views x 4 epochs, and
   ``alive`` grows at the duplication.
5. The orientation path: the same scan and recipe for 6 epochs with the
   ratio loss from epoch 1, the direction loss from epoch 2 and an
   applied wayward cull at epoch 3: kNN launches = direction fires + 1,
   segpair launches = epochs x views, ``alive`` falls after the cull. Its
   view step 24 (the 25th render, epoch 2), where the direction and the
   ratio branch both fire, runs twice from the same state as in 3b: the
   projection, direction and ratio gradients, the kNN's indices, and the
   parameters, Adam moments and absgrads after it bit for bit equal; the
   doubled step adds one launch of each seg kernel, the row sum and the
   kNN. The row sum's second job, the backward of the direction loss's
   neighbour gather (``rank_sum_gather``), launches once a direction
   fire, the doubled one's included. On the doubled step's own cotangent
   and kNN indices (16384 x 5 rows of 3 into 16384, most of them the dead
   query rows' zeros) that job is held bit for bit to the step's result,
   a second launch and the CPU plain version of every row, within the
   gradient gate to the card's plain version and to ATen's backward of
   ``x[idx]``, and timed beside them and its bound (the
   ``rank_sum_gather`` entry of the kernels line).
   Then the port's ``cli.fit_edges`` and ``cli.evaluate`` on its output.
6. The other render paths at full width: the same scan and recipe for
   3 epochs each with (a) ``tile_pair_kernel: true`` (the v4 pair path:
   pair launches = epochs x views, no seg launch), (b)
   ``rasterizer_backend: "pallas_v1"``, ``tile_dense_capacity: 0``,
   ``tile_pair_budget: 0`` (the v1 single-level path: v1 launches =
   epochs x views) and (c) ``tile_pair_kernel: false`` with the recipe's
   budget (the pair-prefix two-level path: v2 launches = 2 x epochs x
   views), each with finite losses and its steady-epoch Mpx/s.
7. Multi-rank training (``parallel/``):
   (a) band mode on the card: the 5 fixture cameras at the seg recipe's
   settings split into 4 bands of 13 tile rows (padded height 832); the
   bands' images must be the full render's rows, their partial losses
   (three strategies, bg scores drawn once) sum to the full losses, their
   gradients sum to the full gradients and the norm of their summed sinks
   is the full absgrad; 20 launches of each seg kernel;
   (b) ``step_mode: "view_batch"``, ``view_batch_size: 5``, 3 epochs
   through the CLI with no mesh: seg launches = epochs x views, 2 batch
   steps per epoch;
   (c) several ranks on the one card (``torch.distributed.run``, Gloo on
   the card's tensors) of ``scripts/torch_multiprocess_worker.py``, which
   runs the shard-sum probe (the kernel on each rank's 16384-row shard of
   one array, then an all-reduce) and a probe of which collectives Gloo
   takes on CUDA tensors, then the CLI in the same group with
   ``--mesh_tiles 2``, then ``--mesh_gauss 2``, ``--mesh_views 2``
   (batches of 2) and, on 4 ranks, ``--mesh_views 2 --mesh_tiles 2``, 3
   epochs each with ratio fires and a duplication: all ranks' final
   states bit for bit equal, epoch losses within 2e-3 relative (plus the
   log's last digit) of a single-process run of the same config in this
   call; then ``--mesh_gauss 1`` on one NCCL rank. The shard-sum kernel
   is also held to its plain version on one [16384, 128] shard and timed
   beside it, ``torch.sum`` and the bytes bound, warm (the shard in L2)
   and cold (10 distinct shards, 84 MB, cycled), by events and by the
   device time of calls queued behind a sleeping kernel (their profiler
   device times come in phase 8).

8. The kernel lab (``edgegaussians_tpu_torch/lab/``) at the JAX labs'
   size: 20000 random Gaussians at 800x800, the two-level frame at k1
   128, k2 384, t2 625. First the lab path: its three entry points
   (``scripts/torch_kernel_lab.py``, ``scripts/torch_cumprod_lab.py``,
   ``scripts/torch_segpair_probe.py``) on the card, with their gates
   (V3 against V0, the production ``raster_v2``: image within 1e-5,
   dfeats within 1e-4 of max-abs; ``twolevel`` against ``v3`` within
   1e-5; every probe PASS) and every lab kernel launched. Then each
   chunked-scan kernel (four forward scan forms and the backward) against
   its plain version on level 1 and on level 2 fed level 1's t_out, two
   launches of each bit-equal, timed by events and by the device time of
   calls queued behind a sleeping kernel (``device_ms``), and
   each probe kernel against its plain version and the script's oracle,
   with times beside the bound and, where one PyTorch call computes the
   same function, that call's (and the device times of each probe and
   of its library call from torch.profiler); the onehot probe must
   launch one device kernel a call and take less device time than
   ``onehot @ c``. Last, the host cost of a
   dyn_write and a dyn_read call split into its parts (argument checks,
   allocation, stream lookup, the ctypes call with its launch, the whole
   wrapper), each beside the form it replaced, and the device activities
   per call from the profiler, which must be one kernel (with
   ``--profile_dir``, counted on the host's launch records); the vmem_dyn
   probe's device time over every activity of its calls beside its
   kernel's, and one device kernel a call on both its runs; the roll and
   transpose probes' launch floor (their kernels' device time on the same
   runs at one 16-byte vector each) beside their device time; the shard-sum
   kernel's and torch.sum's device times, warm and cold, and one device
   kernel a shard-sum call. Every torch.profiler window of the run but
   phase 10's trace is in phase 8, after the in-process training runs.

9. The DTU recipe at full width (``configs/DTU.json``): the tracked
   DTU-shaped scan ``synthetic_data/DTU_synth/data/dtu_s0`` (30 views at
   1600x1200, 2498 SfM seeds padded to 20000) through
   ``scripts/torch_scale_run.py`` on the seg path with staged capacity up
   to 131072, pair budget 196608, cap 512, cut in depth only: 52 epochs
   (the duplications at 40 and 50) with the staged start factor lowered
   to 1.0, so that the capacity steps to 131072 inside the cut.
   Launches = epochs x views of each seg kernel and of the row sum, finite
   losses, no pair overflow, and the final checkpoint (written after the
   last growth) resumed through the CLI for one more epoch at its own
   capacity. Then
   phase 2 at the recipes' sizes on that grown state: the seg kernels on
   DTU view 0 (7500 tiles, the 196608-pair budget) under phase 2's gates
   with two launches of each bit-equal; the kNN at k = 6 and 15 on the
   state's 131072 rows, bit for bit the plain version on seeded query
   rows; the row sum of the view's 196608 backward rows, bit for bit the
   CPU plain version; each timed beside its bound and, where one exists,
   the PyTorch call (the ``dtu`` entries of the kernels line).

10. The port's tools beside the trainer, after phase 8 (phase 10's
   sweep trains in-process, and its trace needs no device record):
   (a) ``graft_entry.entry()`` on the card: its 128x128 image within 1e-5
   of the same forward through the plain seg version on the card, one seg
   forward launch, finite and nonzero; (b) ``graft_entry.dryrun_multichip(4,
   "cuda")``: 4 Gloo ranks sharing the card, each exits 0 with every
   check of the JAX dry run's stages held (compositions against the flat
   view batch and the Gaussian-sharded epochs against the tile-sharded
   ones within 1e-4) and has launched the seg kernels, the kNN and the
   row sum in both its jobs; (c) ``cli.make_synthetic`` writes two 10-view 800x800 scans
   and ``cli.sweep --backend cuda`` trains both with the recipe cut to 3
   epochs in this process (launches of each seg kernel and the row sum =
   2 x epochs x views, finite losses, one PLY a scene), then on 2
   torchrun ranks sharing the card into another output directory: rank r
   trains scene r only, each PLY bit for bit the in-process one; (d)
   ``utils/profiling``: ``device_timer`` around 10 fixture seg renders
   (forward and backward) takes at least their CUDA-event time, and
   ``trace`` over one render writes a Chrome trace whose host records
   hold one launch in each seg kernel's span.
11. The harness scripts (``scripts/torch_*.py``), each run as a process
   as a user runs it, its last line read as JSON: (a)
   ``torch_profile_stages.py --fixture`` (800x800, camera 0): every stage
   finite, the seg stages' pair counts those phase 2 bins for camera 0,
   each kernel stage one launch of its kernel a call, each stage's ms,
   device ms and launches printed; (b) ``torch_profile_train_step.py`` at
   the recipe's 16384 capacity: every key of the JAX script finite, the
   kNN component one ``knn`` launch a call and the direction component
   one ``rank_sum_gather``; its ``expected_launches_per_step`` printed
   beside the host launch records of a seg main-path view step (a report);
   (c) ``torch_epoch_ab.py --turns 2`` on a scan made as phase 3's, 6
   epochs a variant: finite losses, ``full`` launches the kNN and
   ``noorient`` does not; (d) ``torch_tp_dtu_bench.py`` at its defaults
   (131072 Gaussians, 1600x1200) in ``--mode ref`` and ``--mode tp --mesh
   1``: the losses within 1e-5 relative, ms a render and peak memory
   printed; (e) ``torch_pair_budget_audit.py`` and
   ``torch_time_to_converge.py`` on that scan, 4 epochs, checkpoints every
   2, 1 extraction seed: the audit's peak the largest ``pairs=`` of its
   log, within the budget, no overflow warning; the eval finds every
   checkpoint, each a row with a finite chamfer or reported without edges
   (at 4 epochs the recipe's opacities have not started to train, so the
   extraction's opacity filter keeps none). The kernels line adds the
   launches of (c)'s and (e)'s training runs as ``launches_harness``.
12. The last nine scripts (``scripts/torch_*.py``), each run as a
   process, its last line read as JSON, (a)-(d) beside (e)-(f): (a)
   ``torch_scatter_lab.py`` at the JAX lab's shapes (20000 Gaussians,
   800x800, K1 128, K2 384, t2 625): every variant A-G within 1e-5 of
   max-abs of A on the masked rows it keeps (E and F drop the valid slots
   past their compaction caps), the row sum (G) one ``rank_sum`` launch a
   call and the same bits on two calls; (b) ``torch_segpair_profile.py
   --variants 0,1,seg --steps 5``: each variant's kernels launched 5
   times (the single-level frame's ``raster_v2`` for ``0``, the v4 pair
   kernels for ``1``, the seg kernels for ``seg``; the row sum in each),
   its op table holding as many kernel records of each, a finite device
   total; (c) ``torch_profile_sharded_trace.py --steps 5``: the seg
   kernels in its table, the loss within 1e-5 relative of the unsharded
   render's; (d) ``torch_pair_kernel_ab.py --epochs 4`` on a scan made as
   phase 3's: ``dense`` launches ``raster_v2`` (two a view step) and no
   pair or seg kernel, ``pairk`` the v4 pair kernels, ``segk`` the seg
   kernels, each epochs x views times; (e) ``torch_scaling_efficiency.py
   --mesh-sizes 1,2 --steps 1 --ranks_on shared``: every mode's rows
   finite; (f) ``torch_dup_spread_ab.py --seeds 1`` and
   ``torch_dp_quality_run.py``, 3 epochs on that scan,
   ``torch_dtu_spread.py --scenes 1 --epochs 2 --views 4 --width 320
   --height 240``, then ``torch_spread_synth.py --skip_fit`` over its
   scene: finite losses, rows with a finite chamfer or reported without
   edges. The kernels line adds the launches of (d)'s and (f)'s training
   runs as ``launches_scripts``.

With ``--full``, last: the whole unmodified ``configs/ABC_DexiNed.json``
(400 epochs) on a 50-view 800x800 synthetic scan made as
``cli/make_synthetic.py --seed 11`` makes SYN01, then fit_edges and
evaluate, printing chamfer and F@5/10/20 (the quality metric of PERF.md
section 2; ROADMAP Queue 3); then the whole 500-epoch DTU recipe on
dtu_s0 through ``scripts/torch_scale_run.py``, fit_edges and evaluate,
beside the JAX package's dtu_s0 audit and DTU-synthetic spread.

With ``--profile_dir``, phases 3 and 4 also trace epoch 2 with
torch.profiler (``cli.train --profile_dir``; the tracing slows those
epochs) and print, per path, the device's busy share of the window, the
kernel launches per view step and the top device kernels;
``scripts/torch_gather_trace.py`` reads the direction loss's gather
backward from phase 5's trace (``<dir>/orient/trace.json``).

The line before the last names the card and its power limit; before it, a
JSON object lists each kernel's launches on its path, error, times and
bound. The last line is ``{"ok": true, "device": {...}}``. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the lab's timing and t_out comparison, shared with its entry points
from edgegaussians_tpu_torch.lab.harness import (EPS_T, cuda_ms, log,
                                                 t_out_rel)

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.join(REPO, "scripts"))
# the harness scripts' kernel counters and device timing, shared here
from torch_common import (  # noqa: E402
    KERNEL_SYMBOLS, PROFILED_WINDOWS, kernel_counts, kernel_modules,
    op_count, profiled, queued_ms, reset_kernel_counts, torchrun,
    window_counts)
FIXTURE = os.path.join(REPO, "bench_fixture", "abc_00004926.npz")
RECIPE = os.path.join(REPO, "configs", "ABC_DexiNed.json")
KERNEL_LIBS = ("segpair", "raster_v2", "knn", "pair", "raster_v1",
               "rank_sum", "shard_sum", "lab_chunked", "lab_probes")
EPOCHS = 3
VIEWS = 10
FALLBACK_EPOCHS = 5
FALLBACK_BUDGET = 2048      # below epoch 0's ~6.2k pairs per view
DUP_EPOCH = 2
K1, K2, T2 = 128, 640, 128  # the recipe's two-level settings
CAP, BUDGET = 768, 49152    # the recipe's per-tile cap and pair budget
PAIR_BLOCK_TILES = 8        # the v4 tables' block (the JAX TILE_BLOCK)
# phase 6: the recipe's model settings of each other render path
OTHER_PATHS = {
    "pair_v4": dict(tile_pair_kernel=True),
    "single_v1": dict(rasterizer_backend="pallas_v1", tile_dense_capacity=0,
                      tile_pair_budget=0),
    "pair_prefix": dict(tile_pair_kernel=False),
}
KNN_CAPACITY = 16384        # the ABC recipe's max_num_gaussians
KNN_KS = (6, 11, 15)        # ABC direction fetch, Replica's, wayward cull
# the DTU / Replica capacity: a cloud uniform in the unit box, every other
# row live, k = 6 (their direction-loss fetch); the plain version on a
# seeded sample of query rows; cdist + topk over chunks of query rows
KNN_BIG, KNN_BIG_K, KNN_BIG_SAMPLE, KNN_BIG_CHUNK = 131072, 6, 2048, 8192
# the seg kernels' chain, timed on runs of broad pairs of alpha
# SEG_CHAIN_ALPHA that every pixel walks to the end (0.995^768 > 1e-4):
# one CTA at the shorter and longer length gives the time a pair adds;
# the longer at 1, 2 and 4 CTAs an SM shows whether CTAs sharing an SM
# slow each other. Queued behind a sleeping kernel (queued_ms: ~20 ms), so
# the host's ~20 us a launch hides.
SEG_CHAIN_PAIRS = (64, 768)
SEG_CHAIN_ALPHA = 0.005
SEG_CHAIN_CTAS_PER_SM = (1, 2, 4)
ORIENT_EPOCHS = 6
ORIENT_CUTS = dict(start_ratio_loss_at_epoch=0, start_dir_loss_at_epoch=1)
WAYWARD_EPOCH = 3
FULL_VIEWS = 50
# phase 3b: the main path cut to DET_EPOCHS epochs, its view step at
# DET_STEP renders (epoch 1) run twice from the same state
DET_EPOCHS = 2
DET_STEP = VIEWS + 3
# phase 5: its view step at ORIENT_DET_STEP renders, the 5th render of the
# first epoch past start_dir_loss_at_epoch, where the direction and the
# ratio branch both fire, run twice from the same state
ORIENT_DET_STEP = (ORIENT_CUTS["start_dir_loss_at_epoch"] + 1) * VIEWS + 4
# phase 2 (rank_sum) at the seg main path's size: the recipe's pair budget
# and capacity, ~6.2k valid pairs over the 2500 Gaussians of its seed
MAIN_PAIRS, MAIN_GAUSSIANS = 6200, 2500
# forward image: both sides take the same f32 steps per pixel; only the
# order of the log-alpha sum (FMA chain vs matmul) and of the
# transmittance products (sequential vs cumprod scan) differ
IMG_ATOL = 1e-5
# dfeats / dpacked / absgrad, relative to the plain version's max-abs: the
# per-slot sums over 256 pixels are 3xTF32 tensor-core products vs an f32
# matmul, and the rows reach [N,8] through the row-sum kernel (in row
# order) on one side and the plain version's index_add_ atomics (in
# another order on every run) on the other
GRAD_RTOL_OF_MAX = 1e-4
# the H100 SXM's published peaks from NVIDIA's data sheet: HBM bytes/s
# and f32 FLOP/s outside the tensor cores; the special-function units
# give 16 results per SM per clock against 128 f32 FMA lanes, so expf and
# the reciprocal run at F32_FLOPS / 2 / 8 per second
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SFU_OPS = F32_FLOPS / 16
# per (slot, pixel) evaluation: log alpha 1 mul + 5 FMA (11 flops), guard,
# threshold, clamp, 1 - a, t * (1 - a), a * t, the sum (5) and one expf;
# the backward adds a * gt / (1 - a) (a reciprocal) and the six products
# and six sums of the per-slot reduction
FWD_OPS = (16, 1)           # (flops, special-function ops)
BWD_OPS = (29, 2)
# the v1 kernels add log1p(-a) and exp(lt - log1p(-a)) per evaluation
V1_FWD_OPS = (16, 3)
V1_BWD_OPS = (29, 4)
# per (query, live key) of the kNN: 3 subs, 3 muls, 2 adds, the dead-key add
KNN_OPS = (9, 0)
# the kNN's instruction floor: those operations cannot contract into FMAs,
# so with the compare each pair issues ~10 lane-instructions, at 132 SMs x
# 128 lanes x 1.98 GHz (the H100 SXM's top SM clock)
KNN_LANE_INSTR = 10
LANE_INSTR_PER_S = 132 * 128 * 1.98e9
# phase 7: 4 bands of cdiv(50, 4) = 13 tile rows; view batches of 5;
# the multi-rank runs' cuts (ratio loss fires from epoch 1, a
# duplication of the top 5% by absgrad after epoch 1)
BANDS = 4
VIEW_BATCH = 5
MULTI_ORIENT = dict(start_ratio_loss_at_epoch=0)
MULTI_MODEL = dict(dup_high_pos_grads_at_epoch=[1],
                   dup_threshold_type="top_fraction",
                   dup_threshold_value=0.05)
MULTI_BATCH = 2             # view batches of the --mesh_views 2 run
MULTI_LOSS_RTOL = 2e-3      # epoch losses, multi-rank vs one process
WORKER = os.path.join(REPO, "scripts", "torch_multiprocess_worker.py")
SHARD_ROWS = 16384          # rows of the probe's shard per rank
# distinct shards cycled for L2-cold shard-sum calls: 84 MB against the
# card's 50 MB of L2, so each call's shard was evicted since its last read
COLD_SHARDS = 10
# phase 8: the lab's entry points; the logsum form's tolerance (a sum of
# logs in another order than the plain version's cumsum, then exp, where
# the other forms multiply the same factors)
# phase 9: configs/DTU.json on the tracked dtu_s0 scan, cut in depth to
# DTU_EPOCHS epochs (its first two duplications, at 40 and 50, and one
# epoch after them), with the staged start at 32768 rows (start factor
# 1.0 for its 22482 padded seeds), so that the capacity steps 32768 ->
# 65536 -> 131072 inside the cut. Duplications moved to the first epochs
# select a third of the Gaussians each and overflow the pair budget by
# the fourth (327649 pairs of 196608 on the card); the recipe's own
# epochs do not. The kNN at its k of the direction fetch (6) and of
# Replica's wayward cull (15)
DTU_RECIPE = os.path.join(REPO, "configs", "DTU.json")
DTU_EPOCHS = 52
DTU_START_FACTOR = 1.0
DTU_KNN_KS = (6, 15)
LAB_SCRIPTS = ("torch_kernel_lab", "torch_cumprod_lab",
               "torch_segpair_probe")
LOGSUM_TOL = 5e-5
HOST_CALLS = 2000           # calls per part of phase 8's host-cost split
FLOOR_PROBES = ("roll", "transpose")   # phase 8: timed at their launch floor
# phase 10: the dry run's ranks (the port's tests run 4 too); the fixture
# seg renders device_timer times
DRYRUN_RANKS = 4
PROFILED_RENDERS = 10
# phase 11: the harness scripts (scripts/torch_*.py) as a user runs them,
# each a process; the epoch A/B's turns and depth, the audit's depth, the
# time-to-converge's depth and checkpoint interval (the recipe trains
# opacities from epoch 20, and extraction keeps only those over 0.2: on
# this scan it first finds edges at epoch 49), the view steps whose host
# launch records are counted beside profile_train_step's figure
HARNESS_TIMEOUT = 600
HARNESS_REPS = 5            # calls a timing block of (a) and (b)
AB_TURNS, AB_EPOCHS = 2, 6
AUDIT_EPOCHS = 4
TTC_EPOCHS, TTC_INTERVAL = 100, 50
COUNTED_STEPS = 10
# phase 12: the last nine scripts as a user runs them; the per-op traces'
# steps, the pair-kernel A/B's and the spreads' depths, the DTU spread's
# cut scene, and what each traced variant launches a step
SCRIPT_STEPS = 5
PKA_EPOCHS = 4
SPREAD_EPOCHS = 3
DTU_SPREAD = dict(scenes=1, epochs=2, views=4, width=320, height=240)
SCATTER_TOL = 1e-5          # each variant against A, of A's max-abs
PROFILE_KERNELS = {
    "0": {"raster_v2_fwd": 1, "raster_v2_bwd": 1, "rank_sum": 1},
    "1": {"pair_fwd": 1, "pair_bwd": 1, "rank_sum": 1},
    "seg": {"segpair_fwd": 1, "segpair_bwd": 1, "rank_sum": 1}}
# the pair-kernel A/B's variants: the kernels each launches and those it
# must not
PKA_KERNELS = {"dense": (("raster_v2_fwd", "raster_v2_bwd"),
                         ("pair_fwd", "segpair_fwd")),
               "pairk": (("pair_fwd", "pair_bwd"),
                         ("segpair_fwd", "raster_v2_fwd")),
               "segk": (("segpair_fwd", "segpair_bwd"),
                        ("pair_fwd", "raster_v2_fwd"))}
# the JAX profile_train_step.py's keys (:98-149)
TRAIN_STEP_KEYS = ("proj_grad_ms", "proj_grad_bg_ratio_ms", "adam_ms",
                   "knn_ms", "dir_loss_ms", "ratio_loss_ms", "geo_adam_ms",
                   "every5_total_ms", "expected_step_ms",
                   "expected_in_train_mpx_s")


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr}")
    return proc.stdout.strip()


def bound_ms(nbytes: float, evals: float, ops) -> tuple:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over their peak rate, in ms, with
    what bounds it."""
    flops, sfu = ops
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(evals * flops / F32_FLOPS, evals * sfu / SFU_OPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_environment():
    from edgegaussians_tpu_torch.ops import _build
    log("== phase 1: environment and build")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    log("tensorboardX: " + ("importable" if importlib.util.find_spec(
        "tensorboardX") else "not installed")
        + "; the smoke's training runs write no TensorBoard logs")
    # the trainer's view-0 render every 5th epoch would add seg forward
    # launches and time to every path's counts and epochs
    sys.modules["tensorboardX"] = None
    log(run([_build.nvcc_path(), "--version"]).splitlines()[-1])
    log(f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the plain versions would "
                           "not be full f32")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    log(card)

    def timed_build(name):
        t0 = time.time()
        return _build.build(name), time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        built = dict(zip(KERNEL_LIBS, pool.map(timed_build, KERNEL_LIBS)))
    for name, (lib, secs) in built.items():
        _build.load(name)
        log(f"built {os.path.relpath(lib, REPO)} in {secs:.1f}s")
        log(open(str(lib) + ".log").read().strip())
    log(f"all kernels built in {time.time() - t0:.1f}s")
    return card


def fixture_cameras(device):
    """Per camera of the fixture: (projection, packed rows); plus the
    image size and the Gaussian count."""
    from edgegaussians_tpu_torch.ops import tiles
    from edgegaussians_tpu_torch.ops.projection import project_gaussians
    d = np.load(FIXTURE)
    w, h = int(d["width"]), int(d["height"])
    args = [torch.from_numpy(d[k]).to(device)
            for k in ("means", "quats", "scales")]
    opac = torch.from_numpy(d["opacities"]).reshape(-1).to(device)
    out = []
    with torch.no_grad():
        for c in range(d["viewmats"].shape[0]):
            vm = torch.from_numpy(d["viewmats"][c]).to(device)
            K = torch.from_numpy(d["Ks"][c]).to(device)
            proj = project_gaussians(*args, opac, vm, K, w, h)
            out.append((proj, tiles.pack_gaussian_render_data(proj)))
    return out, w, h, opac.shape[0]


def seg_case(proj, packed, w: int, h: int, cap: int, budget: int,
             max_tiles: int, gen, device) -> dict:
    """One camera's seg compositor inputs: its projection binned at
    ``cap`` / ``budget`` / ``max_tiles``, and seeded [T,256] cotangents."""
    from edgegaussians_tpu_torch.ops import segpair, tiles
    n = packed.shape[0]
    origins = tiles.tile_origins(w, h, 16, device=device)
    with torch.no_grad():
        pbins = tiles.bin_pairs_frame_order(
            proj, w, h, 16, min(cap, n), budget,
            max_tiles_per_gaussian=max_tiles)
        src, ox, oy = segpair.pair_inputs(packed[pbins.order], pbins,
                                          origins)
        feats = segpair.build_pair_features(src, ox, oy).contiguous()
        T = pbins.counts_f.shape[0]
        g = torch.rand((T, 256), generator=gen, device=device)
    return dict(pbins=pbins, src=src, ox=ox, oy=oy, feats=feats,
                s_f=pbins.s_f.to(torch.int32), g=g, n=n)


def seg_cases(device):
    """Per camera: the seg compositor's inputs at the main path's shapes."""
    from edgegaussians_tpu_torch.ops import tiles
    cams, w, h, _ = fixture_cameras(device)
    gen = torch.Generator(device=device).manual_seed(0)
    cases = [seg_case(proj, packed, w, h, 768, 49152, 16, gen, device)
             for proj, packed in cams]
    return cases, tiles.pixel_basis(16, device=device)


def seg_work(cs, basis):
    """(fwd bytes, bwd bytes, evaluations) one camera's seg kernels need:
    the kept pairs' features, run table, basis and [T,256] planes read
    once, outputs written once; a pixel evaluates a pair while its
    transmittance before the pair is >= 1e-4."""
    from edgegaussians_tpu_torch.ops import segpair
    _, _, t_inc, _, _, slot_valid = segpair._padded_alpha(
        cs["feats"], cs["s_f"], basis)
    t_before = torch.cat([torch.ones_like(t_inc[:, :1]), t_inc[:, :-1]], 1)
    evals = int(((t_before >= EPS_T) & slot_valid[..., None]).sum())
    T = cs["s_f"].shape[0] - 1
    kept = int(cs["s_f"][-1])
    common = kept * 32 + (T + 1) * 4 + basis.numel() * 4 + T * 256 * 4
    return common, common + kept * 32, evals


def rel_err(a, b, what: str) -> float:
    """Max-abs error of ``a`` against ``b`` relative to ``b``'s max-abs,
    held to GRAD_RTOL_OF_MAX."""
    scale = b.abs().max().item()
    rel = (a - b).abs().max().item() / max(scale, 1e-30)
    if not math.isfinite(rel) or rel > GRAD_RTOL_OF_MAX:
        raise AssertionError(f"{what} error {rel:.3g} of max-abs")
    return rel


def check_image(e_img: float, what: str, atol: float = IMG_ATOL) -> None:
    if not math.isfinite(e_img) or e_img > atol:
        raise AssertionError(f"{what}: image error {e_img:.3g} > {atol}")


def time_kernels(calls, n_cases: int, bounds):
    """(kernel ms, plain ms, library ms: None, kernel device ms) per
    camera for each entry of ``calls``. The kernel's and the plain
    version's ms are CUDA events over back-to-back calls; the kernel's
    device ms is its calls queued behind a sleeping kernel (queued_ms),
    which the wrapper's host work (~20 us a call) does not pace."""
    ms = {}
    with torch.no_grad():
        for name, (kern, plain) in calls.items():
            # per camera: one call of each over the cameras per rep
            ms[name] = (cuda_ms(kern, 20) / n_cases,
                        cuda_ms(plain, 2) / n_cases, None,
                        queued_ms(kern, 20) / n_cases)
            log(f"{name}: kernel {ms[name][0]:.4f} ms (device "
                f"{ms[name][3]:.4f} ms), plain {ms[name][1]:.4f} ms, "
                f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) per "
                "camera")
    fwd, bwd = calls
    log(f"fwd+bwd per camera: kernel {ms[fwd][0] + ms[bwd][0]:.4f} ms "
        f"(device {ms[fwd][3] + ms[bwd][3]:.4f} ms), plain "
        f"{ms[fwd][1] + ms[bwd][1]:.4f} ms")
    return ms


def chain_case(n_tiles: int, pairs: int, device):
    """(feats, s_f, gt) of ``n_tiles`` frame rows, each one run of
    ``pairs`` broad pairs of alpha ~SEG_CHAIN_ALPHA on every pixel, so
    that no pixel stops early."""
    from edgegaussians_tpu_torch.ops import segpair
    b = n_tiles * pairs
    src = torch.zeros((b, 8), device=device)
    src[:, 0] = src[:, 2] = 1e-6
    src[:, 3:5] = 7.5
    src[:, 5] = math.log(SEG_CHAIN_ALPHA)
    zero = torch.zeros(b, device=device)
    feats = segpair.build_pair_features(src, zero, zero).contiguous()
    s_f = torch.arange(0, b + 1, pairs, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    gt = torch.rand((n_tiles, 256), generator=gen, device=device)
    return feats, s_f, gt


def longest_runs(cases, device):
    """Per fixture camera, its longest run alone as one frame row: (feats,
    s_f, gt) of its own pairs and cotangent row."""
    out = []
    for cs in cases:
        fr = int(cs["pbins"].counts_f.argmax())
        a, b = (int(x) for x in cs["s_f"][fr:fr + 2])
        out.append((cs["feats"][a:b].contiguous(),
                    torch.tensor([0, b - a], dtype=torch.int32,
                                 device=device),
                    cs["gt"][fr:fr + 1].contiguous()))
    return out


def own_run_ms(kernel: str, runs, basis) -> list:
    """Device ms of one CTA alone on each of ``runs`` (longest_runs), the
    seg ``kernel`` ("fwd" or "bwd"), through queued_ms."""
    from edgegaussians_tpu_torch.ops import segpair
    if kernel == "fwd":
        return [queued_ms(lambda: segpair.segpair_fwd(f, s, basis), 20)
                for f, s, _ in runs]
    return [queued_ms(lambda: segpair.segpair_bwd(f, s, basis, g), 20)
            for f, s, g in runs]


def phase_seg_chain(device, cases, basis, fixture_ms: dict) -> None:
    """The seg kernels' chain timed, one CTA alone: both kernels on each
    camera's longest run (its own pairs), beside the launch's time per
    camera, and on faint runs of SEG_CHAIN_PAIRS (the time a pair adds);
    the backward on faint runs of the fixture's longest lengths, and its
    longer faint runs at SEG_CHAIN_CTAS_PER_SM CTAs an SM."""
    from edgegaussians_tpu_torch.ops import segpair
    lo, hi = SEG_CHAIN_PAIRS
    runs = [int(cs["pbins"].counts_f.max()) for cs in cases]
    with torch.no_grad():
        feats, s_f, gt = chain_case(1, hi, device)
        rel_err(segpair.segpair_bwd(feats, s_f, basis, gt),
                segpair.segpair_bwd_ref(feats, s_f, basis, gt),
                f"chain run of {hi} pairs: dfeats")
        check_image((segpair.segpair_fwd(feats, s_f, basis)
                     - segpair.segpair_fwd_ref(feats, s_f, basis))
                    .abs().max().item(), f"chain run of {hi} pairs")

        def timed(kernel: str, n_tiles: int, pairs: int) -> float:
            feats, s_f, gt = chain_case(n_tiles, pairs, device)
            if kernel == "fwd":
                return queued_ms(
                    lambda: segpair.segpair_fwd(feats, s_f, basis), 20)
            return queued_ms(
                lambda: segpair.segpair_bwd(feats, s_f, basis, gt), 20)

        longest = longest_runs(cases, device)
        for f, s, _ in longest:
            check_image((segpair.segpair_fwd(f, s, basis)
                         - segpair.segpair_fwd_ref(f, s, basis))
                        .abs().max().item(), f"longest run of {f.shape[0]}")
        own = {k: own_run_ms(k, longest, basis) for k in ("fwd", "bwd")}
        alone = {p: timed("bwd", 1, p) for p in sorted({lo, hi, *runs})}
        fwd = {p: timed("fwd", 1, p) for p in (lo, hi)}
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        shared = {c: timed("bwd", c * sms, hi) for c in SEG_CHAIN_CTAS_PER_SM}
    sm_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"]).splitlines()[0])

    def per_pair(t: dict) -> str:
        ns = (t[hi] - t[lo]) / (hi - lo) * 1e6
        return f"a pair adds {ns:.1f} ns, {ns * sm_mhz * 1e-3:.0f} cycles " \
               f"at {sm_mhz:.0f} MHz"

    log("segpair_bwd one CTA alone on a faint run: "
        + ", ".join(f"{p} pairs {t:.4f} ms" for p, t in alone.items())
        + f"; {per_pair(alone)}")
    log("segpair_fwd one CTA alone on a faint run: "
        + ", ".join(f"{p} pairs {t:.4f} ms" for p, t in fwd.items())
        + f"; {per_pair(fwd)}")
    log(f"segpair_bwd faint runs of {hi} pairs on {sms} SMs: "
        + ", ".join(f"{c} CTA(s) an SM {t:.4f} ms ({t / shared[1]:.2f}x)"
                    for c, t in shared.items()))
    for k in ("fwd", "bwd"):
        ms = fixture_ms[f"segpair_{k}"]
        log(f"segpair_{k} {ms:.4f} ms per camera beside one CTA alone on "
            f"each camera's longest run {runs}: its own pairs "
            + ", ".join(f"{t:.4f}" for t in own[k]) + " ms (x"
            + ", x".join(f"{t / ms:.2f}" for t in own[k])
            + f" of the launch; mean x{np.mean(own[k]) / ms:.2f})"
            + ("; faint pairs " + ", ".join(f"{alone[r]:.4f}" for r in runs)
               + " ms" if k == "bwd" else ""))


def phase_kernels(device):
    from edgegaussians_tpu_torch.ops import segpair
    log("== phase 2: seg kernels vs plain versions, fixture at 800x800")
    cases, basis = seg_cases(device)
    err = {"segpair_fwd": 0.0, "segpair_bwd": 0.0}
    work = np.zeros(3)
    for c, cs in enumerate(cases):
        pb = cs["pbins"]
        with torch.no_grad():
            img_k = segpair.segpair_fwd(cs["feats"], cs["s_f"], basis)
            img_r = segpair.segpair_fwd_ref(cs["feats"], cs["s_f"], basis)
            # both backwards take the same cotangent, folded with the
            # plain image, so the comparison isolates the kernel
            gt = (cs["g"] * (1.0 - img_r)).contiguous()
            dfe_k = segpair.segpair_bwd(cs["feats"], cs["s_f"], basis, gt)
            dfe_r = segpair.segpair_bwd_ref(cs["feats"], cs["s_f"], basis,
                                            gt)
            torch.cuda.synchronize()
            valid = pb.pair_valid[:, None]
            dfe_k = torch.where(valid, dfe_k, torch.zeros_like(dfe_k))
            out_k = segpair.pair_grads_to_packed(dfe_k, cs["src"], cs["ox"],
                                                 cs["oy"], pb, cs["n"])
            out_r = segpair.pair_grads_to_packed(dfe_r, cs["src"], cs["ox"],
                                                 cs["oy"], pb, cs["n"])
            work += seg_work(cs, basis)
        e_img = (img_k - img_r).abs().max().item()
        e_dfe = (dfe_k - dfe_r).abs().max().item()
        err["segpair_fwd"] = max(err["segpair_fwd"], e_img)
        err["segpair_bwd"] = max(err["segpair_bwd"], e_dfe)
        rel = [rel_err(a, b, f"camera {c}: {name}")
               for name, a, b in zip(("dfeats", "dpacked", "absgrad"),
                                     (dfe_k, *out_k), (dfe_r, *out_r))]
        log(f"camera {c}: pairs={int(pb.num_pairs)}/49152 "
            f"kept={int(pb.s_f[-1])} max_run={int(pb.counts_f.max())} "
            f"img_err={e_img:.3g} dfeats_err={e_dfe:.3g} "
            f"dfeats_rel={rel[0]:.3g} dpacked_rel={rel[1]:.3g} "
            f"absgrad_rel={rel[2]:.3g}")
        check_image(e_img, f"camera {c}")

    def over_cases(fn):
        return lambda: [fn(cs) for cs in cases]

    for cs in cases:
        cs["gt"] = (cs["g"] * 0.5).contiguous()
    calls = {
        "segpair_fwd": (
            over_cases(lambda cs: segpair.segpair_fwd(
                cs["feats"], cs["s_f"], basis)),
            over_cases(lambda cs: segpair.segpair_fwd_ref(
                cs["feats"], cs["s_f"], basis))),
        "segpair_bwd": (
            over_cases(lambda cs: segpair.segpair_bwd(
                cs["feats"], cs["s_f"], basis, cs["gt"])),
            over_cases(lambda cs: segpair.segpair_bwd_ref(
                cs["feats"], cs["s_f"], basis, cs["gt"]))),
    }
    per_cam = work / len(cases)
    bounds = {"segpair_fwd": bound_ms(per_cam[0], per_cam[2], FWD_OPS),
              "segpair_bwd": bound_ms(per_cam[1], per_cam[2], BWD_OPS)}
    log(f"per camera: {per_cam[2]:.0f} pair-pixel evaluations, "
        f"{per_cam[0] / 1e6:.2f} MB (fwd) / {per_cam[1] / 1e6:.2f} MB (bwd)")
    ms = time_kernels(calls, len(cases), bounds)
    with torch.no_grad():
        twice = [segpair.segpair_fwd(cases[0]["feats"], cases[0]["s_f"], basis)
                 for _ in range(2)]
    if not torch.equal(*twice):
        raise AssertionError("segpair_fwd: two launches on the same inputs "
                             "differ")
    log("segpair_fwd: two launches on camera 0 bit-equal")
    phase_seg_chain(device, cases, basis,
                    {k: v[0] for k, v in ms.items()})
    return err, ms, bounds


def dense_cases(device):
    """Per camera: both levels' compositor inputs at the recipe's
    two-level settings (the dense path the 'fallback' action runs)."""
    from edgegaussians_tpu_torch.ops import composite, tiles
    cams, w, h, n = fixture_cameras(device)
    origins = tiles.tile_origins(w, h, 16, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    cases = []
    with torch.no_grad():
        for proj, packed in cams:
            bins2 = tiles.bin_gaussians_two_level(
                proj, w, h, 16, K1, K2, T2, max_tiles_per_gaussian=16,
                occupancy_sort=True)
            origins_f = origins[bins2.tile_perm]
            fr = composite.two_level_frame(packed[bins2.order], bins2,
                                           origins_f)
            g = torch.rand((origins.shape[0], 256), generator=gen,
                           device=device)
            cases.append(dict(bins2=bins2, fr=fr, origins_f=origins_f, g=g,
                              n=n))
    return cases


def dense_work(feats, counts, basis, t_in):
    """(fwd bytes, bwd bytes, evaluations) one level's dense kernels need:
    the live slots' features, counts, basis and [T,256] planes read once,
    outputs written once (the backward's whole [T,K,8] dfeats); a pixel
    evaluates a live slot while its transmittance before it is >= 1e-4."""
    from edgegaussians_tpu_torch.ops import raster_v2
    T, K, _ = feats.shape
    t0 = torch.ones((T, 256), device=feats.device) if t_in is None else t_in
    evals = 0
    for r0, r1 in raster_v2._row_chunks(T, K):
        _, _, t_inc = raster_v2._chunk_alpha(feats[r0:r1], counts[r0:r1],
                                             basis, t0[r0:r1])
        t_before = torch.cat([t0[r0:r1, None], t_inc[:, :-1]], 1)
        live = (torch.arange(K, device=feats.device)[None, :]
                < counts[r0:r1, None])
        evals += int(((t_before >= EPS_T) & live[..., None]).sum())
    live_slots = int(torch.clamp(counts, max=K).sum())
    plane = T * 256 * 4
    common = (live_slots * 32 + T * 4 + basis.numel() * 4
              + (0 if t_in is None else plane))
    return common + 2 * plane, common + plane + T * K * 32, evals


def check_t_out(t_k, t_r, what: str, rtol: float = 1e-5) -> float:
    """Kernel t_out against the plain version's: relative error where the
    plain value is >= 1e-4; below it the value depends on where the walk
    stopped, so only that both are below 1e-4."""
    rel = t_out_rel(t_k, t_r)
    if not rel <= rtol:
        raise AssertionError(f"{what}: t_out disagrees ({rel:.3g})")
    return rel


def phase_dense_kernels(device):
    from edgegaussians_tpu_torch.ops import composite, raster_v2, tiles
    log(f"== phase 2 (dense): two-level kernels vs plain versions, fixture "
        f"at 800x800, k1={K1} k2={K2} t2={T2}, occupancy sort")
    cases = dense_cases(device)
    basis = tiles.pixel_basis(16, device=device)
    err = {"raster_v2_fwd": 0.0, "raster_v2_bwd": 0.0}
    work = np.zeros(3)
    for c, cs in enumerate(cases):
        fr, bins2, g = cs["fr"], cs["bins2"], cs["g"]
        with torch.no_grad():
            img1_k, tout1_k = raster_v2.composite_fwd_seg(
                fr.feats1, fr.counts1, basis)
            img1_r, tout1_r = raster_v2.composite_fwd_seg_ref(
                fr.feats1, fr.counts1, basis)
            # level 2 of both versions starts from the plain level 1's
            # t_out, so each comparison isolates one kernel launch
            tin2 = composite.ovf_take(tout1_r, bins2).contiguous()
            img2_k, tout2_k = raster_v2.composite_fwd_seg(
                fr.feats2, fr.counts2, basis, tin2)
            img2_r, tout2_r = raster_v2.composite_fwd_seg_ref(
                fr.feats2, fr.counts2, basis, tin2)
            images = composite.ovf_add(img1_r, img2_r, bins2)
            g2 = composite.ovf_take(g, bins2).contiguous()
            tot2 = composite.ovf_take(images, bins2).contiguous()
            d1_k = raster_v2.composite_bwd_seg(fr.feats1, fr.counts1, basis,
                                               g, None, images)
            d1_r = raster_v2.composite_bwd_seg_ref(fr.feats1, fr.counts1,
                                                   basis, g, None, images)
            d2_k = raster_v2.composite_bwd_seg(fr.feats2, fr.counts2, basis,
                                               g2, tin2, tot2)
            d2_r = raster_v2.composite_bwd_seg_ref(fr.feats2, fr.counts2,
                                                   basis, g2, tin2, tot2)
            torch.cuda.synchronize()
            outs = []
            for d1, d2 in ((d1_k, d2_k), (d1_r, d2_r)):
                dg1 = composite.tile_features_vjp(fr.g1, cs["origins_f"],
                                                  fr.validf1, d1)
                dg2 = composite.tile_features_vjp(fr.g2, fr.origins2,
                                                  fr.validf2, d2)
                outs.append(composite.scatter_slot_grads(
                    [(dg1, fr.validf1, bins2.ranks1),
                     (dg2, fr.validf2, bins2.ranks2)], bins2.order,
                    cs["n"]))
            work += dense_work(fr.feats1, fr.counts1, basis, None)
            work += dense_work(fr.feats2, fr.counts2, basis, tin2)
        e_img = max((img1_k - img1_r).abs().max().item(),
                    (img2_k - img2_r).abs().max().item())
        e_tout = max(check_t_out(tout1_k, tout1_r, f"camera {c} level 1"),
                     check_t_out(tout2_k, tout2_r, f"camera {c} level 2"))
        e_dfe = max((d1_k - d1_r).abs().max().item(),
                    (d2_k - d2_r).abs().max().item())
        err["raster_v2_fwd"] = max(err["raster_v2_fwd"], e_img)
        err["raster_v2_bwd"] = max(err["raster_v2_bwd"], e_dfe)
        rel = [rel_err(d1_k, d1_r, f"camera {c}: dfeats level 1"),
               rel_err(d2_k, d2_r, f"camera {c}: dfeats level 2")]
        rel += [rel_err(a, b, f"camera {c}: {name}") for name, a, b in
                zip(("dpacked", "absgrad"), outs[0], outs[1])]
        log(f"camera {c}: pairs={int(bins2.num_pairs)} "
            f"live1={int(fr.counts1.sum())} live2={int(fr.counts2.sum())} "
            f"max_count={int(bins2.counts.max())} img_err={e_img:.3g} "
            f"t_out_rel={e_tout:.3g} dfeats_err={e_dfe:.3g} "
            f"dfeats_rel={max(rel[:2]):.3g} dpacked_rel={rel[2]:.3g} "
            f"absgrad_rel={rel[3]:.3g}")
        check_image(e_img, f"camera {c}")

    dense_timing_inputs(cases, basis)

    def over_levels(kernel: str, plain=False, levels=(1, 2)):
        return lambda: [dense_call(kernel, dense_level_args(cs, lv), basis,
                                   plain)
                        for cs in cases for lv in levels]

    calls = {f"raster_v2_{k}": (over_levels(k), over_levels(k, plain=True))
             for k in ("fwd", "bwd")}
    per_cam = work / len(cases)
    bounds = {"raster_v2_fwd": bound_ms(per_cam[0], per_cam[2], FWD_OPS),
              "raster_v2_bwd": bound_ms(per_cam[1], per_cam[2], BWD_OPS)}
    log(f"per camera, both levels: {per_cam[2]:.0f} slot-pixel "
        f"evaluations, {per_cam[0] / 1e6:.2f} MB (fwd) / "
        f"{per_cam[1] / 1e6:.2f} MB (bwd)")
    ms = time_kernels(calls, len(cases), bounds)
    with torch.no_grad():
        level_ms = {(k, lv): queued_ms(over_levels(k, levels=(lv,)), 20)
                    / len(cases) for k in ("fwd", "bwd") for lv in (1, 2)}
        for lv in (1, 2):
            args = dense_level_args(cases[0], lv)
            for k in ("fwd", "bwd"):
                twice = [as_tuple(dense_call(k, args, basis))
                         for _ in range(2)]
                if not all(map(torch.equal, *twice)):
                    raise AssertionError(f"raster_v2_{k} level {lv}: two "
                                         "launches on the same inputs "
                                         "differ")
    log("raster_v2_fwd, raster_v2_bwd: two launches on camera 0 bit-equal "
        "at both levels")
    phase_dense_chain(device, cases, basis, level_ms)
    return err, ms, bounds


def dense_timing_inputs(cases, basis) -> None:
    """Each camera's timing inputs beside its frame: level 2's t_in from
    the plain level 1's t_out (every tree and kernel times the same
    inputs), a total, and the level-2 rows of g and of the total."""
    from edgegaussians_tpu_torch.ops import composite, raster_v2
    for cs in cases:
        fr, bins2 = cs["fr"], cs["bins2"]
        with torch.no_grad():
            img1, tout1 = raster_v2.composite_fwd_seg_ref(
                fr.feats1, fr.counts1, basis)
        cs["tin2"] = composite.ovf_take(tout1, bins2).contiguous()
        cs["total"] = (0.5 + 0.5 * img1).contiguous()
        cs["g2"] = composite.ovf_take(cs["g"], bins2).contiguous()
        cs["total2"] = composite.ovf_take(cs["total"], bins2).contiguous()


def dense_level_args(cs, level: int) -> tuple:
    """(feats, counts, t_in, g, total) of one camera's ``level`` (1 or 2),
    after dense_timing_inputs."""
    fr = cs["fr"]
    if level == 1:
        return fr.feats1, fr.counts1, None, cs["g"], cs["total"]
    return fr.feats2, fr.counts2, cs["tin2"], cs["g2"], cs["total2"]


def dense_call(kernel: str, args, basis, plain: bool = False):
    """The dense ``kernel`` ("fwd" or "bwd") on ``args`` (as
    dense_level_args): the kernel's wrapper, or its plain version."""
    from edgegaussians_tpu_torch.ops import raster_v2
    feats, counts, t_in, g, total = args
    if kernel == "fwd":
        fn = (raster_v2.composite_fwd_seg_ref if plain
              else raster_v2.composite_fwd_seg)
        return fn(feats, counts, basis, t_in)
    fn = raster_v2.composite_bwd_seg_ref if plain else \
        raster_v2.composite_bwd_seg
    return fn(feats, counts, basis, g, t_in, total)


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def check_dense(args, basis, what: str) -> None:
    """Both dense kernels on ``args`` against their plain versions: image,
    t_out and dfeats under phase 2's gates."""
    img_k, tout_k = dense_call("fwd", args, basis)
    img_r, tout_r = dense_call("fwd", args, basis, plain=True)
    check_image((img_k - img_r).abs().max().item(), what)
    check_t_out(tout_k, tout_r, what)
    rel_err(dense_call("bwd", args, basis),
            dense_call("bwd", args, basis, plain=True), f"{what}: dfeats")


def longest_row(cs, level: int) -> int:
    """The row of one camera's ``level`` with the most live slots (the
    first of several)."""
    return int(dense_level_args(cs, level)[1].argmax())


def longest_rows(cases, level: int) -> list:
    """Per camera, its longest_row of ``level`` alone as a one-row frame:
    dense_level_args of it."""
    out = []
    for cs in cases:
        r = longest_row(cs, level)
        out.append(tuple(None if x is None else x[r:r + 1].contiguous()
                         for x in dense_level_args(cs, level)))
    return out


def check_longest_rows(cases, rows, level: int, basis) -> None:
    """Each dense kernel on each camera's longest row of ``level`` alone
    (``rows``, from longest_rows) gives that row of its launch on the
    camera's whole frame, bit for bit (a CTA walks one row and nothing
    crosses rows; the whole frames are held to the plain versions)."""
    for c, (cs, one) in enumerate(zip(cases, rows)):
        r = longest_row(cs, level)
        for k in ("fwd", "bwd"):
            full = as_tuple(dense_call(k, dense_level_args(cs, level),
                                       basis))
            alone = as_tuple(dense_call(k, one, basis))
            if not all(torch.equal(x[r:r + 1], y)
                       for x, y in zip(full, alone)):
                raise AssertionError(f"raster_v2_{k}: camera {c} level "
                                     f"{level}'s longest row alone differs "
                                     "from that row of the whole launch")


def dense_chain_case(slots: int, device) -> tuple:
    """A one-row level-2 frame (K = K2) of ``slots`` live broad slots of
    alpha ~SEG_CHAIN_ALPHA on every pixel (chain_case's pairs), entered at
    a seeded t_in in [0.5, 1), so that no pixel stops (0.5 * 0.995^640 >
    1e-4); slots past the count carry the -1e30 constant term of the
    frame's contract: dense_level_args of it."""
    pairs, _, g = chain_case(1, slots, device)
    feats = torch.zeros((1, K2, 8), device=device)
    feats[..., 5] = -1e30
    feats[0, :slots] = pairs
    gen = torch.Generator(device=device).manual_seed(3)
    t_in = 0.5 + 0.5 * torch.rand((1, 256), generator=gen, device=device)
    total = torch.rand((1, 256), generator=gen, device=device)
    return (feats, torch.tensor([slots], dtype=torch.int32, device=device),
            t_in, g, total)


def phase_dense_chain(device, cases, basis, level_ms: dict) -> None:
    """The dense kernels' chain, timed one CTA alone (queued_ms): each
    kernel on each camera's longest row of each level (its own slots,
    the same bits as that row of the whole launch), beside that level's
    launch per camera; and both kernels on a faint level-2 row of K2
    slots that every pixel walks to the end, held to the plain versions."""
    with torch.no_grad():
        check_dense(dense_chain_case(K2, device), basis,
                    f"faint level-2 row of {K2} slots")
        own = {}
        for lv in (1, 2):
            rows = longest_rows(cases, lv)
            check_longest_rows(cases, rows, lv, basis)
            for k in ("fwd", "bwd"):
                own[(k, lv)] = [
                    queued_ms(lambda: dense_call(k, args, basis), 20)
                    for args in rows]
            own[("slots", lv)] = [int(a[1]) for a in rows]
    for k in ("fwd", "bwd"):
        for lv in (1, 2):
            ms, alone = level_ms[(k, lv)], own[(k, lv)]
            log(f"raster_v2_{k} level {lv}: {ms:.4f} ms per camera (device) "
                "beside "
                f"one CTA alone on each camera's longest row "
                f"{own[('slots', lv)]} live slots: "
                + ", ".join(f"{t:.4f}" for t in alone) + " ms (x"
                + ", x".join(f"{t / ms:.2f}" for t in alone)
                + f" of the launch; mean x{np.mean(alone) / ms:.2f})")


def pair_cases(device):
    """Per camera: the v4 pair kernels' inputs at the recipe's cap and
    budget, binned with brick-alignment pads."""
    from edgegaussians_tpu_torch.ops import pair, tiles
    cams, w, h, n = fixture_cameras(device)
    origins = tiles.tile_origins(w, h, 16, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    cases = []
    with torch.no_grad():
        for proj, packed in cams:
            pbins = tiles.bin_pairs_frame_order(
                proj, w, h, 16, min(CAP, n), BUDGET,
                max_tiles_per_gaussian=16, block_tiles=PAIR_BLOCK_TILES)
            src, ox, oy, feats, sfp, counts = pair.pair_prep(
                packed[pbins.order], pbins, origins)
            g = torch.rand((sfp.shape[0], 256), generator=gen,
                           device=device)
            cases.append(dict(pbins=pbins, src=src, ox=ox, oy=oy,
                              feats=feats, sfp=sfp, counts=counts, g=g,
                              n=n))
    return cases


def pair_work(cs, basis):
    """(fwd bytes, bwd bytes, evaluations) one camera's v4 kernels need:
    the composited pairs' features, run starts and lengths, basis and
    [T,256] planes read once, outputs written once; a pixel evaluates a
    pair while its transmittance before the pair is >= 1e-4."""
    from edgegaussians_tpu_torch.ops import pair, segpair
    maxrun, chunks = pair._run_chunks(cs["counts"])
    evals = 0
    for r0, r1 in chunks:
        _, _, t_inc, _, _, slot_valid = segpair.run_alpha(
            cs["feats"], cs["sfp"][r0:r1], cs["counts"][r0:r1], basis,
            maxrun)
        t_before = torch.cat([torch.ones_like(t_inc[:, :1]),
                              t_inc[:, :-1]], 1)
        evals += int(((t_before >= EPS_T) & slot_valid[..., None]).sum())
    T = cs["sfp"].shape[0]
    kept = int(cs["counts"].sum())
    plane = T * 256 * 4
    common = kept * 32 + T * 8 + basis.numel() * 4
    return common + plane, common + 2 * plane + kept * 32, evals


def phase_pair_kernels(device):
    from edgegaussians_tpu_torch.ops import pair, segpair, tiles
    log(f"== phase 2 (pair): v4 block-window kernels vs plain versions, "
        f"fixture at 800x800, cap {CAP}, budget {BUDGET}, block_tiles "
        f"{PAIR_BLOCK_TILES}")
    cases = pair_cases(device)
    basis = tiles.pixel_basis(16, device=device)
    err = {"pair_fwd": 0.0, "pair_bwd": 0.0}
    work = np.zeros(3)
    for c, cs in enumerate(cases):
        pb = cs["pbins"]
        args = (cs["feats"], cs["sfp"], cs["counts"], basis)
        with torch.no_grad():
            img_k = pair.pair_fwd(*args)
            img_r = pair.pair_fwd_ref(*args)
            # both backwards take the plain image as the total, so the
            # comparison isolates the kernel
            dfe_k = pair.pair_bwd(*args, cs["g"], img_r)
            dfe_r = pair.pair_bwd_ref(*args, cs["g"], img_r)
            torch.cuda.synchronize()
            valid = pb.pair_valid[:, None]
            dfe_k = torch.where(valid, dfe_k, torch.zeros_like(dfe_k))
            outs = [segpair.pair_grads_to_packed(
                d, cs["src"], cs["ox"], cs["oy"], pb, cs["n"])
                for d in (dfe_k, dfe_r)]
            work += pair_work(cs, basis)
        e_img = (img_k - img_r).abs().max().item()
        e_dfe = (dfe_k - dfe_r).abs().max().item()
        err["pair_fwd"] = max(err["pair_fwd"], e_img)
        err["pair_bwd"] = max(err["pair_bwd"], e_dfe)
        rel = [rel_err(dfe_k, dfe_r, f"camera {c}: dfeats")]
        rel += [rel_err(a, b, f"camera {c}: {name}")
                for name, a, b in zip(("dpacked", "absgrad"), *outs)]
        pads = int((pb.s_f[1:] - pb.s_f[:-1] - pb.counts_f).sum())
        log(f"camera {c}: pairs={int(pb.num_pairs)}/{BUDGET} "
            f"kept={int(cs['counts'].sum())} pads={pads} "
            f"max_run={int(cs['counts'].max())} img_err={e_img:.3g} "
            f"dfeats_err={e_dfe:.3g} dfeats_rel={rel[0]:.3g} "
            f"dpacked_rel={rel[1]:.3g} absgrad_rel={rel[2]:.3g}")
        check_image(e_img, f"camera {c}")

    def over_cases(fn):
        return lambda: [fn(cs) for cs in cases]

    for cs in cases:
        cs["total"] = (0.5 + 0.5 * cs["g"]).contiguous()
    calls = {
        "pair_fwd": tuple(over_cases(lambda cs, f=f: f(
            cs["feats"], cs["sfp"], cs["counts"], basis))
            for f in (pair.pair_fwd, pair.pair_fwd_ref)),
        "pair_bwd": tuple(over_cases(lambda cs, f=f: f(
            cs["feats"], cs["sfp"], cs["counts"], basis, cs["g"],
            cs["total"])) for f in (pair.pair_bwd, pair.pair_bwd_ref)),
    }
    per_cam = work / len(cases)
    bounds = {"pair_fwd": bound_ms(per_cam[0], per_cam[2], FWD_OPS),
              "pair_bwd": bound_ms(per_cam[1], per_cam[2], BWD_OPS)}
    log(f"per camera: {per_cam[2]:.0f} pair-pixel evaluations, "
        f"{per_cam[0] / 1e6:.2f} MB (fwd) / {per_cam[1] / 1e6:.2f} MB (bwd)")
    ms = time_kernels(calls, len(cases), bounds)
    with torch.no_grad():
        for k in ("fwd", "bwd"):
            # the backward writes the rows inside runs, and no pad row
            rows = (slice(None) if k == "fwd"
                    else cases[0]["pbins"].pair_valid)
            twice = [pair_call(k, pair_args(cases[0]), basis)[rows]
                     for _ in range(2)]
            if not torch.equal(*twice):
                raise AssertionError(f"pair_{k}: two launches on the same "
                                     "inputs differ")
    log("pair_fwd, pair_bwd: two launches on camera 0 bit-equal (the "
        "backward's rows inside runs)")
    phase_pair_chain(cases, basis, {k: v[3] for k, v in ms.items()})
    return err, ms, bounds


def pair_args(cs) -> tuple:
    """(feats, sfp, counts, g, total) of one camera's v4 frame (after
    phase_pair_kernels set its timing total)."""
    return cs["feats"], cs["sfp"], cs["counts"], cs["g"], cs["total"]


def pair_call(kernel: str, args, basis):
    """The v4 ``kernel`` ("fwd" or "bwd") wrapper on ``args`` (as
    pair_args)."""
    from edgegaussians_tpu_torch.ops import pair
    feats, sfp, counts, g, total = args
    if kernel == "fwd":
        return pair.pair_fwd(feats, sfp, counts, basis)
    return pair.pair_bwd(feats, sfp, counts, basis, g, total)


def pair_longest_rows(cases, device) -> list:
    """Per camera, its longest run alone as a one-row frame: (row, pair
    args of it)."""
    out = []
    for cs in cases:
        r = int(cs["counts"].argmax())
        s0, n = int(cs["sfp"][r]), int(cs["counts"][r])
        one = torch.tensor([n], dtype=torch.int32, device=device)
        out.append((r, (cs["feats"][s0:s0 + n].contiguous(),
                        torch.zeros_like(one), one,
                        cs["g"][r:r + 1].contiguous(),
                        cs["total"][r:r + 1].contiguous())))
    return out


def phase_pair_chain(cases, basis, device_ms: dict) -> None:
    """The v4 kernels' chain, timed one CTA alone (queued_ms): each kernel
    on each camera's longest run alone (its own pairs; the same bits as
    that row of the whole launch), beside the launch's device time per
    camera."""
    device = cases[0]["feats"].device
    rows = pair_longest_rows(cases, device)
    own = {}
    with torch.no_grad():
        for c, (cs, (r, one)) in enumerate(zip(cases, rows)):
            full = pair_call("fwd", pair_args(cs), basis)
            if not torch.equal(full[r:r + 1], pair_call("fwd", one, basis)):
                raise AssertionError(f"pair_fwd: camera {c}'s longest run "
                                     "alone differs from its row of the "
                                     "whole launch")
            s0, n = int(cs["sfp"][r]), int(cs["counts"][r])
            full = pair_call("bwd", pair_args(cs), basis)
            if not torch.equal(full[s0:s0 + n], pair_call("bwd", one, basis)):
                raise AssertionError(f"pair_bwd: camera {c}'s longest run "
                                     "alone differs from its rows of the "
                                     "whole launch")
        for k in ("fwd", "bwd"):
            own[k] = [queued_ms(lambda: pair_call(k, one, basis), 20)
                      for _, one in rows]
    lengths = [int(one[2]) for _, one in rows]
    for k in ("fwd", "bwd"):
        ms = device_ms[f"pair_{k}"]
        log(f"pair_{k} {ms:.4f} ms per camera (device) beside one CTA "
            f"alone on each camera's longest run {lengths}: its own pairs "
            + ", ".join(f"{t:.4f}" for t in own[k]) + " ms (x"
            + ", x".join(f"{t / ms:.2f}" for t in own[k])
            + f" of the launch; mean x{np.mean(own[k]) / ms:.2f})")


def rank_sum_cases(device):
    """(name, rows [B,10], idx [B], n, valid [B]) of the row sum: each
    fixture camera's seg backward rows (budget 49152, ~33k valid pairs of
    12740 Gaussians, dfeats from the seg kernel) and one at the seg main
    path's size (the same budget and the recipe's capacity 16384, ~6.2k
    valid pairs over the 2500 Gaussians of its seed; seeded rows)."""
    from edgegaussians_tpu_torch.ops import segpair
    cases, basis = seg_cases(device)
    out = []
    with torch.no_grad():
        for c, cs in enumerate(cases):
            pb = cs["pbins"]
            dfe = segpair.segpair_bwd(cs["feats"], cs["s_f"], basis,
                                      (cs["g"] * 0.5).contiguous())
            dfe = torch.where(pb.pair_valid[:, None], dfe,
                              torch.zeros_like(dfe))
            dsrc = segpair.build_pair_features_vjp(cs["src"], cs["ox"],
                                                   cs["oy"], dfe)
            rows = torch.cat([dsrc, dsrc[:, 3:5].abs()], -1).contiguous()
            out.append((f"camera {c}", rows, pb.pair_ranks, cs["n"],
                        pb.pair_valid))
    gen = torch.Generator(device=device).manual_seed(12)
    idx = torch.randint(0, MAIN_GAUSSIANS, (BUDGET,), generator=gen,
                        device=device)
    rows = torch.randn((BUDGET, 10), generator=gen, device=device)
    valid = torch.arange(BUDGET, device=device) < MAIN_PAIRS
    out.append(("main path", rows, idx, KNN_CAPACITY, valid))
    return out


def phase_rank_sum(device):
    """Phase 2 (rank_sum): the row sum of the compositors' backwards
    against its plain version (bit for bit against the CPU's, within the
    gradient gate against the card's index_add_ atomics), two launches
    bit-equal, then its time beside the index_add_ it replaced, at the
    fixture's and the seg main path's sizes."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    log("== phase 2 (rank_sum): the deterministic row sum vs its plain "
        "version and index_add_")
    cases = rank_sum_cases(device)
    err = 0.0
    times = {}
    for name, rows, idx, n, valid in cases:
        with torch.no_grad():
            got = rs.rank_sum(rows, idx, n, valid)
            again = rs.rank_sum(rows, idx, n, valid)
            plain = rs.rank_sum_ref(rows, idx, n, valid)
            cpu = rs.rank_sum_ref(rows.cpu(), idx.cpu(), n, valid.cpu())
            torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"rank_sum {name}: two launches differ")
        if not torch.equal(got.cpu().view(torch.int32),
                           cpu.view(torch.int32)):
            raise AssertionError(f"rank_sum {name}: not the CPU plain "
                                 "version's bits")
        rel = rel_err(got, plain, f"rank_sum {name}")
        err = max(err, (got - plain).abs().max().item())
        keys = torch.where(valid, idx, torch.full_like(idx, n))
        keys32, perm = torch.sort(keys.to(torch.int32), stable=True)
        acc = torch.zeros((n + 1, 10), device=device)
        out = torch.zeros((n, 10), device=device)
        # what the sum needs: the mask, each valid row and its index
        # (dropped rows are never read), the [n, C] output; one add a
        # valid element
        nv = int(valid.sum())
        width = rows.shape[1]
        nbytes = (nv * (width * rows.element_size() + idx.element_size())
                  + valid.numel() * valid.element_size() + n * width * 4)
        t = {"kernel": cuda_ms(lambda: rs.rank_sum(rows, idx, n, valid),
                               20),
             "plain": cuda_ms(lambda: rs.rank_sum_ref(rows, idx, n, valid),
                              20),
             "library": cuda_ms(lambda: acc.index_add_(0, keys, rows), 20),
             "kernel_dev": queued_ms(
                 lambda: rs.rank_sum(rows, idx, n, valid), 20),
             "sum_only_dev": queued_ms(
                 lambda: rs.launch_sum(rows, keys32, perm, n, out), 20),
             "library_dev": queued_ms(
                 lambda: acc.index_add_(0, keys, rows), 20),
             "bound": bound_ms(nbytes, nv, (width, 0))}
        times[name] = t
        log(f"rank_sum {name}: {rows.shape[0]} rows, {int(valid.sum())} "
            f"valid, n {n}: rel err {rel:.3g}, bit-equal to the CPU plain "
            f"version; wrapper {t['kernel']:.4f} ms (device "
            f"{t['kernel_dev']:.4f}: sort + sum; the sum kernel alone "
            f"{t['sum_only_dev']:.4f}), plain {t['plain']:.4f} ms, "
            f"index_add_ {t['library']:.4f} ms "
            f"(device {t['library_dev']:.4f}), bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]})")
    cams = [t for name, t in times.items() if name.startswith("camera")]

    def mean(key):
        return float(np.mean([t[key] for t in cams]))
    bound = float(np.mean([t["bound"][0] for t in cams]))
    bounds = {"rank_sum": (bound, cams[0]["bound"][1])}
    log(f"rank_sum per fixture camera: wrapper {mean('kernel'):.4f} ms "
        f"(device {mean('kernel_dev'):.4f}), index_add_ "
        f"{mean('library'):.4f} ms (device {mean('library_dev'):.4f}), "
        f"bound {bound:.4f} ms")
    ms = {"rank_sum": (mean("kernel"), mean("plain"), mean("library"),
                       mean("kernel_dev"))}
    return {"rank_sum": err}, ms, bounds


def v1_cases(device):
    """Per camera: the v1 kernels' inputs, the single-level frame at
    capacity 768 (the path ``rasterizer_backend: "pallas_v1"`` runs)."""
    from edgegaussians_tpu_torch.ops import tiles
    cams, w, h, n = fixture_cameras(device)
    origins = tiles.tile_origins(w, h, 16, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    cases = []
    with torch.no_grad():
        for proj, packed in cams:
            bins = tiles.bin_gaussians(proj, w, h, 16, min(CAP, n),
                                       max_tiles_per_gaussian=16)
            feats = tiles.build_tile_features(
                packed[bins.order][bins.ranks], origins,
                bins.valid.to(torch.float32)).contiguous()
            g = torch.rand((origins.shape[0], 256), generator=gen,
                           device=device)
            cases.append(dict(bins=bins, feats=feats, g=g))
    return cases


def v1_work(cs, basis):
    """(fwd bytes, bwd bytes, evaluations, walked evaluations) one
    camera's v1 kernels need: the whole [T,K,8] frame and basis read once,
    the [T,256] planes and (backward) the [T,K,8] dfeats once; a pixel
    evaluates a live slot while its log transmittance before the slot is
    >= log 1e-4. ``walked`` counts every (slot, pixel) of the frame."""
    from edgegaussians_tpu_torch.ops import raster_v1, raster_v2
    feats, bins = cs["feats"], cs["bins"]
    T, K, _ = feats.shape
    evals = 0
    for r0, r1 in raster_v2._row_chunks(T, K):
        alpha, _, _, _ = raster_v1._chunk_terms(feats[r0:r1], basis)
        log1m = torch.log1p(-alpha)
        lt_before = torch.cumsum(log1m, dim=1) - log1m
        evals += int(((lt_before >= raster_v1.LOG_TRANSMITTANCE_EPS)
                      & bins.valid[r0:r1, :, None]).sum())
    frame = T * K * 32
    plane = T * 256 * 4
    common = frame + basis.numel() * 4
    return common + plane, common + 2 * plane + frame, evals, T * K * 256


def phase_v1_kernels(device):
    from edgegaussians_tpu_torch.ops import raster_v1, tiles
    log(f"== phase 2 (v1): v1 log-space kernels vs plain versions, fixture "
        f"at 800x800, single-level frame at capacity {CAP}")
    cases = v1_cases(device)
    basis = tiles.pixel_basis(16, device=device)
    err = {"raster_v1_fwd": 0.0, "raster_v1_bwd": 0.0}
    work = np.zeros(4)
    for c, cs in enumerate(cases):
        with torch.no_grad():
            img_k = raster_v1.composite_fwd(cs["feats"], basis)
            img_r = raster_v1.composite_fwd_ref(cs["feats"], basis)
            d_k = raster_v1.composite_bwd(cs["feats"], basis, cs["g"], img_r)
            d_r = raster_v1.composite_bwd_ref(cs["feats"], basis, cs["g"],
                                              img_r)
            same = (torch.equal(img_k, raster_v1.composite_fwd(cs["feats"],
                                                               basis))
                    and torch.equal(d_k, raster_v1.composite_bwd(
                        cs["feats"], basis, cs["g"], img_r)))
            torch.cuda.synchronize()
            work += v1_work(cs, basis)
        if not same:
            raise AssertionError(f"raster_v1: camera {c}: two launches "
                                 "differ")
        e_img = (img_k - img_r).abs().max().item()
        e_dfe = (d_k - d_r).abs().max().item()
        err["raster_v1_fwd"] = max(err["raster_v1_fwd"], e_img)
        err["raster_v1_bwd"] = max(err["raster_v1_bwd"], e_dfe)
        rel = rel_err(d_k, d_r, f"camera {c}: dfeats")
        live = raster_v1.live_slots(cs["feats"])
        log(f"camera {c}: the kernels' find keeps {int(live.sum())} slots "
            f"and skips {int((~live).sum())} marked ones (valid slots of "
            f"the binning: {int(cs['bins'].valid.sum())}); longest row "
            f"{int(live.sum(1).argmax())} with {int(live.sum(1).max())} "
            f"live slots; max_count={int(cs['bins'].counts.max())} "
            f"img_err={e_img:.3g} dfeats_err={e_dfe:.3g} "
            f"dfeats_rel={rel:.3g}")
        check_image(e_img, f"camera {c}")

    def over_cases(fn):
        return lambda: [fn(cs) for cs in cases]

    for cs in cases:
        cs["total"] = (0.5 + 0.5 * cs["g"]).contiguous()
    calls = {
        "raster_v1_fwd": tuple(over_cases(lambda cs, f=f: f(
            cs["feats"], basis)) for f in (raster_v1.composite_fwd,
                                           raster_v1.composite_fwd_ref)),
        "raster_v1_bwd": tuple(over_cases(lambda cs, f=f: f(
            cs["feats"], basis, cs["g"], cs["total"]))
            for f in (raster_v1.composite_bwd, raster_v1.composite_bwd_ref)),
    }
    per_cam = work / len(cases)
    bounds = {"raster_v1_fwd": bound_ms(per_cam[0], per_cam[2], V1_FWD_OPS),
              "raster_v1_bwd": bound_ms(per_cam[1], per_cam[2], V1_BWD_OPS)}
    log(f"per camera: {per_cam[2]:.0f} live slot-pixel evaluations of "
        f"{per_cam[3]:.0f} walked (T x {CAP} x 256), "
        f"{per_cam[0] / 1e6:.2f} MB (fwd) / {per_cam[1] / 1e6:.2f} MB (bwd)")
    return err, time_kernels(calls, len(cases), bounds), bounds


def knn_inputs(device):
    """The fixture's means as live rows, padded with dead rows (at the
    origin, as a fixed-capacity state's free slots) to the recipe's
    capacity."""
    means = np.load(FIXTURE)["means"].astype(np.float32)
    n_live = means.shape[0]
    pts = np.zeros((KNN_CAPACITY, 3), np.float32)
    pts[:n_live] = means
    mask = np.zeros(KNN_CAPACITY, bool)
    mask[:n_live] = True
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(mask).to(device), n_live)


def check_knn(d_k, i_k, d_r, i_r, mask, what: str, rows=None) -> float:
    """Kernel against plain, bit for bit (both round every product and
    sum of d^2 alike and share the tie rule): equal distances and indices;
    no self, no dead neighbour on wet slots; dry slots float32 max with
    index 0. ``rows``: the query rows the answers belong to (default: all,
    in order). Returns the distances' max abs error, 0."""
    from edgegaussians_tpu_torch.ops import knn as knn_mod
    if not (torch.equal(d_k, d_r) and torch.equal(i_k, i_r)):
        raise AssertionError(
            f"{what}: {int((d_k != d_r).sum())} distances and "
            f"{int((i_k != i_r).sum())} indices differ from the plain "
            "version")
    dry = d_r == knn_mod.F32_MAX
    if not bool((i_r[dry] == 0).all()):
        raise AssertionError(f"{what}: a dry slot with an index")
    wet = ~dry
    if rows is None:
        rows = torch.arange(i_k.shape[0], device=i_k.device)
    if bool((i_k[wet] == rows[:, None].expand_as(i_k)[wet]).any()) or \
            not bool(mask[i_k[wet]].all()):
        raise AssertionError(f"{what}: a self or dead neighbour")
    return 0.0


def knn_cloud(device, n: int, seed: int = 8):
    """``n`` points uniform in the unit box from ``seed``, every other row
    live (a staged capacity half full)."""
    r = np.random.default_rng(seed)
    pts = r.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[::2] = True
    return torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)


def knn_floor_ms(pairs: float) -> float:
    """The instruction floor of ``pairs`` (query, live key) pairs: the 9
    uncontracted operations and the compare, one lane-instruction each,
    over the H100's 132 SMs x 128 lanes at 1.98 GHz."""
    return pairs * KNN_LANE_INSTR / LANE_INSTR_PER_S * 1e3


def phase_knn_big(device):
    """Phase 2 (knn) at the DTU / Replica capacity: the kernel on
    :func:`knn_cloud`, bit-equal to the plain version on KNN_BIG_SAMPLE
    seeded query rows, timed beside its bound, its instruction floor and
    cdist + topk over chunks of KNN_BIG_CHUNK query rows."""
    from edgegaussians_tpu_torch.ops import knn as knn_mod
    pts, mask = knn_cloud(device, KNN_BIG)
    n, k = pts.shape[0], KNN_BIG_K
    n_live = int(mask.sum())
    log(f"== phase 2 (knn, {n} rows): {n_live} live rows uniform in the "
        f"unit box, k={k}")
    rows = torch.from_numpy(np.sort(np.random.default_rng(9).choice(
        n, KNN_BIG_SAMPLE, replace=False))).to(device)
    inf = torch.tensor(float("inf"), device=device)

    def library():
        # the yardstick: cdist, the masks and topk per chunk of rows
        for r0 in range(0, n, KNN_BIG_CHUNK):
            r1 = min(r0 + KNN_BIG_CHUNK, n)
            d = torch.where(mask[None, :], torch.cdist(pts[r0:r1], pts), inf)
            q = torch.arange(r1 - r0, device=device)
            d[q, r0 + q] = inf
            torch.topk(d, k, dim=1, largest=False)

    with torch.no_grad():
        d_k, i_k = knn_mod.knn(pts, k, mask)
        torch.cuda.synchronize()
        ref = [knn_mod.knn_ref_rows(pts, k, mask, rows[c:c + 512])
               for c in range(0, KNN_BIG_SAMPLE, 512)]
        err = check_knn(d_k[rows], i_k[rows], torch.cat([r[0] for r in ref]),
                        torch.cat([r[1] for r in ref]), mask,
                        f"{n} rows, {KNN_BIG_SAMPLE} sampled", rows)
        ms = (cuda_ms(lambda: knn_mod.knn(pts, k, mask), 3),
              cuda_ms(library, 1))
    bound = bound_ms(n * 12 + n + n * k * 12, n * n_live, KNN_OPS)
    log(f"knn {n} rows k={k}: {KNN_BIG_SAMPLE} sampled query rows bit-equal "
        f"to plain; kernel {ms[0]:.4f} ms, cdist+topk in chunks of "
        f"{KNN_BIG_CHUNK} rows {ms[1]:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]}; {n * n_live} query-key pairs), instruction floor "
        f"{knn_floor_ms(n * n_live):.4f} ms")
    return err, ms, bound


def phase_knn_kernel(device):
    from edgegaussians_tpu_torch.ops import knn as knn_mod
    pts, mask, n_live = knn_inputs(device)
    n = pts.shape[0]
    log(f"== phase 2 (knn): kNN kernel vs plain version, fixture means "
        f"({n_live} live rows) padded to {n} with dead rows")
    err = 0.0
    with torch.no_grad():
        for k in KNN_KS:
            d_k, i_k = knn_mod.knn(pts, k, mask)
            torch.cuda.synchronize()
            d_r, i_r = knn_mod.knn_ref(pts, k, mask)
            e = check_knn(d_k, i_k, d_r, i_r, mask, f"k={k}")
            # no dry slot: dead query rows get live neighbours too
            if bool((d_r == knn_mod.F32_MAX).any()):
                raise AssertionError(f"k={k}: dry slots with {n_live} live "
                                     "rows")
            err = max(err, e)
            log(f"k={k}: bit-equal to plain (distances and indices), dead "
                "rows answered")
        few = torch.zeros_like(mask)
        few[[0, 5000, 9000, 12000]] = True
        d_k, i_k = knn_mod.knn(pts, 6, few)
        torch.cuda.synchronize()
        d_r, i_r = knn_mod.knn_ref(pts, 6, few)
        check_knn(d_k, i_k, d_r, i_r, few, "4 live rows")
        dry = (d_k == knn_mod.F32_MAX).sum(dim=1)
        if not (bool((dry[few] == 3).all()) and
                bool((dry[~few] == 2).all())):
            raise AssertionError("4 live rows: dry slot counts")
        log("4 live rows, k=6: live rows 3 dry slots, dead rows 2, "
            "float32 max and index 0 on both sides")

        k = KNN_KS[0]
        big = torch.tensor(float("inf"), device=device)

        def library():
            # the yardstick: one cdist, the masks, one topk
            d = torch.cdist(pts, pts)
            d = torch.where(mask[None, :], d, big)
            d.fill_diagonal_(float("inf"))
            return torch.topk(d, k, dim=1, largest=False)

        ms = (cuda_ms(lambda: knn_mod.knn(pts, k, mask), 20),
              cuda_ms(lambda: knn_mod.knn_ref(pts, k, mask), 2),
              cuda_ms(library, 5))
    nbytes = n * 12 + n + n * k * 12
    bound = bound_ms(nbytes, n * n_live, KNN_OPS)
    log(f"knn k={k}: kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, "
        f"cdist+topk {ms[2]:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
        f"{n * n_live} query-key pairs), instruction floor "
        f"{knn_floor_ms(n * n_live):.4f} ms")
    err = max(err, phase_knn_big(device)[0])
    return err, ms, bound


def small_scene(seed=0, n=300, width=64, height=48):
    r = np.random.default_rng(seed)
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.01), np.log(0.06), (n, 3))) \
        .astype(np.float32)
    opac = r.uniform(0.2, 0.9, n).astype(np.float32)
    f = 55.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    return (means, quats, scales, opac, np.eye(4, dtype=np.float32), K,
            width, height)


def render_grads(scene, device, **render_kw):
    """Image and the gradients of a weighted clipped-image sum w.r.t. the
    four parameter groups and the absgrad sink, on ``device``."""
    from edgegaussians_tpu_torch.ops.rasterize import rasterize
    *arrays, width, height = scene
    t = [torch.from_numpy(a).to(device) for a in arrays]
    params = [x.requires_grad_() for x in t[:4]]
    sink = torch.zeros((t[0].shape[0], 2), device=device,
                       requires_grad=True)
    out = rasterize(*params, t[4], t[5], width, height, tile_size=16,
                    absgrad_sink=sink, **render_kw)
    img = torch.clamp(out.image, 0, 1)
    w = (torch.arange(img.numel(), device=device, dtype=torch.float32)
         .reshape(img.shape) % 7) / 7.0 + 0.3
    grads = torch.autograd.grad((img * w).sum(), params + [sink])
    return [out.image.detach().cpu()] + [g.cpu() for g in grads]


WHOLE_PATHS = {
    "seg": dict(capacity=256, pair_budget=2048, pair_kernel="seg"),
    "two_level": dict(capacity=64, dense_capacity=16, overflow_tiles=3,
                      occupancy_sort=True, pair_budget=0),
    "single": dict(capacity=64, pair_budget=0),
    "pair_v4": dict(capacity=256, pair_budget=2048, pair_kernel=True),
    "single_v1": dict(capacity=64, pair_budget=0, backend="pallas_v1"),
    "pair_prefix": dict(capacity=64, dense_capacity=16, overflow_tiles=3,
                        occupancy_sort=True, pair_budget=2048,
                        pair_kernel=False),
}


def phase_whole_path(device):
    log("== phase 2b: whole rasterizer, GPU kernels vs CPU plain path")
    scene = small_scene()
    names = ("image", "means", "quats", "scales", "opacities", "absgrad")
    for path, kw in WHOLE_PATHS.items():
        errs = []
        for name, a, b in zip(names, render_grads(scene, device, **kw),
                              render_grads(scene, torch.device("cpu"),
                                           **kw)):
            e = (a - b).abs().max().item()
            # the JAX package's own seg-vs-dense tolerances
            # (tests/test_pallas_segpair.py:65-66)
            ok = torch.allclose(a, b, atol=2e-5 if name == "image" else 3e-4,
                                rtol=0 if name == "image" else 2e-3)
            errs.append(f"{name}={e:.3g}")
            if not ok:
                raise AssertionError(f"whole-path {path} {name} disagrees: "
                                     f"{e:.3g}")
        log(f"{path}: max_abs_err " + " ".join(errs))


class Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def trace_summary(trace_path: str, view_steps: int) -> str:
    """Device busy share of a torch.profiler Chrome trace's window (the
    union of the device kernels' intervals over the span of all events),
    kernel launches per view step, and the top kernels by device time."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    busy, end = 0.0, -math.inf
    for e in kernels:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"device busy {busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms "
            f"window (share {busy / window:.4f}), "
            f"{len(kernels) / view_steps:.0f} kernel launches per view "
            "step; top kernels (ms): "
            + "; ".join(f"{n[:60]} {d / 1e3:.3f}" for n, d in top))


def no_launches(**counts):
    """Every kernel's expected launches: 0 unless given."""
    zero = {k: 0 for mod in kernel_modules() for k in mod.launch_counts}
    return dict(zero, **counts)


def write_config(tmp: str, epochs, tag: str, orient=None, seed=None,
                 training=None, data_dir=None, **model):
    """The recipe cut for a run tagged ``tag``, written to
    ``<tmp>/<tag>.json``; returns (config dict, path). ``epochs`` and
    ``seed`` None keep the recipe's; ``orient`` updates its orientation
    losses, ``training`` its training section, ``model`` its model; the
    scans are read from ``data_dir`` (default ``<tmp>/data``)."""
    with open(RECIPE) as f:
        cfg = json.load(f)
    if epochs is not None:
        cfg["training"]["num_epochs"] = epochs
    if seed is not None:
        cfg["training"]["seed"] = seed
    cfg["model"].update(model)
    cfg["training"].update(training or {})
    cfg["training"]["loss"]["orientation_losses"].update(orient or {})
    cfg["data"]["base_dir"] = (data_dir or os.path.join(tmp, "data")) + "/"
    for k in ("output_dir", "checkpoint_dir", "log_dir"):
        cfg["output"][k] = os.path.join(tmp, tag, k) + "/"
    cfg_path = os.path.join(tmp, f"{tag}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return cfg, cfg_path


def run_dir(cfg: dict, scan: str) -> str:
    return os.path.join(cfg["output"]["output_dir"],
                        f"{cfg['output']['exp_name']}_"
                        f"{cfg['data']['edge_detection_method']}", scan)


def train_cli_run(tmp: str, scan: str, epochs, tag: str,
                  profile_dir=None, orient=None, views=VIEWS, echo=True,
                  seed=None, training=None, **model):
    """Train the recipe on ``scan`` through the CLI with every launch
    count set to 0 just before; returns (log text, launches read just
    after, output dir, config path). See :func:`write_config` for the
    cuts. ``profile_dir`` traces epoch 2 and prints its summary; ``echo``
    False only captures the CLI's output."""
    from edgegaussians_tpu_torch.cli import train as train_cli
    cfg, cfg_path = write_config(tmp, epochs, tag, orient=orient, seed=seed,
                                 training=training, **model)
    captured = io.StringIO()
    reset_kernel_counts()
    argv = ["--config_file", cfg_path, "--scene_name", scan, "--backend",
            "cuda", "--force_rerun"]
    if profile_dir:
        argv += ["--profile_dir", os.path.join(profile_dir, tag),
                 "--profile_epochs", "1"]
    with contextlib.redirect_stdout(Tee(sys.stdout, captured) if echo
                                    else captured):
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = kernel_counts()
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    if profile_dir:
        log(f"{tag} path, epoch 2 traced: " + trace_summary(
            os.path.join(profile_dir, tag, "trace.json"), views))
    return captured.getvalue(), launches, run_dir(cfg, scan), cfg_path


def epoch_lines(text: str, epochs: int):
    """(loss, alive, Mpx/s) of each epoch line; all losses finite."""
    rows = [(float(m.group(1)), int(m.group(2)), float(m.group(3)))
            for m in re.finditer(r"^epoch \d+: loss=(\S+) alive=(\d+) .*"
                                 r"px/s=(\S+)M", text, re.M)]
    if len(rows) != epochs or not all(math.isfinite(r[0]) for r in rows):
        raise AssertionError(f"epoch lines {rows}")
    return rows


def check_outputs(out_dir: str, epochs: int, n_expected: int) -> int:
    from edgegaussians_tpu_torch.io.ply import read_gaussian_params_from_ply
    pos, _, _, opac = read_gaussian_params_from_ply(
        os.path.join(out_dir, "gaussians_all.ply"))
    if pos.shape != (n_expected, 3) or not np.isfinite(pos).all() \
            or not np.isfinite(opac).all():
        raise AssertionError(f"gaussians_all.ply holds {pos.shape}, "
                             f"expected {n_expected} alive Gaussians")
    for name in ("time.txt", f"epoch{epochs - 1}.npz"):
        if not os.path.exists(os.path.join(out_dir, name)):
            raise AssertionError(f"{name} missing")
    return pos.shape[0]


def phase_main_path(tmp: str, scan: str, profile_dir=None):
    log(f"== phase 3: main path, {EPOCHS} epochs of ABC_DexiNed on a "
        f"{VIEWS}-view 800x800 synthetic scan")
    text, launches, out_dir, _ = train_cli_run(tmp, scan, EPOCHS, "seg",
                                               profile_dir)
    rows = epoch_lines(text, EPOCHS)
    expected = no_launches(segpair_fwd=EPOCHS * VIEWS,
                           segpair_bwd=EPOCHS * VIEWS,
                           rank_sum=EPOCHS * VIEWS)
    if launches != expected:
        raise AssertionError(f"launches {launches} on the seg main path, "
                             f"expected {expected}")
    with open(RECIPE) as f:
        n_seed = json.load(f)["model"]["init_min_num_gaussians"]
    n = check_outputs(out_dir, EPOCHS, n_seed)
    log(f"main path ok: losses={[r[0] for r in rows]} launches={launches} "
        f"ply={n} Gaussians")
    return launches, [r[2] for r in rows[1:]]


def state_tensors(state) -> dict:
    """Every tensor of a train state's model and Adam moments, by name."""
    m = state.model
    out = {f"param {g}": p for g, p in m.params().items()}
    for g, (mu, nu) in state.opt.moments.items():
        out[f"mu {g}"], out[f"nu {g}"] = mu, nu
    out.update(alive=m.alive, absgrads=m.absgrads,
               absgrad_count=m.absgrad_count)
    return out


def bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its f32 elements as their bit patterns (so -0 and +0
    differ, and NaNs compare by payload)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@contextlib.contextmanager
def step_twice(at_step: int):
    """Within the context, the view step that ``trainer.view_step`` enters
    at ``state.step == at_step`` runs twice from the same state (every
    parameter, Adam moment and count, absgrads, the step and the
    generator restored in place between the two). Yields the list that
    gets one dict a run: the projection gradients (parameters and absgrad
    sink), every gradient handed to Adam (the projection's and, on a fired
    step, the direction's and the ratio's), the kNN's neighbour indices,
    the direction loss's gather backward's inputs (its cotangent and
    indices) and output, and the parameters, both Adam moments and
    absgrads after the step."""
    from edgegaussians_tpu_torch.models import losses
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    from edgegaussians_tpu_torch.train import optim, trainer
    step, adam, neighbours, gather = (trainer.view_step, optim.apply_updates,
                                      losses.update_nearest_neighbors,
                                      rs.gather_backward)
    runs = []

    def twice(state, *args, **kw):
        if state.step != at_step:
            return step(state, *args, **kw)
        with torch.no_grad():
            saved = {k: v.clone() for k, v in state_tensors(state).items()}
        counts = dict(state.opt.counts)
        gen = state.generator.get_state()
        proj_grad = kw["proj_grad"]
        for i in range(2):
            if i:
                with torch.no_grad():
                    for k, v in state_tensors(state).items():
                        v.copy_(saved[k])
                state.opt.counts = dict(counts)
                state.step = at_step
                state.generator.set_state(gen)
            got, after, calls = [], {}, {"adam": 0, "knn": 0, "gather": 0}

            def recorded(*a, **k):
                got.append(proj_grad(*a, **k))
                return got[-1]

            def recorded_adam(model, grads, *a, **k):
                after.update({f"adam {calls['adam']} {g}": x.detach().clone()
                              for g, x in grads.items()})
                calls["adam"] += 1
                return adam(model, grads, *a, **k)

            def recorded_knn(*a, **k):
                idx = neighbours(*a, **k)
                after[f"knn {calls['knn']}"] = idx.clone()
                calls["knn"] += 1
                return idx

            def recorded_gather(g, idx, n):
                dx = gather(g, idx, n)
                i = calls["gather"]
                after.update({f"gather {i} cotangent": g.detach().clone(),
                              f"gather {i} indices": idx.clone(),
                              f"gather {i} dx": dx.clone()})
                calls["gather"] += 1
                return dx
            optim.apply_updates = recorded_adam
            losses.update_nearest_neighbors = recorded_knn
            rs.gather_backward = recorded_gather
            try:
                out = step(state, *args, **dict(kw, proj_grad=recorded))
            finally:
                optim.apply_updates = adam
                losses.update_nearest_neighbors = neighbours
                rs.gather_backward = gather
            _, _, grads, gsink = got[0]
            with torch.no_grad():
                after.update({f"grad {g}": x.clone()
                              for g, x in grads.items()})
                after["absgrad sink"] = gsink.clone()
                after.update({k: v.clone()
                              for k, v in state_tensors(state).items()})
            runs.append(after)
        return out

    trainer.view_step = twice
    try:
        yield runs
    finally:
        trainer.view_step = step


def check_twice(runs, at_step: int, need) -> list:
    """Raise unless the view step ``at_step`` ran twice (``step_twice``),
    recorded a tensor under each name prefix of ``need``, and gave the
    same bits in every tensor; returns the tensors' names."""
    if len(runs) != 2:
        raise AssertionError(f"view step {at_step} ran {len(runs)} times")
    a, b = runs
    missing = [p for p in need if not any(k.startswith(p) for k in a)]
    differ = [k for k in a if k not in b or a[k].shape != b[k].shape
              or not torch.equal(bits(a[k]), bits(b[k]))]
    if missing or differ or set(a) != set(b):
        raise AssertionError(f"view step {at_step} run twice from the same "
                             f"state: nothing recorded for {missing}; "
                             f"differs in {differ}")
    return sorted(a)


def phase_determinism(tmp: str, scan: str):
    """Phase 3b: the seg main path for DET_EPOCHS epochs through the CLI,
    its view step at DET_STEP renders run twice from the same state
    (``step_twice``): the two runs' gradients (parameters and absgrad
    sink, and what Adam was handed), and the parameters, both Adam
    moments and absgrads after the step, bit for bit equal."""
    log(f"== phase 3b: determinism, view step {DET_STEP} of {DET_EPOCHS} "
        "epochs of the main path run twice from the same state")
    with step_twice(DET_STEP) as runs:
        _, launches, _, _ = train_cli_run(tmp, scan, DET_EPOCHS,
                                          "determinism", echo=False)
    names = check_twice(runs, DET_STEP, need=("grad", "adam", "mu", "nu"))
    views = DET_EPOCHS * VIEWS + 1
    expected = no_launches(segpair_fwd=views, segpair_bwd=views,
                           rank_sum=views)
    if launches != expected:
        raise AssertionError(f"launches {launches} of the determinism run, "
                             f"expected {expected}")
    log(f"determinism ok: {len(names)} tensors bit-equal (gradients, "
        f"parameters, Adam moments, absgrads); launches {launches}")


def phase_fallback_path(tmp: str, scan: str, profile_dir=None):
    log(f"== phase 4: fallback path, {FALLBACK_EPOCHS} epochs of "
        f"ABC_DexiNed on the same scan; cuts: tile_pair_budget="
        f"{FALLBACK_BUDGET} (epoch 0 overflows), "
        f"dup_high_pos_grads_at_epoch=[{DUP_EPOCH}]")
    text, launches, out_dir, _ = train_cli_run(
        tmp, scan, FALLBACK_EPOCHS, "fallback", profile_dir,
        tile_pair_budget=FALLBACK_BUDGET,
        dup_high_pos_grads_at_epoch=[DUP_EPOCH])
    rows = epoch_lines(text, FALLBACK_EPOCHS)
    warn = re.findall(r"^WARNING: epoch (\d+): .*switching to the dense "
                      r"frame path", text, re.M)
    if warn != ["0"]:
        raise AssertionError(f"fallback warnings for epochs {warn}, "
                             "expected one after epoch 0")
    dense = 2 * VIEWS * (FALLBACK_EPOCHS - 1)
    expected = no_launches(segpair_fwd=VIEWS, segpair_bwd=VIEWS,
                           raster_v2_fwd=dense, raster_v2_bwd=dense,
                           rank_sum=FALLBACK_EPOCHS * VIEWS)
    if launches != expected:
        raise AssertionError(f"launches {launches} on the fallback path, "
                             f"expected {expected}")
    alive = [r[1] for r in rows]
    # an epoch line reports alive before that epoch's density event
    if not alive[DUP_EPOCH + 1] > alive[DUP_EPOCH] == alive[0]:
        raise AssertionError(f"alive per epoch {alive}: no growth at the "
                             f"duplication of epoch {DUP_EPOCH}")
    with np.load(os.path.join(out_dir,
                              f"epoch{FALLBACK_EPOCHS - 1}.npz")) as ck:
        n_alive = int(ck["f:.gaussians.alive"].sum())
    n = check_outputs(out_dir, FALLBACK_EPOCHS, n_alive)
    log(f"fallback path ok: losses={[r[0] for r in rows]} alive={alive} "
        f"launches={launches} ply={n} Gaussians")
    return launches, [r[2] for r in rows[1:]]


def direction_fires(epochs: int, views: int, start_epoch: int) -> int:
    """Renders at which the direction loss fires: every 5th render
    (counted over the run) of an epoch past its start epoch."""
    return sum(1 for step in range(1, epochs * views + 1)
               if step % 5 == 0 and (step - 1) // views > start_epoch)


def downstream(tmp: str, scan: str, cfg_path: str, out_dir: str, tag: str,
               cluster_seed=None):
    """The port's cli.fit_edges (``--seed cluster_seed`` when given) then
    cli.evaluate (with --write_metrics) on a trained scan; both must exit
    0 and write their files. Returns (parametric edges, per-scan chamfer
    metrics or None, PR metrics)."""
    import pickle

    from edgegaussians_tpu_torch.cli import evaluate, fit_edges
    t0 = time.time()
    argv = ["--config_file", cfg_path, "--scene_name", scan]
    if cluster_seed is not None:
        argv += ["--seed", str(cluster_seed)]
    if fit_edges.main(argv):
        raise AssertionError("cli.fit_edges returned non-zero")
    with open(os.path.join(out_dir, "parametric_edges.json")) as f:
        edges = json.load(f)
    metrics_dir = os.path.join(tmp, tag, "metrics")
    if evaluate.main(["--scan_names", scan, "--gt_base_dir",
                      os.path.join(tmp, "groundtruth"), "--output_base_dir",
                      os.path.dirname(out_dir), "--use_parametric_edges",
                      "--write_metrics", "--write_metrics_dir",
                      metrics_dir]):
        raise AssertionError("cli.evaluate returned non-zero")
    written = os.path.join(metrics_dir, "release", "DexiNed")
    with open(os.path.join(written, "pr.pkl"), "rb") as f:
        pr = pickle.load(f)
    with open(os.path.join(written, "acc_comp_chamfer.pkl"), "rb") as f:
        per_scan = pickle.load(f).get(scan, {}).get("edgegaussians")
    log(f"fit_edges + evaluate in {time.time() - t0:.1f}s: "
        f"{len(edges['lines_end_pts'])} lines, "
        f"{len(edges['curves_ctl_pts'])} curves, metrics {per_scan}")
    return edges, per_scan, pr


def gather_backward_check(run: dict):
    """Phase 5's direction loss's gather backward (``ops/rank_sum.
    gather_backward``, the row-sum kernel's second job) on the doubled
    fired step's own cotangent and kNN indices (``step_twice``): the
    kernel's result bit-equal to the step's, to a second launch and to the
    CPU plain version of every row (``rank_sum_ref``: no row dropped),
    within the gradient gate of the card's plain version and of ATen's
    backward of ``x[idx]`` (``index_put_`` with accumulate, what the gather
    ran before it had a backward of its own); then their times beside the
    bound. Returns (max_abs_err, (ms, plain ms, library ms, device ms),
    bound) for the kernels line, and the extra keys."""
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    g, idx, dx = (run[f"gather 0 {k}"] for k in ("cotangent", "indices",
                                                  "dx"))
    n, width = dx.shape
    rows = g.reshape(-1, width).contiguous()
    flat = idx.reshape(-1)
    keep = rs.nonzero_rows(rows)
    nz = int(keep.sum())
    with torch.no_grad():
        got = rs.gather_backward(g, idx, n)
        again = rs.gather_backward(g, idx, n)
        cpu = rs.rank_sum_ref(rows.cpu(), flat.cpu(), n)
        plain = rs.rank_sum_ref(rows, flat, n)
        aten = torch.zeros_like(dx).index_put_((flat,), rows,
                                               accumulate=True)
        torch.cuda.synchronize()
    for what, other in (("the step's", dx), ("a second launch's", again),
                        ("the CPU plain version's", cpu)):
        if not torch.equal(bits(got.cpu()), bits(other.cpu())):
            raise AssertionError(f"gather backward: not {what} bits")
    rel = rel_err(got, plain, "gather backward against the plain version")
    rel_a = rel_err(got, aten, "gather backward against ATen's x[idx] "
                    "backward")
    err = (got - plain).abs().max().item()
    runs_all = int(torch.bincount(flat, minlength=n).max())
    runs_kept = int(torch.bincount(flat[keep], minlength=n).max()) \
        if nz else 0
    acc = torch.zeros_like(dx)
    t = {"kernel": cuda_ms(lambda: rs.gather_backward(g, idx, n), 20),
         "plain": cuda_ms(lambda: rs.rank_sum_ref(rows, flat, n), 20),
         "library": cuda_ms(lambda: acc.index_put_((flat,), rows,
                                                   accumulate=True), 20),
         "kernel_dev": queued_ms(lambda: rs.gather_backward(g, idx, n), 20)}
    # what the sum needs: every cotangent row read once (to find the zero
    # ones), the kept rows' indices, the [n, C] output written; one add a
    # kept element
    nbytes = (rows.numel() * rows.element_size()
              + nz * flat.element_size() + n * width * 4)
    bound = bound_ms(nbytes, nz, (width, 0))
    log(f"gather backward at phase 5's fired step: {rows.shape[0]} rows "
        f"({nz} not all zero) of {width} into {n}, longest run {runs_all} "
        f"rows ({runs_kept} once the zero rows are dropped); bit-equal to "
        f"the step's, a second launch's and the CPU plain version's; rel "
        f"err {rel:.3g} against the card's plain version, {rel_a:.3g} "
        f"against ATen's x[idx] backward; wrapper {t['kernel']:.4f} ms "
        f"(device {t['kernel_dev']:.4f}), plain {t['plain']:.4f} ms, ATen's "
        f"backward {t['library']:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
    extra = {"at": "phase 5's fired step", "rows": rows.shape[0],
             "rows_not_zero": nz, "outputs": n, "longest_run": runs_all,
             "longest_run_kept": runs_kept}
    return (err, (t["kernel"], t["plain"], t["library"], t["kernel_dev"]),
            bound, extra)


def phase_orientation_path(tmp: str, scan: str, profile_dir=None):
    log(f"== phase 5: orientation path, {ORIENT_EPOCHS} epochs of "
        f"ABC_DexiNed on the same scan; cuts: "
        + ", ".join(f"{k}={v}" for k, v in ORIENT_CUTS.items())
        + f", if_cull_wayward=true, cull_wayward_apply=true, "
        f"cull_wayward_at_epoch=[{WAYWARD_EPOCH}]; view step "
        f"{ORIENT_DET_STEP} (direction and ratio fire) run twice from the "
        "same state")
    with step_twice(ORIENT_DET_STEP) as runs:
        text, launches, out_dir, cfg_path = train_cli_run(
            tmp, scan, ORIENT_EPOCHS, "orient", profile_dir,
            orient=ORIENT_CUTS, if_cull_wayward=True,
            cull_wayward_apply=True, cull_wayward_at_epoch=[WAYWARD_EPOCH])
    # the doubled step hands Adam the projection's, the direction's and
    # the ratio's gradients, in that order, asks for neighbours once and
    # runs the direction loss's gather backward once
    names = check_twice(runs, ORIENT_DET_STEP,
                        need=("grad", "adam 2", "knn 0", "gather 0", "mu",
                              "nu"))
    rows = epoch_lines(text, ORIENT_EPOCHS)
    fires = direction_fires(ORIENT_EPOCHS, VIEWS,
                            ORIENT_CUTS["start_dir_loss_at_epoch"])
    views = ORIENT_EPOCHS * VIEWS + 1
    # the row sum: one a compositor backward, and one a direction fire
    # (the backward of its neighbour gather, counted apart), the doubled
    # fire's included
    expected = no_launches(segpair_fwd=views, segpair_bwd=views,
                           rank_sum=views, rank_sum_gather=fires + 1,
                           knn=fires + 2)
    if launches != expected:
        raise AssertionError(f"launches {launches} on the orientation path, "
                             f"expected {expected} ({fires} direction "
                             "fires + 1 wayward cull + the doubled fire)")
    log(f"orientation determinism ok: view step {ORIENT_DET_STEP} run twice "
        f"bit-equal in {len(names)} tensors (gradients of the projection, "
        "direction and ratio steps, kNN indices, the gather backward's "
        "inputs and output, parameters, Adam moments, absgrads)")
    gather = gather_backward_check(runs[0])
    alive = [r[1] for r in rows]
    # an epoch line reports alive before that epoch's density event
    if not alive[WAYWARD_EPOCH + 1] < alive[WAYWARD_EPOCH] == alive[0]:
        raise AssertionError(f"alive per epoch {alive}: no fall at the "
                             f"wayward cull of epoch {WAYWARD_EPOCH}")
    with np.load(os.path.join(out_dir, f"epoch{ORIENT_EPOCHS - 1}.npz")) \
            as ck:
        n_alive = int(ck["f:.gaussians.alive"].sum())
    n = check_outputs(out_dir, ORIENT_EPOCHS, n_alive)
    log(f"orientation path ok: losses={[r[0] for r in rows]} alive={alive} "
        f"launches={launches} ply={n} Gaussians")
    downstream(tmp, scan, cfg_path, out_dir, "orient")
    return launches, [r[2] for r in rows[1:]], gather


def phase_other_paths(tmp: str, scan: str, profile_dir=None):
    """Phase 6: the recipe on each other render path; returns each path's
    launches and steady-epoch Mpx/s."""
    views = EPOCHS * VIEWS
    expected = {
        "pair_v4": no_launches(pair_fwd=views, pair_bwd=views,
                               rank_sum=views),
        "single_v1": no_launches(raster_v1_fwd=views, raster_v1_bwd=views,
                                 rank_sum=views),
        "pair_prefix": no_launches(raster_v2_fwd=2 * views,
                                   raster_v2_bwd=2 * views, rank_sum=views),
    }
    out = {}
    for path, model in OTHER_PATHS.items():
        log(f"== phase 6 ({path}): {EPOCHS} epochs of ABC_DexiNed on the "
            "same scan; cuts: " + ", ".join(f"{k}={v}" for k, v in
                                            model.items()))
        text, launches, out_dir, _ = train_cli_run(
            tmp, scan, EPOCHS, path, profile_dir, **model)
        rows = epoch_lines(text, EPOCHS)
        if launches != expected[path]:
            raise AssertionError(f"launches {launches} on the {path} path, "
                                 f"expected {expected[path]}")
        with open(RECIPE) as f:
            n_seed = json.load(f)["model"]["init_min_num_gaussians"]
        n = check_outputs(out_dir, EPOCHS, n_seed)
        pxs = [r[2] for r in rows[1:]]
        log(f"{path} path ok: losses={[r[0] for r in rows]} "
            f"launches={launches} ply={n} Gaussians, steady epochs {pxs} "
            "Mpx/s")
        out[path] = (launches, pxs)
    return out


def phase_band_mode(device):
    """Phase 7a: four bands of each fixture camera against its full render
    at the seg recipe's settings; returns the band renders' launches."""
    from edgegaussians_tpu_torch.models import losses
    from edgegaussians_tpu_torch.ops import segpair
    from edgegaussians_tpu_torch.ops.rasterize import rasterize
    from edgegaussians_tpu_torch.parallel import bands
    d = np.load(FIXTURE)
    w, h = int(d["width"]), int(d["height"])
    rows_per, band_h, pad_h = bands.band_geometry(w, h, 16, BANDS)
    log(f"== phase 7a: band mode on the card, 5 fixture cameras at "
        f"800x800 in {BANDS} bands of {rows_per} tile rows (padded height "
        f"{pad_h}), seg path at cap {CAP}, budget {BUDGET}")
    n = d["means"].shape[0]
    base = [torch.from_numpy(d[k].astype(np.float32)).to(device)
            for k in ("means", "quats", "scales")]
    base.append(torch.from_numpy(d["opacities"].astype(np.float32))
                .reshape(-1).to(device))
    kw = dict(tile_size=16, capacity=min(CAP, n), pair_budget=BUDGET,
              pair_kernel="seg", max_tiles_per_gaussian=16)
    gen = torch.Generator(device=device).manual_seed(4)
    names = ("means", "quats", "scales", "opacities")
    worst = {"image": 0.0, "loss": 0.0, "grads": 0.0, "absgrad": 0.0}

    def render(params, vm, K, sink, **band):
        return rasterize(*params, vm, K, w, h, absgrad_sink=sink, **kw,
                         **band)

    cams = []
    for c in range(d["viewmats"].shape[0]):
        vm = torch.from_numpy(d["viewmats"][c]).to(device)
        K = torch.from_numpy(d["Ks"][c]).to(device)
        gt = torch.rand((h, w), generator=gen, device=device)
        em = gt >= 0.5
        scores = torch.rand(h * w, generator=gen, device=device)
        params = [x.clone().requires_grad_() for x in base]
        sink = torch.zeros((n, 2), device=device, requires_grad=True)
        out = render(params, vm, K, sink)
        pred = torch.clamp(out.image, 0.0, 1.0)
        full_losses = torch.stack([
            losses.projection_loss_whole(pred, gt),
            losses.projection_loss_bg_edge_ratio(pred, gt, em, 1.0, scores),
            losses.projection_loss_weighted(pred, gt,
                                            losses.compute_weight_mask(em))])
        full_grads = torch.autograd.grad(full_losses.sum(), params + [sink])
        cams.append((vm, K, gt, em, scores, out.image.detach(),
                     full_losses.detach(), full_grads))
    torch.cuda.synchronize()
    for mod in kernel_modules():
        mod.reset_launch_counts()
    for c, (vm, K, gt, em, scores, full_img, full_losses,
            full_grads) in enumerate(cams):
        params = [x.clone().requires_grad_() for x in base]
        imgs, band_losses = [], torch.zeros(3, device=device)
        grads = [torch.zeros_like(g) for g in full_grads]
        for b in range(BANDS):
            y0 = b * band_h
            sink = torch.zeros((n, 2), device=device, requires_grad=True)
            out = render(params, vm, K, sink, band_row0=b * rows_per,
                         band_tile_rows=rows_per)
            pred = torch.clamp(out.image, 0.0, 1.0)
            gt_b, em_b, valid_b = bands.band_inputs(gt, em, y0, band_h,
                                                    pad_h, h, w)
            part = torch.stack([bands.band_partial_loss(
                pred, gt_b, em_b, valid_b, em, s, 1.0, scores,
                loss_type="l1", height=h, width=w, y0=y0, band_h=band_h,
                pad_h=pad_h) for s in range(3)])
            for acc, g in zip(grads, torch.autograd.grad(
                    part.sum(), params + [sink])):
                acc += g
            band_losses += part.detach()
            imgs.append(out.image.detach())
        torch.cuda.synchronize()
        e_img = (torch.cat(imgs)[:h] - full_img).abs().max().item()
        check_image(e_img, f"camera {c} bands")
        e_loss = ((band_losses - full_losses).abs()
                  / full_losses.abs()).max().item()
        if not e_loss <= 1e-5:
            raise AssertionError(f"camera {c}: band losses {band_losses} "
                                 f"vs full {full_losses}")
        e_grads = max(rel_err(a, b, f"camera {c} bands: {nm}")
                      for nm, a, b in zip(names, grads, full_grads))
        e_abs = rel_err(torch.linalg.vector_norm(grads[-1], dim=-1),
                        torch.linalg.vector_norm(full_grads[-1], dim=-1),
                        f"camera {c} bands: absgrad")
        for k, v in zip(worst, (e_img, e_loss, e_grads, e_abs)):
            worst[k] = max(worst[k], v)
        log(f"camera {c}: band image err {e_img:.3g}, losses rel "
            f"{e_loss:.3g} (full {[f'{x:.6f}' for x in full_losses.tolist()]}"
            f"), grads rel {e_grads:.3g}, absgrad rel {e_abs:.3g}")
    launches = {k: v for mod in kernel_modules()
                for k, v in mod.launch_counts.items()}
    bands_run = len(cams) * BANDS
    expected = no_launches(segpair_fwd=bands_run, segpair_bwd=bands_run,
                           rank_sum=bands_run)
    if launches != expected:
        raise AssertionError(f"launches {launches} of the band renders, "
                             f"expected {expected}")
    log(f"band mode ok: worst {worst}, launches {launches}")
    return launches


def shards(device, n: int = 1) -> list:
    """``n`` distinct seeded [SHARD_ROWS, 128] shards on ``device``."""
    gen = torch.Generator(device=device).manual_seed(6)
    return [torch.rand((SHARD_ROWS, 128), generator=gen, device=device)
            for _ in range(n)]


def cycling(fn, xs):
    """A call of ``fn`` on the next of ``xs`` at each call, round and
    round: with more bytes in ``xs`` than the L2 holds, each call's input
    comes from device memory."""
    it = itertools.cycle(xs)
    return lambda: fn(next(it))


def phase_shard_sum_kernel(device):
    """The shard-sum kernel on one [SHARD_ROWS, 128] shard against its
    plain version and the float64 sum; its time beside the plain
    version's, torch.sum's and the bytes bound, warm (the same shard, in
    L2) and cold (COLD_SHARDS shards cycled), by events and by the device
    time of queued calls. Returns the error, the times, the bound and the
    kernels line's further keys."""
    from edgegaussians_tpu_torch.ops import shard_sum
    log(f"== phase 7 (shard_sum): the shard-sum kernel vs its plain "
        f"version on a [{SHARD_ROWS}, 128] shard")
    xs = shards(device, COLD_SHARDS)
    x = xs[0]
    kern = shard_sum.shard_sum2x

    def lib(t):
        return torch.sum(t, 0, keepdim=True)
    with torch.no_grad():
        got = kern(x)
        again = kern(x)
        plain = shard_sum.shard_sum2x_ref(x)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("shard_sum: two launches differ")
        exact = (2.0 * x.double()).sum(0, keepdim=True)
        err = (got - plain).abs().max().item()
        rel = ((got.double() - exact).abs() / exact).max().item()
        if not rel <= 1e-5:
            raise AssertionError(f"shard_sum: {rel:.3g} from the float64 sum")
        ms = (cuda_ms(lambda: kern(x), 200),
              cuda_ms(lambda: shard_sum.shard_sum2x_ref(x), 200),
              cuda_ms(lambda: lib(x), 200),
              queued_ms(lambda: kern(x), 50))
        t = {"library_device_ms": queued_ms(lambda: lib(x), 50),
             "cold_ms": cuda_ms(cycling(kern, xs), 200),
             "cold_device_ms": queued_ms(cycling(kern, xs), 50),
             "library_cold_ms": cuda_ms(cycling(lib, xs), 200),
             "library_cold_device_ms": queued_ms(cycling(lib, xs), 50)}
    bound = bound_ms(x.numel() * 4 + 128 * 4, x.numel(), (1, 0))
    log(f"shard_sum: max_abs_err vs plain {err:.3g} (rel to float64 "
        f"{rel:.3g}), two launches bit-equal; warm: kernel {ms[0]:.4f} ms "
        f"(device {ms[3]:.4f} ms), plain {ms[1]:.4f} ms, torch.sum "
        f"{ms[2]:.4f} ms (device {t['library_device_ms']:.4f} ms); cold "
        f"({COLD_SHARDS} shards cycled): kernel {t['cold_ms']:.4f} ms "
        f"(device {t['cold_device_ms']:.4f} ms), torch.sum "
        f"{t['library_cold_ms']:.4f} ms (device "
        f"{t['library_cold_device_ms']:.4f} ms); bound {bound[0]:.4f} ms "
        f"({bound[1]}); device = calls queued behind a sleeping kernel")
    return err, ms, bound, {"shard_sum": t}


def shard_sum_device(device, traced: bool = False) -> dict:
    """The device times of the shard-sum kernel and of torch.sum on
    phase 7's shard, warm and cold (COLD_SHARDS shards cycled), from
    torch.profiler (run in phase 8, where every profiler window of the run
    is: see profiled_device), as keys of the kernels line; raises unless a
    call after the first is one device kernel, the shard-sum's."""
    from edgegaussians_tpu_torch.ops import shard_sum
    xs = shards(device, COLD_SHARDS)
    kern = shard_sum.shard_sum2x

    def lib(t):
        return torch.sum(t, 0, keepdim=True)
    with torch.no_grad():
        dev = {"kernel": profiled_device(lambda: kern(xs[0]), "shard_sum"),
               "kernel_cold": profiled_device(cycling(kern, xs),
                                              "shard_sum"),
               "torch.sum": profiled_device(lambda: lib(xs[0]), ""),
               "torch.sum_cold": profiled_device(cycling(lib, xs), "")}
        per_call, seen = one_kernel_per_call(lambda: kern(xs[0]),
                                             "shard_sum2x_kernel", traced)
    log("shard_sum device time (profiler): " + ", ".join(
        f"{k} {ms:.4f} ms ({n:.2f} activities per call)"
        for k, (ms, n) in dev.items())
        + f"; device activities per call {per_call:.2f} (records per "
        f"window: host launches, memsets or memcpys, kernel, other: {seen})")
    return {"profiler_device_ms": dev["kernel"][0],
            "profiler_cold_device_ms": dev["kernel_cold"][0],
            "library_profiler_device_ms": dev["torch.sum"][0],
            "library_profiler_cold_device_ms": dev["torch.sum_cold"][0]}


def phase_view_batch(tmp: str, scan: str):
    """Phase 7b: view batches in one process through the CLI."""
    epochs, batches = EPOCHS, VIEWS // VIEW_BATCH
    log(f"== phase 7b: view batches, {epochs} epochs of ABC_DexiNed on the "
        f"same scan; cuts: step_mode=view_batch, view_batch_size="
        f"{VIEW_BATCH}")
    text, launches, out_dir, _ = train_cli_run(
        tmp, scan, epochs, "view_batch",
        training=dict(step_mode="view_batch", view_batch_size=VIEW_BATCH))
    rows = epoch_lines(text, epochs)
    views = epochs * VIEWS
    expected = no_launches(segpair_fwd=views, segpair_bwd=views,
                           rank_sum=views)
    if launches != expected:
        raise AssertionError(f"launches {launches} on the view-batch path, "
                             f"expected {expected}")
    with np.load(os.path.join(out_dir, f"epoch{epochs - 1}.npz")) as ck:
        steps = int(ck["f:.step"])
    if steps != epochs * batches:
        raise AssertionError(f"{steps} batch steps, expected {batches} per "
                             "epoch")
    pxs = [r[2] for r in rows[1:]]
    log(f"view-batch path ok: losses={[r[0] for r in rows]} steps={steps} "
        f"launches={launches}, steady epochs {pxs} Mpx/s")
    return launches, pxs


def run_ranks(nproc: int, tag: str, out: str, cli_argv, dist_backend=None):
    """``scripts/torch_multiprocess_worker.py`` on ``nproc`` ranks of
    this card through :func:`torchrun`: the probe, then the CLI with
    ``cli_argv`` in the same group. Returns (rank 0's output, every
    rank's results)."""
    args = [WORKER, "--tasks", "cli", "--device", "cuda", "--out", out]
    if dist_backend:
        args += ["--dist_backend", dist_backend]
    text = torchrun(nproc, tag, args + ["--"] + cli_argv)
    results = []
    for r in range(nproc):
        with np.load(os.path.join(out, f"rank{r}.npz")) as d:
            results.append({k: d[k] for k in d.files})
    return text, results


def check_ranks_agree(results, tag: str) -> None:
    """Every rank's final state equal to rank 0's, bit for bit."""
    keys = [k for k in results[0] if k.startswith("cli:")]
    for r, res in enumerate(results[1:], 1):
        for k in keys:
            if not np.array_equal(res[k], results[0][k]):
                raise AssertionError(f"{tag}: rank {r}'s {k[4:]} differs "
                                     "from rank 0's")


def check_losses_match(rows, ref_rows, tag: str) -> float:
    """Epoch losses against the single-process run's: within
    MULTI_LOSS_RTOL relative plus the log's last printed digit."""
    worst = 0.0
    for e, (a, b) in enumerate(zip(rows, ref_rows)):
        diff = abs(a[0] - b[0])
        if diff > MULTI_LOSS_RTOL * abs(b[0]) + 1e-5:
            raise AssertionError(f"{tag}: epoch {e} loss {a[0]} vs "
                                 f"{b[0]} in one process")
        worst = max(worst, diff / abs(b[0]))
    return worst


def phase_multi_rank(tmp: str, scan: str):
    """Phase 7c: the sharded trainers on two ranks of the card (and the
    Gaussian-axis one on one NCCL rank), each against a single-process
    run of the same config. Returns the shard-sum probe's launches, its
    error and each run's steady-epoch Mpx/s."""
    cuts = ", ".join(f"{k}={v}" for k, v in
                     {**MULTI_ORIENT, **MULTI_MODEL}.items())
    batches = dict(step_mode="view_batch", view_batch_size=MULTI_BATCH)
    # name: (training cuts, ranks, 'views' axis, CLI flags, backend)
    runs = {
        "tiles": (dict(), 2, 1, ["--mesh_tiles", "2"], "gloo"),
        "gauss": (dict(), 2, 1, ["--mesh_gauss", "2"], "gloo"),
        "views": (batches, 2, 2, ["--mesh_views", "2"], "gloo"),
        "views_tiles": (batches, 4, 2, ["--mesh_views", "2", "--mesh_tiles",
                                        "2"], "gloo"),
        "gauss_nccl": (dict(), 1, 1, ["--mesh_gauss", "1"], None),
    }
    single = {}
    out = {}
    probe = None
    for name, (training, nproc, n_views, flags, backend) in runs.items():
        ref_tag = "multi_ref_views" if training else "multi_ref"
        if ref_tag not in single:
            log(f"== phase 7c ({ref_tag}): {EPOCHS} epochs in one process; "
                f"cuts: {cuts}" + (f", {training}" if training else ""))
            text, _, _, _ = train_cli_run(
                tmp, scan, EPOCHS, ref_tag, orient=MULTI_ORIENT,
                training=training, **MULTI_MODEL)
            single[ref_tag] = epoch_lines(text, EPOCHS)
        log(f"== phase 7c ({name}): {nproc} rank(s) on the card "
            f"({backend or 'nccl'}), {' '.join(flags)}, the same config")
        cfg, cfg_path = write_config(tmp, EPOCHS, f"multi_{name}",
                                     orient=MULTI_ORIENT, training=training,
                                     **MULTI_MODEL)
        t0 = time.time()
        text, results = run_ranks(
            nproc, name, os.path.join(tmp, f"ranks_{name}"),
            ["--config_file", cfg_path, "--scene_name", scan, "--backend",
             "cuda", "--force_rerun"] + flags, backend)
        wall = time.time() - t0
        rows = epoch_lines(text, EPOCHS)
        check_ranks_agree(results, name)
        with np.load(os.path.join(run_dir(cfg, scan),
                                  f"epoch{EPOCHS - 1}.npz")) as ck:
            for k in ck.files:
                if not np.array_equal(ck[k], results[0]["cli:" + k]):
                    raise AssertionError(f"{name}: the checkpoint's {k} "
                                         "is not rank 0's state")
        rel = check_losses_match(rows, single[ref_tag], name)
        per_rank = [json.loads(str(r["launches"])) for r in results]
        views = EPOCHS * VIEWS // n_views
        expected = no_launches(segpair_fwd=views, segpair_bwd=views,
                               rank_sum=views)
        for r, got in enumerate(per_rank):
            if got != expected:
                raise AssertionError(f"{name}: rank {r} launches {got}, "
                                     f"expected {expected}")
        sums = [r["probe_sum"] for r in results]
        plain = results[0]["probe_plain"]
        p_err = max(float(np.abs(s - plain).max()) for s in sums)
        p_rel = max(float((np.abs(s - plain) / np.abs(plain)).max())
                    for s in sums)
        if not p_rel <= 1e-5 or any(int(r["probe_launches"]) != 1
                                    for r in results):
            raise AssertionError(f"{name}: the shard-sum probe under "
                                 f"all-reduce is {p_rel:.3g} from plain")
        collectives = json.loads(str(results[0]["collectives"]))
        alive = [r[1] for r in rows]
        pxs = [r[2] for r in rows[1:]]
        log(f"{name} ok in {wall:.1f}s (process start included): losses="
            f"{[r[0] for r in rows]} (one process "
            f"{[r[0] for r in single[ref_tag]]}, worst rel {rel:.3g}) "
            f"alive={alive} ranks bit-equal, launches per rank "
            f"{per_rank[0]}, probe all-reduced err {p_err:.3g} "
            f"(rel {p_rel:.3g}) in {nproc} rank(s), steady epochs {pxs} "
            f"Mpx/s; {backend or 'nccl'} on CUDA tensors: {collectives}")
        out[name] = (pxs, sum(int(r["probe_launches"]) for r in results),
                     p_err)
        if probe is None and nproc > 1:
            probe = out[name][1:]
    return out, probe


def lab_modules():
    """The kernel lab's modules, each with its ``launch_counts``."""
    from edgegaussians_tpu_torch.lab import chunked, probes
    return (chunked, probes)


def lab_script(name: str):
    """``scripts/<name>.py``, one of the lab's entry points, as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_lab_path():
    """Phase 8, the lab path: the lab's three entry points on the card,
    every launch count set to 0 just before and read just after; their
    gates. Returns the lab kernels' launches."""
    log("== phase 8: the kernel lab's entry points on the card (the JAX "
        "labs' scene: 20000 Gaussians, 800x800, k1 128, k2 384, t2 625)")
    scripts = {name: lab_script(name) for name in LAB_SCRIPTS}
    for mod in kernel_modules() + lab_modules():
        mod.reset_launch_counts()
    t0 = time.time()
    kl = scripts["torch_kernel_lab"].main([])
    cl = scripts["torch_cumprod_lab"].main([])
    pr = scripts["torch_segpair_probe"].main([])
    torch.cuda.synchronize()
    launches = {k: v for mod in lab_modules()
                for k, v in mod.launch_counts.items()}
    log(f"lab path in {time.time() - t0:.1f}s, launches {launches}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"lab kernels never launched on the lab path: "
                             f"{idle}")
    check_image(kl["fwd_err"], "V3 vs V0")
    if not kl["t_out_rel"] <= 1e-5:
        raise AssertionError(f"V3 vs V0: t_out {kl['t_out_rel']:.3g}")
    if not kl["bwd_rel"] <= GRAD_RTOL_OF_MAX:
        raise AssertionError(f"V3 vs V0: dfeats {kl['bwd_rel']:.3g} of "
                             "max-abs")
    # the port's two-level scan is the cumulative product: held to v3;
    # logsum is a different rounding of it and noscan a different
    # function, both only printed
    check_image(cl["err_vs_v3"]["twolevel"], "twolevel vs v3")
    failed = [k for k, v in pr.items() if not math.isfinite(v)]
    if failed:
        raise AssertionError(f"probes failed: {failed}")
    return launches


def lab_work(sc):
    """(fwd bytes, bwd bytes, evaluations) of the chunked kernels over both
    levels: the whole frames (the kernels read every slot), basis and
    [T,256] planes read once, outputs written once; the evaluations a
    compositor needs, sum of min(count, K) x 256."""
    from edgegaussians_tpu_torch.lab import scene
    t1, k1 = sc.feats1.shape[:2]
    t2, k2 = sc.feats2.shape[:2]
    frames = (t1 * k1 + t2 * k2) * 32
    plane = (t1 + t2) * 256 * 4
    common = frames + 2 * sc.basis.numel() * 4 + t2 * 256 * 4   # + t_in2
    evals = (scene.live_evaluations(sc.counts1, k1)
             + scene.live_evaluations(sc.counts2, k2))
    # fwd: img + t_out; bwd: g + total in, prior2 in, dfeats out
    return (common + 2 * plane, common + 2 * plane + t2 * 256 * 4 + frames,
            evals)


def phase_lab_kernels(device, traced: bool = False):
    """Phase 8, each lab kernel against its plain version on the lab
    scene (level 1, then level 2 fed the plain level 1's t_out) and each
    probe against its plain version and the oracle; their times.
    ``traced``: earlier phases ran under torch.profiler (one_kernel_per_call
    then counts host records). Returns errors, times, bounds and the
    kernels line's further keys."""
    from edgegaussians_tpu_torch.lab import chunked, probes, scene
    log("== phase 8: lab kernels vs plain versions on the lab scene, "
        "level 1 and level 2")
    sc = scene.bench_scene(device=device)
    basis, f1, f2, rows = sc.basis, sc.feats1, sc.feats2, sc.rows2
    gen = torch.Generator(device=device).manual_seed(8)
    g1 = torch.rand((f1.shape[0], 256), generator=gen, device=device)
    err, ms, bounds = {}, {}, {}
    with torch.no_grad():
        ref1, tref1 = chunked.chunked_fwd_ref(f1, basis)
        tin2 = tref1[rows].contiguous()
        ref2, _ = chunked.chunked_fwd_ref(f2, basis, tin2)
        total = ref1.clone()
        total[rows] += ref2
        g2, prior2, total2 = (x[rows].contiguous() for x in (g1, ref1, total))
        for scan in chunked.SCANS:
            tol = LOGSUM_TOL if scan == "logsum" else IMG_ATOL
            outs = [(chunked.chunked_fwd(f1, basis, scan=scan),
                     chunked.chunked_fwd_ref(f1, basis, scan=scan)),
                    (chunked.chunked_fwd(f2, basis, tin2, scan=scan),
                     chunked.chunked_fwd_ref(f2, basis, tin2, scan=scan))]
            again = [chunked.chunked_fwd(f1, basis, scan=scan),
                     chunked.chunked_fwd(f2, basis, tin2, scan=scan)]
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for (k, _), a in zip(outs, again)
                       for x, y in zip(k, a)):
                raise AssertionError(f"lab_fwd_{scan}: two launches differ")
            e_img = max((k[0] - r[0]).abs().max().item() for k, r in outs)
            check_image(e_img, f"lab_fwd_{scan}", tol)
            e_t = max(check_t_out(k[1], r[1], f"lab_fwd_{scan} level {i + 1}",
                                  rtol=tol) for i, (k, r) in enumerate(outs))
            err[f"lab_fwd_{scan}"] = e_img
            log(f"lab_fwd_{scan}: img_err={e_img:.3g} t_out_rel={e_t:.3g}")
        d = [(chunked.chunked_bwd(f1, basis, g1, None, None, total),
              chunked.chunked_bwd_ref(f1, basis, g1, None, None, total)),
             (chunked.chunked_bwd(f2, basis, g2, tin2, prior2, total2),
              chunked.chunked_bwd_ref(f2, basis, g2, tin2, prior2, total2))]
        again = [chunked.chunked_bwd(f1, basis, g1, None, None, total),
                 chunked.chunked_bwd(f2, basis, g2, tin2, prior2, total2)]
        torch.cuda.synchronize()
        if not all(torch.equal(k, a) for (k, _), a in zip(d, again)):
            raise AssertionError("lab_bwd_v3: two launches differ")
        rel = max(rel_err(k, r, f"lab_bwd_v3 level {i + 1}")
                  for i, (k, r) in enumerate(d))
        err["lab_bwd_v3"] = max((k - r).abs().max().item() for k, r in d)
        log(f"lab_bwd_v3: dfeats_err={err['lab_bwd_v3']:.3g} "
            f"dfeats_rel={rel:.3g}")

        fwd_b, bwd_b, evals = lab_work(sc)
        walked = (f1.shape[0] * f1.shape[1] + f2.shape[0] * f2.shape[1]) * 256
        log(f"lab scene, both levels: {evals} live slot-pixel evaluations "
            f"of {walked} walked, {fwd_b / 1e6:.2f} MB (fwd) / "
            f"{bwd_b / 1e6:.2f} MB (bwd)")

        def fwd(f, scan):
            return lambda: (f(f1, basis, scan=scan),
                            f(f2, basis, tin2, scan=scan))
        # events over back-to-back calls, the plain version's, none for a
        # library, and the device time of calls queued behind a sleeping
        # kernel: a call of both levels may take less device time than its
        # two wrappers' host work
        for scan in chunked.SCANS:
            name = f"lab_fwd_{scan}"
            ms[name] = (cuda_ms(fwd(chunked.chunked_fwd, scan), 20),
                        cuda_ms(fwd(chunked.chunked_fwd_ref, scan), 2), None,
                        queued_ms(fwd(chunked.chunked_fwd, scan), 20))
            bounds[name] = bound_ms(fwd_b, evals, FWD_OPS)

        def bwd(f):
            return lambda: (f(f1, basis, g1, None, None, total),
                            f(f2, basis, g2, tin2, prior2, total2))
        ms["lab_bwd_v3"] = (cuda_ms(bwd(chunked.chunked_bwd), 20),
                            cuda_ms(bwd(chunked.chunked_bwd_ref), 2), None,
                            queued_ms(bwd(chunked.chunked_bwd), 20))
        bounds["lab_bwd_v3"] = bound_ms(bwd_b, evals, BWD_OPS)
        for name in [f"lab_fwd_{s}" for s in chunked.SCANS] + ["lab_bwd_v3"]:
            log(f"{name}: kernel {ms[name][0]:.4f} ms (device "
                f"{ms[name][3]:.4f} ms), plain {ms[name][1]:.4f} ms, bound "
                f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), both levels")

        p_err, p_ms, p_bounds, extra = phase_lab_probes(device, traced)
    err.update(p_err)
    ms.update(p_ms)
    bounds.update(p_bounds)
    return err, ms, bounds, extra


def probe_library(name: str, t):
    """One PyTorch call computing case ``name``'s function on its inputs
    (built beforehand), or None where none does: torch.roll alone lacks
    the add, and no call keeps a buffer across steps."""
    from edgegaussians_tpu_torch.lab import probes
    case = probes.CASES[name]
    if case.probe == "onehot":
        ids = torch.arange(t["r8"].shape[1], device=t["r8"].device,
                           dtype=torch.float32)
        onehot = (ids[:, None] == t["r8"][0][None, :]).to(torch.float32)
        return lambda: onehot @ t["c"]
    if case.probe == "transpose":
        return lambda: t["x"].t().contiguous()
    if case.probe in ("dyn_read", "dyn_write"):
        offs = t["offs"].tolist()
        idx = torch.cat([torch.arange(o, o + 128, device=t["offs"].device)
                         for o in offs])
        if case.probe == "dyn_read":   # the windows' rows, without the x2
            return lambda: torch.index_select(t["src"], 0, idx)
        out = torch.zeros((512, 256), device=t["offs"].device)
        vals = torch.rand((idx.shape[0], 256), device=t["offs"].device)
        return lambda: out.index_copy_(0, idx, vals)
    return None


def probe_bytes(probe: str, t, out) -> int:
    """The bytes a probe's function must move on inputs ``t`` with result
    ``out``: what it reads once and writes once. dyn_read reads and writes
    only its windows, dyn_write writes its whole array (the port's
    function zeroes the rows outside the windows, which the script leaves
    undefined), onehot reads only row 0 of the segment ids; the other
    probes read every input."""
    offs = t["offs"].numel() * 4 if "offs" in t else 0
    if probe == "dyn_read":           # each window read, then written x2
        return offs + 2 * out.numel() * 4
    if probe == "dyn_write":          # the whole array, zero outside
        return offs + out.numel() * 4
    if probe == "onehot":
        return (t["r8"].shape[1] + t["c"].numel() + out.numel()) * 4
    return sum(x.numel() * x.element_size() for x in t.values()) \
        + out.numel() * 4


def profiled_device(fn, kernel_name: str, calls: int = 50):
    """(device ms per call of the kernels whose name holds
    ``kernel_name`` ("" for every activity of the call), device activities
    per call: kernels, fills and copies of any name), from torch.profiler
    over ``calls`` calls: at the probes' sizes a call's CUDA-event time is
    its host dispatch. (0.0, 0.0) if the profiler saw no device activity.

    Each window must come after the in-process training phases: on the
    H100 machine, once a window had run before them, every window after
    them lost device records (39-43 of 50 probe kernels). A window with
    fewer kernel records than host launch records (CUPTI drops them now
    and then) is read again, up to PROFILED_WINDOWS windows; in a traced
    run every window is short, and the last one's figures are returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILED_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        if window_counts(prof.events())[1] is not None:
            break
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in device
             if kernel_name in e.key)
    return us / calls / 1e3, sum(e.count for e in device) / calls


def profiler_records(fn, kernel_name: str, calls: int) -> tuple:
    """(host runtime launch records, host memset or memcpy records,
    device records of kernels whose name holds ``kernel_name``, any other
    device records: kernels, fills, copies) in one torch.profiler window
    over ``calls`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = moves = named = other = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if kernel_name in e.name:
                named += 1
            else:
                other += 1
        elif "LaunchKernel" in e.name:
            launches += 1
        elif "Memset" in e.name or "Memcpy" in e.name:
            moves += 1
    return launches, moves, named, other


def one_kernel_per_call(fn, kernel_name: str, host_records: bool = False,
                        calls: int = 50,
                        windows: int = PROFILED_WINDOWS) -> tuple:
    """Device activities per call of ``fn`` and the record counts (host
    launches, host memsets or memcpys, device records of the kernel,
    other device records) of each window read. Raises unless a window
    holds exactly one device record of ``kernel_name`` per call and no
    other device record. Any other activity (a fill, a copy) or more than
    one kernel a call raises at once. A window short of records and
    holding nothing else is read again, up to ``windows`` windows: CUPTI
    drops device records now and then (49 of 50 kernels in one window on
    the H100 machine), and a dropped record cannot be told from a call
    that launched nothing.

    ``host_records`` (for a run whose earlier phases were traced, after
    which every window lost device records: 39 of 50 on the H100
    machine) reads one window and counts the launches on the host's
    records instead: exactly one runtime launch record a call and no
    memset or memcpy record; every device record that comes through must
    still be the kernel's, at most one a call."""
    seen = []
    for _ in range(1 if host_records else windows):
        launches, moves, named, other = counts = profiler_records(
            fn, kernel_name, calls)
        seen.append(counts)
        if moves or other or named > calls or (
                host_records and launches != calls):
            raise AssertionError(
                f"{kernel_name}: {launches} host launch records, {moves} "
                f"memset or memcpy records, {named} kernel and {other} "
                f"other device records over {calls} calls, expected one "
                "kernel a call")
        if host_records or named == calls:
            return named / calls, seen
    raise AssertionError(
        f"{kernel_name}: short of one kernel record a call in each of "
        f"{windows} profiler windows of {calls} calls (host launches, "
        f"memsets or memcpys, kernel, other): {seen}")


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls, on
    time.perf_counter_ns, started after torch.cuda.synchronize()."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    us = (time.perf_counter_ns() - t0) / calls / 1e3
    torch.cuda.synchronize()
    return us


def probe_host_split(device, traced: bool = False) -> dict:
    """Phase 8: the host cost of a dyn_write and a dyn_read call (the
    script's runs P4 and P5), part by part, in microseconds per call over
    HOST_CALLS calls: the argument checks, the allocation, the stream
    lookup, the ctypes call with its launch, and the whole wrapper; beside
    each part the form it replaced (torch.zeros, a torch.cuda.Stream
    object, prototypes set at every call), and the device activities per
    wrapper call from the profiler. Raises unless that is one kernel."""
    from edgegaussians_tpu_torch.lab import probes
    from edgegaussians_tpu_torch.ops import _build
    t = {p: probes.case_tensors(name, device) for p, name in
         (("dyn_write", "P4 dyn-offset-DMA-write"),
          ("dyn_read", "P5 dyn-offset-DMA-read"))}
    offs_w, offs_r, src = t["dyn_write"]["offs"], t["dyn_read"]["offs"], \
        t["dyn_read"]["src"]
    rows, cols, win = 512, 256, 128            # the script's P4 array
    dev = offs_w.device                        # with its index
    out_w = torch.empty((rows, cols), device=dev)
    out_r = torch.empty((offs_r.shape[0] * win, src.shape[1]), device=dev)
    stream = _build.stream(dev)
    cases = {
        "dyn_write": dict(
            checks=lambda: (probes._check_offs(offs_w, offs_w.device),
                            probes._check_windows(win, cols)),
            shape=out_w.shape,
            args=(offs_w.data_ptr(), out_w.data_ptr(), offs_w.shape[0], win,
                  rows, cols, stream),
            call=lambda: probes.probe_dyn_write(offs_w, rows, cols, win)),
        "dyn_read": dict(
            checks=lambda: (probes._check_2d("src", src),
                            probes._check_offs(offs_r, src.device),
                            probes._check_windows(win, src.shape[1]),
                            src.data_ptr() % 16),
            shape=out_r.shape,
            args=(offs_r.data_ptr(), src.data_ptr(), out_r.data_ptr(),
                  offs_r.shape[0], win, src.shape[0], src.shape[1], stream),
            call=lambda: probes.probe_dyn_read(src, offs_r, win)),
    }
    split = {}
    for p, c in cases.items():
        name = f"probe_{p}"
        argtypes = probes.ARGTYPES[name]

        def per_call_prototypes():      # the replaced launch path
            fn = getattr(_build.load("lab_probes"), name)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            return fn(*c["args"])

        us = {
            "checks": host_us(c["checks"]),
            "alloc_empty": host_us(lambda: torch.empty(
                c["shape"], dtype=torch.float32, device=dev)),
            "alloc_zeros": host_us(lambda: torch.zeros(
                c["shape"], dtype=torch.float32, device=dev)),
            "stream_raw": host_us(lambda: _build.stream(dev)),
            "stream_object": host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "ctypes_launch": host_us(lambda: _build.launch(
                "lab_probes", name, argtypes, c["args"])),
            "ctypes_launch_per_call_prototypes": host_us(
                per_call_prototypes),
            "wrapper": host_us(c["call"]),
        }
        per_call, seen = one_kernel_per_call(c["call"], name, traced)
        us["device_activities_per_call"] = per_call
        split[p] = us
        log(f"{name} host us per call ({HOST_CALLS} calls each): checks "
            f"{us['checks']:.3f}, allocation torch.empty "
            f"{us['alloc_empty']:.3f} (torch.zeros {us['alloc_zeros']:.3f}),"
            f" stream lookup raw {us['stream_raw']:.3f} (Stream object "
            f"{us['stream_object']:.3f}), ctypes call + launch "
            f"{us['ctypes_launch']:.3f} (prototypes set per call "
            f"{us['ctypes_launch_per_call_prototypes']:.3f}), whole wrapper "
            f"{us['wrapper']:.3f}; device activities per call "
            f"{per_call:.2f} (profiler; records per window: host launches, "
            f"memsets or memcpys, kernel, other: {seen})")
    return split


def probe_floor_call(probe: str, device):
    """A call of the script's runs of ``probe`` (roll or transpose) on one
    16-byte vector each: roll [1, 4] by 2 on axis 0 and on axis 1 (two
    launches, as the script's P1 and P2), transpose [4, 4] (one, as P6).
    One CTA doing one vector: the kernel's floor of a launch."""
    from edgegaussians_tpu_torch.lab import probes
    if probe == "roll":
        x = torch.arange(4, dtype=torch.float32, device=device).view(1, 4)
        return lambda: [probes.probe_roll(x, 2, axis) for axis in (0, 1)]
    x = torch.arange(16, dtype=torch.float32, device=device).view(4, 4)
    return lambda: probes.probe_transpose(x)



def phase_lab_probes(device, traced: bool = False):
    """Each probe kernel on the script's runs against its plain version
    and the oracle; per probe the times of its runs, summed, beside the
    bytes bound and the library call's, and its device time from the
    profiler: its kernel's and every activity of its calls' (a key of the
    kernels line beyond the contract's, as are the shard-sum's device
    times, shard_sum_device). For roll and transpose also the launch
    floor: the kernel's device time on the same runs at one 16-byte
    vector each (probe_floor_call; ``floor_device_ms``)."""
    from edgegaussians_tpu_torch.lab import probes
    err, ms, bounds, extra = {}, {}, {}, {}
    per = {p: [0.0, 0.0, 0.0, 0.0, True, 0.0, 0.0, 0.0]
           for p in probes.PROBES}
    for name, case in probes.CASES.items():
        out_k, e_k, tol = probes.run_case(name, device)
        out_r, e_r, _ = probes.run_case(name, device, plain=True)
        torch.cuda.synchronize()
        if not (e_k <= tol and e_r <= tol):
            raise AssertionError(f"{name}: oracle error kernel {e_k:.3g}, "
                                 f"plain {e_r:.3g} > {tol}")
        key = f"probe_{case.probe}"
        err[key] = max(err.get(key, 0.0),
                       (out_k - out_r).abs().max().item())
        t = probes.case_tensors(name, device)
        kern, plain = probes.KERNELS[case.probe]
        lib = probe_library(name, t)
        acc = per[case.probe]
        acc[0] += cuda_ms(lambda: case.call(kern, t), 200)
        acc[1] += cuda_ms(lambda: case.call(plain, t), 200)
        if lib is None:
            acc[4] = False
        else:
            acc[2] += cuda_ms(lib, 200)
            # every device activity of the call, whatever its kernels' names
            acc[6] += profiled_device(lib, "")[0]
        acc[3] += probe_bytes(case.probe, t, out_k)
        acc[5] += profiled_device(lambda: case.call(kern, t),
                                  f"probe_{case.probe}_kernel")[0]
        acc[7] += profiled_device(lambda: case.call(kern, t), "")[0]
        log(f"{name}: oracle error kernel {e_k:.3g} plain {e_r:.3g}, kernel "
            f"vs plain {(out_k - out_r).abs().max().item():.3g}")
    for p, (k_ms, p_ms, l_ms, nbytes, has_lib, dev_ms, l_dev, call_dev) in \
            per.items():
        key = f"probe_{p}"
        ms[key] = (k_ms, p_ms, l_ms if has_lib else None, dev_ms or None)
        extra[key] = {"call_device_ms": call_dev or None}
        bounds[key] = bound_ms(nbytes, 0, (0, 0))
        log(f"{key}: kernel {k_ms:.4f} ms (device "
            + (f"{dev_ms:.4f} ms, every activity of the call {call_dev:.4f}"
               f" ms" if dev_ms > 0 else "not measured")
            + f", profiler), plain {p_ms:.4f} ms, library "
            + (f"{l_ms:.4f} ms (device {l_dev:.4f} ms, profiler)"
               if has_lib else "none")
            + f", bound {bounds[key][0]:.5f} ms ({bounds[key][1]}; "
            f"{nbytes / 1e6:.3f} MB)")
    onehot_device(device, per["onehot"][5], per["onehot"][6], traced)
    vmem_dyn_device(device, traced)
    probe_host_split(device, traced)
    extra["shard_sum"] = shard_sum_device(device, traced)
    for p in FLOOR_PROBES:      # windows of their own, after the checks'
        key = f"probe_{p}"
        f_ms = launch_floor_ms(p, device)
        extra[key]["floor_device_ms"] = f_ms or None
        log(f"{key}: device {per[p][5]:.5f} ms over the script's runs, "
            + (f"launch floor {f_ms:.5f} ms (the same runs at one 16-byte "
               "vector each)" if f_ms > 0 else "launch floor not measured")
            + f", bound {bounds[key][0]:.5f} ms (profiler)")
    return err, ms, bounds, extra


def launch_floor_ms(probe: str, device, windows: int = 3) -> float:
    """The profiler's device time of probe_floor_call(probe): a window
    that saw no record of the kernel (CUPTI drops records in bursts) is
    read again, up to ``windows`` windows; 0.0 if none saw one."""
    for _ in range(windows):
        ms = profiled_device(probe_floor_call(probe, device),
                             f"probe_{probe}_kernel")[0]
        if ms > 0:
            return ms
    return 0.0


def vmem_dyn_device(device, traced: bool = False) -> None:
    """Phase 8: each of the vmem_dyn probe's runs (P7a, P7b) launches one
    device kernel a call and nothing else; raises otherwise."""
    from edgegaussians_tpu_torch.lab import probes
    for name, case in probes.CASES.items():
        if case.probe != "vmem_dyn":
            continue
        t = probes.case_tensors(name, device)
        per_call, seen = one_kernel_per_call(
            lambda: case.call(probes.probe_vmem_dyn, t),
            "probe_vmem_dyn_kernel", traced)
        log(f"{name}: device activities per call {per_call:.2f} "
            f"(profiler; records per window: host launches, memsets or "
            f"memcpys, kernel, other: {seen})")


def onehot_device(device, dev_ms: float, lib_dev_ms: float,
                  traced: bool = False) -> None:
    """Phase 8: the onehot probe (the script's run P3) launches one device
    kernel a call and nothing else, and its device time is below that of
    ``onehot @ c`` on the same inputs (both from the profiler windows of
    phase_lab_probes); raises otherwise."""
    from edgegaussians_tpu_torch.lab import probes
    t = probes.case_tensors("P3 onehot-matmul", device)
    per_call, seen = one_kernel_per_call(
        lambda: probes.probe_onehot(t["r8"], t["c"]), "probe_onehot", traced)
    log(f"probe_onehot: device activities per call {per_call:.2f} "
        f"(profiler; records per window: host launches, memsets or "
        f"memcpys, kernel, other: {seen}); device {dev_ms:.4f} ms against "
        f"onehot @ c {lib_dev_ms:.4f} ms")
    if not 0.0 < dev_ms < lib_dev_ms:
        raise AssertionError(f"probe_onehot: device {dev_ms:.4f} ms, not "
                             f"below onehot @ c's {lib_dev_ms:.4f} ms")


def scale_module():
    """``scripts/torch_scale_run.py``, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "torch_scale_run", os.path.join(REPO, "scripts",
                                        "torch_scale_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dtu_recipe() -> dict:
    with open(DTU_RECIPE) as f:
        return json.load(f)


def phase_dtu_recipe(tmp: str, profile_dir=None):
    """The DTU recipe at full width (``configs/DTU.json``: 30 views at
    1600x1200, 131072 Gaussians at most, pair budget 196608, cap 512, the
    seg path, staged capacity) on the tracked dtu_s0 scan, cut in depth
    only: DTU_EPOCHS epochs, the staged start factor lowered to
    DTU_START_FACTOR, so that the capacity steps up to the maximum inside
    the cut. Every launch count is set to 0 just before the run and read
    just after. Then the run's final checkpoint, written after the last
    growth, resumes for one more epoch through the CLI. Returns
    (launches, the run's numbers, the resumed state's checkpoint
    path)."""
    scale = scale_module()
    d = dtu_recipe()
    max_cap = d["model"]["max_num_gaussians"]
    budget = d["model"]["tile_pair_budget"]
    log(f"== phase 9: the DTU recipe at full width on dtu_s0 (30 views, "
        f"1600x1200, up to {max_cap} Gaussians, pair budget {budget}), "
        f"{DTU_EPOCHS} epochs, staged start factor {DTU_START_FACTOR}")
    for mod in kernel_modules():
        mod.reset_launch_counts()
    res = scale.scale_run(
        DTU_RECIPE, DTU_EPOCHS, "cuda", os.path.join(tmp, "dtu"),
        skip_eval=True,
        profile_dir=os.path.join(profile_dir, "dtu") if profile_dir
        else None,
        model={"staged_capacity_start_factor": DTU_START_FACTOR})
    torch.cuda.synchronize()
    launches = {k: v for mod in kernel_modules()
                for k, v in mod.launch_counts.items()}
    views = 30
    expected = no_launches(segpair_fwd=DTU_EPOCHS * views,
                           segpair_bwd=DTU_EPOCHS * views,
                           rank_sum=DTU_EPOCHS * views)
    if launches != expected:
        raise AssertionError(f"launches {launches} on the DTU path, "
                             f"expected {expected}")
    losses = res["losses"]
    if len(losses) != DTU_EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"DTU epoch losses {losses}")
    steps = [tuple(int(x) for x in re.findall(r"capacity (\d+) -> (\d+)",
                                              line)[0])
             + (int(line.split()[1][:-1]),) for line in res["capacity_steps"]]
    if not steps or steps[-1][1] != max_cap:
        raise AssertionError(f"DTU capacity steps {res['capacity_steps']} "
                             f"do not reach {max_cap}")
    if res["peak_pairs"] is None or res["peak_pairs"] > budget:
        raise AssertionError(f"DTU peak pairs {res['peak_pairs']} over the "
                             f"budget {budget}")
    if profile_dir:
        log("dtu path, epoch 2 traced: " + trace_summary(
            os.path.join(profile_dir, "dtu", "trace.json"), views))
    # resume the run's final checkpoint, written after the last growth,
    # for one more epoch
    ckpt = os.path.join(res["out_dir"], f"epoch{DTU_EPOCHS - 1}.npz")
    with np.load(ckpt) as z:
        cap = z["f:.gaussians.alive"].shape[0]
        n_live = int(z["f:.gaussians.alive"].sum())
    with open(res["config_path"]) as f:
        cfg = json.load(f)
    cfg["training"]["num_epochs"] = 1
    cfg["output"]["output_dir"] = os.path.join(tmp, "dtu_resumed") + "/"
    cfg_path = os.path.join(tmp, "dtu_resume.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    from edgegaussians_tpu_torch.cli import train as train_cli
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = train_cli.main(["--config_file", cfg_path, "--scene_name",
                             res["scan"], "--backend", "cuda",
                             "--force_rerun", "--ckpt_path", ckpt])
    resumed = os.path.join(cfg["output"]["output_dir"], "release_PidiNet",
                           res["scan"], "epoch0.npz")
    if rc or not os.path.exists(resumed):
        raise AssertionError(f"the DTU resume failed:\n{text.getvalue()}")
    rows = epoch_lines(text.getvalue(), 1)
    with np.load(resumed) as z:
        if z["f:.gaussians.alive"].shape[0] != cap or not all(
                np.isfinite(z[f"f:.gaussians.params.{g}"]).all()
                for g in ("means", "scales", "quats", "opacities")):
            raise AssertionError("the resumed DTU state's capacity or "
                                 "parameters")
    wall = res["train_wall_s"]
    log(f"DTU path ok: losses {losses}; capacity steps "
        f"{res['capacity_steps']}; peak pairs {res['peak_pairs']} of "
        f"{budget}; {res['final_live']} live at the end; training wall "
        f"{wall:.1f}s for {DTU_EPOCHS} epochs (set-up included); launches "
        f"{launches}; the final checkpoint ({cap} rows, {n_live} live, "
        f"written after the epoch-{steps[-1][2]} growth) resumed one epoch "
        f"at capacity {cap}, loss {rows[0][0]}")
    return launches, res, resumed


def dtu_view_case(ckpt: str, device):
    """View 0 of dtu_s0 on the grown state of ``ckpt``: its live rows
    projected, binned at the recipe's cap and budget, as a seg case; and
    the state's means and alive mask."""
    from edgegaussians_tpu_torch.config import config_from_dict
    from edgegaussians_tpu_torch.data import parsers
    from edgegaussians_tpu_torch.ops import tiles
    from edgegaussians_tpu_torch.ops.projection import project_gaussians
    d = dtu_recipe()
    scale = scale_module()
    d["data"].update(base_dir=os.path.join(scale.DTU_BASE, "data") + "/",
                     edge_detection_method=scale.DETECTOR)
    cfg = config_from_dict(d)
    scene = parsers.load_scene(cfg.data, scale.DTU_SCAN)
    w, h = scene.width, scene.height
    with np.load(ckpt) as z:
        p = {k: torch.from_numpy(z[f"f:.gaussians.params.{k}"]).to(device)
             for k in ("means", "scales", "quats", "opacities")}
        alive = torch.from_numpy(z["f:.gaussians.alive"]).to(device)
    live = alive.nonzero()[:, 0]
    with torch.no_grad():
        proj = project_gaussians(
            p["means"][live], p["quats"][live], torch.exp(p["scales"][live]),
            torch.sigmoid(p["opacities"][live, 0]),
            torch.from_numpy(np.asarray(scene.viewmats[0],
                                        np.float32)).to(device),
            torch.from_numpy(np.asarray(scene.Ks[0], np.float32)).to(device),
            w, h)
    gen = torch.Generator(device=device).manual_seed(13)
    cs = seg_case(proj, tiles.pack_gaussian_render_data(proj), w, h,
                  cfg.model.tile_gaussian_capacity, cfg.model.tile_pair_budget,
                  cfg.model.max_tiles_per_gaussian, gen, device)
    return cs, tiles.pixel_basis(16, device=device), p["means"], alive, (w, h)


def phase_recipe_kernels(device, ckpt: str, dtu_launches: dict) -> dict:
    """Phase 2 at the DTU / Replica recipes' sizes, on the grown state of
    the DTU run: the seg kernels on one DTU view (7500 tiles, the 196608
    budget) under phase 2's gates, two launches of each bit-equal; the
    kNN at k = 6 and 15 on the state's live means at its 131072 rows, bit
    for bit the plain version on seeded query rows; the row sum of the
    view's backward rows (196608), bit for bit the CPU plain version.
    Returns, per kernel, its numbers at these sizes for the kernels
    line."""
    from edgegaussians_tpu_torch.ops import knn as knn_mod
    from edgegaussians_tpu_torch.ops import rank_sum as rs
    from edgegaussians_tpu_torch.ops import segpair
    cs, basis, means, alive, (w, h) = dtu_view_case(ckpt, device)
    pb = cs["pbins"]
    T = pb.counts_f.shape[0]
    log(f"== phase 2 (recipe sizes): the DTU state of {alive.shape[0]} rows "
        f"({int(alive.sum())} live), view 0 at {w}x{h}: {T} tiles, "
        f"{int(pb.num_pairs)} pairs of the {pb.pair_valid.shape[0]} budget, "
        f"{int(pb.s_f[-1])} kept, longest run {int(pb.counts_f.max())}")
    out = {}
    per_view = {k: v // (DTU_EPOCHS * 30) for k, v in dtu_launches.items()}
    with torch.no_grad():
        img_k = segpair.segpair_fwd(cs["feats"], cs["s_f"], basis)
        img_r = segpair.segpair_fwd_ref(cs["feats"], cs["s_f"], basis)
        gt = (cs["g"] * (1.0 - img_r)).contiguous()
        dfe_k = segpair.segpair_bwd(cs["feats"], cs["s_f"], basis, gt)
        dfe_r = segpair.segpair_bwd_ref(cs["feats"], cs["s_f"], basis, gt)
        twice = (segpair.segpair_fwd(cs["feats"], cs["s_f"], basis),
                 segpair.segpair_bwd(cs["feats"], cs["s_f"], basis, gt))
        torch.cuda.synchronize()
        valid = pb.pair_valid[:, None]
        dfe_k = torch.where(valid, dfe_k, torch.zeros_like(dfe_k))
        out_k = segpair.pair_grads_to_packed(dfe_k, cs["src"], cs["ox"],
                                             cs["oy"], pb, cs["n"])
        out_r = segpair.pair_grads_to_packed(dfe_r, cs["src"], cs["ox"],
                                             cs["oy"], pb, cs["n"])
        if not torch.equal(img_k, twice[0]) or not torch.equal(
                torch.where(valid, twice[1], torch.zeros_like(dfe_k)),
                dfe_k):
            raise AssertionError("DTU view: two launches of a seg kernel "
                                 "differ")
        e_img = (img_k - img_r).abs().max().item()
        check_image(e_img, "DTU view")
        rel = [rel_err(a, b, f"DTU view: {name}")
               for name, a, b in zip(("dfeats", "dpacked", "absgrad"),
                                     (dfe_k, *out_k), (dfe_r, *out_r))]
        fwd_b, bwd_b, evals = seg_work(cs, basis)
        gt_t = (cs["g"] * 0.5).contiguous()
        calls = {
            "segpair_fwd": (
                lambda: segpair.segpair_fwd(cs["feats"], cs["s_f"], basis),
                lambda: segpair.segpair_fwd_ref(cs["feats"], cs["s_f"],
                                                basis), fwd_b, FWD_OPS),
            "segpair_bwd": (
                lambda: segpair.segpair_bwd(cs["feats"], cs["s_f"], basis,
                                            gt_t),
                lambda: segpair.segpair_bwd_ref(cs["feats"], cs["s_f"],
                                                basis, gt_t), bwd_b,
                BWD_OPS)}
        for name, (kern, plain, nbytes, ops) in calls.items():
            out[name] = {
                "ms": cuda_ms(kern, 10), "device_ms": queued_ms(kern, 10),
                "plain_ms": cuda_ms(plain, 1),
                "bound": bound_ms(nbytes, evals, ops), "library_ms": None,
                "max_abs_err": e_img if name == "segpair_fwd"
                else (dfe_k - dfe_r).abs().max().item(),
                "launches_per_view_step": per_view[name]}
        log(f"DTU view: img_err {e_img:.3g}, dfeats_rel {rel[0]:.3g}, "
            f"dpacked_rel {rel[1]:.3g}, absgrad_rel {rel[2]:.3g}; two "
            f"launches bit-equal; {evals} pair-pixel evaluations")

        # the row sum of the view's backward rows
        dsrc = segpair.build_pair_features_vjp(cs["src"], cs["ox"],
                                               cs["oy"], dfe_k)
        rows = torch.cat([dsrc, dsrc[:, 3:5].abs()], -1).contiguous()
        idx, n, valid_r = pb.pair_ranks, cs["n"], pb.pair_valid
        got = rs.rank_sum(rows, idx, n, valid_r)
        again = rs.rank_sum(rows, idx, n, valid_r)
        cpu = rs.rank_sum_ref(rows.cpu(), idx.cpu(), n, valid_r.cpu())
        plain = rs.rank_sum_ref(rows, idx, n, valid_r)
        if not (torch.equal(got.view(torch.int32), again.view(torch.int32))
                and torch.equal(got.cpu().view(torch.int32),
                                cpu.view(torch.int32))):
            raise AssertionError("rank_sum at the DTU view: not two equal "
                                 "launches of the CPU plain version's bits")
        keys = torch.where(valid_r, idx, torch.full_like(idx, n))
        acc = torch.zeros((n + 1, rows.shape[1]), device=device)
        nv = int(valid_r.sum())
        width = rows.shape[1]
        nbytes = (nv * (width * 4 + idx.element_size())
                  + valid_r.numel() + n * width * 4)
        out["rank_sum"] = {
            "ms": cuda_ms(lambda: rs.rank_sum(rows, idx, n, valid_r), 10),
            "device_ms": queued_ms(
                lambda: rs.rank_sum(rows, idx, n, valid_r), 10),
            "plain_ms": cuda_ms(lambda: rs.rank_sum_ref(rows, idx, n,
                                                        valid_r), 5),
            "library_ms": cuda_ms(lambda: acc.index_add_(0, keys, rows), 10),
            "bound": bound_ms(nbytes, nv, (width, 0)),
            "max_abs_err": (got - plain).abs().max().item(),
            "launches_per_view_step": per_view["rank_sum"]}
        log(f"rank_sum at the DTU view: {rows.shape[0]} rows, {nv} valid, n "
            f"{n}: bit-equal to the CPU plain version on two launches")

        # the kNN on the grown state's means, every row queried
        nrows = means.shape[0]
        n_live = int(alive.sum())
        qrows = torch.from_numpy(np.sort(np.random.default_rng(14).choice(
            nrows, KNN_BIG_SAMPLE, replace=False))).to(device)
        for k in DTU_KNN_KS:
            d_k, i_k = knn_mod.knn(means, k, alive)
            torch.cuda.synchronize()
            ref = [knn_mod.knn_ref_rows(means, k, alive, qrows[c:c + 512])
                   for c in range(0, KNN_BIG_SAMPLE, 512)]
            check_knn(d_k[qrows], i_k[qrows], torch.cat([r[0] for r in ref]),
                      torch.cat([r[1] for r in ref]), alive,
                      f"DTU state k={k}", qrows)
            inf = torch.tensor(float("inf"), device=device)

            def library(k=k):
                for r0 in range(0, nrows, KNN_BIG_CHUNK):
                    r1 = min(r0 + KNN_BIG_CHUNK, nrows)
                    dd = torch.where(alive[None, :],
                                     torch.cdist(means[r0:r1], means), inf)
                    q = torch.arange(r1 - r0, device=device)
                    dd[q, r0 + q] = inf
                    torch.topk(dd, k, dim=1, largest=False)

            out[f"knn_k{k}"] = {
                "ms": cuda_ms(lambda k=k: knn_mod.knn(means, k, alive), 3),
                "device_ms": None,
                "plain_ms": None, "library_ms": cuda_ms(library, 1),
                "bound": bound_ms(nrows * 12 + nrows + nrows * k * 12,
                                  nrows * n_live, KNN_OPS),
                "max_abs_err": 0.0, "launches_per_view_step": 0}
            log(f"knn on the DTU state, {nrows} rows ({n_live} live), k={k}: "
                f"{KNN_BIG_SAMPLE} seeded query rows bit-equal to plain")
    for name, t in out.items():
        log(f"{name} at the recipe's size: kernel {t['ms']:.4f} ms"
            + (f" (device {t['device_ms']:.4f})" if t["device_ms"] else "")
            + (f", plain {t['plain_ms']:.4f} ms" if t["plain_ms"] else "")
            + (f", library {t['library_ms']:.4f} ms" if t["library_ms"]
               else "")
            + f", bound {t['bound'][0]:.4f} ms ({t['bound'][1]}), "
            f"{t['launches_per_view_step']} a DTU view step")
    return out


def phase_full_dtu(tmp: str):
    """With --full: the 500-epoch DTU recipe on dtu_s0 through
    scripts/torch_scale_run.py, then fit_edges and evaluate, beside the
    JAX package's dtu_s0 audit and DTU-synthetic spread."""
    log("== full (DTU): the whole DTU recipe on dtu_s0 through "
        "scripts/torch_scale_run.py")
    res = scale_module().scale_run(DTU_RECIPE, dtu_recipe()["training"][
        "num_epochs"], "cuda", os.path.join(tmp, "dtu_full"))
    log(f"full (DTU): train wall {res['train_wall_s']:.1f}s, peak pairs "
        f"{res['peak_pairs']}/{res['pair_budget']}, capacity steps "
        f"{res['capacity_steps']}, final live {res['final_live']}; chamfer "
        f"{res['chamfer']} F@5/10/20 {res['F@5']} / {res['F@10']} / "
        f"{res['F@20']} (the JAX package on dtu_s0: chamfer 0.005436, F@10 "
        "0.981, docs/RESULTS.md:77-84; its DTU-synthetic spread 0.0055 +- "
        "0.0006 / 0.979 +- 0.010, docs/RESULTS.md:326-338)")


def phase_full(tmp: str):
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    scan = "SYN01"
    with open(RECIPE) as f:
        epochs = json.load(f)["training"]["num_epochs"]
    log(f"== full: the unmodified ABC_DexiNed recipe ({epochs} epochs) on "
        f"{scan}, a {FULL_VIEWS}-view 800x800 synthetic scan "
        "(cli/make_synthetic.py --seed 11)")
    generate_scene(tmp, scan, seed=11, n_views=FULL_VIEWS, width=800,
                   height=800)
    t0 = time.time()
    text, launches, out_dir, cfg_path = train_cli_run(
        tmp, scan, None, "full", views=FULL_VIEWS, echo=False)
    wall = time.time() - t0
    rows = epoch_lines(text, epochs)
    for line in text.splitlines():
        m = re.match(r"epoch (\d+): ", line)
        if not m or int(m.group(1)) % 25 == 0 or \
                int(m.group(1)) == epochs - 1:
            log(line)
    pxs = [r[2] for r in rows[1:]]
    log(f"full: train wall {wall:.1f}s (CLI, set-up included), "
        f"steady epochs median {float(np.median(pxs))} Mpx/s, "
        f"alive {rows[-1][1]}, launches {launches}")
    _, per_scan, pr = downstream(tmp, scan, cfg_path, out_dir, "full")
    if per_scan is None:
        raise AssertionError("full: no predictions to evaluate")
    f_at = [pr[f"fscore_{t}"][0] for t in (0.005, 0.01, 0.02)]
    log(f"full: chamfer {per_scan['chamfer_dist']} acc {per_scan['acc']} "
        f"comp {per_scan['comp']} F@5/10/20 {f_at[0]} / {f_at[1]} / "
        f"{f_at[2]} (JAX distribution on such scans: chamfer 0.0049 +- "
        "0.0001, F@10 0.995 +- 0.001)")


def phase_entry(device) -> dict:
    """Phase 10a: ``graft_entry.entry()`` on the card, its image held to
    the same forward through the plain seg version on the card; one seg
    forward launch. Returns the launches."""
    from edgegaussians_tpu_torch import graft_entry
    from edgegaussians_tpu_torch.ops import segpair
    log("== phase 10a: graft_entry.entry() on the card (128x128, seg, cap "
        "128, budget 4096) against the plain seg forward on the card")
    fn, args = graft_entry.entry()
    if args[0].device.type != "cuda":
        raise AssertionError(f"entry() put its arguments on {args[0].device}")
    reset_kernel_counts()
    img = fn(*args)
    torch.cuda.synchronize()
    launches = kernel_counts()
    kernel = segpair.segpair_fwd
    segpair.segpair_fwd = segpair.segpair_fwd_ref
    try:
        plain = fn(*args)
    finally:
        segpair.segpair_fwd = kernel
    if launches != no_launches(segpair_fwd=1):
        raise AssertionError(f"entry(): launches {launches}, expected one "
                             "seg forward")
    total = float(img.sum())
    if tuple(img.shape) != (128, 128) or not torch.isfinite(img).all() \
            or not total > 0:
        raise AssertionError(f"entry(): image {tuple(img.shape)}, sum "
                             f"{total}")
    e_img = (img - plain).abs().max().item()
    check_image(e_img, "entry() image")
    log(f"entry ok: image sum {total:.4f}, max_abs_err against the plain "
        f"version {e_img:.3g}, launches {launches}")
    return launches


def phase_dryrun() -> dict:
    """Phase 10b: ``graft_entry.dryrun_multichip(4, "cuda")``: 4 Gloo
    ranks sharing the card, every rank's checks, and each rank's launches
    of the seg kernels, the kNN and the row sum's two jobs. Returns rank
    0's."""
    from edgegaussians_tpu_torch import graft_entry
    log(f"== phase 10b: graft_entry.dryrun_multichip({DRYRUN_RANKS}, "
        "'cuda'): Gloo ranks sharing the card")
    t0 = time.time()
    results = graft_entry.dryrun_multichip(DRYRUN_RANKS, "cuda")
    for r in results:
        if not all(r["launches"].get(k, 0) > 0 for k in
                   ("segpair_fwd", "segpair_bwd", "knn", "rank_sum",
                    "rank_sum_gather")):
            raise AssertionError(f"dry run rank {r['rank']} launches "
                                 f"{r['launches']}: a kernel of its path "
                                 "did not launch")
    log(f"dry run ok in {time.time() - t0:.1f}s (process start included): "
        f"every rank's checks hold; launches per rank "
        f"{[r['launches'] for r in results]}")
    return results[0]["launches"]


def sweep_ply(out: str, scan: str) -> bytes:
    with open(os.path.join(out, scan, "gaussians_all.ply"), "rb") as f:
        return f.read()


def phase_sweep(tmp: str) -> dict:
    """Phase 10c: ``cli.make_synthetic`` writes two scans; ``cli.sweep
    --backend cuda`` trains both in this process (the recipe cut to EPOCHS
    epochs; launches, finite losses, one PLY a scene), then on 2 torchrun
    ranks sharing the card into another output directory: each rank's
    summary holds its scene, each PLY bit for bit the in-process one.
    Returns the in-process sweep's launches."""
    from edgegaussians_tpu_torch.cli import make_synthetic, sweep
    from edgegaussians_tpu_torch.io.ply import read_gaussian_params_from_ply
    scans = ("sweepA", "sweepB")
    base = os.path.join(tmp, "sweep_scans")
    log(f"== phase 10c: cli.make_synthetic ({len(scans)} scans, {VIEWS} "
        f"views, 800x800), then cli.sweep --backend cuda over them, "
        f"{EPOCHS} epochs of ABC_DexiNed, in this process and on 2 torchrun "
        "ranks")
    t0 = time.time()
    if make_synthetic.main(["--base_dir", base, "--scan_names", *scans,
                            "--n_views", str(VIEWS)]):
        raise AssertionError("cli.make_synthetic returned non-zero")
    log(f"scans made in {time.time() - t0:.1f}s")
    data = os.path.join(base, "data")
    outs = {}
    for tag in ("sweep_one", "sweep_ranks"):
        cfg, cfg_path = write_config(tmp, EPOCHS, tag, data_dir=data)
        outs[tag] = (os.path.dirname(run_dir(cfg, scans[0])), cfg_path)
    out, cfg_path = outs["sweep_one"]
    argv = ["--config_file", cfg_path, "--scene_names", ",".join(scans),
            "--backend", "cuda"]
    captured = io.StringIO()
    reset_kernel_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(Tee(sys.stdout, captured)):
        rc = sweep.main(argv)
    torch.cuda.synchronize()
    launches = kernel_counts()
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"cli.sweep returned {rc}")
    rows = epoch_lines(captured.getvalue(), len(scans) * EPOCHS)
    views = len(scans) * EPOCHS * VIEWS
    expected = no_launches(segpair_fwd=views, segpair_bwd=views,
                           rank_sum=views)
    if launches != expected:
        raise AssertionError(f"launches {launches} of the sweep, expected "
                             f"{expected}")
    with open(os.path.join(out, "sweep_p0.json")) as f:
        summary = json.load(f)
    if set(summary) != set(scans):
        raise AssertionError(f"sweep_p0.json holds {sorted(summary)}")
    for scan in scans:
        pos, _, _, opac = read_gaussian_params_from_ply(
            os.path.join(out, scan, "gaussians_all.ply"))
        if pos.shape != (summary[scan]["gaussians"], 3) \
                or not np.isfinite(pos).all() or not np.isfinite(opac).all():
            raise AssertionError(f"{scan}: gaussians_all.ply holds "
                                 f"{pos.shape}, summary {summary[scan]}")
    log(f"sweep in one process ok in {wall:.1f}s: losses "
        f"{[r[0] for r in rows]}, launches {launches}, summary {summary}")

    out_r, cfg_path_r = outs["sweep_ranks"]
    t0 = time.time()
    torchrun(len(scans), "sweep on 2 ranks",
             ["-m", "edgegaussians_tpu_torch.cli.sweep", "--config_file",
              cfg_path_r, "--scene_names", ",".join(scans), "--backend",
              "cuda", "--force_rerun"])
    for rank, scan in enumerate(scans):
        with open(os.path.join(out_r, f"sweep_p{rank}.json")) as f:
            got = json.load(f)
        if set(got) != {scan}:
            raise AssertionError(f"sweep_p{rank}.json holds {sorted(got)}, "
                                 f"expected {scan} only")
        if sweep_ply(out_r, scan) != sweep_ply(out, scan):
            raise AssertionError(f"{scan}: rank {rank}'s PLY differs from "
                                 "the in-process sweep's")
    log(f"sweep on 2 ranks ok in {time.time() - t0:.1f}s (process start "
        "included): rank r trained scene r, each PLY bit for bit the "
        "in-process one")
    return launches


def phase_profiling(device) -> None:
    """Phase 10d: ``utils/profiling`` on the card. ``device_timer`` around
    PROFILED_RENDERS fixture seg renders, forward and backward, takes at
    least the CUDA-event time of the same block; ``trace`` over one render
    writes a trace whose host records hold each seg kernel's launch (its
    device records are not required: torch.profiler drops them after the
    in-process training runs)."""
    from torch.profiler import record_function

    from edgegaussians_tpu_torch.ops import segpair
    from edgegaussians_tpu_torch.utils import profiling
    log(f"== phase 10d: utils/profiling on the card: device_timer over "
        f"{PROFILED_RENDERS} fixture seg renders, trace over one")
    cases, basis = seg_cases(device)

    def render(cs):
        with record_function("segpair_fwd"):
            segpair.segpair_fwd(cs["feats"], cs["s_f"], basis)
        with record_function("segpair_bwd"):
            segpair.segpair_bwd(cs["feats"], cs["s_f"], basis, cs["g"])

    render(cases[0])
    torch.cuda.synchronize()
    timed = {}
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profiling.device_timer(timed, "renders", device):
        start.record()
        for i in range(PROFILED_RENDERS):
            render(cases[i % len(cases)])
        stop.record()
    event_ms = start.elapsed_time(stop)
    if not timed["renders"] * 1e3 >= event_ms:
        raise AssertionError(f"device_timer {timed['renders'] * 1e3:.4f} ms "
                             f"< the events' {event_ms:.4f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            render(cases[0])
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
    launches = [e for e in events if "LaunchKernel" in e["name"]]
    device_records = [e for e in events if e.get("cat") == "kernel"]
    for name in ("segpair_fwd", "segpair_bwd"):
        spans = [e for e in events if e["name"] == name
                 and e.get("cat") == "user_annotation"]
        inside = [e for e in launches for a in spans
                  if a["ts"] <= e["ts"] <= a["ts"] + a["dur"]]
        if len(spans) != 1 or len(inside) != 1:
            raise AssertionError(f"trace: {len(spans)} {name} spans holding "
                                 f"{len(inside)} host launch records")
    log(f"profiling ok: device_timer {timed['renders'] * 1e3:.4f} ms >= "
        f"events {event_ms:.4f} ms over {PROFILED_RENDERS} renders; trace: "
        f"one host launch record in each seg kernel's span, "
        f"{len(launches)} launch records, {len(device_records)} device "
        "kernel records")


def phase_slice_tools(device) -> dict:
    """Phase 10: the entry, the dry run, the sweep and utils/profiling on
    the card; returns each path's launches."""
    t0 = time.time()
    out = {"entry": phase_entry(device), "dryrun": phase_dryrun()}
    with tempfile.TemporaryDirectory() as tmp:
        out["sweep"] = phase_sweep(tmp)
    phase_profiling(device)
    log(f"phase 10 ok in {time.time() - t0:.1f}s")
    return out


def harness(script: str, *args) -> tuple:
    """``scripts/<script>.py`` with ``args`` as a process, as a user runs
    it: (its output, its last line as JSON). Raises unless it exits 0
    within HARNESS_TIMEOUT; the process is stopped on return."""
    import signal
    cmd = [sys.executable, os.path.join(REPO, "scripts", f"{script}.py"),
           *map(str, args)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=HARNESS_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{script} exited {proc.returncode}:\n"
                             f"{text[-6000:]}")
    return text, json.loads(text.strip().splitlines()[-1])


def timing_line(name: str, t: dict) -> str:
    dev = t.get("device_ms")
    return (f"{name}: {t['ms']:.4f} ms, device "
            + ("-" if dev is None else f"{dev:.4f}") + f" ms "
            f"({t.get('device_ms_by', '-')}), {t['launches']:.0f} launches, "
            f"kernels {t['kernels']}")


def phase_profile_stages(device) -> dict:
    """Phase 11a: ``torch_profile_stages.py --fixture`` (800x800, camera
    0): every stage finite, the seg stages' pair counts those phase 2
    bins for camera 0, each kernel stage one launch of its kernel a call.
    Returns the script's JSON."""
    from torch_profile_stages import STAGE_KERNELS

    from edgegaussians_tpu_torch.ops import tiles
    log("== phase 11a: scripts/torch_profile_stages.py --fixture, "
        "stage by stage on the dense two-level path and the seg path")
    t0 = time.time()
    _, res = harness("torch_profile_stages", "--fixture", "--reps",
                     HARNESS_REPS)
    if not res["finite"]:
        raise AssertionError("profile_stages: a stage's output is not "
                             "finite")
    stages = dict(res["stages"], **res["seg"]["stages"])
    for name, want in STAGE_KERNELS.items():
        if stages[name]["kernels"] != want:
            raise AssertionError(f"profile_stages {name!r}: kernels "
                                 f"{stages[name]['kernels']} a call, "
                                 f"expected {want}")
    cams, w, h, n = fixture_cameras(device)
    with torch.no_grad():
        pb = tiles.bin_pairs_frame_order(cams[0][0], w, h, 16, min(768, n),
                                         49152, max_tiles_per_gaussian=16)
    want = {"pairs": int(pb.num_pairs), "kept": int(pb.s_f[-1])}
    got = {k: res["seg"][k] for k in want}
    if got != want:
        raise AssertionError(f"profile_stages seg counts {got}, phase 2's "
                             f"camera 0 {want}")
    for name, t in stages.items():
        log(timing_line(name, t))
    log(f"profile_stages ok in {time.time() - t0:.1f}s: dense pairs "
        f"{res['pairs']} counts1_sum {res['counts1_sum']} counts2_sum "
        f"{res['counts2_sum']} trunc {res['trunc']}; seg {got} as phase 2's "
        "camera 0")
    return res


def view_step_launches(tmp: str, scan: str, device) -> float:
    """Host kernel launch records a seg main-path view step (the recipe on
    phase 3's scan, from its initial state), over COUNTED_STEPS steps in
    one torch.profiler window (torch_common.profiled)."""
    from edgegaussians_tpu_torch.cli.train import scene_inputs
    from edgegaussians_tpu_torch.config import load_config
    from edgegaussians_tpu_torch.train import optim, trainer
    _, cfg_path = write_config(tmp, EPOCHS, "harness_steps")
    cfg = load_config(cfg_path)
    seeds, sc = scene_inputs(cfg, scan)
    state = trainer.init_train_state(seeds, cfg, device=device)
    images = torch.from_numpy(np.asarray(sc.images, np.float32)).to(device)
    masks = images >= cfg.model.edge_detection_threshold
    vms = torch.from_numpy(np.asarray(sc.viewmats, np.float32)).to(device)
    Ks = torch.from_numpy(np.asarray(sc.Ks, np.float32)).to(device)
    pg = trainer.make_proj_grad_fn(cfg, sc.width, sc.height)
    lrs = optim.all_lrs(cfg.training.optim, 1)
    views = itertools.count()

    def step():
        trainer.view_step(state, next(views) % sc.num_views, images, masks,
                          vms, Ks, proj_grad=pg, lrs=lrs, lambda_proj=1.0,
                          bg_ratio=1.0, strategy_idx=0,
                          run_sum=torch.zeros((), device=device))

    step()
    torch.cuda.synchronize()
    # this process's earlier traces leave its windows without device
    # records (section 7 of PERF.md): the host's records alone
    return profiled(step, COUNTED_STEPS, device_records=False)[0]


def phase_profile_train_step(tmp: str, scan: str, device) -> dict:
    """Phase 11b: ``torch_profile_train_step.py`` at the recipe's 16384
    capacity: every JAX key finite, the kNN component one ``knn`` launch a
    call and the direction component one ``rank_sum_gather``; its
    ``expected_launches_per_step`` printed beside a view step's host
    launch records (a report, not a gate). Returns the script's JSON."""
    log("== phase 11b: scripts/torch_profile_train_step.py, the view "
        "step's components at the recipe's 16384 capacity")
    t0 = time.time()
    _, res = harness("torch_profile_train_step", "--reps", HARNESS_REPS)
    bad = [k for k in TRAIN_STEP_KEYS + ("capacity",)
           if not isinstance(res.get(k), (int, float))
           or not math.isfinite(res[k])]
    if bad or res["capacity"] != 16384:
        raise AssertionError(f"profile_train_step: keys {bad} missing or "
                             f"not finite, capacity {res.get('capacity')}")
    for comp, want in (("knn", {"knn": 1}),
                       ("dir_loss", {"rank_sum_gather": 1})):
        if res["kernels"][comp] != want:
            raise AssertionError(f"profile_train_step {comp}: kernels "
                                 f"{res['kernels'][comp]} a call, expected "
                                 f"{want}")
    for k in TRAIN_STEP_KEYS:
        stem = k[:-3] if k.endswith("_ms") else None
        extra = (f", device {res.get(stem + '_device_ms')} ms, "
                 f"{res.get(stem + '_launches')} launches"
                 if stem and stem + "_launches" in res else "")
        log(f"{k} {res[k]}{extra}")
    log(f"device ms by {res['device_ms_by']}; expected step device "
        f"{res['expected_step_device_ms']} ms")
    measured = view_step_launches(tmp, scan, device)
    log(f"profile_train_step ok in {time.time() - t0:.1f}s: "
        f"expected_launches_per_step {res['expected_launches_per_step']} "
        f"(its every-5th block {res['every5_total_launches']}), a seg "
        f"main-path view step {measured:.1f} host launch records "
        f"(phase 3's scan, no fired step; a report, not a gate)")
    res["view_step_launches"] = measured
    return res


def phase_epoch_ab(tmp: str, scan: str) -> dict:
    """Phase 11c: ``torch_epoch_ab.py --turns AB_TURNS`` on phase 3's scan,
    cut in depth to AB_EPOCHS epochs: both variants train with finite
    losses, ``full`` launches the kNN and ``noorient`` does not. Returns
    the script's JSON."""
    log(f"== phase 11c: scripts/torch_epoch_ab.py --turns {AB_TURNS} on a "
        f"{VIEWS}-view 800x800 scan, {AB_EPOCHS} epochs a variant")
    t0 = time.time()
    _, res = harness("torch_epoch_ab", "--turns", AB_TURNS, "--epochs",
                     AB_EPOCHS, "--data_dir", os.path.join(tmp, "data"),
                     "--scene_name", scan, "--out_root",
                     os.path.join(tmp, "epoch_ab"))
    for tag in ("full", "noorient"):
        ls = res[f"{tag}_losses"]
        if len(ls) != AB_TURNS * AB_EPOCHS or not all(map(math.isfinite,
                                                          ls)):
            raise AssertionError(f"epoch_ab {tag}: losses {ls}")
    if not res["full_launches"]["knn"] or res["noorient_launches"]["knn"]:
        raise AssertionError(
            f"epoch_ab: kNN launches {res['full_launches']['knn']} (full), "
            f"{res['noorient_launches']['knn']} (noorient)")
    log(f"epoch_ab ok in {time.time() - t0:.1f}s: every5_block_ms "
        f"{res['every5_block_ms']}, full {res['t_full_ms_per_view']} ms a "
        f"view (spread {res['t_full_spread_ms']}), noorient "
        f"{res['t_noorient_ms_per_view']} (spread "
        f"{res['t_noorient_spread_ms']}), order {res['order']}, launches "
        f"full {res['full_launches']}, noorient {res['noorient_launches']}")
    return res


def phase_tp_bench() -> dict:
    """Phase 11d: ``torch_tp_dtu_bench.py`` at the JAX script's defaults
    (131072 Gaussians, 1600x1200) in ``--mode ref`` and ``--mode tp --mesh
    1``, each its own process: the two losses within 1e-5 relative.
    Returns each mode's JSON."""
    log("== phase 11d: scripts/torch_tp_dtu_bench.py --mode ref, then "
        "--mode tp --mesh 1 (131072 Gaussians, 1600x1200)")
    t0 = time.time()
    out = {mode: harness("torch_tp_dtu_bench", "--mode", mode,
                         *(("--mesh", 1) if mode == "tp" else ()))[1]
           for mode in ("ref", "tp")}
    a, b = out["ref"]["loss"], out["tp"]["loss"]
    if not (math.isfinite(a) and abs(a - b) <= 1e-5 * abs(a)):
        raise AssertionError(f"tp_dtu_bench: loss {a} (ref) against {b} "
                             "(tp, mesh 1)")
    for mode, r in out.items():
        log(f"{r['mode']}: {r['ms_per_render']} ms a render, device "
            f"{r['device_ms']} ms, {r['launches']} launches, "
            f"{r['mpx_per_s']} Mpx/s, peak {r['peak_device_mem_gib']} GiB, "
            f"first render {r['compile_s']} s, loss {r['loss']}")
    log(f"tp_dtu_bench ok in {time.time() - t0:.1f}s: losses {a} and {b}")
    return out


def phase_audit_ttc(tmp: str, scan: str) -> dict:
    """Phase 11e: ``torch_pair_budget_audit.py`` and
    ``torch_time_to_converge.py`` on phase 3's scan with 1 extraction
    seed, cut in depth to AUDIT_EPOCHS and TTC_EPOCHS epochs: the audit's
    peak the largest ``pairs=`` of its log, within the budget, no
    overflow warning; the time-to-converge's eval finding the checkpoints
    written every TTC_INTERVAL epochs, each a row of ttc_results.json
    with a finite chamfer. Returns the audit's JSON with the rows."""
    data, gt = os.path.join(tmp, "data"), os.path.join(tmp, "groundtruth")
    log(f"== phase 11e: scripts/torch_pair_budget_audit.py and "
        f"scripts/torch_time_to_converge.py, {AUDIT_EPOCHS} and "
        f"{TTC_EPOCHS} epochs on a {VIEWS}-view 800x800 scan, 1 extraction "
        "seed")
    t0 = time.time()
    scan_args = ("--data_dir", data, "--scene_name", scan, "--gt_base", gt)
    text, res = harness("torch_pair_budget_audit", "--epochs", AUDIT_EPOCHS,
                        "--seeds", 1, "--out_root",
                        os.path.join(tmp, "audit"), *scan_args)
    logged = [int(p) for p in re.findall(r"pairs=(\d+)/", text)]
    if (len(logged) != AUDIT_EPOCHS or res["peak_pairs"] != max(logged)
            or res["peak_pairs"] > res["budget"]
            or res["overflow_warnings"] or "exceed tile_pair_budget" in text):
        raise AssertionError(f"audit: peak {res['peak_pairs']}, the log's "
                             f"pairs= {logged}, budget {res['budget']}, "
                             f"{res['overflow_warnings']} warnings")
    log(f"audit ok: peak {res['peak_pairs']} of budget {res['budget']}, "
        f"pairs {logged}, train wall {res['wall_s']} s, chamfer "
        f"{res['chamfer']}, f10 {res['f10']}, launches {res['launches']}")
    _, cfg_path = write_config(tmp, TTC_EPOCHS, "ttc_recipe")
    ttc = os.path.join(tmp, "ttc")
    harness("torch_time_to_converge", "--stage", "train", "--config",
            cfg_path, "--interval", TTC_INTERVAL, "--out_root", ttc,
            *scan_args)
    _, ev = harness("torch_time_to_converge", "--stage", "eval",
                    "--seeds", 1, "--out_root", ttc, *scan_args)
    with open(os.path.join(ttc, "ttc_results.json")) as f:
        rows = json.load(f)
    want = list(range(TTC_INTERVAL - 1, TTC_EPOCHS, TTC_INTERVAL))
    if (rows != ev["rows"] or ev["no_edges"]
            or [r["epoch"] for r in rows] != want
            or not all(math.isfinite(r["chamfer"]) for r in rows)):
        raise AssertionError(f"time_to_converge: rows {rows}, no edges at "
                             f"{ev['no_edges']}, checkpoints expected at "
                             f"{want}")
    log(f"time_to_converge ok in {time.time() - t0:.1f}s (with the audit): "
        f"checkpoints {want}, rows {rows}")
    res["ttc_rows"] = rows
    return res


def add_counts(total: dict, counts: dict) -> dict:
    """Each kernel's launches of ``counts`` added into ``total``."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_harness(device) -> dict:
    """Phase 11: the harness scripts on the card, each run as a user runs
    it; returns the kernel launches of their training runs (the epoch
    A/B's and the audit's)."""
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        scan = "synth0"
        generate_scene(tmp, scan, seed=0, n_views=VIEWS, width=800,
                       height=800)
        phase_profile_stages(device)
        phase_profile_train_step(tmp, scan, device)
        ab = phase_epoch_ab(tmp, scan)
        phase_tp_bench()
        audit = phase_audit_ttc(tmp, scan)
    launches = {}
    for counts in (ab["full_launches"], ab["noorient_launches"],
                   audit["launches"]):
        add_counts(launches, counts)
    log(f"phase 11 ok in {time.time() - t0:.1f}s: launches of its training "
        f"runs {launches}")
    return launches


def table_holds(rows, counts: dict, what: str) -> None:
    """Each port kernel launched in a traced window (``counts``, by
    counter) appears in the window's op table with as many kernel records
    (counters sharing one CUDA symbol add up)."""
    by_symbol = {}
    for k, v in counts.items():
        if v:
            by_symbol.setdefault(KERNEL_SYMBOLS[k], []).append(k)
    for symbol, names in by_symbol.items():
        want = sum(counts[k] for k in names)
        got = op_count(rows, names[0])
        if got != want:
            raise AssertionError(f"{what}: {got} kernel records of {symbol} "
                                 f"in the table, {want} launches of {names}")


def phase_scatter_lab() -> None:
    """Phase 12a: ``torch_scatter_lab.py`` at its defaults (the JAX lab's
    scene): every variant within SCATTER_TOL of max-abs of A on the masked
    rows it keeps (E and F keep the first P2cap / P1cap valid slots), the
    row sum (G) one kernel a call and the same bits twice."""
    log("== phase 12a: scripts/torch_scatter_lab.py, the backward-scatter "
        "variants at the JAX lab's shapes")
    t0 = time.time()
    _, res = harness("torch_scatter_lab")
    for name, row in res["variants"].items():
        if not row["rel_err"] <= SCATTER_TOL:
            raise AssertionError(f"scatter_lab {name}: {row['rel_err']:.3g} "
                                 "of A's max-abs")
        log(timing_line(f"{name} ({row['label']})", row)
            + f", err {row['max_err']:.3g} ({row['dropped_rows']} valid "
            f"rows past its caps), same bits twice {row['repeat_bits']}")
    g = res["variants"]["G"]
    if not g["repeat_bits"] or g["kernels"] != {"rank_sum": 1}:
        raise AssertionError(f"scatter_lab G: same bits twice "
                             f"{g['repeat_bits']}, kernels {g['kernels']}")
    log(f"scatter_lab ok in {time.time() - t0:.1f}s: T {res['T']}, rows "
        f"{res['rows']}, counts1_sum {res['counts1_sum']}, counts2_sum "
        f"{res['counts2_sum']}")


def phase_op_traces() -> None:
    """Phase 12b-c: ``torch_segpair_profile.py --variants 0,1,seg`` and
    ``torch_profile_sharded_trace.py``, SCRIPT_STEPS traced steps each:
    every variant's table holds its own kernels, SCRIPT_STEPS records of
    each kernel a step launches, and a finite device total; the sharded
    step's loss within 1e-5 relative of the unsharded render's."""
    log(f"== phase 12b: scripts/torch_segpair_profile.py --variants 0,1,seg "
        f"--steps {SCRIPT_STEPS}, then 12c: "
        "scripts/torch_profile_sharded_trace.py")
    t0 = time.time()
    _, res = harness("torch_segpair_profile", "--variants", "0,1,seg",
                     "--steps", SCRIPT_STEPS)
    for name, v in res["variants"].items():
        want = {k: n * SCRIPT_STEPS for k, n in PROFILE_KERNELS[name].items()}
        if v["kernels"] != want or not (math.isfinite(v["total_device_ms"])
                                        and v["total_device_ms"] > 0):
            raise AssertionError(f"segpair_profile {name}: kernels "
                                 f"{v['kernels']} (expected {want}), device "
                                 f"{v['total_device_ms']} ms a step")
        table_holds(v["rows"], v["kernels"], f"segpair_profile {name}")
        top = ", ".join(f"{r['op'][:40]} {r['ms_per_step']:.4f}"
                        for r in v["rows"][:4])
        log(f"variant {name}: {v['ms_per_step']:.2f} ms a step by wall "
            f"clock, device {v['total_device_ms']:.3f} ms a step over "
            f"{len(v['rows'])} ops; top: {top}")
    _, sh = harness("torch_profile_sharded_trace", "--steps", SCRIPT_STEPS)
    if (sh["kernels"].get("segpair_fwd") != SCRIPT_STEPS
            or sh["kernels"].get("segpair_bwd") != SCRIPT_STEPS):
        raise AssertionError(f"sharded trace: kernels {sh['kernels']}")
    table_holds(sh["rows"], sh["kernels"], "sharded trace")
    a, b = sh["loss"], sh["unsharded_loss"]
    if not (math.isfinite(a) and abs(a - b) <= 1e-5 * abs(b)):
        raise AssertionError(f"sharded trace: loss {a}, unsharded {b}")
    log(f"op traces ok in {time.time() - t0:.1f}s: sharded step "
        f"{sh['ms_per_step']:.2f} ms by wall clock, device "
        f"{sh['total_device_ms']:.3f} ms a step, loss {a} (unsharded {b})")


def phase_pair_kernel_ab(tmp: str, scan: str) -> dict:
    """Phase 12d: ``torch_pair_kernel_ab.py --epochs PKA_EPOCHS`` on a scan
    made as phase 3's: each variant launches its own compositor,
    epochs x views times, and none of the others'. Returns its training
    launches."""
    log(f"== phase 12d: scripts/torch_pair_kernel_ab.py --epochs "
        f"{PKA_EPOCHS} on a {VIEWS}-view 800x800 scan")
    t0 = time.time()
    _, res = harness("torch_pair_kernel_ab", "--epochs", PKA_EPOCHS,
                     "--data_dir", os.path.join(tmp, "data"),
                     "--scene_name", scan, "--out_root",
                     os.path.join(tmp, "pair_kernel_ab"))
    launches = {}
    for tag, (own, others) in PKA_KERNELS.items():
        got = res[f"{tag}_launches"]
        per = 2 if tag == "dense" else 1
        ls = res[f"{tag}_losses"]
        if (any(got[k] != per * PKA_EPOCHS * VIEWS for k in own)
                or any(got[k] for k in others)
                or len(ls) != PKA_EPOCHS or not all(map(math.isfinite, ls))):
            raise AssertionError(f"pair_kernel_ab {tag}: launches {got}, "
                                 f"losses {ls}")
        add_counts(launches, got)
    log(f"pair_kernel_ab ok in {time.time() - t0:.1f}s: ms a view dense "
        f"{res['t_dense_ms_per_view']}, pairk "
        f"{res['t_pair_kernel_ms_per_view']}, segk "
        f"{res['t_seg_kernel_ms_per_view']} (speedups {res['speedup_pair']}, "
        f"{res['speedup_seg']}; host-paced)")
    return launches


def phase_scaling() -> None:
    """Phase 12e: ``torch_scaling_efficiency.py --mesh-sizes 1,2 --steps 1
    --ranks_on shared``: every mode's rows finite at both sizes."""
    log("== phase 12e: scripts/torch_scaling_efficiency.py --mesh-sizes "
        "1,2 --steps 1 --ranks_on shared")
    t0 = time.time()
    _, res = harness("torch_scaling_efficiency", "--mesh-sizes", "1,2",
                     "--steps", 1, "--ranks_on", "shared")
    for mode, rows in res["modes"].items():
        if [r["devices"] for r in rows] != [1, 2] or not all(
                math.isfinite(r[k]) and r[k] > 0 for r in rows
                for k in ("sec_per_epoch", "px_per_s", "tiles_per_s",
                          "efficiency_vs_1dev")):
            raise AssertionError(f"scaling {mode}: rows {rows}")
        log(f"{mode}: " + "; ".join(
            f"x{r['devices']} {r['sec_per_epoch'] * 1e3:.1f} ms an epoch, "
            f"efficiency {r['efficiency_vs_1dev']}" for r in rows))
    log(f"scaling ok in {time.time() - t0:.1f}s ({res['note']})")


def quality_rows(rows, what: str) -> str:
    """Each row's chamfer and F@10 finite, or both None (no edges found,
    as phase 11e reports a run without edges)."""
    out = []
    for r in rows:
        c, f = r["chamfer"], r["f10"]
        if (c is None) != (f is None) or (c is not None and not (
                math.isfinite(c) and math.isfinite(f))):
            raise AssertionError(f"{what}: row {r}")
        out.append("no edges" if c is None else f"chamfer {c:.5f} F@10 "
                   f"{f:.4f}")
    return ", ".join(out)


def finite_losses(losses, n: int, what: str) -> None:
    if len(losses) != n or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}, {n} expected")


def phase_spreads(tmp: str, scan: str) -> dict:
    """Phase 12f: ``torch_dup_spread_ab.py --seeds 1`` and
    ``torch_dp_quality_run.py`` on phase 3's scan, SPREAD_EPOCHS epochs;
    ``torch_dtu_spread.py`` on one cut DTU-shaped scene, then
    ``torch_spread_synth.py --skip_fit`` over it: finite losses, rows with
    a finite chamfer or reported without edges. Returns their training
    launches."""
    log(f"== phase 12f: scripts/torch_dup_spread_ab.py --seeds 1 and "
        f"scripts/torch_dp_quality_run.py ({SPREAD_EPOCHS} epochs), "
        f"scripts/torch_dtu_spread.py {DTU_SPREAD}, then "
        "scripts/torch_spread_synth.py --skip_fit")
    t0 = time.time()
    scan_args = ("--data_dir", os.path.join(tmp, "data"), "--scene_name",
                 scan, "--gt_base", os.path.join(tmp, "groundtruth"))
    launches = {}
    _, dup = harness("torch_dup_spread_ab", "--seeds", 1, "--epochs",
                     SPREAD_EPOCHS, "--out_root", os.path.join(tmp, "dup"),
                     *scan_args)
    for arm, rows in dup["results"].items():
        run = dup["runs"][f"{arm}/seed0"]
        finite_losses(run["losses"], SPREAD_EPOCHS, f"dup_spread_ab {arm}")
        add_counts(launches, run["launches"])
        log(f"dup_spread_ab {arm}: {quality_rows(rows, arm)}, "
            f"{rows[0]['gaussians']} Gaussians")
    _, dp = harness("torch_dp_quality_run", "--epochs", SPREAD_EPOCHS,
                    "--seeds", 1, "--out_root", os.path.join(tmp, "dp"), *scan_args)
    finite_losses(dp["losses"], SPREAD_EPOCHS, "dp_quality_run")
    add_counts(launches, dp["launches"])
    log(f"dp_quality_run (batch {dp['batch']}): "
        f"{quality_rows([dp], 'dp_quality_run')}, wall {dp['wall_s']} s")
    root = os.path.join(tmp, "dtu_spread")
    _, dtu = harness("torch_dtu_spread", *itertools.chain.from_iterable(
        (f"--{k}", v) for k, v in DTU_SPREAD.items()), "--out_root", root)
    for scan_name, run in dtu["runs"].items():
        finite_losses(run["losses"], DTU_SPREAD["epochs"], scan_name)
        add_counts(launches, run["launches"])
    log(f"dtu_spread: {quality_rows(dtu['rows'], 'dtu_spread')}")
    with open(dtu["config"]) as f:
        cfg = json.load(f)
    out_base = os.path.join(cfg["output"]["output_dir"],
                            f"{cfg['output']['exp_name']}_PidiNet")
    _, rows = harness("torch_spread_synth", "--config_file", dtu["config"],
                      "--gt_base_dir", os.path.join(root, "synthetic_data",
                                                    "groundtruth"),
                      "--output_base_dir", out_base, "--skip_fit",
                      "--scan_names", ",".join(dtu["runs"]))
    for scan_name, r in rows.items():
        if not math.isfinite(r["chamfer_dist"]):
            raise AssertionError(f"spread_synth {scan_name}: {r}")
    no_edges = [s for s, r in zip(dtu["runs"], dtu["rows"])
                if r["chamfer"] is None]
    if sorted(rows) != sorted(set(dtu["runs"]) - set(no_edges)):
        raise AssertionError(f"spread_synth rows {sorted(rows)}, scans "
                             f"without edges {no_edges}")
    log(f"spreads ok in {time.time() - t0:.1f}s: spread_synth rows "
        + (", ".join(f"{k} chamfer {r['chamfer_dist']:.5f}"
                     for k, r in rows.items()) or "none")
        + (f"; without edges {no_edges}" if no_edges else ""))
    return launches


def phase_scripts() -> dict:
    """Phase 12: the last nine scripts on the card, each run as a user
    runs it, one after another; returns the kernel launches of their
    training runs."""
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        scan = "synth0"
        generate_scene(tmp, scan, seed=0, n_views=VIEWS, width=800,
                       height=800)
        phase_scatter_lab()
        phase_op_traces()
        launches = phase_pair_kernel_ab(tmp, scan)
        phase_scaling()
        add_counts(launches, phase_spreads(tmp, scan))
    log(f"phase 12 ok in {time.time() - t0:.1f}s: launches of its training "
        f"runs {launches}")
    return launches


def lab_kernel_rows(launches):
    """(name, source, replaced TPU kernel, launches) of the lab's kernels."""
    from edgegaussians_tpu_torch.lab import chunked, probes
    cl = "scripts/cumprod_lab.py:134 (fwd :165, pallas_call :175) with "
    probe_lines = {"roll": ":51 (pallas_call :58)",
                   "onehot": ":66 (pallas_call :82)",
                   "dyn_write": ":92 (pallas_call :107)",
                   "dyn_read": ":128 (pallas_call :143)",
                   "transpose": ":163 (pallas_call :169)",
                   "vmem_dyn": ":177 (pallas_call :196)"}
    return [
        ("lab_fwd_v3", chunked.KERNEL_SOURCE,
         "scripts/kernel_lab.py:86 (fwd_v3 :116, pallas_call :127); "
         + cl + "_scan_v3 :55", launches),
        ("lab_fwd_noscan", chunked.KERNEL_SOURCE, cl + "_scan_none :66",
         launches),
        ("lab_fwd_twolevel", chunked.KERNEL_SOURCE,
         cl + "_scan_twolevel :70", launches),
        ("lab_fwd_logsum", chunked.KERNEL_SOURCE, cl + "_scan_matmul :116",
         launches),
        ("lab_bwd_v3", chunked.KERNEL_SOURCE,
         "scripts/kernel_lab.py:172 (bwd_v3 :206, pallas_call :224)",
         launches),
    ] + [(f"probe_{p}", probes.KERNEL_SOURCE,
          f"scripts/segpair_mosaic_probe.py{probe_lines[p]}", launches)
         for p in probes.PROBES]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile_dir", default=None,
                    help="also trace epoch 2 of phases 3 to 6 here")
    ap.add_argument("--full", action="store_true",
                    help="also run the whole 400-epoch recipe, then "
                         "fit_edges and evaluate")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # the processes started here cache the bytecode Python compiles under
    # the checkout's build/: where the installation keeps no cache of its
    # own, each would compile torch's modules anew (~8 s a process on the
    # card's machine)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(REPO, "build",
                                                     "pycache")
    card = phase_environment()
    err, ms, bounds = phase_kernels(device)
    err_d, ms_d, bounds_d = phase_dense_kernels(device)
    err.update(err_d)
    ms.update(ms_d)
    bounds.update(bounds_d)
    err["knn"], ms["knn"], bounds["knn"] = phase_knn_kernel(device)
    for phase in (phase_pair_kernels, phase_v1_kernels, phase_rank_sum):
        err_p, ms_p, bounds_p = phase(device)
        err.update(err_p)
        ms.update(ms_p)
        bounds.update(bounds_p)
    phase_whole_path(device)
    band_launches = phase_band_mode(device)
    err["shard_sum"], ms["shard_sum"], bounds["shard_sum"], extra = \
        phase_shard_sum_kernel(device)
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    with tempfile.TemporaryDirectory() as tmp:
        scan = "synth0"
        t0 = time.time()
        generate_scene(tmp, scan, seed=0, n_views=VIEWS, width=800,
                       height=800)
        log(f"scan generated in {time.time() - t0:.1f}s")
        seg_launches, seg_pxs = phase_main_path(tmp, scan,
                                                args.profile_dir)
        phase_determinism(tmp, scan)
        dense_launches, dense_pxs = phase_fallback_path(tmp, scan,
                                                        args.profile_dir)
        orient_launches, orient_pxs, gather = phase_orientation_path(
            tmp, scan, args.profile_dir)
        err["rank_sum_gather"], ms["rank_sum_gather"], \
            bounds["rank_sum_gather"], extra["rank_sum_gather"] = gather
        others = phase_other_paths(tmp, scan, args.profile_dir)
        _, batch_pxs = phase_view_batch(tmp, scan)
        multi, (probe_launches, probe_err) = phase_multi_rank(tmp, scan)
        dtu_launches, dtu, dtu_ckpt = phase_dtu_recipe(tmp,
                                                       args.profile_dir)
        recipe = phase_recipe_kernels(device, dtu_ckpt, dtu_launches)
        if args.full:
            phase_full(tmp)
            phase_full_dtu(tmp)
    log(f"steady epochs (epoch >= 1): seg path {seg_pxs} Mpx/s; fallback "
        f"run, dense two-level path {dense_pxs} Mpx/s; orientation path "
        f"{orient_pxs} Mpx/s; "
        + "; ".join(f"{path} path {pxs} Mpx/s"
                    for path, (_, pxs) in others.items())
        + f"; view batches of {VIEW_BATCH} {batch_pxs} Mpx/s; "
        + "; ".join(f"{name} ranks {pxs} Mpx/s"
                    for name, (pxs, _, _) in multi.items()))
    log(f"DTU recipe (phase 9): {dtu['train_wall_s']:.1f}s for "
        f"{DTU_EPOCHS} epochs, peak pairs {dtu['peak_pairs']}, capacity "
        f"steps {dtu['capacity_steps']}")
    log(f"band renders (phase 7a) launched {band_launches['segpair_fwd']} "
        f"of each seg kernel; the shard-sum probe under all-reduce err "
        f"{probe_err:.3g}")
    lab_launches = phase_lab_path()
    err_l, ms_l, bounds_l, extra_l = phase_lab_kernels(
        device, traced=args.profile_dir is not None)
    err.update(err_l)
    ms.update(ms_l)
    bounds.update(bounds_l)
    for name, keys in extra_l.items():
        extra.setdefault(name, {}).update(keys)
    # after phase 8: its profiler windows come after every in-process
    # training run, and phase 10's trace needs no device record
    slice_launches = phase_slice_tools(device)
    slice_launches["harness"] = phase_harness(device)
    slice_launches["scripts"] = phase_scripts()
    for path, counts in slice_launches.items():
        for name, n in counts.items():
            if n:
                extra.setdefault(name, {})[f"launches_{path}"] = n
    from edgegaussians_tpu_torch.ops import (
        knn, pair, rank_sum, raster_v1, raster_v2, segpair, shard_sum)
    kernels = []
    for name, source, replaces, launches in (
            ("segpair_fwd", segpair.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_segpair.py:277", seg_launches),
            ("segpair_bwd", segpair.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_segpair.py:345", seg_launches),
            ("raster_v2_fwd", raster_v2.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_raster_v2.py:94", dense_launches),
            ("raster_v2_bwd", raster_v2.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_raster_v2.py:146",
             dense_launches),
            ("knn", knn.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_knn.py:52", orient_launches),
            ("pair_fwd", pair.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_pair.py:152",
             others["pair_v4"][0]),
            ("pair_bwd", pair.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_pair.py:206",
             others["pair_v4"][0]),
            ("raster_v1_fwd", raster_v1.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_raster.py:90",
             others["single_v1"][0]),
            ("raster_v1_bwd", raster_v1.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/pallas_raster.py:97",
             others["single_v1"][0]),
            ("rank_sum", rank_sum.KERNEL_SOURCE,
             "edgegaussians_tpu/ops/composite.py:136 (_scatter_rows: an "
             "XLA scatter-add, no Pallas kernel)", seg_launches),
            ("rank_sum_gather", rank_sum.KERNEL_SOURCE,
             "edgegaussians_tpu/models/losses.py:154 (the backward of the "
             "gather means[nn_indices[:, k]]: an XLA scatter-add, no "
             "Pallas kernel)", orient_launches),
            ("shard_sum", shard_sum.KERNEL_SOURCE,
             "tests/test_vma.py:205, scripts/vma_pallas_repro.py:52",
             {"shard_sum": probe_launches}),
            *lab_kernel_rows(lab_launches)):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": ms[name][2] if len(ms[name]) > 2 else None,
            "device_ms": ms[name][3] if len(ms[name]) > 3 else None,
            **extra.get(name, {})})
        at = [(k, t) for k, t in recipe.items()
              if k == name or k.startswith(name + "_k")]
        if at:
            # the same kernel at the DTU recipe's sizes (phase 9's state)
            kernels[-1]["dtu"] = [dict(
                {kk: v for kk, v in t.items() if kk != "bound"},
                at=k, bound_ms=t["bound"][0], bound_by=t["bound"][1],
                launches_dtu_run=dtu_launches.get(name, 0))
                for k, t in at]
    print(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
