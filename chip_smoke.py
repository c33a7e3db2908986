"""On-card smoke run of the PyTorch/CUDA port's main paths (one NVIDIA GPU).

    python3 chip_smoke.py

Nine kernels: K1, the fused exact-ASW kernel (ops/cuda/asw_kernel.cu); K2,
the separable-ASW kernel (ops/cuda/asw_sep_kernel.cu); K3, the d-lanes
kernel for left-only ASW and box (ops/cuda/asw_dlanes_kernel.cu); K4, the
symmetric d-lanes kernel (ops/cuda/asw_sym_dlanes_kernel.cu); SGM, the
semi-global scan kernel (ops/cuda/sgm_kernel.cu); the stack kernel
(ops/cuda/stacks_kernel.cu), which builds both views' channel stacks for
K1-K4 in one launch a pair; the cost kernel (ops/cuda/cost_kernel.cu),
which builds the eager path's raw (H, W, D) cost volume in one launch; and
the disparity kernel (ops/cuda/disparity_kernel.cu), which turns every
route's WTA planes into the map in one launch; and the WTA kernel
(ops/cuda/wta_kernel.cu), which takes the eager volume's WTA planes in one
launch.
Phases, one line each per kernel or path; any failure exits non-zero:

  1. device  — refuses to run without CUDA; prints the card's name and
               power limit (nvidia-smi) and the torch / CUDA versions;
  2. build   — builds every kernel from ops/cuda/ (nvcc sm_90a, one library);
  3. small   — each kernel against its plain PyTorch version on the
               reference kernel tests' geometries (tests/test_pallas_kernel.py
               for K1, tests/test_pallas_dlanes.py for K2, K3 and K4, plus
               K3 at K = 65 and K4 at K = 63, their window bounds, and K3
               and K4 at heights of several of their tile plans' rows, not
               a multiple of them (K3 left-only and box, K4 also at
               D = 64); K3's box bit for bit;
               K2 the same, symmetric and left-only, over several row
               blocks, column tiles and d-chunks; K2's bfloat16 storage
               mode is held to its drift bar against float32); K1 also
               past its old easy shapes: D = 160 (more than one d-chunk)
               in each mode, r = 32, H and W not multiples of its tile
               plan, D = 1; K1's shard inputs (K1_SHARD_CASES:
               n_valid_cols < W, a d_window, the right-view strip, alone
               and together, in each mode, also at D = 160) at the same
               bars, the strip's d exact where its cost is finite; SGM bit
               for bit over SGM_SMALL_CASES (H = 1, W = 1, D from 1 to 128,
               the register path's limit, and past it to 6200, blocks that
               mix directions, zero and other penalties, 4 and 8 paths),
               each under the default plan and, where that is the
               register path, the long-D path too (sgm_check_plans);
  4. full    — the same comparison at full width: K1 on a synthetic 450x375
               pair, D=64, r=16, on kitti_tiled's config at 1242x375,
               D=128, and in box mode at tsukuba_ad_box's 384x288, D=16,
               r=4; K2 with kitti_sep and kitti_seplo, K3 with
               kitti_tiled's config in left-only ASW and in box (box bit
               for bit), K4 with
               kitti_tiled's config on kernel_layout="dlanes", all on a
               1242x375 pair, D=128, r=16, and K4 with
               middlebury_asw_full's on "dlanes" at 450x375, D=64; K4
               equals K1 over the same stacks bit for bit, all six planes,
               at every K4 geometry (the small cases and both pairs); SGM
               bit for bit over the port's raw cost volume of the 1242x375
               pair (kitti_sgm, D=128), 4 and 8 paths, under the same
               three plans;
  5. serve   — each path through StereoMatcher: middlebury_asw_full answers
               three uint8 requests and a batch of two, then kitti_tiled's
               config one 1242x375 D=128 pair (K1); kitti_sep three 1242x375
               requests and a batch of two and kitti_seplo one pair (K2),
               whose map must stay within SEP_CONTRACT of the exact one;
               kitti_tiled in left-only ASW three requests and a batch of
               two, and in box one pair (K3); kitti_tiled on "dlanes" one
               pair (K4), whose map must agree with K1's.  Launch counts are
               reset just before each path and read just after it: every
               kernel of the path must have launched (K1 6, K2 6, K3 5 + 1,
               K4 1 times) and no other, and the stack kernel once per
               launch of K1-K4 (here and in phase 7).  A "dlanes" config no d-lanes
               kernel supports (D = 256) must raise.  kitti_sgm three
               requests and a batch of two, and one 8-path pair (SGM 6,
               none on its long-D path, the cost kernel 6: one volume a
               pair), bad-2.0 < 5%, each map equal bit for bit to the same
               pipeline with the plain cost loop, the plain SGM and the
               plain post-process and the plain WTA planes (the WTA
               kernel 6: one per SGM launch); then middeval3_h_sgm's path
               (MIDDEVAL3_H_OVERRIDES: 8 paths, D = 256, uniqueness 10)
               on one 1440x994 pair, SGM 1 on the long-D path
               (sgm_kernel.long_launches 1), the cost kernel 1, the WTA
               kernel 1 and the disparity kernel 1, held the same way.  The confidence surface at
               middlebury_asw_full (K1), kitti_sep (K2) and kitti_sgm
               (SGM): disp equals match_pair's bit for bit, and
               lr_valid & (uniq_pct >= r) reproduces the
               uniqueness_ratio=r gate (fill and median off) for r = 5,
               15 but for at most 0.01% of pixels.  y_chunks: eager
               kitti_tiled at 1242x375 in 4 bands equals one band bit for
               bit (peak allocations printed), K1 with y_chunks=3 equals
               y_chunks=1.  On every path the disparity kernel launches
               once per map (once per band in row bands);
  6. times   — median ms per pair (CUDA events) of each kernel's wrapper
               and of its plain version, with the channel stacks built
               inside (ms, plain_ms) and over the
               same pre-built stacks (from_stacks_ms,
               plain_from_stacks_ms), and of the end-to-end call
               (e2e_ms): K1 at both ASW geometries and tsukuba_ad_box's
               box, K2 for both presets, K3
               for left-only ASW and box and K4 at 1242x375 D=128 and
               450x375 D=64; and K1 over the stacks of K3's and K4's
               configs (kernel_layout="xlanes"), so that each new kernel is
               timed against K1 on its function; K2's, K3's and K4's tile
               plans, and K2's peak allocation of one end-to-end call;
               the SGM kernel and its plain version over kitti_sgm's raw
               cost volume (4 and 8 paths), each of its phases launched
               alone, its rate over the 3 P - 1 volumes it moves
               (sgm_schedule_bytes) and its share of their floor, the
               kernel call's peak allocation, that volume's build, and
               kitti_sgm end to end with its peak allocation; the same
               for the long-D path over middeval3_h_sgm's 1440x994 D=256
               volume, 8 paths, bit for bit with its plain version first
               and beside sgm_bound's 0.875 ms (middeval3_times); the stack
               kernel against the plain stack build (both views, bit for
               bit, then timed: the kernel's device time by the profiler,
               both by CUDA events around a call) at 1242x375 D=128 and
               450x375 D=64 r=16, beside its byte bound (stacks_bound);
               the cost kernel against the plain loop over d (bit for bit,
               then timed the same way, and the plain loop by CUDA
               events) at 1242x375 D=128 and 450x375 D=64, beside its byte
               bound (cost_bound); the disparity kernel against the plain
               post-process over K2's planes at 1242x375 D=128 and K1's at
               450x375 D=64 (bit for bit, then timed the same way), beside
               its byte bound (disparity_bound); the WTA kernel against
               the plain WTA planes over the SGM volume S of kitti_sgm
               (1242x375 D=128, rbestd) and of middeval3_h_sgm (1440x994
               D=256, rbestd and ubest), bit for bit, then timed the same
               way beside its byte bound (wta_bound) and the plain
               planes' time;
  7. entry   — the user's entry points at 1242x375 D=128, launch counts
               read around each: whether the native codec built (the
               compiler's words if not); ``python -m
               aswstereomatch_torch.tools.serve --device cuda`` in a child
               process answers three kitti_sep requests (the third
               uint16_x256), kitti_tiled with the confidence planes and
               kitti_sgm, each equal bit for bit to the same request run
               here, refuses a wrong config keeping the connection and a
               malformed header dropping it, and is stopped; the time of a
               kitti_sep request's layers here (H2D, enqueue, pipeline,
               encode, D2H); ``aswstereomatch_torch.cli.main`` on a
               synthetic KITTI pair with kitti_tiled (K1 5) and its
               left-only weights (K3 5), bad-2.0 < 5%, the PNG read back;
               ``tools.sweep`` over 4 pairs (K2 4), resumed after two lost
               records (K2 2), and one pair fetched in f32 within 1/512 px
               of u16;
  8. sharded — parallel/'s layouts at 1242x375 D=128 on a virtual mesh of
               one card repeated ([cuda:0] x 4: the card runs the shards in
               turn, so a time here is no multi-card time), each equal bit
               for bit to the unsharded run and read for its launches:
               kitti_tiled y-, x- and d-sharded (K1 4 each) against K1;
               kitti_sep y (K2 4) against K2; left-only y (K3 4) against
               K3, x and d (K1 4) against K1 (kernel_layout="xlanes"); box
               x and d (K1 4) against K1; kitti_batch's two pairs on a 2x2
               mesh (K1 4) against their single maps; median ms of each
               layout and of its unsharded run.  Every K1 call of the x and
               d layouts (recorded in the counted run) against its plain
               version on the same inputs (check_k1_shard_call: a winner
               that differs must be a near-tie).  CPU inputs over the card
               mesh: kitti_tiled y, x and d through api.sharded_match_fn
               and kitti_batch through distributed.run_batch_distributed
               (K1 4 each), back on the CPU equal to the unsharded maps;
  9. tile    — one pair's tile axis across processes: 4 worker processes
               (``chip_smoke.py --tile-worker``) on the card over gloo
               (NCCL refuses two ranks on one card) run kitti_tiled y, x
               and d on tile 4, kitti_sep y, left-only y and kitti_batch on
               data 2 x tile 2 at 1242x375 D=128; each holds its shards
               against the unsharded map bit for bit and reads its
               launches; the launches summed over the processes must be
               phase 8's, one per shard; per-layout times and the bytes
               each exchange sent between processes are printed.  With two
               cards or more the same runs over NCCL, one card per
               process; otherwise it prints that NCCL was not run;
 10. tools   — the port's accuracy and validation tools
               (aswstereomatch_torch/tools/) run in this process on
               cuda:0, one line each with its time and the kernels'
               launches read around it: card_fuzz (24 trials from seed
               5000 and 6 d-window trials from 105000: kernel route vs
               eager, launches equal to kernel_for's prediction),
               fuzz_pipeline (12 trials from seed 1000), the flagship
               sharded check at 1242x375 D=128 r=16 (every row exact),
               run_baseline_configs, pin_sep_accuracy (seeds 0 1 2,
               symmetric and left-only), sym_vs_leftonly, compare_opencv
               (smooth at the five scene geometries, hard at kitti and
               venus) and refuse_curve (kitti, venus; seeds 7 8), both
               without their cv2 rows where cv2 does not import, and
               dataset_roundtrip (the five scenes, a CLI child process
               each).  The accuracy rows are held to the reference's
               records in bench_results/ at each tool's bars; the
               separable symmetric mode must meet SEP_CONTRACT, the
               left-only mode too unless the reference's own record
               misses it.  A tool fails on a missed bar, a kernel its
               configs route to that never launched, or a launch of any
               other; after all eleven runs (pin_sep_accuracy and
               compare_opencv run twice) the phase fails if any did.
               Records go to results_torch/;
 11. timing  — the port's serving and timing tools on cuda:0 at full size,
               one line each with its time and the launches in this
               process read around it (daemons and CLI or sweep children
               launch in their own): serve_bench (a daemon child, 4
               clients, 100 requests x 3 wires at kitti_sep, then 40 x 3
               at kitti_sgm; each wire's first answers bit for bit with
               this process's); serve_soak (a recycle soak of 48 requests from
               2 clients at a measured RSS limit, >= 1 restart on 42, and
               a steady soak of 1000 requests from 4 clients; 0 unstable
               answers and 0 errors in both; RSS curves and restart costs
               printed); soak_runner around a sweep child over
               SWEEP_SOAK_PAIRS kitti_sep pairs (RSS first / peak / last,
               pairs/s); profile_stages at kitti, symmetric (K1),
               left-only and box (K3), separable (K2), the routed kernel
               launched once per call in every rung; bench_separable at
               kitti, its accuracy held to bench_results/separable_ab.json;
               headline_variance (a chain of 20 kitti_sep pairs, 3 CLI
               sessions: device busy per pair against the sessions'
               mean_s); the warm hook's body on a change to
               ops/cuda/asw_kernel.cu, its child's library equal to
               build.library_path().  Every tool runs; then the phase
               fails if any missed a check, and prints its total time.

Before the last line it prints one JSON object with a row per kernel (its
bound_ms from this run's shapes and the function's least work, see
k1_bound / k2_bound / box_bound / sgm_bound / stacks_bound / cost_bound /
disparity_bound / wta_bound); the last line is
{"ok": true, "device": {...}}.  Imports torch, numpy and the port only (no
jax).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# Phase-3 geometries and bars: tests/test_pallas_kernel.py's K1 fixtures.
# (name, config overrides, (H, W), make_pair kwargs, bar): bar "exact" holds
# bestd / rbestd exactly and the float planes at a tolerance (_check_exact),
# a number is the argmin agreement both views must exceed.
_BASE = dict(max_disparity=8, cost="tad_grad", aggregation="asw",
             window_radius=2, gamma_color=14.0, gamma_spatial=9.0)
SMALL_CASES = [
    ("symmetric", {}, (24, 40), dict(seed=3), "exact"),
    ("left_only", dict(asw_symmetric=False), (24, 40), dict(seed=3), "exact"),
    ("ad_cost", dict(cost="ad"), (24, 40), dict(seed=3), "exact"),
    ("multi_xtile", {}, (16, 200), dict(seed=3), "exact"),
    ("r0_d2", dict(max_disparity=2, window_radius=0), (13, 24),
     dict(seed=6, num_layers=1), "exact"),
    ("r1_d4", dict(max_disparity=4, window_radius=1), (11, 40),
     dict(seed=6, num_layers=1), "exact"),
    ("one_tile", {}, (8, 128), dict(seed=6, num_layers=1), "exact"),
    # D > 8 and not a multiple of 8: disparity groups past D
    ("r1_d12", dict(max_disparity=12, window_radius=1), (16, 48), dict(seed=3), "exact"),
    ("d20", dict(max_disparity=20), (24, 48), dict(seed=3), "exact"),
    ("box_ad", dict(aggregation="box", cost="ad", window_radius=3), (24, 40),
     dict(seed=12), 0.999),
    ("box_tad", dict(aggregation="box", window_radius=3), (24, 40),
     dict(seed=12), 0.999),
    # Beyond the one-thread-per-pixel kernel's easy shapes: D over one
    # d-chunk of 128 (the WTA state carried across chunks, the right view
    # folded per chunk) in each mode; the largest window of the K2-K4 cases;
    # H and W not multiples of the tile plan's rows and columns; D = 1.
    ("d160_r2", dict(max_disparity=160), (16, 200), dict(seed=3), "exact"),
    ("d160_left_only", dict(max_disparity=160, asw_symmetric=False), (16, 200),
     dict(seed=3), "exact"),
    ("d160_box", dict(max_disparity=160, aggregation="box"), (16, 200), dict(seed=3), 0.999),
    ("r32_d16", dict(max_disparity=16, window_radius=32), (10, 70), dict(seed=3), "exact"),
    ("ragged", {}, (45, 150), dict(seed=3), "exact"),
    ("d1", dict(max_disparity=1, window_radius=1), (9, 20), dict(seed=3), "exact"),
]


# K1's shard inputs, the sharded layouts' (parallel/): (name, config
# overrides, (H, W), make_pair kwargs, shard inputs, bar) as SMALL_CASES.
K1_SHARD_CASES = [
    ("window", {}, (24, 40), dict(seed=3), dict(d_window=(1, 7)), "exact"),
    ("n_valid", {}, (24, 40), dict(seed=3), dict(n_valid_cols=33), "exact"),
    ("strip", {}, (16, 200), dict(seed=3), dict(want_strip=True), "exact"),
    # a d-shard's call: one overlap d each side, every column real, the strip
    ("dshard_form", dict(max_disparity=10), (24, 48), dict(seed=3),
     dict(n_valid_cols=48, d_window=(1, 9), want_strip=True), "exact"),
    ("all_left_only", dict(asw_symmetric=False), (24, 40), dict(seed=3),
     dict(n_valid_cols=31, d_window=(2, 6), want_strip=True), "exact"),
    ("all_box", dict(aggregation="box", window_radius=3), (24, 40), dict(seed=12),
     dict(n_valid_cols=31, d_window=(2, 6), want_strip=True), 0.999),
    # more than one d-chunk: the window across chunks, a strip of 159 columns
    ("d160_all", dict(max_disparity=160), (16, 200), dict(seed=3),
     dict(n_valid_cols=190, d_window=(20, 150), want_strip=True), "exact"),
    ("d160_left_only_last_chunk", dict(max_disparity=160, asw_symmetric=False), (16, 200),
     dict(seed=3), dict(d_window=(129, 160), want_strip=True), "exact"),
]


# K2's phase-3 fixtures: tests/test_pallas_dlanes.py:273-290 (SEP, mostly
# symmetric) and the left-only ones of :318-323.
_SEP = dict(asw_separable=True, asw_symmetric=False)
_SYM = dict(_SEP, asw_symmetric=True)
SEP_SMALL_CASES = [
    ("sep_sym", _SYM, (24, 40), dict(seed=3), "exact"),
    ("sep_leftonly", _SEP, (24, 40), dict(seed=3), "exact"),
    ("sep_ad_cost", dict(_SYM, cost="ad"), (24, 40), dict(seed=3), "exact"),
    ("sep_multitile_odd", _SYM, (21, 150), dict(seed=3), "exact"),
    ("sep_d16_r3", dict(_SYM, max_disparity=16, window_radius=3), (20, 100),
     dict(seed=3), "exact"),
    ("sep_d128_multinb", dict(_SYM, max_disparity=128), (16, 192), dict(seed=3), "exact"),
    ("sep_k33_flagship", dict(_SYM, max_disparity=16, window_radius=16), (12, 80),
     dict(seed=3), "exact"),
    ("sep_k65_boundary", dict(_SYM, max_disparity=16, window_radius=32), (10, 70),
     dict(seed=3), "exact"),
    ("sep_leftonly_small", _SEP, (24, 40), dict(seed=3), "exact"),
    ("sep_leftonly_k33", dict(_SEP, max_disparity=16, window_radius=16), (12, 80),
     dict(seed=3), "exact"),
    # Blocks of several output rows (tile plan (6, 72, 32, 11) in both
    # modes): H at least 3 x TY and not a multiple of it, r >= 4, more than
    # one d-chunk and column tile, so that whole multi-row blocks, a partial
    # last block and the clamped top and bottom rows are held exactly
    # (tests/test_torch_sep_tile_plan.py checks these plans).
    ("sep_rows_sym", dict(_SYM, max_disparity=40, window_radius=5), (41, 130),
     dict(seed=3), "exact"),
    ("sep_rows_left_only", dict(_SEP, max_disparity=40, window_radius=5), (41, 130),
     dict(seed=3), "exact"),
]
# K2's bfloat16 storage mode, both weight modes (test_pallas_dlanes.py:346-365)
SEP_BF16_CASES = [("sep_bf16_sym", True), ("sep_bf16_leftonly", False)]

# K3's phase-3 fixtures: tests/test_pallas_dlanes.py:32-46 (left-only ASW)
# and :95-115 (box pinned to "dlanes"), exact; and K = 65, its bound.
_LO = dict(asw_symmetric=False)
_BOX = dict(max_disparity=16, aggregation="box", window_radius=3, kernel_layout="dlanes")
DLANES_SMALL_CASES = [
    ("dl_base", _LO, (24, 40), dict(seed=3), "exact"),
    ("dl_ad_cost", dict(_LO, cost="ad"), (24, 40), dict(seed=3), "exact"),
    ("dl_multitile_odd", _LO, (21, 150), dict(seed=3), "exact"),
    ("dl_d16_r3", dict(_LO, max_disparity=16, window_radius=3), (20, 100), dict(seed=3),
     "exact"),
    ("dl_d128_multinb", dict(_LO, max_disparity=128), (16, 192), dict(seed=3), "exact"),
    ("dl_box_one", _BOX, (24, 40), dict(seed=3), "exact"),
    ("dl_box_multi", _BOX, (21, 150), dict(seed=3), "exact"),
    ("dl_k65_boundary", dict(_LO, max_disparity=16, window_radius=32), (10, 70),
     dict(seed=3), "exact"),
    # Blocks of several output rows (tile plans (8, 32, 128) and (8, 56, 64)):
    # H at least 3 x TY and not a multiple of it, so that whole multi-row
    # blocks, a partial last block and the clamped rows are held exactly
    # (tests/test_torch_dlanes_tile_plan.py checks these plans).
    ("dl_rows_left_only", dict(_LO, max_disparity=128, window_radius=3), (29, 150),
     dict(seed=3), "exact"),
    ("dl_rows_box", dict(_BOX, max_disparity=64), (29, 150), dict(seed=3), "exact"),
]
# K4's: tests/test_pallas_dlanes.py:185-196 and K = 63, its bound, at the
# reference's bar for this kernel (argmin agreement > 99.5%, :211-218).
_SYMDL = dict(kernel_layout="dlanes")
SYM_DLANES_SMALL_CASES = [
    ("sdl_base", _SYMDL, (24, 40), dict(seed=3), 0.995),
    ("sdl_multitile_odd", _SYMDL, (21, 150), dict(seed=3), 0.995),
    ("sdl_d16_r3", dict(_SYMDL, max_disparity=16, window_radius=3), (20, 100),
     dict(seed=3), 0.995),
    ("sdl_d128_multinb", dict(_SYMDL, max_disparity=128), (16, 192), dict(seed=3), 0.995),
    ("sdl_k63_boundary", dict(_SYMDL, max_disparity=16, window_radius=31), (10, 70),
     dict(seed=3), 0.995),
    # Blocks of several output rows (tile plans (4, 72, 40, 11) and
    # (6, 32, 64, 9)): H at least 3 x TY and not a multiple of it, so that
    # whole multi-row blocks, a partial last block and the clamped rows are
    # held; the second at D = 64, where one d-chunk fills every consumer
    # thread (tests/test_torch_sym_dlanes_tile_plan.py checks these plans).
    ("sdl_rows", dict(_SYMDL, max_disparity=40, window_radius=5), (29, 130), dict(seed=3),
     0.995),
    ("sdl_rows_d64", dict(_SYMDL, max_disparity=64, window_radius=4), (29, 150),
     dict(seed=3), 0.995),
]
# K4's full-width pairs (phases 4 and 6): (name, preset, (H, W), make_pair seed),
# each on kernel_layout="dlanes".
K4_FULL_CASES = [
    ("sdl_kitti", "kitti_tiled", (375, 1242), 31),
    ("sdl_middlebury", "middlebury_asw_full", (375, 450), 11),
]

# The SGM kernel's phase-3 geometries: (name, (H, W, D), paths, P1, P2) over
# a random cost volume.  Lines of one pixel (H = 1, W = 1); on the register
# path D = 4 (one lane holds disparities, the rest idle), 12 to 40, and
# D = 128, its limit; D = 1, 2, 5, 33, 97 and 102, not multiples of 4, go
# to the long-D path, as D = 129 to 6142 do with their L rows in shared
# memory, and D = 6200, whose two L rows outgrow a warp's shared memory and
# go to the global scratch; other and zero penalties; H = 3, W = 200, whose
# phase-A blocks mix rows of two directions with columns (and diagonals of
# three in phase C).
SGM_SMALL_CASES = [
    ("sgm_h1", (1, 40, 16), 8, 8.0, 32.0),
    ("sgm_w1", (40, 1, 16), 8, 8.0, 32.0),
    ("sgm_1x1", (1, 1, 5), 8, 8.0, 32.0),
    ("sgm_d1", (17, 23, 1), 8, 8.0, 32.0),
    ("sgm_d2", (17, 23, 2), 4, 3.0, 50.0),
    ("sgm_d33", (21, 30, 33), 8, 8.0, 32.0),
    ("sgm_d129", (12, 40, 129), 8, 3.0, 50.0),
    ("sgm_d256_4", (9, 31, 256), 4, 0.0, 0.0),
    ("sgm_d256_8", (9, 31, 256), 8, 8.0, 32.0),
    ("sgm_zero_pen", (20, 28, 12), 8, 0.0, 0.0),
    ("sgm_tall", (50, 7, 40), 4, 3.0, 50.0),
    ("sgm_scratch_d6200", (3, 5, 6200), 8, 8.0, 32.0),
    ("sgm_mixed_h3", (3, 200, 24), 4, 8.0, 32.0),
    ("sgm_mixed_h3_8", (3, 200, 40), 8, 3.0, 50.0),
    ("sgm_d97", (13, 29, 97), 4, 3.0, 50.0),
    ("sgm_d102", (11, 17, 102), 8, 8.0, 32.0),
    ("sgm_d128", (10, 23, 128), 8, 3.0, 50.0),
    ("sgm_d255", (6, 9, 255), 8, 8.0, 32.0),
    ("sgm_d257", (7, 19, 257), 8, 8.0, 32.0),
    ("sgm_rows_d6142", (2, 3, 6142), 4, 8.0, 32.0),
    ("sgm_d4", (17, 23, 4), 8, 3.0, 50.0),
]

# Published peaks of one H100 SXM (NVIDIA's data sheet, the dense rates at
# the 700 W limit): FP32 outside the tensor cores, HBM3.  The special
# function units (exp2, rsqrt) return 16 results per clock per SM against
# 128 FP32 lanes doing 2 flops (an FMA) each: 1/16 of the FP32 flop rate.
FP32_FLOPS = 67e12
MUFU_OPS = FP32_FLOPS / 16
HBM_BYTES = 3.35e12


def _bound(flops: float, mufu: float, nbytes: float) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operation
    time (FP32 flops and special-function ops at their peaks) and the byte
    time over the memory rate."""
    ops_s = max(flops / FP32_FLOPS, mufu / MUFU_OPS)
    bytes_s = nbytes / HBM_BYTES
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes")


def k1_bound(H: int, W: int, cfg) -> tuple:
    """K1's function (exact ASW) at its least work.  Per (pixel, d, tap):
    the weight product, the num FMA and the den add in symmetric mode (4
    flops); in left-only mode only the num FMA, since den does not depend
    on d (one add per (pixel, tap)).  Each distinct weight once, an expf +
    sqrtf and ~10 flops: the left one per (pixel, tap), the right one per
    (right column x - d, tap).  Each distinct raw cost once, ~12 flops per
    (row, extended column, d).  Bytes: the two stacks in, six (H, W)
    planes out."""
    assert cfg.aggregation == "asw", "the bound counts ASW work"
    r, D = cfg.window_radius, cfg.max_disparity
    K = 2 * r + 1
    sym = cfg.asw_symmetric
    taps = H * W * D * K * K
    weights = H * K * K * (W + ((W + D - 1) if sym else 0))
    flops = (4 * taps if sym else 2 * taps + H * W * K * K)
    flops += 10 * weights + 12 * H * (W + 2 * r) * D
    nbytes = 4 * (7 * H * (W + 2 * r) + 7 * H * (W + 2 * r + D - 1) + 6 * H * W)
    return _bound(flops, 2.0 * weights, nbytes)


def k2_bound(H: int, W: int, cfg) -> tuple:
    """K2's function (separable ASW) at its least work.  Symmetric mode:
    per vertical tap (H*(W+2r)*D*K) the weight product, num FMA and den add
    (4 flops), per horizontal tap (H*W*D*K) the weight product and two FMAs
    (5 flops).  Left-only mode: one num FMA per tap, den once per (column,
    tap), as it does not depend on d.  Each entry of the 1-D weight planes
    once (an expf + sqrtf and ~10 flops); each raw cost once, ~12 flops per
    (row, extended column, d).  Bytes: the stacks in, six (H, W) planes out
    (the kernel's weight-plane scratch is not the function's)."""
    r, D = cfg.window_radius, cfg.max_disparity
    K = 2 * r + 1
    sym = cfg.asw_symmetric
    WL, WR = W + 2 * r, W + 2 * r + D - 1
    vtaps, htaps = H * WL * D * K, H * W * D * K
    entries = H * K * (WL + W + ((WR + W + D - 1) if sym else 0))
    flops = (4 * vtaps + 5 * htaps if sym
             else 2 * (vtaps + htaps) + H * K * (WL + 2 * W))
    flops += 10 * entries + 12 * H * WL * D
    nbytes = 4 * (7 * H * (WL + WR) + 6 * H * W)
    return _bound(flops, 2.0 * entries, nbytes)


def box_bound(H: int, W: int, cfg) -> tuple:
    """The box function at its least work: separable running sums, ~4
    flops per (pixel, d) (an add and a subtract along each axis), and each
    raw cost once, ~12 flops per (row, extended column, d); not the K^2
    taps per (pixel, d) of a direct window sum.  Bytes: the two stacks in,
    six (H, W) planes out."""
    assert cfg.aggregation == "box", "the bound counts box work"
    r, D = cfg.window_radius, cfg.max_disparity
    flops = 4 * H * W * D + 12 * H * (W + 2 * r) * D
    nbytes = 4 * (7 * H * (W + 2 * r) + 7 * H * (W + 2 * r + D - 1) + 6 * H * W)
    return _bound(flops, 0.0, nbytes)


def sgm_bound(H: int, W: int, cfg) -> tuple:
    """SGM's function at its least work: bytes, one read of the raw (H, W,
    D) cost volume and one write of S, 2 x 4 H W D (the kernel's one pass
    per direction moves 3 P - 1 volumes for P paths).  Operations: per
    (pixel, d, path) two adds of a penalty, three mins, the add and the
    subtract of the step and the add into S, 8 FP32 operations."""
    assert cfg.aggregation == "sgm", "the bound counts SGM work"
    n = H * W * cfg.max_disparity
    return _bound(8.0 * n * cfg.sgm_paths, 0.0, 2 * 4 * n)


def stacks_bound(H: int, W: int, r: int, D: int) -> tuple:
    """Both views' channel stacks at their least traffic: the two float32
    (H, W, 3) images read once and the stacks (7, H, W + 2r) and (7, H,
    W + 2r + D - 1) written once.  The ~200 FP32 operations a pixel (15 of
    them IEEE divisions) take less time than the bytes at these rates."""
    nbytes = 4 * (2 * 3 * H * W + 7 * H * (2 * (W + 2 * r) + D - 1))
    return _bound(0.0, 0.0, nbytes)


def cost_bound(H: int, Wo: int, C: int, D: int) -> tuple:
    """The raw cost volume at its least traffic: the edge-padded planes of
    ``cost.precompute`` read once (colour (H, Wo, C) and (H, Wo + D - 1, C),
    gradient (H, Wo) and (H, Wo + D - 1)) and the (H, Wo, D) volume written
    once.  Its ~15 FP32 operations an element take less time than its 4
    bytes at these rates."""
    nbytes = 4 * (H * (2 * Wo + D - 1) * (C + 1) + H * Wo * D)
    return _bound(0.0, 0.0, nbytes)


def disparity_bound(H: int, W: int, cfg) -> tuple:
    """The map from the WTA planes at its least traffic: the planes the
    config reads (bestd, bestc, cm, cp; rbestd with the LR check, ubest
    with the uniqueness gate) read once and the float32 map written once.
    Its ~30 FP32 operations a pixel take less time than its bytes."""
    planes = 4 + int(cfg.lr_check) + int(cfg.uniqueness_ratio > 0)
    return _bound(0.0, 0.0, 4 * H * W * (planes + 1))


def wta_bound(H: int, W: int, cfg) -> tuple:
    """The WTA planes of an (H, W, D) volume at their least traffic: the
    float32 volume read once and the planes the config asks for written
    once (bestd, bestc, cm, cp; rbestd with the LR check, ubest with the
    uniqueness gate).  Its few operations an element take less time than
    its 4 bytes."""
    planes = 4 + int(cfg.lr_check) + int(cfg.uniqueness_ratio > 0)
    return _bound(0.0, 0.0, 4 * H * W * (cfg.max_disparity + planes))


def wta_times(card: str, label: str, S, cfg) -> dict:
    """Phase 6's WTA rows: the WTA kernel over the SGM volume S against the
    plain WTA planes (the config's planes, bit for bit), then the kernel's
    device time (profiler), both by CUDA events around a call, beside
    wta_bound."""
    import torch

    from aswstereomatch_torch.ops.cuda import wta_kernel

    H, W, D = S.shape
    kw = {"rbestd": cfg.lr_check, "ubest": cfg.uniqueness_ratio > 0}
    got, want = wta_kernel.wta_planes(S, **kw), wta_kernel.reference(S, **kw)
    for k in want:
        g, w = got[k], want[k]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            fail(f"times {label}: the WTA kernel's {k} differs from the plain planes on "
                 f"{int((g != w).sum())} pixels")
    del got, want
    bound_ms, bound_by = wta_bound(H, W, cfg)
    t = {  # ms: the kernel's device time; call_ms: CUDA events around a call
        "ms": _device_ms(lambda: wta_kernel.wta_planes(S, **kw), "wta_planes_kernel", 50),
        "call_ms": _median_ms(lambda: wta_kernel.wta_planes(S, **kw), 50),
        "plain_ms": _median_ms(lambda: wta_kernel.reference(S, **kw), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(f"times {label} on {card}: WTA kernel {t['ms']:.4f} ms on the card "
          f"({t['call_ms']:.4f} ms by CUDA events around a call), bit for bit with the plain "
          f"planes, {[k for k, on in kw.items() if on]} among them (bound {bound_ms:.4f} ms by "
          f"{bound_by}, "
          f"{100 * bound_ms / t['ms']:.1f}%); plain planes {t['plain_ms']:.3f} ms by CUDA "
          f"events around a call", flush=True)
    return t


def sgm_schedule_bytes(H: int, W: int, cfg) -> int:
    """The bytes the SGM kernel's schedule moves: each direction reads C and
    writes its L once, and the sums read S and the two scratch volumes back
    in the pinned order, 3 P - 1 (H, W, D) float32 volumes for P paths (11
    and 23).  No schedule that writes each L to device memory once moves
    fewer; sgm_bound counts the function's least, 2."""
    assert cfg.aggregation == "sgm", "the schedule is SGM's"
    return (3 * cfg.sgm_paths - 1) * 4 * H * W * cfg.max_disparity


def sgm_check_plans(H: int, W: int, D: int, paths: int) -> list:
    """The plans each SGM check runs: the default, and where that is the
    register path also the long-D path."""
    from aswstereomatch_torch.ops.cuda import sgm_kernel

    best = sgm_kernel.plan(H, W, D, paths)
    out = [best]
    if best.vpl:
        out.append(sgm_kernel.plan(H, W, D, paths, vpl=0))
    return out


def check_sgm(name, shape, paths, p1, p2, device) -> int:
    """The SGM kernel under each of sgm_check_plans against its plain
    version on a random (H, W, D) cost volume, bit for bit (both take the
    reference's adds and mins in its order).  Returns the launches it
    made; raises AssertionError."""
    import torch

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import sgm_kernel

    H, W, D = shape
    cfg = StereoConfig(aggregation="sgm", max_disparity=D, sgm_paths=paths,
                       sgm_p1=p1, sgm_p2=p2)
    rng = np.random.default_rng(H * 1000 + W + D)
    vol = torch.from_numpy((rng.random(shape) * 40.0).astype(np.float32)).to(device)
    ref = sgm_kernel.aggregate_reference(vol, cfg)
    plans = sgm_check_plans(H, W, D, paths)
    for i, plan in enumerate(plans):
        got = sgm_kernel.aggregate(vol, cfg, None if i == 0 else plan)
        desc = f"{name} (vpl {plan.vpl})"
        assert got.shape == ref.shape and torch.isfinite(got).all(), f"{desc}: bad output"
        assert torch.equal(got, ref), (
            f"{desc}: differs from the plain version on {int((got != ref).sum())} of "
            f"{ref.numel()} values, max |diff| {float((got - ref).abs().max())}")
    return len(plans)


# The middeval3_h_sgm deployment (benchmark/configs/middeval3_h_sgm.json):
# kitti_sgm with these overrides on a 1440x994 pair.  D = 256 is past the
# register path's 128, so its SGM scan runs on the long-D path.
MIDDEVAL3_H_OVERRIDES = {"sgm_paths": 8, "max_disparity": 256, "uniqueness_ratio": 10.0}
MIDDEVAL3_H_SHAPE = (994, 1440)


def middeval3_serve(reset, launched, check_map) -> dict:
    """Phase 5's middeval3_h_sgm path: one 1440x994 uint8 pair through
    StereoMatcher, launch counts reset just before it: the raw volume in one
    cost kernel launch, its scan in one SGM kernel call on the long-D path,
    the map in one disparity kernel launch with the uniqueness gate on, and
    no other kernel.  The same pipeline with the plain cost loop, the plain
    SGM and the plain post-process on the card gives the map bit for bit.
    Returns the matcher, its uint8 pair and the map's bad-2.0."""
    import aswstereomatch_torch
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import (cost_kernel, disparity_kernel, sgm_kernel,
                                               wta_kernel)
    from aswstereomatch_torch.utils import synthetic

    H, W = MIDDEVAL3_H_SHAPE
    m = aswstereomatch_torch.StereoMatcher.from_preset("kitti_sgm", **MIDDEVAL3_H_OVERRIDES)
    D = m.cfg.max_disparity
    if (pipeline._resolve_backend(m.cfg, m.device) != "eager"
            or pipeline.kernel_for(m.cfg) is not None
            or sgm_kernel.plan(H, W, D, m.cfg.sgm_paths).vpl):
        fail(f"serve: {m.cfg} does not resolve to the eager path and the SGM kernel's "
             f"long-D path")
    p = synthetic.make_pair(height=H, width=W, max_disparity=D, seed=51)
    lu, ru = p["left"].astype(np.uint8), p["right"].astype(np.uint8)
    reset()
    got = m(lu, ru).cpu().numpy()
    launched("middeval3_h_sgm's path", {"SGM": 1}, maps=1)
    if sgm_kernel.long_launches != 1 or cost_kernel.launches != 1 or wta_kernel.launches != 1:
        fail(f"serve: middeval3_h_sgm's path ran {sgm_kernel.long_launches} long-D SGM "
             f"volumes, {cost_kernel.launches} cost kernel launches and "
             f"{wta_kernel.launches} WTA kernel launches, expected 1, 1 and 1")
    bad = check_map("middeval3_h_sgm", got, p, D, 0.05)
    kernel_aggregate, kernel_cost = sgm_kernel.aggregate, cost_kernel.cost_volume
    kernel_map, kernel_planes = disparity_kernel.disparity_map, wta_kernel.planes
    sgm_kernel.aggregate = sgm_kernel.aggregate_reference
    cost_kernel.cost_volume = cost_kernel.reference
    disparity_kernel.disparity_map = disparity_kernel.reference
    wta_kernel.planes = wta_kernel.reference
    reset()
    try:
        want = m(lu, ru).cpu().numpy()
    finally:
        sgm_kernel.aggregate, cost_kernel.cost_volume = kernel_aggregate, kernel_cost
        disparity_kernel.disparity_map, wta_kernel.planes = kernel_map, kernel_planes
    launched("the plain middeval3_h_sgm pipeline", {}, maps=0)
    if cost_kernel.launches or sgm_kernel.long_launches or wta_kernel.launches:
        fail("serve: the plain middeval3_h_sgm pipeline launched the cost, the SGM or the WTA "
             "kernel")
    if not np.array_equal(got, want):
        fail(f"serve: middeval3_h_sgm differs from the plain pipeline on "
             f"{int((got != want).sum())} pixels")
    return {"matcher": m, "left": lu, "right": ru, "bad_2": bad}


def middeval3_times(card: str, dev, served: dict) -> dict:
    """Phase 6's middeval3_h_sgm row: the SGM kernel on its long-D path over
    the raw cost volume of phase 5's pair (1440x994, D = 256, 8 paths), bit
    for bit with its plain version, then both timed by CUDA events around a
    call, each phase alone, the kernel's rate over the volumes it moves and
    its share of sgm_bound (0.875 ms); the raw volume's build, and the call
    end to end with its peak allocation above what the script holds."""
    import torch

    from aswstereomatch_torch.ops import cost as cost_ops
    from aswstereomatch_torch.ops.cuda import sgm_kernel
    from aswstereomatch_torch.utils import plan_sweep

    m, lu, ru = served["matcher"], served["left"], served["right"]
    c = m.cfg
    H, W = MIDDEVAL3_H_SHAPE
    l = torch.from_numpy(lu).to(dev).float()
    r = torch.from_numpy(ru).to(dev).float()
    vol = cost_ops.cost_volume(l, r, c)
    got, ref = sgm_kernel.aggregate(vol, c), sgm_kernel.aggregate_reference(vol, c)
    if not (torch.isfinite(got).all() and torch.equal(got, ref)):
        fail(f"times: SGM middeval3_h_sgm differs from its plain version on "
             f"{int((got != ref).sum())} of {ref.numel()} values")
    del ref
    wta = wta_times(card, f"wta middeval3_h_sgm {W}x{H} D={c.max_disparity}", got, c)
    del got
    plan = sgm_kernel.plan(H, W, c.max_disparity, c.sgm_paths)
    bound_ms, bound_by = sgm_bound(H, W, c)
    t = {
        "ms": _median_ms(lambda: sgm_kernel.aggregate(vol, c), 5),
        "plain_ms": _median_ms(lambda: sgm_kernel.aggregate_reference(vol, c), 1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "phase_ms": plan_sweep.sgm_phase_ms(vol, c, plan, 5),
        "cost_volume_ms": _median_ms(lambda: cost_ops.cost_volume(l, r, c), 5),
        "e2e_ms": _median_ms(lambda: m(lu, ru), 5),
    }
    schedule_bytes = sgm_schedule_bytes(H, W, c)
    floor_ms = schedule_bytes / HBM_BYTES * 1e3
    t["gb_per_s"] = schedule_bytes / (t["ms"] * 1e-3) / 1e9
    del vol
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m(lu, ru)
    torch.cuda.synchronize()
    t["peak_alloc_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
    print(f"times SGM middeval3_h_sgm {W}x{H} D={c.max_disparity} {c.sgm_paths} paths, long-D "
          f"path, on {card}: kernel {t['ms']:.3f} ms, bit for bit with its plain version "
          f"(bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / t['ms']:.2f}%; "
          f"{3 * c.sgm_paths - 1} volumes {schedule_bytes} B at {t['gb_per_s']:.1f} GB/s, "
          f"{100 * floor_ms / t['ms']:.1f}% of their {floor_ms:.3f} ms floor); phases alone "
          + " / ".join(f"{x:.3f}" for x in t["phase_ms"])
          + f" ms; plain {t['plain_ms']:.3f} ms; raw cost volume (the cost kernel) "
          f"{t['cost_volume_ms']:.3f} ms; end-to-end {t['e2e_ms']:.3f} ms/pair; peak "
          f"allocation of a call {t['peak_alloc_mib']:.3f} MiB", flush=True)
    t["wta"] = wta
    return t


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def _kernel_module(cfg, kernel=None):
    """The port's kernel module named ``kernel`` (a module of ops/cuda), or
    by default K2 for a separable config and K1 otherwise."""
    import importlib

    if kernel is None:
        kernel = "asw_sep_kernel" if cfg.asw_separable else "asw_kernel"
    return importlib.import_module(f"aswstereomatch_torch.ops.cuda.{kernel}")


def check_small(name, overrides, shape, pair_kw, bar, device, kernel=None) -> dict:
    """Kernel vs plain version on one phase-3 case (``kernel`` as
    _kernel_module picks it); raises AssertionError."""
    import torch

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**_BASE, **overrides})
    module = _kernel_module(cfg, kernel)
    D = cfg.max_disparity
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, **pair_kw)
    l = torch.from_numpy(p["left"]).to(device)
    r = torch.from_numpy(p["right"]).to(device)
    got = {k: v.cpu().numpy() for k, v in module.wta_outputs(l, r, cfg).items()}
    ref = {k: v.cpu().numpy() for k, v in module.wta_outputs_reference(l, r, cfg).items()}
    if module.__name__.endswith(".asw_dlanes_kernel") and cfg.aggregation == "box":
        _check_bits(name, got, ref, D)
    if bar == "exact":
        # bars of test_pallas_kernel.py:55-71 and :160-162 (K1) and
        # test_pallas_dlanes.py:56-77, :304-312 (K2, K3: float sums in
        # another order)
        _check_exact(name, got, ref, D, dict(rtol=1e-5, atol=1e-4)
                     if module.__name__.endswith(".asw_kernel")
                     else dict(rtol=1e-4, atol=1e-3))
    else:
        # argmin agreement: K1's box bar (test_pallas_kernel.py:173-178) and
        # K4's (test_pallas_dlanes.py:211-218)
        agree = float((got["bestd"] == ref["bestd"]).mean())
        ragree = float((got["rbestd"] == ref["rbestd"]).mean())
        assert agree > bar and ragree > bar, f"{name}: agree {agree} / {ragree}"
        np.testing.assert_allclose(got["bestc"], ref["bestc"], rtol=1e-4, atol=1e-3,
                                   err_msg=f"{name} bestc")
    return {"case": name, "max_abs_err": float(np.abs(got["bestc"] - ref["bestc"]).max())}


def check_k1_shard(name, overrides, shape, pair_kw, shard, bar, device) -> dict:
    """K1 with shard inputs against its plain version over the same stacks:
    ``bar`` as check_small's; with the strip, rbestc and r_strip_c at the
    float tolerance (inf where no candidate reaches a column) and r_strip_d
    exact where its cost is finite, 0 elsewhere.  Raises AssertionError."""
    import torch

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_kernel, common
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**_BASE, **overrides})
    D = cfg.max_disparity
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, **pair_kw)
    ls, rs = common.stacks(torch.from_numpy(p["left"]).to(device),
                           torch.from_numpy(p["right"]).to(device), cfg)
    before = asw_kernel.launches
    got = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, **shard)
    assert asw_kernel.launches == before + 1, f"{name}: the kernel did not launch"
    got = {k: v.cpu().numpy() for k, v in got.items()}
    ref = {k: v.cpu().numpy()
           for k, v in asw_kernel.reference_from_stacks(ls, rs, cfg, **shard).items()}
    assert sorted(got) == sorted(ref), f"{name}: planes {sorted(got)} vs {sorted(ref)}"
    tol = dict(rtol=1e-5, atol=1e-4)
    if bar == "exact":
        _check_exact(name, got, ref, D, tol)
    else:
        for k in ("bestd", "rbestd"):
            agree = float((got[k] == ref[k]).mean())
            assert agree > bar, f"{name} {k}: agree {agree}"
        np.testing.assert_allclose(got["bestc"], ref["bestc"], rtol=1e-4, atol=1e-3,
                                   err_msg=f"{name} bestc")
        tol = dict(rtol=1e-4, atol=1e-3)
    if shard.get("want_strip"):
        assert got["r_strip_c"].shape == (shape[0], D - 1), f"{name}: strip shape"
        for k in ("rbestc", "r_strip_c"):
            np.testing.assert_allclose(got[k], ref[k], **tol, err_msg=f"{name} {k}")
        finite = np.isfinite(ref["r_strip_c"])
        same = got["r_strip_d"][finite] == ref["r_strip_d"][finite]
        assert (same.all() if bar == "exact" else same.mean() > bar), f"{name} r_strip_d"
        assert (got["r_strip_d"][~finite] == 0).all(), f"{name}: r_strip_d where no candidate"
    return {"case": name, "max_abs_err": float(np.abs(got["bestc"] - ref["bestc"]).max())}


def check_k1_shard_call(name, ls, rs, cfg, shard, got) -> dict:
    """One K1 call that a sharded layout made (its stacks, config, shard
    inputs and outputs) against the plain version on the same inputs.

    At full width some pixels' two best sums lie within float rounding of
    each other, so the kernel and the plain version may pick either: every
    pixel where a winner differs must be such a near-tie (the plain cost of
    the kernel's winner within the float tolerance of the plain best, the
    winner inside the window and, in the right view, a candidate that
    exists), in both views and the strip.  Costs everywhere (rbestc and
    r_strip_c too, inf where no candidate reaches a column), cm / cp /
    ubest where the winner agrees, r_strip_d 0 where no candidate reaches.
    Raises AssertionError; returns the mismatch counts and max errors."""
    import torch

    from aswstereomatch_torch.ops import aggregate
    from aswstereomatch_torch.ops.cuda import asw_kernel

    D = cfg.max_disparity
    tol = (dict(rtol=1e-5, atol=1e-4) if cfg.aggregation == "asw"
           else dict(rtol=1e-4, atol=1e-3))
    ref = {k: v.cpu().numpy() for k, v in
           asw_kernel.reference_from_stacks(ls, rs, cfg, **shard).items()}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    assert sorted(got) == sorted(ref), f"{name}: planes {sorted(got)} vs {sorted(ref)}"
    vol = (aggregate.aggregate_box(aggregate.cost_volume_from_stacks(ls, rs, cfg), cfg)
           if cfg.aggregation == "box" else aggregate.aggregate_asw_from_stacks(ls, rs, cfg))
    vol = vol.cpu().numpy()
    H, W, _ = vol.shape
    n_valid = shard.get("n_valid_cols", W)
    lo, hi = shard.get("d_window", (0, D))
    rows = np.arange(H)[:, None]

    gd, rd = got["bestd"], ref["bestd"]
    assert ((gd >= lo) & (gd < hi)).all(), f"{name}: bestd outside {lo, hi}"
    mis = gd != rd
    np.testing.assert_allclose(vol[rows, np.arange(W)[None, :], gd][mis], ref["bestc"][mis],
                               **tol, err_msg=f"{name}: bestd differs beyond a near-tie")
    np.testing.assert_allclose(got["bestc"], ref["bestc"], **tol, err_msg=f"{name} bestc")
    inner = ~mis & (rd > 0) & (rd < D - 1)
    for k, m in (("cm", inner), ("cp", inner), ("ubest", ~mis)):
        np.testing.assert_allclose(got[k][m], ref[k][m], **tol, err_msg=f"{name} {k}")

    # the right view over x' in [-(D-1), W): the strip, then the own columns
    cat = lambda o, a, b: np.concatenate([o[a], o[b]], axis=1)  # noqa: E731
    g_rc, r_rc = cat(got, "r_strip_c", "rbestc"), cat(ref, "r_strip_c", "rbestc")
    g_rd, r_rd = cat(got, "r_strip_d", "rbestd"), cat(ref, "r_strip_d", "rbestd")
    np.testing.assert_allclose(g_rc, r_rc, **tol, err_msg=f"{name} rbestc / r_strip_c")
    finite = np.isfinite(r_rc)
    assert (g_rd[~finite] == 0).all(), f"{name}: r_strip_d where no candidate"
    rmis = (g_rd != r_rd) & finite
    x = np.arange(-(D - 1), W)[None, :] + g_rd  # the left column of got's candidate
    ok = (x >= 0) & (x < n_valid) & (g_rd >= lo) & (g_rd < hi)
    assert ok[rmis].all(), f"{name}: a right-view winner that is no candidate"
    np.testing.assert_allclose(vol[rows, x.clip(0, W - 1), g_rd][rmis], r_rc[rmis], **tol,
                               err_msg=f"{name}: rbestd differs beyond a near-tie")
    return {"bestd_ties": int(mis.sum()), "rbestd_ties": int(rmis.sum()),
            "max_abs_err": float(np.abs(got["bestc"] - ref["bestc"]).max())}


def _check_exact(name, got, ref, D, tol) -> None:
    """Exact bestd / rbestd; bestc and ubest at ``tol``, cm / cp at ``tol``
    where both neighbours of bestd exist.  Raises AssertionError."""
    np.testing.assert_array_equal(got["bestd"], ref["bestd"], err_msg=f"{name} bestd")
    np.testing.assert_array_equal(got["rbestd"], ref["rbestd"], err_msg=f"{name} rbestd")
    np.testing.assert_allclose(got["bestc"], ref["bestc"], **tol, err_msg=f"{name} bestc")
    bd = ref["bestd"]
    mask = (bd > 0) & (bd < D - 1)
    for k in ("cm", "cp"):
        np.testing.assert_allclose(got[k][mask], ref[k][mask], **tol, err_msg=f"{name} {k}")
    np.testing.assert_allclose(got["ubest"], ref["ubest"], **tol, err_msg=f"{name} ubest")


def _check_bits(name, got, ref, D) -> None:
    """K3's box against its plain version bit for bit: both sum each window
    column over dy, then K columns over dx, and scale by (float)(1 / K^2).
    cm / cp where both neighbours of bestd exist (elsewhere undefined).
    Raises AssertionError."""
    bd = ref["bestd"]
    inner = (bd > 0) & (bd < D - 1)
    for k in ("bestd", "rbestd", "bestc", "ubest", "cm", "cp"):
        a, b = (got[k], ref[k]) if k not in ("cm", "cp") else (got[k][inner], ref[k][inner])
        assert np.array_equal(a, b), f"{name} {k}: not bit for bit"


def check_k4_bits(name, cfg, pair, device) -> None:
    """K4 against K1 over the same channel stacks, all six planes bit for
    bit: K4 computes K1's symmetric function with K1's arithmetic, term for
    term, and each output sums its taps in the same (dy, dx) order.
    Raises AssertionError."""
    import torch

    from aswstereomatch_torch.ops.cuda import asw_kernel, asw_sym_dlanes_kernel, common

    ls, rs = common.stacks(torch.from_numpy(pair["left"]).to(device),
                           torch.from_numpy(pair["right"]).to(device), cfg)
    k4 = asw_sym_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg)
    k1 = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg.replace(kernel_layout="xlanes"))
    differ = [k for k in k4 if not torch.equal(k4[k], k1[k])]
    assert not differ, f"{name}: K4 differs from K1 in {differ}"


def check_sep_bf16(name, sym, device) -> dict:
    """K2's bfloat16 storage mode.  Against its own plain version at the
    f32 cases' bars (exact bestd / rbestd, bestc rtol 1e-4 / atol 1e-3):
    both round each raw cost to bf16, nearest-even.  Against the f32 kernel
    at the drift bar of test_pallas_dlanes.py:360-365 (> 99.5% argmin
    agreement, |delta| > 2 on < 0.2%, bestc within rtol / atol 1e-2), and
    its bestc must differ from the f32 kernel's: the flag is honoured.
    Raises AssertionError."""
    import torch

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_sep_kernel
    from aswstereomatch_torch.utils import synthetic

    cfg32 = StereoConfig(**{**_BASE, **_SEP, "asw_symmetric": sym,
                            "max_disparity": 32, "window_radius": 8})
    cfg16 = cfg32.replace(volume_dtype="bfloat16")
    p = synthetic.make_pair(height=40, width=120, max_disparity=32, seed=7)
    l = torch.from_numpy(p["left"]).to(device)
    r = torch.from_numpy(p["right"]).to(device)

    def run(fn, cfg):
        return {k: v.cpu().numpy() for k, v in fn(l, r, cfg).items()}

    k16 = run(asw_sep_kernel.wta_outputs, cfg16)
    p16 = run(asw_sep_kernel.wta_outputs_reference, cfg16)
    k32 = run(asw_sep_kernel.wta_outputs, cfg32)
    _check_exact(f"{name} vs bf16 plain", k16, p16, 32, dict(rtol=1e-4, atol=1e-3))
    for k in ("bestd", "rbestd"):
        agree = float(np.mean(k16[k] == k32[k]))
        gross = float(np.mean(np.abs(k16[k] - k32[k]) > 2))
        assert agree > 0.995 and gross < 0.002, (
            f"{name} {k} vs f32 kernel: agree {agree}, |dd|>2 {gross}")
    np.testing.assert_allclose(k16["bestc"], k32["bestc"], rtol=1e-2, atol=1e-2,
                               err_msg=f"{name} bestc vs f32 kernel")
    assert not np.array_equal(k16["bestc"], k32["bestc"]), (
        f"{name}: bf16 bestc equals the f32 kernel's (storage flag ignored)")
    return {"case": name, "max_abs_err": float(np.abs(k16["bestc"] - p16["bestc"]).max())}


def check_floats_where_argmin_agrees(got, ref, D, rtol=1e-4, atol=1e-3) -> dict:
    """bestc everywhere; ubest where bestd agrees; cm / cp where bestd agrees
    and both neighbours exist.  Numpy arrays; raises AssertionError, else
    returns each plane's max |got - ref| over its mask."""
    same = got["bestd"] == ref["bestd"]
    inner = same & (ref["bestd"] > 0) & (ref["bestd"] < D - 1)
    errs = {}
    for k, mask in (("bestc", np.ones_like(same)), ("cm", inner), ("cp", inner),
                    ("ubest", same)):
        np.testing.assert_allclose(got[k][mask], ref[k][mask], rtol=rtol, atol=atol,
                                   err_msg=k)
        a, b = got[k][mask], ref[k][mask]
        # equal entries (inf included, where D <= 3 leaves no ubest) count 0
        with np.errstate(invalid="ignore"):  # inf - inf, masked by a == b
            errs[k] = float(np.where(a == b, 0.0, np.abs(a - b)).max(initial=0.0))
    return errs


def _argmin_agreement(a, b):
    """(share within 0.51, share off by > 2): test_pallas_kernel.py:86-87."""
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    return float(np.mean(diff <= 0.51)), float(np.mean(diff > 2.0))


def _median_ms(fn, reps: int) -> float:
    """Median of per-call CUDA-event times (after one warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_ms(fn, name: str, reps: int) -> float:
    """Median device time (ms) of the launches of the kernel ``name`` over
    ``reps`` calls of ``fn`` (after one warm-up call), from the profiler's
    CUDA activity: a kernel shorter than its host call, which CUDA events
    around the call would time with the host's enqueue."""
    import torch

    from aswstereomatch_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [(b - a) / 1e3 for a, b, n in profiling._device_intervals(prof) if name in n]
    if len(times) != reps:
        fail(f"device time of {name}: the profiler saw {len(times)} launches of {reps}")
    return float(np.median(times))


# ---- 7. the entry points: serve, CLI, sweep (each path read on its own) ----
ENTRY_H, ENTRY_W, ENTRY_D = 375, 1242, 128


def _client_round(sock, pair, config, **kw):
    """One request through the daemon: (answer, client round trip in ms)."""
    from aswstereomatch_torch.tools import serve

    t0 = time.perf_counter()
    got = serve.send_request(sock, pair["left"].astype(np.uint8),
                             pair["right"].astype(np.uint8), config, dtype="uint8", **kw)
    return got, (time.perf_counter() - t0) * 1e3


def serve_phase(card: str, dev, reset, launched) -> None:
    """``python -m aswstereomatch_torch.tools.serve --device cuda`` in a child
    process, on a free port: kitti_sep three times (K2; the third answer
    uint16_x256), kitti_tiled with the confidence planes (K1), a wrong config
    (an error; the connection stays), kitti_sgm (SGM) on the same
    connection, and a malformed header on another (an error; dropped).  Each
    answer must equal, bit for bit, the same request run here through
    ``StereoMatcher`` / ``match_pair_with_confidence`` (whose launches are
    counted), and the daemon must have mapped the kernels' library.  The
    daemon is stopped (and its device lock released) before this returns."""
    import socket
    import struct
    import tempfile

    import torch

    import aswstereomatch_torch
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.tools import serve
    from aswstereomatch_torch.utils import synthetic

    pk = synthetic.make_pair(height=ENTRY_H, width=ENTRY_W, max_disparity=ENTRY_D, seed=51)
    u8 = {s: torch.from_numpy(pk[s].astype(np.uint8)).to(dev) for s in ("left", "right")}
    get = aswstereomatch_torch.get_preset
    sep, tiled, sgm = get("kitti_sep"), get("kitti_tiled"), get("kitti_sgm")

    # what each answer must be: the same requests run in this process
    reset()
    want_sep = aswstereomatch_torch.StereoMatcher(sep)(u8["left"], u8["right"]).cpu().numpy()
    conf = [t.cpu().numpy() for t in pipeline.match_pair_with_confidence(
        u8["left"].float(), u8["right"].float(), tiled)]
    want_sgm = aswstereomatch_torch.StereoMatcher(sgm)(u8["left"], u8["right"]).cpu().numpy()
    n_here = launched("serve's requests run here", {"K1": 1, "K2": 1, "SGM": 1})
    want_u16 = np.clip(np.round(want_sep * 256.0), 0, 65535).astype(np.uint16)

    logdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    log = open(Path(logdir) / "serve.log", "w")
    env = dict(os.environ, PYTHONPATH=str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "aswstereomatch_torch.tools.serve", "--device", "cuda",
         "--port", "0"], cwd=HERE, stdout=log, stderr=subprocess.STDOUT, env=env)
    rows = []
    try:
        port = serve.wait_for_port(log.name, proc, timeout_s=120)
        with socket.create_connection(("127.0.0.1", port), timeout=300) as sock:
            for i in range(3):
                kw = {"response_dtype": "uint16_x256"} if i == 2 else {}
                (d, h), ms = _client_round(sock, pk, {"preset": "kitti_sep"}, **kw)
                want = want_u16.astype(np.float32) / 256.0 if i == 2 else want_sep
                if h["dtype"] != kw.get("response_dtype", "float32") or not np.array_equal(d, want):
                    fail(f"serve: kitti_sep request {i + 1} ({h['dtype']}) differs from "
                         f"StereoMatcher's map on {int((d != want).sum())} pixels")
                rows.append((f"kitti_sep {h['dtype']}", h["elapsed_ms"], ms))
            (d, h, uniq, lrv), ms = _client_round(sock, pk, {"preset": "kitti_tiled"},
                                                  confidence=True)
            for name, got, want in (("disp", d, conf[0]), ("uniq_pct", uniq, conf[1]),
                                    ("lr_valid", lrv, conf[2])):
                if not np.array_equal(got, want):
                    fail(f"serve: kitti_tiled confidence {name} differs from "
                         f"match_pair_with_confidence's on {int((got != want).sum())} pixels")
            rows.append(("kitti_tiled confidence", h["elapsed_ms"], ms))
            try:
                _client_round(sock, pk, {"preset": "kitti_sep", "aggregation": "bogus"})
                fail("serve: a wrong config got an answer")
            except RuntimeError as e:
                refused = str(e)
            (d, h), ms = _client_round(sock, pk, {"preset": "kitti_sgm"})
            if not np.array_equal(d, want_sgm):
                fail(f"serve: kitti_sgm after the refused config differs from "
                     f"StereoMatcher's map on {int((d != want_sgm).sum())} pixels")
            rows.append(("kitti_sgm (same connection, after the error)", h["elapsed_ms"], ms))
        with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
            sock.sendall(struct.pack("<I", 8) + b"notjson!")
            rlen = struct.unpack("<I", serve._recv_exact(sock, 4))[0]
            answer = json.loads(serve._recv_exact(sock, rlen))
            dropped = sock.recv(1) == b""
        if answer.get("status") != "error" or not dropped:
            fail(f"serve: malformed header answered {answer}, connection dropped {dropped}")
        maps = Path(f"/proc/{proc.pid}/maps").read_text()
        if "libasw_torch.so" not in maps:
            fail("serve: the daemon never loaded the kernels' library")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    print(f"serve entry point on {card}: daemon answers equal the in-process matcher bit for "
          f"bit (kitti_sep f32 x2 and uint16_x256 == this script's encoding, K2; kitti_tiled "
          f"disp / uniq_pct / lr_valid == match_pair_with_confidence, K1; kitti_sgm, SGM; "
          f"{n_here} launches here for the comparison); the daemon loaded libasw_torch.so; "
          f"wrong config answered '{refused}' and kept the connection; malformed header "
          f"answered '{answer['message']}' and dropped it; daemon stopped (exit "
          f"{proc.returncode})", flush=True)
    for label, server_ms, client_ms in rows:
        print(f"serve {ENTRY_W}x{ENTRY_H} D={ENTRY_D} uint8 wire, {label}: server elapsed_ms "
              f"{server_ms}, client round trip {client_ms:.2f} ms on {card}", flush=True)


def serve_layers(card: str, dev) -> None:
    """Where a kitti_sep request's server time goes, in this process on the
    same uint8 pair: host-to-device copy of both images, the host time to
    enqueue the pipeline (no sync: near the pipeline's device time only if
    something in it waits for the card), the pipeline on the card, the u16
    encode, and the device-to-host copy of the f32 and the u16 map."""
    import torch

    import aswstereomatch_torch
    from aswstereomatch_torch.tools import serve
    from aswstereomatch_torch.utils import synthetic

    pk = synthetic.make_pair(height=ENTRY_H, width=ENTRY_W, max_disparity=ENTRY_D, seed=51)
    lu, ru = (torch.from_numpy(pk[s].astype(np.uint8)) for s in ("left", "right"))
    m = aswstereomatch_torch.StereoMatcher.from_preset("kitti_sep")
    l, r = lu.to(dev), ru.to(dev)
    d = m(l, r)
    du = serve.encode_u16(d)
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m(l, r)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t = {
        "h2d_ms": _median_ms(lambda: (lu.to(dev), ru.to(dev)), 5),
        "enqueue_ms": float(np.median(enqueue)),
        "pipeline_ms": _median_ms(lambda: m(l, r), 5),
        "encode_u16_ms": _median_ms(lambda: serve.encode_u16(d), 5),
        "d2h_f32_ms": _median_ms(lambda: d.cpu(), 5),
        "d2h_u16_ms": _median_ms(lambda: du.cpu(), 5),
    }
    print(f"serve layers kitti_sep {ENTRY_W}x{ENTRY_H} D={ENTRY_D} uint8 on {card} (CUDA-event "
          f"medians; enqueue on the host clock): " + json.dumps(t), flush=True)


def cli_phase(card: str, reset, launched) -> None:
    """``aswstereomatch_torch.cli.main`` in this process on a synthetic
    KITTI pair: kitti_tiled (K1: the first call, one warm-up, three timed)
    and its left-only weights (K3), each read alone; bad-2.0 under 5%, the
    disparity PNG read back through the port's io when the codec built."""
    import contextlib
    import io as stdio
    import tempfile
    import warnings

    from aswstereomatch_torch import cli
    from aswstereomatch_torch.utils import io, native

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    for label, extra, key in (("kitti_tiled", [], "K1"),
                              ("kitti_tiled --left-only-weights", ["--left-only-weights"], "K3")):
        args = ["--synthetic", "kitti", "--preset", "kitti_tiled", "--iters", "3",
                "--json", str(out / "run.json"), "--out", str(out / "disp.png"), *extra]
        reset()
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stdout(stdio.StringIO()):
            warnings.simplefilter("always")
            rc = cli.main(args)
        n = launched(f"cli {label}", {key: 5})
        rec = json.loads((out / "run.json").read_text())
        if rc != 0 or not rec["metrics"]["bad_2"] < 0.05 or rec["shape"] != [ENTRY_H, ENTRY_W]:
            fail(f"cli {label}: exit {rc}, record {rec.get('metrics')} {rec.get('shape')}")
        png = "not read back (native codec unavailable: PGM written)"
        if native.available():
            img = io.read_image(str(out / "disp.png"))
            if img.shape != (ENTRY_H, ENTRY_W):
                fail(f"cli {label}: disparity PNG reads back as {img.shape}")
            png = f"PNG reads back {img.shape}"
        mesh = "; ".join(str(w.message) for w in caught if "mesh" in str(w.message))
        print(f"cli entry point on {card}: {label} exit 0, bad_2 {rec['metrics']['bad_2']}, "
              f"compile_s {rec['compile_s']}, best_s {rec['best_s']}, pairs_per_s "
              f"{rec['pairs_per_s']}, device {rec['device']}; {key} launches {n}, other "
              f"kernels 0; {png}; {mesh or 'no mesh warning'}", flush=True)


def sweep_phase(card: str, reset, launched) -> None:
    """``make_synthetic_dataset`` (4 KITTI pairs) and
    ``aswstereomatch_torch.tools.sweep.main`` with kitti_sep, u16 fetch (K2
    4 times); two manifest records and their maps removed and the sweep run
    again (K2 exactly twice; both maps written again; 4 pairs in the
    summary); one pair with the f32 fetch within 1/512 px of the u16 map."""
    import contextlib
    import io as stdio
    import shutil
    import tempfile

    from aswstereomatch_torch.tools import sweep
    from aswstereomatch_torch.utils import io, native

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    d = root / "u16"
    sweep.make_synthetic_dataset(str(d), 4, ENTRY_H, ENTRY_W, ENTRY_D)

    def run(dir_, *extra):
        buf = stdio.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = sweep.main(["--dir", str(dir_), "--preset", "kitti_sep", *extra])
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"sweep: exit {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1]), wall

    reset()
    summary, wall = run(d, "--fetch", "u16")
    launched("sweep, 4 pairs", {"K2": 4})
    if summary["pairs"] != 4:
        fail(f"sweep: summary {summary}")
    mpath = d / "sweep_manifest.json"
    man = json.loads(mpath.read_text())
    lost = sorted(man["done"])[2:]
    for pid in lost:
        del man["done"][pid]
        (d / f"{pid}_disp.pfm").unlink()
    mpath.write_text(json.dumps(man))
    reset()
    summary2, wall2 = run(d, "--fetch", "u16")
    launched("sweep resume", {"K2": 2})
    if summary2["pairs"] != 4 or not all((d / f"{p}_disp.pfm").exists() for p in lost):
        fail(f"sweep: resume summary {summary2}, maps rewritten "
             f"{[(d / f'{p}_disp.pfm').exists() for p in lost]}")
    d32 = root / "f32"
    d32.mkdir()
    for suffix in ("_left.ppm", "_right.ppm", "_gt.pfm"):
        shutil.copy(d / f"pair0000{suffix}", d32 / f"pair0000{suffix}")
    reset()
    run(d32, "--fetch", "f32")
    launched("sweep f32 fetch", {"K2": 1})
    a = io.read_pfm(str(d / "pair0000_disp.pfm"))
    b = io.read_pfm(str(d32 / "pair0000_disp.pfm"))
    worst = float(np.max(np.abs(a - b)[b >= 0]))
    if not worst <= 1 / 512 + 1e-6:
        fail(f"sweep: u16 and f32 maps differ by {worst} px")
    shutil.rmtree(root, ignore_errors=True)
    print(f"sweep entry point on {card}: kitti_sep {ENTRY_W}x{ENTRY_H} D={ENTRY_D}, 4 pairs in "
          f"{wall:.3f} s ({4 / wall:.3f} pairs/s, sweep.main's wall time), "
          f"mean_bad_2 {summary['mean_bad_2']}; resume after 2 lost records: K2 launches 2, "
          f"both maps rewritten, {summary2['pairs']} pairs in {wall2:.3f} s; u16 vs f32 fetch "
          f"max |diff| {worst:.6f} px (<= 1/512); native PNM reader "
          f"{'used' if native.available() else 'unavailable (pure-Python reader)'}",
          flush=True)


def entry_points(card: str, dev, reset, launched) -> None:
    """Phase 7: the native codec, then serve, CLI and sweep (the daemon is
    stopped before the sweep takes the device lock)."""
    from aswstereomatch_torch.utils import native

    if native.available():
        print("native codec: built from native/stereoio.cpp", flush=True)
    else:
        print(f"native codec: not built: {native.build_error()}", flush=True)
    serve_phase(card, dev, reset, launched)
    serve_layers(card, dev)
    cli_phase(card, reset, launched)
    sweep_phase(card, reset, launched)


# ---- 8. the sharded layouts on a virtual mesh of one card ------------------

def sharded_phase(card: str, dev, reset, launched) -> dict:
    """Phase 8: parallel/'s layouts at 1242x375 D=128 on [dev] x 4 (and a
    2x2 mesh for kitti_batch), each against the unsharded run bit for bit,
    launches read around each; returns the median times by layout."""
    import torch

    from aswstereomatch_torch import get_preset
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import asw_kernel
    from aswstereomatch_torch.parallel import api, distributed, dshard, mesh, tiling
    from aswstereomatch_torch.utils import synthetic

    p = synthetic.make_dataset_pair("kitti")
    l = torch.from_numpy(p["left"]).to(dev)
    r = torch.from_numpy(p["right"]).to(dev)
    m4 = mesh.build_mesh(1, 4, [dev] * 4)
    fns = {"y": tiling.match_pair_tiled, "x": tiling.match_pair_tiled_x,
           "d": dshard.match_pair_dsharded}
    kitti = get_preset("kitti_tiled")
    lo, box = kitti.replace(asw_symmetric=False), kitti.replace(aggregation="box")
    sep = get_preset("kitti_sep")
    xl = lambda c: c.replace(kernel_layout="xlanes")  # noqa: E731  (K1)
    # (label, config, axis, the unsharded run's config, its kernel, the layout's kernel)
    cases = [("kitti_tiled", kitti, "y", kitti, "K1", "K1"),
             ("kitti_tiled", kitti, "x", kitti, "K1", "K1"),
             ("kitti_tiled", kitti, "d", kitti, "K1", "K1"),
             ("kitti_sep", sep, "y", sep, "K2", "K2"),
             ("left-only", lo, "y", lo, "K3", "K3"),
             ("left-only", lo, "x", xl(lo), "K1", "K1"),
             ("left-only", lo, "d", xl(lo), "K1", "K1"),
             ("box", box, "x", xl(box), "K1", "K1"),
             ("box", box, "d", xl(box), "K1", "K1")]
    virtual = "virtual mesh, one card runs the shards in turn: not a multi-card time"
    times, unsharded = {}, {}
    for label, cfg, axis, ucfg, ukey, key in cases:
        if ucfg not in unsharded:
            reset()
            unsharded[ucfg] = pipeline.match_pair(l, r, ucfg)
            launched(f"sharded: unsharded {label}", {ukey: 1}, stack_builds=False)
        want = unsharded[ucfg]
        calls = []
        kernel_call = asw_kernel.wta_outputs_from_stacks
        if axis in "xd":
            # record K1's calls with the shard inputs the layout gives it
            def recording(ls, rs, c, plan=None, **kw):
                outs = kernel_call(ls, rs, c, plan, **kw)
                calls.append((ls, rs, c, kw, outs))
                return outs
            asw_kernel.wta_outputs_from_stacks = recording
        try:
            reset()
            got = fns[axis](l, r, cfg, m4)
            n = launched(f"sharded: {label} {axis}", {key: 4}, stack_builds=False)
        finally:
            asw_kernel.wta_outputs_from_stacks = kernel_call
        if not torch.equal(got, want):
            fail(f"sharded: {label} {axis}-sharded differs from the unsharded {ukey} run on "
                 f"{int((got != want).sum())} of {want.numel()} pixels")
        for k, (ls, rs, c, kw, outs) in enumerate(calls):
            name = f"sharded: {label} {axis}-shard {k}'s K1 call"
            try:
                res = check_k1_shard_call(name, ls, rs, c, kw, outs)
            except AssertionError as e:
                fail(f"{name}: {e}")
            print(f"sharded {label} {axis}-shard {k}: K1 at ({ls.shape[1]}, "
                  f"{ls.shape[2] - 2 * c.window_radius}) D={c.max_disparity} with {kw} equals "
                  f"its plain version (near-ties: bestd {res['bestd_ties']}, right view "
                  f"{res['rbestd_ties']}; max |bestc err| {res['max_abs_err']:.3g})", flush=True)
        t = times[f"{label} {axis}"] = {
            "ms": _median_ms(lambda: fns[axis](l, r, cfg, m4), 3),
            "unsharded_ms": _median_ms(lambda: pipeline.match_pair(l, r, ucfg), 3),
            "launches": n}
        print(f"sharded {label} {axis} 1242x375 D=128, 4 shards ({virtual}) on {card}: "
              f"equals the unsharded {ukey} run bit for bit; {t['ms']:.3f} ms against "
              f"{t['unsharded_ms']:.3f} ms unsharded; {key} launches {n}", flush=True)
    # kitti_batch: two pairs over data 2 x tile 2, each y-tiled over 2 shards
    batch_cfg = get_preset("kitti_batch")
    p2 = synthetic.make_dataset_pair("kitti", seed=1)
    lefts = torch.stack([l, torch.from_numpy(p2["left"]).to(dev)])
    rights = torch.stack([r, torch.from_numpy(p2["right"]).to(dev)])
    m22 = mesh.build_mesh(2, 2, [dev] * 4)
    singles = [pipeline.match_pair(lefts[i], rights[i], batch_cfg) for i in range(2)]
    reset()
    out = tiling.match_batch_sharded(lefts, rights, batch_cfg, m22)
    n = launched("sharded: kitti_batch 2x2", {"K1": 4}, stack_builds=False)
    for i in range(2):
        if not torch.equal(out[i], singles[i]):
            fail(f"sharded: kitti_batch pair {i} on the 2x2 mesh differs from its single "
                 f"map on {int((out[i] != singles[i]).sum())} pixels")
    t = times["kitti_batch 2x2"] = {
        "ms": _median_ms(lambda: tiling.match_batch_sharded(lefts, rights, batch_cfg, m22), 3),
        "unsharded_ms": _median_ms(lambda: pipeline.match_batch(lefts, rights, batch_cfg), 3),
        "launches": n}
    print(f"sharded kitti_batch 2 pairs 1242x375 D=128, data 2 x tile 2 ({virtual}) on {card}: "
          f"each pair equals its single unsharded K1 map bit for bit; {t['ms']:.3f} ms against "
          f"{t['unsharded_ms']:.3f} ms for the unsharded batch; K1 launches {n}", flush=True)

    # A caller's CPU tensors over the card mesh: the shards run on the card
    # (K1, no plain version) and the map comes back to the CPU, through the
    # config-driven entry point and through the multi-process runner's
    # batch slice in this one process.
    lc, rc = p["left"], p["right"]
    want = unsharded[kitti].cpu()
    for axis in "yxd":
        fn = api.sharded_match_fn(kitti.replace(mesh_data=1, mesh_tile=4, tile_axis=axis),
                                  [dev] * 4)
        reset()
        got = fn(torch.from_numpy(lc), torch.from_numpy(rc))
        launched(f"sharded: kitti_tiled {axis} from CPU inputs", {"K1": 4}, stack_builds=False)
        if got.device.type != "cpu" or not torch.equal(got, want):
            fail(f"sharded: kitti_tiled {axis} from CPU inputs on {got.device} differs from "
                 f"the unsharded run on {int((got.cpu() != want).sum())} pixels")
    gm = distributed.global_mesh(tile=2, devices=[dev] * 4)
    reset()
    shards = distributed.run_batch_distributed(np.stack([lc, p2["left"]]),
                                               np.stack([rc, p2["right"]]), batch_cfg, gm)
    launched("sharded: run_batch_distributed from CPU inputs", {"K1": 4}, stack_builds=False)
    out = torch.full((2, *want.shape), float("nan"))
    for s in shards:
        out[s.index] = s.data.cpu()
    for i in range(2):
        if not torch.equal(out[i], singles[i].cpu()):
            fail(f"sharded: run_batch_distributed pair {i} differs from its single map on "
                 f"{int((out[i] != singles[i].cpu()).sum())} pixels")
    print(f"sharded from CPU inputs over [{dev}] x 4 on {card}: kitti_tiled y, x and d "
          f"through api.sharded_match_fn (K1 4 each) and kitti_batch's 2 pairs through "
          f"distributed.run_batch_distributed on a {gm.shape} mesh (K1 4) come back to the "
          f"CPU equal to the unsharded maps bit for bit", flush=True)
    return times


# ---- 9. one pair's tile axis across processes ------------------------------

TILE_WORKERS = 4
TILE_WORKER_TIMEOUT_S = 240
# (label, preset, config change, layout, the unsharded run's kernel): phase
# 8's kitti_tiled y, x and d, kitti_sep y, left-only y and kitti_batch, each
# with its 4 launches of that kernel summed over the processes
TILE_CASES = [("kitti_tiled y", "kitti_tiled", {}, "y", "K1"),
              ("kitti_tiled x", "kitti_tiled", {}, "x", "K1"),
              ("kitti_tiled d", "kitti_tiled", {}, "d", "K1"),
              ("kitti_sep y", "kitti_sep", {}, "y", "K2"),
              ("left-only y", "kitti_tiled", {"asw_symmetric": False}, "y", "K3"),
              ("kitti_batch 2x2", "kitti_batch", {}, "batch", "K1")]


def tile_worker(rank: int, nproc: int, port: int, backend: str, out: str) -> int:
    """Phase 9's worker ``rank`` of ``nproc``: brings up the process group
    over ``backend`` (gloo: every process on cuda:0; NCCL: one card each),
    runs each TILE_CASES layout on the global mesh (tile 4; data 2 x tile 2
    for the batch) with the launch counters and the transport's byte counts
    read around it, holds its shards against the unsharded map bit for bit,
    times three more runs between barriers and writes what it read to
    ``out/<rank>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from aswstereomatch_torch import get_preset
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel,
                                               asw_sym_dlanes_kernel, build, sgm_kernel)
    from aswstereomatch_torch.parallel import collectives, distributed, dshard, tiling
    from aswstereomatch_torch.utils import synthetic

    kernels = {"K1": asw_kernel, "K2": asw_sep_kernel, "K3": asw_dlanes_kernel,
               "K4": asw_sym_dlanes_kernel, "SGM": sgm_kernel}
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    build.load()  # the parent's build, found by its key
    distributed.initialize(f"127.0.0.1:{port}", nproc, rank, backend=backend)
    per = TILE_WORKERS // nproc
    m4 = distributed.global_mesh(tile=4, devices=[dev] * per)
    m22 = distributed.global_mesh(tile=2, devices=[dev] * per)
    p = [synthetic.make_dataset_pair("kitti", seed=s) for s in (0, 1)]
    lefts = np.stack([q["left"] for q in p])
    rights = np.stack([q["right"] for q in p])
    l, r = torch.from_numpy(lefts[0]).to(dev), torch.from_numpy(rights[0]).to(dev)
    fns = {"y": tiling.match_pair_tiled, "x": tiling.match_pair_tiled_x,
           "d": dshard.match_pair_dsharded}
    report = {}
    for label, preset, change, axis, _ in TILE_CASES:
        cfg = get_preset(preset).replace(**change)
        if axis == "batch":
            want = torch.stack([pipeline.match_pair(torch.from_numpy(a).to(dev),
                                                    torch.from_numpy(b).to(dev), cfg)
                                for a, b in zip(lefts, rights)])
            run = lambda: distributed.run_batch_distributed(lefts, rights, cfg, m22)  # noqa: E731
            owned = len(m22.local_shards())
        else:
            want = pipeline.match_pair(l, r, cfg)
            run = lambda: fns[axis](l, r, cfg, m4)  # noqa: E731
            owned = len(m4.local_shards())
        torch.cuda.synchronize()
        for m in kernels.values():
            m.launches = 0
        before = dict(collectives.sent_bytes)
        dist.barrier()
        shards = run()
        torch.cuda.synchronize()
        launches = {k: m.launches for k, m in kernels.items()}
        sent = {k: v - before.get(k, 0) for k, v in collectives.sent_bytes.items()
                if v - before.get(k, 0)}
        if len(shards) != owned:
            raise SystemExit(f"{label}: rank {rank} got {len(shards)} shards, owns {owned}")
        for s in shards:
            if not torch.equal(s.data, want[s.index]):
                raise SystemExit(f"{label}: rank {rank}'s shard {s.index} differs from the "
                                 f"unsharded map on {int((s.data != want[s.index]).sum())} "
                                 "pixels")
        times = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            dist.barrier()
            times.append(1e3 * (time.perf_counter() - t0))
        report[label] = {"launches": launches, "shards": owned, "bytes": sent,
                         "ms": float(np.median(times))}
    dist.destroy_process_group()
    Path(out, f"{rank}.json").write_text(json.dumps(report))
    return 0


def tile_processes_phase(card: str, sharded: dict) -> None:
    """Phase 9: TILE_CASES over 4 worker processes on cuda:0 over gloo
    (NCCL refuses two ranks on one card) and, where there are two cards or
    more, over NCCL with one card per process; fails on a worker's nonzero
    exit, its timeout or launches other than phase 8's."""
    import socket
    import tempfile

    import torch

    runs = [("gloo", TILE_WORKERS)]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs.append(("nccl", TILE_WORKERS if cards >= TILE_WORKERS else 2))
    else:
        print(f"tile across processes over NCCL: not run: {cards} card visible, and NCCL "
              "refuses two ranks on one card", flush=True)
    for backend, nproc in runs:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = tempfile.mkdtemp(prefix="chip_smoke_tile_")
        t0 = time.perf_counter()
        logs = [Path(out, f"{rank}.log") for rank in range(nproc)]
        procs = []
        try:
            for rank, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()), "--tile-worker",
                         str(rank), str(nproc), str(port), backend, out],
                        stdout=f, stderr=subprocess.STDOUT))
            # the first worker to fail ends the phase: the others would wait
            # for it in their exchanges
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.perf_counter() - t0 < TILE_WORKER_TIMEOUT_S):
                time.sleep(0.2)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        # a worker that failed first, else one that was killed
        for rank in sorted(range(nproc), key=lambda i: procs[i].returncode < 0):
            proc, log = procs[rank], logs[rank]
            if proc.returncode != 0:
                fail(f"tile {backend}: worker {rank} exited {proc.returncode} (killed at the "
                     f"first failure or the {TILE_WORKER_TIMEOUT_S} s timeout):\n"
                     f"{log.read_text()[-3000:]}")
        reports = [json.loads(Path(out, f"{rank}.json").read_text()) for rank in range(nproc)]
        wall_s = time.perf_counter() - t0
        for label, _, _, axis, key in TILE_CASES:
            rows = [rep[label] for rep in reports]
            launches = {k: sum(row["launches"][k] for row in rows) for k in rows[0]["launches"]}
            if launches != {k: 4 if k == key else 0 for k in launches}:
                fail(f"tile {backend}: {label} launched {launches} over {nproc} processes, "
                     f"expected {key} 4 (phase 8's)")
            for rank, row in enumerate(rows):
                if row["launches"][key] != row["shards"]:
                    fail(f"tile {backend}: {label} rank {rank} launched {key} "
                         f"{row['launches'][key]} times for its {row['shards']} shards")
            sent = {}
            for row in rows:
                for kind, n in row["bytes"].items():
                    sent[kind] = sent.get(kind, 0) + n
            one = sharded.get("kitti_batch 2x2" if axis == "batch" else label, {}).get("ms")
            print(f"tile {backend} {label} 1242x375 D=128 over {nproc} processes on {card} "
                  f"({'one card, the processes take turns on it and gloo stages every byte '
                     'through the host: not a multi-card time' if backend == 'gloo' else
                     'one card per process'}): every shard equals the unsharded map bit for "
                  f"bit; {key} launches {launches[key]} (one per shard); {rows[0]['ms']:.3f} ms "
                  f"per pair" + (f" against {one:.3f} ms in one process (phase 8)" if one else "")
                  + "; bytes sent between processes: "
                  + (", ".join(f"{kind} {n}" for kind, n in sorted(sent.items())) or "none"),
                  flush=True)
        print(f"tile {backend}: {nproc} workers, {wall_s:.1f} s from spawn to exit", flush=True)


def tools_phase(card: str, kernels: dict) -> None:
    """Phase 10: the port's accuracy and validation tools
    (aswstereomatch_torch/tools/) in this process on cuda:0 at their full
    geometries, each one's kernel launches read around it.  A tool fails on
    a missed bar, a kernel its configs route to that did not launch, or a
    launch of another; every tool runs, then the phase fails if any did."""
    import torch

    from aswstereomatch_torch.tools import (card_fuzz, common, compare_opencv,
                                            dataset_roundtrip, flagship_sharded_check,
                                            fuzz_pipeline, pin_sep_accuracy, refuse_curve,
                                            run_baseline_configs, sym_vs_leftonly)

    dev = torch.device("cuda", 0)
    try:
        compare_opencv.import_cv2()
        use_cv2 = True
    except ImportError:
        use_cv2 = False
    print("tools: cv2 " + ("imports: compare_opencv and refuse_curve run with the cv2 rows"
                           if use_cv2 else "does not import: compare_opencv and refuse_curve "
                           "run with --no-cv2 (no cv2 rows)"), flush=True)
    out = HERE / "results_torch"
    quiet = lambda *a, **k: None  # noqa: E731
    failed = []

    def checks_ok(rec) -> str:
        return "" if rec["ok"] else "accuracy bars missed"

    def sep_ok(rec, record) -> str:
        # The symmetric mode must meet SEP_CONTRACT; a mode whose reference
        # record misses it too (left-only) must give the reference's verdict.
        want = pin_sep_accuracy.verdict(common.reference_rows(record))["pass"]
        v = rec["verdict"]
        bad = [] if rec["ok"] else ["accuracy bars missed"]
        if not (v["pass"] or (rec["left_only"] and not want)):
            bad.append(f"verdict {v['line']}; the reference's record: "
                       f"{'PASS' if want else 'FAIL'}")
        return "; ".join(bad)

    def tool(name, fn, problem, describe):
        for m in kernels.values():
            m.launches = 0
        t0 = time.perf_counter()
        rec = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: m.launches for k, m in kernels.items()}
        routed = set(rec["kernels_routed"])
        why = problem(rec)
        idle = sorted(k for k in routed if not got[k])
        other = sorted(k for k, n in got.items() if n and k not in routed)
        if idle:
            why += f"; routed to {idle} but they never launched"
        if other:
            why += f"; launched {other}, which its configs do not route to"
        common.write_record(str(out / f"{name}.json"), rec)
        print(f"tools {name} on {card}: {wall:.1f} s; launches "
              f"{ {k: n for k, n in got.items() if n} }; {describe(rec)}"
              + (f"; FAILED: {why.lstrip('; ')}" if why else "; ok"), flush=True)
        if why:
            failed.append(name)
        return rec

    t_phase = time.perf_counter()
    tool("card_fuzz", lambda: card_fuzz.run(dev, 24, 6, 5000, progress=quiet),
         lambda r: "" if not r["failures"] else "; ".join(
             x["line"] for x in r["rows"] if x["status"] == "FAIL"),
         lambda r: f"24 + 6 trials from seeds 5000 / 105000: {r['ok']} ok, "
                   f"{r['skipped_eager_routed']} skipped (eager-routed), {r['failures']} "
                   "failures" + ("" if r["failures"] else
                                 ", launches equal to kernel_for's prediction in every trial"))
    tool("fuzz_pipeline", lambda: fuzz_pipeline.run(dev, 12, 1000, progress=quiet),
         lambda r: "; ".join(x["line"] for x in r["rows"] if x["status"] == "FAIL"),
         lambda r: f"12 trials from seed 1000, {r['failures']} failures ("
                   + ", ".join(f"{x['seed']}:{'+'.join(x['checks'])}" for x in r["rows"]) + ")")
    tool("sharded_flagship", lambda: flagship_sharded_check.run_checks(dev, progress=quiet),
         lambda r: "" if r["all_exact"] else "not exact: " + ", ".join(
             f"{x['layout']} ({x['differing_pixels']} px)" for x in r["rows"] if not x["exact"]),
         lambda r: "1242x375 D=128 r=16: " + ", ".join(
             f"{x['layout']} [{x['route']}] {'exact' if x['exact'] else 'DIFFERS'} "
             f"{x['wall_s']:.2f} s" for x in r["rows"]))

    def accuracy(r):
        return common.summary(r["checks"])

    tool("baseline_configs", lambda: run_baseline_configs.run(dev, progress=quiet), checks_ok,
         lambda r: "; ".join(f"{x['preset']}/{x['geometry']} {x['pairs_per_s']} pairs/s "
                             f"({x['pairs_per_s_queued']} queued) bad_2 {x['bad_2']} epe "
                             f"{x['epe']}" for x in r["rows"])
         + f"; against bench_results/baseline_configs.json: {accuracy(r)}")
    for left_only, name, record in ((False, "sep_vs_exact_kitti", "sep_vs_exact_kitti.json"),
                                    (True, "seplo_vs_exact_kitti", "seplo_vs_exact_kitti.json")):
        tool(name, lambda: pin_sep_accuracy.run(dev, (0, 1, 2), left_only=left_only,
                                                progress=quiet),
             lambda r, record=record: sep_ok(r, record),
             lambda r: f"seeds 0 1 2: {r['verdict']['line']}; rows (regime/seed: delta, "
                       "on-exact-correct, GT cost): " + ", ".join(
                           f"{x['regime']}/{x['seed']}: {x['delta_bad2_vs_exact']} "
                           f"{x['delta_bad2_on_exact_correct']} {x['gt_bad2_cost']}"
                           for x in r["rows"]) + f"; against {record}: {accuracy(r)}")
    tool("symmetric_vs_leftonly", lambda: sym_vs_leftonly.run(dev, progress=quiet), checks_ok,
         lambda r: "; ".join(f"{x['geometry']} {'sym' if x['symmetric'] else 'lo'} "
                             f"{x['pairs_per_s']} pairs/s ({x['pairs_per_s_queued']} queued) "
                             f"bad_2 {x['bad_2']}" for x in r["rows"])
         + f"; against bench_results/symmetric_vs_leftonly.json: {accuracy(r)}")
    for regime, geoms in (("smooth", ["tsukuba", "venus", "teddy", "cones", "kitti"]),
                          ("hard", ["kitti", "venus"])):
        tool(f"opencv_compare_{regime}",
             lambda: compare_opencv.run(geoms, dev, regime, use_cv2, progress=quiet), checks_ok,
             lambda r: f"cv2 {r['cv2']}; {len(r['rows'])} rows; against "
                       f"bench_results/opencv_compare*.json: {accuracy(r)}")
    tool("refuse_curve", lambda: refuse_curve.run(["kitti", "venus"], [7, 8], dev, use_cv2,
                                                  progress=quiet), checks_ok,
         lambda r: f"cv2 {r['cv2']}; {len(r['rows'])} rows, {len(r['matched_coverage'])} "
                   f"matched-coverage pairs; against bench_results/refuse_curve.json: "
                   + accuracy(r))
    tool("dataset_roundtrip", lambda: dataset_roundtrip.run(dev, progress=quiet),
         lambda r: "" if r["ok"] else "; ".join(
             f"{x['scene']}: {x.get('cli_stderr') or x}" for x in r["rows"] if not x["ok"]),
         lambda r: "; ".join(
             f"{x['scene']} ({x['preset']}, {x['gt_format']}): GT decode err "
             f"{x['gt_decode_max_err']}, CLI exit {x['cli_returncode']}, bad_2 CLI "
             f"{x.get('metrics', {}).get('bad_2')} / in-process "
             f"{x.get('in_process_metrics', {}).get('bad_2')}" for x in r["rows"]))
    print(f"tools: {time.perf_counter() - t_phase:.1f} s for phase 10; records in {out}",
          flush=True)
    if failed:
        fail(f"tools: {', '.join(failed)} failed")


# ---- 11. the serving and timing tools ------------------------------------
SWEEP_SOAK_PAIRS = 200      # the sweep soak's pairs (copies of SWEEP_SOAK_SCENES scenes)
SWEEP_SOAK_SCENES = 4


def sweep_soak(out: Path) -> dict:
    """``soak_runner`` around ``python -m aswstereomatch_torch.tools.sweep
    --preset kitti_sep`` over SWEEP_SOAK_PAIRS synthetic 1242x375 pairs in a
    temporary directory (SWEEP_SOAK_SCENES scenes made once and linked under
    the other pair ids: a scene takes seconds of numpy to make), deleted
    afterwards.  Pairs/s over the child's life and between its first and
    last written map (the steady rate, past the start and the first build)."""
    import shutil
    import tempfile

    from aswstereomatch_torch.tools import common, soak_runner, sweep

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_soak_"))
    try:
        sweep.make_synthetic_dataset(str(root), SWEEP_SOAK_SCENES, ENTRY_H, ENTRY_W, ENTRY_D)
        for i in range(SWEEP_SOAK_SCENES, SWEEP_SOAK_PAIRS):
            for suffix in ("_left.ppm", "_right.ppm", "_gt.pfm"):
                os.link(root / f"pair{i % SWEEP_SOAK_SCENES:04d}{suffix}",
                        root / f"pair{i:04d}{suffix}")
        log = out / "sweep_soak_child.log"
        rec = soak_runner.run(
            [sys.executable, "-m", "aswstereomatch_torch.tools.sweep", "--dir", str(root),
             "--preset", "kitti_sep"], str(out / "sweep_soak.json"), interval=1.0,
            log=str(log), env=common.child_env(), timeout_s=300)
        maps = sorted(p.stat().st_mtime for p in root.glob("*_disp.pfm"))
        lines = [ln for ln in log.read_text().splitlines() if ln.startswith("{")]
        summary = json.loads(lines[-1]) if lines else {}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec.update(pairs=summary.get("pairs"), mean_bad_2=summary.get("mean_bad_2"),
               pairs_per_s=(summary.get("pairs") or 0) / rec["wall_s"],
               steady_pairs_per_s=(len(maps) - 1) / (maps[-1] - maps[0])
               if len(maps) > 1 and maps[-1] > maps[0] else None)
    if rec["returncode"] != 0 or rec["pairs"] != SWEEP_SOAK_PAIRS:
        print("sweep soak: the sweep's log ends:\n" + common.log_tail(log), flush=True)
    return rec


def timing_phase(card: str, dev, kernels: dict) -> None:
    """Phase 11: the port's serving and timing tools on cuda:0 at full size,
    one line each with its time and the kernels' launches in this process
    read around it (the daemons and the CLI and sweep children launch in
    their own processes; here run the comparisons' and the timed runs'
    launches).  Every tool runs; then the phase fails if any missed a check."""
    import torch

    from aswstereomatch_torch.ops.cuda import build
    from aswstereomatch_torch.tools import (bench_separable, common, headline_variance,
                                            profile_stages, serve_bench, serve_soak,
                                            warm_on_compute_change as warm)

    out = HERE / "results_torch"
    out.mkdir(exist_ok=True)
    quiet = lambda *a, **k: None  # noqa: E731
    failed = []

    def tool(name, fn, problem, describe, routed=None):
        for m in kernels.values():
            m.launches = 0
        t0 = time.perf_counter()
        try:
            rec = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            why, line = problem(rec), describe(rec)
        except Exception as e:  # noqa: BLE001 - every tool runs; the phase fails after
            print(f"tools {name} on {card}: FAILED: {type(e).__name__}: {e}", flush=True)
            failed.append(name)
            return None
        got = {k: m.launches for k, m in kernels.items()}
        routed = set(rec["kernels_routed"] if routed is None else routed)
        idle = sorted(k for k in routed if not got[k])
        other = sorted(k for k, n in got.items() if n and k not in routed)
        if idle:
            why += f"; routed to {idle} but they never launched here"
        if other:
            why += f"; launched {other}, which its configs do not route to"
        common.write_record(str(out / f"{name}.json"), rec)
        print(f"tools {name} on {card}: {wall:.1f} s; launches here "
              f"{ {k: n for k, n in got.items() if n} }; {line}"
              + (f"; FAILED: {why.lstrip('; ')}" if why else "; ok"), flush=True)
        if why:
            failed.append(name)
        return rec

    def bench_line(r):
        return "; ".join(
            f"{k}: p50 {v['p50_ms']:.3f} / p90 {v['p90_ms']:.3f} / p99 {v['p99_ms']:.3f} / max "
            f"{v['max_ms']:.3f} ms, server p50 {v['server_side_p50_ms']:.3f} ms, past server "
            f"p50 {v['client_past_server_p50_ms']:.3f} ms, {v['throughput_pairs_per_s']:.3f} "
            f"pairs/s, first answers {'bit for bit' if v['first_answer_bit_exact'] else 'DIFFER'}"
            for k, v in r["wire"].items())

    t_phase = time.perf_counter()
    # kitti_sgm answers ~10 pairs/s under 4 clients: fewer requests keep the phase short
    for preset, kernel, requests in (("kitti_sep", "K2", 100), ("kitti_sgm", "SGM", 40)):
        tool(f"serve_bench_{preset}", lambda: serve_bench.run(
                 dev, preset, 4, requests,
                 log_path=str(out / f"serve_bench_{preset}_daemon.log"), progress=quiet),
             lambda r: "" if r["ok"] else f"errors {r['errors']}",
             lambda r: f"{preset}, 4 clients x {requests} requests x 3 wires at "
                       f"{ENTRY_W}x{ENTRY_H} D={ENTRY_D}: " + bench_line(r),
             routed=[kernel])

    def soak_line(r):
        return (f"{r['requests_completed']} requests, {r['unstable']} unstable, "
                f"{r['server_errors']} server errors, {r['client_reconnects']} reconnects, "
                f"{r['supervisor_restarts_on_42']} restarts on 42 (limit "
                f"{r['max_rss_mb_limit']} MiB), {r['aggregate_pairs_per_s']} pairs/s in "
                f"{r['wall_s']} s; per class p50/p99 ms "
                + ", ".join(f"{k} {v['p50_ms']}/{v['p99_ms']}"
                            for k, v in r["latency_by_class"].items())
                + "; generations: " + "; ".join(
                    f"rc {g['rc']}, up {g['up_s']} s, first answer {g['first_answer_s']} s "
                    f"(elapsed_ms {g['first_answer_elapsed_ms']}), {g['answers']} answers, "
                    f"RSS MiB {g['rss_curve_mb']}" for g in r["generations"]))

    soaks = tool("serve_soak", lambda: serve_soak.run(
                     dev, requests=1000, clients=4, recycle_requests=48, recycle_clients=2,
                     log_dir=str(out / "serve_soak_logs"), deadline_s=600, progress=quiet),
                 lambda r: "; ".join(f"{k} soak missed {[c for c, ok in r[k]['checks'].items()
                                                          if not ok]}"
                                     for k in ("recycle", "steady") if not r[k]["ok"]),
                 lambda r: f"probe RSS {r['recycle']['probe']['rss_mb_listening']} MiB "
                           f"listening, {r['recycle']['probe']['rss_mb_after_first_answer']} "
                           f"MiB after one answer; recycle soak (48 requests, 2 clients): "
                           + soak_line(r["recycle"]) + " | steady soak (1000 requests, 4 "
                           "clients, 8192 MiB): " + soak_line(r["steady"]),
                 routed=["K1", "K2"])
    if soaks is not None:  # the reference's two records
        common.write_record(str(out / "serve_soak_2k.json"), soaks["recycle"])
        common.write_record(str(out / "serve_soak_2k_steady.json"), soaks["steady"])
    tool("sweep_soak", lambda: sweep_soak(out),
         lambda r: "" if r["returncode"] == 0 and r["pairs"] == SWEEP_SOAK_PAIRS else
         f"exit {r['returncode']}, {r['pairs']} pairs, timed out {r['timed_out']}",
         lambda r: f"sweep kitti_sep over {r['pairs']} pairs at {ENTRY_W}x{ENTRY_H} "
                   f"D={ENTRY_D} in a child process: RSS first / peak / last "
                   f"{r['rss_mb_first']} / {r['rss_mb_peak']} / {r['rss_mb_last']} MiB over "
                   f"{r['samples']} samples; {r['pairs_per_s']:.3f} pairs/s over the child's "
                   f"{r['wall_s']} s, {r['steady_pairs_per_s']} pairs/s between its first "
                   f"and last map; mean_bad_2 {r['mean_bad_2']}", routed=[])
    for mode, kw, kernel in (("symmetric", {}, "K1"), ("left_only", {"left_only": True}, "K3"),
                             ("box", {"box": True}, "K3"),
                             ("symmetric+separable", {"separable": True}, "K2")):
        tool(f"profile_stages_kitti_{mode.replace('+', '_')}",
             lambda: profile_stages.run(dev, "kitti", queue=8, progress=quiet, **kw),
             lambda r: "; ".join(r["launch_problems"]),
             lambda r: f"{r['mode']}: " + ", ".join(
                 f"{x['rung']} {1e3 * x['s_per_pair']:.3f} ms ({x['delta_ms']:+.3f}; "
                 f"{x['launches']})" for x in r["rows"])
                 + f"; epilogue {r['epilogue_share_pct']}%, {r['pairs_per_s_full']} pairs/s",
             routed=[kernel])
    tool("separable_ab", lambda: bench_separable.run(dev, ("kitti",), 8, progress=quiet),
         lambda r: ("" if r["ok"] else "accuracy bars missed")
         + "".join(f"; {x['variant']}: {x['error']}" for x in r["errors"]),
         lambda r: "; ".join(
             f"{x['variant']} {x['pairs_per_s']} pairs/s ({x['pairs_per_s_queued']} queued), "
             f"peak {x['peak_alloc_mib']} MiB, bad_2 {x['bad_2']}, epe {x['epe']}"
             if "bad_2" in x else f"{x['variant']}: " + (x.get("error") or
                                                         f"{x['agree_sixteenth_px']} within "
                                                         f"1/16 px, max |diff| "
                                                         f"{x['max_abs_delta']}")
             for x in r["rows"]) + "; against bench_results/separable_ab.json: "
         + common.summary(r["checks"]))
    tool("headline_variance", lambda: headline_variance.run(dev, sessions=3, chain=19,
                                                           progress=quiet),
         lambda r: "" if r["device_time"]["device_s_per_pair"] else "no device time",
         lambda r: f"chain of {r['device_time']['chain']} kitti_sep pairs: device busy "
                   f"{1e3 * r['device_time']['device_s_per_pair']:.3f} ms/pair "
                   f"({r['device_time']['device_pairs_per_s']:.3f} pairs/s), wall "
                   f"{1e3 * r['device_time']['wall_s_per_pair']:.3f} ms/pair (CUDA events, "
                   f"{r['device_time']['dispatch_times_s']} s per chain); 3 CLI sessions "
                   f"mean_s {[x['mean_s'] for x in r['sessions']]}, best_s "
                   f"{[x['best_s'] for x in r['sessions']]}, compile_s "
                   f"{[x['compile_s'] for x in r['sessions']]}, process "
                   f"{[x['process_s'] for x in r['sessions']]} s; median mean_s "
                   f"{r['median_mean_s']}; dispatch overhead "
                   f"{1e3 * r['dispatch_overhead_s_per_pair']:.3f} ms/pair",
         routed=["K2"])

    def warm_run():
        results = out / "warm"
        results.mkdir(exist_ok=True)
        child = warm.hook(["aswstereomatch_torch/ops/cuda/asw_kernel.cu", "README.md"], results)
        if child is None:
            raise RuntimeError("the hook spawned no child for a change to asw_kernel.cu")
        try:
            rc = child.wait(timeout=300)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
            raise
        lines = (results / "warm_cache.log").read_text().splitlines()
        lib = next((ln.split(" library ", 1)[1].split(" (")[0] for ln in reversed(lines)
                    if " library " in ln), None)
        return {"rc": rc, "library": lib, "want": str(build.library_path()),
                "log": lines[-1] if lines else "",
                "hook_log": (results / "warm_hook.log").read_text().splitlines()[-1]}

    tool("warm_hook", warm_run,
         lambda r: "" if r["rc"] == 0 and r["library"] == r["want"] else
         f"child exit {r['rc']}, library {r['library']} against {r['want']}: {r['log']}",
         lambda r: f"{r['hook_log']}; the child's library {r['library']} (build.library_path() "
                   f"{'equal' if r['library'] == r['want'] else 'DIFFERS'})", routed=[])
    print(f"tools: {time.perf_counter() - t_phase:.1f} s for phase 11; records in {out}",
          flush=True)
    if failed:
        fail(f"timing tools: {', '.join(failed)} failed")


def main() -> int:
    sys.path.insert(0, str(HERE))
    try:
        import torch

        import aswstereomatch_torch
    except ImportError as e:
        fail(f"import: {e} (run from a checkout of the repository)")
    if Path(aswstereomatch_torch.__file__).resolve().parent.parent != HERE:
        fail(f"aswstereomatch_torch loaded from {aswstereomatch_torch.__file__}, "
             f"not from the checkout at {HERE}")
    from aswstereomatch_torch.config import SEP_CONTRACT, StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops import aggregate
    from aswstereomatch_torch.ops import cost as cost_ops
    from aswstereomatch_torch.ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel,
                                               asw_sym_dlanes_kernel, build, common,
                                               cost_kernel, disparity_kernel, sgm_kernel,
                                               stacks_kernel, wta_kernel)
    from aswstereomatch_torch.utils import evaluate, plan_sweep, synthetic

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("device: torch.cuda.is_available() is False; this script runs on a GPU only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    try:
        build.load()
    except build.BuildError as e:
        fail(f"build: {e}")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s; " + " | ".join(ptxas), flush=True)

    # ---- 3. kernel vs plain, small geometries ---------------------------
    for label, kernel, cases in (("small K1", "asw_kernel", SMALL_CASES),
                                 ("small K2", "asw_sep_kernel", SEP_SMALL_CASES),
                                 ("small K3", "asw_dlanes_kernel", DLANES_SMALL_CASES),
                                 ("small K4", "asw_sym_dlanes_kernel", SYM_DLANES_SMALL_CASES)):
        small = []
        for case in cases:
            try:
                small.append(check_small(*case, device=dev, kernel=kernel))
            except AssertionError as e:
                fail(f"{label} {case[0]}: {e}")
        if label == "small K2":
            for name, sym in SEP_BF16_CASES:
                try:
                    small.append(check_sep_bf16(name, sym, dev))
                except AssertionError as e:
                    fail(f"{label} {name}: {e}")
        print(f"{label}: " + ", ".join(f"{s['case']} ok" for s in small), flush=True)
    shard_small = []
    for case in K1_SHARD_CASES:
        try:
            shard_small.append(check_k1_shard(*case, device=dev))
        except AssertionError as e:
            fail(f"small K1 shard inputs {case[0]}: {e}")
    print("small K1 shard inputs (n_valid_cols, d_window, strip): "
          + ", ".join(f"{s['case']} ok" for s in shard_small), flush=True)
    for case in SGM_SMALL_CASES:
        try:
            check_sgm(*case, device=dev)
        except AssertionError as e:
            fail(f"small SGM {case[0]}: {e}")
    print("small SGM: " + ", ".join(f"{c[0]} ok" for c in SGM_SMALL_CASES)
          + " (kernel equals plain bit for bit under the default plan and, where that is "
          "the register path, the long-D path)", flush=True)

    # ---- 4. kernel vs plain at full width -------------------------------
    def full_width(label, cfg, pair, kernel=None):
        module = _kernel_module(cfg, kernel)
        l = torch.from_numpy(pair["left"]).to(dev)
        r = torch.from_numpy(pair["right"]).to(dev)
        got = {k: v.cpu().numpy() for k, v in module.wta_outputs(l, r, cfg).items()}
        ref = {k: v.cpu().numpy() for k, v in module.wta_outputs_reference(l, r, cfg).items()}
        agree = {}
        for k in ("bestd", "rbestd"):
            agree[k] = _argmin_agreement(got[k], ref[k])
            if not (agree[k][0] > 0.99 and agree[k][1] < 0.005):
                fail(f"full {label} {k}: agreement {agree[k][0]:.6f}, "
                     f"|dd|>2 on {agree[k][1]:.6f}")
        try:  # f32 sums of many taps in another order: the box-kernel bar
            errs = check_floats_where_argmin_agrees(got, ref, cfg.max_disparity)
            if module is asw_dlanes_kernel and cfg.aggregation == "box":
                _check_bits(label, got, ref, cfg.max_disparity)
        except AssertionError as e:
            fail(f"full {label}: {e}")
        print(f"full: {label} bestd agree {agree['bestd'][0]:.6f} "
              f"(|dd|>2 {agree['bestd'][1]:.6f}), rbestd agree {agree['rbestd'][0]:.6f} "
              f"(|dd|>2 {agree['rbestd'][1]:.6f}), max_abs_err where bestd agrees "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
        return errs["bestc"]

    cfg_m = aswstereomatch_torch.get_preset("middlebury_asw_full")
    D_m = cfg_m.max_disparity
    pm = synthetic.make_pair(height=375, width=450, max_disparity=D_m, seed=11)
    max_abs_err = full_width("K1 450x375 D=64 r=16", cfg_m, pm)
    cfg_tsu = aswstereomatch_torch.get_preset("tsukuba_ad_box")  # K1 box, D <= 64
    ptsu = synthetic.make_pair(height=288, width=384, max_disparity=cfg_tsu.max_disparity,
                               seed=41)
    full_width("K1 box tsukuba_ad_box 384x288 D=16 r=4", cfg_tsu, ptsu)
    cfg_sep = aswstereomatch_torch.get_preset("kitti_sep")
    cfg_seplo = aswstereomatch_torch.get_preset("kitti_seplo")
    kitti_cfg = aswstereomatch_torch.get_preset("kitti_tiled")
    cfg_lo = kitti_cfg.replace(asw_symmetric=False)     # K3, left-only ASW
    cfg_box = kitti_cfg.replace(aggregation="box")      # K3, box at D > 64
    cfg_sdl = kitti_cfg.replace(kernel_layout="dlanes")  # K4
    pk = synthetic.make_pair(height=375, width=1242, max_disparity=128, seed=31)
    full_width("K1 kitti_tiled 1242x375 D=128 r=16", kitti_cfg, pk)
    sep_err = full_width("K2 kitti_sep 1242x375 D=128 r=16", cfg_sep, pk)
    full_width("K2 kitti_seplo 1242x375 D=128 r=16", cfg_seplo, pk)
    dl_err = full_width("K3 left-only 1242x375 D=128 r=16", cfg_lo, pk, "asw_dlanes_kernel")
    full_width("K3 box 1242x375 D=128 r=16", cfg_box, pk, "asw_dlanes_kernel")
    sdl_err = full_width("K4 symmetric dlanes 1242x375 D=128 r=16", cfg_sdl, pk,
                         "asw_sym_dlanes_kernel")
    cfg_sdl_m = cfg_m.replace(kernel_layout="dlanes")  # K4 at D = 64
    full_width("K4 symmetric dlanes 450x375 D=64 r=16", cfg_sdl_m, pm, "asw_sym_dlanes_kernel")
    # K4 against K1 bit for bit at every K4 geometry: the small cases and
    # the full-width pairs (K4_FULL_CASES)
    k4_pairs = []
    for name, over, shape, kw, _ in SYM_DLANES_SMALL_CASES:
        cfg = StereoConfig(**{**_BASE, **over})
        k4_pairs.append((name, cfg, synthetic.make_pair(
            height=shape[0], width=shape[1], max_disparity=cfg.max_disparity, **kw)))
    k4_pairs += [(name, aswstereomatch_torch.get_preset(preset).replace(kernel_layout="dlanes"),
                  {"kitti_tiled": pk, "middlebury_asw_full": pm}[preset])
                 for name, preset, shape, seed in K4_FULL_CASES]
    for name, cfg, pair in k4_pairs:
        try:
            check_k4_bits(name, cfg, pair, dev)
        except AssertionError as e:
            fail(f"full {e}")
    print(f"full: K4 equals K1 over the same stacks bit for bit, all six planes, at "
          f"{len(k4_pairs)} geometries ({', '.join(n for n, _, _ in k4_pairs)})", flush=True)
    # SGM on the port's raw cost volume of the 1242x375 pair, 4 and 8 paths
    cfg_sgm = aswstereomatch_torch.get_preset("kitti_sgm")
    lk = torch.from_numpy(pk["left"]).to(dev)
    rk = torch.from_numpy(pk["right"]).to(dev)
    vol_k = cost_ops.cost_volume(lk, rk, cfg_sgm)
    sgm_err = 0.0
    for paths in (4, 8):
        c = cfg_sgm.replace(sgm_paths=paths)
        ref = sgm_kernel.aggregate_reference(vol_k, c)
        for i, plan in enumerate(sgm_check_plans(375, 1242, 128, paths)):
            got = sgm_kernel.aggregate(vol_k, c, None if i == 0 else plan)
            if not (torch.isfinite(got).all() and torch.equal(got, ref)):
                fail(f"full: SGM kitti_sgm {paths} paths (vpl {plan.vpl}) differs from "
                     f"its plain version on "
                     f"{int((got != ref).sum())} of {ref.numel()} values")
            sgm_err = max(sgm_err, float((got - ref).abs().max()))
        del got, ref
    print("full: SGM kitti_sgm 1242x375 D=128, 4 and 8 paths: kernel equals plain bit for "
          "bit under the default plan and the long-D path",
          flush=True)

    # ---- 5. main paths: matchers serving requests -----------------------
    u8 = lambda a: a.astype(np.uint8)  # noqa: E731  (lossless: 8-bit grid)

    def check_map(label, d, p, D, max_bad2=None):
        rep = evaluate.bad_report(d, p["gt"], valid=~p["occluded"])
        if not (d.shape == p["gt"].shape and np.isfinite(d).all() and d.min() >= 0
                and d.max() < D and rep["density"] == 1.0
                and (max_bad2 is None or rep["bad_2"] < max_bad2)):
            fail(f"serve: bad {label} map: min {d.min()}, max {d.max()}, {rep}")
        return rep["bad_2"]

    def serve(matcher, pairs, batch_of):
        """Single calls for each pair, then one batch of the first
        `batch_of`; numpy maps."""
        disps = [matcher(u8(p["left"]), u8(p["right"])).cpu().numpy() for p in pairs]
        batch = None
        if batch_of:
            batch = matcher.batch(np.stack([u8(p["left"]) for p in pairs[:batch_of]]),
                                  np.stack([u8(p["right"]) for p in pairs[:batch_of]]))
            batch = batch.cpu().numpy()
            for i in range(batch_of):
                if not np.array_equal(batch[i], disps[i]):
                    fail(f"serve: batch[{i}] differs from the single call")
        return disps

    kernels = {"K1": asw_kernel, "K2": asw_sep_kernel, "K3": asw_dlanes_kernel,
               "K4": asw_sym_dlanes_kernel, "SGM": sgm_kernel}

    def reset():
        torch.cuda.synchronize()
        for m in (*kernels.values(), stacks_kernel, cost_kernel, disparity_kernel, wta_kernel):
            m.launches = 0
        sgm_kernel.long_launches = 0

    def launched(label, want, stack_builds=True, maps=None) -> int:
        """Fails unless the launches since the last reset are ``want`` (name
        -> count) and none of any other kernel, and, with ``stack_builds``,
        the stack kernel's one per launch of K1-K4 (every kernel-route call
        built its stacks in it), and, where ``maps`` is given, the disparity
        kernel's one per map; returns their sum."""
        torch.cuda.synchronize()
        got = {k: m.launches for k, m in kernels.items()}
        full = {k: want.get(k, 0) for k in kernels}
        if got != full:
            fail(f"serve: {label} launched {got}, expected {full}")
        if maps is not None and disparity_kernel.launches != maps:
            fail(f"serve: {label} launched the disparity kernel {disparity_kernel.launches} "
                 f"times, expected {maps} (one per map)")
        builds = sum(want.get(k, 0) for k in ("K1", "K2", "K3", "K4"))
        if stack_builds and stacks_kernel.launches != builds:
            fail(f"serve: {label} launched the stack kernel {stacks_kernel.launches} times, "
                 f"expected {builds} (one per launch of K1-K4)")
        return sum(want.values())

    Matcher = aswstereomatch_torch.StereoMatcher
    matcher = Matcher.from_preset("middlebury_asw_full")
    kitti = Matcher(kitti_cfg)
    sep = Matcher.from_preset("kitti_sep")
    tsu = Matcher(cfg_tsu)
    seplo = Matcher.from_preset("kitti_seplo")
    lo, box, sdl = Matcher(cfg_lo), Matcher(cfg_box), Matcher(cfg_sdl)
    sdl_m = Matcher(cfg_sdl_m)
    for m, want in ((matcher, asw_kernel), (kitti, asw_kernel), (tsu, asw_kernel),
                    (sep, asw_sep_kernel),
                    (seplo, asw_sep_kernel), (lo, asw_dlanes_kernel), (box, asw_dlanes_kernel),
                    (sdl, asw_sym_dlanes_kernel), (sdl_m, asw_sym_dlanes_kernel)):
        if (pipeline._resolve_backend(m.cfg, m.device) != "cuda"
                or pipeline.kernel_for(m.cfg) is not want):
            fail(f"serve: {m.cfg} does not resolve to {want.__name__}")
    reqs = [synthetic.make_pair(height=375, width=450, max_disparity=D_m, seed=s)
            for s in (21, 22, 23)]
    reqs_k = [pk] + [synthetic.make_pair(height=375, width=1242, max_disparity=128, seed=s)
                     for s in (32, 33)]

    # K1's path: middlebury_asw_full requests, then one kitti_tiled pair
    reset()
    disps = serve(matcher, reqs, 2)
    dk = serve(kitti, [pk], 0)[0]
    main_launches = launched("K1's path", {"K1": 6}, maps=6)
    map_launches = disparity_kernel.launches
    stack_launches = stacks_kernel.launches
    bads = [check_map("450x375", d, p, D_m, 0.05) for p, d in zip(reqs, disps)]
    bad_k = check_map("kitti_tiled", dk, pk, 128)
    print(f"serve K1: 3 requests 450x375 bad_2 {[round(b, 5) for b in bads]}, batch of 2 "
          f"== singles, kitti_tiled 1242x375 D=128 bad_2 {bad_k:.5f} density 1.0; "
          f"K1 launches {main_launches}, stack kernel {stack_launches}, other kernels 0",
          flush=True)

    # K2's path: kitti_sep requests and a batch of two, one kitti_seplo pair
    reset()
    ds = serve(sep, reqs_k, 2)
    dlo = serve(seplo, [pk], 0)[0]
    sep_launches = launched("K2's path", {"K2": 6}, maps=6)
    map_launches += disparity_kernel.launches
    stack_launches += stacks_kernel.launches
    bads_s = [check_map("kitti_sep", d, p, 128, 0.05) for p, d in zip(reqs_k, ds)]
    bad_lo = check_map("kitti_seplo", dlo, pk, 128, 0.05)
    delta = evaluate.bad_delta_between(ds[0], dk, 2.0, ~pk["occluded"])
    if not delta <= SEP_CONTRACT["delta_bad2_max"]:
        fail(f"serve: kitti_sep drifted from exact kitti_tiled: bad-2.0 delta {delta}")
    print(f"serve K2: 3 requests kitti_sep 1242x375 bad_2 {[round(b, 5) for b in bads_s]}, "
          f"batch of 2 == singles, kitti_seplo bad_2 {bad_lo:.5f}, density 1.0; "
          f"kitti_sep vs exact kitti_tiled bad-2.0 delta {delta:.5f} "
          f"(<= {SEP_CONTRACT['delta_bad2_max']}); K2 launches {sep_launches}, "
          f"stack kernel {stacks_kernel.launches}, other kernels 0", flush=True)

    # K3's paths: left-only ASW requests and a batch of two; box, one pair
    reset()
    dls = serve(lo, reqs_k, 2)
    dl_launches = launched("K3's left-only path", {"K3": 5}, maps=5)
    map_launches += disparity_kernel.launches
    reset()
    dbox = serve(box, [pk], 0)[0]
    dl_launches += launched("K3's box path", {"K3": 1}, maps=1)
    map_launches += disparity_kernel.launches
    bads_l = [check_map("left-only", d, p, 128, 0.05) for p, d in zip(reqs_k, dls)]
    bad_box = check_map("box", dbox, pk, 128)
    print(f"serve K3: 3 requests left-only ASW 1242x375 D=128 bad_2 "
          f"{[round(b, 5) for b in bads_l]}, batch of 2 == singles, density 1.0; box 1 pair "
          f"bad_2 {bad_box:.5f} density 1.0; K3 launches {dl_launches} (5 + 1), "
          f"other kernels 0", flush=True)

    # K4's path: kitti_tiled on kernel_layout="dlanes", one pair, against K1's map
    reset()
    dsdl = serve(sdl, [pk], 0)[0]
    sdl_launches = launched("K4's path", {"K4": 1}, maps=1)
    map_launches += disparity_kernel.launches
    bad_sdl = check_map("symmetric dlanes", dsdl, pk, 128)
    sdl_agree, sdl_gross = _argmin_agreement(dsdl, dk)  # test_pallas_dlanes.py:232-234
    if not (sdl_agree > 0.99 and sdl_gross < 0.005):
        fail(f"serve: K4's map vs K1's: agreement {sdl_agree}, |dd|>2 on {sdl_gross}")
    reset()
    try:
        Matcher(kitti_cfg.replace(kernel_layout="dlanes", max_disparity=256))(
            u8(pk["left"]), u8(pk["right"]))
        fail("serve: kernel_layout='dlanes' with D=256 did not raise on the card")
    except ValueError as e:
        refused = str(e)
    launched("the refused D=256 config", {}, maps=0)
    print(f"serve K4: kitti_tiled on dlanes 1242x375 D=128 bad_2 {bad_sdl:.5f} density 1.0, "
          f"vs K1's map: within 0.51 on {sdl_agree:.6f}, |dd|>2 on {sdl_gross:.6f}; "
          f"K4 launches {sdl_launches}, other kernels 0; dlanes D=256 raised: {refused}",
          flush=True)

    # SGM's path: kitti_sgm requests and a batch of two, one 8-path pair;
    # the raw cost volume in the cost kernel, its aggregation the SGM kernel
    sgm_m = Matcher.from_preset("kitti_sgm")
    sgm8 = Matcher.from_preset("kitti_sgm", sgm_paths=8)
    for m in (sgm_m, sgm8):
        if (pipeline._resolve_backend(m.cfg, m.device) != "eager"
                or pipeline.kernel_for(m.cfg) is not None):
            fail(f"serve: {m.cfg} does not resolve to the eager path and its SGM kernel")
    reset()
    dsg = serve(sgm_m, reqs_k, 2)
    dsg8 = serve(sgm8, [pk], 0)[0]
    sgm_launches = launched("SGM's path", {"SGM": 6}, maps=6)
    map_launches += disparity_kernel.launches
    cost_launches = cost_kernel.launches
    if cost_launches != 6:
        fail(f"serve: SGM's path launched the cost kernel {cost_launches} times, expected 6 "
             f"(one volume a pair)")
    if sgm_kernel.long_launches:
        fail(f"serve: SGM's path at D=128 ran {sgm_kernel.long_launches} volumes on the long-D "
             f"path, expected 0 (the register path)")
    wta_launches = wta_kernel.launches
    if wta_launches != sgm_launches:
        fail(f"serve: SGM's path launched the WTA kernel {wta_launches} times, expected "
             f"{sgm_launches} (one per SGM volume)")
    bads_g = [check_map("kitti_sgm", d, p, 128, 0.05) for p, d in zip(reqs_k, dsg)]
    bad_g8 = check_map("kitti_sgm 8 paths", dsg8, pk, 128, 0.05)
    # the same pipeline with the plain cost loop, the plain SGM and the plain
    # post-process on the card: the same map, bit for bit
    kernel_aggregate, kernel_cost = sgm_kernel.aggregate, cost_kernel.cost_volume
    kernel_map, kernel_planes = disparity_kernel.disparity_map, wta_kernel.planes
    sgm_kernel.aggregate = sgm_kernel.aggregate_reference
    cost_kernel.cost_volume = cost_kernel.reference
    disparity_kernel.disparity_map = disparity_kernel.reference
    wta_kernel.planes = wta_kernel.reference
    reset()
    try:
        plain_maps = [m(u8(pk["left"]), u8(pk["right"])).cpu().numpy() for m in (sgm_m, sgm8)]
    finally:
        sgm_kernel.aggregate, cost_kernel.cost_volume = kernel_aggregate, kernel_cost
        disparity_kernel.disparity_map, wta_kernel.planes = kernel_map, kernel_planes
    launched("the plain SGM pipeline", {}, maps=0)
    if cost_kernel.launches or wta_kernel.launches:
        fail(f"serve: the plain SGM pipeline launched the cost kernel {cost_kernel.launches} "
             f"times and the WTA kernel {wta_kernel.launches} times")
    for paths, got, want in ((4, dsg[0], plain_maps[0]), (8, dsg8, plain_maps[1])):
        if not np.array_equal(got, want):
            fail(f"serve: kitti_sgm {paths} paths differs from the plain pipeline on "
                 f"{int((got != want).sum())} pixels")
    print(f"serve SGM: 3 requests kitti_sgm 1242x375 D=128 bad_2 "
          f"{[round(b, 6) for b in bads_g]}, batch of 2 == singles, 8 paths bad_2 "
          f"{bad_g8:.6f}, density 1.0; maps equal the plain pipeline's (plain cost loop, "
          f"plain SGM, plain WTA planes, plain post-process) bit for bit (4 and 8 paths); "
          f"SGM launches {sgm_launches} (5 + 1), none on the long-D path, "
          f"cost kernel {cost_launches}, WTA kernel {wta_launches}, other kernels 0",
          flush=True)

    # middeval3_h_sgm's path: one 1440x994 D=256 8-path pair with the
    # uniqueness gate; the scan on the SGM kernel's long-D path
    mid = middeval3_serve(reset, launched, check_map)
    sgm_launches += 1
    cost_launches += 1
    map_launches += 1
    wta_launches += 1
    print(f"serve SGM: middeval3_h_sgm 1440x994 D=256 8 paths uniqueness 10 bad_2 "
          f"{mid['bad_2']:.6f}, density 1.0; the map equals the plain pipeline's bit for bit; "
          f"SGM 1 (on the long-D path), cost kernel 1, WTA kernel 1, disparity kernel 1, "
          f"other kernels 0", flush=True)
    print(f"serve maps: the disparity kernel launched once per map on every path, "
          f"{map_launches} times", flush=True)

    # The confidence surface on each kind of path: its disp is match_pair's,
    # and lr_valid & (uniq_pct >= r) reproduces the uniqueness_ratio=r gate
    # (fill and median off, which would move the rejected pixels)
    for label, cfg, p, key in (("middlebury_asw_full 450x375 D=64", cfg_m, reqs[0], "K1"),
                               ("kitti_sep 1242x375 D=128", cfg_sep, pk, "K2"),
                               ("kitti_sgm 1242x375 D=128", cfg_sgm, pk, "SGM")):
        l = torch.from_numpy(p["left"]).to(dev)
        r = torch.from_numpy(p["right"]).to(dev)
        reset()
        disp, uniq, lrv = pipeline.match_pair_with_confidence(l, r, cfg)
        same = torch.equal(disp, pipeline.match_pair(l, r, cfg))
        worst = 0
        for ratio in (5.0, 15.0):
            gated = pipeline.match_pair(l, r, cfg.replace(uniqueness_ratio=ratio,
                                                          fill_holes=False, median_filter=False))
            worst = max(worst, int(((lrv & (uniq >= ratio)) != (gated >= 0)).sum()))
        launched(f"confidence {label}", {key: 4}, maps=4)
        bar = int(1e-4 * disp.numel())
        if not (same and uniq.dtype == torch.float32 and lrv.dtype == torch.bool
                and bool(((uniq >= 0) & (uniq <= 1e6)).all()) and worst <= bar):
            fail(f"confidence {label}: disp == match_pair {same}, gate disagreements {worst} "
                 f"(bar {bar})")
        print(f"confidence {label} ({key}): disp equals match_pair bit for bit; the gate at "
              f"r = 5 and 15 reproduced but for at most {worst} pixels (bar {bar}); "
              f"lr_valid share {float(lrv.float().mean()):.4f}", flush=True)

    # y_chunks row streaming at full width: eager kitti_tiled in 4 bands equals
    # the unbanded run bit for bit; the kernel path ignores y_chunks
    cfg_e = kitti_cfg.replace(backend="eager")
    maps, peaks, walls = {}, {}, {}
    reset()
    for n in (1, 4):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        maps[n] = pipeline.match_pair(lk, rk, cfg_e.replace(y_chunks=n))
        torch.cuda.synchronize()
        walls[n] = time.perf_counter() - t0
        peaks[n] = (torch.cuda.max_memory_allocated() - held) / 2**20
    launched("eager kitti_tiled", {}, maps=5)  # one band, then four
    if not torch.equal(maps[1], maps[4]):
        fail(f"y_chunks: eager kitti_tiled in 4 bands differs from one on "
             f"{int((maps[1] != maps[4]).sum())} pixels")
    bad_e = check_map("eager kitti_tiled", maps[1].cpu().numpy(), pk, 128)
    # Why the eager window sums take a fixed order: rows of 1089 taps moved
    # by one row (4 bytes off their 16-byte alignment), summed again
    taps = torch.rand(4000, 1089, device=dev, generator=torch.Generator(dev).manual_seed(0))
    moved = torch.cat([taps[:1], taps])[1:]
    plain_moved = int((moved.sum(-1) != taps.sum(-1)).sum())
    fixed_moved = int((aggregate._window_sum(moved, 33)
                       != aggregate._window_sum(taps, 33)).sum())
    if fixed_moved:
        fail(f"y_chunks: the fixed-order window sum moved with its rows on {fixed_moved} rows")
    reset()
    dk3 = Matcher(kitti_cfg.replace(y_chunks=3))(u8(pk["left"]), u8(pk["right"])).cpu().numpy()
    launched("kitti_tiled with y_chunks=3", {"K1": 1}, maps=1)
    if not np.array_equal(dk3, dk):
        fail("y_chunks: kitti_tiled on K1 with y_chunks=3 differs from y_chunks=1")
    print(f"y_chunks: eager kitti_tiled 1242x375 D=128, 4 bands == 1 band bit for bit "
          f"(bad_2 {bad_e:.5f}); peak allocation {peaks[1]:.1f} MiB in one band, "
          f"{peaks[4]:.1f} MiB in 4; {walls[1]:.2f} / {walls[4]:.2f} s; K1 with y_chunks=3 "
          f"== y_chunks=1; rows of 1089 taps moved by 4 bytes: a plain sum changes on "
          f"{plain_moved} of 4000, the fixed-order window sum on {fixed_moved}", flush=True)

    # ---- 6. times -------------------------------------------------------
    times = {}
    for geo, cfg, p, m, reps, kernel in (
            ("K1 450x375", cfg_m, reqs[0], matcher, 5, None),
            ("K1 1242x375", kitti_cfg, pk, kitti, 3, None),
            ("K1 box 384x288", cfg_tsu, ptsu, tsu, 5, None),
            ("K2 kitti_sep 1242x375", cfg_sep, pk, sep, 5, None),
            ("K2 kitti_seplo 1242x375", cfg_seplo, pk, seplo, 5, None),
            ("K3 left-only 1242x375", cfg_lo, pk, lo, 3, "asw_dlanes_kernel"),
            ("K3 box 1242x375", cfg_box, pk, box, 3, "asw_dlanes_kernel"),
            ("K4 1242x375", cfg_sdl, pk, sdl, 3, "asw_sym_dlanes_kernel"),
            ("K4 450x375", cfg_sdl_m, reqs[0], sdl_m, 3, "asw_sym_dlanes_kernel")):
        module = _kernel_module(cfg, kernel)
        l = torch.from_numpy(p["left"]).to(dev)
        r = torch.from_numpy(p["right"]).to(dev)
        lu, ru = u8(p["left"]), u8(p["right"])
        H, W = p["gt"].shape
        if cfg.asw_separable:
            bound_ms, bound_by = k2_bound(H, W, cfg)
        elif cfg.aggregation == "box":
            bound_ms, bound_by = box_bound(H, W, cfg)
        else:
            bound_ms, bound_by = k1_bound(H, W, cfg)
        ls, rs = common.stacks(l, r, cfg)
        times[geo] = {  # ms / plain_ms: the wrappers with the stacks built inside
            "ms": _median_ms(lambda: module.wta_outputs(l, r, cfg), reps),
            "plain_ms": _median_ms(lambda: module.wta_outputs_reference(l, r, cfg), reps),
            "from_stacks_ms": _median_ms(
                lambda: module.wta_outputs_from_stacks(ls, rs, cfg), reps),
            "plain_from_stacks_ms": _median_ms(
                lambda: module.reference_from_stacks(ls, rs, cfg), reps),
            "e2e_ms": _median_ms(lambda: m(lu, ru), reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        t = times[geo]
        k1_note = ""
        if module is asw_dlanes_kernel:
            t["plan"] = list(asw_dlanes_kernel.tile_plan(H, W, cfg.max_disparity,
                                                         cfg.window_radius,
                                                         cfg.aggregation == "box"))
        if module is asw_sym_dlanes_kernel:
            t["plan"] = list(asw_sym_dlanes_kernel.tile_plan(H, W, cfg.max_disparity,
                                                             cfg.window_radius))
        if module is asw_sep_kernel:
            t["plan"] = list(asw_sep_kernel.tile_plan(H, W, cfg.max_disparity,
                                                      cfg.window_radius, cfg.asw_symmetric))
            # peak allocation of one end-to-end call, above what the script holds
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            m(lu, ru)
            torch.cuda.synchronize()
            t["peak_alloc_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
        if kernel is not None:  # K1 on the same function
            cfg_x = cfg.replace(kernel_layout="xlanes")
            assert pipeline.kernel_for(cfg_x) is asw_kernel
            t["k1_from_stacks_ms"] = _median_ms(
                lambda: asw_kernel.wta_outputs_from_stacks(ls, rs, cfg_x), 2)
            k1_note = f"; K1 (xlanes) over the same stacks {t['k1_from_stacks_ms']:.3f} ms"
        print(f"times {geo} D={cfg.max_disparity} on {card}: kernel {t['ms']:.3f} ms with "
              f"the channel stacks, {t['from_stacks_ms']:.3f} ms over pre-built stacks "
              f"(bound {bound_ms:.4f} ms by {bound_by}); plain {t['plain_ms']:.3f} / "
              f"{t['plain_from_stacks_ms']:.3f} ms; end-to-end {t['e2e_ms']:.3f} ms/pair"
              + k1_note + (f"; plan {t['plan']}" if "plan" in t else "")
              + (f"; peak allocation of a call {t['peak_alloc_mib']:.3f} MiB"
                 if "peak_alloc_mib" in t else ""), flush=True)

    # The stack kernel against the plain stack build: both views, bit for
    # bit, then timed (the kernel's device time from the profiler, both by
    # CUDA events around a call) beside the byte bound
    for geo, p, cfg in (("stacks 1242x375 D=128", pk, kitti_cfg),
                        ("stacks 450x375 D=64", reqs[0], cfg_m)):
        l = torch.from_numpy(p["left"]).to(dev)
        r = torch.from_numpy(p["right"]).to(dev)
        H, W = p["gt"].shape
        rad, D = cfg.window_radius, cfg.max_disparity
        got = stacks_kernel.channel_stacks(l, r, rad, D)
        want = stacks_kernel.reference(l, r, rad, D)
        for view, a, b in zip(("left", "right"), got, want):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                fail(f"stacks {geo}: the {view} stack differs from the plain build on "
                     f"{int((a.view(torch.int32) != b.view(torch.int32)).sum())} elements")
        bound_ms, bound_by = stacks_bound(H, W, rad, D)
        t = times[geo] = {  # ms: the kernel's device time; call_ms: CUDA events around a call
            "ms": _device_ms(lambda: stacks_kernel.channel_stacks(l, r, rad, D),
                             "channel_stacks_kernel", 50),
            "call_ms": _median_ms(lambda: stacks_kernel.channel_stacks(l, r, rad, D), 50),
            "plain_ms": _median_ms(lambda: stacks_kernel.reference(l, r, rad, D), 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"times {geo} r={rad} on {card}: stack kernel {t['ms']:.4f} ms on the card "
              f"({t['call_ms']:.4f} ms by CUDA events around a call), both views bit for bit "
              f"with the plain build (bound {bound_ms:.4f} ms by {bound_by}, "
              f"{100 * bound_ms / t['ms']:.1f}%); plain stack build {t['plain_ms']:.3f} ms",
              flush=True)

    # The cost kernel against the plain loop over d: the raw volume bit for
    # bit, then timed (the kernel's device time from the profiler, the call
    # with precompute's ops by CUDA events, the plain loop by CUDA events)
    # beside the byte bound
    for geo, p, c in (("cost 1242x375 D=128", pk, cfg_sgm),
                      ("cost 450x375 D=64", reqs[0], cfg_sgm.replace(max_disparity=64))):
        l = torch.from_numpy(p["left"]).to(dev)
        r = torch.from_numpy(p["right"]).to(dev)
        planes = cost_ops.precompute(l, r, c)
        got = cost_kernel.cost_volume(planes, c)
        want = cost_kernel.reference(planes, c)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"{geo}: the cost kernel differs from the plain loop on "
                 f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} elements")
        del got, want
        H, Wo, C = planes.lc.shape
        bound_ms, bound_by = cost_bound(H, Wo, C, c.max_disparity)
        t = times[geo] = {  # ms: the kernel's device time; call_ms: cost_volume by CUDA events
            "ms": _device_ms(lambda: cost_kernel.cost_volume(planes, c),
                             "cost_volume_kernel", 50),
            "call_ms": _median_ms(lambda: cost_ops.cost_volume(l, r, c), 20),
            "plain_ms": _median_ms(lambda: cost_kernel.reference(planes, c), 5),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"times {geo} on {card}: cost kernel {t['ms']:.4f} ms on the card "
              f"({t['call_ms']:.4f} ms by CUDA events around cost_volume, precompute's ops "
              f"included), bit for bit with the plain loop (bound {bound_ms:.4f} ms by "
              f"{bound_by}, {100 * bound_ms / t['ms']:.1f}%); plain loop {t['plain_ms']:.3f} ms",
              flush=True)

    # The disparity kernel against the plain post-process: the map from K2's
    # planes of the 1242x375 pair and from K1's of the 450x375 one, bit for
    # bit, then timed (the kernel's device time from the profiler, both by
    # CUDA events around a call) beside the byte bound
    for geo, p, c, module in (("disparity 1242x375 D=128", pk, cfg_sep, asw_sep_kernel),
                              ("disparity 450x375 D=64", reqs[0], cfg_m, asw_kernel)):
        l = torch.from_numpy(p["left"]).to(dev)
        r = torch.from_numpy(p["right"]).to(dev)
        planes = module.wta_outputs(l, r, c)
        got = disparity_kernel.disparity_map(planes, c, c.median_filter)
        want = disparity_kernel.reference(planes, c, c.median_filter)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"{geo}: the disparity kernel differs from the plain post-process on "
                 f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} pixels")
        H, W = p["gt"].shape
        bound_ms, bound_by = disparity_bound(H, W, c)
        t = times[geo] = {  # ms: the kernel's device time; call_ms: CUDA events around a call
            "ms": _device_ms(lambda: disparity_kernel.disparity_map(planes, c, c.median_filter),
                             "disparity_map_kernel", 50),
            "call_ms": _median_ms(
                lambda: disparity_kernel.disparity_map(planes, c, c.median_filter), 50),
            "plain_ms": _median_ms(
                lambda: disparity_kernel.reference(planes, c, c.median_filter), 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"times {geo} on {card}: disparity kernel {t['ms']:.4f} ms on the card "
              f"({t['call_ms']:.4f} ms by CUDA events around a call), bit for bit with the "
              f"plain post-process (bound {bound_ms:.4f} ms by {bound_by}, "
              f"{100 * bound_ms / t['ms']:.1f}%); plain post-process {t['plain_ms']:.3f} ms "
              f"by CUDA events around a call", flush=True)

    # SGM: the kernel over the raw cost volume, 4 and 8 paths; the raw cost
    # volume (cost_volume, through the cost kernel) and kitti_sgm end to end
    for paths in (4, 8):
        c = cfg_sgm.replace(sgm_paths=paths)
        bound_ms, bound_by = sgm_bound(375, 1242, c)
        plan = sgm_kernel.plan(375, 1242, 128, paths)
        t = times[f"SGM kitti_sgm {paths} paths"] = {
            "ms": _median_ms(lambda: sgm_kernel.aggregate(vol_k, c), 10),
            "plain_ms": _median_ms(lambda: sgm_kernel.aggregate_reference(vol_k, c), 2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "phase_ms": plan_sweep.sgm_phase_ms(vol_k, c, plan, 10),
        }
        # computed from the shape, so printed here and not in the kernels line
        schedule_bytes = sgm_schedule_bytes(375, 1242, c)
        floor_ms = schedule_bytes / HBM_BYTES * 1e3
        t["gb_per_s"] = schedule_bytes / (t["ms"] * 1e-3) / 1e9
        # peak allocation of the kernel call alone, above what the script holds
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sgm_kernel.aggregate(vol_k, c)
        torch.cuda.synchronize()
        t["kernel_peak_alloc_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
        m = sgm_m if paths == 4 else sgm8
        lu, ru = u8(pk["left"]), u8(pk["right"])
        t["e2e_ms"] = _median_ms(lambda: m(lu, ru), 3)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m(lu, ru)
        torch.cuda.synchronize()
        t["peak_alloc_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
        t["cost_volume_ms"] = _median_ms(lambda: cost_ops.cost_volume(lk, rk, c), 5)
        print(f"times SGM kitti_sgm 1242x375 D=128 {paths} paths on {card}: kernel "
              f"{t['ms']:.3f} ms (bound {bound_ms:.4f} ms by {bound_by}, "
              f"{100 * bound_ms / t['ms']:.1f}%; {3 * paths - 1} volumes "
              f"{schedule_bytes} B at {t['gb_per_s']:.1f} GB/s, {100 * floor_ms / t['ms']:.1f}% "
              f"of their {floor_ms:.3f} ms floor); phases alone "
              + " / ".join(f"{x:.3f}" for x in t["phase_ms"])
              + f" ms; kernel call peak allocation {t['kernel_peak_alloc_mib']:.3f} MiB; "
              f"plain {t['plain_ms']:.3f} ms; raw cost volume (the cost kernel) "
              f"{t['cost_volume_ms']:.3f} ms; end-to-end {t['e2e_ms']:.3f} ms/pair; "
              f"peak allocation of a call {t['peak_alloc_mib']:.3f} MiB", flush=True)

    # The WTA kernel over kitti_sgm's SGM volume (8 paths, the cell's
    # config), bit for bit with the plain planes, then timed
    c8 = cfg_sgm.replace(sgm_paths=8)
    S_k = sgm_kernel.aggregate(vol_k, c8)
    times["wta 1242x375 D=128"] = wta_times(card, "wta kitti_sgm 1242x375 D=128", S_k, c8)
    del S_k

    # SGM's long-D path at middeval3_h_sgm's shape, bit for bit, then timed
    times["SGM middeval3_h_sgm 8 paths"] = middeval3_times(card, dev, mid)
    times["wta 1440x994 D=256"] = times["SGM middeval3_h_sgm 8 paths"].pop("wta")
    del mid

    # ---- 7. the entry points: serve, CLI, sweep -------------------------
    entry_points(card, dev, reset, launched)

    # ---- 8. the sharded layouts -----------------------------------------
    sharded = sharded_phase(card, dev, reset, launched)

    # ---- 9. one pair's tile axis across processes -----------------------
    tile_processes_phase(card, sharded)

    # ---- 10. the accuracy and validation tools --------------------------
    tools_phase(card, kernels)

    # ---- 11. the serving and timing tools -------------------------------
    timing_phase(card, dev, kernels)

    def row(name, source, replaces, launches, err, geo, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, **times[geo],
                "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        row("asw_wta", "aswstereomatch_torch/ops/cuda/asw_kernel.cu",
            "aswstereomatch_tpu/ops/pallas/asw_kernel.py:166", main_launches,
            max_abs_err, "K1 450x375", kitti=times["K1 1242x375"],
            box=times["K1 box 384x288"], sharded=sharded),
        row("asw_sep_wta", "aswstereomatch_torch/ops/cuda/asw_sep_kernel.cu",
            "aswstereomatch_tpu/ops/pallas/asw_sep_dlanes.py:192", sep_launches,
            sep_err, "K2 kitti_sep 1242x375", seplo=times["K2 kitti_seplo 1242x375"]),
        row("asw_dlanes_wta", "aswstereomatch_torch/ops/cuda/asw_dlanes_kernel.cu",
            "aswstereomatch_tpu/ops/pallas/asw_dlanes.py:223", dl_launches,
            dl_err, "K3 left-only 1242x375", box=times["K3 box 1242x375"]),
        row("asw_sym_dlanes_wta", "aswstereomatch_torch/ops/cuda/asw_sym_dlanes_kernel.cu",
            "aswstereomatch_tpu/ops/pallas/asw_sym_dlanes.py:122", sdl_launches,
            sdl_err, "K4 1242x375", middlebury=times["K4 450x375"]),
        row("sgm_aggregate", "aswstereomatch_torch/ops/cuda/sgm_kernel.cu",
            "aswstereomatch_tpu/ops/aggregate.py:335", sgm_launches, sgm_err,
            "SGM kitti_sgm 4 paths", eight_paths=times["SGM kitti_sgm 8 paths"],
            long_d=times["SGM middeval3_h_sgm 8 paths"]),
        row("channel_stacks", "aswstereomatch_torch/ops/cuda/stacks_kernel.cu",
            "none: XLA fuses aswstereomatch_tpu/ops/preprocess.py::channel_stack", stack_launches,
            0.0, "stacks 1242x375 D=128", middlebury=times["stacks 450x375 D=64"]),
        row("cost_volume", "aswstereomatch_torch/ops/cuda/cost_kernel.cu",
            "none: XLA fuses aswstereomatch_tpu/ops/cost.py::cost_volume", cost_launches,
            0.0, "cost 1242x375 D=128", middlebury=times["cost 450x375 D=64"]),
        row("disparity_map", "aswstereomatch_torch/ops/cuda/disparity_kernel.cu",
            "none: XLA fuses aswstereomatch_tpu/models/pipeline.py::_disp_pre_from_wta "
            "and the median", map_launches, 0.0, "disparity 1242x375 D=128",
            middlebury=times["disparity 450x375 D=64"]),
        row("wta_planes", "aswstereomatch_torch/ops/cuda/wta_kernel.cu",
            "none: XLA fuses aswstereomatch_tpu/ops/wta.py and postprocess.right_volume",
            wta_launches, 0.0, "wta 1242x375 D=128", middeval3=times["wta 1440x994 D=256"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tile-worker"]:
        rank, nproc, port = (int(a) for a in sys.argv[2:5])
        sys.exit(tile_worker(rank, nproc, port, *sys.argv[5:7]))
    sys.exit(main())
