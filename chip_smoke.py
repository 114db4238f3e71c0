#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Dalorex engine, of granite-3-2b,
rwkv6-1.6b and zamba2-2.7b serving and of granite-3-2b training on one
GPU.

    python3 chip_smoke.py \
        [--phases kernels,twin,main,hbm,noc,place,taskgraph,block,rmat18,
                  serve,spmd,lm,rwkv,zamba,train] [--seed 0]

Phases, in order; any failed check raises and the script exits non-zero:

1. device and build — the card's name and power limit (nvidia-smi), and
   the build of the eight kernel sources (``src/repro_torch/kernels/
   {engine,scatter_update,spmv,flash_attention,rwkv6,mamba2}/csrc/*.cu``;
   one nvcc each, sm_90a, all started together), and the tensor-core
   instructions (HGMMA) in each instance of the built flash library, by
   ``cuobjdump -sass`` (each bfloat16 instance must have some);
2. ``kernels`` — each of the eight standalone kernels against its plain
   PyTorch version on the same CUDA tensors, at the main paths' shapes
   plus the edge cases of the CPU sweeps: bitwise equal on every output
   element, except ``queue_push_pop``, whose turned queue is compared
   below its count (``turn_contract``: the kernel keeps live rows only),
   the T2 scans, whose ``nb`` and ``w`` are compared where ``jvalid``
   holds (``scan_contract``: the kernel writes live lanes only), and
   ``spmv_block_ell``, whose sums run in another order
   (``rtol = atol = 1e-4``; two of its calls bitwise equal; timed beside
   cuSPARSE's CSR product and, where PyTorch takes it, a BSR tensor of the
   same blocks).  Prints each kernel's time (CUDA events,
   median of 25 launches with the L2 cache flushed before each, behind a
   device spin that hides the wrapper's host dispatch), its
   plain version's time, its bound (bytes moved over 3.35 TB/s;
   ``queue_push_pop``: its live rows, the scans their live lanes, with
   the whole bound and the live share beside it) and, where one PyTorch call computes the same
   function, that call's time;
3. ``twin`` — R-MAT scale 10 over 16 tiles, ``backend="torch"`` against
   ``backend="kernels"``: values and Stats bitwise equal (but
   ``launches``), and equal to (or within the reference's tolerance of)
   the oracle, for BFS (async and BSP), SSSP, WCC, SpMV, PageRank,
   k-core (k = 2, 5; async and BSP) and triangles, unfused
   (``fuse=False``); then every one of them with ``fuse=True`` (each leg
   one kernel: 3 calls a round, 5 for triangles; every leg call also held
   against its plain stage by the legs' contract, ``fused.contract``:
   bitwise below each queue's count and on the valid message rows, the
   popped rows past the pop 0 in the kernel's; with the edge cases: empty
   frontier, a leg 0 that pops nothing, a cap-0 update queue, spills on
   every channel, the four of triangles included), k-core also with the
   edge shard streamed, and BFS, SSSP and SpMV with the edge shard
   streamed (``edge_space="hbm"``), unfused and fused; then 9
   configurations past the kernels' shared-memory staging (T = 257,
   pops of 512, 16,640 fresh rows, windows of 4,096, and stagings in the
   device scratch: 65,536 frontier pops, 16,384 popped ranges), fused and
   unfused, with the path each kernel took; every unfused scan call held
   against its plain version (``scan_contract``); then the physical NoCs
   on R-MAT-FABRIC_SCALE over 16 tiles (a 4 x 4 grid): BFS on the mesh,
   torus, ruche (factor 2), hier 2 x 2 (mesh base, ``low_order_dielocal``) and
   hier 2 x 1 (torus base) at ``link_cap=1``, "torch" against "kernels"
   unfused and fused (values and Stats bitwise but ``launches``, values
   equal to the oracle, no drops; the fused legs, whose spills are the X
   leg's N rows and the Y leg's T * capacity rows at the waypoint, held
   against their plain stages at the FusedCheck's rounds), SSSP and
   PageRank (FABRIC_PR_ITERS epochs) on the torus and hier 2 x 2 at
   ``link_cap=2`` fused, the flight recorder on against off (bitwise,
   launches included), and the die-local criterion of
   ``tests/test_hier.py`` (fewer DIE-class flits than the flat placement
   on uncapped hier 2 x 2 links);
4. ``main`` — the main paths over R-MAT-22 (edge factor 10, seed 1) on 64
   tiles, fused, the partition built once: one BFS query from vertex 0
   (the highest out-degree) with ``EngineConfig(cap_updq=262144)``, hop
   counts equal to the oracle; then one SpMV ``y[dst] += val * x[src]``
   with ``EngineConfig(cap_updq=SPMV_CAP_UPDQ)``, every update applied
   once and within the reference's tolerance plus the float32 error
   limit of the oracle (``spmv_f32_bound``, which a planted lost or
   doubled hub term must exceed).  Each: no drops, three kernel calls a
   round, each leg kernel launched once a round (counts read just after
   the path).  Then short runs of the same paths (and BFS in BSP mode)
   whose fused legs are held against their plain stages at the main
   shapes and timed (bound, the whole-queue bound of the earlier design,
   the live share of a turned queue, plain time; no library call computes
   a leg);
5. ``hbm`` (with ``main``) — fused BFS on the same partition with the
   edge shard streamed and the tile budget at 4 MiB, under the resident
   footprint: ``edge_space="vmem"`` must fail validation; HBM_ROUNDS
   rounds (a depth cut) whose values, rounds, msgs, spills, edges,
   updates, drops and link flits equal a resident fused run's of the
   same depth; ``hbm_windows > 0``; then ``edge_scan_stream`` checked and
   timed at the shard and messages of its leg 1 in round
   ``HBM_SCAN_ROUND``;
6. ``noc`` — the rmat-hier preset's fabric and placement on 64 tiles:
   hier, an 8 x 8 grid as 2 x 2 dies of 4 x 4 meshes,
   ``low_order_dielocal`` (edge mode ``die_aligned``).  (a) Fused BFS
   from vertex 0 on R-MAT-NOC_SCALE with the queues NOC_CAPS on uncapped
   links and the flight recorder on (every round, a ring of 65,536; the
   main path's R-MAT-22 loses messages under this placement at its
   queues, ROADMAP.md §3): hop counts equal to the oracle, no drops, each
   fused leg once a
   round (counts read just after the path), the ring unwrapped and its
   cycle timeline bitwise ``Stats.cycles``, its summed link-class and
   message series equal to ``flits_per_link`` per class and
   ``Stats.msgs``, ``die_crossings.sum() == hop_histogram.sum()``;
   rounds, wall ms a round, the DIE-class flit share, peak device memory,
   and device ms a round over a profiled window (the routes' share
   beside it), with the ideal crossbar's on the same partition.  (b) The
   main path's R-MAT-22 under the same placement and fabric at
   ``link_cap=1`` with its queues (a tile budget of NOC_VMEM_LIMIT for
   the die-aligned shard) for NOC_STRESS_ROUNDS rounds, "torch" against
   "kernels" fused: values, Stats and trace rings bitwise but
   ``launches``, link occupancy at most ``link_cap`` times the two route
   legs, equal drops; round NOC_CHECK_ROUND's fused legs held against
   their plain stages and timed;
6b. ``place`` — adaptive placement (``repro_torch.place``), the rungs of
   ``benchmarks/fig15_adaptive.py`` at noc (a)'s configuration (noc's
   runs are reused, or run here when phase noc is not selected).  (a)
   Between queries: a plan from (a)'s ring within PLACE_BUDGET (V // 8),
   applied on the card, BFS from the same root again: values bitwise the
   unmigrated run's and the oracle's, no drops, three launches a round,
   the move priced into Stats (``migrated_vertices`` and
   ``migration_cycles`` > 0, ``energy_pj`` within 1e-5 of the host
   oracle ``energy_from_totals``); printed: pairs by reason, DIE-class
   flits and the hottest tile's busy share before and after, the host ms
   of the plan and of ``apply_plan``, rounds, wall and device ms a round.
   (b) Epoch boundaries: ``adaptive_pagerank`` over PLACE_PR_EPOCHS
   epochs, a plan every PLACE_PR_EVERY, against ``pagerank`` on
   R-MAT-PLACE_PR_SCALE: within rtol 1e-6, atol 1e-12, a plan applied,
   edges, updates and delivered updates equal.  (c) The twin on
   R-MAT-PLACE_TWIN_SCALE over 16 tiles: "torch" against "kernels" fused
   (every leg call against its plain stage) and unfused (every scan
   call), bitwise (values, Stats but launches, plans) for BFS on a
   partition migrated by its own ring's plan, the dyadic adaptive
   PageRank and static serving with a plan after every batch (each query
   bitwise its solo run on the starting partition).  (d) The planner and
   ``apply_plan`` on noc (b)'s R-MAT-22 partition and ring at budget
   PLACE_MAIN_BUDGET: host seconds of each step, the old and new
   ``e_chunk``, ``Program.validate``'s verdict at NOC_VMEM_LIMIT;
7. ``taskgraph`` — the fused task-graph programs on 64 tiles: k-core
   (k = 16) on symmetrized R-MAT-20 (edge factor 10, seed 1), equal to
   ``kcore_ref``, and triangle counting on ``prepare_triangles`` of
   symmetrized R-MAT-TRI_SCALE, equal to ``triangles_wedge_ref`` (the
   vectorized ``triangles_ref``; both under ``key=pg.place``).  Each: no
   drops, each leg kernel launched once a round (3 and 5 a round); then
   short runs whose legs are held bitwise against their plain stages at
   selected rounds and timed;
8. ``block`` — R-MAT-14: ``spmv_block_ell`` (b = 128) on A[dst, src] =
   val against the dense oracle and the engine's SpMV at T = 16, and the
   same product as binned ``scatter_segments`` rounds (add, and a min),
   bitwise equal to numpy's serial ``np.add.at`` / ``np.minimum.at``,
   and its min on NaNs and signed zeros bitwise ``binned_scatter``;
9. ``rmat18`` — R-MAT-18 over 64 tiles: the unfused paths
   (``fuse=False``: BFS, BFS with the shard streamed through
   ``edge_scan_stream``, SpMV, PageRank; five kernel calls a round)
   against the oracles; PageRank runs 3 iterations (the depth is cut from
   the reference's 20 for chip time only); the two ``queue_push_pop``
   turns and the scan of BFS round ``R18_TURN_ROUND``, and the scan of
   the streamed BFS's, are held against their plain versions and timed
   at the operands the engine gave them;
9b. ``serve`` — query lanes (``repro_torch.serve``).  (a) A static batch
   of SERVE_B BFS queries on R-MAT-SERVE_SCALE (64 tiles, ``MAIN_FUSED``;
   cut from the main path's R-MAT-22): MAIN_ROOT, SERVE_RANDOM sources
   drawn from ``--seed``, MAIN_ROOT again and a padding lane.  Lane 0
   bitwise a solo run from MAIN_ROOT on the same partition
   (values and every Stats field, launches included), the two
   MAIN_ROOT lanes bitwise each other, every lane equal to the oracle, no
   drops, the padding lane born finished, ``total_rounds`` the largest
   lane count, each fused leg launched once a shared round for the whole
   batch; queries/s, wall and device ms a shared round beside the solo
   run's, peak memory; the legs held against their plain stages over
   the first SERVE_CHECK_ROUNDS rounds and timed at B = SERVE_B.  (b)
   The continuous front end on R-MAT-SERVE_CONT_SCALE (cut), Poisson
   arrivals, the trace on: every record equal to its oracle and to its
   solo run (rounds, edges, values, ring bitwise), no drops.  (c) B = 3
   lanes on R-MAT-10 (the mesh runs on R-MAT-FABRIC_SCALE) over 16 tiles:
   "torch" against "kernels", fused (every leg call against its plain
   stage) and unfused (every scan call), ideal and mesh at link_cap 2,
   BFS and SSSP, and BFS streamed; values and lane-led Stats bitwise but
   launches.  Then both scans at SERVE_B lanes of the R-MAT-22 shard,
   checked and timed;
9c. ``spmd`` — SPMD on ``torch.distributed`` (``core/comm.py``
   ``AxisComm``, one tile a process).  (a) The tile base of fused leg 0:
   its operands at SPMD_TILE_CALLS calls of BFS and of a 3-lane batch on
   R-MAT-SPMD_TWIN_SCALE and of triangles on symmetrized
   R-MAT-SPMD_TRI_SCALE, over SPMD_TWIN_T tiles; the leg launched on all
   rows, then on each tile's rows alone over its shard row with ``tile0``
   the tile (as AxisComm and LaneAxisComm launch it): each one-tile launch
   bitwise those rows of the launch on all rows (the legs' contract) and
   equal to its plain stage.  (b) World size 1 over NCCL (a file store;
   one card, and NCCL takes one GPU a rank): fused BFS and SPMD_LANES
   serving lanes on R-MAT-SPMD_SCALE at T = 1 through ``mesh=`` an
   ``auto_mesh((1,), ("x",))``, bitwise the LocalComm runs at T = 1
   (values, Stats but launches; the lanes' batch clock) and the oracle,
   each fused leg once a round; each SPMD run again with its fused legs
   held against their plain stages at those one-row shapes (FusedCheck);
   wall ms a round, and device ms, NCCL kernel ms, kernels and PyTorch
   operators a round over a profiled window, beside the LocalComm run's;
10. ``lm`` — granite-3-2b serving at full width and all 40 layers.  The
   flash kernel against its plain version (K/V repeated, blockwise scan)
   at granite's bfloat16 prefill shape (B 4, S 2048, 32 / 8 heads of 64)
   and the reference's sweep plus G = 4, hd 32 / 128, one-tile and ragged
   S (100, and 200: one 200-row block of the reference's prefill), window
   128 and float32 at granite's shape, and the bfloat16 body's edge cases
   (S = 8, 64, 100, 200; windows 64 and 128 at G = 1, 4, 8; hd 32, 64,
   128; a row with no live key in a computed kv tile) (2e-5 float32, 2e-2
   bfloat16), timed with SDPA as the library yardstick (timed only; the
   port never calls it) and the float32 body at the same shape; bfloat16
   projections held to the float32 product
   (float32 accumulation).  Then, with random weights from a seed made on
   the card, 4 prompts of 2048 random tokens: ``prefill`` and 16 greedy
   ``serve_step``s with the kernel against the same path with
   ``use_kernels=False``, in float32 (layer 0's K/V bitwise equal, last
   hidden within 1e-3, greedy tokens equal where the plain top-2 logit
   gap > 1e-2, position, finiteness) and in bfloat16 (finite, tokens in
   the vocabulary, last hidden within ``BF16_REL_L2`` of the plain run).
   The kernel launches once a layer in prefill (40) and never in decode,
   the plain path never (counts read just after each path).  A float32
   prompt of 200 tokens prefills on the kernel and matches the plain
   path; one of 600 (600 % 512 != 0) is refused on both paths, as the
   reference's prefill refuses it;
11. ``rwkv`` — rwkv6-1.6b serving at full width and all 24 layers.  The
   WKV6 kernel against its plain version (``wkv6_chunked`` at the same
   chunk; y and the final state within ``WKV_REL_TOL`` of their largest
   magnitude) and against the step-by-step scan oracle (the reference's
   3e-4) on the reference's sweep, a state carried across two calls, a
   non-zero state0, S = 8 (one chunk of 8), every decay at -4 and at
   -1e-6, and the prefill shape (B 4, S 2048, 32 heads of 64), timed at
   the latter (no single PyTorch call computes WKV6: no library time).
   Then, with random weights from a seed made on the card, 4 prompts of
   2048 random tokens: ``prefill`` and 16 greedy ``serve_step``s with the
   kernel against ``use_kernels=False``, in float32 with the decay, bonus
   and token-shift leaves drawn from a seed (layer 0's token-shift carry
   bitwise equal, its WKV state within ``WKV_REL_TOL`` and the last hidden
   within ``RWKV_F32_TOL`` of their largest magnitude, greedy tokens as in
   ``lm``, position, finiteness) and in bfloat16 at the reference's init
   (finite, tokens in the vocabulary, last hidden within
   ``RWKV_BF16_REL_L2`` of the plain run).  The kernel launches once a
   layer in prefill (24) and never in decode, the plain path never;
12. ``zamba`` — zamba2-2.7b serving at full width and all 54 layers (9
   superblocks: the shared attention block, then 6 Mamba2 layers).  The
   SSD kernel against its plain version (``ssd_chunked`` at the same
   chunk; y and the final state within ``SSD_REL_TOL`` of their largest
   magnitude, every output finite) and against the step-by-step scan
   oracle (the reference's 3e-4) on the reference's sweep, a non-zero
   state0, a state carried across two calls, S = 16 (one chunk), every dt
   at the clip, dt -> 0, chunk 32 with an upper triangle that overflows
   float32, ragged tiles (chunks of 1, 5, 8 and 24 steps, S = 8 < chunk),
   and the prefill shape (B 4, S 2048, 80 heads, P 64, N 64), timed at the
   latter (no PyTorch call computes SSD: no library time; bound: bytes, or
   the products in 3xTF32 on the tensor cores plus the rest in float32,
   with the all-float32 bound beside it); every instance of the built
   SSD library must hold HMMA (tensor-core) instructions
   (``cuobjdump -sass``).
   The flash kernel at hd 80 against its plain version in float32 and
   bfloat16 (S = 8, 200, 208, 256, 512; windows 64, 128 and 4096),
   timed at zamba2's prefill shape (B 4, S 2048, 32 / 32 heads) with SDPA
   as the yardstick.  Then, with random weights from a seed made
   on the card, 4 prompts of 2048 random tokens: ``prefill`` and 16 greedy
   ``serve_step``s with the kernels against ``use_kernels=False``, in
   float32 with ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b`` drawn
   from a seed (superblock 0's K/V bitwise equal; the first Mamba2 layer's
   conv carry and SSD state and the last hidden within ``ZAMBA_F32_TOL``
   of their largest magnitude; greedy tokens as in ``lm``; position;
   finiteness) and in bfloat16 at the reference's init (finite, tokens in
   the vocabulary, last hidden within ``ZAMBA_BF16_REL_L2`` of the plain
   run).  The SSD kernel launches once a Mamba2 layer in prefill (54) and
   the flash kernel once a superblock (9), neither in decode, the plain
   path neither.  A 208-token prompt prefills on the kernels and matches
   the plain path; a 200-token one (200 % 16 != 0) is refused on both
   paths, as the reference's ``ssd_chunked`` asserts;
13. ``train`` — granite-3-2b training at full width and all 40 layers,
   random weights from a seed, B 4 sequences of 2048 tokens from the
   seeded Markov source (``--seed``), remat on.  (a) The flash backward
   kernel (``flash_attention_bwd.cu``) against its plain version
   (autograd through ``repeat_kv_attention``; dq, dk, dv within
   FLASH_BWD_TOL of its largest magnitude) and the training forward's
   logsumexp against ``attention_lse``, on FLASH_BWD_SWEEP (granite's
   shape in float32, S = 200, window 128, G = 1 and 4, hd 32, 80 and 128)
   and granite's bfloat16 shape, timed there beside SDPA's backward
   (forward plus backward less forward; timed only).  (b) One whole-model
   step at TRAIN_TWIN_LAYERS layers, forward, remat and backward, the
   kernel path against ``use_kernels=False`` from the same weights (the
   reference's draws scaled to a fan-in init) and batch, float32 (loss,
   global gradient norm, every leaf within TRAIN_LOSS_RTOL,
   TRAIN_GNORM_RTOL, TRAIN_LEAF_REL) and bfloat16 (loss and norm; every
   leaf of both paths within TRAIN_BF16_LEAF_REL of the float32
   gradient at the same weights); the kernels launch twice a layer
   forward (forward and remat) and once backward, the plain path never.
   (c) TRAIN_STEPS timed steps of ``make_train_step`` at all 40 layers
   (bf16 parameters, AdamW with a float32 master): step ms, tokens/s,
   launches a step, peak memory.  (d) ``train`` at TRAIN_RESUME_LAYERS
   layers (a depth cut: a 40-layer checkpoint is ~37 GB of disk), 4 steps
   against 2, a checkpoint, a restart and 2 more: bitwise.

The last lines are the script's wall time, the kernels' JSON record, the
nvidia-smi line, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or away from the repository, the script fails before printing
any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.graph import CSRGraph, rmat_edges  # noqa: E402
from repro_torch.core import reference as ref  # noqa: E402
from repro_torch.kernels import scatter_update as SEG  # noqa: E402
from repro_torch.kernels import spmv as SPMV  # noqa: E402
from repro_torch.kernels.engine import fused as F  # noqa: E402
from repro_torch.kernels.engine import kernel as K  # noqa: E402
from repro_torch.core.program import BFS, as_program  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.cuda_build import cuda_tool  # noqa: E402
from repro_torch.kernels import mamba2 as SSD  # noqa: E402
from repro_torch.kernels import rwkv6 as W6  # noqa: E402
from repro_torch.models import layers as LMLAYERS  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402
from repro_torch.parallel.sharding import ParamSpec, tree_map  # noqa: E402
from repro_torch import trace as TR  # noqa: E402
from repro_torch.core.comm import LocalComm  # noqa: E402
from repro_torch.noc import make_network  # noqa: E402
from repro_torch.noc.topology import CLASS_DIE, N_LINK_CLASSES  # noqa: E402
from repro_torch import serve as SERVE  # noqa: E402
from repro_torch import place as PL  # noqa: E402
from repro_torch.perf import model as PM  # noqa: E402
from repro_torch.checkpoint import store as CKPT  # noqa: E402
from repro_torch.data.pipeline import make_source  # noqa: E402
from repro_torch.optim import adamw as ADAMW  # noqa: E402
from repro_torch.runtime import trainer as TRAINER  # noqa: E402
from tools.bf16_grad_readings import (leaf_names,  # noqa: E402
                                      rescale_to_fan_in)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
ENGINE_SRC = "src/repro_torch/kernels/engine/csrc/engine_kernels.cu"
FUSED_SRC = "src/repro_torch/kernels/engine/csrc/fused_legs.cu"
TPU_KERNEL = "src/repro/kernels/engine/kernel.py"
# name: (source, TPU kernel it replaces)
KERNEL_ROWS = {
    "frontier_pop": (ENGINE_SRC, f"{TPU_KERNEL}:371"),
    "queue_push_pop": (ENGINE_SRC, f"{TPU_KERNEL}:417"),
    "edge_scan_gather": (ENGINE_SRC, f"{TPU_KERNEL}:473"),
    "edge_scan_stream": (ENGINE_SRC, f"{TPU_KERNEL}:519"),
    "fold_scatter": (ENGINE_SRC, f"{TPU_KERNEL}:557"),
    "fold_scatter_add": (ENGINE_SRC, f"{TPU_KERNEL}:557"),
    **{k.__name__: (FUSED_SRC, f"{TPU_KERNEL}:241") for k in F.KERNELS},
    "scatter_segments": (
        "src/repro_torch/kernels/scatter_update/csrc/scatter_segments.cu",
        "src/repro/kernels/scatter_update/kernel.py:47"),
    "spmv_block_ell": (
        "src/repro_torch/kernels/spmv/csrc/spmv_block_ell.cu",
        "src/repro/kernels/spmv/kernel.py:42"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:72"),
    "wkv6_kernel": ("src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
                    "src/repro/kernels/rwkv6/kernel.py:59"),
    "ssd_kernel": ("src/repro_torch/kernels/mamba2/csrc/ssd.cu",
                   "src/repro/kernels/mamba2/kernel.py:55"),
    # no TPU kernel: the reference differentiates blockwise_attention
    "flash_attention_bwd": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        "src/repro/models/layers.py:57"),
}
ALL_WRAPPERS = (*K.KERNELS, *F.KERNELS, SEG.scatter_segments,
                SPMV.spmv_block_ell, FA.flash_attention, W6.wkv6_kernel,
                SSD.ssd_kernel, FA.flash_attention_bwd)

# Main path: R-MAT-22 over T=64 tiles (v_chunk, e_chunk of its partition).
# The update (spill) queue holds 262144 entries: its one-round burst bound
# (EngineConfig.min_caps, 32832 here, rounded up to 65536) drops updates on
# this graph, because tiles whose updates converge on a few hot owners keep
# spilling faster than the 64-entry replay drains; this run's peak
# occupancy is 169369 entries (PERF.md).
MAIN_SCALE, MAIN_T, MAIN_ROOT = 22, 64, 0
MAIN_V_CHUNK, MAIN_E_CHUNK = 65536, 642283
MAIN_CFG = EngineConfig(cap_updq=262144)
# SpMV on the same partition starts with every vertex that has out-edges
# in the frontier, so its update burst is larger: the update queue is the
# smallest power of two above 4/3 of the peak occupancy that
# tools/port_round_profile.py --app spmv measured with the queue at the
# tile budget's largest admissible size (PERF.md), so the TSU's throttle
# keeps its quarter of headroom.
SPMV_CAP_UPDQ = 131072
SPMV_CFG = EngineConfig(cap_updq=SPMV_CAP_UPDQ)
SPMV_SEED, SPMV_SOURCES = 0, 1750061  # x's seed; vertices with out-edges
# The fused main paths (fuse=True is the default): each leg one kernel.
MAIN_FUSED = dataclasses.replace(MAIN_CFG, fuse=True)
SPMV_FUSED = dataclasses.replace(SPMV_CFG, fuse=True)
# The streamed-shard phase: fused BFS on the main partition with the tile's
# scratchpad budget cut under the resident footprint (8,439,640 B a tile,
# 5,138,264 of it the edge shard), so only edge_space="hbm" validates.
HBM_VMEM_LIMIT = 4 * 2 ** 20
HBM_CFG = dataclasses.replace(MAIN_FUSED, edge_space="hbm",
                              vmem_limit_bytes=HBM_VMEM_LIMIT)
# Rounds of the main-shape runs whose fused legs are held against their
# plain versions (not counted; long enough for spills on both channels and
# the update queue's growth).
CHECK_ROUNDS = {"BFS": 1500, "SpMV": 800, "BFS-BSP": 200, "BFS-hbm": 300}
# The phase on the PageRank partition drives the unfused paths.
UNFUSED = dict(fuse=False)
R18_CFGS = {"BFS": dataclasses.replace(MAIN_CFG, **UNFUSED),
            "SpMV": dataclasses.replace(SPMV_CFG, **UNFUSED),
            "BFS-hbm": dataclasses.replace(MAIN_CFG, edge_space="hbm",
                                           **UNFUSED)}
# The task-graph programs over the main path's 64 tiles.  k-core: k = 16
# on symmetrized R-MAT-20 (V = 1,048,576, E = 19,967,950 directed edges;
# a serial peel takes 3 epochs and 1,761,883 decrements and leaves a core
# of 137,224), with the BFS main path's update queue (its spill traffic
# also converges on hub owners).  Triangles: prepare_triangles of
# symmetrized R-MAT-TRI_SCALE, queues sized by sized_cfg.  Both scales
# are cut for the script's time, not for memory (PERF.md §4).
KCORE_SCALE, KCORE_K = 20, 16
KCORE_V, KCORE_E, KCORE_CORE = 1048576, 19967950, 137224
KCORE_CFG = MAIN_CFG
TRI_SCALE = 12
TRI_CFG = EngineConfig()
CHECK_ROUNDS.update({"k-core": 400, "triangles": 300})
# The physical NoCs.  Twin: BFS on each fabric over 16 tiles (a 4 x 4
# grid) at link_cap 1, its placement beside it (hier 2x2 with the
# die-local one); SSSP and PageRank (FABRIC_PR_ITERS epochs) on the torus
# and hier 2x2 at link_cap 2; the trace on against off on TRACE_TWIN.  A
# link-bound run takes a round for every few messages (BFS on the twin's
# R-MAT-10 at link_cap 1: 1,892-3,555 rounds, and the fabric runs took
# 755 s of the card's time; on R-MAT-8 378-662 rounds and ~140 s), so
# they run on R-MAT-FABRIC_SCALE (63-125 rounds; both channels still
# spill on the fabrics together, and the die-local criterion holds): cut
# for the script's time (PERF.md §4).  Their fused legs are held against
# their plain stages every FABRIC_CHECK_PERIOD-th round and at the
# FusedCheck's other rounds.
TWIN_FABRICS = {
    "mesh": (dict(noc="mesh"), "low_order"),
    "torus": (dict(noc="torus"), "low_order"),
    "ruche": (dict(noc="ruche", ruche_factor=2), "low_order"),
    "hier 2x2": (dict(noc="hier", ndies_y=2, ndies_x=2),
                 "low_order_dielocal"),
    "hier 2x1 torus": (dict(noc="hier", ndies_y=2, ndies_x=1,
                            hier_base="torus"), "low_order"),
}
FABRIC_SCALE, FABRIC_CHECK_PERIOD, FABRIC_PR_ITERS = 6, 100, 2
TRACE_TWIN = "hier 2x2"
# Phase noc: the rmat-hier preset's fabric and placement
# (src/repro/configs/dalorex_graph.py): an 8 x 8 grid as 2 x 2 dies of 4 x
# 4 meshes, die-local placement.  (a) BFS to the end on uncapped links
# with the flight recorder on (a ring long enough for every round), on
# R-MAT-NOC_SCALE with queues that hold its spills: on R-MAT-22 this
# placement loses messages at the main path's queues on every fabric
# (412,613 on the ideal crossbar; on hier 5,137,856 by round 40,000, not
# done), and with queues that hold them its hier run outlasts the script
# (ROADMAP.md §3, PERF.md §4).  R-MAT-18 needs a range queue of 7,496 and
# an update queue of 258,559 (peaks of the run at NOC_CAPS); the run is on
# R-MAT-16 since the serving phase came (cut for the script's time, PERF.md
# §4), with the same queues.  (b) The main
# path's R-MAT-22 partition under the same placement at link_cap 1, its
# queues the main path's, for NOC_STRESS_ROUNDS rounds.  The die-aligned
# edge layout gives each run of same-die tiles its own vertices' edges:
# on R-MAT-22 the die of the low ids (the hubs) holds most of them,
# e_chunk is 3,374,734 against the flat layout's 642,283, and the
# resident shard (27.0 MB a tile) passes the modelled tile's 16 MiB, so
# (b)'s tile budget is NOC_VMEM_LIMIT.
NOC_SCALE, NOC_PLACEMENT, NOC_DIES = 16, "low_order_dielocal", (2, 2)
NOC_FABRIC = dict(noc="hier", ndies_y=2, ndies_x=2, hier_base="mesh")
NOC_CAPS = dict(cap_rangeq=65536, cap_updq=524288)
NOC_CFG = EngineConfig(link_cap=0, trace=True, trace_every=1,
                       trace_rounds=65536, **NOC_FABRIC, **NOC_CAPS)
NOC_VMEM_LIMIT = 32 * 2 ** 20
NOC_STRESS_ROUNDS, NOC_CHECK_ROUND = 200, 100
NOC_STRESS = dataclasses.replace(
    MAIN_FUSED, link_cap=1, vmem_limit_bytes=NOC_VMEM_LIMIT, trace=True,
    trace_rounds=NOC_STRESS_ROUNDS, max_rounds=NOC_STRESS_ROUNDS,
    **NOC_FABRIC)
# the profiled window of (a), and of the ideal crossbar on its partition
NOC_PROFILE_AT, NOC_PROFILE_ROUNDS = 300, 20
# Phase serve: query lanes.  (a) A static batch of SERVE_B BFS queries on
# R-MAT-SERVE_SCALE (T = 64, MAIN_FUSED): MAIN_ROOT, SERVE_RANDOM sources
# drawn from --seed among the vertices with out-edges, MAIN_ROOT again and
# a padding lane, beside a solo run from MAIN_ROOT; its fused legs held
# against their plain stages and timed over its first SERVE_CHECK_ROUNDS
# rounds, and its device time over SERVE_PROFILE_ROUNDS rounds from
# SERVE_PROFILE_AT.  Cut from the main path's R-MAT-22 (20,545
# shared rounds, ~200-290 s) for the script's time: with phase spmd the
# script took 1,091-1,240 s on slow hosts against the 1,200 s it must keep.
# (b) The continuous front end on R-MAT-SERVE_CONT_SCALE (cut from
# R-MAT-22, and one step below R-MAT-18, for the script's time: its 12
# solo runs, trace on, are checked, and R-MAT-18 took the script past
# 1,200 s on a slow host): SERVE_CONT_QUERIES queries through
# SERVE_CONT_WIDTH lanes, Poisson arrivals SERVE_CONT_GAP modelled cycles
# apart, the trace on (a ring that holds every round of a query).  (c)
# The twin on R-MAT-10 over 16 tiles, B = 3 (two sources and a padding
# lane): "torch" against "kernels", fused and unfused, ideal and mesh at
# link_cap 2, BFS and SSSP; and BFS with the shard streamed, unfused.  The
# mesh runs take R-MAT-FABRIC_SCALE, as the twin's fabric runs do (a
# capped link takes a round for every few messages): cut for the
# script's time.
SERVE_SCALE, SERVE_B, SERVE_RANDOM = 20, 8, 5
SERVE_CHECK_ROUNDS = 300
SERVE_PROFILE_AT, SERVE_PROFILE_ROUNDS = 300, 20
SERVE_CONT_SCALE, SERVE_CONT_QUERIES, SERVE_CONT_WIDTH = 17, 12, 4
SERVE_CONT_GAP = 2e4
SERVE_CONT_CFG = dataclasses.replace(MAIN_FUSED, trace=True,
                                     trace_rounds=8192)
SERVE_TWIN_SCALE, SERVE_TWIN_T = 10, 16
SERVE_TWIN_FABRICS = {"ideal": (SERVE_TWIN_SCALE, {}),
                      "mesh": (FABRIC_SCALE, dict(noc="mesh", link_cap=2))}
# the lane-axis scans timed at SERVE_B lanes of the R-MAT-22 shard
SERVE_SCAN_R = MAIN_T * MAIN_CFG.cap_route_range
# Phase place: adaptive placement (repro_torch.place) at noc (a)'s
# configuration, the rungs of benchmarks/fig15_adaptive.py.  (a) Between
# queries: noc (a)'s traced BFS is the observation and the unmigrated
# twin; a plan from its ring within fig15's default budget (V // 8),
# applied, BFS from the same root again, the move priced.  (b) Epoch
# boundaries: adaptive_pagerank over PLACE_PR_EPOCHS epochs, a plan every
# PLACE_PR_EVERY, against plain pagerank over the same epochs, under (a)'s
# fabric and placement on R-MAT-PLACE_PR_SCALE: cut from (a)'s R-MAT-16
# for the script's time (the two runs took 59.4 s there, PERF.md §4).
# (c) The twin on R-MAT-PLACE_TWIN_SCALE over PLACE_TWIN_T tiles, hier 2
# x 2, die-local: "torch" against "kernels", fused and unfused, through a
# migration (BFS; the dyadic adaptive PageRank of tests/test_place.py,
# budget PLACE_TWIN_BUDGET; static serving of PLACE_SERVE_SOURCES sources
# through PLACE_SERVE_WIDTH lanes).  (d) The
# planner and migrator at full size: noc (b)'s R-MAT-22 partition and
# its ring, the rmat-hier-adapt preset's budget, host side only (at the
# main queues this placement drops messages on R-MAT-22, ROADMAP.md §3).
PLACE_BUDGET = (1 << NOC_SCALE) // 8
PLACE_PR_SCALE, PLACE_PR_EPOCHS, PLACE_PR_EVERY = 14, 4, 2
PLACE_TWIN_SCALE, PLACE_TWIN_T, PLACE_TWIN_BUDGET = 10, 16, 16
PLACE_TWIN_FABRIC = dict(noc="hier", ndies_y=2, ndies_x=2)
PLACE_PR_DAMPING, PLACE_PR_TWIN_EPOCHS = 0.5, 3
PLACE_SERVE_SOURCES, PLACE_SERVE_WIDTH = 6, 2
PLACE_MAIN_BUDGET = 128   # the rmat-hier-adapt preset's adapt_budget
# Phase spmd: SPMD on torch.distributed (core/comm.py AxisComm).  (a) The
# tile base of fused leg 0 on the card: its operands at SPMD_TILE_CALLS
# calls of the twin's BFS (R-MAT-SPMD_TWIN_SCALE, SPMD_TWIN_T tiles), of
# triangles (symmetrized R-MAT-SPMD_TRI_SCALE) and of a 3-lane batch, each
# launched on all rows and then on one tile's rows at a time with tile0
# the tile (AxisComm's and LaneAxisComm's launch).  (b) World size 1 over
# NCCL (one card: NCCL takes one GPU a rank): BFS and SPMD_LANES serving
# lanes at T = 1 on R-MAT-SPMD_SCALE, the largest that the phase's ~30 s
# hold (rounds grow with the edges at one tile: ~E / 60), against the
# LocalComm run at T = 1 and the oracle; wall and device ms a round; each
# SPMD run again with its fused legs held against their plain stages at
# the one-row shapes (FusedCheck, every SPMD_CHECK_PERIOD-th round).
SPMD_TWIN_SCALE, SPMD_TWIN_T, SPMD_TRI_SCALE = 10, 16, 8
SPMD_TILE_CALLS = (0, 1, 4, 9)
SPMD_SCALE, SPMD_LANES = 11, 4
SPMD_PROFILE_AT, SPMD_PROFILE_ROUNDS = 100, 20
SPMD_CHECK_PERIOD = 30
SPMD_HOST_TOP = 12
BLOCK_SCALE, BLOCK_B, BLOCK_T = 14, 128, 16
# the knobs of the reference's block-ELL test (tests/test_kernels.py:75)
TEST_KNOBS = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                  cap_route_update=32, cap_rangeq=128, cap_updq=4096,
                  max_rounds=20000)
SEG_CAP = 4096        # updates per bin and round of the binned scatter
SEG_EDGE_B = 2050     # b of the column-range edge case: G = 5, b % 4 == 2
PR_SCALE, PR_ITERS = 18, 3
# the unfused R-MAT-18 BFS round whose two queue_push_pop turns are timed
# at the engine's operands (of about 1,000 rounds)
R18_TURN_ROUND = 500
INF32 = float(np.finfo(np.float32).max)
REPS = 25
# the Timer's spin before each timed launch: ~0.5 ms at the H100's clocks,
# longer than any kernel wrapper's host dispatch (the fused legs' wrappers
# take over 0.1 ms: a shorter spin adds what is left of it to their times)
SPIN_CYCLES = 1_000_000
# the shorter spin (~0.1 ms) that the fused legs are also timed under, so
# that their times compare with readings taken under it; the two readings
# differ where a wrapper's host dispatch outlasts the short spin
SHORT_SPIN_CYCLES = 200_000
# The LM serving path: granite-3-2b at full width and all 40 layers, B = 4
# prompts of 2048 random tokens, 16 greedy steps.
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bfloat16 (NVIDIA data sheet)
LM_ARCH, LM_B, LM_P, LM_G, LM_SEED = "granite-3-2b", 4, 2048, 16, 0
# flash cases (B, S, H, Hkv, hd, window, dtype): the reference's sweep
# (tests/test_kernels.py:24-30), then G = 4 at hd 128 and 32, S one tile
# of the reference (128) and of the kernel (64), S = 100 and 200 (ragged
# tiles; 200 is one block of the reference's prefill, min(512, S)),
# granite's prefill shape with window 128 and in float32; then for the
# bfloat16 body (tensor cores, TMA boxes of 64 rows, 128-row query
# blocks): S = 8 (shorter than a box), 64, 100 and 200, windows 64 and 128
# at G = 1, 4 and 8, hd 32, 64 and 128, and window 64 at S = 256, where
# row 191 has no live key in a kv tile its warpgroup computes.  The main
# shape, granite's bfloat16 prefill, is timed.  Tolerances: the
# reference's.
FLASH_SWEEP = (
    (2, 256, 4, 2, 64, 0, "float32"), (1, 256, 4, 1, 64, 64, "float32"),
    (2, 128, 2, 2, 32, 0, "float32"), (1, 512, 8, 8, 64, 128, "float32"),
    (1, 256, 4, 4, 128, 0, "bfloat16"), (1, 256, 8, 2, 128, 0, "float32"),
    (1, 384, 8, 2, 32, 64, "bfloat16"), (1, 128, 4, 4, 64, 0, "float32"),
    (1, 64, 4, 1, 64, 0, "float32"), (1, 100, 4, 2, 64, 0, "float32"),
    (2, 200, 32, 8, 64, 0, "float32"), (2, 200, 32, 8, 64, 0, "bfloat16"),
    (LM_B, LM_P, 32, 8, 64, 128, "bfloat16"),
    (LM_B, LM_P, 32, 8, 64, 0, "float32"),
    (1, 8, 4, 4, 64, 0, "bfloat16"), (1, 64, 4, 1, 64, 0, "bfloat16"),
    (2, 100, 8, 1, 128, 0, "bfloat16"), (2, 100, 4, 4, 32, 0, "bfloat16"),
    (2, 200, 8, 8, 32, 0, "bfloat16"), (1, 384, 8, 1, 32, 64, "bfloat16"),
    (1, 512, 8, 8, 128, 128, "bfloat16"), (2, 256, 4, 1, 64, 64, "bfloat16"))
FLASH_MAIN = (LM_B, LM_P, 32, 8, 64, 0, "bfloat16")
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Largest relative L2 distance of the bfloat16 kernel run's last hidden
# state from the bfloat16 plain run's: twice the 0.0717 the card gave
# (PERF.md §5).  The two differ only in the attention's summation order,
# but a flipped bfloat16 rounding grows over 40 layers under the
# reference's init (std 1/sqrt(40) on every block matrix); the float32
# run, held to 1e-3, is the check of the kernel's arithmetic.
BF16_REL_L2 = 0.15
# granite prompt lengths the reference's prefill takes (one 200-row block)
# and refuses (600 % min(512, 600) != 0)
LM_RAGGED_P, LM_REFUSED_P = 200, 600
# The rwkv6 serving path: rwkv6-1.6b at full width and all 24 layers, the
# same prompts and steps.  WKV6 cases (B, S, H, K, chunk, w_log, state0):
# the reference's sweep (tests/test_kernels.py:142-146), a non-zero state0,
# S = 8 (C = S), every decay at the clip and at no decay; then every
# instance of the kernel (K 16, 32, 64 at 1, 2 and 4 tiles of 8 steps) and
# ragged tiles (chunks of 5, 12 and 20 steps) over 512 steps; then the
# prefill shape (timed).  w_log None draws clip(-exp(0.5 N(0, 1))), as the
# sweep.
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 (NVIDIA data sheet)
RWKV_ARCH = "rwkv6-1.6b"
WKV_SWEEP = (
    (2, 128, 3, 16, 16, None, False), (1, 64, 2, 32, 32, None, False),
    (2, 96, 1, 64, 16, None, False), (2, 128, 4, 64, 16, None, True),
    (1, 8, 2, 64, 16, None, False), (1, 64, 2, 64, 16, -4.0, False),
    (1, 64, 2, 64, 16, -1e-6, False),
    (2, 512, 3, 16, 8, None, True), (2, 512, 3, 16, 16, None, False),
    (1, 512, 2, 16, 32, None, True), (2, 512, 2, 32, 8, None, False),
    (1, 512, 2, 32, 16, None, True), (1, 512, 2, 32, 32, None, False),
    (2, 512, 2, 64, 8, None, True), (1, 512, 2, 64, 32, None, True),
    (2, 40, 3, 64, 5, None, True), (2, 48, 2, 16, 12, None, False),
    (1, 60, 2, 64, 20, None, True))
WKV_MAIN = (LM_B, LM_P, 32, 64, 16, None, True)
# y and the final state within WKV_REL_TOL of their largest magnitude
# (the kernel and wkv6_chunked sum in float32 in other orders; the card
# gave at most 3.7e-7, PERF.md §6); the reference's tolerance against the
# scan oracle
WKV_REL_TOL = 1e-5
WKV_ORACLE_TOL = 3e-4
# float32 serving: the last hidden state within RWKV_F32_TOL of its largest
# magnitude (the WKV sums' order differs in each of 24 layers; the card
# gave 1.22e-5).  bfloat16, at the reference's init: rel L2 from the plain
# run within RWKV_BF16_REL_L2, twice the 0.02796 the card gave (a flipped
# bfloat16 rounding of the time mix's output grows over the layers)
RWKV_F32_TOL = 1e-4
RWKV_BF16_REL_L2 = 0.06
# The zamba2 serving path: zamba2-2.7b at full width and all 54 layers (9
# superblocks of the shared attention block and 6 Mamba2 layers), the same
# prompts and steps.  SSD cases (B, S, H, P, N, chunk, a_log, dt, state0):
# the reference's sweep (tests/test_kernels.py:180-182), a non-zero state0,
# one chunk (S = 16), every dt at the clip (-e^2 * 10 < -4), dt -> 0, and
# chunk 32 at the clip, whose upper triangle overflows float32; then the
# prefill shape (timed).  a_log None draws 0.3 N(0, 1) and dt None
# softplus(N(0, 1)), as the sweep.
ZAMBA_ARCH = "zamba2-2.7b"
SSD_SWEEP = (
    (2, 128, 3, 16, 8, 16, None, None, False),
    (1, 64, 2, 32, 16, 32, None, None, False),
    (2, 96, 1, 64, 64, 16, None, None, False),
    (2, 128, 4, 64, 64, 16, None, None, True),
    (1, 16, 2, 64, 64, 16, None, None, False),
    (2, 64, 3, 32, 16, 16, 2.0, 10.0, False),
    (1, 64, 2, 32, 16, 16, None, 1e-5, False),
    (1, 64, 2, 16, 8, 32, 2.0, 10.0, False),
    # ragged tiles (the kernel pads a chunk to 8-step tiles): chunks of 1,
    # 5 and 8 steps and S = 8 < chunk, at (P, N) = (16, 8) and (64, 64), H
    # not a multiple of a block's heads; then three tiles (chunk 24)
    (2, 16, 3, 16, 8, 1, None, None, False),
    (2, 40, 3, 16, 8, 5, None, None, True),
    (2, 64, 3, 16, 8, 8, None, None, False),
    (2, 8, 3, 16, 8, 16, None, None, True),
    (1, 16, 3, 64, 64, 1, None, None, True),
    (1, 40, 3, 64, 64, 5, None, None, False),
    (1, 64, 3, 64, 64, 8, None, None, True),
    (1, 8, 3, 64, 64, 16, None, None, False),
    (1, 48, 5, 32, 16, 24, None, None, True),
    # zamba2's 80 heads, the last block of a batch row part idle, over more
    # blocks than an H100 has SMs (135 and 140: a second wave)
    (5, 64, 80, 64, 64, 16, None, None, True),
    (10, 64, 80, 32, 16, 32, None, None, False))
SSD_MAIN = (LM_B, LM_P, 80, 64, 64, 16, None, None, True)
# y and the final state within SSD_REL_TOL of their largest magnitude
# (the kernel and ssd_chunked sum in float32 in other orders); the
# reference's tolerance against the scan oracle
SSD_REL_TOL = 1e-5
SSD_ORACLE_TOL = 3e-4
# flash at zamba2's head width, 80 (2560 / 32): the reference's sweep
# shapes at hd 80, a ragged windowed S, float32 at the prefill shape; then
# for the bfloat16 body (two 64-column boxes a row, columns 80-127 read as
# zeros; PV at wgmma's N = 80): S = 8 and 200, windows 64 and 128 at G =
# 1, 4 and 8, and zamba2's window (4096, past S); the main shape, zamba2's
# bfloat16 prefill, is timed
FLASH80_SWEEP = (
    (1, 256, 4, 4, 80, 0, "float32"), (2, 200, 4, 2, 80, 64, "float32"),
    (1, 256, 4, 4, 80, 0, "bfloat16"), (LM_B, LM_P, 32, 32, 80, 0, "float32"),
    (2, 8, 8, 1, 80, 0, "bfloat16"), (2, 200, 8, 2, 80, 64, "bfloat16"),
    (1, 512, 8, 8, 80, 128, "bfloat16"), (1, 256, 4, 1, 80, 64, "bfloat16"),
    (2, 208, 32, 32, 80, 4096, "bfloat16"))
FLASH80_MAIN = (LM_B, LM_P, 32, 32, 80, 0, "bfloat16")
# float32 serving, with a_log, dt_bias, d_skip and conv_b drawn (at the
# reference's init a_log = dt_bias = conv_b = 0 and d_skip = 1 in every
# head): the first Mamba2 layer's conv carry and SSD state and the last
# hidden state within ZAMBA_F32_TOL of their largest magnitude (the card
# gave at most 6.4e-6: the attention's and the SSD's sums run in other
# orders in each of 9 superblocks and 54 layers).  bfloat16, at the
# reference's init: rel L2 from the plain run within ZAMBA_BF16_REL_L2,
# about twice the 0.787 the card gave.  That bound says little: at the
# reference's init (std 1/3 on every Mamba2 matrix, ROADMAP §3) a flipped
# bfloat16 rounding grows over 54 layers until the two runs are nearly
# unrelated, so the float32 run is the check of the kernels' arithmetic
# (the phase also prints the bfloat16 run's distance from a float32 run
# at the same init).
ZAMBA_F32_TOL = 5e-5
ZAMBA_BF16_REL_L2 = 1.6
# prompt lengths: 208 = 13 chunks of 16 is served; 200 is refused by the
# SSD (200 % min(16, 200) != 0), as the reference's ssd_chunked asserts
ZAMBA_SERVED_P, ZAMBA_REFUSED_P = 208, 200
# The training path: granite-3-2b at full width and all 40 layers, bf16
# parameters with a float32 master, B = 4 sequences of 2048 tokens from the
# seeded Markov source, remat on.  Flash backward cases (B, S, H, Hkv, hd,
# window, dtype): granite's shape in float32, S = 200 (not a multiple of
# the 64-row tile), window 128, G = 1 and G = 4, hd 80, 32 and 128, each
# dtype; the main shape, granite's bfloat16 training attention, is timed.
FLASH_BWD_SWEEP = (
    (LM_B, LM_P, 32, 8, 64, 0, "float32"),
    (2, 200, 8, 2, 64, 0, "float32"), (2, 200, 8, 2, 64, 0, "bfloat16"),
    (1, 512, 8, 2, 64, 128, "float32"), (1, 512, 8, 2, 64, 128, "bfloat16"),
    (2, 256, 4, 4, 64, 0, "float32"), (2, 256, 4, 4, 64, 0, "bfloat16"),
    (2, 256, 8, 2, 64, 0, "float32"), (1, 256, 4, 4, 80, 0, "float32"),
    (1, 256, 4, 4, 80, 0, "bfloat16"), (1, 256, 4, 2, 32, 0, "float32"),
    (1, 256, 4, 1, 128, 64, "float32"), (1, 256, 4, 1, 128, 64, "bfloat16"))
FLASH_BWD_MAIN = (LM_B, LM_P, 32, 8, 64, 0, "bfloat16")
# each gradient within FLASH_BWD_TOL of its plain version's largest
# magnitude (the forward's tolerances; the sums run in other orders), the
# logsumexp within FLASH_LSE_TOL absolute
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# The phase's weights: the reference's draws (``TFM.init_params``), each
# block matrix scaled to std 1/sqrt(fan-in) (``tools/bf16_grad_readings.py``
# ``rescale_to_fan_in``).  The reference's own init (std 1/sqrt(40) on every
# stacked block matrix) makes its gradients ill-conditioned: there the JAX
# package's own bfloat16 gradient of granite-3-2b reduced at 3 layers is
# 0.74-1.18 rel L2 from its float32 one on its block leaves, the port's
# 0.67-1.10 on the CPU and 0.68-1.12 on the card (ROADMAP §3), so no
# bfloat16 check can hold it; at the fan-in init all three read
# 0.006-0.018 there, and the reference 0.021 at most at 8 layers, 0.026 at
# 40.
# (b) One whole-model step at TRAIN_TWIN_LAYERS layers (a depth cut for the
# script's time, PERF.md §4), kernel path against plain path, from the same
# weights and batch: the loss within rtol TRAIN_LOSS_RTOL, the global
# gradient norm within TRAIN_GNORM_RTOL, in float32 every gradient leaf
# within relative L2 TRAIN_LEAF_REL; in bfloat16 every leaf of both paths
# within TRAIN_BF16_LEAF_REL of the float32 plain path's gradient at the
# same weights (the bfloat16 weights widened): ~5x the reference's 0.021,
# where a zero gradient reads 1 and an unrelated one of the same norm ~1.41.
TRAIN_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
TRAIN_GNORM_RTOL = {"float32": 1e-3, "bfloat16": 0.1}
TRAIN_LEAF_REL = 1e-2   # float32
TRAIN_BF16_LEAF_REL = 0.1
TRAIN_TWIN_LAYERS = 8
TRAIN_STEPS = 10            # timed steps of the kernel path
TRAIN_RESUME_LAYERS = 2     # depth of the save/resume check (disk: §4)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)


def log(*a):
    print(*a, flush=True)


def spmv_x(n: int) -> np.ndarray:
    """The main SpMV path's ``x``: normal float32 from ``SPMV_SEED``."""
    return np.random.default_rng(SPMV_SEED).normal(size=n) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of ``fn`` over REPS launches after warm-up,
    with the 50 MB L2 cache overwritten before each timed launch.  A spin
    of SPIN_CYCLES clock cycles on the device follows the overwrite, so
    that the host has enqueued ``fn``'s launches before the first event
    is reached: a fast kernel's time is its device time, not its
    wrapper's host dispatch; a function whose host work outlasts the spin
    (the plain versions) is timed with its host gaps."""

    def __init__(self, dev):
        self.flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def ms(self, fn) -> float:
        return self.reading(fn)["ms"]

    def reading(self, fn, spin=None) -> dict:
        """``ms`` as above, under ``spin`` cycles (default SPIN_CYCLES),
        and ``host_ms``: the median host time of the ``fn`` calls, which the
        spin keeps from waiting on the device."""
        for _ in range(3):
            fn()
        times, host = [], []
        for _ in range(REPS):
            self.flush.fill_(1)
            torch.cuda._sleep(SPIN_CYCLES if spin is None else spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            h0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return dict(ms=float(np.median(times)),
                    host_ms=float(np.median(host)))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(moved_bytes: int) -> float:
    return moved_bytes / HBM_BYTES_PER_S * 1e3


def tensors(x):
    """The tensors of a (nested) tuple of outputs, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in tensors(y)]
    return []


def assert_bitwise(got, want, where):
    """Every output tensor bitwise equal (floats by their bits)."""
    got, want = tensors(got), tensors(want)
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{where}: output {i} {a.shape}/{a.dtype} "
                                 f"vs {b.shape}/{b.dtype}")
        bits_a = a.view(torch.int32) if a.dtype == torch.float32 else a
        bits_b = b.view(torch.int32) if b.dtype == torch.float32 else b
        if not torch.equal(bits_a, bits_b):
            bad = (bits_a != bits_b).nonzero()[:5].tolist()
            raise AssertionError(f"{where}: output {i} {tuple(a.shape)} "
                                 f"differs at {bad}")


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over all outputs: 0.0, since every output
    must be bitwise equal (raises otherwise)."""
    assert_bitwise(got, want, "kernel against its plain version")
    return 0.0


# --------------------------------------------------------------------------
# Phase 1: device and build
# --------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"# card: {smi}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    libs = (K.LIBRARY, F.LIBRARY, SEG.LIBRARY, SPMV.LIBRARY, FA.LIBRARY,
            W6.LIBRARY, SSD.LIBRARY, FA.BWD_LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        list(pool.map(lambda lib: lib.get(), libs))
    log(f"# kernel build: {time.perf_counter() - t0:.2f} s for "
        f"{len(libs)} sources built together")
    for lib in libs:
        log(f"#   {lib.source.name}: nvcc {lib.build_seconds:.2f} s -> "
            f"{lib.path}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"#   ptxas: {line.strip()}")
    hgmma = flash_tensor_core_instructions()
    log("# flash tensor-core instructions (cuobjdump -sass, HGMMA = wgmma): "
        + ", ".join(f"{k} {v}" for k, v in hgmma.items()))
    return smi, hgmma


def flash_tensor_core_instructions() -> dict:
    """HGMMA (wgmma) instructions in each instance of the built flash
    library, by ``cuobjdump -sass``; fails unless every bfloat16 instance
    runs on the tensor cores."""
    sass = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(FA.LIBRARY.path)],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1]
            body = "bfloat16" if "flash_wgmma_kernel" in fn else "float32"
            name = f"{body} hd {fn.split('ILi')[1].split('E')[0]}"
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    for hd in FA.HEAD_DIMS:
        assert counts.get(f"bfloat16 hd {hd}", 0) > 0, counts
    return dict(sorted(counts.items()))


# --------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on the card
# --------------------------------------------------------------------------

def rng_tensor(rng, a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def frontier_inputs(rng, T, n, k_max, dev):
    dens = rng.choice([0.0, 0.001, 0.02, 0.3, 1.0], size=T)
    mask = rng.random((T, n)) < dens[:, None]
    k = rng.integers(0, k_max + 1, T).astype(np.int32)
    k[:4] = [0, k_max, k_max, 1][:T]
    return rng_tensor(rng, mask, dev), rng_tensor(rng, k, dev)


# The shapes the pop and the min fold are timed at: the R-MAT-22 partition
# (the kernel table's shape) and R-MAT-18's, the shape of the unfused paths
# that launch them (phase rmat18); the fold with 4,096 rows a tile.
POP_FOLD_SHAPES = {"R-MAT-22 partition": (MAIN_T, MAIN_V_CHUNK),
                   "R-MAT-18 partition": (MAIN_T, 2 ** PR_SCALE // MAIN_T)}
# the min fold's slices past its staging: ranges of 52,432 slots
FOLD_BESIDE_V_CHUNK = 262144
# The T2 scans' shards at the same two partitions (ceil(E / 64) words a
# tile), timed at both: R-MAT-18's is the shape the unfused paths launch.
SCAN_SHAPES = {"R-MAT-22 partition": MAIN_E_CHUNK,
               "R-MAT-18 partition": 39134}


def unaligned(x: torch.Tensor, offset_bytes: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset_bytes`` past a
    16-byte boundary (a view into a larger buffer)."""
    n = nbytes(x)
    buf = torch.empty(n + 16, dtype=torch.uint8, device=x.device)
    view = buf[offset_bytes:offset_bytes + n].view(x.dtype).view(x.shape)
    return view.copy_(x)


def split_edges(T, n, dev):
    """The positions within two of every boundary of the column split of
    ``T`` tiles of ``n`` (its inner and outer ends), clipped to the tile."""
    bounds = np.array(K.device_split(T, n, dev).bounds(n))
    return np.unique(np.clip(bounds[:, None] + np.arange(-2, 2), 0, n - 1))


def pop_edge_inputs(rng, T, n, k_max, dev, kind):
    """Bitmaps at the pop's column split: "boundaries" sets bits only
    beside its boundaries; "straddle" gives each tile k_max or fewer set
    bits around one boundary, then more past them; budgets 0, 1 and
    k_max among the tiles."""
    mask = np.zeros((T, n), bool)
    k = rng.integers(0, k_max + 1, T).astype(np.int32)
    k[:3] = [0, 1, k_max][:T]
    if kind == "boundaries":
        e = split_edges(T, n, dev)
        mask[:, e] = rng.random((T, e.size)) < 0.7
    else:
        bounds = K.device_split(T, n, dev).bounds(n)
        for t in range(T):
            b = bounds[1 + t % max(len(bounds) - 2, 1)]
            half = int(rng.integers(0, k_max + 1))
            mask[t, max(b - half, 0):b + k_max - half] = True
            mask[t, b + k_max + 8:b + k_max + 40] = True
    return rng_tensor(rng, mask, dev), rng_tensor(rng, k, dev)


def check_frontier_pop(rng, dev, timer):
    k_max = MAIN_CFG.f_pop
    for T, n in ((3, 257), (5, 48), (2, 16)):  # ragged / small edge cases
        mask, k = frontier_inputs(rng, T, n, k_max, dev)
        max_abs_err(K.frontier_pop(mask, k, k_max),
                    K.frontier_take(mask, k, k_max))
    # the column split's edges (G = 5 and 9; n % 16 == 5 puts the tiles
    # off 16-byte vectors), each also on a bitmap off a vector (its
    # cleared copy on one: byte by byte)
    for T, n, kind in ((4, 2050, "boundaries"), (4, 2050, "straddle"),
                       (3, 4101, "boundaries"), (8, 4101, "straddle"),
                       (MAIN_T, 4096, "straddle")):
        mask, k = pop_edge_inputs(rng, T, n, k_max, dev, kind)
        for m in (mask, unaligned(mask, 5)):
            max_abs_err(K.frontier_pop(m, k, k_max),
                        K.frontier_take(m, k, k_max))
            assert K.frontier_pop.split == K.device_split(T, n, dev)
            assert K.frontier_pop.split.G > 1, K.frontier_pop.split
    calls = []
    for label, (T, n) in POP_FOLD_SHAPES.items():
        mask, k = frontier_inputs(rng, T, n, k_max, dev)
        out = K.frontier_pop(mask, k, k_max)
        max_abs_err(out, K.frontier_take(mask, k, k_max))
        copy = torch.empty_like(mask)
        calls.append(dict(
            call=label, shape=[T, n], G=K.frontier_pop.split.G,
            ms=timer.ms(lambda: K.frontier_pop(mask, k, k_max)),
            plain_ms=timer.ms(lambda: K.frontier_take(mask, k, k_max)),
            bound_ms=bound_ms(nbytes(mask, k, *out)),
            copy_ms=timer.ms(lambda: copy.copy_(mask))))
    main = calls[0]
    return dict(max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], library_ms=None, G=main["G"],
                copy_ms=main["copy_ms"], calls=calls)


def queue_inputs(rng, T, cap, w, m, max_n, dev, full_rows=False):
    data = rng.integers(-9, 1 << 22, (T, cap, w)).astype(np.int32)
    count = rng.integers(0, cap + 1, T).astype(np.int32)
    count[:3] = [0, cap, max(cap - 2, 0)][:T]  # empty / full / overflow
    rows = rng.integers(0, 1 << 22, (T, m, w)).astype(np.int32)
    valid = rng.random((T, m)) < (0.0 if not full_rows else 0.7)
    n = rng.integers(0, max_n + 1, T).astype(np.int32)
    n[:2] = [max_n, 0]
    return [rng_tensor(rng, a, dev) for a in (data, count, rows, valid, n)]


def turn_bytes(args, out, max_n) -> int:
    """Bytes a live-row turn must move: per tile, the rows of the
    appended queue that it reads (the first max(max_n, n_pop + count')),
    the turned queue's live rows and the taken rows written, the valid
    and taken_valid flags and the four counts."""
    data, count, rows, valid, n = args
    w = data.shape[2]
    n_pop = out[1].sum(dim=1)
    ncount = out[3].long()
    read = torch.clamp(n_pop + ncount, min=max_n)
    T, m = valid.shape
    return int(4 * w * (read + ncount + max_n).sum()) + T * (m + max_n + 16)


def turn_call(label, args, out, max_n, timer) -> dict:
    """One turn held against its plain version by ``turn_contract`` and
    timed: the live-row bound, the whole-queue bound of the earlier
    design (every input read and every output written whole) and the
    turned queue's live share of its capacity."""
    err = max_abs_err(K.turn_contract(out),
                      K.turn_contract(K.fifo_turn(*args, max_n)))
    T, cap, w = args[0].shape
    return dict(
        call=label, shape=[T, cap, w], max_abs_err=err,
        G=K.device_split(T, cap, args[0].device).G,
        ms=timer.ms(lambda: K.queue_push_pop(*args, max_n)),
        plain_ms=timer.ms(lambda: K.fifo_turn(*args, max_n)),
        bound_ms=bound_ms(turn_bytes(args, out, max_n)),
        whole_bound_ms=bound_ms(nbytes(*args, *out)),
        live_share=float(out[3].sum()) / (T * cap))


def check_queue_push_pop(rng, dev, timer):
    """The live-row turn against fifo_turn (``turn_contract``: the turned
    queue below its count, the other outputs whole) on the edge cases, 16,448
    fresh rows (past the 48 KiB of shared memory a block gets without opting
    in) and 65,536 (past STAGE_SMEM_MAX: the device scratch); then the two
    calls of a main-path round on drawn operands (counts uniform in [0,
    cap]), timed."""
    for T, cap, w, m, max_n in ((3, 16, 3, 8, 6), (4, 8, 2, 8, 8),
                                (2, 32, 4, 1, 8), (3, 20000, 4, 16448, 32),
                                (2, 70000, 4, 65536, 64),
                                (5, 3000, 5, 40, 16)):
        args = queue_inputs(rng, T, cap, w, m, max_n, dev, full_rows=True)
        out = K.queue_push_pop(*args, max_n)
        max_abs_err(K.turn_contract(out),
                    K.turn_contract(K.fifo_turn(*args, max_n)))
        assert K.queue_push_pop.path == ("device scratch" if m == 65536
                                         else "shared memory")
    cfg = MAIN_CFG
    calls = []
    # the two calls of a round: the range channel (fresh tasks) and the
    # update channel (replay only: one empty fresh row)
    for label, cap, w, m, max_n, fresh in (
            ("range", cfg.cap_rangeq, 3, cfg.f_pop, cfg.r_pop, True),
            ("update", cfg.cap_updq, 2, 1, cfg.u_pop, False)):
        args = queue_inputs(rng, MAIN_T, cap, w, m, max_n, dev, fresh)
        calls.append(turn_call(label, args, K.queue_push_pop(*args, max_n),
                               max_n, timer))
    total = {key: sum(c[key] for c in calls)
             for key in ("ms", "plain_ms", "bound_ms", "whole_bound_ms")}
    return dict(max_abs_err=max(c["max_abs_err"] for c in calls),
                library_ms=None, calls=calls, **total)


def scan_inputs(rng, T, e_chunk, R, max_t2, dev, negative=False):
    """Operands of a T2 scan: half the messages valid, lengths uniform in
    [0, max_t2] (with ``negative``, a quarter of them below 0), the
    invalid messages' starts half -1."""
    ed = rng.integers(-1, 1 << 22, (T, e_chunk)).astype(np.int32)
    ev = rng.uniform(1, 10, (T, e_chunk)).astype(np.float32)
    start = rng.integers(0, T * e_chunk, (T, R)).astype(np.int32)
    stop = start + rng.integers(0, max_t2 + 1, (T, R)).astype(np.int32)
    if negative:
        stop = np.where(rng.random((T, R)) < 0.25,
                        start - rng.integers(1, 9, (T, R)), stop)
    rv = rng.random((T, R)) < 0.5
    start = np.where(rv | (rng.random((T, R)) < 0.5), start, -1)
    return [rng_tensor(rng, a, dev)
            for a in (ed, ev, start.astype(np.int32),
                      stop.astype(np.int32), rv)]


# The scans' edge cases (T, e_chunk, R, max_t2): max_t2 not a multiple of 4
# (7, 33, 6: a team's last thread holds a cut group), R = 1, shards shorter
# than max_t2, and R * max_t2 = 19.2 M lanes, past the 65,535-block grid of
# the earlier design's (T, lanes / 256) launch.
SCAN_EDGES = ((2, 64, 10, 8), (2, 33, 24, 4), (3, 128, 1, 16),
              (2, 64, 10, 7), (3, 200, 30, 33), (2, 50, 17, 6),
              (1, 70, 1, 32), (2, 5, 12, 16), (3, 20, 40, 33),
              (1, 70000, 600000, 32))


def scan_call(scan, args, max_t2, *window):
    """One scan held against its plain version by ``scan_contract``."""
    plain = K.segment_stream if window else K.segment_gather
    out = scan(*args, max_t2, *window)
    max_abs_err(K.scan_contract(out),
                K.scan_contract(plain(*args, max_t2, *window)))
    return out


def check_scan_edges(scan, windows, dev):
    """The edge cases of SCAN_EDGES, each on fresh operands, with negative
    lengths, and on operands that start off a 16-byte vector; for the
    stream at each window of ``windows(max_t2)`` whose staging the plain
    version holds in memory (2 * window words a message)."""
    rng = np.random.default_rng(1)
    for T, e_chunk, R, mt in SCAN_EDGES:
        for kind in ("plain", "negative", "unaligned"):
            args = scan_inputs(rng, T, e_chunk, R, mt, dev,
                               negative=kind != "plain")
            if kind == "unaligned":
                args = [unaligned(a, a.element_size()) for a in args]
            for window in windows(mt):
                if window and T * R * 2 * window[0] > 2 ** 26:
                    continue
                scan_call(scan, args, mt, *window)


def scan_bounds(args, out, max_t2) -> dict:
    """The bounds of one scan: ``bound_ms``, what the function must move
    under ``scan_contract`` (each message's rv, start and stop, jvalid
    whole, and for each live lane, j below a valid message's length, its
    distinct shard words read and its nb and w written); ``whole_bound_ms``
    with every lane's nb and w and the distinct words of every lane's
    clamped index; and the live share of the lanes."""
    ed, ev, start, stop, rv = args
    T, e_chunk = ed.shape
    dev = ed.device
    length = torch.where(rv, stop - start, 0)
    local0 = torch.where(rv, start % e_chunk, 0)
    j = torch.arange(max_t2, device=dev, dtype=torch.int32)
    live = j < length[:, :, None]
    eidx = torch.clamp(local0[:, :, None] + j, max=e_chunk - 1)
    words = shard_words(eidx, T)
    # a live lane's word, or -1 (one extra "word" a shard row at most)
    live_words = shard_words(torch.where(live, eidx, -1), T) - sum(
        int(bool((~live[t::T]).any())) for t in range(T))
    n_live = int(live.sum())
    rows = nbytes(start, stop, rv)
    return dict(
        bound_ms=bound_ms(rows + nbytes(out[2]) + 8 * live_words
                          + 8 * n_live),
        whole_bound_ms=bound_ms(rows + nbytes(*out) + 8 * words),
        live_share=n_live / live.numel())


def scan_library(args, max_t2):
    """The scans' library yardstick: one torch.gather of the (dst, val)
    word pairs at every lane's clamped index (no jvalid)."""
    ed, ev, start, stop, rv = args
    T, e_chunk = ed.shape
    lanes = start.shape[0] // T
    local0 = torch.where(rv, start % e_chunk, 0)
    j = torch.arange(max_t2, device=ed.device, dtype=torch.int32)
    eidx = torch.clamp(local0[:, :, None] + j, max=e_chunk - 1)
    pairs = torch.stack([ed, ev.view(torch.int32)], dim=-1)
    # the serving lanes' rows gather from the one shard (a view)
    pairs = pairs[None].expand((lanes,) + tuple(pairs.shape))
    gidx = eidx.reshape(lanes, T, -1, 1).expand(-1, -1, -1, 2) \
        .to(torch.int64)
    return lambda: torch.gather(pairs, 2, gidx)


def scan_record(label, args, max_t2, timer, *window) -> dict:
    """One scan at ``args``: checked by ``scan_contract``, timed beside
    its plain version and the library yardstick, with its bounds."""
    scan = K.edge_scan_stream if window else K.edge_scan_gather
    plain = K.segment_stream if window else K.segment_gather
    out = scan_call(scan, args, max_t2, *window)
    T, e_chunk = args[0].shape
    rec = dict(call=label, shape=[T, e_chunk, args[2].shape[1], max_t2],
               lanes=args[2].shape[0] // T,
               max_abs_err=0.0,
               ms=timer.ms(lambda: scan(*args, max_t2, *window)),
               plain_ms=timer.ms(lambda: plain(*args, max_t2, *window)),
               **scan_bounds(args, out, max_t2),
               library_ms=timer.ms(scan_library(args, max_t2)),
               library="torch.gather, no jvalid")
    if window:  # what the staged windows of the earlier design read
        rec["staged_bound_ms"] = bound_ms(
            nbytes(*args[2:], *out)
            + 8 * stream_words(args[2], args[4], e_chunk, *window, T))
    return rec


def scan_row(calls) -> dict:
    main = calls[0]
    return dict(max_abs_err=0.0, calls=calls,
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "whole_bound_ms", "live_share",
                                        "library_ms")})


def check_edge_scan_gather(rng, dev, timer):
    check_scan_edges(K.edge_scan_gather, lambda mt: [()], dev)
    R = MAIN_T * MAIN_CFG.cap_route_range
    max_t2 = MAIN_CFG.max_t2
    return scan_row([
        scan_record(label, scan_inputs(rng, MAIN_T, e_chunk, R, max_t2,
                                       dev), max_t2, timer)
        for label, e_chunk in SCAN_SHAPES.items()])


def shard_words(idx, shard_T=None) -> int:
    """Distinct shard words of (rows, ...) indices, each row reading shard
    row ``row % shard_T`` (the serving lanes' rows share one shard;
    ``shard_T`` None: one row a shard row)."""
    shard_T = shard_T or idx.shape[0]
    return sum(int(torch.unique(idx[t::shard_T]).numel())
               for t in range(shard_T))


def stream_words(start, rv, e_chunk, window, shard_T=None):
    """Distinct shard words the staged windows of these messages cover:
    what the earlier, staging design of the streamed T2 read."""
    local0 = torch.where(rv, start % e_chunk, 0)
    base = torch.div(local0, window, rounding_mode="floor") * window
    k = torch.arange(2 * window, device=start.device, dtype=torch.int32)
    sidx = torch.clamp(base[:, :, None] + k, max=e_chunk - 1)
    return shard_words(sidx, shard_T)


def check_edge_scan_stream(rng, dev, timer):
    """Edge cases (windows of 1, 2 and 16 times max_t2, past what fused
    leg 1 stages, and shards shorter than two windows), then the main
    path's T2 shape with the auto window (128) and the max_t2-tight one
    (32), as fig13's ladder runs them, and R-MAT-18's shard."""
    check_scan_edges(
        K.edge_scan_stream,
        lambda mt: [(w,) for w in (mt, 2 * mt, 16 * mt,
                                   K.STREAM_MAX_WINDOW + 1, 4096)], dev)
    max_t2 = MAIN_CFG.max_t2
    R = MAIN_T * MAIN_CFG.cap_route_range
    main22, main18 = SCAN_SHAPES.items()
    calls = []
    for (label, e_chunk), window in ((main22, 128), (main22, max_t2),
                                     (main18, 128)):
        args = scan_inputs(rng, MAIN_T, e_chunk, R, max_t2, dev)
        calls.append(scan_record(f"window {window}, {label}", args, max_t2,
                                 timer, window))
    return scan_row(calls)  # the auto window, as the engine resolves it


def fold_inputs(rng, T, v_chunk, R, dev):
    tgt = np.where(rng.random((T, v_chunk)) < 0.5, INF32,
                   rng.integers(0, 30, (T, v_chunk))).astype(np.float32)
    valid = rng.random((T, R)) < 0.8
    lidx = np.where(valid, rng.integers(0, v_chunk, (T, R)), v_chunk)
    lidx[:, : R // 4] = np.where(valid[:, : R // 4], 3, v_chunk)  # dups
    vals = rng.normal(10, 12, (T, R)).astype(np.float32)  # some negative
    return [rng_tensor(rng, a, dev)
            for a in (tgt, lidx.astype(np.int32), vals, valid)]


def nan_bits(rng, shape):
    """float32 values, a sixth each: NaNs with the sign bit clear and with
    it set (quiet and signalling payloads), +-0.0 and +-inf; the rest
    numbers."""
    kind = rng.integers(0, 6, shape)
    u = np.where(
        kind == 0, 0x7F800001 + rng.integers(0, 0x7FFFFF, shape),
        np.where(kind == 1, 0xFF800001 + rng.integers(0, 0x7FFFFF, shape),
                 np.where(kind == 2, rng.choice(
                     [0, 0x80000000, 0x7F800000, 0xFF800000], shape),
                     rng.normal(0, 20, shape).astype(np.float32).view(
                         np.uint32))))
    return u.astype(np.uint32).view(np.float32)


def min_fold_edge_inputs(rng, T, v_chunk, R, dev, kind):
    """Min-fold inputs at its column split: rows beside every boundary
    ("boundaries"), +0.0 and -0.0 in targets and rows ("zeros"), NaNs of
    both signs, +-0.0 and +-inf in targets and rows, many rows a slot, so
    that the rule's row order shows ("nan"), every target float32 max
    ("max"), rows equal to their slot's target ("equal"), every row
    invalid ("invalid", half on real slots) or on one slot
    ("one-slot")."""
    tgt = rng.normal(0, 20, (T, v_chunk)).astype(np.float32)
    valid = rng.random((T, R)) < 0.8
    lidx = rng.choice(split_edges(T, v_chunk, dev), (T, R))
    vals = rng.normal(0, 20, (T, R)).astype(np.float32)
    if kind == "zeros":
        z = np.float32([0.0, -0.0])
        tgt[:, :64] = rng.choice(z, (T, 64))
        lidx = rng.integers(0, 64, (T, R))
        vals = np.where(rng.random((T, R)) < 0.7, rng.choice(z, (T, R)),
                        np.abs(vals))
    elif kind == "nan":
        tgt[:, :64] = nan_bits(rng, (T, 64))
        lidx = rng.integers(0, 64, (T, R))
        vals = nan_bits(rng, (T, R))
    elif kind == "max":
        tgt[:] = INF32
    elif kind == "equal":
        vals = np.take_along_axis(tgt, lidx, 1)
    elif kind == "invalid":
        valid[:] = False
    elif kind == "one-slot":
        lidx[:] = v_chunk // 2
    lidx = np.where(valid | (rng.random((T, R)) < 0.5), lidx, v_chunk)
    return [rng_tensor(rng, a, dev) for a in (
        tgt, lidx.astype(np.int32), vals.astype(np.float32), valid)]


def check_fold_scatter(rng, dev, timer):
    def plain(*a):
        return K.scatter_body(*a, "min")

    def fold(*a):
        out = K.fold_scatter(*a)
        split = K.device_split(*a[0].shape, dev)
        assert K.fold_scatter.split == split
        assert K.fold_scatter.path == K.min_fold_path(split.step)
        return out

    for T, v, R in ((3, 32, 20), (2, 8, 64), (2, 128, 1)):
        args = fold_inputs(rng, T, v, R, dev)
        max_abs_err([fold(*args)], [plain(*args)])
    # the column split's edges, G = 5 (also on a target off a 16-byte
    # vector), and the slices past the staging (ranges of 52,432 slots)
    for kind in ("boundaries", "zeros", "nan", "max", "equal", "invalid",
                 "one-slot"):
        args = min_fold_edge_inputs(rng, 2, SEG_EDGE_B, 4096, dev, kind)
        max_abs_err([fold(*args)], [plain(*args)])
        assert K.fold_scatter.split.G > 1, K.fold_scatter.split
        args[0] = unaligned(args[0], 4)
        max_abs_err([fold(*args)], [plain(*args)])
    # NaNs and signed zeros past the staging (ranges of 52,432 slots)
    args = min_fold_edge_inputs(rng, MAIN_T, FOLD_BESIDE_V_CHUNK, 4096, dev,
                                "nan")
    max_abs_err([fold(*args)], [plain(*args)])
    assert K.fold_scatter.path == "folded beside the copy"
    R = MAIN_T * MAIN_CFG.cap_route_update
    calls = []
    shapes = {**POP_FOLD_SHAPES,
              "past the staging": (MAIN_T, FOLD_BESIDE_V_CHUNK)}
    for label, (T, v) in shapes.items():
        tgt, lidx, vals, valid = args = fold_inputs(rng, T, v, R, dev)
        out = fold(*args)
        max_abs_err([out], [plain(*args)])
        # library yardstick: one scatter_reduce(amin) into the slice plus
        # its trash column, rows pre-masked (it folds -0.0 and +0.0 in no
        # fixed order)
        ext = torch.cat([tgt, tgt.new_full((T, 1), INF32)], dim=1)
        masked = torch.where(valid, vals, INF32)
        lidx64 = lidx.to(torch.int64)
        copy = torch.empty_like(tgt)
        calls.append(dict(
            call=label, shape=[T, v, R], G=K.fold_scatter.split.G,
            path=K.fold_scatter.path,
            ms=timer.ms(lambda: K.fold_scatter(*args)),
            plain_ms=timer.ms(lambda: plain(*args)),
            bound_ms=bound_ms(nbytes(*args, out)),
            library_ms=timer.ms(
                lambda: ext.scatter_reduce(1, lidx64, masked, "amin")),
            library="scatter_reduce amin",
            copy_ms=timer.ms(lambda: copy.copy_(tgt))))
    assert calls[-1]["path"] == "folded beside the copy", calls[-1]
    main = calls[0]
    assert main["path"] == "staged in shared memory", main
    return dict(max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], library_ms=main["library_ms"],
                G=main["G"], path=main["path"], copy_ms=main["copy_ms"],
                calls=calls)


def add_fold_inputs(rng, T, v_chunk, R, dev, kind):
    """Add-fold inputs: "path" draws slots as the SpMV path spreads them;
    "dups" puts a quarter of the rows on one slot, "one-slot" all of them,
    "invalid" none (every row on the trash slot), "boundaries" every row
    on the slots beside the column boundaries of the kernel's split (two
    before each, two after); these send invalid rows to the trash slot.
    "invalid-on-real-slots" puts the invalid rows on slots 0 and 1 and the
    valid ones on the others.  Slot 0 holds -0.0, which invalid rows alone
    turn into +0.0 (each adds 0.0, as the reference does)."""
    tgt = rng.normal(0, 1, (T, v_chunk)).astype(np.float32)
    tgt[:, 0] = -0.0
    valid = rng.random((T, R)) < 0.8
    lidx = rng.integers(0, v_chunk, (T, R))
    if kind == "dups":
        lidx[:, : R // 4] = 3
    elif kind == "one-slot":
        lidx[:] = 1
    elif kind == "invalid":
        valid[:] = False
    elif kind == "boundaries":
        bounds = np.array(K.device_split(T, v_chunk, dev).bounds(v_chunk))
        edges = np.unique(np.clip(bounds[:, None] + [-2, -1, 0, 1], 0,
                                  v_chunk - 1))
        lidx = rng.choice(edges, (T, R))
    if kind == "invalid-on-real-slots":
        lidx = np.where(valid, rng.integers(2, v_chunk, (T, R)),
                        rng.integers(0, 2, (T, R)))
    else:
        lidx = np.where(valid, lidx, v_chunk)
    lidx = lidx.astype(np.int32)
    vals = (rng.normal(0, 1, (T, R)) * 10.0 ** rng.integers(
        -3, 4, (T, R))).astype(np.float32)  # mixed magnitudes
    return [rng_tensor(rng, a, dev) for a in (tgt, lidx, vals, valid)]


def check_fold_scatter_add(rng, dev, timer):
    fold = K.fold_scatter_add

    def plain(*a):
        return K.scatter_body(*a, "add")

    R = MAIN_T * SPMV_CFG.cap_route_update
    # then the column split's edges: rows beside every boundary of G = 5
    # ranges of 2,050 slots (b % 4 == 2), in one chunk and in two, and of
    # the timed shape's; v_chunk 301 (G = 1, not a multiple of 4), with
    # invalid rows on real slots
    for T, v, r, kind in ((3, 32, 20, "dups"), (2, 8, 64, "dups"),
                          (2, 128, 1, "path"), (2, 16, 300, "one-slot"),
                          (2, 16, 40, "invalid"),
                          (3, 4, 64, "invalid-on-real-slots"),
                          (MAIN_T, MAIN_V_CHUNK, R, "dups"),
                          (MAIN_T, MAIN_V_CHUNK, R, "one-slot"),
                          (2, 64, 40000, "dups"), (2, 4096, 20000, "path"),
                          (2, SEG_EDGE_B, 4096, "boundaries"),
                          (2, SEG_EDGE_B, 16385, "boundaries"),
                          (MAIN_T, MAIN_V_CHUNK, R, "boundaries"),
                          (3, 301, 2000, "invalid-on-real-slots"),
                          (3, 301, 2000, "dups")):
        args = add_fold_inputs(rng, T, v, r, dev, kind)
        max_abs_err([fold(*args)], [plain(*args)])
        assert fold.path == K.add_chunks(r)  # past 16,384 rows: chunks
        assert fold.split == K.device_split(T, v, dev)
        assert kind != "boundaries" or fold.split.G > 1, fold.split
    tgt, lidx, vals, valid = args = add_fold_inputs(
        rng, MAIN_T, MAIN_V_CHUNK, R, dev, "path")
    out = fold(*args)
    err = max_abs_err([out], [plain(*args)])
    # library yardstick: one out-of-place scatter_add into the slice plus
    # its trash column, rows pre-masked (float atomics: not order-keeping)
    ext = torch.cat([tgt, tgt.new_zeros((MAIN_T, 1))], dim=1)
    masked = torch.where(valid, vals, 0.0)
    lidx64 = lidx.to(torch.int64)
    return dict(
        max_abs_err=err, ms=timer.ms(lambda: fold(*args)),
        plain_ms=timer.ms(lambda: plain(*args)),
        bound_ms=bound_ms(nbytes(*args, out)),
        library_ms=timer.ms(lambda: ext.scatter_add(1, lidx64, masked)),
        G=fold.split.G)


def seg_inputs(rng, nb, b, cap, dev, kind):
    """Operands of scatter_segments; ``kind`` a list of column-range
    boundaries: updates on the slots beside each (its last slot before,
    its first after, several times each), in random order, a quarter of
    the rows empty."""
    base = rng.normal(0, 1, (nb, b)).astype(np.float32)
    idx = rng.integers(-1, b, (nb, cap))  # -1 = empty slot
    if kind == "one-slot":
        idx = np.where(rng.random((nb, cap)) < 0.8, 5, -1)
    elif kind == "nan":  # NaNs, +-0.0 and +-inf on the first 64 slots
        idx = np.where(rng.random((nb, cap)) < 0.2, -1,
                       rng.integers(0, min(b, 64), (nb, cap)))
        base[:, :64] = nan_bits(rng, base[:, :64].shape)
        return [rng_tensor(rng, a, dev) for a in (
            base, idx.astype(np.int32), nan_bits(rng, (nb, cap)))]
    elif kind == "empty":
        idx[:] = -1
    elif isinstance(kind, list):
        edges = np.unique(np.clip(np.array(kind)[:, None] + [-1, 0], 0,
                                  b - 1))
        idx = np.where(rng.random((nb, cap)) < 0.25, -1,
                       rng.choice(edges, (nb, cap)))
    vals = rng.normal(0, 1, (nb, cap)).astype(np.float32)
    return [rng_tensor(rng, a, dev)
            for a in (base, idx.astype(np.int32), vals)]


# scatter_segments' yardsticks: one PyTorch call on the slots plus a trash
# column; the amin computes the same function, the add keeps no order
SEG_LIBRARY = {"add": "scatter_add (float atomics: not the same bits)",
               "min": "scatter_reduce amin (the same function)"}


def check_scatter_segments(rng, dev, timer):
    """At the TPU tests' shapes, the edge cases (among them, at b = 2050
    over G = 5 column ranges: duplicate slots on both sides of each inner
    boundary and every range's first and last slot; and 300 bins of 20,000
    slots, one range each, wider than the add's slot counters), and the
    engine's T3 shape (NB = 64 bins of b = 65536 slots, cap = 4096
    updates each)."""
    calls = []
    for op in ("add", "min"):
        for nb, b, cap, kind in ((4, 128, 32, "mixed"), (2, 64, 128, "mixed"),
                                 (3, 32, 200, "one-slot"),
                                 (2, 64, 16, "empty"), (2, 16, 1, "mixed"),
                                 (2, 64, 300, "nan"),
                                 (2, SEG_EDGE_B, 4096, "nan"),
                                 (MAIN_T, FOLD_BESIDE_V_CHUNK, 512, "nan"),
                                 (300, 20000, 256, "mixed"),
                                 (2, SEG_EDGE_B, 40000, "mixed"),
                                 (MAIN_T, MAIN_V_CHUNK, SEG_CAP,
                                  "one-slot")):
            if kind == "nan" and op == "add":
                continue  # the min's cases
            args = seg_inputs(rng, nb, b, cap, dev, kind)
            max_abs_err([SEG.scatter_segments(*args, op=op)],
                        [SEG.binned_scatter(*args, op)])
        split = K.device_split(2, SEG_EDGE_B, dev)
        assert split.G > 1, split
        args = seg_inputs(rng, 2, SEG_EDGE_B, SEG_CAP, dev,
                          split.bounds(SEG_EDGE_B))
        max_abs_err([SEG.scatter_segments(*args, op=op)],
                    [SEG.binned_scatter(*args, op)])
        # timed at the TPU tests' shapes and at the T3 shape
        for nb, b, cap in ((4, 128, 32), (2, 64, 128),
                           (MAIN_T, MAIN_V_CHUNK, SEG_CAP)):
            base, idx, vals = args = seg_inputs(rng, nb, b, cap, dev,
                                                "mixed")
            out = SEG.scatter_segments(*args, op=op)
            err = max_abs_err([out], [SEG.binned_scatter(*args, op)])
            ext = torch.cat([base, base.new_full((nb, 1), INF32)], dim=1)
            slot = torch.where(idx < 0, b, idx).to(torch.int64)
            library = (functools.partial(ext.scatter_add, 1, slot, vals)
                       if op == "add" else functools.partial(
                           ext.scatter_reduce, 1, slot, vals, "amin"))
            calls.append(dict(
                call=op, shape=[nb, b, cap],
                G=K.device_split(nb, b, dev).G, max_abs_err=err,
                ms=timer.ms(lambda: SEG.scatter_segments(*args, op=op)),
                plain_ms=timer.ms(lambda: SEG.binned_scatter(*args, op)),
                bound_ms=bound_ms(nbytes(*args, out)),
                library_ms=timer.ms(library), library=SEG_LIBRARY[op]))
    t3 = [c for c in calls if c["shape"] == [MAIN_T, MAIN_V_CHUNK, SEG_CAP]]
    # the row's times: the add and the min call at the T3 shape, summed
    total = {key: sum(c[key] for c in t3)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return dict(max_abs_err=max(c["max_abs_err"] for c in calls),
                calls=calls, **total)


def coo_block_ell(n, rows, cols, vals, b, dev):
    """Block-ELL operands of the (n x n) COO matrix, on ``dev``."""
    bvals, bcols, n_pad = SPMV.to_block_ell(n, rows, cols, vals, b)
    return (torch.from_numpy(bvals).to(dev), torch.from_numpy(bcols).to(dev),
            n_pad)


@functools.lru_cache(maxsize=None)
def block_graph():
    """R-MAT-14 (edge factor 10, seed 1) as A[dst, src] = val."""
    n, src, dst, val = rmat_edges(BLOCK_SCALE, edge_factor=10, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    src_idx = np.repeat(np.arange(n), g.ptr[1:] - g.ptr[:-1])
    return g, src_idx


def spmv_within_tol(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=what)
    return err


def check_spmv_block_ell(rng, dev, timer):
    for n, nnz, b in ((300, 2000, 64), (513, 4000, 128), (100, 500, 32),
                      (64, 0, 32)):
        rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
        vals = rng.normal(size=nnz).astype(np.float32)
        bv, bc, n_pad = coo_block_ell(n, rows, cols, vals, b, dev)
        x = torch.from_numpy(rng.normal(size=n_pad).astype(np.float32)) \
            .to(dev)
        spmv_within_tol(SPMV.spmv_block_ell(bv, bc, x),
                        SPMV.block_ell_matvec(bv, bc, x), f"n={n} b={b}")
    g, src_idx = block_graph()
    bv, bc, n_pad = coo_block_ell(g.num_vertices, g.dst, src_idx, g.val,
                                  BLOCK_B, dev)
    x = torch.from_numpy(rng.normal(size=n_pad).astype(np.float32)).to(dev)
    y = SPMV.spmv_block_ell(bv, bc, x)
    err = spmv_within_tol(y, SPMV.block_ell_matvec(bv, bc, x), "R-MAT-14")
    # the groups' partials are summed in a fixed order: a second call gives
    # the same bits
    assert_bitwise(SPMV.spmv_block_ell(bv, bc, x), y, "spmv_block_ell rerun")
    live = int((bc >= 0).sum())
    log(f"#   block-ELL R-MAT-{BLOCK_SCALE}: {live} nonzero blocks of "
        f"{BLOCK_B}x{BLOCK_B}, S = {bc.shape[1]}, bvals "
        f"{nbytes(bv) / 2 ** 30:.3f} GiB")
    # bytes this run needs: each nonzero block once, bcols, x, y
    moved = live * BLOCK_B * BLOCK_B * 4 + nbytes(bc, x, y)
    # library yardstick: one cuSPARSE CSR matrix-vector product of the
    # same matrix (built from the COO outside the timing)
    order = np.lexsort((src_idx, g.dst))
    crow = np.concatenate([[0], np.cumsum(np.bincount(g.dst,
                                                      minlength=n_pad))])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev), torch.from_numpy(src_idx[order])
        .to(dev), torch.from_numpy(g.val[order]).to(dev), (n_pad, n_pad),
        check_invariants=True)
    torch.testing.assert_close(csr @ x, y, rtol=1e-4, atol=1e-4)
    row = dict(
        max_abs_err=err, ms=timer.ms(lambda: SPMV.spmv_block_ell(bv, bc, x)),
        plain_ms=timer.ms(lambda: SPMV.block_ell_matvec(bv, bc, x)),
        bound_ms=bound_ms(moved), library_ms=timer.ms(lambda: csr @ x))
    log(f"#   spmv_block_ell R-MAT-{BLOCK_SCALE}: two calls bitwise equal")
    # a same-format yardstick: one BSR tensor of the live blocks (the same
    # bytes the kernel reads) times x; timed only, where PyTorch takes it
    live_rows = (bc >= 0).sum(dim=1)
    bsr = torch.sparse_bsr_tensor(
        torch.cat([live_rows.new_zeros(1), live_rows.cumsum(0)]),
        bc[bc >= 0].long(), bv[bc >= 0], (n_pad, n_pad),
        check_invariants=True)
    try:
        torch.testing.assert_close((bsr @ x[:, None])[:, 0], y, rtol=1e-4,
                                   atol=1e-4)
        row["library_bsr_ms"] = timer.ms(lambda: bsr @ x[:, None])
        log(f"#   BSR yardstick (torch.sparse_bsr_tensor @ x, "
            f"{nbytes(bsr.values()) / 1e6:.1f} MB of blocks): "
            f"{row['library_bsr_ms']:.4f} ms")
    except (RuntimeError, NotImplementedError) as e:
        row["library_bsr_ms"] = None
        log(f"#   BSR yardstick: PyTorch refuses BSR @ x on this card: "
            f"{str(e).splitlines()[0]}")
    del bsr
    return row


def phase_kernels(dev, timer):
    rng = np.random.default_rng(0)
    rows = {}
    for name, check in (("frontier_pop", check_frontier_pop),
                        ("queue_push_pop", check_queue_push_pop),
                        ("edge_scan_gather", check_edge_scan_gather),
                        ("edge_scan_stream", check_edge_scan_stream),
                        ("fold_scatter", check_fold_scatter),
                        ("fold_scatter_add", check_fold_scatter_add),
                        ("scatter_segments", check_scatter_segments),
                        ("spmv_block_ell", check_spmv_block_ell)):
        r = check(rng, dev, timer)
        torch.cuda.synchronize()
        rows[name] = r
        lib = "n/a" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        agree = ("within rtol = atol = 1e-4 of" if name == "spmv_block_ell"
                 else "bitwise (the turned queue below its count) equal to"
                 if name == "queue_push_pop" else
                 "bitwise (nb and w where jvalid holds) equal to"
                 if name.startswith("edge_scan") else "bitwise equal to")
        log(f"# kernel {name}: {agree} its plain version; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (bytes), library {lib}"
            + (f"; G = {r['G']}" if "G" in r else "")
            + (f"; {r['path']}" if "path" in r else ""))
        for c in r.get("calls", []):
            log(f"#   {c['call']} call {c['shape']}"
                + (f", G = {c['G']}" if "G" in c else "")
                + (f", {c['path']}" if "path" in c else "")
                + f": kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                f"bound {c['bound_ms']:.4f} ms"
                + (f" (whole {c['whole_bound_ms']:.4f} ms, live share "
                   f"{c['live_share']:.4f})" if "live_share" in c else "")
                + (f", staged windows' bound {c['staged_bound_ms']:.4f} ms"
                   if "staged_bound_ms" in c else "")
                + (f", library {c['library_ms']:.4f} ms ({c['library']})"
                   if "library" in c else "")
                + (f", copy_ {c['copy_ms']:.4f} ms" if "copy_ms" in c
                   else ""))
    return rows


# --------------------------------------------------------------------------
# The fused legs against their plain versions, inside engine runs
# --------------------------------------------------------------------------

def leg_index(name: str) -> int:
    """The leg a fused-leg wrapper runs: the digit its name ends with."""
    return int(name[-1])


def scan_words(recv, rv, e_chunk, tmpl, shard_T) -> int:
    """Distinct shard words the T2 lanes of these messages read: the
    staged windows when streamed, else the clamped lane indices (rows of
    serving lanes that share a shard row counted once)."""
    if tmpl.window:
        return stream_words(recv[..., 0], rv, e_chunk, tmpl.window, shard_T)
    local0 = torch.where(rv, recv[..., 0] % e_chunk, 0)
    j = torch.arange(tmpl.max_t2, device=rv.device, dtype=torch.int32)
    eidx = torch.clamp(local0[:, :, None] + j, max=e_chunk - 1)
    return shard_words(eidx, shard_T)


def leg_bytes(name: str, tmpl, ops, out, whole=False) -> int:
    """Bytes a fused leg must move on these operands: each input it reads
    once, each output once (a queue that the leg appends to in place: its
    count read and written and the rows appended; a queue turned keeping
    its live rows: the rows below the old count read, those below the new
    one written); the data-dependent reads as this call needs them: leg 0's
    f_pop vertex slots (deg and ptr_start, and the value where the payload
    reads it), the valid rows of the spill that a leg re-queues, the
    distinct shard words a scan leg's messages address (4 bytes each, 8
    where the emit reads the edge value), the two vertex words of each
    delivered wedge or close row, and at least one shard word per close
    row's search.  ``whole``: the bound of the earlier design, which copied
    or shifted those queues whole (every slot read and written)."""
    sh, st, new = ops[1], ops[2], out[0]
    small = nbytes(*tensors(out[1:]))
    if leg_index(name) == 0:  # its range queue turned keeping live rows
        rq, rq2 = st.queues[0], new.queues[0]
        slot = 12 if tmpl.payload in ("value", "value_over_deg") else 8
        queue = nbytes(rq.data, rq2.data) if whole else 12 * int(
            rq.count.sum() + rq2.count.sum())
        return (nbytes(st.frontier, st.net_pressure,
                       *(q.count for q in st.queues), new.frontier,
                       rq2.count)
                + queue + small + slot * st.frontier.shape[0] * tmpl.f_pop)
    recv, rv, sp, spv = ops[3:7]
    moved = (small + nbytes(*ops[3:]) - nbytes(sp)
             + int(spv.sum()) * 4 * sp.shape[2])
    for i, (q, q2) in enumerate(zip(st.queues, new.queues)):
        if q is q2:
            continue
        row = 4 * q.data.shape[2]
        if whole:
            moved += nbytes(*q, *q2)
        elif q2.data is q.data:  # appended in place: the counts and the rows
            moved += nbytes(q.count, q2.count) + row * int(
                (q2.count - q.count).sum())
        elif F.LIVE_TURN.get(name) == i:  # the live rows only
            moved += nbytes(q.count, q2.count) + row * int(
                q.count.sum() + q2.count.sum())
        else:
            moved += nbytes(*q, *q2)
    if name in ("fused_leg1", "fused_tri_leg1", "fused_tri_leg3"):
        word = 8 if tmpl.emit in ("plus_w", "times_w") and \
            name == "fused_leg1" else 4
        return moved + word * scan_words(recv, rv, sh.edge_dst.shape[1],
                                         tmpl, sh.edge_dst.shape[0])
    if name == "fused_tri_leg2":
        return moved + 8 * int(rv.sum())
    if name == "fused_tri_leg4":
        return moved + nbytes(st.acc, new.acc) + 12 * int(rv.sum())
    flags = "frontier" if tmpl.mode == "async" else "next_frontier"
    if name == "fused_kcore_leg2":
        return moved + nbytes(st.value, st.acc, getattr(st, flags),
                              new.value, new.acc, getattr(new, flags))
    if tmpl.fold == "min":
        return moved + nbytes(st.value, getattr(st, flags), new.value,
                              getattr(new, flags))
    return moved + nbytes(st.acc, new.acc)


EVERY_CHANNEL = "spills on every channel in one round"


def leg_split(name, tmpl, ops) -> int:
    """G, the blocks a tile of a fused leg shares its work over (the
    column split of kernel.py; one more block a tile appends, or takes
    the frontier in leg 0; two more for the wedge leg)."""
    st, dev = ops[2], ops[2].frontier.device
    T, v_chunk = st.frontier.shape
    if name in ("fused_leg2", "fused_kcore_leg2"):
        return K.device_split(T, v_chunk, dev).G
    if name in ("fused_leg1", "fused_tri_leg1", "fused_tri_leg3"):
        return F.scan_split(T, ops[3].shape[1], tmpl.max_t2, dev).G
    if name == "fused_tri_leg2":
        return F.wedge_split(T, ops[3].shape[1], dev).G
    if name == "fused_tri_leg4":
        return F.close_split(T, ops[3].shape[1], dev).G
    return F.leg0_split(T, st.queues[0].data.shape[1], dev)


def check_leg(name, tmpl, ops, got, want, where):
    """A fused leg's outputs against its plain stage's, by the kernels'
    contract (kernels/engine/fused.py ``contract``): what both define
    bitwise, and the kernel's popped message rows past the pop 0."""
    defined, past = F.contract(name, tmpl, ops[2], got)
    assert_bitwise(defined, F.contract(name, tmpl, ops[2], want)[0], where)
    assert not bool(past.any()), f"{where}: a popped message row past " \
        f"the pop is not 0"


class FusedCheck:
    """A context in which the engine's fused-leg wrappers also run each
    leg's plain version (the stage they are given) on the same operands,
    at the calls chosen below, and hold every output of the kernel against
    it bitwise.  ``every`` checks every call; otherwise the first two
    rounds, every ``period``-th round, each round whose spill-queue fill
    grew by a quarter over the last checked one, the first call of each
    leg with spills, and the first round with spills on every channel;
    ``only`` (a set of rounds, counted from 0) checks those rounds' calls
    and no other.  Records which edge cases the checked calls covered, and
    the operands of each wrapper's last checked call (for timing), and the
    paths (``path``) the checked launches took.  The comparison is the kernels'
    contract (:func:`check_leg`).  The plain stage runs after the kernel
    on the same operands: a leg of F.IN_PLACE has then appended its spills
    in place onto that queue, and the plain stage's copy of it plus the
    same rows at the same count is what the kernel returned, so the two
    still agree bit for bit; such a call is also checked to return the
    queue it was given (``data_ptr()``)."""

    def __init__(self, label, every=False, period=0, only=None):
        self.label, self.every, self.period = label, every, period
        self.only = only      # if given: check these rounds' calls, only
        self.round, self.fill = -1, 0
        self.this_round = False
        self.spilled = set()  # the legs that spilled this round
        self.checked = {}     # wrapper name: checked calls
        self.cover = set()
        self.last = {}        # wrapper name: its last checked call
        self.paths = set()    # (wrapper name, path) of the checked calls
        self.busy0 = None     # (name, call) of leg 0 on a live frontier

    def __enter__(self):
        self.saved = {k.__name__: k for k in F.KERNELS}
        for n, f in self.saved.items():
            setattr(F, n, functools.partial(self.call, n, f))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(F, n, f)

    def call(self, name, real, tmpl, plain, *ops):
        leg, st = leg_index(name), ops[2]
        check = self.every
        every_now = spilled = False
        if leg == 0:
            self.round += 1
            self.spilled = set()
            fill = max(int(q.count.max()) for q in st.queues[1:])
            grew = fill > 0 and fill >= 1.25 * max(self.fill, 1)
            if grew:
                self.fill = fill
            self.this_round = self.round < 2 or grew or bool(
                self.period and self.round % self.period == 0)
            if self.only is not None:
                self.this_round = self.round in self.only
            check = check or self.this_round
        else:
            spilled = bool(ops[6].any())
            if spilled:
                self.spilled.add(leg)
            every_now = len(self.spilled) == len(st.queues)
            check = (check or self.this_round or self.only is None and (
                (spilled and f"{name}: spills" not in self.cover)
                or (every_now and EVERY_CHANNEL not in self.cover)))
        got = real(tmpl, plain, *ops)
        if check:
            self.paths.add((name, F._WRAPPERS[name].path))
            if name in F.IN_PLACE:
                i = F.IN_PLACE[name]
                assert got[0].queues[i].data.data_ptr() == \
                    st.queues[i].data.data_ptr(), name
            check_leg(name, tmpl, ops, got, plain(*ops),
                      f"{self.label} {name} round {self.round}")
            self.checked[name] = self.checked.get(name, 0) + 1
            self.last[name] = (real, tmpl, plain, ops, got)
            if leg == 0 and not bool(st.frontier.any()):
                self.cover.add(f"{name}: empty frontier")
            elif leg == 0 and tmpl.policy == "traffic":
                self.busy0 = (name, self.last[name])
            elif leg == 0 and torch.equal(got[0].frontier, st.frontier):
                self.cover.add(f"{name}: pops nothing")
            elif spilled:
                self.cover.add(f"{name}: spills")
                if every_now:
                    self.cover.add(EVERY_CHANNEL)
        return got

    def report(self):
        log(f"#   {self.label}: fused legs held bitwise against their plain "
            f"versions at {self.checked} calls of {self.round + 1} rounds; "
            f"peak checked spill-queue fill {self.fill}; covered: "
            f"{sorted(self.cover)}; paths {sorted(map(str, self.paths))}")



def cap0_update_queue(st):
    """``st`` with an update queue of capacity 0 (the fifo_turn early out,
    src/repro/kernels/engine/kernel.py:109-112)."""
    rq, uq = st.queues
    empty = E.Queue(uq.data[:, :0].contiguous(), torch.zeros_like(uq.count))
    return st._replace(queues=(rq, empty))


def check_edge_operands(chk: FusedCheck, cap0_legs=()):
    """Edge cases no engine configuration reaches on its own, on captured
    operands: leg 0 with the fabric hot, so that the TSU grants the
    frontier source nothing and a live frontier pops nothing; the
    ``cap0_legs`` of a 2-channel program on a cap-0 update queue (which
    Program.validate refuses): every spill a drop, nothing replayed; on a
    4-channel program, leg 0 with the fabric cold and queue 2 over 3/4
    full on every other tile, so that the TSU there grants channels 0 and
    1 nothing and channels 2 and 3 their pops."""
    name, (real, tmpl, plain, ops0, _) = chk.busy0
    st = ops0[2]
    hot = st._replace(net_pressure=torch.full_like(st.net_pressure,
                                                   tmpl.plimit + 1))
    ops = (*ops0[:2], hot)
    got = real(tmpl, plain, *ops)
    check_leg(name, tmpl, ops, got, plain(*ops), f"{name} with the fabric hot")
    assert bool(st.frontier.any()) and torch.equal(got[0].frontier,
                                                   st.frontier)
    chk.cover.add(f"{name}: pops nothing")
    if len(st.queues) == 4:
        q1, q2, q3 = st.queues[1:]
        cap2, cap3 = q2.data.shape[1], q3.data.shape[1]
        jam = torch.arange(q2.count.shape[0], device=q2.count.device) \
            % 2 == 0
        queues = (st.queues[0], q1,
                  q2._replace(count=torch.where(
                      jam, 3 * cap2 // 4 + 1, q2.count).to(torch.int32)),
                  q3._replace(count=torch.clamp(q3.count,
                                                max=3 * cap3 // 4)))
        cold = st._replace(net_pressure=torch.zeros_like(st.net_pressure),
                           queues=queues)
        ops = (*ops0[:2], cold)
        got = real(tmpl, plain, *ops)
        check_leg(name, tmpl, ops, got, plain(*ops),
                  f"{name} with queue 2 congested")
        pops = got[4][jam]
        assert bool((pops[:, :2] == 0).all()) and \
            bool((pops[:, 2:] > 0).all()), pops.tolist()
        chk.cover.add(f"{name}: a congested queue downstream")
    for leg in cap0_legs:
        real, tmpl, plain, ops, _ = chk.last[leg]
        ops = (*ops[:2], cap0_update_queue(ops[2]), *ops[3:])
        got = real(tmpl, plain, *ops)
        check_leg(leg, tmpl, ops, got, plain(*ops), f"cap-0 update queue, {leg}")
    if cap0_legs:
        chk.cover.add("cap-0 update queue")


def time_legs(chk: FusedCheck, timer, where):
    """Kernel and plain times and the byte bounds of each leg, on the
    operands of its last checked call, in leg order: the kernel's time
    under the Timer's spin (``ms``) and under SHORT_SPIN_CYCLES
    (``short_spin_ms``), its wrapper's host time a call (``host_ms``), the
    bound of this design and the whole-capacity one of the earlier
    (``bound_whole_ms``),
    and, for a leg of F.LIVE_TURN, the live share of its turned queue (the
    rows below the old count over its capacity).  A leg of F.IN_PLACE
    appends onto the queue of those operands, which its checked call
    already did: re-running it writes the same rows again (the same bits),
    and the plain stage, run on the same operands, copies that queue and
    appends the same rows at the same count."""
    calls = []
    for name in sorted(chk.last, key=leg_index):
        real, tmpl, plain, ops, out = chk.last[name]
        live = None
        if name in F.LIVE_TURN:
            q = ops[2].queues[F.LIVE_TURN[name]]
            live = int(q.count.sum()) / max(q.data.shape[0] * q.data.shape[1],
                                            1)
        kernel = timer.reading(lambda: real(tmpl, plain, *ops))
        short = timer.reading(lambda: real(tmpl, plain, *ops),
                              SHORT_SPIN_CYCLES)
        calls.append(dict(
            kernel=name, call=where, template=dict(
                payload=tmpl.payload, emit=tmpl.emit, fold=tmpl.fold,
                k=tmpl.k, mode=tmpl.mode, policy=tmpl.policy,
                window=tmpl.window),
            G=leg_split(name, tmpl, ops), path=F._WRAPPERS[name].path,
            max_abs_err=0.0, ms=kernel["ms"], short_spin_ms=short["ms"],
            host_ms=kernel["host_ms"],
            plain_ms=timer.ms(lambda: plain(*ops)),
            bound_ms=bound_ms(leg_bytes(name, tmpl, ops, out)),
            bound_whole_ms=bound_ms(leg_bytes(name, tmpl, ops, out,
                                              whole=True)),
            live_share=live))
        c = calls[-1]
        log(f"# kernel {name} ({where}, G = {c['G']}, {c['path']}): bitwise "
            f"equal to its plain version by the legs' contract; kernel "
            f"{c['ms']:.4f} ms ({c['short_spin_ms']:.4f} under the short "
            f"spin; host {c['host_ms']:.4f} ms a call), plain "
            f"{c['plain_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ms (bytes; whole queues "
            f"{c['bound_whole_ms']:.4f} ms)"
            + ("" if live is None else f", live share of the turned queue "
               f"{live:.4f}") + ", library none")
    return calls


# --------------------------------------------------------------------------
# Phases 3 and 4: the engine
# --------------------------------------------------------------------------

def assert_stats_equal(a, b, where):
    for f, x, y in zip(a._fields, a, b):
        if f == "launches":
            continue
        bx = x.view(torch.int32) if x.dtype == torch.float32 else x
        by = y.view(torch.int32) if y.dtype == torch.float32 else y
        if not torch.equal(bx, by):
            raise AssertionError(f"Stats.{f} differs ({where}): "
                                 f"{x.tolist()} vs {y.tolist()}")


@functools.lru_cache(maxsize=None)
def rmat_graph(scale):
    """R-MAT-``scale`` (edge factor 10, seed 1), built once a run."""
    n, src, dst, val = rmat_edges(scale, edge_factor=10, seed=1)
    return CSRGraph.from_edges(n, src, dst, val)


def build_graph(scale, T, dev):
    g = rmat_graph(scale)
    return g, alg.prepare(g, T, "low_order", device=dev)


def reset_launches():
    for k in ALL_WRAPPERS:
        k.launches = 0


def read_launches() -> dict:
    return {k.__name__: k.launches for k in ALL_WRAPPERS}


def twin_apps(g, pg, gs, pgs, pgt, root, x):
    """name: (run(cfg) on the port, oracle, tolerance or None for exact)."""
    return {
        "bfs-bsp": (lambda c: alg.bfs(pg, root, dataclasses.replace(
            c, mode="bsp")), ref.bfs_ref(g, root), None),
        "sssp": (lambda c: alg.sssp(pg, root, c), ref.sssp_ref(g, root),
                 dict(rtol=1e-5, atol=0.0)),
        "wcc": (lambda c: alg.wcc(pgs, c), ref.wcc_ref(gs), None),
        "spmv": (lambda c: alg.spmv(pg, x, c),
                 ref.spmv_ref(g, x.astype(np.float64)),
                 dict(rtol=2e-4, atol=1e-4)),
        "pagerank": (lambda c: alg.pagerank(pg, iters=8, cfg=c),
                     ref.pagerank_ref(g, iters=8),
                     dict(rtol=2e-3, atol=1e-7)),
        **{f"kcore{k}-{mode}": (
            lambda c, k=k, mode=mode: alg.kcore(
                pgs, k, dataclasses.replace(c, mode=mode)),
            ref.kcore_ref(gs, k), None)
           for k in (2, 5) for mode in ("async", "bsp")},
        "triangles": (lambda c: alg.triangles(pgt, c),
                      ref.triangles_ref(gs, key=pgt.place), None),
    }


def check_values(got, want, tol, where):
    if tol is None:
        np.testing.assert_array_equal(got, want, err_msg=where)
        return
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all(), where
    np.testing.assert_allclose(got[finite], want[finite], err_msg=where,
                               **tol)


def phase_twin(dev):
    """The twin's runs, every unfused scan call held against its plain
    version by scan_contract; then the physical fabrics' runs."""
    with scan_check({}) as seen:
        twin_runs(dev)
    assert seen.get("edge_scan_gather", 0) > 0 and \
        seen.get("edge_scan_stream", 0) > 0, seen
    log(f"# engine twin: every unfused scan call bitwise its plain version "
        f"under scan_contract: {seen}")
    fabric_twin(dev)


def twin_runs(dev):
    g, pg = build_graph(10, 16, dev)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    small = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                 cap_route_update=32, cap_rangeq=128, cap_updq=4096)
    oracle = ref.bfs_ref(g, root)
    for knobs in (small, {}):
        res = {b: alg.bfs(pg, root, EngineConfig(backend=b, fuse=False,
                                                 **knobs))
               for b in ("torch", "kernels")}
        np.testing.assert_array_equal(res["torch"].values,
                                      res["kernels"].values)
        np.testing.assert_array_equal(res["kernels"].values, oracle)
        assert_stats_equal(res["torch"].stats, res["kernels"].stats,
                           "torch vs kernels")
        st = res["kernels"].stats
        assert int(st.drops) == 0
        assert int(st.launches) == 5 * int(st.rounds)
        log(f"# engine twin (scale 10, T=16, "
            f"{'small knobs' if knobs else 'default knobs'}): torch == "
            f"kernels bitwise, == oracle; rounds {int(st.rounds)}, spills "
            f"{st.spills.tolist()}")
    gs = alg.symmetrize(g)
    pgs = alg.prepare(gs, 16, device=dev)
    pgt = alg.prepare_triangles(gs, 16, device=dev)
    x = np.random.default_rng(3).normal(size=g.num_vertices) \
        .astype(np.float32)
    for name, (run, want, tol) in twin_apps(g, pg, gs, pgs, pgt, root,
                                            x).items():
        t0 = time.perf_counter()
        res = {b: run(EngineConfig(backend=b, fuse=False))
               for b in ("torch", "kernels")}
        np.testing.assert_array_equal(res["torch"].values,
                                      res["kernels"].values, err_msg=name)
        assert_stats_equal(res["torch"].stats, res["kernels"].stats, name)
        check_values(res["kernels"].values, want, tol, name)
        st = res["kernels"].stats
        assert int(st.drops) == 0, name
        assert int(st.launches) > 0 and int(res["torch"].stats.launches) \
            == 0, name
        log(f"# engine twin {name} (scale 10, T=16, default knobs, "
            f"unfused): torch == kernels bitwise, matches the oracle "
            f"({'exact' if tol is None else tol}); rounds {int(st.rounds)},"
            f" epochs {int(st.epochs)}, launches {int(st.launches)}; "
            f"{time.perf_counter() - t0:.1f} s for both backends")
    apps = twin_apps(g, pg, gs, pgs, pgt, root, x)
    apps["bfs"] = (lambda c: alg.bfs(pg, root, c), oracle, None)
    leaf = int(np.argmin(g.ptr[1:] - g.ptr[:-1]))  # no out-edges
    tight = dict(small, cap_route_range=2, cap_route_update=4)
    edge_cases = {
        "bfs-tight": (lambda c: alg.bfs(pg, root, dataclasses.replace(
            c, **tight)), oracle, None),
        "bfs-static": (lambda c: alg.bfs(pg, root, dataclasses.replace(
            c, policy="static", **tight)), oracle, None),
        "bfs-leaf": (lambda c: alg.bfs(pg, leaf, c), ref.bfs_ref(g, leaf),
                     None)}
    with FusedCheck("engine twin (scale 10, T=16)", every=True) as chk:
        for name in ("bfs", "bfs-bsp", "sssp", "wcc", "spmv", "pagerank",
                     *edge_cases):
            run, want, tol = apps.get(name) or edge_cases[name]
            twin_run(run, want, tol, f"{name} fused", dict(fuse=True), 3)
        check_edge_operands(chk, ("fused_leg1", "fused_leg2"))
    chk.report()
    missing = FUSED_EDGE_CASES - chk.cover
    assert not missing, f"fused-leg edge cases not reached: {missing}"
    # k-core's fused legs (the classic legs 0 and 1 with its codes, then its
    # threshold fold), resident and streamed, and tight queues for spills
    with FusedCheck("engine twin k-core (scale 10, T=16)",
                    every=True) as chk:
        for k in (2, 5):
            for mode in ("async", "bsp"):
                run, want, tol = apps[f"kcore{k}-{mode}"]
                for space in ("vmem", "hbm"):
                    st = twin_run(run, want, tol,
                                  f"kcore{k}-{mode} {space} fused",
                                  dict(fuse=True, edge_space=space), 3)
                    assert (int(st.hbm_windows) > 0) == (space == "hbm")
        run, want, tol = apps["kcore5-async"]
        twin_run(lambda c: run(dataclasses.replace(c, **tight)), want, tol,
                 "kcore5-tight fused", dict(fuse=True), 3)
        check_edge_operands(chk, ("fused_leg1", "fused_kcore_leg2"))
    chk.report()
    missing = KCORE_EDGE_CASES - chk.cover
    assert not missing, f"k-core fused-leg edge cases not reached: {missing}"
    # triangles' five legs; the default knobs spill on all four channels
    with FusedCheck("engine twin triangles (scale 10, T=16)",
                    every=True) as chk:
        run, want, tol = apps["triangles"]
        st = twin_run(run, want, tol, "triangles fused", dict(fuse=True), 5)
        assert bool((st.spills > 0).all()), st.spills.tolist()
        check_edge_operands(chk)
    chk.report()
    missing = TRIANGLES_EDGE_CASES - chk.cover
    assert not missing, f"triangles fused-leg edge cases not reached: " \
        f"{missing}"
    # the streamed edge shard, unfused (edge_scan_stream) and fused
    for name in ("bfs", "sssp", "spmv"):
        run, want, tol = apps[name]
        for fuse in (False, True):
            with FusedCheck(f"engine twin {name} hbm", every=True) as chk:
                st = twin_run(run, want, tol, f"{name} hbm fuse={fuse}",
                              dict(fuse=fuse, edge_space="hbm"),
                              3 if fuse else 5)
            assert int(st.hbm_windows) > 0 and int(st.hbm_edges) == \
                128 * int(st.hbm_windows)
            if fuse:
                chk.report()
    check_past_staging(dev, g, gs, pg, pgs, root, x)


@contextlib.contextmanager
def unfused_paths(seen: set):
    """Record in ``seen`` the (wrapper, path) of every launch of the
    unfused kernels that have two paths, and the most fresh rows a
    ``queue_push_pop`` launch took, at the names the engine calls them
    by."""
    from repro_torch.core import program as PROG
    # (module, name the engine calls, the wrapper whose path it notes)
    spots = ((E, "queue_push_pop", K.queue_push_pop),
             (PROG, "fold_scatter", K.fold_scatter_add))
    saved = [getattr(mod, n) for mod, n, _ in spots]

    def spy(fn, noted):
        def call(*a, **kw):
            noted.path = None
            out = fn(*a, **kw)
            if noted.path is not None and a[0].device.type == "cuda":
                seen.add((noted.__name__, noted.path))
                if noted is K.queue_push_pop:
                    seen.add(("queue_push_pop", f"{a[2].shape[1]} rows"))
            return out
        return call

    for (mod, n, noted), fn in zip(spots, saved):
        setattr(mod, n, spy(fn, noted))
    try:
        yield
    finally:
        for (mod, n, _), fn in zip(spots, saved):
            setattr(mod, n, fn)


@contextlib.contextmanager
def scan_check(seen: dict):
    """Within the block, every CUDA call of the unfused T2 scans, at the
    names the engine calls them by, is also held against its plain version
    by ``scan_contract``; ``seen`` counts the calls checked, by scan."""
    from repro_torch.core import program as PROG
    saved = {n: getattr(PROG, n)
             for n in ("edge_scan_gather", "edge_scan_stream")}

    def spy(name, fn):
        plain = K.segment_stream if name == "edge_scan_stream" \
            else K.segment_gather

        def call(*a):
            out = fn(*a)
            if a[0].device.type == "cuda":
                max_abs_err(K.scan_contract(out), K.scan_contract(plain(*a)))
                seen[name] = seen.get(name, 0) + 1
            return out
        return call

    for n, fn in saved.items():
        setattr(PROG, n, spy(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(PROG, n, fn)


def check_past_staging(dev, g, gs, pg, pgs, root, x):
    """The configurations whose kernels stage more than shared memory
    holds, which the card refused before: each one end to end, "torch"
    against "kernels" (values and Stats bitwise, every fused-leg call held
    against its plain stage), with the path each kernel took: 16,448 rows
    a tile into the add folds (T = 257, the default cap_route_update of
    64), leg 0 and the wedge leg at f_pop = r_pop = 512, 16,640 fresh rows
    into the wedge leg and the unfused range2 turn (triangles on
    symmetrized R-MAT-8), streamed windows of 4,096, and stagings past
    STAGE_SMEM_MAX bytes in the device scratch: 65,536 frontier pops into
    leg 0 and the unfused range-queue turn, 16,384 popped ranges into the
    triangles' leg 0 and wedge leg."""
    oracle = ref.bfs_ref(g, root)
    pg257 = alg.prepare(g, 257, "low_order", device=dev)
    pgs257 = alg.prepare(gs, 257, device=dev)
    # triangles on symmetrized R-MAT-8: a tenth of the twin's rounds
    n8, src8, dst8, val8 = rmat_edges(8, edge_factor=10, seed=1)
    gs8 = alg.symmetrize(CSRGraph.from_edges(n8, src8, dst8, val8))
    pgt = alg.prepare_triangles(gs8, 16, device=dev)
    knobs257 = dict(cap_route_range=2, max_t2=8)
    tri_want = ref.triangles_ref(gs8, key=pgt.place)
    spmv_tol = dict(rtol=2e-4, atol=1e-4)
    runs = [
        # (label, run(cfg), oracle, tol, knobs, paths wanted)
        ("spmv T=257", lambda c: alg.spmv(pg257, x, c),
         ref.spmv_ref(g, x.astype(np.float64)), spmv_tol, knobs257,
         {("fused_leg2", "2 chunks"), ("fold_scatter_add", "2 chunks")}),
        ("kcore5 T=257", lambda c: alg.kcore(pgs257, 5, c),
         ref.kcore_ref(gs, 5), None, knobs257,
         {("fused_kcore_leg2", "2 chunks")}),
        ("triangles 16,640 wedges", lambda c: alg.triangles(pgt, c),
         tri_want, None, dict(cap_route_update=1040),
         {("fused_tri_leg4", F.CLOSE_PATH), ("queue_push_pop", "16640 rows"),
          ("queue_push_pop", "shared memory")}),
        ("bfs pops 512", lambda c: alg.bfs(pg, root, c), oracle, None,
         dict(f_pop=512, r_pop=512), {("fused_leg0", "shared memory")}),
        ("triangles pops 512", lambda c: alg.triangles(pgt, c), tri_want,
         None, dict(f_pop=512, r_pop=512),
         {("fused_tri_leg0", "shared memory"),
          ("fused_tri_leg2", "shared memory")}),
        ("bfs window 4096", lambda c: alg.bfs(pg, root, c), oracle, None,
         dict(edge_space="hbm", hbm_window=4096),
         {("fused_leg1", "device window")}),
        ("kcore5 window 4096", lambda c: alg.kcore(pgs, 5, c),
         ref.kcore_ref(gs, 5), None,
         dict(edge_space="hbm", hbm_window=4096),
         {("fused_leg1", "device window")}),
        ("bfs pops 65,536", lambda c: alg.bfs(pg, root, c), oracle, None,
         dict(f_pop=65536, cap_rangeq=262144),
         {("fused_leg0", "device scratch"),
          ("queue_push_pop", "65536 rows"),
          ("queue_push_pop", "device scratch")}),
        ("triangles pops 16,384", lambda c: alg.triangles(pgt, c), tri_want,
         None, dict(r_pop=16384, cap_rangeq=65536),
         {("fused_tri_leg0", "device scratch"),
          ("fused_tri_leg2", "device scratch")}),
    ]
    for label, run, want, tol, knobs, wanted in runs:
        seen = set()
        for fuse in (True, False):
            tri = label.startswith("triangles")
            per_round = (5 if tri else 3) if fuse else (8 if tri else 5)
            with FusedCheck(f"past staging: {label}", every=True) as chk, \
                    unfused_paths(seen):
                twin_run(lambda c: run(dataclasses.replace(c, **knobs)),
                         want, tol, f"{label} fuse={fuse}",
                         dict(fuse=fuse), per_round)
            seen |= chk.paths
        missing = wanted - seen
        assert not missing, f"{label}: paths not taken: {missing} ({seen})"
        log(f"# past staging {label}: fused and unfused bitwise equal to "
            f"the torch backend and their plain stages; paths "
            f"{sorted(p for p in seen if p[1] not in (None, 'resident'))}")


FUSED_EDGE_CASES = {"fused_leg0: empty frontier", "fused_leg0: pops nothing",
                    "fused_leg1: spills", "fused_leg2: spills",
                    EVERY_CHANNEL, "cap-0 update queue"}
KCORE_EDGE_CASES = {"fused_leg0: empty frontier", "fused_leg0: pops nothing",
                    "fused_leg1: spills", "fused_kcore_leg2: spills",
                    EVERY_CHANNEL, "cap-0 update queue"}
TRIANGLES_EDGE_CASES = {"fused_tri_leg0: empty frontier",
                        "fused_tri_leg0: pops nothing",
                        "fused_tri_leg0: a congested queue downstream",
                        *(f"fused_tri_leg{i}: spills" for i in range(1, 5))}


def twin_run(run, want, tol, name, kernels_kw, per_round):
    """One workload on "torch" and on "kernels" with ``kernels_kw``:
    values and Stats bitwise equal but ``launches`` (``per_round`` kernel
    calls a round on "kernels"), values against the oracle, no drops."""
    t0 = time.perf_counter()
    base = EngineConfig(**{k: v for k, v in kernels_kw.items()
                           if k != "fuse"})
    res = {"torch": run(dataclasses.replace(base, backend="torch")),
           "kernels": run(dataclasses.replace(base, **kernels_kw))}
    np.testing.assert_array_equal(res["torch"].values,
                                  res["kernels"].values, err_msg=name)
    assert_stats_equal(res["torch"].stats, res["kernels"].stats, name)
    check_values(res["kernels"].values, want, tol, name)
    st = res["kernels"].stats
    assert int(st.drops) == 0, name
    assert int(st.launches) == per_round * int(st.rounds), name
    log(f"# engine twin {name} (scale 10, T=16): torch == kernels bitwise, "
        f"matches the oracle; rounds {int(st.rounds)}, spills "
        f"{st.spills.tolist()}, launches {int(st.launches)}, hbm windows "
        f"{int(st.hbm_windows)}; {time.perf_counter() - t0:.1f} s")
    return st


UNFUSED_ROUND = {"frontier_pop": 1, "queue_push_pop": 2,
                 "edge_scan_gather": 1}
FUSED_ROUND = {"fused_leg0": 1, "fused_leg1": 1, "fused_leg2": 1}


def drive(fn, smi, what, per_round):
    """Run one path with every launch counter at 0 just before it;
    ``per_round`` names the kernels each round must launch, and how often.
    Returns (result, the counters just after, engine wall seconds)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = res.stats
    rounds = int(st.rounds)
    assert int(st.drops) == 0, (what, int(st.drops))
    calls = sum(per_round.values())
    assert int(st.launches) == calls * rounds, (what, int(st.launches),
                                                rounds)
    want = dict.fromkeys(launches, 0)
    want.update({k: n * rounds for k, n in per_round.items()})
    assert launches == want, (what, launches, want)
    edges = int(st.edges_scanned)
    log(f"# path {what}: drops 0; rounds {rounds}, engine wall "
        f"{wall:.3f} s ({1e3 * wall / rounds:.3f} ms/round, {calls} kernel "
        f"calls a round), edges scanned {edges}, "
        f"{edges / wall / 1e6:.3f} M traversed edges/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, kernel "
        f"launches { {k: v for k, v in launches.items() if v} }; card {smi}")
    return res, launches, wall


def check_spmv(g, res, x, what, planted=True):
    """SpMV against the float64 oracle: every edge scanned and folded
    once, and within the reference's tolerance (rtol 2e-4, atol 1e-4,
    set on scale-8 graphs) plus the oracle's float32 error limit
    (``spmv_f32_bound``), which a median-size hub term lost or doubled
    must exceed."""
    deg = g.ptr[1:] - g.ptr[:-1]
    want = ref.spmv_ref(g, x.astype(np.float64))
    assert int(res.stats.edges_scanned) == g.num_edges
    assert int(res.stats.updates_applied) == g.num_edges
    ref_tol = 2e-4 * np.abs(want) + 1e-4
    bound = ref.spmv_f32_bound(g, x.astype(np.float64))
    limit = ref_tol + bound
    has = bound > 0   # vertices with in-edges
    src = np.repeat(np.arange(g.num_vertices), deg)
    prod = g.val * x[src]
    y32 = np.zeros(g.num_vertices, np.float32)
    np.add.at(y32, g.dst, prod)
    for who, y in (("engine", res.values), ("numpy float32", y32)):
        err = np.abs(y - want)
        log(f"# {what} {who} vs the float64 oracle: max abs err "
            f"{err.max():.3e}; {int((err > ref_tol).sum())} of "
            f"{g.num_vertices} vertices outside rtol 2e-4 / atol 1e-4; "
            f"max err / error scale "
            f"{(err[has] / bound[has]).max() * ref.SPMV_F32_C:.4f}; "
            f"max err / limit {(err / limit).max():.4e}")
    err = np.abs(res.values - want)
    assert (err <= limit).all(), int((err > limit).sum())
    if not planted:
        return
    hub = int(np.argmax(np.bincount(g.dst, minlength=g.num_vertices)))
    terms = np.sort(np.abs(prod[g.dst == hub]))
    t_med = terms[len(terms) // 2]
    planted = {"lost": res.values[hub] - t_med,
               "doubled": res.values[hub] + t_med}
    log(f"# {what} planted at hub {hub} ({len(terms)} terms, median |t| "
        f"{t_med:.4e}, limit {limit[hub]:.4e} = tolerance "
        f"{ref_tol[hub]:.4e} + float32 limit {bound[hub]:.4e}): " + ", ".join(
            f"{k} term reads {abs(v - want[hub]) / limit[hub]:.3f} x the "
            f"limit" for k, v in planted.items()))
    assert all(abs(v - want[hub]) > limit[hub] for v in planted.values())


def legs_at_main_shapes(label, run, cfg, timer, scale=MAIN_SCALE,
                        spilling=("fused_leg1", "fused_leg2")):
    """The fused legs of the first CHECK_ROUNDS[label] rounds of a main
    path, held against their plain versions (FusedCheck, and every 50th
    round), then timed.  Async runs must have checked spills in the
    ``spilling`` legs; a BSP run's first epoch is the root's single range
    task, one message a round, so it spills nothing in these rounds."""
    with FusedCheck(f"R-MAT-{scale} {label}", period=50) as chk:
        run(dataclasses.replace(cfg, max_rounds=CHECK_ROUNDS[label]))
    chk.report()
    if cfg.mode == "async":
        want = {f"{n}: spills" for n in spilling}
        assert want <= chk.cover, (want, chk.cover)
    return time_legs(chk, timer, label)


def phase_main(dev, smi, timer, with_hbm):
    t0 = time.perf_counter()
    g, pg = build_graph(MAIN_SCALE, MAIN_T, dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    deg = g.ptr[1:] - g.ptr[:-1]
    assert (pg.v_chunk, pg.e_chunk) == (MAIN_V_CHUNK, MAIN_E_CHUNK), \
        (pg.v_chunk, pg.e_chunk)
    assert int(np.argmax(deg)) == MAIN_ROOT
    log(f"# main path graph: R-MAT-{MAIN_SCALE} V={g.num_vertices} "
        f"E={g.num_edges} T={MAIN_T} v_chunk={pg.v_chunk} "
        f"e_chunk={pg.e_chunk}, root {MAIN_ROOT} (out-degree "
        f"{int(deg[MAIN_ROOT])}); host build {t_graph:.1f} s")

    t0 = time.perf_counter()
    oracle = ref.bfs_ref(g, MAIN_ROOT)
    log(f"# BFS oracle: {time.perf_counter() - t0:.1f} s, "
        f"{int(np.isfinite(oracle).sum())} reachable vertices")
    paths = {}
    bfs, paths["BFS"], wall = drive(
        lambda: alg.bfs(pg, MAIN_ROOT, MAIN_FUSED), smi,
        f"BFS R-MAT-{MAIN_SCALE} (fused)", FUSED_ROUND)
    np.testing.assert_array_equal(bfs.values, oracle)
    log("# main path BFS: hop counts equal to the oracle")

    x = spmv_x(g.num_vertices)
    assert int((deg > 0).sum()) == SPMV_SOURCES
    res, paths["SpMV"], _ = drive(
        lambda: alg.spmv(pg, x, SPMV_FUSED), smi,
        f"SpMV R-MAT-{MAIN_SCALE} (fused, cap_updq {SPMV_CFG.cap_updq})",
        FUSED_ROUND)
    check_spmv(g, res, x, "main path SpMV")
    log("# main path SpMV: within rtol 2e-4 / atol 1e-4 plus the float32 "
        "error limit of the oracle at every vertex; a lost or doubled "
        "median hub term exceeds it")

    calls = []
    for label, run, cfg in (
            ("BFS", lambda c: alg.bfs(pg, MAIN_ROOT, c), MAIN_FUSED),
            ("SpMV", lambda c: alg.spmv(pg, x, c), SPMV_FUSED),
            ("BFS-BSP", lambda c: alg.bfs(pg, MAIN_ROOT, c),
             dataclasses.replace(MAIN_FUSED, mode="bsp"))):
        calls += legs_at_main_shapes(label, run, cfg, timer)
    scans = []
    if with_hbm:
        paths["BFS-hbm"], scans = phase_hbm(pg, smi, timer)
        calls += legs_at_main_shapes(
            "BFS-hbm", lambda c: alg.bfs(pg, MAIN_ROOT, c), HBM_CFG, timer)
    return paths, calls, scans


@contextlib.contextmanager
def scan_operands(round_no: int, kept: list,
                  name: str = "edge_scan_gather"):
    """Copies, into ``kept``, of the scan operands of round ``round_no``
    of the run inside, as the engine makes them: those of the unfused
    scan ``name``, or with ``name="fused_leg1"`` the shard and the
    delivered range messages of fused leg 1 (its window and max_t2 with
    them).  Each entry: (operands, max_t2, window or None)."""
    from repro_torch.core import program as PROG
    mod = F if name == "fused_leg1" else PROG
    real = getattr(mod, name)
    calls = [0]

    def spy(*a):
        if calls[0] == round_no:
            if name == "fused_leg1":
                tmpl, sh, recv, rv = a[0], a[3], a[5], a[6]
                ops = (sh.edge_dst, sh.edge_val, recv[..., 0], recv[..., 1],
                       rv)
                kept.append(([x.clone().contiguous() for x in ops],
                             tmpl.max_t2, tmpl.window or None))
            else:
                kept.append(([x.clone() for x in a[:5]], a[5],
                             a[6] if len(a) > 6 else None))
        calls[0] += 1
        return real(*a)

    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, real)


def scan_at(kept, label, timer, smi) -> dict:
    """The scan of one engine round's operands (``scan_operands``),
    checked by scan_contract and timed, with its live share logged."""
    assert len(kept) == 1, len(kept)
    args, max_t2, window = kept[0]
    rec = scan_record(label, args, max_t2, timer,
                      *(() if window is None else (window,)))
    log(f"# {'edge_scan_stream' if window else 'edge_scan_gather'} at "
        f"{label} {rec['shape']}: scan_contract bitwise; kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.6f} ms (whole {rec['whole_bound_ms']:.4f} ms, "
        f"live share {rec['live_share']:.6f}), library "
        f"{rec['library_ms']:.4f} ms; card {smi}")
    return rec


# the round of the fused streamed BFS on R-MAT-22 whose leg-1 operands the
# streamed scan is checked and timed at (of 20,545 rounds); the streamed
# run stops after HBM_ROUNDS rounds, held to a resident run of the same
# depth (cut from the whole run for the script's time, PERF.md §4)
HBM_SCAN_ROUND, HBM_ROUNDS = 1000, 1100


def phase_hbm(pg, smi, timer):
    """Fused BFS on the main partition with the edge shard streamed and the
    tile's scratchpad budget under the resident footprint, HBM_ROUNDS
    rounds, against a resident run of the same depth; then
    edge_scan_stream at the operands of one of its leg-1 calls."""
    prog = as_program(BFS)

    def scratchpad(cfg):
        return sum(b for _, sp, b in prog.tile_decls(
            cfg, MAIN_T, pg.e_chunk, pg.v_chunk) if sp == "vmem")

    resident = dataclasses.replace(HBM_CFG, edge_space="vmem")
    log(f"# hbm phase: tile scratchpad budget {HBM_VMEM_LIMIT} B; declared "
        f"{scratchpad(resident)} B with the shard resident, "
        f"{scratchpad(HBM_CFG)} B with it streamed")
    assert scratchpad(HBM_CFG) <= HBM_VMEM_LIMIT < scratchpad(resident)
    try:
        alg.bfs(pg, MAIN_ROOT, resident)
    except ValueError as e:
        assert "over budget" in str(e), e
        log(f"# hbm phase: edge_space='vmem' refused at validation: {e}")
    else:
        raise AssertionError("edge_space='vmem' ran over its budget")
    kept = []
    depth = dict(max_rounds=HBM_ROUNDS)
    with scan_operands(HBM_SCAN_ROUND, kept, "fused_leg1"):
        res, launches, _ = drive(
            lambda: alg.bfs(pg, MAIN_ROOT, dataclasses.replace(HBM_CFG,
                                                               **depth)),
            smi, f"BFS R-MAT-{MAIN_SCALE} (fused, hbm, {HBM_ROUNDS} rounds)",
            FUSED_ROUND)
    vmem = alg.bfs(pg, MAIN_ROOT, dataclasses.replace(MAIN_FUSED, **depth))
    np.testing.assert_array_equal(res.values, vmem.values)
    st = res.stats
    assert int(st.rounds) == HBM_ROUNDS
    for f in ("rounds", "msgs", "spills", "edges_scanned",
              "updates_applied", "drops", "flits_per_link"):
        assert torch.equal(getattr(st, f), getattr(vmem.stats, f)), f
    window = 128  # resolve_window(0, max_t2 = 32)
    assert int(st.hbm_windows) > 0
    assert int(st.hbm_edges) == window * int(st.hbm_windows)
    log(f"# hbm phase: after {HBM_ROUNDS} rounds the values, rounds, msgs, "
        f"spills, edges, updates, drops and link flits equal a resident "
        f"fused run's of the same depth; "
        f"hbm_windows {int(st.hbm_windows)}, hbm_edges "
        f"{int(st.hbm_edges)}")
    assert kept and kept[0][2] == window, kept[0][1:] if kept else None
    return launches, [scan_at(
        kept, f"R-MAT-{MAIN_SCALE} streamed BFS round {HBM_SCAN_ROUND} "
        f"(fused leg 1's operands), window {window}", timer, smi)]


# --------------------------------------------------------------------------
# The physical NoCs: the twin's fabric runs and phase 5b (``noc``)
# --------------------------------------------------------------------------

def assert_rings_equal(a, b, where):
    """Two flight-recorder rings bitwise on every field but ``launches``
    (each path's own per-round tally)."""
    assert a.cursor == b.cursor, (where, a.cursor, b.cursor)
    for f in a._fields[1:]:
        if f == "launches":
            continue
        assert_bitwise(getattr(a, f), getattr(b, f), f"{where}: ring {f}")


def flits_by_class(stats, net) -> np.ndarray:
    """(N_LINK_CLASSES,) int64 flits of a run on each link class."""
    flits = stats.flits_per_link.cpu().numpy().astype(np.int64)
    return np.bincount(net.link_classes, weights=flits,
                       minlength=N_LINK_CLASSES).astype(np.int64)


def fabric_runs(run, want, tol, name, kw, paths=("unfused", "fused"),
                chk=None):
    """``run`` on "torch" and on "kernels" along ``paths`` (unfused:
    ``fuse=False``; fused under the FusedCheck ``chk``), with the
    EngineConfig fields ``kw``: values and Stats bitwise but
    ``launches`` (5 calls a round unfused, 3 fused), values against the
    oracle, no drops.  Returns {path: result}."""
    t0 = time.perf_counter()
    base = EngineConfig(**kw)
    res = {"torch": run(dataclasses.replace(base, backend="torch"))}
    for path in paths:
        fuse = path == "fused"
        with (chk if fuse and chk is not None else contextlib.nullcontext()):
            res[path] = run(dataclasses.replace(base, fuse=fuse))
    for path in paths:
        where = f"{name} {path}"
        np.testing.assert_array_equal(res["torch"].values,
                                      res[path].values, err_msg=where)
        assert_stats_equal(res["torch"].stats, res[path].stats, where)
        st = res[path].stats
        assert int(st.launches) == (3 if path == "fused" else 5) * int(
            st.rounds), where
    check_values(res["torch"].values, want, tol, name)
    st = res["torch"].stats
    assert int(st.drops) == 0, name
    log(f"# engine twin {name} (scale {FABRIC_SCALE}, T=16): torch == "
        f"kernels {' and '.join(paths)} bitwise, matches the oracle; rounds "
        f"{int(st.rounds)}, spills {st.spills.tolist()}, max link "
        f"occupancy {int(st.max_link_occupancy)}, die crossings "
        f"{st.die_crossings.tolist()}; {time.perf_counter() - t0:.1f} s")
    return res


def fabric_twin(dev):
    """The physical fabrics on R-MAT-FABRIC_SCALE over 16 tiles (4 x 4):
    BFS on each of TWIN_FABRICS at link_cap 1, "torch" against "kernels"
    unfused and fused (fused legs held against their plain stages at the
    FusedCheck's rounds: the legs see spills S = N + T * capacity rows
    wide); SSSP and PageRank (the add fold) on the torus and hier 2x2 at
    link_cap 2, fused; the trace on against off for one fused run; and
    the die-local criterion: on uncapped hier 2x2 links the die-local
    placement carries fewer DIE-class flits than the flat one."""
    g = rmat_graph(FABRIC_SCALE)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    oracle = ref.bfs_ref(g, root)
    parts = {s: alg.prepare(g, 16, s, dies=(2, 2), device=dev)
             for s in ("low_order", "low_order_dielocal")}
    fused_bfs, cover = {}, set()
    for name, (fabric, scheme) in TWIN_FABRICS.items():
        pg = parts[scheme]
        with FusedCheck(f"engine twin BFS {name}",
                        period=FABRIC_CHECK_PERIOD) as chk:
            res = fabric_runs(lambda c: alg.bfs(pg, root, c), oracle, None,
                              f"bfs {name} link_cap 1",
                              dict(link_cap=1, **fabric), chk=chk)
        chk.report()
        cover |= chk.cover
        fused_bfs[name] = res["fused"]
    # legs 1 and 2 were held against their plain stages on spills S =
    # N + T * capacity rows wide
    assert {"fused_leg1: spills", "fused_leg2: spills"} <= cover, cover
    x = np.random.default_rng(3).normal(size=g.num_vertices) \
        .astype(np.float32)
    for name in ("torus", "hier 2x2"):
        fabric, scheme = TWIN_FABRICS[name]
        pg = parts[scheme]
        for app, run, want, tol in (
                ("sssp", lambda c: alg.sssp(pg, root, c),
                 ref.sssp_ref(g, root), dict(rtol=1e-5, atol=0.0)),
                ("pagerank", lambda c: alg.pagerank(
                    pg, iters=FABRIC_PR_ITERS, cfg=c),
                 ref.pagerank_ref(g, iters=FABRIC_PR_ITERS),
                 dict(rtol=2e-3, atol=1e-7))):
            with FusedCheck(f"engine twin {app} {name}",
                            period=FABRIC_CHECK_PERIOD) as chk:
                fabric_runs(run, want, tol, f"{app} {name} link_cap 2",
                            dict(link_cap=2, **fabric), ("fused",), chk)
            chk.report()
    # the flight recorder reads, never writes: trace on == trace off
    name = TRACE_TWIN
    fabric, scheme = TWIN_FABRICS[name]
    traced = alg.bfs(parts[scheme], root, EngineConfig(
        link_cap=1, trace=True, trace_rounds=65536, **fabric))
    off = fused_bfs[name]
    np.testing.assert_array_equal(off.values, traced.values)
    assert_stats_equal(off.stats, traced.stats, "trace on against off")
    assert torch.equal(off.stats.launches, traced.stats.launches)
    tr = TR.trace_arrays(traced.trace)
    n = int(traced.stats.rounds)
    assert tr["n_recorded"] == tr["n_seen"] == n
    assert (tr["launches"] == 3).all()
    net = make_network(EngineConfig(**fabric), 16)
    np.testing.assert_array_equal(tr["link_cls"].sum(0),
                                  flits_by_class(traced.stats, net))
    log(f"# engine twin trace, BFS {name} link_cap 1 fused: values and "
        f"Stats (launches included) bitwise the trace-off run's; {n} "
        f"rounds recorded, flits per link class {tr['link_cls'].sum(0)}")
    # the die-local criterion of tests/test_hier.py, on the card
    cfg = EngineConfig(link_cap=0, **TWIN_FABRICS["hier 2x2"][0])
    net = make_network(cfg, 16)
    die, share = {}, {}
    for scheme, pg in parts.items():
        res = alg.bfs(pg, root, cfg)
        np.testing.assert_array_equal(res.values, oracle)
        assert int(res.stats.drops) == 0
        die[scheme] = int(flits_by_class(res.stats, net)[CLASS_DIE])
        dh = res.stats.die_crossings.cpu().numpy().astype(np.int64)
        share[scheme] = dh[1:].sum() / dh.sum()
    assert die["low_order_dielocal"] < die["low_order"], die
    assert share["low_order_dielocal"] < share["low_order"], share
    log(f"# engine twin die-local criterion (hier 2x2, uncapped, fused): "
        f"DIE-class flits {die['low_order_dielocal']} die-local < "
        f"{die['low_order']} flat, injections crossing a die "
        f"{share['low_order_dielocal']:.4f} < {share['low_order']:.4f}; "
        f"both == oracle, no drops")


def round_profile(pg, cfg, at: int, n: int, comm=None,
                  root=MAIN_ROOT, host_top: int = 0) -> dict:
    """Device ms a round of rounds ``at .. at + n - 1`` of BFS from
    ``root`` on ``pg`` under ``cfg`` (torch.profiler; the rounds before
    run unprofiled, as run_engine runs them), and of it the routes' (the
    NoC backend's ``route`` calls, as tools/port_round_profile.py
    attributes them) and the NCCL kernels'; ``comm`` is LocalComm over the
    partition's tiles unless given (phase spmd: AxisComm of one tile over
    the whole one-tile partition).  With ``host_top``, the next n rounds'
    wall ms a round unprofiled, and the ``host_top`` Python functions
    that take the most host time of the n after them (cProfile, own time
    a round)."""
    from torch.profiler import ProfilerActivity, profile
    from tools.port_round_profile import RouteRanges, device_us
    comm = comm or LocalComm(pg.T, pg.device)
    prog = as_program(BFS)
    shard = E.GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)
    value, frontier = alg.init_min_state(pg, [root])
    st = E.init_state(comm, cfg, pg.v_chunk, value, frontier, prog)
    rnd = E.make_round(comm, RouteRanges(make_network(cfg, pg.T)), cfg,
                       prog, pg.e_chunk, pg.v_chunk, shard)
    stats = E.zero_stats(cfg, pg.T, prog, pg.device)
    tbuf = TR.zero_trace(cfg, pg.T, prog, pg.device) if cfg.trace else None
    zf = torch.zeros((), dtype=torch.float32, device=pg.device)
    kcomp = (zf, zf)
    for r in range(at):
        st, stats, kcomp, tbuf, p = rnd(st, stats, kcomp, tbuf, r)
        assert int(p) > 0, r
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in range(at, at + n):
            st, stats, kcomp, tbuf, p = rnd(st, stats, kcomp, tbuf, r)
            assert int(p) > 0, r
    total, by_name, counts = device_us(prof)
    nccl = sum(us for k, us in by_name.items() if "nccl" in k.lower())
    # the collectives the host called (ProcessGroupNCCL's "nccl:" ranges)
    calls = [e for e in prof.events() if e.name.startswith("nccl:")
             and e.device_type != torch.autograd.DeviceType.CUDA]
    out = dict(device_ms=total / 1e3 / n,
               route_ms=counts["route_us"] / 1e3 / n,
               kernels=counts["kernels"] / n, aten_ops=counts["aten_ops"] / n,
               nccl_ms=nccl / 1e3 / n, collectives=len(calls) / n,
               nccl_host_ms=sum(e.cpu_time_total for e in calls) / 1e3 / n)
    if host_top:
        import cProfile
        import pstats

        def rounds(first):
            nonlocal st, stats, kcomp, tbuf
            for r in range(first, first + n):
                st, stats, kcomp, tbuf, p = rnd(st, stats, kcomp, tbuf, r)
                assert int(p) > 0, r

        t0 = time.perf_counter()
        rounds(at + n)
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3 / n
        prof = cProfile.Profile()
        prof.runcall(rounds, at + 2 * n)
        own = pstats.Stats(prof).stats  # func: (cc, nc, tottime, ...)
        top = sorted(own.items(), key=lambda kv: -kv[1][2])[:host_top]
        out["host_top"] = [(f"{f[2]} ({Path(f[0]).name}:{f[1]})",
                            v[2] * 1e3 / n, v[1] / n) for f, v in top]
    return out


def phase_noc(dev, smi, timer):
    """The physical NoC with the rmat-hier preset's fabric and placement
    (hier, 2 x 2 dies of 4 x 4 meshes, die-local placement) on 64 tiles.
    (a) Fused BFS from MAIN_ROOT on R-MAT-NOC_SCALE, uncapped links,
    queues NOC_CAPS, the flight recorder on: hop counts equal to the
    oracle, no drops, each fused leg once a round, the ring unwrapped and
    its timeline on Stats.cycles bitwise, its link-class and message
    series summed equal to the Stats, every injection in both
    histograms; device ms a round over a profiled window, beside the
    ideal crossbar's on the same partition.  (b) The main path's R-MAT-22
    under the same placement and fabric at link_cap 1 for
    NOC_STRESS_ROUNDS rounds, "torch" against "kernels" fused: values,
    Stats and rings bitwise but ``launches``, link occupancy within its
    cap, the drops of both; round NOC_CHECK_ROUND's fused legs held
    against their plain stages and timed."""
    g = rmat_graph(NOC_SCALE)
    pg = alg.prepare(g, MAIN_T, NOC_PLACEMENT, dies=NOC_DIES, device=dev)
    assert pg.edge_mode == "die_aligned", pg.edge_mode
    oracle = ref.bfs_ref(g, MAIN_ROOT)
    net = make_network(NOC_CFG, MAIN_T)
    log(f"# noc (a): R-MAT-{NOC_SCALE} (V={g.num_vertices} "
        f"E={g.num_edges}) over T={MAIN_T} (8 x 8), {NOC_PLACEMENT} over "
        f"{NOC_DIES[0]} x {NOC_DIES[1]} dies, edge mode {pg.edge_mode}: "
        f"v_chunk={pg.v_chunk} e_chunk={pg.e_chunk}; queues {NOC_CAPS}")
    paths = {}
    what = (f"BFS R-MAT-{NOC_SCALE} (fused, hier {NOC_DIES[0]}x"
            f"{NOC_DIES[1]} mesh base, {NOC_PLACEMENT}, uncapped links, "
            f"trace on)")
    res, paths["BFS hier"], wall = drive(
        lambda: alg.bfs(pg, MAIN_ROOT, NOC_CFG), smi, what, FUSED_ROUND)
    peak = torch.cuda.max_memory_allocated()
    np.testing.assert_array_equal(res.values, oracle)
    st = res.stats
    rounds = int(st.rounds)
    tr = TR.trace_arrays(res.trace)
    assert tr["n_seen"] == tr["n_recorded"] == rounds, \
        (tr["n_seen"], rounds)  # the ring did not wrap
    rec = TR.reconcile_cycles(res.trace, float(st.cycles))
    assert rec["exact"], rec
    cls = flits_by_class(st, net)
    np.testing.assert_array_equal(tr["link_cls"].sum(0), cls)
    np.testing.assert_array_equal(tr["msgs"].sum(0), st.msgs.cpu().numpy())
    assert int(st.die_crossings.sum()) == int(st.hop_histogram.sum())
    die_share = cls[CLASS_DIE] / max(cls.sum(), 1)
    log(f"# noc BFS: hop counts equal to the oracle; ring of {rounds} "
        f"rounds unwrapped, cycle timeline exact ({rec['last_total']:.0f}); "
        f"flits per class {cls.tolist()} (DIE share {die_share:.4f}) equal "
        f"to the summed link_cls series; msgs {st.msgs.tolist()} equal to "
        f"the summed msgs series; die crossings {st.die_crossings.tolist()}"
        f", hop histogram sum {int(st.hop_histogram.sum())}; wall "
        f"{1e3 * wall / rounds:.3f} ms/round; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; card {smi}")
    prof = {}
    ideal = dataclasses.replace(NOC_CFG, noc="ideal", trace=False)
    for label, cfg in (("hier", NOC_CFG), ("ideal", ideal)):
        prof[label] = p = round_profile(pg, cfg, NOC_PROFILE_AT,
                                        NOC_PROFILE_ROUNDS)
        assert p["device_ms"] > 0, f"the profiler saw no device time: {p}"
        log(f"# noc profile {label} (R-MAT-{NOC_SCALE}, rounds "
            f"{NOC_PROFILE_AT}..{NOC_PROFILE_AT + NOC_PROFILE_ROUNDS - 1}, "
            f"same partition): device {p['device_ms']:.3f} ms/round, routes "
            f"{p['route_ms']:.3f} ms/round (share "
            f"{p['route_ms'] / p['device_ms']:.3f}), {p['kernels']:.1f} "
            f"kernels and {p['aten_ops']:.1f} PyTorch operators a round; "
            f"card {smi}")
    # (b): R-MAT-22 at link_cap 1, "torch" against "kernels" fused, round
    # NOC_CHECK_ROUND's legs held against their plain stages
    t0 = time.perf_counter()
    g22 = rmat_graph(MAIN_SCALE)
    pg22 = alg.prepare(g22, MAIN_T, NOC_PLACEMENT, dies=NOC_DIES, device=dev)
    log(f"# noc (b): R-MAT-{MAIN_SCALE} over T={MAIN_T}, {NOC_PLACEMENT}, "
        f"edge mode {pg22.edge_mode}: v_chunk={pg22.v_chunk} "
        f"e_chunk={pg22.e_chunk}, tile budget {NOC_VMEM_LIMIT} B")
    reset_launches()
    stress = {"torch": alg.bfs(pg22, MAIN_ROOT, dataclasses.replace(
        NOC_STRESS, backend="torch"))}
    assert read_launches() == dict.fromkeys(read_launches(), 0)
    with FusedCheck(f"noc stress R-MAT-{MAIN_SCALE}",
                    only={NOC_CHECK_ROUND}) as chk:
        stress["kernels"] = alg.bfs(pg22, MAIN_ROOT, NOC_STRESS)
    paths["BFS hier stress"] = read_launches()
    chk.report()
    a, b = stress["torch"], stress["kernels"]
    np.testing.assert_array_equal(a.values, b.values)
    assert_stats_equal(a.stats, b.stats, "noc stress")
    assert_rings_equal(a.trace, b.trace, "noc stress")
    assert int(b.stats.rounds) == NOC_STRESS_ROUNDS
    want = dict.fromkeys(paths["BFS hier stress"], 0)
    want.update({k: NOC_STRESS_ROUNDS for k in FUSED_ROUND})
    assert paths["BFS hier stress"] == want, paths["BFS hier stress"]
    occ = int(b.stats.max_link_occupancy)
    assert occ <= NOC_STRESS.link_cap * 2, occ  # the program's two legs
    assert set(chk.checked) == set(FUSED_ROUND), chk.checked
    log(f"# noc stress (R-MAT-{MAIN_SCALE}, link_cap {NOC_STRESS.link_cap}, "
        f"{NOC_STRESS_ROUNDS} rounds): torch == kernels fused bitwise "
        f"(values, Stats and rings but launches); max link occupancy {occ}"
        f"; drops {int(a.stats.drops)} on both; spills "
        f"{b.stats.spills.tolist()}; {time.perf_counter() - t0:.1f} s")
    calls = time_legs(chk, timer, f"noc stress round {NOC_CHECK_ROUND}")
    # what phase place starts from: (a)'s run and (b)'s partition and ring
    obs = dict(g=g, pg=pg, res=res, wall=wall, g22=g22, pg22=pg22,
               ring22=b.trace)
    return paths, calls, dict(rounds=rounds, wall_ms=1e3 * wall / rounds,
                              peak_gib=peak / 2 ** 30, die_share=die_share,
                              drops_stress=int(a.stats.drops), **{
                                  f"{k}_{m}": v for k, p in prof.items()
                                  for m, v in p.items()}), obs


# --------------------------------------------------------------------------
# Phase place: adaptive placement
# --------------------------------------------------------------------------

def busy_share_max(trace) -> float:
    """The hottest tile's share of the ring's busy cycles (1 / T is
    perfect balance)."""
    busy = PL.score_tiles(trace)
    return float(busy.max() / busy.sum()) if busy.sum() > 0 else 0.0


def noc_observation(dev, smi):
    """What phase place starts from when phase noc did not run: noc (a)'s
    traced BFS on its partition, and noc (b)'s R-MAT-22 partition and
    ring ("kernels", fused).  Returns (observation, launches by path)."""
    paths = {}
    g = rmat_graph(NOC_SCALE)
    pg = alg.prepare(g, MAIN_T, NOC_PLACEMENT, dies=NOC_DIES, device=dev)
    res, paths["BFS hier (observation)"], wall = drive(
        lambda: alg.bfs(pg, MAIN_ROOT, NOC_CFG), smi,
        f"BFS R-MAT-{NOC_SCALE} (fused, hier, {NOC_PLACEMENT}, trace on; "
        f"noc (a)'s run)", FUSED_ROUND)
    g22 = rmat_graph(MAIN_SCALE)
    pg22 = alg.prepare(g22, MAIN_T, NOC_PLACEMENT, dies=NOC_DIES, device=dev)
    reset_launches()
    ring22 = alg.bfs(pg22, MAIN_ROOT, NOC_STRESS).trace
    paths["BFS hier stress (observation)"] = read_launches()
    return dict(g=g, pg=pg, res=res, wall=wall, g22=g22, pg22=pg22,
                ring22=ring22), paths


def place_between_queries(obs, smi):
    """(a): plan from noc (a)'s ring within PLACE_BUDGET, apply, BFS from
    the same root again, price the move.  Values bitwise the unmigrated
    run's and the oracle's, no drops, three launches a round, the
    migration counters set, ``energy_pj`` within 1e-5 of the host oracle.
    Printed, not gated: pairs by reason, DIE-class flits and the hottest
    tile's busy share before and after, the plan's and the apply's host
    ms, rounds, wall and device ms a round."""
    g, pg0, res0 = obs["g"], obs["pg"], obs["res"]
    T = pg0.T
    cfg = dataclasses.replace(NOC_CFG, adapt_budget=PLACE_BUDGET)
    td = PL.cfg_tile_die(cfg, T)
    net = make_network(cfg, T)
    t0 = time.perf_counter()
    plan = PL.plan_from_trace(pg0, cfg, res0.trace)
    plan_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    pg1 = PL.apply_plan(g, pg0, plan, tile_die=td)
    torch.cuda.synchronize()
    apply_ms = 1e3 * (time.perf_counter() - t0)
    res1, launches, wall = drive(
        lambda: alg.bfs(pg1, MAIN_ROOT, cfg), smi,
        f"BFS R-MAT-{NOC_SCALE} migrated ({plan.num_pairs} pairs; fused, "
        f"hier, trace on)", FUSED_ROUND)
    np.testing.assert_array_equal(res1.values, res0.values)
    np.testing.assert_array_equal(res1.values, ref.bfs_ref(g, MAIN_ROOT))
    st = PL.price_migration(res1.stats, pg0, plan, T, params=cfg.perf,
                            tile_die=td)
    moved = int(st.migrated_vertices)
    assert moved == plan.moved_vertices(pg0) > 0, moved
    assert float(st.migration_cycles) > 0, float(st.migration_cycles)
    want = PM.energy_from_totals(st, cfg.perf, net, T)
    np.testing.assert_allclose(float(st.energy_pj), want, rtol=1e-5)
    die = [PM.flits_by_class(s, net)["die"] for s in (res0.stats, st)]
    share = [busy_share_max(r.trace) for r in (res0, res1)]
    rounds = [int(r.stats.rounds) for r in (res0, res1)]
    prof = round_profile(pg1, cfg, NOC_PROFILE_AT, NOC_PROFILE_ROUNDS)
    reasons = {k: plan.reason.count(k) for k in ("die", "bal")}
    log(f"# place (a) between queries (R-MAT-{NOC_SCALE}, T={T}, hier "
        f"2x2, {NOC_PLACEMENT}, budget {PLACE_BUDGET}): plan of "
        f"{plan.num_pairs} pairs {reasons}, {moved} vertices moved, "
        f"migration {float(st.migration_cycles):.0f} cycles "
        f"{float(st.migration_pj):.0f} pJ; e_chunk {pg0.e_chunk} -> "
        f"{pg1.e_chunk}; values bitwise the unmigrated run's and the "
        f"oracle's, energy_pj {float(st.energy_pj):.1f} against the "
        f"oracle's {want:.1f}; DIE-class flits {die[0]} -> {die[1]}, "
        f"busy_share_max {share[0]:.4f} -> {share[1]:.4f}, rounds "
        f"{rounds[0]} -> {rounds[1]}; host: plan {plan_ms:.1f} ms, "
        f"apply_plan {apply_ms:.1f} ms; rerun wall "
        f"{1e3 * wall / rounds[1]:.3f} ms/round (before "
        f"{1e3 * obs['wall'] / rounds[0]:.3f}), device "
        f"{prof['device_ms']:.3f} ms/round (rounds {NOC_PROFILE_AT}.."
        f"{NOC_PROFILE_AT + NOC_PROFILE_ROUNDS - 1}); card {smi}")
    return launches, dict(pairs=plan.num_pairs, reasons=reasons,
                          moved=moved, die_flits=die, busy_share_max=share,
                          rounds=rounds, plan_ms=plan_ms, apply_ms=apply_ms,
                          wall_ms=1e3 * wall / rounds[1],
                          device_ms=prof["device_ms"])


def place_epochs(obs, dev, smi):
    """(b): adaptive_pagerank over PLACE_PR_EPOCHS epochs, a plan every
    PLACE_PR_EVERY from the last epoch's ring, against plain pagerank over
    the same epochs and config: values within fig15's tolerance (rtol
    1e-6, atol 1e-12), at least one plan applied, the placement-free
    counters (edges scanned, updates applied, delivered updates) equal."""
    if PLACE_PR_SCALE == NOC_SCALE:
        g, pg = obs["g"], obs["pg"]
    else:
        g = rmat_graph(PLACE_PR_SCALE)
        pg = alg.prepare(g, MAIN_T, NOC_PLACEMENT, dies=NOC_DIES,
                         device=dev)
    budget = g.num_vertices // 8
    cfg = dataclasses.replace(NOC_CFG, adapt=True,
                              adapt_every=PLACE_PR_EVERY,
                              adapt_budget=budget)
    what = (f"PageRank R-MAT-{PLACE_PR_SCALE} {PLACE_PR_EPOCHS} epochs "
            f"(fused, hier, {NOC_PLACEMENT}, trace on)")
    twin, paths = {}, {}
    twin["plain"], paths["PageRank hier"], wall0 = drive(
        lambda: alg.pagerank(pg, iters=PLACE_PR_EPOCHS, cfg=NOC_CFG), smi,
        what, FUSED_ROUND)
    out = {}

    def adaptive():
        out["res"], out["pg"], out["plans"] = PL.adaptive_pagerank(
            g, pg, iters=PLACE_PR_EPOCHS, cfg=cfg, params=cfg.perf)
        return out["res"]

    twin["adaptive"], paths["PageRank hier adaptive"], wall1 = drive(
        adaptive, smi, f"adaptive {what}, a plan every {PLACE_PR_EVERY}",
        FUSED_ROUND)
    a, b = twin["plain"], twin["adaptive"]
    np.testing.assert_allclose(b.values, a.values, rtol=1e-6, atol=1e-12)
    plans = out["plans"]
    assert plans, "no plan applied"
    for f in ("edges_scanned", "updates_applied"):
        assert int(getattr(a.stats, f)) == int(getattr(b.stats, f)), f
    assert int(a.stats.msgs[-1]) == int(b.stats.msgs[-1])
    st = b.stats
    err = float(np.abs(b.values - a.values).max())
    log(f"# place (b) epoch boundaries: adaptive_pagerank within rtol "
        f"1e-6 of plain pagerank (max abs diff {err:.3e}), {len(plans)} "
        f"plans of {[p.num_pairs for p in plans]} pairs, "
        f"{int(st.migrated_vertices)} vertices moved, "
        f"{float(st.migration_cycles):.0f} cycles; edges "
        f"{int(st.edges_scanned)}, updates {int(st.updates_applied)} and "
        f"delivered updates {int(st.msgs[-1])} equal; rounds "
        f"{int(a.stats.rounds)} plain, {int(st.rounds)} adaptive; wall "
        f"{wall0:.3f} s plain, {wall1:.3f} s adaptive; card {smi}")
    return paths, dict(plans=len(plans), rounds=[int(a.stats.rounds),
                                                 int(st.rounds)],
                       wall_s=[wall0, wall1])


def pow2_degree_graph(g: CSRGraph) -> CSRGraph:
    """tests/test_place.py's dyadic instance: each vertex's out-edges cut
    to the largest power of two <= its degree, unit weights."""
    deg = g.ptr[1:] - g.ptr[:-1]
    keep = np.zeros(g.num_edges, bool)
    for v in range(g.num_vertices):
        d = int(deg[v])
        if d:
            keep[g.ptr[v]:g.ptr[v] + (1 << (d.bit_length() - 1))] = True
    src = np.repeat(np.arange(g.num_vertices), deg)[keep]
    return CSRGraph.from_edges(g.num_vertices, src, g.dst[keep],
                               np.ones(int(keep.sum()), np.float32),
                               dedup=False)


def assert_plans_equal(a, b, where):
    np.testing.assert_array_equal(a.pairs, b.pairs, err_msg=where)
    assert a.reason == b.reason, where


def place_twin(dev):
    """(c): "torch" against "kernels" through a migration, on
    R-MAT-PLACE_TWIN_SCALE over PLACE_TWIN_T tiles, hier 2x2, die-local;
    "kernels" fused (every leg call held against its plain stage) and
    unfused (every scan call by scan_contract): BFS on a partition
    migrated by a plan from its own ring; the dyadic adaptive PageRank;
    static serving with a plan after every batch.  Values, every Stats
    field but ``launches`` and the plans' pairs bitwise; each served query
    bitwise its solo run on the starting partition.  Returns the kernels'
    launches."""
    t0 = time.perf_counter()
    g = rmat_graph(PLACE_TWIN_SCALE)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    base = EngineConfig(trace=True, trace_rounds=4096,
                        adapt_budget=g.num_vertices // 8,
                        **PLACE_TWIN_FABRIC)
    td = PL.cfg_tile_die(base, PLACE_TWIN_T)
    pg0 = alg.prepare(g, PLACE_TWIN_T, NOC_PLACEMENT, dies=NOC_DIES,
                      device=dev)
    paths = ("torch", "fused", "unfused")
    seen, legs = {}, set()

    def cfg_of(path, **kw):
        if path == "torch":
            return dataclasses.replace(base, backend="torch", **kw)
        return dataclasses.replace(base, fuse=path == "fused", **kw)

    def each(run, where):
        """{path: run(path)}, the kernels' calls held as above."""
        out = {}
        for path in paths:
            if path == "fused":
                with FusedCheck(f"place (c) {where}", every=True) as chk:
                    out[path] = run(path)
                legs.update(chk.checked)
            else:
                with scan_check(seen):
                    out[path] = run(path)
        return out

    def same(out, where, fields=lambda r: (r.values, r.stats)):
        for path in paths[1:]:
            (va, sa), (vb, sb) = fields(out["torch"]), fields(out[path])
            np.testing.assert_array_equal(va, vb, err_msg=where)
            assert_stats_equal(sa, sb, f"{where} {path}")

    reset_launches()
    # BFS: a plan from each path's own ring, then the run on its migration
    obs = each(lambda p: alg.bfs(pg0, root, cfg_of(p)), "BFS observation")
    same(obs, "BFS observation")
    plans = {p: PL.plan_from_trace(pg0, base, r.trace)
             for p, r in obs.items()}
    assert plans["torch"].num_pairs > 0
    for p in paths[1:]:
        assert_plans_equal(plans["torch"], plans[p], f"BFS plan {p}")
    pg1 = PL.apply_plan(g, pg0, plans["torch"], tile_die=td)
    mig = each(lambda p: alg.bfs(pg1, root, cfg_of(p)), "BFS migrated")
    same(mig, "BFS migrated")
    for p, per_round in (("fused", 3), ("unfused", 5)):
        assert int(mig[p].stats.launches) == \
            per_round * int(mig[p].stats.rounds), p
    np.testing.assert_array_equal(mig["torch"].values, obs["torch"].values)
    np.testing.assert_array_equal(mig["torch"].values, ref.bfs_ref(g, root))
    # the dyadic adaptive PageRank of tests/test_place.py
    gd = pow2_degree_graph(g)
    pgd = alg.prepare(gd, PLACE_TWIN_T, NOC_PLACEMENT, dies=NOC_DIES,
                      device=dev)
    pr = each(lambda p: PL.adaptive_pagerank(
        gd, pgd, damping=PLACE_PR_DAMPING, iters=PLACE_PR_TWIN_EPOCHS,
        cfg=cfg_of(p, adapt=True, adapt_every=1,
                   adapt_budget=PLACE_TWIN_BUDGET)), "PageRank")
    same(pr, "PageRank", lambda r: (r[0].values, r[0].stats))
    res_t, _, plans_t = pr["torch"]
    assert plans_t, "no plan applied"
    for p in paths[1:]:
        assert len(pr[p][2]) == len(plans_t), p
        for a, b in zip(plans_t, pr[p][2]):
            assert_plans_equal(a, b, f"PageRank plan {p}")
    plain = alg.pagerank(pgd, damping=PLACE_PR_DAMPING,
                         iters=PLACE_PR_TWIN_EPOCHS, cfg=cfg_of("torch"))
    np.testing.assert_allclose(res_t.values, plain.values, rtol=1e-6,
                               atol=1e-12)
    pr_bitwise = bool(np.array_equal(res_t.values, plain.values))
    # static serving with a plan after every batch
    deg = g.ptr[1:] - g.ptr[:-1]
    srcs = np.flatnonzero(deg > 0)[:PLACE_SERVE_SOURCES].tolist()
    reps = each(lambda p: SERVE.Frontend(
        pg0, app="bfs", cfg=cfg_of(p, adapt=True, adapt_every=1,
                                   adapt_budget=PLACE_TWIN_BUDGET),
        width=PLACE_SERVE_WIDTH, graph=g).serve(srcs), "serving")
    rep_t = reps["torch"]
    assert rep_t.migrated_vertices > 0 and rep_t.drops == 0
    for p in paths[1:]:
        rep = reps[p]
        assert rep.row() == rep_t.row(), p
        assert (rep.total_cycles, rep.total_energy_pj) == \
            (rep_t.total_cycles, rep_t.total_energy_pj), p
        for a, b in zip(rep_t.records, rep.records):
            assert (a.qid, a.source, a.complete_cycle, a.rounds, a.edges) \
                == (b.qid, b.source, b.complete_cycle, b.rounds, b.edges), p
            np.testing.assert_array_equal(a.values, b.values)
    for rec in rep_t.records:
        solo = alg.bfs(pg0, rec.source, cfg_of("torch"))
        np.testing.assert_array_equal(rec.values, solo.values)
    assert legs == set(FUSED_ROUND), legs
    if pg0.device.type == "cuda":
        assert set(seen) == {"edge_scan_gather"}, seen
    launches = read_launches()
    log(f"# place (c) twin (R-MAT-{PLACE_TWIN_SCALE}, T={PLACE_TWIN_T}, "
        f"hier 2x2, {NOC_PLACEMENT}): torch == kernels fused and unfused "
        f"bitwise (values, Stats but launches, plans) through a migration, "
        f"fused legs {sorted(legs)} held against their plain stages at "
        f"every call, scans {seen} by scan_contract: BFS plan of "
        f"{plans['torch'].num_pairs} pairs, e_chunk {pg0.e_chunk} -> "
        f"{pg1.e_chunk}, rounds {int(obs['torch'].stats.rounds)} -> "
        f"{int(mig['torch'].stats.rounds)}; dyadic adaptive PageRank "
        f"({PLACE_PR_TWIN_EPOCHS} epochs) {len(plans_t)} plans, "
        f"{int(res_t.stats.migrated_vertices)} moved, bitwise the "
        f"unmigrated run: {pr_bitwise}; static serving of {len(srcs)} "
        f"sources through {PLACE_SERVE_WIDTH} lanes, "
        f"{rep_t.migrated_vertices} vertices moved between batches, each "
        f"query bitwise its solo run on the starting partition; kernel "
        f"launches { {k: v for k, v in launches.items() if v} }; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def place_full_size(obs, smi):
    """(d): the planner and the migrator on noc (b)'s R-MAT-22 partition
    and its ring, at the rmat-hier-adapt preset's budget: the host
    seconds of each step, the old and new ``e_chunk``, and
    ``Program.validate``'s verdict on the new shape at NOC_VMEM_LIMIT.
    No device rerun (ROADMAP.md §3)."""
    g, pg = obs["g22"], obs["pg22"]
    td = PL.cfg_tile_die(NOC_STRESS, pg.T)
    secs = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    busy = step("score_tiles", lambda: PL.score_tiles(obs["ring22"]))
    edges = step("placed_edges", lambda: PL.placed_edges(pg))
    step("vertex_die_affinity",
         lambda: PL.vertex_die_affinity(pg, td, edges))
    del edges
    plan = step("migration_plan", lambda: PL.migration_plan(
        pg, busy, budget=PLACE_MAIN_BUDGET, tile_die=td))
    pg1 = step("apply_plan", lambda: PL.apply_plan(g, pg, plan, tile_die=td))
    torch.cuda.synchronize()
    assert plan.moved_vertices(pg) <= PLACE_MAIN_BUDGET
    try:
        as_program(BFS).validate(NOC_STRESS, pg1.T, pg1.e_chunk,
                                 pg1.v_chunk)
        verdict = "fits"
    except ValueError as e:   # the verdict is printed, not gated
        verdict = f"refused: {e}"
    reasons = {k: plan.reason.count(k) for k in ("die", "bal")}
    log(f"# place (d) full size (V={g.num_vertices}, E={g.num_edges}, "
        f"T={pg.T}, hier 2x2, "
        f"{NOC_PLACEMENT}, ring of {NOC_STRESS_ROUNDS} rounds, budget "
        f"{PLACE_MAIN_BUDGET}): plan of {plan.num_pairs} pairs {reasons}, "
        f"{plan.moved_vertices(pg)} vertices moved; host s "
        f"{ {k: round(v, 3) for k, v in secs.items()} }; e_chunk "
        f"{pg.e_chunk} -> {pg1.e_chunk}; Program.validate at a tile budget "
        f"of {NOC_VMEM_LIMIT} B: {verdict}; card {smi}")
    return dict(secs=secs, pairs=plan.num_pairs, e_chunk=[pg.e_chunk,
                                                          pg1.e_chunk],
                verdict=verdict)


def phase_place(dev, smi, obs=None):
    """Adaptive placement: (a) between queries, (b) at epoch boundaries,
    (c) the twin through a migration, (d) the host side at R-MAT-22.
    ``obs``: phase noc's runs, else run here."""
    paths = {}
    if obs is None:
        obs, paths = noc_observation(dev, smi)
    paths["place BFS migrated"], a = place_between_queries(obs, smi)
    pr_paths, b = place_epochs(obs, dev, smi)
    paths.update(pr_paths)
    paths["place twin"] = place_twin(dev)
    d = place_full_size(obs, smi)
    return paths, dict(a=a, b=b, d=d)


# --------------------------------------------------------------------------
# Phase serve: query lanes
# --------------------------------------------------------------------------

def serve_sources(g, seed, n, extra=()):
    """``n`` distinct sources drawn from ``seed`` among the vertices with
    out-edges (``extra`` excluded)."""
    deg = g.ptr[1:] - g.ptr[:-1]
    pool = np.setdiff1d(np.flatnonzero(deg > 0), np.asarray(extra, int))
    return [int(s) for s in np.random.default_rng(seed).choice(
        pool, size=n, replace=False)]


def assert_lane_is(res, lane, values, stats, where):
    """Lane ``lane`` of a BatchResult: values and every Stats field,
    launches included, bitwise those given (a solo run's, or a lane's)."""
    np.testing.assert_array_equal(res.values[lane], values, err_msg=where)
    for f, a, b in zip(stats._fields, res.stats, stats):
        assert_bitwise(a[lane], b, f"{where}: Stats.{f}")


def lane_profile(pg, cfg, sources, at: int, n: int) -> dict:
    """Device ms a shared round of rounds ``at .. at + n - 1`` of the
    batch (torch.profiler; the rounds before run unprofiled)."""
    from torch.profiler import ProfilerActivity, profile
    from tools.port_round_profile import device_us
    prog = as_program(BFS)
    shard = E.GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)
    value, frontier = SERVE.batch_min_state(pg, sources)
    carry = SERVE.local_lanes_call(
        prog, dataclasses.replace(cfg, max_rounds=at), pg.T, pg.e_chunk,
        pg.v_chunk, shard, value, frontier)
    assert carry.rounds == at and bool((carry.pending > 0).any())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry = SERVE.local_lanes_segment(
            prog, dataclasses.replace(cfg, max_rounds=at + n), pg.T,
            pg.e_chunk, pg.v_chunk, shard, carry, stop_on_finish=False)
    assert carry.rounds == at + n
    total, _, counts = device_us(prof)
    return dict(device_ms=total / 1e3 / n, kernels=counts["kernels"] / n,
                aten_ops=counts["aten_ops"] / n)


def serve_static(g, pg, solo, smi, timer, seed):
    """(a): SERVE_B BFS lanes on R-MAT-SERVE_SCALE.  Lane 0 is the solo
    run bitwise (launches included), lane SERVE_B - 2 lane 0's, every lane
    the oracle's; no drops; each fused leg launched once a shared round
    for the whole batch; the legs held against their plain stages and
    timed at these shapes; queries/s, wall and device ms a shared round,
    peak memory."""
    sources = ([MAIN_ROOT] + serve_sources(g, seed, SERVE_RANDOM,
                                           [MAIN_ROOT]) + [MAIN_ROOT, -1])
    assert len(sources) == SERVE_B
    what = (f"serve (a) BFS R-MAT-{SERVE_SCALE} B={SERVE_B} lanes "
            f"{sources} (fused)")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = SERVE.multi_source(pg, "bfs", sources, MAIN_FUSED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    st = res.stats
    lane_rounds = st.rounds.tolist()
    rounds = res.total_rounds
    assert rounds == max(lane_rounds), (rounds, lane_rounds)
    assert st.drops.tolist() == [0] * SERVE_B, st.drops.tolist()
    assert st.launches.tolist() == [3 * r for r in lane_rounds]
    want = dict.fromkeys(launches, 0)
    want.update({k: n * rounds for k, n in FUSED_ROUND.items()})
    assert launches == want, (launches, want)
    assert_lane_is(res, 0, solo.values, solo.stats,
                   f"{what}: lane 0 against the solo run")
    last = SERVE_B - 2
    assert_lane_is(res, last, res.values[0],
                   E.Stats(*(x[0] for x in st)), f"{what}: lane {last}")
    pad = SERVE_B - 1
    assert np.isinf(res.values[pad]).all() and lane_rounds[pad] == 0
    assert int(res.done_round[pad]) == 0
    t_or = time.perf_counter()
    for lane, s in enumerate(sources[1:last], start=1):
        np.testing.assert_array_equal(res.values[lane], ref.bfs_ref(g, s),
                                      err_msg=f"{what}: lane {lane}")
    t_or = time.perf_counter() - t_or
    queries = SERVE_B - 1
    solo_ms = solo.wall_ms
    log(f"# path {what}: every lane equal to its oracle (the {last - 1} "
        f"drawn in {t_or:.1f} s), lane 0 bitwise the solo run (every "
        f"Stats field, launches included), lane {last} bitwise lane 0, "
        f"padding lane born finished; drops 0; shared rounds {rounds} "
        f"(lane rounds {lane_rounds}; sequential {res.seq_rounds}, "
        f"{res.seq_rounds / rounds:.3f} x); each leg kernel launched once a "
        f"shared round ({ {k: v for k, v in launches.items() if v} }); "
        f"wall {wall:.3f} s, {queries / wall:.4f} queries/s, "
        f"{1e3 * wall / rounds:.3f} ms a shared round (solo BFS "
        f"{solo_ms:.3f} ms a round); peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; card {smi}")
    prof = lane_profile(pg, MAIN_FUSED, sources, SERVE_PROFILE_AT,
                        SERVE_PROFILE_ROUNDS)
    assert prof["device_ms"] > 0, f"the profiler saw no device time: {prof}"
    solo_prof = round_profile(pg, MAIN_FUSED, SERVE_PROFILE_AT,
                              SERVE_PROFILE_ROUNDS)
    log(f"# serve (a) profile (rounds {SERVE_PROFILE_AT}.."
        f"{SERVE_PROFILE_AT + SERVE_PROFILE_ROUNDS - 1}): device "
        f"{prof['device_ms']:.3f} ms a shared round of {SERVE_B} lanes, "
        f"{prof['kernels']:.1f} kernels and {prof['aten_ops']:.1f} PyTorch "
        f"operators a round; solo BFS {solo_prof['device_ms']:.3f} ms, "
        f"{solo_prof['kernels']:.1f} kernels, {solo_prof['aten_ops']:.1f} "
        f"operators; card {smi}")
    with FusedCheck(f"R-MAT-{SERVE_SCALE} B={SERVE_B} lanes",
                    period=50) as chk:
        SERVE.multi_source(pg, "bfs", sources, dataclasses.replace(
            MAIN_FUSED, max_rounds=SERVE_CHECK_ROUNDS))
    chk.report()
    assert {"fused_leg1: spills", "fused_leg2: spills"} <= chk.cover, \
        chk.cover
    calls = time_legs(chk, timer, f"serve B={SERVE_B} round "
                      f"<= {SERVE_CHECK_ROUNDS}")
    return launches, calls, dict(
        queries=queries, wall_s=wall, qps=queries / wall, rounds=rounds,
        seq_rounds=res.seq_rounds, lane_rounds=lane_rounds,
        wall_ms=1e3 * wall / rounds, solo_wall_ms=solo_ms,
        device_ms=prof["device_ms"], solo_device_ms=solo_prof["device_ms"],
        peak_gib=peak / 2 ** 30)


def serve_continuous(dev, smi, seed):
    """(b): the continuous front end on R-MAT-SERVE_CONT_SCALE with the
    trace on: every record its oracle's, its solo run's rounds, edges,
    values and ring (bitwise, launches included); no drops; each leg
    launched once a shared round."""
    g = rmat_graph(SERVE_CONT_SCALE)
    pg = alg.prepare(g, MAIN_T, "low_order", device=dev)
    srcs = serve_sources(g, seed + 1, SERVE_CONT_QUERIES)
    fe = SERVE.Frontend(pg, app="bfs", cfg=SERVE_CONT_CFG,
                        width=SERVE_CONT_WIDTH, policy="continuous")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = fe.serve(srcs, arrival="poisson", gap=SERVE_CONT_GAP, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want.update({k: rep.total_rounds for k in FUSED_ROUND})
    assert launches == want, (launches, want)
    assert rep.drops == 0 and len(rep.records) == SERVE_CONT_QUERIES
    assert rep.batches > 1 and rep.total_rounds < rep.seq_rounds
    for rec in rep.records:
        where = f"serve (b) query {rec.qid} (source {rec.source})"
        np.testing.assert_array_equal(rec.values, ref.bfs_ref(g, rec.source),
                                      err_msg=where)
        solo = alg.bfs(pg, rec.source, SERVE_CONT_CFG)
        np.testing.assert_array_equal(rec.values, solo.values, err_msg=where)
        assert (rec.rounds, rec.edges) == (int(solo.stats.rounds),
                                           int(solo.stats.edges_scanned))
        assert int(rec.trace.cursor) == solo.trace.cursor, where
        for f in rec.trace._fields[1:]:
            assert_bitwise(getattr(rec.trace, f), getattr(solo.trace, f),
                           f"{where}: ring {f}")
    row = rep.row()
    log(f"# path serve (b) continuous R-MAT-{SERVE_CONT_SCALE} "
        f"(V={g.num_vertices}), {SERVE_CONT_QUERIES} queries through "
        f"{SERVE_CONT_WIDTH} lanes, Poisson gap {SERVE_CONT_GAP:g} cycles, "
        f"trace on: every record equal to its oracle and to its solo run "
        f"(rounds, edges, values, ring bitwise); drops 0; {row}; shared "
        f"rounds {rep.total_rounds} against {rep.seq_rounds} sequential; "
        f"wall {wall:.3f} s ({SERVE_CONT_QUERIES / wall:.4f} queries/s, "
        f"{1e3 * wall / rep.total_rounds:.3f} ms a shared round); card "
        f"{smi}")
    return launches, dict(wall_s=wall, rounds=rep.total_rounds,
                          seq_rounds=rep.seq_rounds, row=row)


def serve_twin(dev):
    """(c): multi_source on "torch" against "kernels" at B = 3, fused
    (every leg call held against its plain stage) and unfused (every scan
    call against its plain version), ideal and mesh (link_cap 2), BFS and
    SSSP, and BFS streamed unfused: values and lane-led Stats bitwise but
    launches, values against the oracles, no drops.  Returns the launches
    of the kernels' runs."""
    oracles = {"bfs": ref.bfs_ref, "sssp": ref.sssp_ref}
    parts = {}
    for fabric, (scale, _) in SERVE_TWIN_FABRICS.items():
        g = rmat_graph(scale)
        root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
        parts[fabric] = (g, alg.prepare(g, SERVE_TWIN_T, "low_order",
                                        device=dev),
                         [root, serve_sources(g, 0, 1, [root])[0], -1])
    runs = [(app, fabric, fuse, "vmem") for app in ("bfs", "sssp")
            for fabric in SERVE_TWIN_FABRICS for fuse in (True, False)]
    runs.append(("bfs", "ideal", False, "hbm"))
    reset_launches()
    seen, cover, wants = {}, set(), {}
    t0 = time.perf_counter()
    for app, fabric, fuse, space in runs:
        g, pg, sources = parts[fabric]
        scale, knobs = SERVE_TWIN_FABRICS[fabric]
        base = EngineConfig(edge_space=space, **knobs)
        where = (f"serve (c) {app} R-MAT-{scale} {fabric} {space} "
                 f"{'fused' if fuse else 'unfused'} lanes {sources}")
        # the "torch" run ignores fuse: one a configuration serves both
        if (app, fabric, space) not in wants:
            wants[app, fabric, space] = SERVE.multi_source(
                pg, app, sources, dataclasses.replace(base, backend="torch"))
        want = wants[app, fabric, space]
        cfg = dataclasses.replace(base, fuse=fuse)
        if fuse:
            with FusedCheck(where, every=True) as chk:
                got = SERVE.multi_source(pg, app, sources, cfg)
            cover |= set(chk.checked)
        else:
            with scan_check(seen):
                got = SERVE.multi_source(pg, app, sources, cfg)
        np.testing.assert_array_equal(want.values, got.values,
                                      err_msg=where)
        assert_stats_equal(want.stats, got.stats, where)
        per_round = 3 if fuse else 5
        assert got.stats.launches.tolist() == [
            per_round * r for r in got.stats.rounds.tolist()], where
        assert int(got.stats.drops.sum()) == 0, where
        assert int(got.stats.rounds[2]) == 0, where
        for lane in (0, 1):
            check_values(got.values[lane],
                         oracles[app](g, sources[lane]),
                         None if app == "bfs" else dict(rtol=1e-5, atol=0.0),
                         f"{where} lane {lane}")
        if fabric == "mesh":
            assert int(got.stats.spills.sum()) > 0, where
    assert cover == set(FUSED_ROUND), cover
    assert set(seen) == {"edge_scan_gather", "edge_scan_stream"}, seen
    log(f"# serve (c) twin (T={SERVE_TWIN_T}, B=3 with a padding lane): "
        f"{len(runs)} configurations, torch == kernels "
        f"bitwise (values and lane-led Stats but launches), every lane "
        f"equal to its oracle; fused legs {sorted(cover)} held against "
        f"their plain stages at every call, scans {seen} by scan_contract "
        f"(the lane-axis kernels at B = 3); "
        f"{time.perf_counter() - t0:.1f} s")
    return read_launches()


def lane_scan_inputs(rng, lanes, T, e_chunk, R, max_t2, dev):
    """A scan's operands for ``lanes`` serving lanes over one shard:
    :func:`scan_inputs`' shard of T rows, and messages of lanes * T rows
    drawn as its messages are."""
    shard = scan_inputs(rng, T, e_chunk, 1, max_t2, dev)[:2]
    rows = lanes * T
    start = rng.integers(0, T * e_chunk, (rows, R)).astype(np.int32)
    stop = start + rng.integers(0, max_t2 + 1, (rows, R)).astype(np.int32)
    rv = rng.random((rows, R)) < 0.5
    start = np.where(rv | (rng.random((rows, R)) < 0.5), start, -1)
    return [*shard, *(rng_tensor(rng, a, dev) for a in (
        start.astype(np.int32), stop.astype(np.int32), rv))]


def serve_scans(dev, timer):
    """The two scans at SERVE_B lanes of the R-MAT-22 shard: checked by
    scan_contract and timed beside their plain versions and the library
    gather, with their bounds."""
    rng = np.random.default_rng(SERVE_B)
    max_t2 = MAIN_CFG.max_t2
    args = lane_scan_inputs(rng, SERVE_B, MAIN_T, MAIN_E_CHUNK,
                            SERVE_SCAN_R, max_t2, dev)
    label = f"B={SERVE_B} lanes, R-MAT-22 partition"
    return {"edge_scan_gather": scan_record(label, args, max_t2, timer),
            "edge_scan_stream": scan_record(f"window 128, {label}", args,
                                            max_t2, timer, 128)}


def phase_serve(dev, smi, timer, seed):
    """Query lanes: (a) SERVE_B BFS lanes on R-MAT-SERVE_SCALE beside
    their solo run, (b) the continuous front end, (c) the twin and the
    lane-axis kernels against their plain versions at B = 3, and the scans
    timed at SERVE_B lanes."""
    g, pg = build_graph(SERVE_SCALE, MAIN_T, dev)
    paths = {}
    solo, paths["serve solo"], wall = drive(
        lambda: alg.bfs(pg, MAIN_ROOT, MAIN_FUSED), smi,
        f"BFS R-MAT-{SERVE_SCALE} (fused; serve (a)'s solo run)",
        FUSED_ROUND)
    solo.wall_ms = 1e3 * wall / int(solo.stats.rounds)
    paths["serve twin"] = serve_twin(dev)
    scans = serve_scans(dev, timer)
    paths["serve static"], calls, stat = serve_static(g, pg, solo, smi,
                                                      timer, seed)
    paths["serve continuous"], cont = serve_continuous(dev, smi, seed)
    return paths, calls, scans, dict(static=stat, continuous=cont)


KCORE_ROUND = {"fused_leg0": 1, "fused_leg1": 1, "fused_kcore_leg2": 1}
TRIANGLES_ROUND = {f"fused_tri_leg{i}": 1 for i in range(5)}


def phase_taskgraph(dev, smi, timer):
    """The fused k-core and triangles programs on 64 tiles, against their
    oracles; then their legs held against the plain stages and timed."""
    paths, calls = {}, []
    t0 = time.perf_counter()
    n, src, dst, val = rmat_edges(KCORE_SCALE, edge_factor=10, seed=1)
    gs = alg.symmetrize(CSRGraph.from_edges(n, src, dst, val))
    pgs = alg.prepare(gs, MAIN_T, device=dev)
    assert (gs.num_vertices, gs.num_edges) == (KCORE_V, KCORE_E), \
        (gs.num_vertices, gs.num_edges)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ref.kcore_ref(gs, KCORE_K)
    assert int(want.sum()) == KCORE_CORE, int(want.sum())
    log(f"# taskgraph k-core: symmetrized R-MAT-{KCORE_SCALE} V="
        f"{gs.num_vertices} E={gs.num_edges} T={MAIN_T} v_chunk="
        f"{pgs.v_chunk} e_chunk={pgs.e_chunk}, k={KCORE_K}: host build "
        f"{t_graph:.1f} s, oracle {time.perf_counter() - t0:.1f} s, core "
        f"{int(want.sum())}")
    res, paths["k-core"], _ = drive(
        lambda: alg.kcore(pgs, KCORE_K, KCORE_CFG), smi,
        f"k-core k={KCORE_K} R-MAT-{KCORE_SCALE} (fused, cap_updq "
        f"{KCORE_CFG.cap_updq})", KCORE_ROUND)
    np.testing.assert_array_equal(res.values, want)
    log(f"# taskgraph k-core: equal to kcore_ref; epochs "
        f"{int(res.stats.epochs)}, rounds {int(res.stats.rounds)}, "
        f"decrements applied {int(res.stats.updates_applied)}")
    calls += legs_at_main_shapes(
        "k-core", lambda c: alg.kcore(pgs, KCORE_K, c), KCORE_CFG, timer,
        KCORE_SCALE, ("fused_leg1",))
    del pgs

    t0 = time.perf_counter()
    n, src, dst, val = rmat_edges(TRI_SCALE, edge_factor=10, seed=1)
    gs = alg.symmetrize(CSRGraph.from_edges(n, src, dst, val))
    pgt = alg.prepare_triangles(gs, MAIN_T, device=dev)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ref.triangles_wedge_ref(gs, key=pgt.place)
    log(f"# taskgraph triangles: symmetrized R-MAT-{TRI_SCALE} V="
        f"{gs.num_vertices} E={gs.num_edges} T={MAIN_T} v_chunk="
        f"{pgt.v_chunk} e_chunk={pgt.e_chunk}: host build {t_graph:.1f} s, "
        f"oracle {time.perf_counter() - t0:.1f} s, {int(want.sum())} "
        f"triangles")
    res, paths["triangles"], wall = drive(
        lambda: alg.triangles(pgt, TRI_CFG), smi,
        f"triangles R-MAT-{TRI_SCALE} (fused)", TRIANGLES_ROUND)
    np.testing.assert_array_equal(res.values, want)
    st = res.stats
    log(f"# taskgraph triangles: equal to the oracle; msgs per channel "
        f"{st.msgs.tolist()}, spills {st.spills.tolist()}, close tasks "
        f"searched {int(st.msgs[3])}; engine wall {wall:.3f} s")
    calls += legs_at_main_shapes(
        "triangles", lambda c: alg.triangles(pgt, c), TRI_CFG, timer,
        TRI_SCALE, ())
    return paths, calls


def binned_rounds(g, src_idx, prod, b, cap):
    """The products ``prod`` of the edges of ``g`` binned by destination
    block (bins of ``b`` slots), in edge order, as rounds of ``cap`` slots
    per bin: a list of (idx, vals) numpy pairs, -1 marking empty slots."""
    nb = -(-g.num_vertices // b)
    order = np.argsort(g.dst // b, kind="stable")
    bins = g.dst[order] // b
    rank = np.arange(len(order)) - np.searchsorted(bins, bins)
    rounds = []
    for k in range(int(rank.max()) // cap + 1 if len(order) else 0):
        pick = (rank >= k * cap) & (rank < (k + 1) * cap)
        idx = np.full((nb, cap), -1, np.int32)
        vals = np.zeros((nb, cap), np.float32)
        e = order[pick]
        idx[bins[pick], rank[pick] - k * cap] = g.dst[e] % b
        vals[bins[pick], rank[pick] - k * cap] = prod[e]
        rounds.append((idx, vals))
    return nb, rounds


def phase_block(dev, smi):
    g, src_idx = block_graph()
    n = g.num_vertices
    x = np.random.default_rng(7).normal(size=n).astype(np.float32)
    expect = SPMV.spmv_dense_ref(n, g.dst, src_idx, g.val, x)
    bv, bc, n_pad = coo_block_ell(n, g.dst, src_idx, g.val, BLOCK_B, dev)
    x_pad = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    x_pad[:n] = torch.from_numpy(x).to(dev)
    prod = g.val * x[src_idx]  # float32 products, the engine's emit
    nb, rounds = binned_rounds(g, src_idx, prod, BLOCK_B, SEG_CAP)
    add_ref = np.zeros(nb * BLOCK_B, np.float32)
    np.add.at(add_ref, g.dst, prod)   # serial float32, in edge order
    min_ref = np.full(nb * BLOCK_B, np.float32(INF32))
    np.minimum.at(min_ref, g.dst, prod)
    ops = {"add": torch.zeros((nb, BLOCK_B), dtype=torch.float32,
                              device=dev),
           "min": torch.full((nb, BLOCK_B), INF32, device=dev)}

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = SPMV.spmv_block_ell(bv, bc, x_pad)
    for idx, vals in rounds:
        idx_t = torch.from_numpy(idx).to(dev)
        vals_t = torch.from_numpy(vals).to(dev)
        for op in ops:
            ops[op] = SEG.scatter_segments(ops[op], idx_t, vals_t, op=op)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    assert launches["spmv_block_ell"] == 1
    assert launches["scatter_segments"] == 2 * len(rounds)

    y = y[:n].cpu().numpy()
    np.testing.assert_allclose(y, expect, rtol=1e-4, atol=1e-4)
    for op, want in (("add", add_ref), ("min", min_ref)):
        got = ops[op].reshape(-1).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=op)
    np.testing.assert_allclose(add_ref[:n], expect, rtol=1e-4, atol=1e-4)
    # the min on NaNs of both signs, +-0.0 and +-inf at the block's shape
    rng = np.random.default_rng(BLOCK_SCALE)
    for cap in (SEG_CAP, 64):
        args = seg_inputs(rng, nb, BLOCK_B, cap, dev, "nan")
        max_abs_err([SEG.scatter_segments(*args, op="min")],
                    [SEG.binned_scatter(*args, "min")])
    pg = alg.prepare(g, BLOCK_T, device=dev)
    res = alg.spmv(pg, x, EngineConfig(fuse=False, **TEST_KNOBS))
    assert int(res.stats.drops) == 0
    np.testing.assert_allclose(res.values, expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y, res.values, rtol=1e-4, atol=1e-4)
    log(f"# block: R-MAT-{BLOCK_SCALE} (V={n}, E={g.num_edges}) "
        f"spmv_block_ell (b={BLOCK_B}, S={bc.shape[1]}) within 1e-4 of the "
        f"dense oracle and of the engine's SpMV (T={BLOCK_T}, "
        f"{int(res.stats.rounds)} rounds); binned scatter_segments "
        f"({len(rounds)} rounds of {nb} bins x {SEG_CAP}) add and min "
        f"bitwise equal to np.add.at / np.minimum.at; {wall:.3f} s for the "
        f"kernels, launches {launches}; the min on NaNs and signed zeros "
        f"bitwise binned_scatter; card {smi}")
    return launches


@contextlib.contextmanager
def turn_operands(round_no: int, kept: list):
    """Copies, into ``kept``, of the operands of the two ``queue_push_pop``
    calls (range channel, update channel) of round ``round_no`` of the
    run inside, as the engine makes them."""
    real = E.queue_push_pop
    calls = [0]

    def spy(*a):
        if calls[0] // 2 == round_no:
            kept.append(([x.clone() for x in a[:5]], a[5]))
        calls[0] += 1
        return real(*a)

    E.queue_push_pop = spy
    try:
        yield
    finally:
        E.queue_push_pop = real


def phase_rmat18(dev, smi, timer):
    """R-MAT-18 over 64 tiles: the unfused paths (BFS, SpMV, and BFS with
    the streamed shard through edge_scan_stream), then PageRank.  The two
    turns and the scan of BFS round R18_TURN_ROUND, and the scan of the
    streamed BFS's, are checked and timed at the operands the engine gave
    them.  Returns (the paths' launch counts, the turns' records, the
    scans' records by kernel)."""
    t0 = time.perf_counter()
    g, pg = build_graph(PR_SCALE, MAIN_T, dev)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    oracle = ref.bfs_ref(g, root)
    log(f"# R-MAT-{PR_SCALE} (V={g.num_vertices}, E={g.num_edges}) over "
        f"T={MAIN_T}, BFS root {root}: host build and oracle "
        f"{time.perf_counter() - t0:.1f} s")
    paths, kept, scans = {}, [], {}
    gather_ops, stream_ops = [], []
    with turn_operands(R18_TURN_ROUND, kept), \
            scan_operands(R18_TURN_ROUND, gather_ops):
        res, paths["BFS"], _ = drive(
            lambda: alg.bfs(pg, root, R18_CFGS["BFS"]), smi,
            f"BFS R-MAT-{PR_SCALE} (unfused)",
            {**UNFUSED_ROUND, "fold_scatter": 1})
    np.testing.assert_array_equal(res.values, oracle)
    assert len(kept) == 2, len(kept)
    turns = []
    for label, (args, max_n) in zip(("range", "update"), kept):
        out = K.queue_push_pop(*args, max_n)
        turns.append(turn_call(
            f"{label}, R-MAT-{PR_SCALE} BFS round {R18_TURN_ROUND}", args,
            out, max_n, timer))
        c = turns[-1]
        log(f"# queue_push_pop at R-MAT-{PR_SCALE} BFS round "
            f"{R18_TURN_ROUND}, {label} call {c['shape']}, G = {c['G']}: "
            f"turn_contract bitwise; kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.6f} ms (whole "
            f"queue {c['whole_bound_ms']:.4f} ms, live share "
            f"{c['live_share']:.6f}); card {smi}")
    del kept
    scans["edge_scan_gather"] = scan_at(
        gather_ops, f"R-MAT-{PR_SCALE} BFS round {R18_TURN_ROUND}", timer,
        smi)
    vmem_stats = res.stats
    with scan_operands(R18_TURN_ROUND, stream_ops, "edge_scan_stream"):
        res, paths["BFS-hbm"], _ = drive(
            lambda: alg.bfs(pg, root, R18_CFGS["BFS-hbm"]), smi,
            f"BFS R-MAT-{PR_SCALE} (unfused, hbm)",
            {"frontier_pop": 1, "queue_push_pop": 2, "edge_scan_stream": 1,
             "fold_scatter": 1})
    scans["edge_scan_stream"] = scan_at(
        stream_ops, f"R-MAT-{PR_SCALE} streamed BFS round {R18_TURN_ROUND}",
        timer, smi)
    np.testing.assert_array_equal(res.values, oracle)
    assert torch.equal(res.stats.edges_scanned, vmem_stats.edges_scanned)
    assert int(res.stats.hbm_windows) > 0
    x = spmv_x(g.num_vertices)
    res, paths["SpMV"], _ = drive(
        lambda: alg.spmv(pg, x, R18_CFGS["SpMV"]), smi,
        f"SpMV R-MAT-{PR_SCALE} (unfused)",
        {**UNFUSED_ROUND, "fold_scatter_add": 1})
    check_spmv(g, res, x, f"SpMV R-MAT-{PR_SCALE}", planted=False)
    log(f"# R-MAT-{PR_SCALE} BFS (resident and hbm) equal to the oracle; "
        f"SpMV within the tolerance plus the float32 limit")

    t0 = time.perf_counter()
    want = ref.pagerank_ref(g, iters=PR_ITERS)
    t_oracle = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = alg.pagerank(pg, iters=PR_ITERS, cfg=R18_CFGS["SpMV"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = res.stats
    assert int(st.drops) == 0 and res.epochs == PR_ITERS
    assert int(st.launches) == 5 * int(st.rounds)
    np.testing.assert_allclose(res.values, want, rtol=2e-3, atol=1e-7)
    log(f"# PageRank R-MAT-{PR_SCALE} over T={MAIN_T}, {PR_ITERS} "
        f"iterations (cap_updq {SPMV_CFG.cap_updq}): within rtol 2e-3 / "
        f"atol 1e-7 of the oracle, drops 0; rounds {int(st.rounds)}, "
        f"engine wall {wall:.3f} s ({1e3 * wall / int(st.rounds):.3f} "
        f"ms/round); oracle {t_oracle:.1f} s; card {smi}")
    return paths, turns, scans


# --------------------------------------------------------------------------
# Phase 10: granite-3-2b serving on the flash kernel
# --------------------------------------------------------------------------

def flash_inputs(gen, B, S, H, Hkv, hd, dtype, dev):
    dt = getattr(torch, dtype)
    return [torch.randn(B, S, h, hd, generator=gen, device=dev).to(dt)
            for h in (H, Hkv, Hkv)]


def check_flash(dev, timer, sweep, main):
    """The flash kernel against its plain version on the cases of
    ``sweep`` and at the ``main`` shape (a prefill's); timed at the
    latter."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for case in (*sweep, main):
        B, S, H, Hkv, hd, win, dtype = case
        q, k, v = flash_inputs(gen, B, S, H, Hkv, hd, dtype, dev)
        out = FA.flash_attention(q, k, v, win)
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        want = FA.repeat_kv_attention(q, k, v, pos, win)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"flash {case}")
        err = float((out.float() - want.float()).abs().max())
        log(f"#   flash (B, S, H, Hkv, hd, window, dtype) = {case}: within "
            f"{tol} of its plain version (max |err| {err:.3g})")
    B, S, H, Hkv, hd, win, dtype = main
    # the float32 body (CUDA-core FMAs) at the same shape, timed only: the
    # bfloat16 main shape's record carries it beside the tensor cores' time
    f32 = [x.float() for x in (q, k, v)]
    f32_ms = timer.ms(lambda: FA.flash_attention(*f32, win))
    del f32
    # the library yardstick, timed only: SDPA on (B, H, S, hd) views
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    torch.testing.assert_close(sdpa().transpose(1, 2).float(), want.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])
    flops = 2 * B * H * S * S * hd   # QK^T and PV over the causal triangle
    bound = max(flops / BF16_FLOPS_PER_S, nbytes(q, k, v, out)
                / HBM_BYTES_PER_S) * 1e3
    return dict(max_abs_err=err,
                ms=timer.ms(lambda: FA.flash_attention(q, k, v, win)),
                plain_ms=timer.ms(lambda: FA.repeat_kv_attention(
                    q, k, v, pos, win)),
                bound_ms=bound, library_ms=timer.ms(sdpa),
                bound_by="operations", f32_ms=f32_ms)


def check_matmul_f32(dev):
    """bfloat16 projections accumulate in float32 on the card: matmul_f32
    at granite's MLP widths against the float32 product of the same
    values (a sum rounded to bfloat16 would sit near bfloat16's rounding
    unit, 2**-9, from it)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(LM_B * 256, 2048, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2048, 8192, generator=gen, device=dev) / 45).bfloat16()
    y = LMLAYERS.matmul_f32(a, w)
    want = a.float() @ w.float()
    rel = float((y - want).norm() / want.norm())
    assert y.dtype == torch.float32 and rel < 1e-5, rel
    return rel


def serve(params, cfg, prompts, use_kernels, lm_head, layer0_of):
    """prefill + LM_G greedy steps.  The kernel run drives the entry
    points (``prefill``, ``serve_step``); the plain run takes the same
    steps through ``forward`` with ``use_kernels=False`` and keeps each
    step's float32 logits, whose top-2 gap says where greedy tokens must
    agree.  ``layer0_of(cache)`` copies the cache fields of layer 0 just
    after the prefill.  Returns the run's outputs, times and launch
    counts."""
    B, P = prompts.shape
    cache = TFM.init_cache(cfg, B, P + LM_G, prompts.device)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = TFM.prefill(params, cfg, cache, {"tokens": prompts},
                            use_kernels=use_kernels)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = read_launches()
    layer0 = layer0_of(cache)
    reset_launches()
    tok, toks, gaps = prompts[:, -1:], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_G):
        if use_kernels:
            nxt, cache = TFM.serve_step(params, cfg, cache, tok)
        else:
            x, cache, _ = TFM.forward(params, cfg, {"tokens": tok},
                                    cache=cache, use_kernels=False)
            logits = LMLAYERS.matmul_f32(x[:, -1], lm_head)
            top2 = logits.topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(nxt)
        tok = nxt[:, None]
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return dict(last=last, cache=cache, layer0=layer0,
                tokens=torch.stack(toks, 1),
                gaps=torch.stack(gaps, 1) if gaps else None,
                prefill_s=t_prefill, decode_s=t_decode,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                prefill_launches=prefill_launches,
                decode_launches=read_launches())


def check_serving_run(run, cfg, what, use_kernels, per_prefill):
    """Launches (each kernel of ``per_prefill`` as many times as it says
    on the kernel path's prefill, no kernel in decode or on the plain
    path), the position, finiteness of the hidden state and every cache
    tensor, token range."""
    want = dict.fromkeys(run["prefill_launches"], 0)
    assert run["decode_launches"] == want, (what, run["decode_launches"])
    if use_kernels:
        want.update(per_prefill)
    assert run["prefill_launches"] == want, (what, run["prefill_launches"])
    assert int(run["cache"].pos) == LM_P + LM_G, what
    for x in (run["last"], *tensors(tuple(run["cache"][1:]))):
        assert bool(torch.isfinite(x).all()), what
    v_pad = TFM.abstract_params(cfg)["lm_head"].shape[1]
    toks = run["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < v_pad, what
    step_ms = 1e3 * run["decode_s"] / LM_G
    log(f"# {what}: prefill {LM_B}x{LM_P} {run['prefill_s'] * 1e3:.1f} "
        f"ms ({LM_B * LM_P / run['prefill_s']:.0f} tokens/s), decode "
        f"{step_ms:.2f} ms/step ({LM_B * 1e3 / step_ms:.1f} tokens/s), "
        f"peak device memory "
        f"{run['peak_gib']:.3f} GiB, launches "
        + ", ".join(f"{k} {run['prefill_launches'][k]} in prefill and "
                    f"{run['decode_launches'][k]} in {LM_G} decode steps"
                    for k in per_prefill))


def serve_both(params, cfg, prompts, what, per_prefill, layer0_of):
    """The plain path's serving run, then the kernel path's, each checked
    by ``check_serving_run``.  Returns (kernel run, plain run)."""
    plain = serve(params, cfg, prompts, False, params["lm_head"], layer0_of)
    check_serving_run(plain, cfg, f"{what} plain", False, per_prefill)
    kern = serve(params, cfg, prompts, True, params["lm_head"], layer0_of)
    check_serving_run(kern, cfg, f"{what} kernel", True, per_prefill)
    return kern, plain


def warm_up(params, cfg, prompts):
    """Untimed: the first prefills of a dtype, on either path, pay
    cuBLAS's set-up."""
    for use in (False, True):
        warm = TFM.init_cache(cfg, LM_B, 64, prompts.device)
        TFM.prefill(params, cfg, warm, {"tokens": prompts[:, :64]},
                    use_kernels=use)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def kv_layer0(cache):
    return cache.attn_k[0].clone(), cache.attn_v[0].clone()


def check_tokens(kern, plain):
    """Greedy tokens agree wherever the plain run's top-2 gap exceeds
    1e-2, while a row's earlier tokens agreed.  Returns (pairs checked,
    pairs equal)."""
    sure = plain["gaps"] > 1e-2
    same = kern["tokens"] == plain["tokens"]
    alive = torch.cumprod(same.int(), 1).bool()
    alive = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], 1)
    checked = sure & alive
    assert bool(same[checked].all()), "greedy tokens differ"
    return int(checked.sum()), int(same.sum())


def check_prompt_lengths(params, cfg, prompts):
    """A prompt of LM_RAGGED_P tokens (one 200-row block of the
    reference's prefill) prefills on the flash kernel, within 1e-3 of the
    plain path; one of LM_REFUSED_P tokens is refused on both paths, as
    the reference's block rule refuses it."""
    last = {}
    for use in (True, False):
        cache = TFM.init_cache(cfg, LM_B, LM_RAGGED_P, prompts.device)
        FA.flash_attention.launches = 0
        last[use], _ = TFM.prefill(params, cfg, cache,
                                   {"tokens": prompts[:, :LM_RAGGED_P]},
                                   use_kernels=use)
        assert FA.flash_attention.launches == (cfg.num_layers if use
                                               else 0), use
    torch.testing.assert_close(last[True], last[False], rtol=1e-3,
                               atol=1e-3)
    long = prompts.repeat(1, -(-LM_REFUSED_P // prompts.shape[1]))[
        :, :LM_REFUSED_P]
    for use in (True, False):
        cache = TFM.init_cache(cfg, LM_B, LM_REFUSED_P, prompts.device)
        try:
            TFM.prefill(params, cfg, cache, {"tokens": long},
                        use_kernels=use)
        except ValueError as e:
            assert "512" in str(e), e
        else:
            raise AssertionError(f"a {LM_REFUSED_P}-token prompt was "
                                 f"served (use_kernels={use})")
    log(f"# lm float32: a {LM_RAGGED_P}-token prompt prefills on the flash "
        f"kernel ({cfg.num_layers} launches), last hidden within 1e-3 of "
        f"the plain path (max |err| "
        f"{float((last[True] - last[False]).abs().max()):.3g}); a "
        f"{LM_REFUSED_P}-token prompt is refused on both paths")


def phase_lm(dev, smi, timer):
    """granite-3-2b at full width and depth: the flash kernel against its
    plain version, then prefill + greedy decode, kernel against plain,
    float32 and bfloat16.  Returns (the kernel's record row, the launch
    counts of the kernel paths)."""
    row = check_flash(dev, timer, FLASH_SWEEP, FLASH_MAIN)
    log(f"# kernel flash_attention: within {FLASH_TOL['bfloat16']} of its "
        f"plain version at {FLASH_MAIN}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"(operations), library {row['library_ms']:.4f} ms (SDPA); float32 "
        f"body at the same shape {row['f32_ms']:.4f} ms; card {smi}")
    rel = check_matmul_f32(dev)
    log(f"# lm: bfloat16 projections accumulate in float32 (rel L2 "
        f"{rel:.3g} from the float32 product)")
    # float32 matmuls in full float32, stated and set for this script
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, base.vocab_size, (LM_B, LM_P), generator=gen,
                            dtype=torch.int32, device=dev)
    log(f"# lm: {LM_ARCH} at full width, all {base.num_layers} layers "
        f"(d {base.d_model}, {base.num_heads} heads / {base.num_kv_heads} "
        f"kv of {base.hd}, d_ff {base.d_ff}, vocab {base.vocab_size}, "
        f"{base.param_count() / 1e9:.3f} B parameters), random weights "
        f"from seed {LM_SEED}, B = {LM_B}, prompt {LM_P}, {LM_G} greedy "
        f"steps")
    paths, runs = [], {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        params = TFM.init_params(
            torch.Generator(device=dev).manual_seed(LM_SEED), cfg, dev)
        torch.cuda.synchronize()
        log(f"# lm {dtype}: weights made on the card in "
            f"{time.perf_counter() - t0:.2f} s")
        with torch.inference_mode():
            # untimed: the first prefill of a dtype pays cuBLAS's set-up
            warm = TFM.init_cache(cfg, LM_B, LM_P, dev)
            TFM.prefill(params, cfg, warm, {"tokens": prompts},
                        use_kernels=False)
            del warm
            kern, plain = serve_both(
                params, cfg, prompts, f"lm {dtype}",
                {"flash_attention": cfg.num_layers}, kv_layer0)
            if dtype == "float32":
                check_prompt_lengths(params, cfg, prompts)
        paths.append({**kern["prefill_launches"]})
        del params
        runs[dtype] = (kern, plain)
        err = rel_l2(kern["last"], plain["last"])
        if dtype == "float32":
            for a, b in zip(kern["layer0"], plain["layer0"]):
                assert torch.equal(a, b), "layer 0 K/V cache differs"
            torch.testing.assert_close(kern["last"], plain["last"],
                                       rtol=1e-3, atol=1e-3)
            checked, same = check_tokens(kern, plain)
            log(f"# lm float32: layer 0 K/V bitwise equal; last hidden "
                f"within rtol = atol = 1e-3 (max |err| "
                f"{float((kern['last'] - plain['last']).abs().max()):.3g}, "
                f"rel L2 {err:.3g}); greedy tokens equal on "
                f"{checked} of {LM_B * LM_G} (row, step) pairs "
                f"whose plain top-2 gap > 1e-2 (all pairs equal: "
                f"{same}); pos {LM_P + LM_G}")
        else:
            assert err < BF16_REL_L2, (err, BF16_REL_L2)
            f32_kern = runs["float32"][0]
            log(f"# lm bfloat16: last hidden rel L2 {err:.4g} from the "
                f"bfloat16 plain run (bound {BF16_REL_L2}), "
                f"{rel_l2(kern['last'], f32_kern['last']):.4g} from the "
                f"float32 kernel run; greedy tokens equal to the plain "
                f"run's: {int((kern['tokens'] == plain['tokens']).sum())} "
                f"of {LM_B * LM_G}")
        torch.cuda.empty_cache()
    return row, paths


# --------------------------------------------------------------------------
# Phase 11: rwkv6-1.6b serving on the WKV6 kernel
# --------------------------------------------------------------------------

def wkv_inputs(gen, B, S, H, K, w_fixed, state, dev):
    """r, k, v ~ N(0, 1); w_log = clip(-exp(0.5 N(0, 1))) or ``w_fixed``;
    u ~ 0.5 N(0, 1); state0 ~ N(0, 1) when ``state``, else None."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    r, k, v = randn(B, S, H, K), randn(B, S, H, K), randn(B, S, H, K)
    w = torch.clamp(-torch.exp(0.5 * randn(B, S, H, K)), -4.0, -1e-6)
    if w_fixed is not None:
        w = torch.full_like(w, w_fixed)
    return r, k, v, w, 0.5 * randn(H, K), randn(B, H, K, K) if state else None


def rel_to_max(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def check_wkv6_case(args, chunk, what):
    """The kernel against its plain version (within WKV_REL_TOL of the
    largest magnitude) and the scan oracle (the reference's 3e-4) on one
    case; returns (the kernel's output, its largest errors)."""
    out = W6.wkv6_kernel(*args, chunk=chunk)
    plain = W6.wkv6_chunked(*args, chunk=chunk)
    oracle = W6.wkv6_scan_oracle(*args)
    torch.cuda.synchronize()
    errs = [rel_to_max(a, b) for a, b in zip(out, plain)]
    assert max(errs) <= WKV_REL_TOL, (what, errs)
    for a, b in zip(out, oracle):
        torch.testing.assert_close(a, b, rtol=WKV_ORACLE_TOL,
                                   atol=WKV_ORACLE_TOL, msg=what)
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
    log(f"#   wkv6 {what}: y and state within {WKV_REL_TOL} of the plain "
        f"version's largest magnitude (rel {errs[0]:.3g}, {errs[1]:.3g}; max "
        f"|err| {abs_err:.3g}) and within {WKV_ORACLE_TOL} of the scan "
        f"oracle")
    return out, abs_err


def wkv6_flops(B, S, H, K, C) -> int:
    """Operations of the chunked recurrence: per chunk and head, r_in S
    (2CK^2), the strictly lower scores and their product with v (2 x
    C(C-1)K), the bonus (5CK) and the state update (2CK^2 + 2K^2)."""
    return B * H * (S // C) * (4 * C * K * K + 2 * C * (C - 1) * K
                               + 5 * C * K + 2 * K * K)


def check_wkv6(dev, smi, timer):
    """The WKV6 kernel against its plain version and the scan oracle on
    the reference's sweep and the edge cases, a state carried across two
    calls, and the rwkv6-1.6b prefill shape, timed at the latter.
    Returns the kernel's record row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, S, H, K, chunk, w_fixed, state in WKV_SWEEP:
        args = wkv_inputs(gen, B, S, H, K, w_fixed, state, dev)
        check_wkv6_case(args, chunk, f"(B, S, H, K, chunk) = "
                        f"{(B, S, H, K, chunk)}, w_log "
                        f"{'drawn' if w_fixed is None else w_fixed}, state0 "
                        f"{'drawn' if state else 'zero'}")
    r, k, v, w, u, _ = wkv_inputs(gen, 1, 64, 2, 16, None, False, dev)
    full = W6.wkv6_kernel(r, k, v, w, u)
    h = 32
    halves = [W6.wkv6_kernel(r[:, :h].contiguous(), k[:, :h].contiguous(),
                             v[:, :h].contiguous(), w[:, :h].contiguous(), u)]
    halves.append(W6.wkv6_kernel(
        r[:, h:].contiguous(), k[:, h:].contiguous(), v[:, h:].contiguous(),
        w[:, h:].contiguous(), u, state0=halves[0][1]))
    errs = (rel_to_max(torch.cat([halves[0][0], halves[1][0]], 1), full[0]),
            rel_to_max(halves[1][1], full[1]))
    assert max(errs) <= WKV_REL_TOL, ("state carry", errs)
    log(f"#   wkv6 state carry (1, 64, 2, 16): two halves within "
        f"{WKV_REL_TOL} of one call (rel {errs[0]:.3g}, {errs[1]:.3g})")
    B, S, H, K, chunk, w_fixed, state = WKV_MAIN
    args = wkv_inputs(gen, B, S, H, K, w_fixed, state, dev)
    out, abs_err = check_wkv6_case(args, chunk, f"prefill shape "
                                   f"{(B, S, H, K, chunk)}, state0 drawn")
    hmma = wkv6_tensor_core_instructions()
    smem = wkv6_shared_memory()
    moved = nbytes(*args, *out)
    C = min(chunk, S)
    bounds = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
              "operations": wkv6_flops(B, S, H, K, C) / F32_FLOPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    row = dict(max_abs_err=abs_err,
               ms=timer.ms(lambda: W6.wkv6_kernel(*args, chunk=chunk)),
               plain_ms=timer.ms(lambda: W6.wkv6_chunked(*args,
                                                         chunk=chunk)),
               bound_ms=bounds[bound_by], bound_by=bound_by,
               library_ms=None, hmma=hmma)
    log(f"# kernel wkv6_kernel: within {WKV_REL_TOL} of its plain version "
        f"at {WKV_MAIN[:5]}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({bound_by}; {moved / 1e6:.1f} MB moved: "
        f"{bounds['bytes']:.4f} ms, operations: "
        f"{bounds['operations']:.4f} ms), library none; HMMA (cuobjdump "
        f"-sass) " + ", ".join(f"{k} {v}" for k, v in hmma.items())
        + f"; shared memory a block (K: bytes at C 8, 16, 32) {smem}; "
        f"card {smi}")
    return row


def wkv6_tensor_core_instructions() -> dict:
    """HMMA instructions in each instance (K, KT: the chunk's 8-step
    tiles) of the built WKV6 library; every K the wrapper takes has an
    instance at 1, 2 and 4 tiles."""
    return tensor_core_instructions(
        W6.LIBRARY, r"wkv6_kernelILi(\d+)ELi(\d+)E", "K {} KT {}",
        [f"K {K} KT {kt}" for K in W6.kernel.HEAD_DIMS for kt in (1, 2, 4)])


def wkv6_shared_memory() -> dict:
    """The dynamic shared memory of each instance as compiled
    (``repro_wkv6_smem``), held against the wrapper's mirror
    (``kernel.smem_bytes``) for every K and chunk, and under the 227 KiB
    a block may opt in to.  Returns K -> the bytes at C = 8, 16, 32."""
    lib = W6.LIBRARY.get()
    for K in W6.kernel.HEAD_DIMS:
        for C in range(1, W6.kernel.MAX_CHUNK + 1):
            got = lib.repro_wkv6_smem(K, C)
            assert got == W6.kernel.smem_bytes(K, C), (K, C, got)
            assert got <= W6.kernel.SMEM_LIMIT, (K, C, got)
    return {K: [lib.repro_wkv6_smem(K, C) for C in (8, 16, 32)]
            for K in W6.kernel.HEAD_DIMS}


def perturb_decays(params, gen):
    """Draw the decay, bonus and token-shift leaves, which the reference's
    init leaves at zero (w_log = -1, u = 0, no shift): ``w0`` uniform in
    [-3, 1.5], ``w_lora_b`` 0.1 N(0, 1), ``u`` 0.5 N(0, 1), ``mu`` and
    ``mu_c`` uniform in [0, 1]."""
    blocks = params["blocks"]
    blocks["w0"].uniform_(-3.0, 1.5, generator=gen)
    blocks["w_lora_b"].normal_(0.0, 0.1, generator=gen)
    blocks["u"].normal_(0.0, 0.5, generator=gen)
    blocks["mu"].uniform_(0.0, 1.0, generator=gen)
    blocks["mu_c"].uniform_(0.0, 1.0, generator=gen)


def rwkv_layer0(cache):
    return cache.rwkv[0][0].clone(), cache.rwkv[2][0].clone()


def phase_rwkv(dev, smi, timer):
    """rwkv6-1.6b at full width and depth: the WKV6 kernel against its
    plain version, then prefill + greedy decode, kernel against plain,
    float32 (decay leaves drawn) and bfloat16 (the reference's init).
    Returns (the kernel's record row, the launch counts of the kernel
    paths)."""
    row = check_wkv6(dev, smi, timer)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(RWKV_ARCH)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, base.vocab_size, (LM_B, LM_P), generator=gen,
                            dtype=torch.int32, device=dev)
    log(f"# rwkv: {RWKV_ARCH} at full width, all {base.num_layers} layers "
        f"(d {base.d_model}, heads of {base.rwkv_head_dim}, d_ff "
        f"{base.d_ff}, vocab {base.vocab_size}, "
        f"{base.param_count() / 1e9:.3f} B parameters), random weights "
        f"from seed {LM_SEED}, B = {LM_B}, prompt {LM_P}, {LM_G} greedy "
        f"steps")
    paths = []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        params = TFM.init_params(
            torch.Generator(device=dev).manual_seed(LM_SEED), cfg, dev)
        if dtype == "float32":
            perturb_decays(params, torch.Generator(device=dev).manual_seed(
                LM_SEED + 2))
        torch.cuda.synchronize()
        log(f"# rwkv {dtype}: weights made on the card in "
            f"{time.perf_counter() - t0:.2f} s"
            + (" (decay, bonus and shift leaves drawn)"
               if dtype == "float32" else " (the reference's init)"))
        with torch.inference_mode():
            warm_up(params, cfg, prompts)
            kern, plain = serve_both(
                params, cfg, prompts, f"rwkv {dtype}",
                {"wkv6_kernel": cfg.num_layers}, rwkv_layer0)
        paths.append({**kern["prefill_launches"]})
        del params
        err = rel_l2(kern["last"], plain["last"])
        if dtype == "float32":
            assert torch.equal(kern["layer0"][0], plain["layer0"][0]), \
                "layer 0 token-shift carry differs"
            wkv_err = rel_to_max(kern["layer0"][1], plain["layer0"][1])
            assert wkv_err <= WKV_REL_TOL, wkv_err
            last_err = rel_to_max(kern["last"], plain["last"])
            assert last_err <= RWKV_F32_TOL, last_err
            checked, same = check_tokens(kern, plain)
            log(f"# rwkv float32: layer 0 token-shift carry bitwise equal, "
                f"its WKV state within {WKV_REL_TOL} of the largest "
                f"magnitude ({wkv_err:.3g}); last hidden within "
                f"{RWKV_F32_TOL} of the largest magnitude ({last_err:.3g}, "
                f"rel L2 {err:.3g}); greedy tokens equal on {checked} of "
                f"{LM_B * LM_G} (row, step) pairs whose plain top-2 gap > "
                f"1e-2 (all pairs equal: {same}); pos {LM_P + LM_G}")
        else:
            assert err < RWKV_BF16_REL_L2, (err, RWKV_BF16_REL_L2)
            log(f"# rwkv bfloat16: last hidden rel L2 {err:.4g} from the "
                f"bfloat16 plain run (bound {RWKV_BF16_REL_L2}); greedy "
                f"tokens equal to the plain run's: "
                f"{int((kern['tokens'] == plain['tokens']).sum())} of "
                f"{LM_B * LM_G}")
        torch.cuda.empty_cache()
    return row, paths


# --------------------------------------------------------------------------
# Phase 12: zamba2-2.7b serving on the SSD kernel and the flash kernel at
# hd 80
# --------------------------------------------------------------------------

def ssd_inputs(gen, B, S, H, P, N, a_log, dt, state, dev):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)) or ``dt``; a_log = 0.3
    N(0, 1) or ``a_log``; state0 ~ N(0, 1) when ``state``, else None."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    x = randn(B, S, H, P)
    dts = torch.nn.functional.softplus(randn(B, S, H))
    if dt is not None:
        dts = torch.full_like(dts, dt)
    al = 0.3 * randn(H) if a_log is None else torch.full(
        (H,), a_log, device=dev)
    return (x, dts, al, randn(B, S, N), randn(B, S, N),
            randn(B, H, P, N) if state else None)


def check_ssd_case(args, chunk, what):
    """The kernel against its plain version (within SSD_REL_TOL of the
    largest magnitude) and the scan oracle (the reference's 3e-4) on one
    case, every output finite; returns (the kernel's output, its largest
    error)."""
    out = SSD.ssd_kernel(*args, chunk=chunk)
    plain = SSD.ssd_chunked(*args, chunk=chunk)
    oracle = SSD.ssd_scan_oracle(*args)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(a).all()) for a in out), what
    errs = [rel_to_max(a, b) for a, b in zip(out, plain)]
    assert max(errs) <= SSD_REL_TOL, (what, errs)
    for a, b in zip(out, oracle):
        torch.testing.assert_close(a, b, rtol=SSD_ORACLE_TOL,
                                   atol=SSD_ORACLE_TOL, msg=what)
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
    log(f"#   ssd {what}: finite, y and state within {SSD_REL_TOL} of the "
        f"plain version's largest magnitude (rel {errs[0]:.3g}, "
        f"{errs[1]:.3g}; max |err| {abs_err:.3g}) and within "
        f"{SSD_ORACLE_TOL} of the scan oracle")
    return out, abs_err


def ssd_flops(B, S, H, P, N, C) -> int:
    """Operations of the kernel's chunked recurrence: per chunk and head,
    the T = C (C + 1) / 2 scores s <= t (2N + 2 each) and their product
    with x (2P each), C S^T and its scaling (C P (2N + 2)), the state
    update (C P (2N + 1) and 2PN for its decay) and the cumsum and
    decays (6C)."""
    T = C * (C + 1) // 2
    return B * H * (S // C) * (T * (2 * N + 2) + 2 * T * P
                               + C * P * (2 * N + 2) + C * P * (2 * N + 1)
                               + 2 * P * N + 6 * C)


def ssd_tc_flops(B, S, H, P, N, C) -> int:
    """Operations of the products that the kernel runs on the tensor
    cores: per chunk and head C S^T and the state's increment (2 C P N
    each) and the scores times x (2 P for each of the T = C (C + 1) / 2
    pairs s <= t); per chunk and batch row C B^T (2 N T)."""
    T = C * (C + 1) // 2
    return B * (S // C) * (H * (4 * C * P * N + 2 * T * P) + 2 * N * T)


def ssd_bounds(B, S, H, P, N, C, moved) -> dict:
    """The kernel's bounds: its bytes over 3.35 TB/s; its operations, the
    tensor-core products in 3xTF32 (three MMAs a product) at a third of
    495 TFLOP/s plus the rest of ``ssd_flops`` in float32 at 67 TFLOP/s;
    and ``f32``, every operation in float32 (the bound of the earlier
    design, all FMAs)."""
    T = C * (C + 1) // 2
    flops = ssd_flops(B, S, H, P, N, C)
    # ssd_flops counts C B^T once a head: 2 N T of its T (2 N + 2)
    rest = flops - B * H * (S // C) * (4 * C * P * N + 2 * T * P + 2 * N * T)
    return {"bytes": moved / HBM_BYTES_PER_S * 1e3,
            "operations": (ssd_tc_flops(B, S, H, P, N, C)
                           / (TF32_FLOPS_PER_S / 3) + rest / F32_FLOPS_PER_S)
            * 1e3,
            "f32": flops / F32_FLOPS_PER_S * 1e3}


def tensor_core_instructions(lib, pattern: str, label: str,
                             want) -> dict:
    """HMMA (mma.sync) instructions in each instance of a kernel of the
    built library ``lib``, by ``cuobjdump -sass``: the instances are the
    functions whose mangled name matches ``pattern``, named by ``label``
    formatted with its groups (the template arguments).  Fails unless
    every instance runs its products on the tensor cores and every name in
    ``want`` starts some instance's name."""
    sass = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(lib.path)],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            name = label.format(*m.groups()) if m else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    for w in want:
        assert any(k.startswith(w) for k in counts), (w, counts)
    assert all(v > 0 for v in counts.values()), counts
    return dict(sorted(counts.items()))


def ssd_tensor_core_instructions() -> dict:
    """HMMA instructions in each instance (P, N, KT: the chunk's 8-step
    tiles) of the built SSD library; every (P, N) the wrapper takes has
    an instance."""
    return tensor_core_instructions(
        SSD.LIBRARY, r"ssd_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
        "P {} N {} KT {}",
        [f"P {P} N {N} " for P in SSD.kernel.HEAD_DIMS
         for N in SSD.kernel.STATE_DIMS])


def check_ssd(dev, smi, timer):
    """The SSD kernel against its plain version and the scan oracle on the
    reference's sweep and the edge cases, a state carried across two
    calls, and the zamba2-2.7b prefill shape, timed at the latter.
    Returns the kernel's record row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, S, H, P, N, chunk, a_log, dt, state in SSD_SWEEP:
        args = ssd_inputs(gen, B, S, H, P, N, a_log, dt, state, dev)
        check_ssd_case(args, chunk, f"(B, S, H, P, N, chunk) = "
                       f"{(B, S, H, P, N, chunk)}, a_log "
                       f"{'drawn' if a_log is None else a_log}, dt "
                       f"{'drawn' if dt is None else dt}, state0 "
                       f"{'drawn' if state else 'zero'}")
    x, dt, al, bm, cm, _ = ssd_inputs(gen, 2, 128, 4, 64, 64, None, None,
                                      False, dev)
    full = SSD.ssd_kernel(x, dt, al, bm, cm)
    h = 64
    halves = [SSD.ssd_kernel(*(a[:, :h].contiguous() for a in (x, dt)), al,
                             *(a[:, :h].contiguous() for a in (bm, cm)))]
    halves.append(SSD.ssd_kernel(
        *(a[:, h:].contiguous() for a in (x, dt)), al,
        *(a[:, h:].contiguous() for a in (bm, cm)), state0=halves[0][1]))
    errs = (rel_to_max(torch.cat([halves[0][0], halves[1][0]], 1), full[0]),
            rel_to_max(halves[1][1], full[1]))
    assert max(errs) <= SSD_REL_TOL, ("state carry", errs)
    log(f"#   ssd state carry (2, 128, 4, 64, 64): two halves within "
        f"{SSD_REL_TOL} of one call (rel {errs[0]:.3g}, {errs[1]:.3g})")
    B, S, H, P, N, chunk, a_log, dt, state = SSD_MAIN
    args = ssd_inputs(gen, B, S, H, P, N, a_log, dt, state, dev)
    out, abs_err = check_ssd_case(args, chunk, f"prefill shape "
                                  f"{(B, S, H, P, N, chunk)}, state0 drawn")
    moved = nbytes(*args, *out)
    bounds = ssd_bounds(B, S, H, P, N, min(chunk, S), moved)
    bound_by = max(("bytes", "operations"), key=bounds.get)
    hmma = ssd_tensor_core_instructions()
    row = dict(max_abs_err=abs_err,
               ms=timer.ms(lambda: SSD.ssd_kernel(*args, chunk=chunk)),
               plain_ms=timer.ms(lambda: SSD.ssd_chunked(*args,
                                                         chunk=chunk)),
               bound_ms=bounds[bound_by], bound_by=bound_by,
               f32_bound_ms=bounds["f32"], library_ms=None, hmma=hmma)
    log(f"# kernel ssd_kernel: within {SSD_REL_TOL} of its plain version "
        f"at {SSD_MAIN[:6]}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({bound_by}; {moved / 1e6:.1f} MB moved: "
        f"{bounds['bytes']:.4f} ms, operations in 3xTF32 and float32: "
        f"{bounds['operations']:.4f} ms; all in float32: "
        f"{bounds['f32']:.4f} ms), library none; HMMA (cuobjdump -sass) "
        + ", ".join(f"{k} {v}" for k, v in hmma.items()) + f"; card {smi}")
    return row


def perturb_mamba(params, gen):
    """Draw the Mamba2 leaves that the reference's init leaves constant
    (a_log = dt_bias = conv_b = 0, d_skip = 1 in every head): ``a_log``
    uniform in [-6, 1], ``dt_bias`` uniform in [-4, 4], ``d_skip`` N(0, 1)
    and ``conv_b`` N(0, 1)."""
    blocks = params["blocks"]
    blocks["a_log"].uniform_(-6.0, 1.0, generator=gen)
    blocks["dt_bias"].uniform_(-4.0, 4.0, generator=gen)
    blocks["d_skip"].normal_(0.0, 1.0, generator=gen)
    blocks["conv_b"].normal_(0.0, 1.0, generator=gen)


def zamba_layer0(cache):
    """Superblock 0's K/V slot (written before any kernel runs) and the
    first Mamba2 layer's conv carry and SSD state."""
    return (cache.attn_k[0].clone(), cache.attn_v[0].clone(),
            cache.mamba[0][0, 0].clone(), cache.mamba[1][0, 0].clone())


def check_zamba_prompt_lengths(params, cfg, prompts):
    """A prompt of ZAMBA_SERVED_P tokens (13 chunks of 16) prefills on
    the kernels (9 flash and 54 SSD launches) within ZAMBA_F32_TOL of the
    plain path; one of ZAMBA_REFUSED_P tokens is refused on both paths,
    as the reference's ssd_chunked asserts S % min(16, S) == 0."""
    n_sb = cfg.num_layers // cfg.attn_every
    last = {}
    for use in (True, False):
        cache = TFM.init_cache(cfg, LM_B, ZAMBA_SERVED_P, prompts.device)
        reset_launches()
        last[use], _ = TFM.prefill(params, cfg, cache,
                                   {"tokens": prompts[:, :ZAMBA_SERVED_P]},
                                   use_kernels=use)
        got = read_launches()
        assert (got["flash_attention"], got["ssd_kernel"]) == (
            (n_sb, cfg.num_layers) if use else (0, 0)), (use, got)
    err = rel_to_max(last[True], last[False])
    assert err <= ZAMBA_F32_TOL, err
    for use in (True, False):
        cache = TFM.init_cache(cfg, LM_B, ZAMBA_REFUSED_P, prompts.device)
        try:
            TFM.prefill(params, cfg, cache,
                        {"tokens": prompts[:, :ZAMBA_REFUSED_P]},
                        use_kernels=use)
        except ValueError as e:
            assert "multiple" in str(e), e
        else:
            raise AssertionError(f"a {ZAMBA_REFUSED_P}-token prompt was "
                                 f"served (use_kernels={use})")
    log(f"# zamba float32: a {ZAMBA_SERVED_P}-token prompt prefills on the "
        f"kernels ({n_sb} flash, {cfg.num_layers} SSD launches), last "
        f"hidden within {ZAMBA_F32_TOL} of the plain path's largest "
        f"magnitude ({err:.3g}); a {ZAMBA_REFUSED_P}-token prompt is "
        f"refused on both paths")


def phase_zamba(dev, smi, timer):
    """zamba2-2.7b at full width and depth: the SSD kernel against its
    plain version, the flash kernel at hd 80 against its plain version,
    then prefill + greedy decode, kernels against plain, float32 (the
    Mamba2 leaves drawn) and bfloat16 (the reference's init).  Returns
    (the SSD kernel's record row, the flash kernel's row at hd 80, the
    launch counts of the kernel paths)."""
    ssd_row = check_ssd(dev, smi, timer)
    flash_row = check_flash(dev, timer, FLASH80_SWEEP, FLASH80_MAIN)
    log(f"# kernel flash_attention at hd 80: within "
        f"{FLASH_TOL['bfloat16']} of its plain version at {FLASH80_MAIN}; "
        f"kernel {flash_row['ms']:.4f} ms, plain "
        f"{flash_row['plain_ms']:.4f} ms, bound {flash_row['bound_ms']:.4f} "
        f"ms (operations), library {flash_row['library_ms']:.4f} ms (SDPA); "
        f"float32 body at the same shape {flash_row['f32_ms']:.4f} ms; card "
        f"{smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(ZAMBA_ARCH)
    n_sb = base.num_layers // base.attn_every
    specs = []
    tree_map(specs.append, TFM.abstract_params(base),
             is_leaf=lambda x: isinstance(x, ParamSpec))
    n_params = sum(int(np.prod(s.shape)) for s in specs)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, base.vocab_size, (LM_B, LM_P), generator=gen,
                            dtype=torch.int32, device=dev)
    log(f"# zamba: {ZAMBA_ARCH} at full width, all {base.num_layers} layers "
        f"({n_sb} superblocks of the shared attention block and "
        f"{base.attn_every} Mamba2 layers; d {base.d_model}, "
        f"{base.num_heads} heads / {base.num_kv_heads} kv of {base.hd}, "
        f"window {base.sliding_window}, Mamba2 heads of {base.ssm_head_dim} "
        f"with state {base.ssm_state}, d_ff {base.d_ff}, vocab "
        f"{base.vocab_size}, {n_params / 1e9:.3f} B parameters made), "
        f"random weights from seed {LM_SEED}, B = {LM_B}, prompt {LM_P}, "
        f"{LM_G} greedy steps")
    per_prefill = {"ssd_kernel": base.num_layers, "flash_attention": n_sb}
    paths, f32_ref_init = [], None
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        params = TFM.init_params(
            torch.Generator(device=dev).manual_seed(LM_SEED), cfg, dev)
        torch.cuda.synchronize()
        log(f"# zamba {dtype}: weights made on the card in "
            f"{time.perf_counter() - t0:.2f} s")
        with torch.inference_mode():
            warm_up(params, cfg, prompts)
            if dtype == "float32":
                # the bfloat16 run's yardstick: a float32 prefill at the
                # reference's init; then the float32 check's leaves
                f32_ref_init, _ = TFM.prefill(
                    params, cfg, TFM.init_cache(cfg, LM_B, LM_P, dev),
                    {"tokens": prompts})
                perturb_mamba(params, torch.Generator(
                    device=dev).manual_seed(LM_SEED + 2))
                log("# zamba float32: a_log, dt_bias, d_skip and conv_b "
                    "drawn")
            kern, plain = serve_both(params, cfg, prompts,
                                     f"zamba {dtype}", per_prefill,
                                     zamba_layer0)
            if dtype == "float32":
                check_zamba_prompt_lengths(params, cfg, prompts)
        paths.append({**kern["prefill_launches"]})
        del params
        err = rel_l2(kern["last"], plain["last"])
        if dtype == "float32":
            for a, b in zip(kern["layer0"][:2], plain["layer0"][:2]):
                assert torch.equal(a, b), "superblock 0's K/V differ"
            conv_err, ssd_err = (rel_to_max(a, b) for a, b in zip(
                kern["layer0"][2:], plain["layer0"][2:]))
            last_err = rel_to_max(kern["last"], plain["last"])
            assert max(conv_err, ssd_err, last_err) <= ZAMBA_F32_TOL, (
                conv_err, ssd_err, last_err)
            checked, same = check_tokens(kern, plain)
            log(f"# zamba float32: superblock 0's K/V bitwise equal; the "
                f"first Mamba2 layer's conv carry and SSD state within "
                f"{ZAMBA_F32_TOL} of their largest magnitude ({conv_err:.3g}, "
                f"{ssd_err:.3g}); last hidden within {ZAMBA_F32_TOL} "
                f"({last_err:.3g}, rel L2 {err:.3g}); greedy tokens equal on "
                f"{checked} of {LM_B * LM_G} (row, step) pairs whose plain "
                f"top-2 gap > 1e-2 (all pairs equal: {same}); pos "
                f"{LM_P + LM_G}")
        else:
            assert err < ZAMBA_BF16_REL_L2, (err, ZAMBA_BF16_REL_L2)
            log(f"# zamba bfloat16: last hidden rel L2 {err:.4g} from the "
                f"bfloat16 plain run (bound {ZAMBA_BF16_REL_L2}), "
                f"{rel_l2(kern['last'], f32_ref_init):.4g} from the float32 "
                f"kernel prefill at the same (the reference's) init; greedy "
                f"tokens equal to the plain run's: "
                f"{int((kern['tokens'] == plain['tokens']).sum())} of "
                f"{LM_B * LM_G}")
        torch.cuda.empty_cache()
    return ssd_row, flash_row, paths


def take_rows(st, rows):
    """The state's ``rows`` (an int64 index tensor), every tile-led field
    and queue copied."""
    def pick(x):
        return x.index_select(0, rows)
    return st._replace(
        value=pick(st.value), acc=pick(st.acc),
        frontier=pick(st.frontier), next_frontier=pick(st.next_frontier),
        queues=tuple(E.Queue(pick(q.data), pick(q.count))
                     for q in st.queues),
        net_pressure=pick(st.net_pressure))


def take_out_rows(out, rows):
    """A leg 0's outputs ``(state, msgs, mvalid, drops, dyn_pops, npop,
    npush)`` at state rows ``rows``."""
    return (take_rows(out[0], rows),) + tuple(x.index_select(0, rows)
                                              for x in out[1:])


class LegZeroCapture:
    """The operands of fused leg 0 (classic or triangles) at the
    ``calls``-th calls of a run, copied: the run goes on unchanged."""

    NAMES = ("fused_leg0", "fused_tri_leg0")

    def __init__(self, calls):
        self.calls, self.n, self.ops = set(calls), 0, []

    def __enter__(self):
        self.saved = {n: getattr(F, n) for n in self.NAMES}
        for n, f in self.saved.items():
            setattr(F, n, functools.partial(self.call, n, f))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(F, n, f)

    def call(self, name, real, tmpl, plain, me, sh, st):
        if self.n in self.calls:
            every = torch.arange(me.shape[0], device=me.device)
            self.ops.append((name, real, tmpl, plain, me.clone(),
                             E.GraphShard(*(x.clone() for x in sh)),
                             take_rows(st, every)))
        self.n += 1
        return real(tmpl, plain, me, sh, st)


def check_tile_base(label, ops):
    """Each captured leg 0 launched on all its rows, then on each tile's
    rows alone (one row; one a lane over a batch) over that tile's shard
    row with ``tile0`` the tile, as AxisComm / LaneAxisComm launch it:
    every one-tile launch bitwise those rows of the launch on all rows
    (by the legs' contract), and equal to its plain stage.  Returns the
    one-tile launches made."""
    n = 0
    for name, real, tmpl, plain, me, sh, st in ops:
        assert tmpl.tile0 == 0, (label, tmpl.tile0)
        full = real(tmpl, plain, me, sh, st)
        T = sh.deg.shape[0]
        for k in range(T):
            rows = torch.arange(k, me.shape[0], T, device=me.device)
            tk = tmpl._replace(tile0=k)
            ops_k = (me.index_select(0, rows),
                     E.GraphShard(*(x[k:k + 1] for x in sh)),
                     take_rows(st, rows))
            got = real(tk, plain, *ops_k)
            n += 1
            where = f"spmd (a) {label} {name} tile {k}"
            want = take_out_rows(full, rows)
            defined, past = F.contract(name, tk, ops_k[2], got)
            assert_bitwise(defined, F.contract(name, tk, ops_k[2], want)[0],
                           where)
            assert not bool(past.any()), where
            check_leg(name, tk, ops_k, got, plain(*ops_k), f"{where} plain")
    return n


def spmd_tile_base(dev):
    """(a): the tile base of fused leg 0 on the card."""
    g, pg = build_graph(SPMD_TWIN_SCALE, SPMD_TWIN_T, dev)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    gs = alg.symmetrize(rmat_graph(SPMD_TRI_SCALE))
    pgt = alg.prepare_triangles(gs, SPMD_TWIN_T, device=dev)
    lanes = [root, serve_sources(g, 0, 1, [root])[0], -1]
    runs = {
        "BFS": lambda: alg.bfs(pg, root, EngineConfig()),
        "triangles": lambda: alg.triangles(pgt, EngineConfig()),
        "3 lanes": lambda: SERVE.multi_source(pg, "bfs", lanes,
                                              EngineConfig()),
    }
    t0 = time.perf_counter()
    counts = {}
    for label, run in runs.items():
        with LegZeroCapture(SPMD_TILE_CALLS) as cap:
            run()
        assert len(cap.ops) == len(SPMD_TILE_CALLS), (label, len(cap.ops))
        counts[label] = check_tile_base(label, cap.ops)
    log(f"# spmd (a): fused leg 0 at calls {SPMD_TILE_CALLS} of BFS and "
        f"3 lanes (R-MAT-{SPMD_TWIN_SCALE}) and of triangles (symmetrized "
        f"R-MAT-{SPMD_TRI_SCALE}) over {SPMD_TWIN_T} tiles: each one-tile "
        f"launch (tile0 = k, shard row k; one-tile launches {counts}) "
        f"bitwise tile k's rows of the launch on all rows and equal to its "
        f"plain stage; {time.perf_counter() - t0:.1f} s")


def spmd_checked(label, run, want):
    """``run`` again with every fused leg call of its first two rounds and
    of every SPMD_CHECK_PERIOD-th round (and the FusedCheck's other
    rounds) held against its plain stage at the one-row shapes SPMD gives
    it; the result bitwise ``want``, the unchecked run's.  Returns the
    checked calls by leg."""
    with FusedCheck(label, period=SPMD_CHECK_PERIOD) as chk:
        got = run()
    chk.report()
    np.testing.assert_array_equal(got.values, want.values)
    assert set(chk.checked) == set(FUSED_ROUND), (label, chk.checked)
    return chk.checked


def spmd_world_one(dev, smi):
    """(b): BFS and SPMD_LANES lanes through AxisComm / LaneAxisComm over
    NCCL at world size 1 against the LocalComm runs at T = 1 and the
    oracle.  Returns the launch counts of the SPMD paths."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.core.comm import AxisComm
    from repro_torch.launch.mesh import auto_mesh
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/store",
                            rank=0, world_size=1)
    try:
        mesh = auto_mesh((1,), ("x",))
        g, pg = build_graph(SPMD_SCALE, 1, dev)
        root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
        cfg = EngineConfig()
        oracle = ref.bfs_ref(g, root)
        paths, walls = [], {}
        res = {}
        for how, mesh_of in (("LocalComm", None), ("AxisComm", mesh)):
            what = (f"spmd (b) BFS R-MAT-{SPMD_SCALE} T=1 fused {how}"
                    + (" over NCCL, world size 1" if mesh_of else ""))
            res[how], launches, walls[how] = drive(
                lambda: alg.bfs(pg, root, cfg, mesh=mesh_of), smi, what,
                FUSED_ROUND)
            if mesh_of is not None:
                paths.append(launches)
        np.testing.assert_array_equal(res["AxisComm"].values,
                                      res["LocalComm"].values)
        np.testing.assert_array_equal(res["AxisComm"].values, oracle)
        assert_stats_equal(res["LocalComm"].stats, res["AxisComm"].stats,
                           "spmd (b) BFS")
        rounds = int(res["AxisComm"].stats.rounds)
        checks = [spmd_checked(
            f"spmd (b) BFS R-MAT-{SPMD_SCALE} AxisComm",
            lambda: alg.bfs(pg, root, cfg, mesh=mesh), res["AxisComm"])]
        prof = {how: round_profile(
            pg, cfg, SPMD_PROFILE_AT, SPMD_PROFILE_ROUNDS,
            comm=None if how == "LocalComm" else AxisComm(
                mesh.get_group("x"), 1, 0, pg.device), root=root,
            host_top=SPMD_HOST_TOP) for how in ("LocalComm", "AxisComm")}
        costs = collective_costs(AxisComm(mesh.get_group("x"), 1, 0,
                                          pg.device))
        sources = [root] + serve_sources(g, 0, SPMD_LANES - 1, [root])
        lanes = {}
        for how, mesh_of in (("LocalComm", None), ("AxisComm", mesh)):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lanes[how] = SERVE.multi_source(pg, "bfs", sources, cfg,
                                            mesh=mesh_of)
            torch.cuda.synchronize()
            walls[f"{how} lanes"] = time.perf_counter() - t0
            launches = read_launches()
            shared = lanes[how].total_rounds
            want = dict.fromkeys(launches, 0)
            want.update({k: n * shared for k, n in FUSED_ROUND.items()})
            assert launches == want, (how, launches, want)
            if mesh_of is not None:
                paths.append(launches)
        checks.append(spmd_checked(
            f"spmd (b) {SPMD_LANES} lanes LaneAxisComm",
            lambda: SERVE.multi_source(pg, "bfs", sources, cfg, mesh=mesh),
            lanes["AxisComm"]))
        a, b = lanes["LocalComm"], lanes["AxisComm"]
        np.testing.assert_array_equal(b.values, a.values)
        assert_stats_equal(a.stats, b.stats, "spmd (b) lanes")
        assert (a.total_rounds, a.batch_cycles, a.batch_energy_pj) == (
            b.total_rounds, b.batch_cycles, b.batch_energy_pj)
        np.testing.assert_array_equal(a.done_round, b.done_round)
        np.testing.assert_array_equal(a.done_cycle, b.done_cycle)
        assert int(b.stats.drops.sum()) == 0
        for lane, src in enumerate(sources):
            np.testing.assert_array_equal(b.values[lane],
                                          ref.bfs_ref(g, src))
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    lane_rounds = b.total_rounds
    log(f"# spmd (b): R-MAT-{SPMD_SCALE} (V {g.num_vertices}, E "
        f"{g.num_edges}) on one tile, fused: BFS from {root} in {rounds} "
        f"rounds, AxisComm over NCCL (world size 1) bitwise the LocalComm "
        f"run (values, Stats but launches) and the oracle; "
        f"{SPMD_LANES} lanes {sources} in {lane_rounds} shared rounds, "
        f"LaneAxisComm bitwise LaneComm (values, lane-led Stats, batch "
        f"clock, done rounds) and each lane its oracle; each run again with "
        f"its fused legs held against their plain stages (FusedCheck, "
        f"every {SPMD_CHECK_PERIOD}th round): {checks}; card {smi}")
    for how in ("LocalComm", "AxisComm"):
        p = prof[how]
        log(f"#   {how}: BFS wall {1e3 * walls[how] / rounds:.3f} ms a "
            f"round; lanes wall {1e3 * walls[how + ' lanes'] / lane_rounds:.3f}"
            f" ms a shared round; device {p['device_ms']:.4f} ms a round "
            f"(NCCL kernels {p['nccl_ms']:.4f}), {p['kernels']:.1f} kernels "
            f"and {p['aten_ops']:.1f} PyTorch operators a round, "
            f"{p['collectives']:.1f} collectives a round taking "
            f"{p['nccl_host_ms']:.3f} ms of host time (rounds "
            f"{SPMD_PROFILE_AT}-{SPMD_PROFILE_AT + SPMD_PROFILE_ROUNDS - 1}); "
            f"the next {SPMD_PROFILE_ROUNDS} rounds' wall {p['wall_ms']:.3f} "
            f"ms a round; card {smi}")
        log(f"#   {how}: host ms a round (cProfile own time, calls a "
            f"round), the {SPMD_HOST_TOP} largest: " + "; ".join(
                f"{name} {ms:.3f} ({calls:g})"
                for name, ms, calls in p["host_top"]))
    log("#   host ms a call, NCCL at world size 1 (200 calls each): "
        + ", ".join(f"{k} {v:.4f}" for k, v in costs.items())
        + f"; card {smi}")
    return paths


def collective_costs(comm, reps=200) -> dict:
    """Host ms a call of each AxisComm collective at the engine's small
    shapes (a round's counters, a route's send buffer), the device
    synchronized once after ``reps`` calls."""
    dev = comm.device
    ops = {
        "psum int32 (1, 4)": (comm.psum, torch.ones((1, 4), dtype=torch.int32,
                                                     device=dev)),
        "pmax float32 (1,) (all-gather)": (
            comm.pmax, torch.ones((1,), device=dev)),
        "a2a int32 (1, 1024, 2)": (comm.a2a, torch.ones(
            (1, 1024, 2), dtype=torch.int32, device=dev)),
        "clone int32 (1, 4) (no collective)": (torch.clone, torch.ones(
            (1, 4), dtype=torch.int32, device=dev)),
    }
    out = {}
    for name, (fn, x) in ops.items():
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def phase_spmd(dev, smi):
    """SPMD on torch.distributed: (a) the tile base of fused leg 0, (b)
    world size 1 over NCCL.  Returns the launch counts of (b)'s paths."""
    spmd_tile_base(dev)
    return spmd_world_one(dev, smi)


# --------------------------------------------------------------------------
# Phase 13: granite-3-2b training on the flash backward kernel
# --------------------------------------------------------------------------

def check_flash_bwd(dev, timer):
    """The flash backward kernel against its plain version (autograd
    through ``repeat_kv_attention``) on FLASH_BWD_SWEEP and at the main
    shape, the training forward's logsumexp against ``attention_lse``;
    timed at the main shape (and the float32 instance at the same shape)
    beside SDPA's backward (forward plus backward less forward, K/V
    repeated to the query heads; timed only, the port never calls it)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    for case in (*FLASH_BWD_SWEEP, FLASH_BWD_MAIN):
        B, S, H, Hkv, hd, win, dtype = case
        q, k, v = flash_inputs(gen, B, S, H, Hkv, hd, dtype, dev)
        do = torch.randn(B, S, H, hd, generator=gen, device=dev).to(q.dtype)
        out, lse = FA.flash_attention_fwd(q, k, v, win)
        got = FA.flash_attention_bwd(q, k, v, out, lse, do, win)
        want = FA.attention_bwd_plain(q, k, v, do, win)
        torch.cuda.synchronize()
        lse_err = float((lse - FA.attention_lse(q, k, win)).abs().max())
        assert lse_err <= FLASH_LSE_TOL[dtype], (case, lse_err)
        rel = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = float((a.float() - b.float()).abs().max())
            big = float(b.float().abs().max())
            assert err <= FLASH_BWD_TOL[dtype] * big, (case, name, err, big)
            rel.append(err / big)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        log(f"#   flash bwd (B, S, H, Hkv, hd, window, dtype) = {case}: "
            f"dq, dk, dv within {FLASH_BWD_TOL[dtype]} of the plain "
            f"version's largest magnitude ({', '.join(f'{r:.3g}' for r in rel)}"
            f"), lse within {lse_err:.3g}")
        del got, want
    B, S, H, Hkv, hd, win, dtype = FLASH_BWD_MAIN
    f32 = [x.float() for x in (q, k, v, out, lse, do)]
    f32_ms = timer.ms(lambda: FA.flash_attention_bwd(*f32, win))
    del f32
    G = H // Hkv
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2).detach()
              .requires_grad_(True) for x in (k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
    flops = 5 * B * H * S * S * hd  # S, dP, dV, dK, dQ over the triangle
    moved = nbytes(q, k, v, out, lse, do) + nbytes(q, k, v)
    bound = max(flops / BF16_FLOPS_PER_S, moved / HBM_BYTES_PER_S) * 1e3
    return dict(max_abs_err=err,
                ms=timer.ms(lambda: FA.flash_attention_bwd(q, k, v, out, lse,
                                                           do, win)),
                plain_ms=timer.ms(lambda: FA.attention_bwd_plain(
                    q, k, v, do, win)),
                bound_ms=bound, bound_by="operations",
                library_ms=timer.ms(sdpa_fwd_bwd) - timer.ms(sdpa),
                f32_ms=f32_ms)


def check_matmul_f32_grad(dev):
    """A bfloat16 projection's gradients (``matmul_f32``'s autograd
    function) at granite's MLP widths against autograd of the float32
    product of the same values: within 1e-2 relative L2 of it and 1e-3 of
    it rounded to bfloat16 (the backward keeps the float32 cotangent and
    rounds each gradient once).  Returns the four distances."""
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(LM_B * 256, 2048, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2048, 8192, generator=gen, device=dev) / 45).bfloat16()
    dy = torch.randn(LM_B * 256, 8192, generator=gen, device=dev)
    a.requires_grad_(True)
    w.requires_grad_(True)
    got = torch.autograd.grad(LMLAYERS.matmul_f32(a, w), (a, w), dy)
    a32, w32 = (x.detach().float().requires_grad_(True) for x in (a, w))
    want = torch.autograd.grad(a32 @ w32, (a32, w32), dy)
    rel = [rel_l2(g, x) for g, x in zip(got, want)]
    rel16 = [rel_l2(g, x.bfloat16()) for g, x in zip(got, want)]
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(rel) < 1e-2 and max(rel16) < 1e-3, (rel, rel16)
    return rel + rel16


def train_batch(src, step, dev):
    return {"tokens": torch.from_numpy(src.batch_at(step)).to(dev)}


def train_params(dev, cfg):
    """``cfg``'s weights: the reference's draws from LM_SEED, each block
    matrix scaled to std 1/sqrt(fan-in)."""
    return rescale_to_fan_in(TFM.init_params(
        torch.Generator(device=dev).manual_seed(LM_SEED), cfg, dev))


def train_step_twin(dev, base, src):
    """One whole-model step's loss and gradients at TRAIN_TWIN_LAYERS
    layers, the kernel path against the plain path (``use_kernels=False``)
    from the same weights and batch, in float32 (the bfloat16 weights
    widened) and bfloat16; each bfloat16 leaf of both paths against the
    float32 plain path's.  Returns the kernel paths' launch counts."""
    cfg16 = dataclasses.replace(base, dtype="bfloat16",
                                num_layers=TRAIN_TWIN_LAYERS)
    p16 = train_params(dev, cfg16)
    batch = train_batch(src, 0, dev)
    names = leaf_names(p16)
    L = cfg16.num_layers
    grads32, counts = None, []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg16, dtype=dtype)
        params = p16 if dtype == "bfloat16" else \
            tree_map(lambda a: a.detach().float(), p16)
        runs = {}
        for use in (True, False):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, grads = TRAINER.loss_and_grads(params, cfg, batch,
                                                    use_kernels=use)
            torch.cuda.synchronize()
            runs[use] = (loss, grads, ADAMW.global_norm(grads),
                         time.perf_counter() - t0, read_launches())
        (lk, gk, nk, tk, ck), (lp, gp, np_, tp, cp) = runs[True], runs[False]
        del runs
        assert ck["flash_attention"] == 2 * L and \
            ck["flash_attention_bwd"] == L, ck  # forward, remat, backward
        assert cp["flash_attention"] == cp["flash_attention_bwd"] == 0, cp
        assert bool(torch.isfinite(lk)) and bool(torch.isfinite(nk))
        counts.append(ck)
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        norm_rel = abs(float(nk) - float(np_)) / float(np_)
        leaf = {n: rel_l2(a, b) for n, a, b in zip(names, gk, gp)}
        worst = max(leaf, key=leaf.get)
        log(f"# train {dtype}: one step at {L} layers, kernel path against "
            f"plain: loss {float(lk):.6f} / {float(lp):.6f} (rel "
            f"{loss_rel:.3g}, bound {TRAIN_LOSS_RTOL[dtype]}), grad norm "
            f"{float(nk):.6g} / {float(np_):.6g} (rel {norm_rel:.3g}, bound "
            f"{TRAIN_GNORM_RTOL[dtype]}), leaf rel L2 at most "
            f"{leaf[worst]:.3g} ({worst}); step {tk * 1e3:.1f} / "
            f"{tp * 1e3:.1f} ms (forward, remat, backward; no update)")
        assert loss_rel <= TRAIN_LOSS_RTOL[dtype], loss_rel
        assert norm_rel <= TRAIN_GNORM_RTOL[dtype], norm_rel
        if dtype == "float32":
            assert leaf[worst] <= TRAIN_LEAF_REL, (worst, leaf[worst])
            grads32 = gp
            del gk, params
            continue
        dist = {n: (rel_l2(a, c), rel_l2(b, c))
                for n, a, b, c in zip(names, gk, gp, grads32)}
        far = max(dist, key=lambda n: max(dist[n]))
        log(f"# train bfloat16: every leaf of both paths within "
            f"{TRAIN_BF16_LEAF_REL} rel L2 of the float32 gradient at the "
            f"same weights; farthest {far} {max(dist[far]):.3g}; kernel / "
            f"plain: " + ", ".join(f"{n} {ek:.3g}/{ep:.3g}"
                                   for n, (ek, ep) in dist.items()))
        for n, (ek, ep) in dist.items():
            assert ek <= TRAIN_BF16_LEAF_REL and ep <= TRAIN_BF16_LEAF_REL, \
                (n, ek, ep)
    return counts


# kernel-name groups of a training step's device time (the backward's
# three passes; the forward's wgmma body; cuBLAS and CUTLASS products)
STEP_GROUPS = (("flash backward", ("delta_kernel", "dkdv_kernel",
                                   "dq_kernel")),
               ("flash forward", ("flash_wgmma_kernel", "flash_fwd_kernel")),
               ("matrix products", ("gemm", "xmma", "cutlass", "nvjet")))


def step_profile(step_fn, params, state, batch) -> tuple:
    """One more step under ``torch.profiler``: (wall ms, device ms, device
    ms by STEP_GROUPS and the rest, the top kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from tools.port_round_profile import device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total, by_name, counts = device_us(prof)
    groups = {g: 0.0 for g, _ in STEP_GROUPS}
    groups["the rest"] = 0.0
    for name, us in by_name.items():
        g = next((g for g, keys in STEP_GROUPS
                  if any(k in name for k in keys)), "the rest")
        groups[g] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return wall, total / 1e3, groups, counts, top


def timed_train_steps(dev, smi, base, src, bwd_ms):
    """TRAIN_STEPS timed steps of ``make_train_step`` (kernel path, all
    the layers, AdamW with a float32 master) after an untimed one;
    ``bwd_ms``: the backward kernel's time at this shape (phase (a)).
    Returns the launch counts of the timed steps and the median step
    ms."""
    cfg = dataclasses.replace(base, dtype="bfloat16")
    params = train_params(dev, cfg)
    oc = ADAMW.OptConfig(**TRAIN_OPT)
    step_fn = TRAINER.make_train_step(cfg, TRAINER.TrainConfig(
        batch=LM_B, seq_len=LM_P, remat=True, opt=oc))
    state = ADAMW.init(params, oc)
    torch.cuda.reset_peak_memory_stats()
    params, state, m = step_fn(params, state, train_batch(src, 0, dev))
    losses, times = [float(m["loss"])], []
    reset_launches()
    for i in range(1, TRAIN_STEPS + 1):
        batch = train_batch(src, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(np.isfinite(losses)), losses
    assert int(state.step) == TRAIN_STEPS + 1
    L = cfg.num_layers
    assert counts["flash_attention_bwd"] == L * TRAIN_STEPS and \
        counts["flash_attention"] == 2 * L * TRAIN_STEPS, counts
    step_ms = float(np.median(times)) * 1e3
    wall, dev_ms, groups, pc, top = step_profile(
        step_fn, params, state, train_batch(src, TRAIN_STEPS + 1, dev))
    log(f"# train bfloat16: one more step profiled: wall {wall:.1f} ms, "
        f"device {dev_ms:.1f} ms (busy share {dev_ms / wall:.3f}), "
        f"{pc['kernels']} kernels, {pc['aten_ops']} PyTorch operators; "
        + ", ".join(f"{g} {ms:.1f} ms ({100 * ms / dev_ms:.1f} %)"
                    for g, ms in groups.items())
        + "; top: " + ", ".join(f"{n[:48]} {us / 1e3:.1f} ms"
                                for n, us in top))
    log(f"# train bfloat16: {TRAIN_STEPS} steps of {LM_B} x {LM_P} tokens "
        f"after one untimed: step {step_ms:.1f} ms median (mean "
        f"{np.mean(times) * 1e3:.1f}, min {min(times) * 1e3:.1f}, max "
        f"{max(times) * 1e3:.1f}), {LM_B * LM_P / (step_ms / 1e3):.0f} "
        f"tokens/s; launches a step: flash_attention "
        f"{counts['flash_attention'] // TRAIN_STEPS} (forward and remat), "
        f"flash_attention_bwd {counts['flash_attention_bwd'] // TRAIN_STEPS}"
        f" at {bwd_ms:.4f} ms each (phase (a)); peak device memory "
        f"{peak:.3f} GiB; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; card {smi}")
    return counts, step_ms


def check_resume(dev, base, seed):
    """``train`` at full width and TRAIN_RESUME_LAYERS layers, weights
    and data from ``seed``: 4 steps uninterrupted, against 2 steps, a
    checkpoint, a restart and 2 more: the resumed steps' losses and the
    final parameters and optimizer state bitwise.  Returns the kernel
    launch counts of the runs."""
    cfg = dataclasses.replace(base, dtype="bfloat16",
                              num_layers=TRAIN_RESUME_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def tc(name, every):
        return TRAINER.TrainConfig(
            steps=4, batch=LM_B, seq_len=LM_P, ckpt_every=every,
            ckpt_dir=os.path.join(root, name), ckpt_keep=1, log_every=0,
            seed=seed, opt=ADAMW.OptConfig(**TRAIN_OPT))
    try:
        reset_launches()
        t0 = time.perf_counter()
        pa, sa, ha = TRAINER.train(cfg, tc("a", 4), device=dev)
        t_run = time.perf_counter() - t0
        nbytes_ckpt = sum(f.stat().st_size for f in
                          Path(root, "a", "step_4").iterdir())
        shutil.rmtree(os.path.join(root, "a"))
        TRAINER.train(cfg, tc("b", 2), stop_after=2, device=dev)
        assert CKPT.latest_valid_step(os.path.join(root, "b")) == 2
        t0 = time.perf_counter()
        pb, sb, hb = TRAINER.train(cfg, tc("b", 2), device=dev)
        t_resume = time.perf_counter() - t0
        counts = read_launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert [h["step"] for h in hb] == [2, 3]
    assert [h["loss"] for h in hb] == [h["loss"] for h in ha[2:]], (ha, hb)
    for a, b in zip(ADAMW.leaves((pa, sa)), ADAMW.leaves((pb, sb))):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    log(f"# train resume: {cfg.num_layers} layers at full width, 4 steps "
        f"uninterrupted ({t_run:.1f} s with its checkpoint) against 2, a "
        f"checkpoint of {nbytes_ckpt / 2 ** 30:.3f} GiB, a restart and 2 "
        f"more ({t_resume:.1f} s): losses "
        f"{', '.join('%.6f' % h['loss'] for h in hb)} and every parameter "
        f"and optimizer leaf bitwise the uninterrupted run's")
    return counts


def phase_train(dev, smi, timer, seed):
    """granite-3-2b training at full width and depth: the flash backward
    kernel against its plain version, one whole-model step kernel against
    plain (float32, bfloat16), TRAIN_STEPS timed steps, then the save and
    resume check at TRAIN_RESUME_LAYERS layers.  Returns (the backward
    kernel's record row, the launch counts of the kernel paths)."""
    row = check_flash_bwd(dev, timer)
    log(f"# kernel flash_attention_bwd: within {FLASH_BWD_TOL['bfloat16']} "
        f"of its plain version at {FLASH_BWD_MAIN}; kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
        f"ms (operations), library {row['library_ms']:.4f} ms (SDPA "
        f"backward: forward + backward less forward); float32 instance "
        f"{row['f32_ms']:.4f} ms; card {smi}")
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rel = check_matmul_f32_grad(dev)
    log(f"# train: bfloat16 projection gradients (dx, dw) within "
        f"{rel[0]:.3g}, {rel[1]:.3g} rel L2 of the float32 product's, "
        f"{rel[2]:.3g}, {rel[3]:.3g} of it rounded to bfloat16")
    base = get_config(LM_ARCH)
    src = make_source("markov", base.vocab_size, LM_P, LM_B, seed)
    log(f"# train: {LM_ARCH} at full width, all {base.num_layers} layers "
        f"({base.param_count() / 1e9:.3f} B parameters), random weights "
        f"from seed {LM_SEED} at a fan-in init, B = {LM_B}, S = {LM_P}, "
        f"Markov data from seed {seed}, remat on")
    paths = train_step_twin(dev, base, src)
    torch.cuda.empty_cache()
    counts, row["step_ms"] = timed_train_steps(dev, smi, base, src,
                                               row["ms"])
    paths.append(counts)
    torch.cuda.empty_cache()
    paths.append(check_resume(dev, base, seed))
    torch.cuda.empty_cache()
    return row, paths


PHASES = ("kernels", "twin", "main", "hbm", "noc", "place", "taskgraph",
          "block", "rmat18", "serve", "spmd", "lm", "rwkv", "zamba", "train")
SPENT = {}  # phase: wall seconds


def timed(name, fn, *args):
    """``fn(*args)``, its wall time logged and kept in SPENT."""
    t0 = time.perf_counter()
    out = fn(*args)
    SPENT[name] = time.perf_counter() - t0
    log(f"# phase {name}: {SPENT[name]:.1f} s")
    return out


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} "
                         f"(default: all; hbm runs with main)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serving phase's drawn sources and "
                         "of the training phase's data")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if phases - set(PHASES):
        raise SystemExit(f"unknown phases {sorted(phases - set(PHASES))}")
    smi, hgmma = phase_device()
    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    rows = timed("kernels", phase_kernels, dev, timer) \
        if "kernels" in phases else {}
    if "twin" in phases:
        timed("twin", phase_twin, dev)
    paths, calls = [], []
    if "main" in phases:
        main_paths, main_calls, scans = timed(
            "main", phase_main, dev, smi, timer, "hbm" in phases)
        paths += main_paths.values()
        calls += main_calls
        if "edge_scan_stream" in rows:
            rows["edge_scan_stream"]["calls"] += scans
    noc_obs = None
    if "noc" in phases:
        noc_paths, noc_calls, _, noc_obs = timed("noc", phase_noc, dev, smi,
                                                 timer)
        paths += noc_paths.values()
        calls += noc_calls
    if "place" in phases:
        place_paths, _ = timed("place", phase_place, dev, smi, noc_obs)
        paths += place_paths.values()
    noc_obs = None
    if "taskgraph" in phases:
        task_paths, task_calls = timed("taskgraph", phase_taskgraph, dev,
                                       smi, timer)
        paths += task_paths.values()
        calls += task_calls
    if "serve" in phases:
        serve_paths, serve_calls, lane_scans, _ = timed(
            "serve", phase_serve, dev, smi, timer, args.seed)
        paths += serve_paths.values()
        calls += serve_calls
        for name, rec in lane_scans.items():
            if name in rows:
                rows[name]["calls"].append(rec)
    for k in F.KERNELS:
        mine = [c for c in calls if c["kernel"] == k.__name__]
        if mine:
            row = mine[0]  # the first path's template (BFS, k-core, ...)
            rows[k.__name__] = dict(
                max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], library_ms=None, calls=mine)
    if "block" in phases:
        paths.append(timed("block", phase_block, dev, smi))
    if "rmat18" in phases:
        r18_paths, turns, scans = timed("rmat18", phase_rmat18, dev, smi,
                                        timer)
        paths += r18_paths.values()
        if "queue_push_pop" in rows:
            rows["queue_push_pop"]["calls"] += turns
        for name, rec in scans.items():
            if name in rows:
                rows[name]["calls"].append(rec)
    if "spmd" in phases:
        paths += timed("spmd", phase_spmd, dev, smi)
    if "lm" in phases:
        rows["flash_attention"], lm_paths = timed("lm", phase_lm, dev, smi,
                                                  timer)
        paths += lm_paths
    if "rwkv" in phases:
        rows["wkv6_kernel"], rwkv_paths = timed("rwkv", phase_rwkv, dev,
                                                smi, timer)
        paths += rwkv_paths
    if "zamba" in phases:
        rows["ssd_kernel"], flash80, zamba_paths = timed(
            "zamba", phase_zamba, dev, smi, timer)
        if "flash_attention" in rows:   # hd 64 (granite) and hd 80 (zamba2)
            rows["flash_attention"]["hd80"] = flash80
        else:
            rows["flash_attention"] = flash80
        paths += zamba_paths
    if "train" in phases:
        rows["flash_attention_bwd"], train_paths = timed(
            "train", phase_train, dev, smi, timer, args.seed)
        paths += train_paths
    if "flash_attention" in rows:
        rows["flash_attention"]["hgmma"] = hgmma
    # each kernel's launches summed over the driven paths
    record = []
    for name, r in rows.items():
        source, replaces = KERNEL_ROWS[name]
        record.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p.get(name, 0) for p in paths),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r.get("bound_by", "bytes"),
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("calls", "hd80", "f32_ms", "hgmma",
                                 "library_bsr_ms", "f32_bound_ms", "hmma",
                                 "G", "path", "copy_ms", "whole_bound_ms",
                                 "live_share", "step_ms")
               if k in r}))
    log(f"# chip_smoke wall time: {time.perf_counter() - t_start:.1f} s "
        f"(phases {','.join(p for p in PHASES if p in phases)})")
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
