#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
learned-prefetch sweep, the paper's tree-vs-learned tables, the
oversubscription matrix, the serving matrix, the multi-tenant matrix, the
predictor-family smoke, a full-width Transformer-family sweep, the
paper's predictor tables, the backend chain, crash safety and the LM
zoo's serving and training paths on the card:

1. the device, its power limit, and the kernel build;
2. K1 (multi-lane replay) against the legacy engine at full benchmark
   scale: none/block/learned lanes under lru on all 11 benchmarks, and every
   other family x policy (tree and oracle under lru/random/hotcold,
   none/block/learned under random/hotcold) at half the working set;
3. K1 against ``tests/golden/uvm_golden.json`` and against its plain
   version on whole batches of the 77 golden cells, one batch per kernel
   variant (maximum difference 0), with both timed;
4. K2 (HLSH attention), K3 (int4 matmul) and K4 (flash attention)
   against their plain versions, at the reference's test shapes and types,
   at the predictor's shapes, at the predictor tables' shapes and at the
   edges of K2's and K4's tilings (K2 in both tilings and both types; K4's
   tensor-core tilings, mma and split, in bf16 with k and v also as cache
   views) and K3's variants;
5. the main path: the sweep over the 11 paper benchmarks x {none, tree,
   learned} x {all memory, half the working set}, predictors trained and
   served on the card (the quantized simplified predictor's weight products
   on K3), every row replayed by K1 and persisted to a cell store; tree and
   learned rows equal the legacy engine on the same inputs; then the same
   grid resumed from its cell store: equal rows, no launch, no fit, under
   5 s;
6. the paper's Table 10 and Table 11 (tree vs learned, unlimited memory);
   every tree row equals the legacy engine's; Fig 12 (normalised PCIe
   traffic) and the §7.4 headline (IPC gain, hit rates, traffic) from the
   same 22 rows, beside the paper's figures (reported, not checked);
7. the ``oversub-full`` scenario (660 cells) through the port's sweep,
   sharing the main path's prediction cache; the 2DCONV cells are held
   against the legacy engine;
8. K1 with step clocks against the legacy engine at scale 1.0: every
   family x policy on the five serve traces and ServeBursty@r8 (316 empty
   windows), window clocks bit for bit;
9. K1 with tenant quotas (and the tenants' completion clocks) against the
   legacy engine on each multi-tenant pair under the 0.4/0.4 split (with
   its spill pool), every family x policy; K1 against its plain version on
   a small step-clock batch and a small quota batch of every family x
   policy;
10. the ``serve-full`` scenario (300 cells): every row on cuda with its
    latency percentiles from K1's step clocks; the ServeBursty rows are
    held against the legacy engine;
11. the ``mt-full`` scenario (360 cells, the tenants' solo replays as K1
    lanes of the same sweep): per-tenant hit rates and slowdowns; the
    MVT+StreamTriad rows, solo replays included, are held against the
    legacy engine;
12. the ``transformer-smoke`` scenario under ``ADAPTIVE_selector.json``
    (the assertions of ``scripts/ci_check.sh``: 4 rows on cuda, both
    families, each bench's eviction its selector entry), its replays held
    against the legacy engine;
13. the family path: the 11 benchmarks x learned x the reference
    Transformer family (2 layers, 4 heads, d_model 200, full attention on
    K4) x {all memory, half the working set} under ``adaptive`` eviction
    with no selector table, so every half-memory cell probes on K1; each
    resolved policy equals the legacy engine's probe, cycles included;
    then top-1, F1 and coverage per bench against the simplified family;
14. the paper's predictor tables (Tables 1-8, Figs 5, 6 and 9 of
    ``repro_torch.core.predictor_tables``) at the reference's sizes but
    half its training steps (``PTABLE_STEPS``), 76 distinct fits on the
    card (K4 on every Transformer's evaluation, K2 on
    Table 5's HLSH rows, K3 on Table 8's quantized rows), each table's rows
    and columns and its metrics checked, the reference's own claims
    reported; then Fig 10 (tree and learned at 1, 2, 5 and 10 us per
    prediction on the 11 benchmarks) on the main path's prediction cache,
    training nothing, one bench's rows held against the legacy engine;
15. kernel times from CUDA events beside the plain versions and a PyTorch
    yardstick: K1 against its plain version on the tables' tree batch
    (which never evicts: its slowest lane's time per access gives K1's
    chain bound, the longest lane's accesses at that rate), K1 per kernel
    variant on the largest batch of each path (the step-clock batches also
    without their capture, and through the quota specialisation), each with
    its slowest lane's accesses, evictions, victim-search chunk scans and
    covered slots, K1 on the golden quota batches with their chain bound,
    K1's per-eviction cost and chunk scans against the span its search
    covers, K1 against its plain version on the main path's learned batch,
    K2 (float32 and bf16, with its tiling), K3 and K4 at the predictor's
    shapes and the predictor tables', each per call through its wrapper and
    as device time per launch (a CUDA graph of 20 launches; the profiler
    where a capture fails), in turns with its PyTorch call and its plain
    version;
16. the backend chain: one cell for each route on which K1 declines (Fig
    11's BICG tree and learned cells with their per-transfer timelines, an
    oracle lookahead of 1024, a window per access of a 78,643-access trace,
    a tree trace past 2^21 accesses, a trace spanning past 2^20 pages, and
    an adaptive cell whose probes span it), through ``run_sweep`` or
    ``dispatch`` with ``backend="cuda"``: each row says ``numpy`` and why,
    K1 never launches, and each equals the legacy engine (timelines element
    by element); Fig 11's GB/s series; accesses per second of the legacy
    loop, the NumPy engine and a one-lane K1 batch per family;
17. crash safety, each run a process of its own sharing the card: the
    ``chaos-smoke`` scenario through ``python -m repro_torch.uvm.faults``
    under its default kill+corrupt+raise plan on K1 (``--backend cuda``:
    driver kills before lane batches and mid cell-file write, transient K1
    raises) and, side by side with it on the host, on the NumPy engine
    with 2 lease workers (worker kills), each with the assertions of
    ``scripts/ci_check.sh`` (8 rows equal to
    the fault-free baseline's, at least one fault, an empty quarantine
    manifest), the K1 rows all ``cuda`` and equal to the NumPy rows; then
    the learned lease pool (4 traces x learned x 1 and 2 us, predictors
    trained and served on the card, K2 and K3 in the workers): 4 workers on
    a fresh cache fit once per trace, a rerun on a copy of its cache trains
    nothing and equals it, and 1 worker on a fresh cache is timed beside
    it;
18. the LM serve path (``repro_torch.launch.serve``): llama3-8b at full
    width (32 layers, d_model 4096, 32/8 heads of 128, vocabulary
    128,256) in bf16, weights drawn on the card from a seed, serving 8
    requests of 512 prompt tokens for 64 tokens each through the paged KV
    store (72 blocks against 48 in HBM), K4 the attention of every layer
    (exactly 32 x 64 launches); a teacher-forced run with attention in the
    plain version holds K4 on the path's own inputs at every layer and the
    logits at depth 1 (the full-depth logits are reported: the model is
    chaotic); the store's dumped trace reloaded and replayed on K1 with
    step clocks (none, tree x lru x ratios 1.0 and 0.5) equal to the
    legacy engine; the ten archs at reduced width through prefill and
    decode (K4 on every arch with attn/eattn/xattn blocks, none on mamba2
    and recurrentgemma; the reference's prefill-decode parity on five);
    K4 timed at the prefill's shape (the mma tiling) and the last decode
    step's over a cache view (the split tiling) beside its plain version
    and ``scaled_dot_product_attention(..., enable_gqa=True)``;
19. the LM training path (``repro_torch.launch.train``): smollm-360m at
    full width (32 layers, d_model 960, 15/5 heads of 64, d_ff 2560,
    vocabulary 49,152, tied embeddings, bf16 at init, remat on), weights
    drawn on the card from seed 0, on ``TokenPipeline`` batches of 8 x
    2,048 tokens: (a) 12 steps, ``save_async`` every 10; (b) a fresh run
    resumed from (a)'s step-10 checkpoint, its first loss (a)'s at step 10
    to 1e-6 relative, the pipeline at step 10; (c) 3 steps under each of
    ``int8`` and ``topk``.  Every run's losses are finite, its parameters
    float32 after its first step and its moments and residuals after its
    second (the reference's types), and it launches none of K1-K4 (training
    attention is the plain version); step ms (step 0 apart), tokens/s,
    model FLOP/s against the float32 peak, peak memory, the loss curve,
    the compressors' ms a step and the checkpoint's times are printed;
    one more step of (a) profiled (host clock, device-busy time, idle
    share, kernels);
20. the sharded path (``repro_torch.distributed.sharding``,
    ``launch.{mesh,dryrun,roofline}``): in a process started before phase
    19, the dry-run's step on CUDA fakes on a 1 x 1 mesh at phases 18-19's
    sizes (smollm-360m train, llama3-8b prefill and decode; each roofline
    step and tracked peak printed beside the card's) and llama3-8b
    ``decode_32k`` on the 16 x 16 production mesh (K4's registered op on
    fake DTensors, once a layer); smollm-360m 3 steps through
    ``build_sharded_train`` on the host mesh (one rank, NCCL; FSDP and
    ZeRO-1 on), its losses phase 19 (a)'s to 1e-6; K4's registered op timed
    against its direct call; then the ``kernels`` line and the result
    line.

Every row of the driven paths 5-7 and 10-14 must say ``cuda``: a row on
the NumPy engine or the legacy loop there fails the run.  Each of the
fourteen driven paths (5, 6, 7, 10, 11, 12, 13, 14, 16, 17, 18's serve,
18's trace replay, 19 and 20) zeroes the launch counters just before it and
reads them just after (phase 17's kernels run in its subprocesses, which log
their counts).  The legacy
engine's replays and the plain versions run in a pool of worker processes
on the host.

Usage: ``python3 chip_smoke.py [--out DIR]`` (``--out`` also writes the rows
and kernel records as JSON, and Fig 11's CSV).  Exits non-zero without a
result line when no CUDA device is present or any check fails.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BENCHES = ("AddVectors", "ATAX", "Backprop", "BICG", "Hotspot", "MVT", "NW",
           "Pathfinder", "Srad-v2", "StreamTriad", "2DCONV")
FRACS = (None, 0.5)
#: benches of the new family x policy lanes of phase 2 (the longest lane,
#: NW, and three of differing reuse)
NEW_LANE_BENCHES = ("ATAX", "NW", "Pathfinder", "2DCONV")
#: the matrix bench held against the legacy engine in phase 7
MATRIX_CHECK_BENCH = "2DCONV"
#: serve traces of the step-clock check (phase 8): serve-full's five and
#: ServeBursty@r8, whose windows are a third empty
STEP_CHECK_BENCHES = ("ServeDecode", "ServeTenantMix", "ServeBursty",
                      "ServeBursty@r32", "ServeBursty@r256", "ServeBursty@r8")
#: capacity ratio and quota splits of the quota check (phase 9)
QUOTA_CHECK_RATIO = 0.75
QUOTA_CHECK_SPLITS = ((0.5, 0.5), (0.4, 0.4))
#: the serve bench and the multi-tenant pair whose rows are held against
#: the legacy engine (phases 10 and 11)
SERVE_CHECK_BENCH = "ServeBursty"
MT_CHECK_BENCH = "MVT+StreamTriad"
#: phase 16, the backend chain: the bench of the oracle and throughput
#: cells; the bench of the span and adaptive cells, its arrays from FAR_ARRAY
#: on allocated FAR_SHIFT pages higher (its first 20,000 accesses, the
#: adaptive probe, touch all three arrays); the trace given a window per
#: access (scale 2.0: past 65,536 accesses); and the tree cell past 2^21
#: accesses (NW at scale 5.5: 2,109,388 accesses, a span of 59,392 pages)
CHAIN_BENCH = "BICG"
FAR_BENCH, FAR_ARRAY, FAR_SHIFT = "Pathfinder", "res_a", 1 << 20
WINDOWS_TRACE = ("ATAX", 2.0, 0, 0.6)
LONG_TREE_BENCH, LONG_TREE_SCALE = "NW", 5.5
#: worker processes of the legacy engine and the plain versions
HOST_WORKERS = 7
K1_SOURCE = "src/repro_torch/csrc/lane_replay.cu"
K2_SOURCE = "src/repro_torch/csrc/hlsh_attention.cu"
K3_SOURCE = "src/repro_torch/csrc/int4_matmul.cu"
K4_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
K1_REPLACES = "src/repro/uvm/backends/pallas_backend.py:197"
K2_REPLACES = "src/repro/kernels/hlsh_attention.py:34"
K3_REPLACES = "src/repro/kernels/int4_matmul.py:22"
K4_REPLACES = "src/repro/kernels/flash_attention.py:26"
GOLDEN = os.path.join(ROOT, "tests", "golden", "uvm_golden.json")
SELECTOR = os.path.join(ROOT, "ADAPTIVE_selector.json")
#: the tolerances of tests/test_kernels.py: K2 and K4 absolute, K3
#: relative to |want| + 1
K2_ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
K4_ATOL = {"float32": 2e-4, "bfloat16": 2e-2}
K3_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: K2's cases (B, N, D) and types: the path's shape first (timed in phase
#: 15), the warp-per-row tiling's edges, the reference's test shapes (the
#: general tile) and Table 5's HLSH rows (512 windows x 4 heads of 50
#: dims); together both tilings in both types
K2_REF_SHAPES = ((1, 128, 32), (2, 256, 64), (1, 512, 128))
K2_TABLE5_SHAPE = (2048, 30, 50)
K2_CASES = tuple(((4096, 30, 12), dt) for dt in ("float32", "bfloat16")) + (
    ((64, 1, 12), "float32"), ((16, 32, 64), "float32"),
    ((33, 31, 13), "float32"), ((33, 31, 13), "bfloat16"),
    ((2, 256, 64), "float32")) + tuple(
    (shape, "bfloat16") for shape in K2_REF_SHAPES) + tuple(
    (K2_TABLE5_SHAPE, dt) for dt in ("float32", "bfloat16"))
#: the reference's test shapes: K4 (B, H, Hkv, Sq, Sk, D), K3 (M, K, N)
K4_REF_SHAPES = ((1, 2, 1, 128, 128, 64), (2, 4, 2, 256, 256, 64),
                 (1, 8, 1, 128, 384, 128), (1, 4, 4, 256, 128, 32))
K3_REF_SHAPES = ((128, 128, 256), (128, 256, 256), (256, 128, 512))
#: the predictor's shapes: the Transformer family's heads at inference
#: (4096 sequences x 4 heads x 30 tokens x 200 / 4), the quantized
#: simplified predictor's layer products (4096 x 30 token rows of width 12
#: and 48) and its classification head at the largest class count and at an
#: odd one (padded by one zero column)
K4_PATH_SHAPE = (4096, 4, 4, 30, 30, 50)
#: edges of K3's variants (M = 1000, no tile multiple: odd K, K and N past
#: the narrow limit, rows of out no whole 16-byte chunks, a wide head), with
#: the path's shapes every compiled body in both types, and of K4's tilings
#: (S around a warp's 32 rows, D around its 64, grouped kv heads with Sq >
#: Sk)
K3_EDGE_CASES = tuple(((1000, k, n), "float32") for k, n in (
    (13, 12), (64, 64), (65, 12), (12, 66), (12, 130), (32, 20000),
    (48, 32), (12, 24), (48, 48), (16, 48))) + tuple(
    ((1000, k, n), "bfloat16") for k, n in (
        (48, 48), (16, 20000), (12, 12), (16, 16), (48, 32), (16, 32),
        (32, 48), (64, 64)))
K4_EDGE_SHAPES = ((2, 5, 5, 1, 1, 1), (2, 5, 5, 31, 31, 49),
                  (2, 5, 5, 33, 33, 64), (2, 5, 5, 129, 129, 100),
                  (2, 5, 5, 29, 29, 128), (2, 4, 2, 33, 29, 50))
#: edges of K4's tensor-core tilings in bf16 (B, H, Hkv, Sq, Sk, D, causal,
#: extra cache keys: k and v the first Sk keys of a longer cache, read in
#: place): the split tiling at one key, llama3-8b's decode over its cache
#: view, granite-20b's G = 48 over splits of several tiles, qwen3-moe's G =
#: 16, four causal rows a head over 600 keys, 64 rows in 4 slices, cross
#: attention; the mma tiling at a ragged 63-row tile, two tiles of 65 rows,
#: 1,000 rows, over a cache view, and more queries than keys unmasked
K4_TC_CASES = ((2, 4, 1, 1, 1, 64, True, 0), (8, 32, 8, 1, 575, 128, True, 1),
               (2, 48, 1, 1, 4097, 128, True, 0),
               (2, 32, 2, 1, 65, 64, True, 0), (2, 8, 2, 4, 600, 64, True, 0),
               (2, 4, 4, 64, 64, 128, False, 0),
               (2, 16, 16, 40, 200, 64, False, 0),
               (2, 3, 1, 63, 63, 128, True, 0), (2, 4, 4, 65, 65, 64, True, 0),
               (1, 8, 2, 1000, 1000, 64, True, 0),
               (2, 12, 4, 100, 300, 128, True, 37),
               (1, 2, 1, 129, 31, 64, False, 0))
K3_PATH_SHAPES = ((4096 * 30, 12, 12), (4096 * 30, 12, 48),
                  (4096 * 30, 48, 12), (4096, 12, 20000), (4096, 12, 19999))
#: the predictor tables' shapes at the evaluation batch of 512 windows: K4
#: on Fig 5's single-feature Transformers (4 heads of 2 to 8 dims) and on
#: the revised rows of Table 8 and Fig 9 (1 head of 12); K3 on Table 8's
#: quantized layer products (the head's N is each bench's class count,
#: found in phase 4)
K4_TABLE_SHAPES = tuple((512, 4, 4, 30, 30, d) for d in (2, 3, 4, 6, 8)) + (
    (512, 1, 1, 30, 30, 12),)
K3_TABLE8_SHAPES = ((512 * 30, 12, 12), (512 * 30, 12, 48),
                    (512 * 30, 48, 12))
#: phase 14's predictor training steps, (STEPS, REVISED_STEPS, FIG5_STEPS)
#: of repro_torch.core.predictor_tables: half the reference's (150, 400,
#: 150), cut (its checks unchanged) to keep the whole run under 1,100 s of
#: its 1,200 with phase 20 on a host whose fits run 1.5x slower
PTABLE_STEPS = (75, 200, 75)
#: the bench whose Fig 10 rows are held against the legacy engine
FIG10_CHECK_BENCH = "NW"
#: the Transformer family's learned cells (phase 13)
FAMILY = "transformer"
#: the bench whose quantized simplified inference is timed with and without
#: K3 (phase 15): an HLSH bench with many windows
INFER_BENCH = "NW"
#: published H100 SXM peaks: HBM bytes/s, float32 FLOP/s outside the
#: tensor cores, bf16 FLOP/s on the tensor cores (dense)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: phase 18, the LM serve path: llama3-8b at full width in bf16, served by
#: repro_torch.launch.serve (9 KV blocks of 64 tokens a request, 72 in all,
#: against 48 in HBM, so the store evicts and prefetches)
LM_ARCH = "llama3-8b"
LM_SERVE = {"requests": 8, "prompt_len": 512, "gen": 64, "hbm_blocks": 48}
#: decode steps held against the plain-attention run, teacher-forced
LM_CHECK_STEPS = 4
#: the LM path against the same model with attention in the plain version
#: (on float32 copies of q, k, v), teacher-forced on the K4 run's tokens.
#: Per call: every attention call of the full-depth model's prefill and
#: first LM_CHECK_STEPS decode steps runs K4 and the plain version on the
#: same inputs (the path's own activations); K4's bf16 output is the
#: float32 result rounded once (at most 2^-8 of the largest output) plus
#: float32 summation differences: limit max |K4 - plain| <= LM_CALL_TOL x
#: max |plain|.  End to end, the full-depth logits cannot be held at any
#: such tolerance: under the reference's initialisation (wq scaled by
#: 1/sqrt(n_heads)) attention logits have a spread of about 256, so each
#: softmax is nearly an argmax, a difference in the last bit flips a row's
#: key, and 32 layers compound the flips (two float32 runs that differ only
#: in the order of attention's sums give logits 1.1-1.3 apart, relative).
#: So the full-depth logits are compared and reported, and the logits are
#: held at depth 1 (the model's first layer, the same weights), where no
#: flip compounds: limit LM_TOL x max |plain|, 8 bf16 roundings (2^-8) of
#: the largest logit
LM_CALL_TOL = 2.0 ** -7
LM_TOL = 2.0 ** -5
#: the reference's prefill-decode parity (tests/test_models_zoo.py):
#: archs, batch, prompt length and tolerance (atol and rtol)
LM_PARITY_ARCHS = ("llama3-8b", "mamba2-780m", "recurrentgemma-9b",
                   "internvl2-1b", "seamless-m4t-medium")
LM_PARITY_B, LM_PARITY_S, LM_PARITY_TOL = 2, 32, 2e-2
#: the replay of the dumped serve trace: prefetchers under lru, and ratios
#: of the trace's working set
LM_REPLAY_PREFETCHERS = ("none", "tree")
LM_REPLAY_RATIOS = (1.0, 0.5)
#: phase 19, the LM training path: smollm-360m at full width (its config:
#: 32 layers, d_model 960, 15/5 heads of 64, d_ff 2560, vocabulary 49,152,
#: tied embeddings, bf16 at init, remat on), weights drawn on the card from
#: seed 0, trained by repro_torch.launch.train on TokenPipeline batches of
#: 8 x 2,048 tokens (SmolLM's context length) with AdamW(weight_decay=0.1,
#: clip_norm=1.0) and linear_warmup_cosine(3e-4, 10, steps): (a) 12 steps
#: with save_async every 10, (b) a fresh run resumed from (a)'s step-10
#: checkpoint to step 12, (c) 3 steps under each gradient compressor; the
#: step counts keep the whole run under 1,100 s of its 1,200
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_COMPRESS_STEPS = 12, 10, 3
TRAIN_LR, TRAIN_WARMUP = 3e-4, 10
#: the resumed run's first loss against (a)'s at step 10: the same
#: parameters (restored bit for bit) and the same batch on the same card
TRAIN_RESUME_TOL = 1e-6
#: phase 20, the sharded path (repro_torch.distributed.sharding,
#: launch.{mesh,dryrun,roofline}, launch.train.build_sharded_train): (a) the
#: dry-run's step on CUDA fakes on a 1 x 1 mesh at phases 18-19's sizes,
#: (arch, kind, sequence or cache length, batch), its roofline step and
#: tracked peak printed beside what phases 18-19 measured; (b) llama3-8b
#: decode_32k on the 16 x 16 production mesh (fake DTensors; K4's
#: registered op once per layer); both in a subprocess on a fake process
#: group, started before phase 19 and overlapping it on the host;
#: (c) smollm-360m through build_sharded_train on the host mesh (one rank,
#: NCCL), FSDP and ZeRO-1 on, MESH_TRAIN_STEPS steps of phase 19 (a)'s
#: schedule, its losses (a)'s first to MESH_TRAIN_TOL relative; then K4's
#: registered op against its direct call, host ms a call at the decode
#: step's shape (MESH_DISPATCH_CALLS calls, in turns)
MESH_CAL_CELLS = (("smollm-360m", "train", TRAIN_SEQ, TRAIN_BATCH),
                  ("llama3-8b", "prefill", LM_SERVE["prompt_len"],
                   LM_SERVE["requests"]),
                  ("llama3-8b", "decode",
                   LM_SERVE["prompt_len"] + LM_SERVE["gen"] - 1,
                   LM_SERVE["requests"]))
MESH_CELL = ("llama3-8b", "decode_32k")
MESH_TRAIN_STEPS = 3
MESH_TRAIN_TOL = 1e-6
MESH_DISPATCH_CALLS = 200
#: bytes that timed calls touch before one touches the same memory again:
#: four times the H100's 50 MB L2, so each call reads and writes HBM
ROTATE_BYTES = 200e6
INT_FIELDS = ("hits", "late", "faults", "prefetch_issued", "prefetch_used",
              "pages_migrated", "pages_evicted")


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def same_stats(got, want, what: str) -> None:
    """Counters exact, cycles/pcie_bytes within 1e-6 relative, and the
    per-tenant hits and step clocks (where the replay has them) exact."""
    import numpy as np
    for f in INT_FIELDS:
        check(getattr(got, f) == getattr(want, f),
              f"{what}: {f} {getattr(got, f)} != {getattr(want, f)}")
    for f in ("cycles", "pcie_bytes"):
        g, w = getattr(got, f), getattr(want, f)
        check(abs(g - w) <= 1e-6 * abs(w),
              f"{what}: {f} {g!r} != {w!r} beyond 1e-6 relative")
    check(got.tenant_hits == want.tenant_hits
          and got.tenant_accesses == want.tenant_accesses,
          f"{what}: tenant hits {got.tenant_hits} != {want.tenant_hits}")
    check((got.step_clocks is None) == (want.step_clocks is None)
          and (want.step_clocks is None
               or np.array_equal(got.step_clocks, want.step_clocks)),
          f"{what}: step clocks differ from the legacy engine's")


def legacy_replay(req):
    """The legacy engine on one request (a host worker's job)."""
    from repro_torch.uvm.simulator import UVMSimulator
    return UVMSimulator(req.config, req.record_timeline).run(
        req.trace, req.prefetcher, step_bounds=req.step_bounds)


def relocated(trace, first_array: str, shift: int):
    """``trace`` with the arrays from ``first_array`` on (in base order)
    allocated ``shift`` pages higher: the same accesses, the span ``shift``
    pages wider (a root-aligned shift keeps every prefetcher's blocks)."""
    import numpy as np
    cut = trace.array_bases[first_array]
    acc = trace.accesses.copy()
    acc["page"] = np.where(acc["page"] >= cut, acc["page"] + shift,
                           acc["page"])
    bases = {a: b + (shift if b >= cut else 0)
             for a, b in trace.array_bases.items()}
    return dataclasses.replace(trace, name=f"{trace.name}-far",
                               accesses=acc, array_bases=bases)


def plain_replay(kwargs):
    """K1's plain version on one lane batch's CPU arguments (a host
    worker's job): (result, seconds)."""
    from repro_torch.kernels.lane_replay import lane_replay_plain
    t0 = time.perf_counter()
    out = lane_replay_plain(**kwargs)
    return out, time.perf_counter() - t0


def init_worker() -> None:
    import torch
    torch.set_num_threads(1)


def per_backend(rows) -> dict:
    """Rows per backend, as a dict for the path's print."""
    import collections
    return dict(collections.Counter(r["backend"] for r in rows))


def all_cuda(rows, what: str) -> None:
    """Every row of a driven path ran on K1: a row on the NumPy engine or
    the legacy loop is a failure there."""
    check(all(r["backend"] == "cuda" for r in rows),
          f"{what} did not run on the cuda backend: rows per backend "
          f"{per_backend(rows)}")


def same_row(row, want, what: str) -> None:
    """A sweep row against legacy ``UVMStats`` of the same inputs."""
    for f in INT_FIELDS:
        check(row[f] == getattr(want, f),
              f"{what}: {f} {row[f]} != legacy {getattr(want, f)}")
    for f in ("cycles", "pcie_bytes"):
        check(abs(row[f] - getattr(want, f)) <= 1e-6 * abs(getattr(want, f)),
              f"{what}: {f} {row[f]} != legacy {getattr(want, f)}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, from CUDA events
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, the graph replayed ``replays`` times between CUDA
    events, so no host work sits between the launches.  None if the
    capture fails."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception as exc:      # a launch that cannot be captured
        torch.cuda.synchronize()
        print(f"chip_smoke: CUDA graph capture failed ({type(exc).__name__}:"
              f" {exc}); timing with the profiler", flush=True)
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def profiled_ms(fn, reps: int):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``: the
    device time of every kernel the ``reps`` calls ran.  None if the trace
    shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def device_ms(fn, reps: int = 20):
    """(device milliseconds per call, method): a CUDA graph of ``reps``
    calls, else the profiler's device time, else (None, "not measured")."""
    ms = graph_ms(fn, reps)
    if ms is not None:
        return ms, "graph"
    ms = profiled_ms(fn, reps)
    return (ms, "profiler") if ms is not None else (None, "not measured")


def copies_of(inputs, call_bytes: float):
    """``inputs`` and enough clones of them that calls taking them in turn
    touch ``ROTATE_BYTES`` (each call ``call_bytes``) before they come back
    to the same copy."""
    n = max(1, math.ceil(ROTATE_BYTES / call_bytes))
    return [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(n - 1)]


def rotating(fn, copies):
    """A call of ``fn`` on each of ``copies`` in turn, so that every call
    reads inputs and writes an output that are not in L2, as on a path that
    moves on through its data.  Each result is held until its copy comes
    round again, so that outputs do not share memory either (within a CUDA
    graph's capture as well)."""
    held = [None] * len(copies)
    turn = itertools.count()

    def call():
        i = next(turn) % len(copies)
        held[i] = fn(*copies[i])
    # one round and one call more, so that the allocator already holds
    # every output (and the one being replaced) when the timing starts
    for _ in range(len(copies) + 1):
        call()
    return call


def timed_in_turns(fns, reps: int = 20):
    """Per-call and device milliseconds of each of ``fns`` (name -> call),
    timed in turns (forward, then backward: a, b, c, c, b, a), each the
    mean of its two turns: {name: {"ms", "device_ms", "method"}}."""
    names = list(fns)
    runs = {n: {"ms": [], "device_ms": [], "method": set()} for n in names}
    for n in names + names[::-1]:
        runs[n]["ms"].append(cuda_ms(fns[n], reps))
        ms, method = device_ms(fns[n], reps)
        runs[n]["device_ms"].append(ms)
        runs[n]["method"].add(method)
    out = {}
    for n, r in runs.items():
        dev = None if None in r["device_ms"] else sum(r["device_ms"]) / 2
        out[n] = {"ms": sum(r["ms"]) / 2, "device_ms": dev,
                  "method": "/".join(sorted(r["method"]))}
    return out


def k1_bound_ms(batch) -> float:
    """Least time for K1's bytes: each input read once (the real accesses'
    pages, predictions and stream positions, the first-touch streams, the
    parameter blocks), each stat written once, over the HBM rate."""
    n_acc = int(batch.iparams[:, 0].sum())
    per_access = 4 + sum(4 for a in (batch.preds, batch.pos, batch.sids)
                         if a is not None)
    n_ft = int(batch.iparams[:, 4].clip(min=0).sum()) if (
        batch.ft is not None) else 0
    lanes = int((batch.iparams[:, 0] > 0).sum())
    nbytes = (n_acc * per_access + n_ft * 4 + lanes * (8 * 8 + 9 * 4)
              + lanes * 10 * 8 + lanes * batch.steps_len * 8)
    return nbytes / HBM_BYTES_S * 1e3


def lane_scan_end(batch, lane: int) -> int:
    """The slots K1's victim search covers in one lane of ``batch``: up to
    the root window of its highest page, prediction or first touch."""
    n = int(batch.iparams[lane, 0])
    hi = int(batch.pages[lane, :n].max()) if n else -1
    if batch.preds is not None and n:
        hi = max(hi, int(batch.preds[lane, :n].max()))
    n_ft = int(batch.iparams[lane, 4])
    if batch.ft is not None and n_ft > 0:
        hi = max(hi, int(batch.ft[lane, :n_ft].max()))
    return min(batch.span, (hi // 512 + 1) * 512)


def k1_lanes(batch):
    """One K1 launch on ``batch`` with its per-lane record: (the stats on
    the host, the slowest lane by the card's global timer: its
    microseconds, accesses, evictions, victim-search chunk scans, the
    slots its search covers, its selection rounds and their
    evictions)."""
    from repro_torch.kernels.lane_replay import lane_replay
    from repro_torch.uvm.backends.cuda_backend import lane_info_buffer
    info = lane_info_buffer(len(batch.pages), "cuda")
    out = lane_replay(**batch.kernel_args("cuda"), lane_info=info)
    out = (out[0] if batch.steps_len else out).cpu()
    info = info.cpu()
    slow = int(info[:, 1].argmax())
    return out, {"us": int(info[slow, 1]) / 1e3,
                 "accesses": int(batch.iparams[slow, 0]),
                 "evictions": int(out[slow, 7]),
                 "chunk_scans": int(info[slow, 0]),
                 "scanned_slots": lane_scan_end(batch, slow),
                 "rounds": int(info[slow, 2]),
                 "round_evictions": int(info[slow, 3])}


def lane_text(x) -> str:
    return (f"slowest lane {x['us'] / 1e3:.1f} ms: {x['accesses']} "
            f"accesses, {x['evictions']} evictions, {x['chunk_scans']} "
            f"chunk scans over {x['scanned_slots']} slots, {x['rounds']} "
            f"rounds evicting {x['round_evictions']}")


def variant_key(batch):
    """K1's variant of one lane batch: (family, policy[, steps][, quotas])."""
    from repro_torch.kernels.lane_replay import kind_key
    return kind_key(batch.family, batch.policy, batch.steps_len,
                    batch.quotas)


def new_variant(key, **fields):
    return {"family": key[0], "policy": key[1],
            "variant": "+".join(key[2:]) or "base", **fields}


def path_batches(backend, requests):
    """The lane batches a sweep of ``requests`` launches, by K1 variant."""
    by_key = {}
    for idx in backend.pack_lanes(requests):
        batch = backend.pack_batch([requests[i] for i in idx])
        by_key.setdefault(variant_key(batch), []).append(batch)
    return by_key


def plain_job(batch):
    """The CPU arguments of K1's plain version on one lane batch."""
    cpu = batch.kernel_args("cpu")
    cpu.pop("buf_len")
    return cpu


def k1_against(batch, plain):
    """K1 on one lane batch against its plain version's result ``plain``
    (from :func:`plain_replay`): (max abs difference of the stats and
    window clocks, kernel stats)."""
    from repro_torch.kernels.lane_replay import lane_replay
    got = lane_replay(**batch.kernel_args("cuda"))
    err = 0.0
    if batch.steps_len:
        (got, got_steps), (plain, plain_steps) = got, plain
        err = float((got_steps.cpu() - plain_steps).abs().max())
    got = got.cpu()
    return max(err, float((got - plain).abs().max())), got


def k1_vs_plain(batch):
    """K1 and its plain version on one lane batch, in this process: (max
    abs difference, kernel stats, plain seconds)."""
    want, plain_s = plain_replay(plain_job(batch))
    err, got = k1_against(batch, want)
    return err, got, plain_s


def cuda_randn(rng, shape, dtype):
    """Standard normal draws from the numpy generator ``rng``, on the card
    in ``dtype``."""
    import torch
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                        device="cuda").to(dtype)


def k4_against_plain(rng, shape, causal, dtype):
    """K4 and its plain version on one (B, H, Hkv, Sq, Sk, D) draw: (max
    abs difference, (q, k, v))."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    b, h, hkv, sq, sk, d = shape
    q = cuda_randn(rng, (b, h, sq, d), dtype)
    k = cuda_randn(rng, (b, hkv, sk, d), dtype)
    v = cuda_randn(rng, (b, hkv, sk, d), dtype)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    return float((got.float() - want.float()).abs().max()), (q, k, v)


def cache_view(rng, shape, extra):
    """q and k, v of a (B, H, Hkv, Sq, Sk, D) shape in bf16 on the card, k
    and v the first Sk keys of a cache of Sk + ``extra`` keys (a view, as a
    decode step hands them to K4; contiguous where ``extra`` is 0)."""
    import torch
    b, h, hkv, sq, sk, d = shape
    q = cuda_randn(rng, (b, h, sq, d), torch.bfloat16)
    k, v = (cuda_randn(rng, (b, hkv, sk + extra, d), torch.bfloat16)[
        :, :, :sk] for _ in range(2))
    return q, k, v


def k4_tiling(shape, dtype, causal) -> str:
    """The tiling K4's wrapper picks for a (B, H, Hkv, Sq, Sk, D) shape."""
    from repro_torch.kernels.flash_attention import flash_geometry
    b, h, hkv, sq, sk, d = shape
    return flash_geometry(b * h, sq, sk, d, dtype, h // hkv, causal).tiling


def rel_err(got, want) -> float:
    """The reference's K3 measure: max |got - want| / (|want| + 1)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (want.abs() + 1.0)).max())


def k3_against_plain(rng, m, kdim, n, dtype, packer: bool):
    """K3 and its plain version on one (M, K) x (K, N) draw: random bytes
    and scale 0.03 as the reference's tests draw them, or (``packer``) a
    weight packed by ``pack_int4_like_fake_quant`` (an odd N padded by one
    column), where the plain product must also equal ``x @
    fake_quant_tensor(w)``.  Returns (relative error, max abs difference,
    (x, packed, scale))."""
    import torch
    from repro_torch.core.quantize import (fake_quant_tensor,
                                           pack_int4_like_fake_quant)
    from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_plain
    x = cuda_randn(rng, (m, kdim), dtype)
    if packer:
        w = cuda_randn(rng, (kdim, n), torch.float32) * 0.3
        packed, scale = pack_int4_like_fake_quant(w)
    else:
        packed = torch.tensor(rng.integers(0, 256, (kdim, n // 2)),
                              dtype=torch.uint8, device="cuda")
        scale = 0.03
    got = int4_matmul(x, packed, scale)[:, :n]
    want = int4_matmul_plain(x, packed, scale)[:, :n]
    err = rel_err(got, want)
    if packer:
        err = max(err, rel_err(want, x @ fake_quant_tensor(w).to(dtype)))
    return err, float((got.float() - want.float()).abs().max()), (
        x, packed, scale)


def rel_max(got, want) -> float:
    """max |got - want| / max |want| in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def k4_lm_record(rng, shape, causal, extra=0):
    """K4 at a (B, H, Hkv, Sq, Sk, D) bf16 shape of the LM path (k and v the
    first Sk keys of a cache of Sk + ``extra``, read in place, as a decode
    step reads them), its PyTorch call (one
    ``scaled_dot_product_attention(..., enable_gqa=True)`` on the same
    tensors; causal only where Sq = Sk, since its causal mask is aligned to
    the top left, and for Sq = 1 over the cache written so far every key is
    visible) and its plain version, in turns over rotating copies; its
    error against the plain version on float32 copies."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost,
                                                     flash_attention_plain,
                                                     flash_geometry,
                                                     split_plan)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, hkv, sq, sk, d = shape
    qkv = cache_view(rng, shape, extra)
    err = rel_max(flash_attention(*qkv, causal=causal),
                  flash_attention_plain(*(t.float() for t in qkv),
                                        causal=causal))
    # the work K4's bound and its registered op's FLOP count read
    ops, nbytes = flash_attention_cost(qkv[0].shape, qkv[1].shape, causal,
                                       2)
    def clone(t):
        """A copy of ``t`` in a cache of its own of Sk + extra keys."""
        cache = t.new_empty((b, t.shape[1], sk + extra, d))
        cache[:, :, :sk] = t
        return cache[:, :, :sk]

    copies = [qkv] + [(qkv[0].clone(), clone(qkv[1]), clone(qkv[2]))
                      for _ in range(max(1, math.ceil(ROTATE_BYTES / nbytes))
                                     - 1)]
    t = timed_in_turns({
        "kernel": rotating(lambda q, k, v: flash_attention(
            q, k, v, causal=causal), copies),
        "library": rotating(lambda q, k, v: sdpa(
            q, k, v, is_causal=causal and sq == sk, enable_gqa=True),
            copies),
        "plain": rotating(lambda q, k, v: flash_attention_plain(
            q, k, v, causal=causal), copies)})
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / BF16_FLOPS * 1e3
    bound = max(by_bytes, by_ops)
    dev = t["kernel"]["device_ms"]
    geo = flash_geometry(b * h, sq, sk, d, torch.bfloat16, h // hkv, causal)
    variant = geo.name()
    if geo.tiling == "split":
        splits, split_keys, groups = split_plan(b * hkv, sk, h // hkv * sq)
        variant += (f" ({splits} splits of {split_keys} keys, {groups} key "
                    f"groups: {b * hkv * splits} blocks)")
    return {"shape": list(shape), "dtype": "bfloat16", "causal": causal,
            "path": "LM serve", "kv_view": extra > 0,
            "rel_err_vs_float32_plain": err,
            "tiling": geo.tiling, "variant": variant,
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "ms": t["kernel"]["ms"], "device_ms": dev,
            "plain_ms": t["plain"]["ms"],
            "plain_device_ms": t["plain"]["device_ms"],
            "library_ms": t["library"]["ms"],
            "library_device_ms": t["library"]["device_ms"],
            "share_of_bound": None if dev is None else bound / dev,
            "timing": t["kernel"]["method"]}


def decode_profile(model, params, b, s, gen, steps=3):
    """Where a decode step's time goes: the mean host-clock milliseconds
    of ``steps`` decode steps (after a prefill of ``b`` x ``s`` random
    tokens and one warm-up step, ending in a synchronize), then the same
    steps under ``torch.profiler``: device-busy milliseconds a step (the
    sum of its kernels' device time), kernels a step, K4's device time a
    step, the idle share (1 - busy / host clock) and the five kernels with
    the most device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import builder as lmb
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab, (b, s))).cuda()
    _, states = lmb.prefill(model, params, {"tokens": tokens},
                            max_len=s + gen)
    toks = tokens[:, -1:]
    lmb.decode(model, params, states, toks, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        lmb.decode(model, params, states, toks, s + 1 + i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            lmb.decode(model, params, states, toks, s + 1 + steps + i)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    k4 = sum(e.self_device_time_total for e in dev
             if "flash" in e.key) / 1e3 / steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    del states
    return {"steps": steps, "wall_ms": wall, "busy_ms": busy,
            "kernels": sum(e.count for e in dev) / steps, "k4_ms": k4,
            "idle_share": max(0.0, 1 - busy / wall),
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / steps)
                    for e in top]}


def lm_phase(card: str, work: str, pool, backend, reset_counts,
             read_counts) -> dict:
    """Phase 18, the LM serve path: (a) llama3-8b at full width served by
    the port's launcher, held against the same model with attention in the
    plain version; (b) its dumped trace replayed on K1 against the legacy
    engine; (c) the ten archs at reduced width through prefill and decode;
    (d) K4 timed at the path's shapes.  Returns the phase's records."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import builder as lmb
    from repro_torch.models import layers as lml
    from repro_torch.offload.serve_trace import (load_trace_npz,
                                                 trace_step_bounds)
    from repro_torch.uvm.config import UVMConfig
    from repro_torch.uvm.prefetchers import NoPrefetcher, TreePrefetcher
    from repro_torch.uvm.replay_core import ReplayRequest

    t18 = time.perf_counter()
    out = {}
    # (a) llama3-8b at full width, weights drawn on the card from seed 0
    cfg = get_arch(LM_ARCH)
    model = lmb.build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lmb.init_params(model,
                             torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = lm_serve.serve(LM_ARCH, device="cuda", params=params, **LM_SERVE)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    gen, b = LM_SERVE["gen"], LM_SERVE["requests"]
    s = LM_SERVE["prompt_len"]
    check(launches["flash_attention"] == cfg.n_layers * gen
          and launches["lane_replay"] == launches["hlsh_attention"]
          == launches["int4_matmul"] == 0,
          f"LM serve launches {launches}, not K4 x {cfg.n_layers * gen}")
    check(res.tokens.shape == (b, gen), f"LM serve tokens {res.tokens.shape}")
    check(bool(torch.isfinite(res.prefill_logits).all())
          and bool(torch.isfinite(res.decode_logits).all()),
          "LM serve: logits not all finite")
    st = res.stats
    check(st["evictions"] > 0, f"LM serve: the store never evicted: {st}")
    prof = decode_profile(model, params, b, s, gen)
    out["decode_profile"] = prof
    print(f"phase 18 {card}: a decode step (outside the serve, "
          f"{prof['steps']} steps after a prefill): {prof['wall_ms']:.2f} ms "
          f"on the host's clock, the device busy {prof['busy_ms']:.2f} ms of "
          f"it ({prof['kernels']:.0f} kernels; K4 {prof['k4_ms']:.3f} ms; "
          f"idle share {100 * prof['idle_share']:.1f}%); by device time "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in prof["top"]), flush=True)
    # the same model with attention in the plain version (on float32
    # copies), teacher-forced on the K4 run's tokens: every attention call
    # also runs K4 on its inputs (comparison launches, not counted above)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s))).cuda()}
    call_errs = []

    def plain_attention(q, k, v, causal=False):
        want = flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal)
        call_errs.append(rel_max(flash_attention(q, k, v, causal=causal),
                                 want))
        return want.to(q.dtype)

    def forced(m, attention, p=params):
        """Prefill and LM_CHECK_STEPS decode steps of ``m`` on the K4
        run's tokens: the last-position logits of each."""
        with mock.patch.object(lml, "flash_attention", attention):
            logits, states = lmb.prefill(m, p, batch, max_len=s + gen)
            got = [logits[:, -1]]
            for step in range(LM_CHECK_STEPS):
                toks = torch.from_numpy(res.tokens[:, step:step + 1]).cuda()
                logits, states = lmb.decode(m, p, states, toks, s + step)
                got.append(logits[:, -1])
        return got

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    full = forced(model, plain_attention)
    k4_logits = [res.prefill_logits[:, -1]] + [
        res.decode_logits[step] for step in range(LM_CHECK_STEPS)]
    errs = [rel_max(a, b) for a, b in zip(k4_logits, full)]
    full_agree = [agree(a, b) for a, b in zip(k4_logits, full)]
    one = lmb.with_counts(model, [1])
    one_k4 = forced(one, flash_attention)
    one_plain = forced(one, plain_attention)
    check(len(call_errs) == (cfg.n_layers + 1) * (1 + LM_CHECK_STEPS)
          and max(call_errs) <= LM_CALL_TOL,
          f"LM serve: K4 against the plain version on the path's inputs, "
          f"{len(call_errs)} calls, relative error up to {max(call_errs)} "
          f"(limit {LM_CALL_TOL})")
    one_errs = [rel_max(a, b) for a, b in zip(one_k4, one_plain)]
    one_agree = [agree(a, b) for a, b in zip(one_k4, one_plain)]
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in full + one_k4),
          "LM serve: the checks' logits are not all finite")
    check(max(one_errs) <= LM_TOL, f"LM serve at depth 1: logits against "
          f"plain attention, relative errors {one_errs} (limit {LM_TOL})")
    # how far two full-depth runs drift that differ only in rounding
    # (reported): the plain version in bf16 against it on float32 copies;
    # then a float32 copy of the model (the bf16 weights converted in
    # place), K4 against the plain version
    drift_bf16 = [rel_max(a, b) for a, b in zip(forced(
        model, flash_attention_plain), full)]
    del full, one_k4, one_plain, k4_logits
    model32 = lmb.build_model(dataclasses.replace(cfg, dtype="float32"))
    params.float()
    drift_f32 = [rel_max(a, b) for a, b in zip(
        forced(model32, flash_attention), forced(model32,
                                                 flash_attention_plain))]
    tok_s = res.n_decoded / res.decode_s
    out["serve"] = {
        "arch": LM_ARCH, **LM_SERVE, "params": n_params, "init_s": init_s,
        "prefill_ms": res.prefill_s * 1e3, "decode_s": res.decode_s,
        "decoded": res.n_decoded, "tok_s": tok_s, "store": st,
        "peak_bytes": peak, "launches": launches,
        "call_rel_err_max": max(call_errs), "calls_checked": len(call_errs),
        "full_depth_rel_err": errs, "full_depth_argmax_agree": full_agree,
        "depth1_rel_err": one_errs, "depth1_argmax_agree": one_agree,
        "drift_bf16_plain_vs_float32_plain": drift_bf16,
        "drift_float32_k4_vs_plain": drift_f32}
    print(f"phase 18 {card}: {LM_ARCH} at full width ({n_params / 1e9:.2f}B "
          f"bf16 parameters drawn on the card in {init_s:.2f} s), "
          f"{b} requests x {s} prompt tokens x {gen} generated: prefill "
          f"{res.prefill_s * 1e3:.1f} ms, {res.n_decoded} tokens decoded in "
          f"{res.decode_s:.3f} s ({tok_s:.1f} tok/s); kv-store hit rate "
          f"{st['hit_rate']:.4f}, prefetch accuracy "
          f"{st['prefetch_accuracy']:.4f}, host bytes {st['host_bytes']:.0f}"
          f", evictions {st['evictions']:.0f}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    print(f"phase 18 {card}: against attention in the plain version "
          f"(prefill and {LM_CHECK_STEPS} teacher-forced steps): K4 on the "
          f"path's inputs in {len(call_errs)} calls, relative error up to "
          f"{max(call_errs):.3g} (limit {LM_CALL_TOL}); logits at depth 1 "
          f"relative {', '.join(f'{e:.3g}' for e in one_errs)} (limit "
          f"{LM_TOL}), argmax equal on {one_agree}; logits at full depth "
          f"(reported, not held: the model is chaotic) relative "
          f"{', '.join(f'{e:.3g}' for e in errs)}, argmax equal on "
          f"{full_agree}; full-depth drift between runs that differ only "
          f"in rounding: the plain version in bf16 against it on float32 "
          f"copies {', '.join(f'{e:.3g}' for e in drift_bf16)}, a float32 "
          f"copy of the model, K4 against the plain version "
          f"{', '.join(f'{e:.3g}' for e in drift_f32)}", flush=True)
    res.prefill_logits = res.decode_logits = None
    del params
    torch.cuda.empty_cache()

    # (b) the dumped trace, reloaded and replayed on K1 with step clocks
    path = os.path.join(work, "lm_serve_trace.npz")
    lm_serve.dump_trace(res, path)
    tr = load_trace_npz(path)
    bounds = trace_step_bounds(tr)
    check(list(bounds) == res.step_ends, "the dumped trace's step ends")
    makers = {"none": NoPrefetcher, "tree": TreePrefetcher}
    reqs = [ReplayRequest(tr, makers[name](), UVMConfig(
        device_pages=int(tr.working_set_pages * ratio), eviction="lru"),
        step_bounds=bounds)
        for name in LM_REPLAY_PREFETCHERS for ratio in LM_REPLAY_RATIOS]
    reset_counts()
    t0 = time.perf_counter()
    stats = backend.replay(reqs)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay_launches = read_counts()
    check(replay_launches["lane_replay"] > 0, "the dumped trace: no K1")
    rows = []
    for req, got, want in zip(reqs, stats, pool.map(legacy_replay, reqs)):
        what = (f"dumped {LM_ARCH} trace {type(req.prefetcher).__name__}/"
                f"{req.config.device_pages} pages")
        check(got.backend == "cuda" and got.step_clocks is not None,
              f"{what}: backend {got.backend}")
        same_stats(got, want, what)
        rows.append({"prefetcher": type(req.prefetcher).__name__,
                     "device_pages": req.config.device_pages,
                     "hit_rate": got.hit_rate,
                     "faults": int(got.faults), "backend": got.backend})
    out["trace_replay"] = {"accesses": len(tr), "steps": len(bounds),
                           "working_set_pages": int(tr.working_set_pages),
                           "rows": rows, "seconds": replay_s,
                           "launches": replay_launches}
    print(f"phase 18 {card}: the dumped trace ({len(tr)} accesses, "
          f"{len(bounds)} decode steps, working set "
          f"{tr.working_set_pages} pages) replayed on K1 with step clocks, "
          f"{len(rows)} rows (none, tree x lru x ratios {LM_REPLAY_RATIOS}) "
          f"all cuda and equal to the legacy engine, in {replay_s:.2f} s; "
          f"hit rates {[round(r['hit_rate'], 4) for r in rows]}, faults "
          f"{[r['faults'] for r in rows]}; launches "
          f"{replay_launches}", flush=True)

    # (c) the ten archs at reduced width through prefill and decode
    arch_rows = {}
    for name in list_archs():
        rcfg = get_arch(name).reduced()
        rmodel = lmb.build_model(rcfg)
        rparams = lmb.init_params(
            rmodel, torch.Generator(device="cuda").manual_seed(1))
        prng = np.random.default_rng(1)
        pb = {"tokens": torch.from_numpy(prng.integers(
            0, rcfg.vocab, (LM_PARITY_B, LM_PARITY_S))).cuda()}
        if rcfg.family == "vlm":
            pb["patches"] = torch.from_numpy(prng.normal(size=(
                LM_PARITY_B, rcfg.frontend_seq, rcfg.d_model))).float().cuda()
        if rcfg.family == "audio":
            pb["frames"] = torch.from_numpy(prng.normal(size=(
                LM_PARITY_B, LM_PARITY_S // 8, rcfg.d_model))).float().cuda()
        prefix = rcfg.frontend_seq if rcfg.family == "vlm" else 0
        reset_counts()
        logits1, rstates = lmb.prefill(rmodel, rparams, pb,
                                       max_len=prefix + LM_PARITY_S + 4)
        nxt = torch.from_numpy(prng.integers(
            0, rcfg.vocab, (LM_PARITY_B, 1))).cuda()
        logits_dec, _ = lmb.decode(rmodel, rparams, rstates, nxt,
                                   prefix + LM_PARITY_S)
        torch.cuda.synchronize()
        k4 = read_counts()["flash_attention"]
        kinds = {k for seg in lmb.all_segments(rmodel) for k in seg.pattern}
        attends = bool(kinds & {"attn", "eattn", "xattn"})
        check((k4 > 0) == attends, f"{name}: {k4} K4 launches with blocks "
              f"{sorted(kinds)}")
        check(bool(torch.isfinite(logits1).all())
              and bool(torch.isfinite(logits_dec).all()),
              f"{name}: logits not finite")
        row = {"k4": k4, "kinds": sorted(kinds)}
        if name in LM_PARITY_ARCHS:
            pb2 = dict(pb, tokens=torch.cat([pb["tokens"], nxt], dim=1))
            logits2, _ = lmb.prefill(rmodel, rparams, pb2)
            diff = (logits_dec[:, 0] - logits2[:, -1]).abs()
            lim = LM_PARITY_TOL + LM_PARITY_TOL * logits2[:, -1].abs()
            check(bool((diff <= lim).all()), f"{name}: prefill-decode "
                  f"parity off by {float(diff.max())}")
            row["parity_max_abs"] = float(diff.max())
        arch_rows[name] = row
    out["reduced_archs"] = arch_rows
    k4_by_arch = {n: r["k4"] for n, r in arch_rows.items()}
    parity = {n: r["parity_max_abs"] for n, r in arch_rows.items()
              if "parity_max_abs" in r}
    print(f"phase 18 {card}: the ten archs at reduced width through prefill "
          f"and decode on the card, K4 launches {k4_by_arch} (0 on the "
          f"archs without attn/eattn/xattn blocks); prefill-decode parity "
          f"(atol = rtol = {LM_PARITY_TOL}) max abs {parity}", flush=True)

    # (d) K4 at the path's shapes: the prefill, and the last decode step
    # over the cache written so far, a view of the cache of s + gen keys
    rng = np.random.default_rng(18)
    hd, nkv = cfg.hd, cfg.n_kv
    k4_times = [
        k4_lm_record(rng, (b, cfg.n_heads, nkv, s, s, hd), True),
        k4_lm_record(rng, (b, cfg.n_heads, nkv, 1, s + gen - 1, hd), True,
                     extra=1)]
    out["k4"] = k4_times
    for t in k4_times:
        share = ("not measured" if t["share_of_bound"] is None
                 else f"{100 * t['share_of_bound']:.1f}%")
        print(f"phase 18 {card}: K4 at {tuple(t['shape'])} bf16 causal"
              f"{' over a cache view' if t['kv_view'] else ''} "
              f"[{t['variant']}]: {t['ms']:.4f} / {t['device_ms']} ms per "
              f"call / device ({t['timing']}), plain {t['plain_ms']:.4f} / "
              f"{t['plain_device_ms']}, sdpa(enable_gqa) "
              f"{t['library_ms']:.4f} / {t['library_device_ms']}, bound "
              f"{t['bound_ms']:.4f} by {t['bound_by']} ({share} of it); "
              f"error against the float32 plain version "
              f"{t['rel_err_vs_float32_plain']:.3g} relative", flush=True)
    print(f"phase 18 {card}: whole phase {time.perf_counter() - t18:.1f} s",
          flush=True)
    out["phase_s"] = time.perf_counter() - t18
    return out


def train_profile(res, tc) -> dict:
    """Where a training step's time goes: one more step of a finished
    :func:`repro_torch.launch.train.train` run (its parameters and
    optimizer state, the pipeline's next batch) under ``torch.profiler``,
    ending in a synchronize: the host-clock milliseconds, the device-busy
    milliseconds (the sum of its kernels' device time), the kernels, the
    idle share (1 - busy / host clock) and the six kernels with the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as lm_train
    from repro_torch.models import build_model
    from repro_torch.optimizer import AdamW, linear_warmup_cosine
    model = build_model(get_arch(res.arch))
    step_fn = lm_train.make_train_step(
        model, AdamW(weight_decay=0.1, clip_norm=1.0),
        linear_warmup_cosine(tc.lr, tc.warmup, tc.steps), None)
    pipe = TokenPipeline(vocab=model.cfg.vocab, seq_len=TRAIN_SEQ,
                         batch_size=TRAIN_BATCH)
    pipe.restore(res.pipeline_state)
    batch = {"tokens": torch.from_numpy(
        pipe.next_batch()["tokens"]).long().cuda()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(res.params, res.opt_state, None, batch, tc.steps - 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall, "busy_ms": busy,
            "kernels": sum(e.count for e in dev),
            "idle_share": max(0.0, 1 - busy / wall),
            "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                    for e in top]}


def train_phase(card: str, work: str, reset_counts, read_counts) -> dict:
    """Phase 19, the LM training path (``repro_torch.launch.train``):
    smollm-360m at full width, (a) 12 steps with a checkpoint written by
    ``save_async`` at step 10, (b) a fresh ``train`` resumed from it, (c) 3
    steps under each of ``int8`` and ``topk``.  Returns the phase's
    records."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as lm_train
    from repro_torch.optimizer import compress_with_error_feedback

    t19 = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.remat and cfg.tie_embeddings,
          f"{TRAIN_ARCH}: not its full-size config")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {}

    def run(name, tc, resume=False):
        """One ``train`` call: its result, its launches (all must be 0:
        training attention is ``attend_plain``), its peak memory and the
        types of every parameter, moment and residual after its first two
        steps."""
        types = []

        def record(step, params, opt, ef, met):
            if len(types) < 2:
                tensors = {"params": list(params.parameters()),
                           "mu": opt.mu, "nu": opt.nu,
                           "residual": ef.residual if ef else []}
                types.append({k: sorted({str(t.dtype).removeprefix("torch.")
                                         for t in v})
                              for k, v in tensors.items()})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = lm_train.train(TRAIN_ARCH, tc, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, resume=resume, device="cuda",
                             callback=record)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        check(not any(launches.values()),
              f"LM train {name}: kernel launches {launches}")
        check(all(math.isfinite(x) for x in res.losses),
              f"LM train {name}: losses {res.losses}")
        # the reference's types: every bf16 parameter float32 after the
        # first step, every parameter, moment and residual after the second
        first, second = types
        check(first["params"] == ["float32"] and all(
            v in ([], ["float32"]) for v in second.values()),
              f"LM train {name}: types after two steps {types}")
        return res, {"wall_s": wall, "launches": launches,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "types": types, "losses": res.losses,
                     "step_ms": [1e3 * t for t in res.step_s],
                     "start": res.start}

    # (a) 12 steps, save_async at step 10
    ck_a = os.path.join(work, "lm_train_a")
    tc = lm_train.TrainConfig(steps=TRAIN_STEPS, lr=TRAIN_LR,
                              warmup=TRAIN_WARMUP,
                              checkpoint_every=TRAIN_CKPT_EVERY,
                              checkpoint_dir=ck_a)
    res_a, rec_a = run("(a)", tc)
    n_params = sum(p.numel() for p in res_a.params.parameters())
    check(rec_a["types"][0]["mu"] == rec_a["types"][0]["nu"] == ["bfloat16"],
          f"LM train (a): moments after step 0 {rec_a['types'][0]}, not "
          f"the reference's bf16")
    steps_a = lm_train.CheckpointManager(ck_a).all_steps()
    check(steps_a == [TRAIN_CKPT_EVERY],
          f"LM train (a): checkpoints at {steps_a}")
    steady = sorted(rec_a["step_ms"][1:])
    step_ms = steady[len(steady) // 2]
    # model FLOPs of a step: 6 x parameters (the tied head's product
    # included) per token, and attention's 12 x layers x heads x head dim
    # x sequence per token (PaLM's count; remat's recompute not counted)
    flops = tokens * (6 * n_params + 12 * cfg.n_layers * cfg.n_heads
                      * cfg.hd * TRAIN_SEQ)
    rec_a.update(params=n_params, step0_ms=rec_a["step_ms"][0],
                 median_step_ms=step_ms, tok_s=tokens / (step_ms / 1e3),
                 model_flops=flops, model_flop_s=flops / (step_ms / 1e3),
                 f32_peak_share=flops / (step_ms / 1e3) / F32_FLOPS,
                 save_block_s=res_a.save_block_s, write_s=res_a.write_s,
                 wait_s=res_a.wait_s)
    rec_a["profile"] = prof = train_profile(res_a, tc)
    out["a"] = rec_a
    loss_at_ckpt = res_a.losses[TRAIN_CKPT_EVERY]
    losses_a = res_a.losses
    del res_a
    torch.cuda.empty_cache()
    print(f"phase 19 {card}: {TRAIN_ARCH} at full width ({n_params / 1e6:.1f}M "
          f"parameters, bf16 at init, remat) trained {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {rec_a['wall_s']:.1f} s: "
          f"step 0 {rec_a['step0_ms']:.0f} ms, then median {step_ms:.0f} ms "
          f"(steps {min(steady):.0f}-{max(steady):.0f} ms), {rec_a['tok_s']:.0f}"
          f" tokens/s, model FLOP/s {rec_a['model_flop_s'] / 1e12:.2f} T "
          f"({100 * rec_a['f32_peak_share']:.1f}% of {F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s float32; TF32 off); peak memory "
          f"{rec_a['peak_bytes'] / 2**30:.2f} GiB; types after steps 0, 1 "
          f"{rec_a['types']}; launches {rec_a['launches']}", flush=True)
    print(f"phase 19 {card}: one more step of (a) under the profiler: "
          f"{prof['wall_ms']:.0f} ms on the host's clock, the device busy "
          f"{prof['busy_ms']:.0f} ms of it ({prof['kernels']} kernels; idle "
          f"share {100 * prof['idle_share']:.1f}%); by device time "
          + ", ".join(f"{n} {ms:.1f} ms x {c}" for n, ms, c in prof["top"]),
          flush=True)
    print(f"phase 19 {card}: loss curve (a) "
          + ", ".join(f"{x:.4f}" for x in losses_a), flush=True)
    print(f"phase 19 {card}: checkpoints at steps {steps_a}: save_async "
          f"held the loop {', '.join(f'{x:.3f}' for x in rec_a['save_block_s'])}"
          f" s, each write took {', '.join(f'{x:.2f}' for x in rec_a['write_s'])}"
          f" s on the writer thread, the final wait {rec_a['wait_s']:.2f} s",
          flush=True)

    # (b) a fresh train() resumed from (a)'s step-10 checkpoint
    with open(os.path.join(ck_a, f"step_{TRAIN_CKPT_EVERY:010d}",
                           "manifest.json")) as f:
        extra = json.load(f)["extra"]
    check(extra["step"] == extra["pipeline"]["step"] == TRAIN_CKPT_EVERY,
          f"LM train: the checkpoint's extra {extra}")
    res_b, rec_b = run("(b)", tc, resume=True)
    first = res_b.losses[0]
    rel = abs(first - loss_at_ckpt) / abs(loss_at_ckpt)
    check(res_b.start == TRAIN_CKPT_EVERY and rel <= TRAIN_RESUME_TOL,
          f"LM train (b): resumed at {res_b.start}, first loss {first} "
          f"against (a)'s {loss_at_ckpt} at step {TRAIN_CKPT_EVERY}")
    check(res_b.pipeline_state["step"] == TRAIN_STEPS,
          f"LM train (b): the pipeline ended at {res_b.pipeline_state}")
    apart = [abs(x - y) / abs(y) for x, y in zip(
        res_b.losses[1:], losses_a[TRAIN_CKPT_EVERY + 1:])]
    rec_b.update(first_loss_rel_err=rel, later_rel_apart=apart)
    out["b"] = rec_b
    del res_b
    torch.cuda.empty_cache()
    print(f"phase 19 {card}: (b) resumed from step {TRAIN_CKPT_EVERY} "
          f"(parameters and pipeline; the optimizer fresh, as in the "
          f"reference): first loss {first:.6f} against (a)'s "
          f"{loss_at_ckpt:.6f}, relative {rel:.3g} (limit "
          f"{TRAIN_RESUME_TOL}); the next {len(apart)} losses "
          f"{', '.join(f'{x:.4f}' for x in rec_b['losses'][1:])}, "
          f"{max(apart):.3g} apart from (a)'s at most; "
          f"{rec_b['wall_s']:.1f} s", flush=True)

    # (c) three steps under each compressor, then each compressor timed
    # on the run's own gradients' shapes (its parameters stand in for them)
    for mode in ("int8", "topk"):
        res_c, rec_c = run(f"({mode})", lm_train.TrainConfig(
            steps=TRAIN_COMPRESS_STEPS, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
            grad_compress=mode))
        plist = [p.detach() for p in res_c.params.parameters()]
        groups = res_c.params.leaf_groups()
        ef = res_c.ef_state
        rec_c["compress_ms"] = cuda_ms(
            lambda: compress_with_error_feedback(plist, ef, mode,
                                                 groups=groups), 3)
        rec_c["mean_step_ms"] = (sum(rec_c["step_ms"][1:])
                                 / len(rec_c["step_ms"][1:]))
        out[mode] = rec_c
        del res_c, plist, ef
        torch.cuda.empty_cache()
        print(f"phase 19 {card}: ({mode}) {TRAIN_COMPRESS_STEPS} steps, "
              f"losses {', '.join(f'{x:.4f}' for x in rec_c['losses'])}, "
              f"steps {', '.join(f'{x:.0f}' for x in rec_c['step_ms'])} ms; "
              f"the compressor {rec_c['compress_ms']:.2f} ms a step over "
              f"{len(groups)} leaves; peak memory "
              f"{rec_c['peak_bytes'] / 2**30:.2f} GiB; types after steps 0, "
              f"1 {rec_c['types']}", flush=True)
    out["phase_s"] = time.perf_counter() - t19
    print(f"phase 19 {card}: whole phase {out['phase_s']:.1f} s", flush=True)
    return out


def lowerings(path: str) -> None:
    """Phase 20 (a) and (b), run in a process of its own (a fake process
    group of 256 ranks): the dry-run's records of MESH_CAL_CELLS on a 1 x 1
    mesh and of MESH_CELL on the single-pod mesh, with CUDA fakes, written
    to ``path`` as JSON with each cell's wall seconds."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    t0 = time.perf_counter()
    init_fake_world(256)
    one = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    recs = {}
    for arch, kind, seq, batch in MESH_CAL_CELLS:
        t = time.perf_counter()
        rec = dryrun.lower_cell(arch, ShapeSpec(f"{kind}_{seq}", seq, batch,
                                                kind), one)
        rec["wall_s"] = time.perf_counter() - t
        recs[f"{arch} {kind}"] = rec
    t = time.perf_counter()
    rec = dryrun.lower_cell(*MESH_CELL, make_production_mesh(
        device_type="cuda"))
    rec["wall_s"] = time.perf_counter() - t
    recs["production"] = rec
    recs["process_s"] = time.perf_counter() - t0
    with open(path + ".tmp", "w") as f:
        json.dump(recs, f)
    os.replace(path + ".tmp", path)


def mesh_phase(card: str, lm: dict, lm_train: dict, lowering, low_path: str,
               reset_counts, read_counts) -> dict:
    """Phase 20, the sharded path: (c) smollm-360m through
    ``build_sharded_train`` on the host mesh against phase 19 (a); K4's
    registered op's dispatch cost; then (a) and (b) from the ``lowerings``
    process.  Returns the phase's records."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_op)
    from repro_torch.launch import train as lm_train_mod
    from repro_torch.launch.mesh import make_host_mesh

    t20 = time.perf_counter()
    out = {}
    # (c) the meshed training step against phase 19 (a)
    mesh = make_host_mesh("cuda")
    try:
        tc = lm_train_mod.TrainConfig(steps=MESH_TRAIN_STEPS, lr=TRAIN_LR,
                                      warmup=TRAIN_WARMUP, fsdp=True,
                                      zero1=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = lm_train_mod.train(TRAIN_ARCH, tc, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        dist.destroy_process_group()
    want = lm_train["a"]["losses"][:MESH_TRAIN_STEPS]
    rel = [abs(x - y) / abs(y) for x, y in zip(res.losses, want)]
    check(not any(launches.values()),
          f"LM mesh train: kernel launches {launches}")
    check(len(rel) == MESH_TRAIN_STEPS and max(rel) <= MESH_TRAIN_TOL,
          f"LM mesh train: losses {res.losses} against phase 19 (a)'s "
          f"{want} (limit {MESH_TRAIN_TOL} relative)")
    step_ms = [1e3 * t for t in res.step_s]
    out["train"] = {"losses": res.losses, "want": want, "rel_err": rel,
                    "step_ms": step_ms, "wall_s": wall, "launches": launches,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "placements": sorted({str(p.placements) for p in
                                          res.params.parameters()})}
    del res
    torch.cuda.empty_cache()
    base_ms = lm_train["a"]["step_ms"][:MESH_TRAIN_STEPS]
    print(f"phase 20 {card}: (c) {TRAIN_ARCH} through build_sharded_train on "
          f"the host mesh (1 x 1, NCCL; FSDP and ZeRO-1 on), "
          f"{MESH_TRAIN_STEPS} steps: losses "
          f"{', '.join(f'{x:.6f}' for x in out['train']['losses'])} against "
          f"phase 19 (a)'s {', '.join(f'{x:.6f}' for x in want)}, relative "
          f"{max(rel):.3g} (limit {MESH_TRAIN_TOL}); steps "
          f"{', '.join(f'{x:.0f}' for x in step_ms)} ms against phase 19's "
          f"{', '.join(f'{x:.0f}' for x in base_ms)}; peak memory "
          f"{out['train']['peak_bytes'] / 2**30:.2f} GiB against "
          f"{lm_train['a']['peak_bytes'] / 2**30:.2f}; launches {launches}",
          flush=True)

    # K4's registered op against the direct call: host ms a call, in turns
    rng = np.random.default_rng(20)
    b, s, gen = (LM_SERVE["requests"], LM_SERVE["prompt_len"],
                 LM_SERVE["gen"])
    q, k, v = cache_view(rng, (b, 32, 8, 1, s + gen - 1, 128), 1)
    check(torch.equal(flash_attention_op(q, k, v, True),
                      flash_attention(q, k, v, causal=True)),
          "K4's registered op differs from its direct call")

    def per_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_DISPATCH_CALLS):
            fn(q, k, v, True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / MESH_DISPATCH_CALLS * 1e3

    times = {"op": [], "direct": []}
    for name in ("op", "direct", "direct", "op", "op", "direct"):
        times[name].append(per_call(flash_attention_op if name == "op"
                                    else flash_attention))
    op_ms, direct_ms = min(times["op"]), min(times["direct"])
    out["k4_dispatch"] = {"op_ms": op_ms, "direct_ms": direct_ms,
                          "dispatch_ms": op_ms - direct_ms,
                          "decode_step_host_ms":
                              lm["decode_profile"]["wall_ms"]}
    print(f"phase 20 {card}: K4's registered op at (8, 32, 8, 1, 575, 128) "
          f"over a cache view: {op_ms:.4f} ms a call on the host's clock "
          f"against the direct call's {direct_ms:.4f} (best of 3 x "
          f"{MESH_DISPATCH_CALLS}): {1e3 * (op_ms - direct_ms):.1f} us of "
          f"dispatch a call, x {32} layers = "
          f"{32 * (op_ms - direct_ms):.3f} ms of a decode step's "
          f"{lm['decode_profile']['wall_ms']:.2f} ms (phase 18)", flush=True)

    # (a) and (b) from the lowering process
    t0 = time.perf_counter()
    rc = lowering.wait(timeout=300)
    out["lowering_wait_s"] = time.perf_counter() - t0
    check(rc == 0, f"phase 20 lowerings exited {rc}")
    with open(low_path) as f:
        recs = json.load(f)
    out["lowerings"] = recs
    for name, rec in recs.items():
        if name == "process_s":
            continue
        check(rec["status"] == "ok", f"phase 20 lowering {name}: {rec}")
        check(rec["roofline"]["flops"] > 0 and math.isfinite(
            rec["roofline"]["step_s"]), f"phase 20 lowering {name}: {rec}")
        # K4's op once a layer at inference, never in training
        want_k4 = 0 if name == "smollm-360m train" else 32
        check(rec["k4_calls"] == want_k4, f"phase 20 lowering {name}: K4's "
              f"op {rec['k4_calls']} times, not {want_k4}")
    serve = lm["serve"]
    measured = {
        "smollm-360m train": (f"step 0 {lm_train['a']['step0_ms']:.0f} ms",
                              lm_train["a"]["peak_bytes"],
                              "phase 19 (a), 12 steps, float32 after step 0"),
        "llama3-8b prefill": (f"prefill {serve['prefill_ms']:.1f} ms",
                              serve["peak_bytes"],
                              "phase 18's serve, decode included"),
        "llama3-8b decode": (
            f"a decode step {lm['decode_profile']['wall_ms']:.2f} ms on the "
            f"host's clock, the device busy "
            f"{lm['decode_profile']['busy_ms']:.2f} ms",
            serve["peak_bytes"], "phase 18's serve")}
    for name, (what, peak, whose) in measured.items():
        rec = recs[name]
        r = rec["roofline"]
        print(f"phase 20 {card}: (a) {name} ({rec['shape']}, batch "
              f"{TRAIN_BATCH if 'train' in name else LM_SERVE['requests']}) "
              f"on a 1 x 1 mesh, CUDA fakes: roofline step {1e3 * r['step_s']:.2f} ms (compute "
              f"{1e3 * r['compute_s']:.2f}, memory {1e3 * r['memory_s']:.2f}"
              f", collective {1e3 * r['collective_s']:.2f}; {r['bottleneck']}"
              f"-bound), tracked peak "
              f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB, lowered in "
              f"{rec['wall_s']:.1f} s; measured: {what}, peak "
              f"{peak / 2**30:.2f} GiB ({whose})", flush=True)
    rec = recs["production"]
    r = rec["roofline"]
    print(f"phase 20 {card}: (b) {' '.join(MESH_CELL)} on single_pod_16x16 "
          f"(CUDA fakes, K4's registered op on fake DTensors x 32): roofline "
          f"step {1e3 * r['step_s']:.2f} ms (compute "
          f"{1e3 * r['compute_s']:.3f}, memory {1e3 * r['memory_s']:.2f}, "
          f"collective {1e3 * r['collective_s']:.2f}; {r['bottleneck']}-"
          f"bound), peak {rec['memory']['peak_bytes'] / 2**30:.2f} GiB a "
          f"chip, collectives {r['coll_counts']}, lowered in "
          f"{rec['wall_s']:.1f} s; the lowering process took "
          f"{recs['process_s']:.1f} s (overlapping phase 19), phase 20 "
          f"waited {out['lowering_wait_s']:.1f} s for it", flush=True)
    out["phase_s"] = time.perf_counter() - t20
    print(f"phase 20 {card}: whole phase {out['phase_s']:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write rows and kernel records here as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    pool = concurrent.futures.ProcessPoolExecutor(
        HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=init_worker)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(ROOT, "build"))
    procs = []
    try:
        return smoke(args, pool, work, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)


def smoke(args, pool, work: str, procs: list) -> int:
    """Every phase; ``work`` holds the sweeps' cell stores and caches;
    ``procs`` gets each process it starts (the caller stops them)."""
    import numpy as np
    import torch
    from repro_torch.core import predictor_tables
    from repro_torch.core.features import cluster_trace, delta_convergence
    from repro_torch.core.service import PredictorService
    from repro_torch.core.vocab import DeltaVocab
    from repro_torch.kernels import LAUNCH_LOG_ENV, build, read_launch_log
    from repro_torch.kernels import lane_replay as k1
    from repro_torch.kernels.flash_attention import (TILINGS, WARP_HEADS,
                                                     FlashGeometry,
                                                     flash_attention,
                                                     flash_attention_plain,
                                                     flash_geometry)
    from repro_torch.kernels.hlsh_attention import (hlsh_attention,
                                                    hlsh_attention_plain,
                                                    hlsh_geometry)
    from repro_torch.kernels.int4_matmul import (int4_matmul,
                                                 int4_matmul_plain,
                                                 VARIANTS, int4_variant,
                                                 unpack_int4)
    from repro_torch.kernels.lane_replay import lane_replay
    from repro_torch.uvm import adaptive, faults, paper_tables, sweep
    from repro_torch.uvm import golden as G
    from repro_torch.offload.serve_trace import (serve_latency_columns,
                                                 trace_step_bounds)
    from repro_torch.traces.interleave import (mt_component_trace,
                                               tenant_last_index)
    from repro_torch.uvm.backends.cuda_backend import (PORTED_FAMILIES,
                                                       PORTED_POLICIES,
                                                       lane_family)
    from repro_torch.uvm.config import UVMConfig
    from repro_torch.uvm.prefetchers import (BlockPrefetcher,
                                             LearnedPrefetcher, NoPrefetcher,
                                             OraclePrefetcher,
                                             TreePrefetcher)
    from repro_torch.uvm.replay_core import ReplayRequest, get_backend
    from repro_torch.uvm.scenarios import MT_BENCHES, expand_scenario

    # float32 products in full precision (TF32 off), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: device and build --------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind} x{count}; nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"phase 1: built {', '.join(build.FLAGS)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    backend = get_backend("cuda", device="cuda")
    counted = {"lane_replay": lane_replay, "hlsh_attention": hlsh_attention,
               "int4_matmul": int4_matmul, "flash_attention": flash_attention}
    path_launches = {}

    def reset_counts():
        k1.reset_counts()
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    def kind_of(req):
        return lane_family(req.prefetcher).split("/")[0], req.config.eviction

    # ---- phase 2: K1 against the legacy engine ----------------------------
    t0 = time.perf_counter()
    traces = {b: sweep.load_trace(b, 1.0, 0, 0.6) for b in BENCHES}
    makers = {
        "none": lambda tr, cfg: NoPrefetcher(),
        "block": lambda tr, cfg: BlockPrefetcher(),
        "tree": lambda tr, cfg: TreePrefetcher(),
        # perfect distance-32 predictions: the golden cells' stand-in model
        "learned": lambda tr, cfg: LearnedPrefetcher(
            G.perfect_preds(tr), extra_latency_cycles=cfg.cycles_per_us),
        "oracle": lambda tr, cfg: OraclePrefetcher(np.asarray(tr.pages)),
    }
    cells = []
    for bench, tr in traces.items():
        for frac in FRACS:
            cap = None if frac is None else int(tr.working_set_pages * frac)
            for name in ("none", "block", "learned"):
                cells.append((bench, frac, name, tr, UVMConfig(
                    device_pages=cap)))
    for bench in NEW_LANE_BENCHES:
        tr = traces[bench]
        cap = int(tr.working_set_pages * 0.5)
        for policy in PORTED_POLICIES:
            for name in ("tree", "oracle") + (
                    ("none", "block", "learned") if policy != "lru" else ()):
                cells.append((bench, 0.5, name, tr, UVMConfig(
                    device_pages=cap, eviction=policy)))
    requests = [ReplayRequest(tr, makers[name](tr, cfg), cfg)
                for _, _, name, tr, cfg in cells]
    legacy = pool.map(legacy_replay, requests)
    stats = backend.replay(requests)
    torch.cuda.synchronize()
    p2_kinds = set()
    for (bench, frac, name, tr, cfg), req, st, want in zip(
            cells, requests, stats, legacy):
        check(st.backend == "cuda", f"{bench}/{name}: backend {st.backend}")
        same_stats(st, want,
                   f"K1 vs legacy {bench}/{name}/{cfg.eviction}/frac={frac}")
        p2_kinds.add(kind_of(req))
    check(len(p2_kinds) == len(PORTED_FAMILIES) * len(PORTED_POLICIES),
          f"phase 2 covered {sorted(p2_kinds)} only")
    print(f"phase 2: K1 matched the legacy engine on {len(cells)} scale-1.0 "
          f"lanes ({len(backend.pack_lanes(requests))} batches, all "
          f"{len(p2_kinds)} family x policy kinds) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3: K1 on the golden cells, against the fixture and plain --
    t0 = time.perf_counter()
    with open(GOLDEN) as f:
        golden = json.load(f)["cells"]
    gids = G.golden_cell_ids()
    greqs = []
    for c in gids:
        trace, cfg, factory = G.golden_cell(c)
        greqs.append(ReplayRequest(trace, factory(), cfg))
    gbatches = [(idx, backend.pack_batch([greqs[i] for i in idx]))
                for idx in backend.pack_lanes(greqs)]
    # the plain versions run in the host workers, all at once
    plains = pool.map(plain_replay, [plain_job(b) for _, b in gbatches])
    variants = {}
    k1_err = 0.0
    for (batch_idx, batch), (plain, plain_s) in zip(gbatches, plains):
        key = variant_key(batch)
        err, got = k1_against(batch, plain)
        check(err == 0.0, f"K1 vs plain on the golden {key} batch: max diff "
              f"{err}")
        k1_err = max(k1_err, err)
        for lane, i in enumerate(batch_idx):
            want = golden[gids[i]]
            row = got[lane].tolist()
            for j, f in enumerate(k1.STAT_FIELDS):
                ok = (row[j] == want[f] if f in INT_FIELDS
                      else abs(row[j] - want[f]) <= 1e-6 * abs(want[f]))
                check(ok, f"K1 golden {gids[i]}: {f} {row[j]} != "
                      f"{want[f]}")
            if "tenant_hits" in want:
                th0 = int(row[len(k1.STAT_FIELDS)])
                check([th0, int(row[1]) - th0] == want["tenant_hits"],
                      f"K1 golden {gids[i]}: tenant hits")
        args_ = batch.kernel_args("cuda")
        variants[key] = new_variant(
            key, golden_lanes=len(batch_idx),
            golden_accesses=int(batch.iparams[:, 0].sum()),
            golden_ms=cuda_ms(lambda: lane_replay(**args_), reps=3),
            golden_plain_ms=plain_s * 1e3,
            golden_bound_ms=k1_bound_ms(batch), golden_max_abs_err=err)
    n_base = len(PORTED_FAMILIES) * len(PORTED_POLICIES)
    check(len(variants) == n_base + len(PORTED_FAMILIES),
          f"golden batches covered {sorted(variants)} only")
    print(f"phase 3 {card}: K1 equal to the fixture on {len(gids)} golden "
          f"cells and to its plain version on {len(variants)} batches (max "
          f"diff {k1_err}), in {time.perf_counter() - t0:.1f} s", flush=True)
    for v in variants.values():
        print(f"  golden {v['family']}/{v['policy']}/{v['variant']}: "
              f"{v['golden_lanes']} lanes, {v['golden_accesses']} accesses: "
              f"K1 {v['golden_ms']:.3f} ms, plain {v['golden_plain_ms']:.1f} "
              "ms", flush=True)

    # ---- phase 4: K2 against its plain version ----------------------------
    # K2 in both tilings and both types: the path's shape and the warp
    # tiling's edges (N of 1 and 32, D of 64, odd D with unaligned row
    # spans), the reference's shapes on the general tile; every draw has a
    # row whose keys are all erased and, where N > 32, a whole erased key
    # tile.  bf16 is held against the plain version on float32 copies of
    # the same inputs (K2 keeps its logits in float32, the bf16 plain
    # version rounds them: at the path's shape it is the less exact one),
    # and at the reference's shapes against the bf16 plain version too
    rng = np.random.default_rng(0)
    k2_err = {"float32": 0.0, "bfloat16": 0.0}
    k2_bf16_plain = {}
    k2_geos = {}
    k2_inputs = {}
    for (b, n, d), dt in K2_CASES:
        dt = getattr(torch, dt)
        q = cuda_randn(rng, (b, n, d), dt)
        v = cuda_randn(rng, (b, n, d), dt)
        keep = torch.tensor(rng.random((b, n)) > 0.3, dtype=dt,
                            device="cuda")
        keep[0] = 0.0
        if n > 32:
            keep[:, 32:64] = 0.0
        got = hlsh_attention(q, q, v, keep).float()
        err = float((got - hlsh_attention_plain(
            *(t.float() for t in (q, q, v, keep)))).abs().max())
        name = str(dt).split(".")[1]
        check(err <= K2_ATOL[name], f"K2 ({b},{n},{d}) {name}: max error "
              f"{err} (limit {K2_ATOL[name]})")
        if dt == torch.bfloat16:
            e16 = float((got - hlsh_attention_plain(q, q, v, keep).float()
                         ).abs().max())
            k2_bf16_plain[f"{b}x{n}x{d}"] = e16
            check((b, n, d) not in K2_REF_SHAPES or e16 <= K2_ATOL[name],
                  f"K2 ({b},{n},{d}) bfloat16: max error {e16} from the "
                  f"bf16 plain version (limit {K2_ATOL[name]})")
        k2_err[name] = max(k2_err[name], err)
        geo = hlsh_geometry(b, n, d, dt)
        k2_geos.setdefault((geo.tiling, name), []).append((b, n, d))
        k2_inputs.setdefault(((b, n, d), name), (q, v, keep))
    check(len(k2_geos) == 4, f"K2's cases reach only {sorted(k2_geos)}")
    # K4 at the reference's shapes x causal x both types, and at the
    # Transformer family's shape in its float32
    k4_err = {"float32": 0.0, "bfloat16": 0.0}
    k4_cases = [(shape, causal, dt) for shape in K4_REF_SHAPES
                for causal in (False, True)
                for dt in (torch.float32, torch.bfloat16)]
    k4_cases += [(shape, causal, torch.float32)
                 for shape in (K4_PATH_SHAPE,) + K4_EDGE_SHAPES
                 for causal in (False, True)]
    k4_cases += [(shape, False, torch.float32) for shape in K4_TABLE_SHAPES]
    for shape, causal, dt in k4_cases:
        err, _ = k4_against_plain(rng, shape, causal, dt)
        name = str(dt).split(".")[1]
        check(err <= K4_ATOL[name], f"K4 {shape} causal={causal} {name}: "
              f"max error {err} (limit {K4_ATOL[name]})")
        k4_err[name] = max(k4_err[name], err)
    # the tables' shapes in bf16, against the float32 plain version on the
    # same inputs, all in the warp tiling
    for shape in K4_TABLE_SHAPES:
        check(flash_geometry(shape[0] * shape[1], 30, 30, shape[-1]).tiling
              == "warp", f"K4 {shape} is not in the warp tiling")
        _, qkv = k4_against_plain(rng, shape, False, torch.bfloat16)
        err = float((flash_attention(*qkv).float() - flash_attention_plain(
            *(t.float() for t in qkv))).abs().max())
        check(err <= K4_ATOL["bfloat16"], f"K4 bf16 {shape}: max error {err} "
              "from the float32 plain version")
        k4_err["bfloat16"] = max(k4_err["bfloat16"], err)
    # the tensor-core tilings' edges in bf16, against the float32 plain
    # version on the same inputs
    k4_tilings = {}
    for *shape, causal, extra in K4_TC_CASES:
        qkv = cache_view(rng, shape, extra)
        n0 = flash_attention.launches
        got = flash_attention(*qkv, causal=causal)
        err = float((got.float() - flash_attention_plain(
            *(t.float() for t in qkv), causal=causal)).abs().max())
        tiling = k4_tiling(shape, torch.bfloat16, causal)
        check(err <= K4_ATOL["bfloat16"] and flash_attention.launches
              == n0 + 1, f"K4 bf16 {tuple(shape)} causal={causal} [{tiling}]"
              f": max error {err} from the float32 plain version")
        k4_err["bfloat16"] = max(k4_err["bfloat16"], err)
        k4_tilings.setdefault(tiling, []).append(tuple(shape))
    for shape, causal, dt in k4_cases:
        k4_tilings.setdefault(k4_tiling(shape, dt, causal), []).append(shape)
    check(sorted(k4_tilings) == sorted(TILINGS) and all(
        k4_tilings[t] for t in ("mma", "split")),
          f"K4's cases reach the tilings {sorted(k4_tilings)} only")
    # bf16 at the path's shape, held against the plain version on float32
    # copies of the same inputs: the bf16 plain version rounds its logits
    # and probabilities to bf16 where K4 keeps them in float32, so at S = 30
    # it is the less exact of the two
    k4_bf16_path = {}
    for causal in (False, True):
        vs_plain, qkv = k4_against_plain(rng, K4_PATH_SHAPE, causal,
                                         torch.bfloat16)
        vs_f32 = float((flash_attention(*qkv, causal=causal).float()
                        - flash_attention_plain(*(t.float() for t in qkv),
                                                causal=causal)
                        ).abs().max())
        check(vs_f32 <= K4_ATOL["bfloat16"], f"K4 {K4_PATH_SHAPE} causal="
              f"{causal} bfloat16: max error {vs_f32} from the float32 "
              f"plain version (limit {K4_ATOL['bfloat16']})")
        k4_bf16_path[f"causal={causal}"] = {"vs_plain": vs_plain,
                                            "vs_float32_plain": vs_f32}
    # K3 at the reference's shapes x both types (random codes), and at the
    # predictor's shapes in float32 on packed weights
    k3_err = {"float32": 0.0, "bfloat16": 0.0}
    k3_abs = 0.0
    k3_cases = [(shape, dt, False) for shape in K3_REF_SHAPES
                for dt in (torch.float32, torch.bfloat16)]
    k3_cases += [(shape, torch.float32, True) for shape in K3_PATH_SHAPES]
    # Table 8's layer products and its head at each bench's class count
    table8_classes = {b: DeltaVocab.build(cluster_trace(
        predictor_tables.get_trace(b), "sm"), distance=1).n_classes
        for b in predictor_tables.PREDICTOR_BENCHMARKS}
    k3_table8 = K3_TABLE8_SHAPES + tuple(
        (512, 12, n) for n in sorted(set(table8_classes.values())))
    k3_cases += [(shape, torch.float32, True) for shape in k3_table8]
    k3_cases += [(shape, getattr(torch, dt), False)
                 for shape, dt in K3_EDGE_CASES]
    reached = {(int4_variant(m, kd, n + n % 2, dt), dt)
               for (m, kd, n), dt, _ in k3_cases}
    missing = [(v, str(dt)) for dt in (torch.float32, torch.bfloat16)
               for v in VARIANTS if (v, dt) not in reached
               and (v, dt) != ("wide32", torch.bfloat16)]
    check(not missing, f"K3's cases reach no case of the bodies {missing}")
    for (m, kd, n), dt, packer in k3_cases:
        err, abs_err, _ = k3_against_plain(rng, m, kd, n, dt, packer)
        name = str(dt).split(".")[1]
        check(err < K3_RTOL[name], f"K3 ({m},{kd},{n}) {name}: relative "
              f"error {err} (limit {K3_RTOL[name]})")
        k3_err[name] = max(k3_err[name], err)
        k3_abs = max(k3_abs, abs_err)
    # x one element into its storage (not 16-byte aligned): the narrow
    # variant's shape takes the general one
    base = cuda_randn(rng, (1000 * 12 + 1,), torch.float32)
    x_off = base[1:].view(1000, 12)
    w_off = torch.tensor(rng.integers(0, 256, (12, 6)), dtype=torch.uint8,
                         device="cuda")
    check(int4_variant(1000, 12, 12, torch.float32, x_off.data_ptr())
          == "general", "K3 on an unaligned x does not take the general "
          "variant")
    err = rel_err(int4_matmul(x_off, w_off, 0.03),
                  int4_matmul_plain(x_off, w_off, 0.03))
    check(err < K3_RTOL["float32"], f"K3 on an unaligned x: relative error "
          f"{err}")
    k3_err["float32"] = max(k3_err["float32"], err)
    # bf16 heads of S x D = 1,500 (every other head's span unaligned),
    # against the float32 plain version on the same inputs
    for causal in (False, True):
        _, qkv = k4_against_plain(rng, (3, 3, 3, 30, 30, 50), causal,
                                  torch.bfloat16)
        err = float((flash_attention(*qkv, causal=causal).float()
                     - flash_attention_plain(*(t.float() for t in qkv),
                                             causal=causal)).abs().max())
        check(err <= K4_ATOL["bfloat16"], f"K4 bf16 (3,3,3,30,30,50) causal="
              f"{causal}: max error {err} from the float32 plain version")
        k4_err["bfloat16"] = max(k4_err["bfloat16"], err)
    torch.cuda.synchronize()
    print(f"phase 4: K2 matched its plain version on {len(K2_CASES)} cases, "
          f"max error {k2_err} (limits {K2_ATOL}; bf16 from the bf16 plain "
          f"version {k2_bf16_plain}; by tiling and type {k2_geos}); K4 on "
          f"{len(k4_cases) + len(K4_TC_CASES)} cases, max error "
          f"{k4_err} (limits {K4_ATOL}; the tensor-core tilings' edges "
          f"{ {t: k4_tilings[t] for t in ('mma', 'split')} }; bf16 at the "
          f"path's shape, from "
          f"the float32 plain version and from the bf16 one: "
          + ", ".join(f"{c} {e['vs_float32_plain']:.3g} / "
                      f"{e['vs_plain']:.3g}" for c, e in k4_bf16_path.items())
          + f"); K3 on {len(k3_cases)} cases, relative "
          f"error {k3_err} (limits {K3_RTOL}; Table 8's shapes "
          + ", ".join(f"{(m, kd, n)} "
                      f"[{int4_variant(m, kd, n + n % 2, torch.float32)}]"
                      for m, kd, n in k3_table8)
          + ")", flush=True)

    # ---- phase 5: the main path -----------------------------------------
    for bench in BENCHES:
        conv = delta_convergence(cluster_trace(traces[bench], "sm"))
        print(f"  {bench}: delta convergence {conv:.3f} -> "
              f"{'bypass' if conv >= 0.7 else 'hlsh'}", flush=True)
    grid = sweep.expand_grid(BENCHES, ["none", "tree", "learned"],
                             scales=[1.0], windows=[0.6],
                             device_fracs=list(FRACS),
                             service_steps=paper_tables.SERVICE_STEPS)
    main_out = os.path.join(work, "main")
    reset_counts()
    t0 = time.perf_counter()
    rows = sweep.run_sweep(grid, out_dir=main_out, device="cuda")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = path_launches["main"] = read_counts()
    print(f"phase 5: main path, {len(rows)} rows in {main_s:.1f} s, rows "
          f"per backend {per_backend(rows)}; launches {launches} (K1 by "
          "family/policy "
          f"{dict(lane_replay.launches_by)})", flush=True)
    print("bench,prefetcher,frac,hit_rate,faults,pcie_bytes,accuracy,"
          "coverage,unity,backend,train_s,predict_s,replay_s")
    for r in rows:
        print(f"{r['bench']},{r['prefetcher']},{r['device_frac']},"
              f"{r['hit_rate']:.4f},{r['faults']},{r['pcie_bytes']:.0f},"
              f"{r['accuracy']:.4f},{r['coverage']:.4f},{r['unity']:.4f},"
              f"{r['backend']},{r['train_seconds']:.2f},"
              f"{r['predict_seconds']:.2f},{r['seconds']:.4f}")
    all_cuda(rows, "a main-path row")
    check(launches["lane_replay"] > 0, "K1 never launched on the main path")
    check(launches["hlsh_attention"] > 0,
          "K2 never launched on the main path")
    check(launches["int4_matmul"] > 0,
          "K3 never launched on the main path's quantized inference")
    learned_reqs = []
    legacy_tree = {}
    checked = [(cell, r) for cell, r in zip(grid, rows)
               if cell.prefetcher != "none"]
    creqs = [ReplayRequest(trace, pf, config) for trace, config, pf, _ in
             (sweep.prepare_cell(cell, device="cuda") for cell, _ in checked)]
    for (cell, r), req, want in zip(checked, creqs,
                                    pool.map(legacy_replay, creqs)):
        same_row(r, want, f"main path {cell.bench}/{cell.prefetcher}/"
                 f"{cell.device_frac}")
        if cell.prefetcher == "learned":
            learned_reqs.append(req)
        elif cell.device_frac is None:
            legacy_tree[cell.bench] = want
    # K1's plain version on the main path's learned batch runs in a host
    # worker while the card drives the later paths (compared in phase 12)
    k1_batch = backend.pack_batch(
        [learned_reqs[i] for i in backend.pack_lanes(learned_reqs)[0]])
    main_plain = pool.submit(plain_replay, plain_job(k1_batch))
    print(f"phase 5: {len(learned_reqs)} learned and {2 * len(legacy_tree)} "
          "tree rows equal the legacy engine on the same inputs", flush=True)
    # the same grid again from its cell store: every row loads, nothing
    # is prepared, replayed, inferred or trained
    resume_fits = []
    fit = PredictorService.fit

    def counted_fit(self, *a, **k):
        resume_fits.append(1)
        return fit(self, *a, **k)

    PredictorService.fit = counted_fit
    reset_counts()
    t0 = time.perf_counter()
    resumed = sweep.run_sweep(grid, out_dir=main_out, device="cuda")
    resume_s = time.perf_counter() - t0
    PredictorService.fit = fit
    resume_launches = read_counts()
    check(len(resumed) == len(rows) and faults.rows_digest(resumed)
          == faults.rows_digest(rows), "phase 5's resume: the rows differ "
          "from the first run's")
    check(not any(resume_launches.values()),
          f"phase 5's resume launched {resume_launches}")
    check(not resume_fits,
          f"phase 5's resume trained {len(resume_fits)} predictors")
    check(resume_s < 5.0, f"phase 5's resume took {resume_s:.2f} s")
    print(f"phase 5 {card}: resumed from the cell store, {len(resumed)} rows "
          f"equal to the first run's, launches {resume_launches}, "
          f"{len(resume_fits)} fits, {resume_s:.3f} s", flush=True)

    # ---- phase 6: the paper's Table 10 and Table 11, Fig 12, §7.4 --------
    reset_counts()
    t0 = time.perf_counter()
    prows = paper_tables.sweep_rows(BENCHES, device="cuda")
    tables_s = time.perf_counter() - t0
    path_launches["tables"] = read_counts()
    tables_launches = lane_replay.launches
    check(tables_launches > 0, "K1 never launched for the paper tables")
    all_cuda(prows, "a paper-table row")
    t10, t11 = paper_tables.table10_rows(prows), paper_tables.table11_rows(
        prows)
    print(f"phase 6: Table 10 (page hit rate, U=UVMSmart tree, R=learned), "
          f"K1 launches {tables_launches}, {tables_s:.1f} s; rows per "
          f"backend {per_backend(prows)}")
    print("bench,hit_U,hit_R,simulated_inst")
    for r in t10:
        print(f"{r['bench']},{r['hit_U']:.4f},{r['hit_R']:.4f},"
              f"{r['simulated_inst']}")
        check(r["hit_U"] == legacy_tree[r["bench"]].hit_rate,
              f"Table 10 {r['bench']}: tree hit rate {r['hit_U']} != legacy "
              f"{legacy_tree[r['bench']].hit_rate}")
    print(f"MEAN,{np.mean([r['hit_U'] for r in t10]):.4f},"
          f"{np.mean([r['hit_R'] for r in t10]):.4f},")
    print("phase 6: Table 11 (Unity = cbrt(accuracy x coverage x hit rate))")
    print("bench,prefetcher,acc,cov,hit,unity")
    for r in t11:
        print(f"{r['bench']},{r['prefetcher']},{r['acc']:.4f},"
              f"{r['cov']:.4f},{r['hit']:.4f},{r['unity']:.4f}")
        if r["prefetcher"] == "U" and r["bench"] != "MEAN":
            want = legacy_tree[r["bench"]]
            check((r["acc"], r["cov"], r["hit"], r["unity"]) == (
                want.accuracy, want.coverage, want.hit_rate, want.unity),
                f"Table 11 {r['bench']}: tree row != legacy")
    by_bench = {r["bench"]: r for r in rows
                if r["prefetcher"] == "learned" and r["device_frac"] is None}
    for r in t10:
        check(r["hit_R"] == by_bench[r["bench"]]["hit_rate"],
              f"Table 10 {r['bench']}: learned hit rate differs from the "
              "main path's row (checked against the legacy engine)")
    print("phase 6: every tree row equals the legacy engine's; every "
          "learned row equals the main path's", flush=True)
    # Fig 12 and the §7.4 headline from the same 22 rows (no replay), with
    # the paper's figures beside them: reported, not checked
    fig12 = paper_tables.fig12_rows(prows)
    ipc_rows, headline = paper_tables.headline(prows)
    print("phase 6: Fig 12 (PCIe traffic, MB; normalized = R / U)")
    print("bench,pcie_U_mb,pcie_R_mb,normalized,ipc_U,ipc_R,ipc_gain")
    for f12, ipc in zip(fig12, ipc_rows):
        print(f"{f12['bench']},{f12['pcie_U_mb']:.3f},{f12['pcie_R_mb']:.3f},"
              f"{f12['normalized']:.4f},{ipc['ipc_U']:.4f},"
              f"{ipc['ipc_R']:.4f},{ipc['ipc_gain']:.4f}")
    print(f"phase 6 (reported): §7.4 headline, IPC "
          f"{100 * (headline['ipc_gain_geomean'] - 1):+.2f}% over UVMSmart "
          f"(paper +10.89%), hit rate {100 * headline['hit_R_mean']:.2f}% "
          f"against {100 * headline['hit_U_mean']:.2f}% (paper 89.02% "
          f"against 76.10%), PCIe traffic "
          f"{100 * (headline['traffic_ratio_geomean'] - 1):+.2f}% (paper "
          "-11.05%)", flush=True)

    # ---- phase 7: the oversub-full matrix ---------------------------------
    matrix = expand_scenario("oversub-full")
    reset_counts()
    t0 = time.perf_counter()
    mrows = sweep.run_sweep(matrix, device="cuda")
    torch.cuda.synchronize()
    matrix_s = time.perf_counter() - t0
    path_launches["oversub-full"] = read_counts()
    matrix_launches = lane_replay.launches
    matrix_by = dict(lane_replay.launches_by)
    replay_s = sum(r["seconds"] for r in mrows)
    check(len(mrows) == 660, f"oversub-full gave {len(mrows)} rows")
    all_cuda(mrows, "an oversub-full row")
    check(matrix_launches > 0, "K1 never launched on oversub-full")
    # the matrix's requests, prepared once: the lane batches as run_sweep
    # packed them, the 2DCONV legacy check and the phase-8 timings
    mreqs = [ReplayRequest(trace, pf, config) for trace, config, pf, _ in
             (sweep.prepare_cell(c, device="cuda") for c in matrix)]
    mbatches = backend.pack_lanes(mreqs)
    lanes_per = {}
    for b in mbatches:
        lanes_per.setdefault(kind_of(mreqs[b[0]]), []).append(len(b))
    check({k: len(v) for k, v in lanes_per.items()} == matrix_by,
          f"lane batches per kind {lanes_per} != K1 launches {matrix_by}")
    print(f"phase 7 {card}: oversub-full, {len(mrows)} rows (per backend "
          f"{per_backend(mrows)}), in {matrix_s:.1f} s (replay "
          f"{replay_s:.1f} s, prepare {matrix_s - replay_s:.1f} s); K1 "
          f"launches {matrix_launches}",
          flush=True)
    for key in sorted(lanes_per):
        print(f"  {key[0]}/{key[1]}: {matrix_by.get(key, 0)} launches, "
              f"lanes per launch {lanes_per[key]}")
    print("prefetcher,eviction,ratio,mean_hit_rate,mean_unity,"
          "mean_pages_evicted")
    for pf in sweep.PREFETCHERS:
        for ev in PORTED_POLICIES:
            for ratio in sorted({c.device_frac for c in matrix}):
                sel = [r for c, r in zip(matrix, mrows) if c.prefetcher == pf
                       and c.eviction == ev and c.device_frac == ratio]
                print(f"{pf},{ev},{ratio},"
                      f"{np.mean([r['hit_rate'] for r in sel]):.4f},"
                      f"{np.mean([r['unity'] for r in sel]):.4f},"
                      f"{np.mean([r['pages_evicted'] for r in sel]):.0f}")
    chk = [i for i, c in enumerate(matrix) if c.bench == MATRIX_CHECK_BENCH]
    for i, want in zip(chk, pool.map(legacy_replay, [mreqs[i] for i in chk])):
        cell = matrix[i]
        same_row(mrows[i], want, f"oversub-full {cell.bench}/"
                 f"{cell.prefetcher}/{cell.eviction}/{cell.device_frac}")
    n_checked = len(chk)
    print(f"phase 7: the {n_checked} {MATRIX_CHECK_BENCH} rows equal the "
          f"legacy engine", flush=True)

    # ---- phase 8: K1 with step clocks against the legacy engine ---------
    t0 = time.perf_counter()
    sreqs = []
    for bench in STEP_CHECK_BENCHES:
        tr = sweep.load_trace(bench, 1.0, 0, None)
        bounds = trace_step_bounds(tr)
        cap = int(tr.working_set_pages * 0.5)
        for name in sweep.PREFETCHERS:
            for policy in PORTED_POLICIES:
                cfg = UVMConfig(device_pages=cap, eviction=policy)
                sreqs.append(ReplayRequest(tr, makers[name](tr, cfg), cfg,
                                           step_bounds=bounds))
    k1_s = time.perf_counter()
    stats = backend.replay(sreqs)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - k1_s
    empty = {}
    for req, st, want in zip(sreqs, stats, pool.map(legacy_replay, sreqs)):
        what = (f"K1 step clocks vs legacy {req.trace.name}/"
                f"{type(req.prefetcher).__name__}/{req.config.eviction}")
        check(st.backend == "cuda" and st.step_clocks is not None, what)
        same_stats(st, want, what)
        sizes = np.diff(np.concatenate([[0], req.step_bounds]))
        empty[req.trace.name] = int((sizes == 0).sum())
    p8_kinds = {variant_key(backend.pack_batch([r])) for r in sreqs}
    check(len(p8_kinds) == n_base, f"phase 8 covered {sorted(p8_kinds)}")
    print(f"phase 8 {card}: K1 step clocks equal the legacy engine's bit for "
          f"bit on {len(sreqs)} scale-1.0 serve lanes ({len(p8_kinds)} "
          f"family x policy kinds; empty windows per trace {empty}); K1 "
          f"{k1_s:.1f} s, whole phase {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 9: K1 with tenant quotas against the legacy engine --------
    t0 = time.perf_counter()
    qreqs = []
    for pair in MT_BENCHES:
        tr = sweep.load_trace(pair, 1.0, 0, 0.6)
        bounds = sweep._mt_step_bounds(tr)
        cap = int(tr.working_set_pages * QUOTA_CHECK_RATIO)
        for f0, f1 in QUOTA_CHECK_SPLITS:
            for name in sweep.PREFETCHERS:
                for policy in PORTED_POLICIES:
                    cfg = UVMConfig(device_pages=cap, eviction=policy,
                                    tenant_pages=(int(f0 * cap),
                                                  int(f1 * cap)))
                    qreqs.append(ReplayRequest(tr, makers[name](tr, cfg),
                                               cfg, step_bounds=bounds))
    # the legacy engine is slow on quota lanes: start it first
    q_legacy = pool.map(legacy_replay, qreqs)
    k1_s = time.perf_counter()
    stats = backend.replay(qreqs)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - k1_s
    # K1 against its plain version on a small batch of each new variant:
    # a step-clock lane of ServeBursty@r8 and a quota lane with the
    # tenants' completion clocks of ATAX+Pathfinder, both at scale 0.25
    small = []
    serve_small = sweep.load_trace("ServeBursty@r8", 0.25, 0, None)
    mt_small = sweep.load_trace("ATAX+Pathfinder", 0.25, 0, 0.6)
    for name in sweep.PREFETCHERS:
        for policy in PORTED_POLICIES:
            cap = int(serve_small.working_set_pages * 0.5)
            cfg = UVMConfig(device_pages=cap, eviction=policy)
            small.append([ReplayRequest(
                serve_small, makers[name](serve_small, cfg), cfg,
                step_bounds=trace_step_bounds(serve_small))])
            cap = int(mt_small.working_set_pages * 0.6)
            cfg = UVMConfig(device_pages=cap, eviction=policy,
                            tenant_pages=(int(0.4 * cap), int(0.4 * cap)))
            small.append([ReplayRequest(
                mt_small, makers[name](mt_small, cfg), cfg,
                step_bounds=sweep._mt_step_bounds(mt_small))])
    small = [b for b in small
             if type(b[0].prefetcher).__name__ != "BlockPrefetcher"]
    sbatches = [backend.pack_batch(reqs) for reqs in small]
    plains = pool.map(plain_replay, [plain_job(b) for b in sbatches])
    for req, st, want in zip(qreqs, stats, q_legacy):
        what = (f"K1 quotas vs legacy {req.trace.name}/"
                f"{type(req.prefetcher).__name__}/{req.config.eviction}/"
                f"{req.config.tenant_pages}")
        check(st.backend == "cuda" and st.tenant_hits is not None, what)
        same_stats(st, want, what)
    p9_kinds = {variant_key(backend.pack_batch([r])) for r in qreqs}
    check(len(p9_kinds) == n_base, f"phase 9 covered {sorted(p9_kinds)}")
    for batch, (plain, plain_s) in zip(sbatches, plains):
        key = variant_key(batch)
        err, _ = k1_against(batch, plain)
        check(err == 0.0, f"K1 vs plain on the small {key} batch: max diff "
              f"{err}")
        k1_err = max(k1_err, err)
        args_ = batch.kernel_args("cuda")
        variants.setdefault(key, new_variant(key)).update(
            plain_lanes=int((batch.iparams[:, 0] > 0).sum()),
            plain_accesses=int(batch.iparams[:, 0].sum()),
            plain_k1_ms=cuda_ms(lambda: lane_replay(**args_), reps=3),
            plain_ms=plain_s * 1e3, plain_bound_ms=k1_bound_ms(batch),
            plain_max_abs_err=err)
    print(f"phase 9 {card}: K1 with quotas equals the legacy engine on "
          f"{len(qreqs)} scale-1.0 lanes of the {len(MT_BENCHES)} pairs "
          f"(ratio {QUOTA_CHECK_RATIO}, splits {QUOTA_CHECK_SPLITS}; "
          f"{len(p9_kinds)} kinds), and its plain version on "
          f"{len(sbatches)} small step-clock and quota batches (max diff "
          f"{k1_err}); K1 {k1_s:.1f} s, whole phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 10: the serve-full matrix --------------------------------
    scells = expand_scenario("serve-full")
    reset_counts()
    t0 = time.perf_counter()
    srows = sweep.run_sweep(scells, device="cuda")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    path_launches["serve-full"] = read_counts()
    serve_launches = lane_replay.launches
    serve_by = dict(lane_replay.launches_by)
    check(len(srows) == 300, f"serve-full gave {len(srows)} rows")
    check(serve_launches > 0 and all("steps" in k for k in serve_by),
          f"serve-full K1 launches {serve_by}")
    for r in srows:
        what = f"serve-full {r['bench']}/{r['prefetcher']}/{r['eviction']}"
        check(r["backend"] == "cuda" and r["slo_source"] == "kernel",
              f"{what}: backend {r['backend']}, slo {r['slo_source']}")
        for m in ("decode_lat", "ttft"):
            ps = [r[f"{m}_p{q}_us"] for q in (50, 95, 99)]
            check(None not in ps and ps[0] <= ps[1] <= ps[2],
                  f"{what}: {m} percentiles {ps}")
    sprep = [sweep.prepare_cell(c, device="cuda") for c in scells]
    sreqs = [ReplayRequest(tr, pf, cfg, step_bounds=sweep._step_bounds(tr))
             for tr, cfg, pf, _ in sprep]
    serve_batches = path_batches(backend, sreqs)
    check({k: len(v) for k, v in serve_batches.items()} == serve_by,
          f"serve-full lane batches != K1 launches {serve_by}")
    chk = [i for i, c in enumerate(scells) if c.bench == SERVE_CHECK_BENCH]
    for i, want in zip(chk, pool.map(legacy_replay, [sreqs[i] for i in chk])):
        r, (tr, cfg, _, _) = srows[i], sprep[i]
        same_row(r, want, f"serve-full {r['bench']}/{r['prefetcher']}/"
                 f"{r['eviction']}/{r['device_frac']}")
        for f, v in serve_latency_columns(tr, want.step_clocks, cfg).items():
            check(r[f] == v, f"serve-full {r['bench']}/{r['prefetcher']}: "
                  f"{f} {r[f]} != legacy {v}")
    serve_train = sum(r["train_seconds"] for r in srows)
    serve_replay = sum(r["seconds"] for r in srows)
    print(f"phase 10 {card}: serve-full, {len(srows)} rows (per backend "
          f"{per_backend(srows)}) with kernel step clocks and ordered "
          f"percentiles, in "
          f"{serve_s:.1f} s (training {serve_train:.1f} s, replay "
          f"{serve_replay:.1f} s); K1 launches {serve_launches}; the "
          f"{len(chk)} {SERVE_CHECK_BENCH} rows equal the legacy engine",
          flush=True)
    print("bench,prefetcher,eviction,ratio,hit_rate,decode_p50_us,"
          "decode_p99_us,ttft_p50_us,ttft_p99_us")
    for r in srows:
        if r["device_frac"] in (1.0, 0.5):
            print(f"{r['bench']},{r['prefetcher']},{r['eviction']},"
                  f"{r['device_frac']},{r['hit_rate']:.4f},"
                  f"{r['decode_lat_p50_us']:.1f},{r['decode_lat_p99_us']:.1f},"
                  f"{r['ttft_p50_us']:.1f},{r['ttft_p99_us']:.1f}")

    # ---- phase 11: the mt-full matrix -----------------------------------
    tcells = expand_scenario("mt-full")
    reset_counts()
    t0 = time.perf_counter()
    trows = sweep.run_sweep(tcells, device="cuda")
    torch.cuda.synchronize()
    mt_s = time.perf_counter() - t0
    path_launches["mt-full"] = read_counts()
    mt_launches = lane_replay.launches
    mt_by = dict(lane_replay.launches_by)
    check(len(trows) == 360, f"mt-full gave {len(trows)} rows")
    for r in trows:
        what = (f"mt-full {r['bench']}/{r['prefetcher']}/{r['eviction']}/"
                f"{r['capacity_split']}/{r['device_frac']}")
        check(r["backend"] == "cuda", f"{what}: backend {r['backend']}")
        sds = [r[f] for f in ("hit_rate_t0", "hit_rate_t1", "slowdown_t0",
                              "slowdown_t1")]
        check(all(isinstance(x, float) for x in sds), f"{what}: {sds}")
        check(r["interference_slowdown"] == max(sds[2:]),
              f"{what}: interference {r['interference_slowdown']}")
    tprep = [sweep.prepare_cell(c, device="cuda") for c in tcells]
    treqs = [ReplayRequest(tr, pf, cfg, step_bounds=sweep._step_bounds(tr))
             for tr, cfg, pf, _ in tprep]
    solos, _ = sweep._solo_requests(tcells, tprep, [{} for _ in tcells],
                                    None, "cuda")
    # the cells' lanes and the solo replays' lanes pack into exactly the
    # batches K1 launched: no replay of the path ran outside K1
    mt_batches = path_batches(backend, treqs + list(solos.values()))
    check({k: len(v) for k, v in mt_batches.items()} == mt_by,
          f"mt-full lane batches != K1 launches {mt_by}")
    mt_lanes = sum(int((b.iparams[:, 0] > 0).sum())
                   for bs in mt_batches.values() for b in bs)
    # the MVT+StreamTriad rows against the legacy engine, solo replays too
    chk = [i for i, c in enumerate(tcells) if c.bench == MT_CHECK_BENCH]
    solo_want = {}
    for i in chk:
        cell, (tr, cfg, _, dp) = tcells[i], tprep[i]
        for t in range(2):
            cap = sweep._solo_capacity(cfg, dp, t)
            key = sweep._solo_key(cell, t, cap, cfg.eviction)
            if key not in solo_want:
                solo = mt_component_trace(tr, t)
                scfg = UVMConfig(prediction_overhead_us=cell.prediction_us,
                                 device_pages=cap, eviction=cfg.eviction)
                solo_want[key] = ReplayRequest(solo, sweep.make_prefetcher(
                    cell, solo, scfg, None, "cuda"), scfg)
    jobs = [treqs[i] for i in chk] + list(solo_want.values())
    legacy = list(pool.map(legacy_replay, jobs))
    solo_cycles = dict(zip(solo_want, (int(st.cycles)
                                       for st in legacy[len(chk):])))
    for i, want in zip(chk, legacy):
        r, cell, (tr, cfg, _, dp) = trows[i], tcells[i], tprep[i]
        what = (f"mt-full {r['bench']}/{r['prefetcher']}/{r['eviction']}/"
                f"{r['capacity_split']}/{r['device_frac']}")
        same_row(r, want, what)
        last = tenant_last_index(tr)
        bounds = list(sweep._mt_step_bounds(tr))
        for t in range(2):
            th, ta = want.tenant_hits[t], want.tenant_accesses[t]
            check(r[f"hit_rate_t{t}"] == th / ta, f"{what}: hit rate t{t}")
            solo = solo_cycles[sweep._solo_key(
                cell, t, sweep._solo_capacity(cfg, dp, t), cfg.eviction)]
            sd = float(want.step_clocks[bounds.index(last[t] + 1)]) / solo
            check(abs(r[f"slowdown_t{t}"] - sd) <= 1e-6 * sd,
                  f"{what}: slowdown t{t} {r[f'slowdown_t{t}']} != legacy "
                  f"{sd}")
    mt_train = sum(r["train_seconds"] for r in trows)
    mt_replay = sum(r["seconds"] for r in trows)
    print(f"phase 11 {card}: mt-full, {len(trows)} rows (per backend "
          f"{per_backend(trows)}) with per-tenant hit rates and slowdowns, "
          f"in {mt_s:.1f} s (training {mt_train:.1f} s, replay "
          f"{mt_replay:.1f} s); K1 launches {mt_launches}, {mt_lanes} "
          f"lanes ({len(solos)} solo replays); "
          f"the {len(chk)} {MT_CHECK_BENCH} rows and their "
          f"{len(solo_want)} solo replays equal the legacy engine",
          flush=True)
    print("split,prefetcher,eviction,mean_hit_t0,mean_hit_t1,"
          "mean_slowdown_t0,mean_slowdown_t1,max_interference")
    for split in ("shared", "0.5/0.5", "0.4/0.4"):
        for pf in sweep.PREFETCHERS:
            for ev in PORTED_POLICIES:
                sel = [r for r in trows if r["capacity_split"] == split
                       and r["prefetcher"] == pf and r["eviction"] == ev]
                print(f"{split},{pf},{ev},"
                      f"{np.mean([r['hit_rate_t0'] for r in sel]):.4f},"
                      f"{np.mean([r['hit_rate_t1'] for r in sel]):.4f},"
                      f"{np.mean([r['slowdown_t0'] for r in sel]):.4f},"
                      f"{np.mean([r['slowdown_t1'] for r in sel]):.4f},"
                      f"{max(r['interference_slowdown'] for r in sel):.4f}")

    # ---- phase 12: transformer-smoke under the committed selector --------
    xcells = expand_scenario("transformer-smoke")
    with open(SELECTOR) as f:
        selector = json.load(f)["selector"]
    os.environ["REPRO_ADAPTIVE_TABLE"] = SELECTOR
    try:
        reset_counts()
        t0 = time.perf_counter()
        xrows = sweep.run_sweep(xcells, device="cuda")
        torch.cuda.synchronize()
        smoke_s = time.perf_counter() - t0
        path_launches["transformer-smoke"] = read_counts()
        xprep = [sweep.prepare_cell(c, device="cuda") for c in xcells]
    finally:
        del os.environ["REPRO_ADAPTIVE_TABLE"]
    # the assertions of scripts/ci_check.sh on the same scenario
    check(len(xrows) == 4, f"transformer-smoke gave {len(xrows)} rows")
    all_cuda(xrows, "a transformer-smoke row")
    fams = {r["model_family"] for r in xrows}
    check(fams == {"simplified", FAMILY}, f"transformer-smoke families {fams}")
    check(not [r for r in xrows if r["eviction"] == "adaptive"],
          "a transformer-smoke row recorded the adaptive literal")
    by_bench = {}
    for r in xrows:
        by_bench.setdefault(r["bench"], set()).add(r["eviction"])
    check(by_bench == {b: {selector[b]} for b in by_bench},
          f"transformer-smoke evictions {by_bench} != the selector's picks")
    smoke_counts = path_launches["transformer-smoke"]
    check(smoke_counts["flash_attention"] > 0
          and smoke_counts["int4_matmul"] > 0,
          f"transformer-smoke launches {smoke_counts}: K4 (Transformer "
          "inference) or K3 (quantized simplified inference) never ran")
    xreqs = [ReplayRequest(tr, pf, cfg) for tr, cfg, pf, _ in xprep]
    for r, want in zip(xrows, pool.map(legacy_replay, xreqs)):
        same_row(r, want, f"transformer-smoke {r['bench']}/"
                 f"{r['model_family']}")
    print(f"phase 12 {card}: transformer-smoke, {len(xrows)} rows (per "
          f"backend {per_backend(xrows)}) in {smoke_s:.1f} s, families "
          f"{sorted(fams)}, evictions "
          f"{ {b: sorted(p) for b, p in by_bench.items()} } as "
          f"ADAPTIVE_selector.json picks; launches {smoke_counts}; every "
          "row equals the legacy engine on the same inputs", flush=True)

    # ---- phase 13: the Transformer family at full width --------------------
    fcells = sweep.expand_grid(BENCHES, ["learned"], scales=[1.0],
                               windows=[0.6], device_fracs=list(FRACS),
                               evictions=["adaptive"],
                               model_families=[FAMILY],
                               service_steps=paper_tables.SERVICE_STEPS)
    check("REPRO_ADAPTIVE_TABLE" not in os.environ,
          "the family path must probe: no selector table")
    reset_counts()
    t0 = time.perf_counter()
    frows = sweep.run_sweep(fcells, device="cuda")
    torch.cuda.synchronize()
    family_s = time.perf_counter() - t0
    family_counts = path_launches["family"] = read_counts()
    check(len(frows) == 2 * len(BENCHES), f"family path gave {len(frows)} "
          "rows")
    check(all(r["backend"] == "cuda" and r["model_family"] == FAMILY
              for r in frows), "a family-path row is off cuda or the family")
    check(family_counts["flash_attention"] > 0,
          f"K4 never launched on the family path: {family_counts}")
    # every probe-resolved policy against the legacy engine's probe
    probe_jobs = []
    for cell, r in zip(fcells, frows):
        if cell.device_frac is None:
            check(r["eviction"] == "lru", f"family {cell.bench}: no eviction "
                  f"pressure but {r['eviction']}")
            continue
        tr = traces[cell.bench]
        dp = int(tr.working_set_pages * cell.device_frac)
        probe_jobs.append((cell, r, tr, dp))
    preqs = [adaptive.probe_requests(tr, dp, adaptive.PROBE_ACCESSES,
                                     adaptive.probe_proxy("learned"))
             for _, _, tr, dp in probe_jobs]
    plegacy = iter(pool.map(legacy_replay, [q for qs in preqs for q in qs]))
    for (cell, r, tr, dp), qs in zip(probe_jobs, preqs):
        cycles = tuple(float(next(plegacy).cycles) for _ in qs)
        got = adaptive.probed(tr, dp, "learned")
        check(got == (adaptive.pick(cycles), cycles)
              and r["eviction"] == got[0],
              f"family {cell.bench}: K1 probe {got}, row {r['eviction']}, "
              f"legacy probe {adaptive.pick(cycles)} {cycles}")
    resolved = {j[0].bench: j[1]["eviction"] for j in probe_jobs}
    family_train = sum(r["train_seconds"] for r in frows)
    print(f"phase 13 {card}: {FAMILY} family, {len(frows)} rows (per backend "
          f"{per_backend(frows)}) in {family_s:.1f} s (training "
          f"{family_train:.1f} s, "
          f"{sum(1 for r in frows if r['train_seconds'])} fits); launches "
          f"{family_counts}; adaptive at half the working set resolved by "
          f"{len(probe_jobs)} probes on K1 to {resolved}, each equal to the "
          "legacy engine's probe, cycles included", flush=True)
    # the family comparison of benchmarks/family_accuracy.py, from the fits
    # of the main path (simplified) and of this path (the family): each
    # fit's metrics stand on the row of the cell that trained it
    family_cmp = []
    print("bench,family,top1,f1,coverage,hit_rate_half")
    for bench in BENCHES:
        learned = [r for r in rows + frows
                   if r["bench"] == bench and r["prefetcher"] == "learned"]
        half = {r["model_family"]: r for r in learned
                if r["device_frac"] == 0.5}
        fits = {r["model_family"]: r for r in learned if "fit_top1" in r}
        entry = {"bench": bench}
        for fam in ("simplified", FAMILY):
            check(fam in fits, f"no {fam} fit for {bench} on its path")
            m = {k: fits[fam][f"fit_{k}"] for k in ("top1", "f1", "coverage")}
            entry[fam] = dict(m, hit_rate_half=half[fam]["hit_rate"])
            print(f"{bench},{fam},{m['top1']:.4f},{m['f1']:.4f},"
                  f"{m['coverage']:.4f},{half[fam]['hit_rate']:.4f}")
        entry["bar_held"] = (entry[FAMILY]["top1"]
                             >= entry["simplified"]["top1"] - 1e-9)
        family_cmp.append(entry)
    held = [e["bench"] for e in family_cmp if e["bar_held"]]
    print(f"phase 13: the reference's bar ({FAMILY} top-1 >= simplified "
          f"top-1) held on {len(held)} of {len(family_cmp)} benches; missed "
          f"on {[e['bench'] for e in family_cmp if not e['bar_held']]} "
          "(reported, not a check: the port's training draws are torch's)",
          flush=True)

    # ---- phase 14: the paper's predictor tables --------------------------
    # Tables 1-8 and Figs 5, 6, 9 at the reference's sizes (10,000 training
    # and 3,000 evaluation windows; full traces) but PTABLE_STEPS' steps,
    # each distinct cell fitted once; then Fig 10 on the main path's
    # prediction cache.  Launches are read per table
    (predictor_tables.STEPS, predictor_tables.REVISED_STEPS,
     predictor_tables.FIG5_STEPS) = PTABLE_STEPS
    predictor_tables.clear_memo()
    reset_counts()
    t0 = time.perf_counter()
    ptables = {}
    ptable_stats = {}
    for name, run in predictor_tables.TABLES.items():
        before, n_fits = read_counts(), predictor_tables.memo_size()
        t1 = time.perf_counter()
        ptables[name] = run(device="cuda")
        torch.cuda.synchronize()
        after = read_counts()
        new_fits = predictor_tables.fitted_cells()[n_fits:]
        ptable_stats[name] = {
            "seconds": time.perf_counter() - t1, "fits": len(new_fits),
            "train_s": sum(c["train_seconds"] for c in new_fits),
            "eval_s": sum(c["eval_seconds"] for c in new_fits),
            "launches": {k: after[k] - before[k] for k in after}}
    fits = predictor_tables.fitted_cells()
    t1 = time.perf_counter()
    before = read_counts()
    fig10_cells = paper_tables.fig10_cells(BENCHES)
    f10_grid = sweep.run_sweep(fig10_cells, device="cuda")
    torch.cuda.synchronize()
    ptables["fig10"] = paper_tables.fig10_rows(f10_grid)
    after = read_counts()
    ptable_stats["fig10"] = {
        "seconds": time.perf_counter() - t1, "fits": sum(
            1 for r in f10_grid if r["train_seconds"] or "fit_top1" in r),
        "train_s": sum(r["train_seconds"] for r in f10_grid),
        "eval_s": sum(r["predict_seconds"] for r in f10_grid),
        "launches": {k: after[k] - before[k] for k in after}}
    ptables_s = time.perf_counter() - t0
    ptables_counts = path_launches["predictor-tables"] = read_counts()
    # the rows each reference script prints
    expect_rows = {"table1": 9, "table2": 10, "table3": 8, "table4": 8,
                   "table5": 8, "table67": 9, "table8": 9, "fig5": 16,
                   "fig6": 6, "fig9": 20,
                   "fig10": (len(BENCHES) + 1) * len(paper_tables.LATENCIES)}
    for name, rows_ in ptables.items():
        cols = predictor_tables.COLUMNS.get(
            name, ["bench", "latency_us", "ipc_normalized"])
        check(len(rows_) == expect_rows[name], f"{name}: {len(rows_)} rows, "
              f"the reference's {expect_rows[name]}")
        check(all(list(r) == cols for r in rows_),
              f"{name}: columns {list(rows_[0])} != {cols}")
        for r in rows_:
            for c in cols[1:]:
                v = r[c]
                if isinstance(v, str) or c in ("distance", "latency_us"):
                    continue                    # an axis, not a metric
                if c == "degradation":
                    ok = math.isfinite(v) and -1.0 <= v <= 1.0
                elif name in ("table67", "fig10"):
                    ok = math.isfinite(v) and v > 0
                else:
                    ok = math.isfinite(v) and 0.0 <= v <= 1.0
                check(ok, f"{name} {r['bench']}: {c} = {v}")
    n_fits = sum(st["fits"] for st in ptable_stats.values())
    check(n_fits == len(fits) == 76, f"the predictor tables fitted {n_fits} "
          f"cells ({len(fits)} distinct keys), not 76")
    check(all(c["devices"] == ["cuda:0"] for c in fits),
          "a table's predictor was not on cuda: "
          f"{sorted({tuple(c['devices']) for c in fits})}")
    for name, kernel in (("table1", "flash_attention"),
                         ("table5", "hlsh_attention"),
                         ("table8", "int4_matmul"),
                         ("fig5", "flash_attention")):
        check(ptable_stats[name]["launches"][kernel] > 0,
              f"{kernel} never launched for {name}: "
              f"{ptable_stats[name]['launches']}")
    f10_launches = ptable_stats["fig10"]["launches"]
    check(ptable_stats["fig10"]["fits"] == 0
          and all(r["train_seconds"] == 0 for r in f10_grid),
          "Fig 10 trained a predictor: its predictions must come from the "
          "main path's cache")
    check(f10_launches["lane_replay"] > 0 and not any(
        f10_launches[k] for k in f10_launches if k != "lane_replay"),
        f"Fig 10 launches {f10_launches}: K1 only")
    all_cuda(f10_grid, "a Fig 10 row")
    # Fig 10's rows of one bench against the legacy engine on the same
    # predictions (its tree row and its four learned rows)
    fchk = [(c, r) for c, r in zip(fig10_cells, f10_grid)
            if c.bench == FIG10_CHECK_BENCH]
    freqs = [ReplayRequest(tr, pf, cfg) for tr, cfg, pf, _ in
             (sweep.prepare_cell(c, device="cuda") for c, _ in fchk)]
    for (cell, r), want in zip(fchk, pool.map(legacy_replay, freqs)):
        what = f"Fig 10 {cell.bench}/{cell.prefetcher}/{cell.prediction_us}"
        same_row(r, want, what)
        check(abs(r["ipc"] - want.ipc) <= 1e-6 * want.ipc,
              f"{what}: ipc {r['ipc']} != legacy {want.ipc}")
    ptrain = sum(c["train_seconds"] for c in fits)
    peval = sum(c["eval_seconds"] for c in fits)
    print(f"phase 14 {card}: the paper's predictor tables in {ptables_s:.1f} "
          f"s, {n_fits} fits on cuda (training {ptrain:.1f} s, set-up and "
          f"evaluation {peval:.1f} s); launches {ptables_counts}; Fig 10 "
          f"trained nothing (K1 launches {f10_launches['lane_replay']}, rows "
          f"per backend {per_backend(f10_grid)}) and its {len(fchk)} "
          f"{FIG10_CHECK_BENCH} rows equal the legacy engine",
          flush=True)
    titles = {
        "table1": "Table 1: Transformer-based UVM page prediction",
        "table2": "Table 2: clustering ablation",
        "table3": "Table 3: prediction distance",
        "table4": "Table 4: Transformer vs FC (shuffled)",
        "table5": "Table 5: full vs HLSH attention",
        "table67": "Tables 6-7: memory footprint (full vs revised)",
        "table8": "Table 8: Transformer (T) vs revised predictor (R)",
        "fig5": "Fig 5: single-feature prediction",
        "fig6": "Fig 6: delta convergence vs shuffle sensitivity",
        "fig9": "Fig 9: predictor comparison",
        "fig10": "Fig 10: prediction-overhead sensitivity (IPC vs "
                 "UVMSmart)"}
    for name, rows_ in ptables.items():
        st = ptable_stats[name]
        print(f"== {titles[name]} == {st['seconds']:.1f} s, {st['fits']} "
              f"fits (training {st['train_s']:.1f} s, inference "
              f"{st['eval_s']:.1f} s), launches K2 "
              f"{st['launches']['hlsh_attention']} / K3 "
              f"{st['launches']['int4_matmul']} / K4 "
              f"{st['launches']['flash_attention']} / K1 "
              f"{st['launches']['lane_replay']}")
        cols = list(rows_[0])
        print(",".join(cols))
        for r in rows_:
            print(",".join(f"{r[c]:.4f}" if isinstance(r[c], float)
                           else str(r[c]) for c in cols))
    # the reference's own claims, reported and not checked (the port
    # trains with torch's draws)
    t4 = {(r["bench"], r["predictor"]): r["top1"] for r in ptables["table4"]}
    fc_loss = {b: t4[(b, "fc")] - t4[(b, "transformer")]
               for b in predictor_tables.TABLE4_BENCHES}
    print("phase 14 (reported): Table 4, FC top-1 less Transformer top-1 on "
          "shuffled inputs: " + ", ".join(f"{b} {v:+.4f}"
                                          for b, v in fc_loss.items())
          + "; the reference's claim (ATAX/BICG survive FC, NW/Backprop "
          "need attention: the difference is higher on both of the first "
          "two than on both of the last two) "
          + ("holds" if min(fc_loss["ATAX"], fc_loss["BICG"])
             > max(fc_loss["NW"], fc_loss["Backprop"]) else "does not hold"))
    f6 = ptables["fig6"]
    hi = [r["degradation"] for r in f6 if r["convergence"] >= 0.7]
    lo = [r["degradation"] for r in f6 if r["convergence"] < 0.7]
    print("phase 14 (reported): Fig 6, degradation (ordered less shuffled "
          "top-1) against delta convergence: " + ", ".join(
              f"{r['bench']} {r['convergence']:.3f} -> "
              f"{r['degradation']:+.4f}" for r in f6)
          + "; high-convergence benches degrade less than low ones: "
          + ("yes" if hi and lo and max(hi) < min(lo) else "no"))
    t8 = ptables["table8"]
    gaps = [r["top1_R"] - r["top1_T"] for r in t8]
    print("phase 14 (reported): Table 8, revised (R) against Transformer "
          f"(T) top-1: mean T {np.mean([r['top1_T'] for r in t8]):.4f}, "
          f"mean R {np.mean([r['top1_R'] for r in t8]):.4f}, R - T from "
          f"{min(gaps):+.4f} to {max(gaps):+.4f}; R >= T on "
          f"{sum(g >= 0 for g in gaps)} of {len(t8)} benches")
    t67 = ptables["table67"]
    print("phase 14 (reported): Tables 6-7, full (fp32) against revised "
          "(4-bit) footprint at a batch of "
          f"{predictor_tables.FOOTPRINT_BATCH}: " + ", ".join(
              f"{r['bench']} {r['full_total_mb']:.2f} / "
              f"{r['revised_total_mb']:.3f} MB ({r['ratio']:.0f}x)"
              for r in t67), flush=True)

    # ---- phase 15: kernel times -----------------------------------------
    # K1 on the tables' tree batch (11 scale-1.0 lanes, no evictions)
    # against its plain version: the tree family at a driven path's shapes.
    # Its slowest lane sets K1's chain bound: a lane is one dependent chain
    # of accesses, so a batch takes at least its longest lane's accesses
    # times the time an access takes in a lane that never evicts
    treqs = []
    for bench in BENCHES:
        trace, config, pf, _ = sweep.prepare_cell(
            paper_tables.eval_cell(bench, "tree"), device="cuda")
        treqs.append(ReplayRequest(trace, pf, config))
    (tidx,) = backend.pack_lanes(treqs)
    t_batch = backend.pack_batch([treqs[i] for i in tidx])
    err, _, t_plain_s = k1_vs_plain(t_batch)
    check(err == 0.0, f"K1 vs plain on the tables' tree batch: max diff "
          f"{err}")
    k1_err = max(k1_err, err)
    t_args = t_batch.kernel_args("cuda")
    t_out, t_lane = k1_lanes(t_batch)
    check(int(t_out[:, 7].max()) == 0, "the tables' tree batch evicted")
    access_us = t_lane["us"] / t_lane["accesses"]

    def chain_bound_ms(batch):
        return int(batch.iparams[:, 0].max()) * access_us / 1e3

    variants[("tree", "lru")].update(
        tables_lanes=len(tidx),
        tables_accesses=int(t_batch.iparams[:, 0].sum()),
        tables_ms=cuda_ms(lambda: lane_replay(**t_args), reps=3),
        tables_plain_ms=t_plain_s * 1e3, tables_bound_ms=k1_bound_ms(t_batch),
        tables_chain_bound_ms=chain_bound_ms(t_batch),
        tables_slowest_lane=t_lane, tables_max_abs_err=err)
    tv = variants[("tree", "lru")]
    print(f"phase 15 {card}: K1 tree/lru {tv['tables_ms']:.3f} ms per launch "
          f"on the tables' tree batch ({len(tidx)} lanes, "
          f"{tv['tables_accesses']} accesses; {lane_text(t_lane)}), equal to "
          f"its plain version ({tv['tables_plain_ms']:.1f} ms on the host); "
          f"chain bound {access_us * 1e3:.1f} ns per access", flush=True)
    # K1 on each golden quota batch (the quota kinds run on no timed path
    # batch of their own): its slowest lane and its chain bound
    for _, batch in gbatches:
        key = variant_key(batch)
        if "quotas" not in key:
            continue
        _, lane = k1_lanes(batch)
        v = variants[key]
        v.update(golden_slowest_lane=lane,
                 golden_chain_bound_ms=chain_bound_ms(batch))
        v["golden_chain_share"] = v["golden_chain_bound_ms"] / v["golden_ms"]
        print(f"phase 15 {card}: K1 {'/'.join(key)} {v['golden_ms']:.3f} ms "
              f"per launch on its golden batch ({v['golden_lanes']} lanes, "
              f"{v['golden_accesses']} accesses; {lane_text(lane)}; chain "
              f"bound {v['golden_chain_bound_ms']:.3f} ms, "
              f"{100 * v['golden_chain_share']:.0f}% of it)", flush=True)
    # K1 per family x policy on the largest batch of the matrix
    for key, v in variants.items():
        if len(key) > 2:
            continue
        cand = [b for b in mbatches if kind_of(mreqs[b[0]]) == key]
        big = max(cand, key=lambda b: sum(len(mreqs[i].trace) for i in b))
        batch = backend.pack_batch([mreqs[i] for i in big])
        args_ = batch.kernel_args("cuda")
        _, lane = k1_lanes(batch)
        v.update(matrix_launches=matrix_by.get(key, 0),
                 matrix_lanes=len(big),
                 matrix_accesses=int(batch.iparams[:, 0].sum()),
                 ms=cuda_ms(lambda: lane_replay(**args_), reps=2),
                 bound_ms=k1_bound_ms(batch),
                 chain_bound_ms=chain_bound_ms(batch), slowest_lane=lane)
        v["chain_share"] = v["chain_bound_ms"] / v["ms"]
        print(f"phase 15 {card}: K1 {key[0]}/{key[1]} {v['ms']:.2f} ms per "
              f"launch on the matrix's largest batch ({len(big)} lanes, "
              f"{v['matrix_accesses']} accesses; {lane_text(lane)}; chain "
              f"bound {v['chain_bound_ms']:.2f} ms, "
              f"{100 * v['chain_share']:.0f}% of it; bytes bound "
              f"{v['bound_ms']:.5f} ms); golden batch {v['golden_ms']:.3f} "
              f"ms, plain {v['golden_plain_ms']:.1f} ms", flush=True)
    # the step-clock and quota variants on the largest batch of each path,
    # with the slowest lane's evictions; the serve batches also without
    # their step capture, and the shared multi-tenant batches also through
    # the quota specialisation, to cost each variant's own branch on the
    # same lanes
    for path, by_key, by in (("serve", serve_batches, serve_by),
                             ("mt", mt_batches, mt_by)):
        for key, batches in sorted(by_key.items()):
            big = max(batches, key=lambda b: int(b.iparams[:, 0].sum()))
            args_ = big.kernel_args("cuda")
            out, lane = k1_lanes(big)
            v = variants.setdefault(key, new_variant(key))
            v.update({f"{path}_launches": by.get(key, 0),
                      f"{path}_lanes": int((big.iparams[:, 0] > 0).sum()),
                      f"{path}_accesses": int(big.iparams[:, 0].sum()),
                      f"{path}_max_lane_evictions": int(out[:, 7].max()),
                      f"{path}_slowest_lane": lane,
                      f"{path}_ms": cuda_ms(lambda: lane_replay(**args_),
                                            reps=1),
                      f"{path}_bound_ms": k1_bound_ms(big),
                      f"{path}_chain_bound_ms": chain_bound_ms(big)})
            same = None
            if key[2:] == ("steps",):
                other = (dataclasses.replace(big, sids=None, steps_len=0)
                         if path == "serve"
                         else dataclasses.replace(big, quotas=True))
                o_args = other.kernel_args("cuda")
                same = "without steps" if path == "serve" else "as quotas"
                v[f"{path}_ms_{same.replace(' ', '_')}"] = cuda_ms(
                    lambda: lane_replay(**o_args), reps=1)
            print(f"phase 15 {card}: K1 {'/'.join(key)} "
                  f"{v[path + '_ms']:.2f} ms per launch on {path}-full's "
                  f"largest batch ({v[path + '_lanes']} lanes, "
                  f"{v[path + '_accesses']} accesses, at most "
                  f"{v[path + '_max_lane_evictions']} evictions a lane; "
                  f"{lane_text(lane)}; chain bound "
                  f"{v[path + '_chain_bound_ms']:.2f} ms, "
                  f"{100 * v[path + '_chain_bound_ms'] / v[path + '_ms']:.0f}"
                  f"% of it); {v[path + '_launches']} launches"
                  + ("" if same is None else
                     f"; {same}: "
                     f"{v[path + '_ms_' + same.replace(' ', '_')]:.2f} ms"),
                  flush=True)
    # the victim search against the span: one serve lane (ServeDecode,
    # tree/lru at half its working set), its pages moved up by whole spans
    # so that the search covers more empty chunks while the replay stays
    # the same (lru and the tree's node counts see only page differences
    # within 2 MB windows)
    tr = sweep.load_trace("ServeDecode", 1.0, 0, None)
    cfg = UVMConfig(device_pages=int(tr.working_set_pages * 0.5))
    base = backend.pack_batch([ReplayRequest(tr, TreePrefetcher(), cfg)])
    base_out = None
    scan_span = []
    for extra in (0, 1, 3, 7):
        shifted = dataclasses.replace(
            base, pages=base.pages + extra * base.span,
            span=base.span * (1 + extra))
        s_args = shifted.kernel_args("cuda")
        out, lane = k1_lanes(shifted)
        base_out = out if base_out is None else base_out
        check(torch.equal(out, base_out), f"the shifted lane (span "
              f"{shifted.span}) replays differently")
        ms = cuda_ms(lambda: lane_replay(**s_args), reps=2)
        ev = float(out[0, 7])
        scan_span.append({
            "span": shifted.span, "scanned": lane["scanned_slots"],
            "ms": ms, "evictions": int(ev),
            "chunk_scans": lane["chunk_scans"],
            "scans_per_eviction": lane["chunk_scans"] / ev,
            "us_per_eviction": ms * 1e3 / ev})
    flat = scan_span[-1]["us_per_eviction"] / scan_span[0]["us_per_eviction"]
    print(f"phase 15 {card}: K1 tree/lru on one ServeDecode lane "
          f"({int(base_out[0, 7])} evictions in {len(tr)} accesses, "
          f"{tr.working_set_pages} pages of working set, the same at every "
          "span) against the slots its victim search covers: " + ", ".join(
              f"{x['scanned']} slots {x['ms']:.1f} ms "
              f"({x['us_per_eviction']:.2f} us and "
              f"{x['scans_per_eviction']:.2f} chunk scans per eviction)"
              for x in scan_span)
          + f"; the largest span's us per eviction is {flat:.2f}x the "
          "smallest's", flush=True)
    # K1 on the main path's learned batch against its plain version
    plain, plain_s = main_plain.result()
    err, _ = k1_against(k1_batch, plain)
    check(err == 0.0, f"K1 vs plain on the main-path batch: max diff {err}")
    k1_err = max(k1_err, err)
    k1_args = k1_batch.kernel_args("cuda")
    k1_ms = cuda_ms(lambda: lane_replay(**k1_args), reps=3)
    # one launch is about 0.15 s: the profiler's device time, no graph
    k1_dev = profiled_ms(lambda: lane_replay(**k1_args), reps=1)
    k1_bound = k1_bound_ms(k1_batch)
    k1_chain = chain_bound_ms(k1_batch)
    n_acc = int(k1_batch.iparams[:, 0].sum())
    # K2, K3 and K4 at the predictor's shapes: per call through the wrapper
    # (what a path pays) and device time per launch (a CUDA graph of the
    # launches), the kernel, its PyTorch call and its plain version in
    # turns; K2 and K3 rotate through copies of their inputs so that no
    # call finds its data in L2 (one K4 call already moves 393 MB)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def timing_fields(t, bound_ms):
        dev = t["kernel"]["device_ms"]
        return {"ms": t["kernel"]["ms"], "device_ms": dev,
                "plain_ms": t["plain"]["ms"],
                "plain_device_ms": t["plain"]["device_ms"],
                "library_ms": t["library"]["ms"],
                "library_device_ms": t["library"]["device_ms"],
                "share_of_bound": None if dev is None else bound_ms / dev,
                "timing": t["kernel"]["method"]}

    def k2_record(q, v, keep):
        """K2 at q's shape and type, its PyTorch call and its plain version
        in turns, over rotating copies: one record of the kernels line.
        The yardstick is one scaled_dot_product_attention call on
        pre-masked q/k (the port never calls it).  k holds q's values in a
        tensor of its own, as on the path (the layer's shared QK is split
        into head-major copies), so every call reads q, k, v and keep and
        writes the output"""
        b, n, d = q.shape
        k = q.clone()
        qm = (q * keep[..., None]).contiguous()
        km = qm.clone()
        nbytes = (4 * b * n * d + b * n) * q.element_size()
        copies = copies_of((q, k, v, keep, qm, km), nbytes)
        t = timed_in_turns({
            "kernel": rotating(lambda q, k, v, kp, qm, km: hlsh_attention(
                q, k, v, kp), copies),
            "library": rotating(lambda q, k, v, kp, qm, km: sdpa(qm, km, v),
                                copies),
            "plain": rotating(lambda q, k, v, kp, qm, km:
                              hlsh_attention_plain(q, k, v, kp), copies)},
            reps=50)
        # the products this keep mask needs: a logit for each pair of kept
        # query and kept key (an erased one is 0), a value product for
        # every pair
        kept = (keep > 0).sum(1).double()
        flops = float((2 * d * kept * kept + 2 * d * n * n).sum())
        by_bytes = nbytes / HBM_BYTES_S * 1e3
        by_ops = flops / F32_FLOPS * 1e3
        bound = max(by_bytes, by_ops)
        return {"shape": [b, n, d], "dtype": str(q.dtype).split(".")[1],
                "variant": hlsh_geometry(b, n, d, q.dtype).name(),
                "bound_ms": bound,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                **timing_fields(t, bound)}

    def k4_record(shape):
        """K4 at a (B, H, H, S, S, D) float32 shape, its PyTorch call (one
        scaled_dot_product_attention call on the same tensors) and its
        plain version in turns, over rotating copies."""
        b, h, _, s_, _, d = shape
        _, qkv = k4_against_plain(rng, shape, False, torch.float32)
        nbytes = 4 * b * h * s_ * d * 4
        copies = copies_of(qkv, nbytes)
        t = timed_in_turns({
            "kernel": rotating(flash_attention, copies),
            "library": rotating(sdpa, copies),
            "plain": rotating(flash_attention_plain, copies)})
        by_bytes = nbytes / HBM_BYTES_S * 1e3
        by_ops = 4 * b * h * s_ * s_ * d / F32_FLOPS * 1e3
        bound = max(by_bytes, by_ops)
        return {"shape": list(shape), "dtype": "float32",
                "variant": flash_geometry(b * h, s_, s_, d).name(),
                "bound_ms": bound,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                **timing_fields(t, bound)}

    # K2 at the main path's shape in both types (the same inputs) and at
    # Table 5's HLSH rows
    q, v, keep = k2_inputs[(K2_CASES[0][0], "float32")]
    k2_main = k2_record(q, v, keep)
    k2_bf16 = dict(k2_record(*(t.to(torch.bfloat16) for t in (q, v, keep))),
                   max_abs_err=k2_err["bfloat16"],
                   max_abs_err_from_bf16_plain=k2_bf16_plain)
    k2_table5 = dict(k2_record(*k2_inputs[(K2_TABLE5_SHAPE, "float32")]),
                     path="predictor tables, Table 5")
    # K4 at the Transformer family's shape (one call moves 393 MB, so one
    # copy) and at the tables' shapes
    k4_main = k4_record(K4_PATH_SHAPE)
    k4_tables = [dict(k4_record(shape), path="predictor tables")
                 for shape in K4_TABLE_SHAPES]
    def k3_record(m, kd, n3):
        """K3 on a packed (K, N) weight, its PyTorch call (one torch.matmul
        on the dequantized weight) and its plain version in turns, over
        rotating copies of x."""
        _, _, (x3, w3, s3) = k3_against_plain(rng, m, kd, n3,
                                              torch.float32, True)
        w_deq = unpack_int4(w3).float() * s3
        by3 = m * kd * 4 + w3.numel() + m * n3 * 4 + 4
        b3 = by3 / HBM_BYTES_S * 1e3
        o3 = 2 * m * kd * n3 / F32_FLOPS * 1e3
        x3_in = copies_of((x3,), by3)
        t3 = timed_in_turns({
            "kernel": rotating(lambda x: int4_matmul(x, w3, s3), x3_in),
            "library": rotating(lambda x: torch.matmul(x, w_deq), x3_in),
            "plain": rotating(lambda x: int4_matmul_plain(x, w3, s3), x3_in)})
        return {"shape": [m, kd, n3],
                "variant": int4_variant(m, kd, n3, x3.dtype, x3.data_ptr()),
                "bound_ms": max(b3, o3),
                "bound_by": "bytes" if b3 >= o3 else "operations",
                **timing_fields(t3, max(b3, o3))}

    # K3 at the classification head's shape and the layer products, then
    # Table 8's layer products and its head at the smallest and largest
    # class counts (padded to even)
    k3_times = [k3_record(*shape)
                for shape in ((4096, 12, 20000),) + K3_PATH_SHAPES[:3]]
    t8_heads = sorted(set(table8_classes.values()))
    k3_times += [dict(k3_record(*shape), path="predictor tables, Table 8")
                 for shape in K3_TABLE8_SHAPES + tuple(
                     (512, 12, n + n % 2) for n in (t8_heads[0],
                                                    t8_heads[-1]))]
    k3_head = k3_times[0]
    # K3 on its path: one bench's quantized simplified inference
    # (predict_trace, HLSH: six weight products a batch) with the products
    # on K3 and as the plain fake-quant product, in turns on one model
    svc = PredictorService(steps=paper_tables.SERVICE_STEPS, device="cuda")
    svc.fit(traces[INFER_BENCH])
    model = svc.result.model
    infer_s = {"k3": [], "fake_quant": []}
    infer_preds = {}
    for which in ("fake_quant", "k3", "k3", "fake_quant"):
        if which == "fake_quant":
            model._mm = lambda x, w: x @ model._qw(w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_preds[which] = svc.predict_trace()
        torch.cuda.synchronize()
        infer_s[which].append(time.perf_counter() - t0)
        model.__dict__.pop("_mm", None)
    agree = float(np.mean(infer_preds["k3"] == infer_preds["fake_quant"]))
    check(agree >= 0.99, f"{INFER_BENCH} predictions with K3 agree with the "
          f"fake-quant product's on {agree:.4f} of accesses")
    print(f"phase 15 {card}: {INFER_BENCH} quantized simplified inference "
          f"({len(traces[INFER_BENCH])} accesses): K3 "
          f"{', '.join(f'{x:.3f}' for x in infer_s['k3'])} s, fake-quant "
          f"product {', '.join(f'{x:.3f}' for x in infer_s['fake_quant'])} "
          f"s; predictions equal on {agree:.4f} of accesses", flush=True)

    def by_path(name):
        return {p: c[name] for p, c in path_launches.items()}

    kernels = [
        {"name": "lane_replay", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": sum(by_path("lane_replay").values()),
         "launches_by_path": by_path("lane_replay"),
         "max_abs_err": k1_err, "ms": k1_ms, "device_ms": k1_dev,
         "timing": "profiler" if k1_dev is not None else "not measured",
         "plain_ms": plain_s * 1e3, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None, "library_device_ms": None,
         "share_of_bound": None if k1_dev is None else k1_bound / k1_dev,
         "chain_bound_ms": k1_chain, "access_us": access_us,
         "chain_share": None if k1_dev is None else k1_chain / k1_dev,
         "variant": "learned/lru",
         "variants": [dict(v, bound_by="bytes", library_ms=None)
                      for v in variants.values()],
         "scan_vs_span": scan_span},
        {"name": "hlsh_attention", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES,
         "launches": sum(by_path("hlsh_attention").values()),
         "launches_by_path": by_path("hlsh_attention"),
         "max_abs_err": k2_err["float32"], "max_abs_err_by_dtype": k2_err,
         **k2_main, "variants": [k2_bf16, k2_table5]},
        {"name": "int4_matmul", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES,
         "launches": sum(by_path("int4_matmul").values()),
         "launches_by_path": by_path("int4_matmul"),
         "max_abs_err": k3_abs, "max_rel_err": k3_err, **k3_head,
         "variants": k3_times[1:],
         "inference_s": dict(infer_s, bench=INFER_BENCH,
                             predictions_equal=agree)},
        {"name": "flash_attention", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES,
         "launches": sum(by_path("flash_attention").values()),
         "launches_by_path": by_path("flash_attention"),
         "max_abs_err": max(k4_err.values()), "max_abs_err_by_dtype": k4_err,
         "bf16_path_shape_err": k4_bf16_path, **k4_main,
         "tilings": {t: FlashGeometry(t, WARP_HEADS if t == "warp" else 1)
                     .name() for t in TILINGS},
         "tilings_checked": {t: len(c) for t, c in k4_tilings.items()},
         "variants": k4_tables},
    ]

    def times(t):
        """One kernel's times: per call / device per launch."""
        def ms(x):
            return "not measured" if x is None else f"{x:.4f}"
        share = ("not measured" if t["share_of_bound"] is None
                 else f"{100 * t['share_of_bound']:.0f}%")
        return (f"{ms(t['ms'])} / {ms(t['device_ms'])} ms per call / device "
                f"({t['timing']}), plain "
                f"{ms(t['plain_ms'])} / {ms(t['plain_device_ms'])}, library "
                f"{ms(t['library_ms'])} / {ms(t['library_device_ms'])}, bound "
                f"{t['bound_ms']:.4f} by {t['bound_by']} ({share} of it)")

    k1_dev_txt = "not measured" if k1_dev is None else f"{k1_dev:.3f}"
    print(f"phase 15 {card}: K1 {k1_ms:.3f} ms per launch ({k1_dev_txt} ms "
          f"device) on the main path's learned batch "
          f"({len(k1_batch.pages)} lanes padded, {n_acc} accesses; chain "
          f"bound {k1_chain:.2f} ms; plain version {plain_s * 1e3:.1f} ms on "
          "the host)", flush=True)
    for t in (k2_main, k2_bf16, k2_table5):
        print(f"phase 15 {card}: K2 at {tuple(t['shape'])} [{t['variant']}] "
              f"{t['dtype']} {times(t)} (library: "
              "scaled_dot_product_attention)", flush=True)
    for t in [k4_main] + k4_tables:
        print(f"phase 15 {card}: K4 at {tuple(t['shape'])} float32 "
              f"[{t['variant']}] {times(t)} (library: "
              "scaled_dot_product_attention)", flush=True)
    for t in k3_times:
        print(f"phase 15 {card}: K3 at {tuple(t['shape'])} float32 "
              f"[{t['variant']}] {times(t)} (library: torch.matmul on the "
              "dequantized weight)", flush=True)
    print(f"phase 15: K4 launches by path {by_path('flash_attention')}",
          flush=True)
    print(f"phase 15: K3 launches by path {by_path('int4_matmul')}; K2 "
          f"{by_path('hlsh_attention')}; whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 16: the backend chain on the card -------------------------
    # one cell for each route on which K1 declines, through run_sweep or
    # dispatch with backend "cuda": each lands on the NumPy engine, names
    # why, launches nothing, and equals the legacy engine (in the host
    # workers, started first)
    from repro_torch.uvm.backends.cuda_backend import (
        MAX_TREE_LANE_ACCESSES, decline_reason)
    from repro_torch.uvm.replay_core import dispatch
    reset_counts()
    t0 = time.perf_counter()
    near = traces[CHAIN_BENCH]
    far = relocated(traces[FAR_BENCH], FAR_ARRAY, FAR_SHIFT)
    wtrace = sweep.load_trace(*WINDOWS_TRACE)

    def half(tr):
        return int(tr.working_set_pages * 0.5)

    direct = {
        "oracle lookahead 1024": lambda: ReplayRequest(
            near, OraclePrefetcher(np.asarray(near.pages), lookahead=1024),
            UVMConfig(device_pages=half(near))),
        f"{len(wtrace)} step windows": lambda: ReplayRequest(
            wtrace, NoPrefetcher(), UVMConfig(device_pages=half(wtrace)),
            step_bounds=np.arange(1, len(wtrace) + 1, dtype=np.int64)),
        f"span past {FAR_SHIFT} pages": lambda: ReplayRequest(
            far, TreePrefetcher(), UVMConfig(device_pages=half(far),
                                             eviction="hotcold")),
    }
    fig11_cells = {pf: paper_tables.eval_cell(paper_tables.FIG11_BENCH, pf)
                   for pf in ("tree", "learned")}
    long_cell = sweep.SweepCell(LONG_TREE_BENCH, "tree",
                                scale=LONG_TREE_SCALE)
    long_name = f"tree, {LONG_TREE_BENCH} at scale {LONG_TREE_SCALE}"
    swept = {f"Fig 11 {pf}": c for pf, c in fig11_cells.items()}
    swept[long_name] = long_cell
    swept_reqs = {}
    for name, cell in swept.items():
        tr, cfg, pf, _ = sweep.prepare_cell(cell, device="cuda")
        swept_reqs[name] = ReplayRequest(
            tr, pf, cfg, record_timeline=name.startswith("Fig 11"))
    check(len(swept_reqs[long_name].trace) > MAX_TREE_LANE_ACCESSES,
          f"{long_name}: {len(swept_reqs[long_name].trace)} accesses, not "
          f"past K1's tree ceiling {MAX_TREE_LANE_ACCESSES}")
    probe_of = adaptive.probe_proxy("tree")

    def probes():
        return adaptive.probe_requests(far, half(far),
                                       adaptive.PROBE_ACCESSES, probe_of)

    jobs = ([f() for f in direct.values()] + list(swept_reqs.values())
            + probes())
    chain_legacy = [pool.submit(legacy_replay, r) for r in jobs]
    launches_before = lane_replay.launches
    fig11 = paper_tables.fig11_timeline(device="cuda")
    chain_rows = {f"Fig 11 {pf}": row for pf, (row, _) in fig11.items()}
    (chain_rows[long_name],) = sweep.run_sweep([long_cell], device="cuda")
    dstats = {name: dispatch(f(), "cuda", "cuda")
              for name, f in direct.items()}
    chosen = adaptive.resolve_all([("adaptive", far.name, far, half(far),
                                    "tree")], device="cuda")[0]
    pstats = [dispatch(r, "cuda", "cuda") for r in probes()]
    cell_req = ReplayRequest(far, TreePrefetcher(), UVMConfig(
        device_pages=half(far), eviction=chosen))
    dstats[f"adaptive (chose {chosen})"] = dispatch(cell_req, "cuda", "cuda")
    torch.cuda.synchronize()
    chain_card_s = time.perf_counter() - t0
    path_launches["chain"] = read_counts()
    check(lane_replay.launches == launches_before,
          f"K1 launched {lane_replay.launches - launches_before} times on "
          "the chain's declined cells")
    reasons = {name: decline_reason(f()) for name, f in direct.items()}
    reasons.update({name: decline_reason(r)
                    for name, r in swept_reqs.items()})
    reasons[f"adaptive (chose {chosen})"] = decline_reason(cell_req)
    reasons.update({f"probe {r.config.eviction}": decline_reason(r)
                    for r in probes()})
    chain_stats = [f.result() for f in chain_legacy]
    chain_want = dict(zip(list(direct) + list(swept_reqs), chain_stats))
    plegacy = chain_stats[len(direct) + len(swept_reqs):]
    chain_want[f"adaptive (chose {chosen})"] = legacy_replay(ReplayRequest(
        far, TreePrefetcher(), UVMConfig(device_pages=half(far),
                                         eviction=chosen)))
    for name, st in dstats.items():
        check(st.backend == "numpy", f"chain {name}: backend {st.backend}")
        same_stats(st, chain_want[name], f"chain {name} vs legacy")
    for name, row in chain_rows.items():
        check(row["backend"] == "numpy",
              f"chain {name}: backend {row['backend']}")
        same_row(row, chain_want[name], f"chain {name}")
    for pf, (row, gbs) in fig11.items():
        tl = np.asarray(row["timeline"])
        wtl = chain_want[f"Fig 11 {pf}"].timeline
        check(tl.shape == wtl.shape and np.allclose(tl, wtl, rtol=1e-6,
                                                    atol=0.0),
              f"Fig 11 {pf}: the timeline differs from the legacy engine's")
        check(row["train_seconds"] == 0.0,
              f"Fig 11 {pf} trained: the main path's cache must serve it")
    pcycles = tuple(float(st.cycles) for st in plegacy)
    for st, w in zip(pstats, plegacy):
        check(st.backend == "numpy", f"chain probe: backend {st.backend}")
        same_stats(st, w, f"chain probe {st.eviction} vs legacy")
    check(adaptive.probed(far, half(far), "tree")
          == (adaptive.pick(pcycles), pcycles) and chosen == adaptive.pick(
              pcycles), f"chain adaptive: chose {chosen}, the legacy engine's "
          f"probe {adaptive.pick(pcycles)} {pcycles}")
    check(all(reasons.values()), f"a chain cell K1 accepts: {reasons}")
    chain_s = time.perf_counter() - t0
    print(f"phase 16 {card}: the backend chain, "
          f"{len(dstats) + len(chain_rows)} "
          f"cells and {len(pstats)} probes K1 declines, all on numpy and "
          f"equal to the legacy engine (timelines element by element), K1 "
          f"launches {path_launches['chain']['lane_replay']}; the card's "
          f"side {chain_card_s:.1f} s, whole phase {chain_s:.1f} s",
          flush=True)
    for name, why in reasons.items():
        print(f"  {name}: numpy, because {why}")
    print(f"phase 16: Fig 11 ({paper_tables.FIG11_BENCH}, PCIe GB/s in "
          f"windows of 10,000 cycles at {paper_tables.CORE_MHZ:.0f} MHz): "
          + "; ".join(f"{pf} {len(g)} windows, peak {g[:, 1].max():.3f}, "
                      f"mean {g[:, 1].mean():.3f}, {len(row['timeline'])} "
                      "transfers" for pf, (row, g) in fig11.items())
          + "; the first windows with traffic:")
    print("prefetcher,cycle,gbs")
    for pf, (_, gbs) in fig11.items():
        for cyc, rate in gbs[gbs[:, 1] > 0][:5]:
            print(f"{pf},{cyc:.0f},{rate:.3f}")
    # what a declined cell costs: accesses per second of the legacy loop,
    # the NumPy engine and a one-lane K1 batch (its packing included) on
    # the chain bench at half its working set, each family under lru, two
    # replays each, in turns
    thru = []
    for name in ("none", "tree", "learned", "oracle"):
        cfg = UVMConfig(device_pages=half(near))
        secs = {"legacy": 0.0, "numpy": 0.0, "cuda": 0.0}
        for engine in ("legacy", "numpy", "cuda", "cuda", "numpy", "legacy"):
            req = ReplayRequest(near, makers[name](near, cfg), cfg)
            t1 = time.perf_counter()
            st = get_backend(engine, "cuda").replay([req])[0]
            torch.cuda.synchronize()
            secs[engine] += time.perf_counter() - t1
            if engine == "legacy":
                base = st
            else:
                same_stats(st, base, f"throughput {name}: {engine} vs "
                           "legacy")
        thru.append({"family": {"none": "demand"}.get(name, name),
                     "accesses": len(near), **{
                         f"{e}_acc_per_s": 2 * len(near) / sec
                         for e, sec in secs.items()}})
    print(f"phase 16 {card}: accesses per second on {CHAIN_BENCH} "
          f"({len(near)} accesses, half the working set, lru): "
          + "; ".join(f"{t['family']} legacy {t['legacy_acc_per_s']:.0f}, "
                      f"numpy {t['numpy_acc_per_s']:.0f}, K1 one lane "
                      f"{t['cuda_acc_per_s']:.0f}" for t in thru)
          + f"; whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 17: crash safety -------------------------------------------
    # each run is a process of its own (the sweep drivers and their lease
    # workers share the card with this one): each process of a run logs its
    # launch counts under the run's own directory (kernels.LAUNCH_LOG_ENV),
    # and the path's counts are their sums
    reset_counts()
    t17 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop(faults.FAULT_PLAN_ENV, None)
    run_launches = {}

    def run_module(name, module, *argv):
        """Run ``module`` as a process; return its stdout, its wall and the
        launches its processes logged."""
        t0 = time.perf_counter()
        log_dir = os.path.join(work, "launches", name)
        res = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                             env=dict(env, **{LAUNCH_LOG_ENV: log_dir}),
                             capture_output=True, text=True, timeout=600)
        check(res.returncode == 0,
              f"{module} {' '.join(argv)}: exit {res.returncode}\n"
              f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        run_launches[name] = read_launch_log(log_dir)
        return res.stdout, time.perf_counter() - t0

    def chaos_smoke(name, *argv):
        """``chaos-smoke`` under the default plan, with the assertions of
        scripts/ci_check.sh: its report, rows and wall."""
        out = os.path.join(work, name)
        stdout, wall = run_module(
            name, "repro_torch.uvm.faults", "--scenario", "chaos-smoke",
            "--device", "cuda", "--out", out, *argv)
        report = json.loads(stdout.strip().splitlines()[-1])
        check(report["cells"] == 8, f"chaos-smoke {name}: {report}")
        check(report["faults_fired"] > 0,
              f"chaos-smoke {name} injected no fault: {report}")
        with open(os.path.join(out, "chaos", "quarantine.json")) as f:
            manifest = json.load(f)
        check(manifest["cells"] == [], f"chaos-smoke {name} quarantined "
              f"{manifest['cells']}")
        crows = sweep.read_results(os.path.join(out, "chaos"))
        check(faults.rows_digest(crows) == report["digest"]
              == faults.rows_digest(sweep.read_results(
                  os.path.join(out, "baseline"))),
              f"chaos-smoke {name}: the rows differ from the baseline's")
        return report, crows, wall

    # (b) runs on the host while (a)'s drivers take turns on the card: both
    # are mostly processes starting up
    with concurrent.futures.ThreadPoolExecutor(1) as side:
        on_numpy = side.submit(chaos_smoke, "chaos_numpy", "--backend",
                               "numpy", "--workers", "2")
        report_k1, rows_k1, chaos_k1_s = chaos_smoke("chaos_cuda",
                                                     "--backend", "cuda")
        report_np, rows_np, chaos_np_s = on_numpy.result()
    all_cuda(rows_k1, "a chaos-smoke row on K1")
    check(run_launches["chaos_cuda"]["lane_replay"] > 0,
          f"chaos-smoke on K1 logged no K1 launch: {run_launches}")
    check(all(r["backend"] == "numpy" for r in rows_np),
          f"chaos-smoke on numpy: rows per backend {per_backend(rows_np)}")
    for got, want in zip(rows_np, rows_k1):
        check(all(got[k] == want[k] for k in ("bench", "prefetcher",
                                                "eviction", "device_pages")),
              f"chaos-smoke: row order {got['bench']} != {want['bench']}")
        same_row(got, types.SimpleNamespace(**want),
                 f"chaos-smoke {got['bench']}/{got['prefetcher']}/"
                 f"{got['eviction']}, numpy against K1")
    for name, run, report, wall in (
            ("K1", "chaos_cuda", report_k1, chaos_k1_s),
            ("numpy, 2 workers", "chaos_numpy", report_np, chaos_np_s)):
        print(f"phase 17 {card}: chaos-smoke on {name}, {report['cells']} "
              f"rows equal to the fault-free baseline's after "
              f"{report['faults_fired']} faults, {report['restarts']} driver "
              f"restarts, {report['retries']} cell retries; quarantine "
              f"empty; {wall:.1f} s (the two runs side by side, so neither "
              f"wall is its run's own); launches in its processes "
              f"{run_launches[run]}",
              flush=True)
    learned = ["--benches", "ATAX,BICG,Pathfinder,Hotspot", "--prefetchers",
               "learned", "--prediction-us", "1,2", "--backend", "numpy",
               "--device", "cuda"]

    def learned_pool(name, *argv):
        out = os.path.join(work, name)
        _, wall = run_module(name, "repro_torch.uvm.sweep", *learned,
                             "--out", out, *argv)
        lrows = sweep.read_results(out)
        check(len(lrows) == 8 and all(r["backend"] == "numpy"
                                      and not r["quarantined"]
                                      for r in lrows),
              f"learned pool {name}: {per_backend(lrows)}")
        return lrows, wall

    rows_a, pool_a_s = learned_pool("learned_a", "--workers", "4")
    fitted = [r["bench"] for r in rows_a if "fit_top1" in r]
    check(sorted(fitted) == sorted({r["bench"] for r in rows_a}),
          f"learned pool: fits on {fitted}, not one per trace")
    shutil.copytree(os.path.join(work, "learned_a"),
                    os.path.join(work, "learned_b"))
    rows_b, pool_b_s = learned_pool("learned_b", "--workers", "1",
                                    "--no-resume")
    check(not any("fit_top1" in r or r["train_seconds"] for r in rows_b),
          "learned pool: the rerun on the copied cache trained")
    check(faults.rows_digest(rows_b) == faults.rows_digest(rows_a),
          "learned pool: the rerun's rows differ from the pool's")
    rows_c, pool_c_s = learned_pool("learned_c", "--workers", "1")
    for name in ("learned_a", "learned_c"):
        # the simplified predictor's quantized inference goes through K3,
        # and through K2 on the HLSH benches (Pathfinder, Hotspot)
        check(run_launches[name]["hlsh_attention"] > 0
              and run_launches[name]["int4_matmul"] > 0,
              f"learned pool {name} logged no K2 or K3 launch: "
              f"{run_launches[name]}")
    train_a = sum(r["train_seconds"] for r in rows_a)
    crash_s = time.perf_counter() - t17
    check(read_counts() == dict.fromkeys(counted, 0),
          f"phase 17 launched in this process: {read_counts()}")
    path_launches["crash"] = {
        name: sum(c[name] for c in run_launches.values())
        for name in counted}
    print(f"phase 17 {card}: the learned lease pool, 8 cells on 4 traces "
          f"(ATAX, BICG, Pathfinder, Hotspot x 1, 2 us; replay on numpy, "
          f"predictors on the card): 4 workers {pool_a_s:.1f} s, "
          f"{len(fitted)} fits ({train_a:.2f} s of training in all); the "
          f"rerun on its cache {pool_b_s:.1f} s, no fit, rows equal; 1 "
          f"worker on a fresh cache {pool_c_s:.1f} s (rows equal to the "
          f"pool's: {faults.rows_digest(rows_c) == faults.rows_digest(rows_a)}"
          f"); launches in the pool's processes {run_launches['learned_a']}, "
          f"in the 1-worker run's {run_launches['learned_c']}; the phase's "
          f"launches {path_launches['crash']}; whole phase {crash_s:.1f} s; whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    crash = {"chaos_cuda": report_k1, "chaos_cuda_s": chaos_k1_s,
             "chaos_numpy": report_np, "chaos_numpy_s": chaos_np_s,
             "pool_4_workers_s": pool_a_s, "rerun_s": pool_b_s,
             "pool_1_worker_s": pool_c_s, "pool_train_s": train_a,
             "phase_s": crash_s, "resume_main_s": resume_s,
             "launches_by_run": run_launches}
    # ---- phase 18: the LM serve path -------------------------------------
    lm = lm_phase(card, work, pool, backend, reset_counts, read_counts)
    path_launches["lm_serve"] = lm["serve"]["launches"]
    path_launches["lm_trace_replay"] = lm["trace_replay"]["launches"]
    # every path's launches, phases 16-18 included
    for rec in kernels:
        rec["launches_by_path"] = by_path(rec["name"])
        rec["launches"] = sum(rec["launches_by_path"].values())
        if rec["name"] == "flash_attention":
            rec["variants"] = rec["variants"] + lm["k4"]
    print(f"phase 18: launches by path {path_launches}; whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 20's lowerings run in a process of their own, beside phase 19
    # (host work on fake tensors; the card is not used; phase 19 is device
    # time, while phase 18's host-bound decode would feel the process)
    low_path = os.path.join(work, "lowerings.json")
    lowering = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.lowerings({low_path!r})"],
        cwd=ROOT)
    procs.append(lowering)
    # ---- phase 19: the LM training path ----------------------------------
    lm_train = train_phase(card, work, reset_counts, read_counts)
    path_launches["lm_train"] = {
        name: sum(lm_train[run]["launches"][name]
                  for run in ("a", "b", "int8", "topk"))
        for name in counted}
    for rec in kernels:
        rec["launches_by_path"]["lm_train"] = path_launches["lm_train"][
            rec["name"]]
    print(f"phase 19: launches {path_launches['lm_train']} (training "
          f"attention is the plain version); whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 20: the sharded path --------------------------------------
    lm_mesh = mesh_phase(card, lm, lm_train, lowering, low_path,
                         reset_counts, read_counts)
    path_launches["lm_mesh"] = lm_mesh["train"]["launches"]
    for rec in kernels:
        rec["launches_by_path"]["lm_mesh"] = path_launches["lm_mesh"][
            rec["name"]]
        if rec["name"] == "flash_attention":
            rec["op_dispatch_ms"] = lm_mesh["k4_dispatch"]["dispatch_ms"]
    print(f"phase 20: launches {path_launches['lm_mesh']} (the meshed "
          f"training step's; the lowerings launch nothing); whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fig11_bicg_timeline.csv"),
                  "w") as f:
            f.write(paper_tables.fig11_csv(fig11))
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "rows": rows,
                       "table10": t10, "table11": t11,
                       "oversub_full": mrows, "serve_full": srows,
                       "mt_full": trows, "transformer_smoke": xrows,
                       "family": frows, "family_accuracy": family_cmp,
                       "kernels": kernels, "launches_by_path": path_launches,
                       "main_path_s": main_s, "tables_s": tables_s,
                       "oversub_full_s": matrix_s, "serve_full_s": serve_s,
                       "mt_full_s": mt_s, "transformer_smoke_s": smoke_s,
                       "family_s": family_s, "predictor_tables": ptables,
                       "predictor_table_stats": ptable_stats,
                       "predictor_table_fits": fits,
                       "predictor_tables_s": ptables_s,
                       "fig12": fig12, "headline": headline,
                       "ipc": ipc_rows, "chain_reasons": reasons,
                       "chain_s": chain_s, "throughput": thru,
                       "crash_safety": crash, "lm": lm,
                       "lm_train": lm_train, "lm_mesh": lm_mesh}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
