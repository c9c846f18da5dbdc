#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (one process per source, all at once), holds each kernel against
its plain PyTorch version (bitwise, except random-float ``plus_times``
products, held within their rounding bound, and flash attention, within
2e-5 in float32 and 2e-2 in bf16), times it, and then drives seven paths
over the paper's Table-6 level-L1 log (10^6 cases, ~7x10^6 events, 26
activities, timestamps) written as an EDF file with 524,288-row groups and
streamed from disk onto the card, the query layer, the ``Dataset`` facade,
its sharded engine and the mining service over that file, the EventLM
serving and training paths, the MoE family's serving, the serving of the
four other families and the training of the moe, hybrid, ssm, audio and
vlm families:

* ``main_path`` — the out-of-core DFG.  It must equal, bitwise, the same
  stream through the plain versions on the CPU, the whole-log DFG on the
  card, the literal shift-and-count DFG on the card, and a numpy count made
  straight from the generator's columns.
* ``stats_path`` — the four statistics fused into one pass
  (``stats_kernel``).  Bitwise equal to the CPU plain stream, the whole-log
  result on the card and numpy oracles (``bincount``,
  ``minimum/maximum.reduceat``, ``np.add.at`` in float32).
* ``filter_path`` — the most common activity, the two-pass case filter
  "cases containing it", and the DFG of the kept rows, bitwise equal to a
  numpy oracle.
* ``variants_path`` — per-case variant fingerprints (two polyhash scans a
  chunk).  Bitwise equal to the CPU plain stream, the whole-log
  fingerprints on the card, a *ghost stream* (every other row group
  replaced by one row per case segment carrying the segments' composed
  affine sketch maps, which the kernel folds with the affine scan) and the
  numpy sketches of the whole log; the variant counts equal ``np.unique``
  of those.
* ``performance_path`` — the timed DFG and the eventually-follows graph in
  one pass.  Bitwise equal to the CPU plain stream, the whole-log results
  on the card and numpy oracles (``bincount``, ``np.add.at`` in float32,
  EFG pairs counted by position offset over equal-length cases), plus the
  remaining-time targets against ``np.maximum.reduceat``.
* ``graph_path`` — the timed process graph (``graph_kernel(26,
  timed=True)``, 28 nodes) and its queries on the semiring kernels:
  reachability (full and k = 3) and bottleneck paths over frequency and
  performance weights, each closure one launch of the closure kernel, and
  node centrality's 16 products; and the registered graph verbs
  streamed through ``kernel_spec(...).make``.  Reachability and the
  frequency-weighted paths equal numpy BFS / Floyd–Warshall oracles
  bitwise; the performance-weighted paths equal the CPU plain stream
  bitwise and centrality ``flow`` is within 1e-6 of it.
* ``discovery_path`` — the heuristics miner (``heuristics_kernel(26)``:
  the DFG plus ``a, b, a`` triple counts, two ``pair_count`` launches a
  chunk) and the alpha miner's footprint finalize.  Bitwise equal to the
  CPU plain stream and a numpy triple-count oracle; the log scores 1.0
  alpha fitness against its own model and its heuristics fitness equals a
  numpy oracle.
* ``query_path`` — the pruned query layer (``repro_torch.query``) over
  the L1 file: four plans (a case band the zone maps refute for ten of the
  fourteen row groups, a time range, ``variant_in`` decided from header
  sketches, ``cases_containing`` on the single-pass schedule), each mined
  with the DFG and variants kernels and held bitwise against the port's
  eager filter-then-mine on the card, the plain lowerings on the card and
  numpy oracles, the ghost chunks of skipped groups folded by the affine
  scan (two launches a ghost chunk, the chunks counted where the scan
  builds them); ``merge_tree`` over per-group folds on the card for every
  mergeable verb against ``run_streaming`` on the card (bitwise) and the
  CPU plain stream (centrality flow within 1e-6), its launches counted apart
  (``query_group_states``: eventually-follows must launch the sum scan,
  the graph query verbs a semiring kernel); ``execute_grouped`` twice, the
  second call from the state cache; and a full scan at prefetch depth 0
  and 1 with its read + decode seconds.
* ``dataset_path`` — the ``Dataset`` facade on the card
  (``repro_torch.open(path, device="cuda")``): all sixteen registered verbs
  through ``collect`` under the eager engine (the whole file as one
  7,003,349-row chunk) and the streaming engine (per-group states through
  the state cache), and ``profile()``, each result bitwise equal across
  the engines, to ``run_streaming`` on the card and to the CPU plain
  streams of the earlier phases (centrality ``flow`` within 1e-6); a
  re-collect served from the result memo with zero reads, and a CPU
  dataset on the same file never served the card's result; the dispatch
  sweep (case bands over 1, 2, 4, 7 and 14 groups, both engines timed
  synchronized, median of 3, memo off, state cache cleared before every
  call) with ``fit_calibration`` over it and ``auto``'s regret; windows by
  groups (each the scratch mine of its rows, a second sweep folding
  nothing) and by time (each the same filter collected directly); and an
  append of 524,288 rows of new cases as 8,192-row groups (the re-collect
  folds only those; the file's bytes equal a numpy-only re-run).
* ``distributed_path`` — the sharded engine on the card
  (``repro_torch.open(path).collect(..., engine="sharded", num_shards=n)``
  for n = 1, 2, 4, 8, every shard on the one card): the DFG, discovery /
  alpha / heuristics, the four graph verbs, the merge-tree verbs, variants
  over a pruned case band (ghost rows) and one ``collect_many``, each
  bitwise equal to the streaming engine on the card, the CPU plain streams
  and the numpy oracles, ``pair_count`` / ``histogram`` launched on every
  shard and the variants collect exactly four affine scans and two uint32
  ``segment_reduce`` a shard; the DFG's events/s at each n beside
  streaming, its stage split (gather, padding, copies, shard updates,
  ``psum``, tail fix) and the idle share of one 8-shard collect; and
  ``sort_by_case_sharded`` of L1 scrambled over 8 shards, equal to a numpy
  bucket oracle with no overflow at slack 2.
* ``service_path`` — the mining service on the card: L1's first 3.5 M rows
  (seven partitions; the whole log made the phase ~75 s) cut at case
  boundaries into host batch files, ingested by the ``Ingestor`` with its
  defaults (500,000-row partitions, 8,192-row groups), then ``serve`` on
  127.0.0.1 answering ``/health``, ``/collect`` (dfg, auto and eager; variants),
  ``/profile``, ``/window``, ``/graph?query=reachability`` and
  ``/explain`` over HTTP, each result JSON-equal to the same verb mined
  eagerly on the card from the claimed rows; three ``/collect`` requests
  raced against an ingest thread appending the new cases, each equal to
  the eager mine of the snapshot it claims; and the device idle share of
  one cold ``/collect``.
* ``serve_path`` — ``eventlm-100m`` at full width (12 layers, d_model 768,
  random weights from seed 0) served by ``serve.engine.Engine`` on prompts
  from the tokenized synthetic log, as ``launch/serve.py`` builds them: (a)
  8 requests x 12 tokens x 8 steps and (b) 8 x 1,000 x 16, in float32 and
  in bf16 compute.  Each prefill layer runs the flash-attention kernel
  (12 launches a prefill, none in decode).  Held against the same engine
  and weights with the plain attention (``attn_impl="ref"``): prefill
  logits within 1e-3 (float32) / 5e-2 (bf16); greedy tokens identical in
  float32, and in bf16 wherever the plain run's top-2 logit margin exceeds
  0.1 (a request is compared up to its first such divergence); in bf16
  both grow to 2^-7 of the row's (the step's) largest logit where that is
  more (``SERVE_BF16_REL``).  Then the
  head dims the kernels pad: ``phi3-mini-3.8b`` (head dim 96, 2 of 32
  layers) and ``gemma3-4b`` (256, 6 of 34 layers, so that its first global
  layer runs) at full width, batch (a), in both dtypes under the same
  gates; and ``attn_p_dtype="bfloat16"`` on phi3-mini: one float32 prefill
  through the kernel, and its first layer's attention held against the
  plain chunked attention with the same ``p_dtype`` (``P_DTYPE_UNIT``).
* ``moe_path`` — the MoE family at full width with depth cut
  (``MOE_RUNS``): ``qwen3-moe-30b-a3b`` (4 of 48 layers, 128 experts top-8,
  batches (a) and (b)) and ``mixtral-8x7b`` (2 of 32 layers, 8 experts
  top-2, window 4,096, batch (a)), random weights from seed 0, served by
  the engine in float32 and bf16 under ``serve_path``'s gates (the kernel
  4 / 2 times a prefill, never in decode), with peak memory, prefill and
  decode tokens/s and one decode step's idle share.  Layer 0's MoE in
  float32 at (b)'s prefill shape (qwen3; (a)'s for mixtral) on the card
  against the CPU: routes identical wherever the k-th logit leads the
  (k+1)-th by more than the float32 error bound of both sides, outputs of
  tokens routed and kept alike within ``MOE_LAYER_ATOL``; and
  ``moe_apply_ep`` on meshes of 1, 2, 4 and 8 shards of the card against
  the dense dispatch (``MOE_EP_ATOL``).
* ``families_path`` — the other four families at full width
  (``FAMILY_RUNS``), random weights from seed 0 and stub frontends
  (``(B, enc_seq | num_patches, d_model)`` normals x 0.1 from a seeded
  generator): ``zamba2-7b`` (13 of 81 layers: two groups of 6 and one tail
  layer; batches (a) and (b)), ``xlstm-1.3b`` (16 of 48: two groups of 7
  mLSTM + 1 sLSTM; (a) and (b)), ``whisper-medium`` (24 + 24 layers, 1,500
  frames; (a)) and ``internvl2-2b`` (24 layers, 256 patches; (a)), each
  served by the engine in float32 and bf16 under ``serve_path``'s gates
  (gate 1; vacuous for the xLSTM, which runs no attention), with each
  family's launch counts exact (gate 4, ``expected_launches``: hybrid one
  a group a prefill, ssm none, audio 24 + 24 + 24 a prefill and 24 a
  decode step (cross attention), vlm one a layer a prefill).  Gate 2:
  prefill and 4 decode steps fed the true next tokens, with the model's
  bf16 K / V cache, against ``forward`` at the same positions, within
  ``FAMILY_CACHE_RTOL`` x max(1, std) in float32 and ``FAMILY_CACHE_BF16``
  times the bf16 forward's own distance from the float32 one (plus the
  float32 bound) in bf16.  internvl2-2b serves with ``max_len`` grown by
  its 256 patch positions.  Gate 3: layer 0's mixers (``mamba2_apply``,
  ``mlstm_apply``, ``slstm_apply`` with their states, then one
  ``*_step``) on the card against the CPU in float32 on ``MIXER_TOKENS``,
  within ``MIXER_RTOL`` of each output's largest magnitude.  The kernel
  against its plain version at each family's attention shapes
  (``FAMILY_FLASH_SHAPES``, ``check_flash_shapes``).
* ``train_path`` — ``eventlm-100m`` at full width trained by
  ``train.trainstep`` on batches from ``launch.train.make_data`` with the
  launcher's ``OptConfig``: (a) 8 x 128 for 20 steps and (b) 8 x 1,024 for
  10, each in bf16 and in float32 compute.  Under ``remat_policy="full"``
  a step launches the flash-attention forward kernel exactly 24 times (the
  forward pass and the recompute) and the backward kernel exactly 12.
  Gates: every loss finite and the mean of the last 5 below the first 5's;
  step 0's loss and every parameter's gradient against the same model and
  batch with ``attn_impl="ref"`` (``TRAIN_LOSS_ATOL``,
  ``TRAIN_GRAD_RTOL``); ``adamw_update`` on the card against the CPU from
  the same gradients within ``ADAMW_ULPS``; a checkpoint saved, restored
  and resumed giving the same next step; TF32 off.  It reports tokens/s,
  a synchronized step's forward / backward / optimizer milliseconds, peak
  memory and a step's idle share.
* ``family_train_path`` — the moe, hybrid, ssm, audio and vlm families
  trained at full width with depth cut (``FAMILY_TRAIN_RUNS``: qwen3-moe 2
  of 48 layers, mixtral 1 of 32, zamba2 13 of 81, xlstm 16 of 48, whisper
  24 + 24 and internvl2 24), random weights from seed 0, stub frontends as
  in ``families_path``, 10 steps at batch (a) (8 x 128 tokens from
  ``launch.train.make_data``) with the launcher's ``OptConfig``, in bf16
  and float32 compute under remat "full".  Gates: (1) step 0's loss and
  every parameter's gradient against the same model, batch and MoE routes
  with ``attn_impl="ref"`` (``TRAIN_LOSS_ATOL`` / ``TRAIN_GRAD_RTOL``; the
  reference run takes the kernel run's expert ids, ``recorded_routes``, and
  the tokens whose own top k differs are counted); (2) layer 0's mixers or
  MoE in float32 under autograd, card against CPU, and ``moe_apply_ep`` at
  1 / 2 / 4 / 8 shards against the dense dispatch (``mixer_check``);
  (3) every loss and grad norm finite, the mean of the last 5 losses below
  the first 5's; (4) launches exact each step: the forward kernel twice an
  attention call and the backward kernel once; (5) a second backward on
  step 0's batch bitwise the first; (6) TF32 off.  It reports tokens/s, a
  synchronized step's forward / backward / optimizer ms, peak memory, a
  step's idle share and the phase's seconds.
* ``launch_path`` — the launch tooling (``repro_torch.launch``): (a) the
  dry run of every single-pod cell, ``python -m repro_torch.launch.dryrun
  --all`` on the (32, 8) mesh in a child process with no card visible,
  started before ``serve_path`` so that it runs beside the model phases,
  each cell's fit against 80 GB, bottleneck, three roofline terms and
  seconds (``LAUNCH_SWEEP_BUDGET_S``); any ``ok: false`` fails the phase.
  (b) The accounting held against real steps on the card, on a 1 x 1 mesh
  (``LAUNCH_CHECKS``: ``eventlm-100m`` batch (a) in bf16 and float32, and
  ``qwen3-moe-30b-a3b`` at 2 of 48 layers, ``family_train_path``'s cut, for
  the MoE dispatch): the dry run's argument bytes equal the parameters',
  AdamW state's and batch's ``nbytes`` exactly; its dot FLOPs equal
  ``FlopCounterMode`` of the real step, whose flash-attention custom ops
  count the kernels' formula times their launches (checked apart); its
  peak within ``LAUNCH_PEAK_RTOL`` of the step's ``max_memory_allocated``
  (less the memory held before the step that is not the step's).  (c)
  ``mfu`` of each step: the roofline's model FLOPs over (measured step
  seconds x the peak of its dtype), beside the ``nvidia-smi`` line.  (d)
  ``examples/dashboard_torch.py`` on the card, its panels' answers equal to
  a CPU run's.  It also times the flash-attention custom op's dispatch
  against the bare launch function (host microseconds a call).

The flash-attention check also holds the backward: the forward's
log-sum-exp against ``flash_attention_lse_ref`` (``FLASH_LSE_ATOL``), the
backward kernel's (dq, dk, dv) against ``flash_attention_bwd_ref`` on the
same inputs (``FLASH_BWD_RTOL`` and ``FLASH_BWD_MAG``: a relative term
and one over the magnitude products of the gradients), a second call
bitwise equal to the first, and ``FlashAttention.apply``'s
gradients against autograd through ``flash_attention_ref``
(``FLASH_GRAD_RTOL``), at ``FLASH_SHAPES``, on (B, S, H, D) views at
every head dim, and at the (B, S, H, D) views ``train_path`` gives it
(``TRAIN_RUNS``' batch and sequence lengths) and at the calls
``family_train_path`` makes (``FAMILY_TRAIN_SHAPES``), in float32 and bf16.

Each path's launch counts are set to 0 just before it runs and read just
after, and must show its kernels.

``python3 chip_smoke.py --counting`` builds only the two counting kernels,
prints their times (``time_counting``: the int32 yardstick rows, the DFG
update's own calls with a bool mask and ``into``, one whole update) and
stops, without the ``ok`` line.  ``python3 chip_smoke.py --semiring`` builds
only ``semiring``, holds the product and closure kernels against their
plain versions (``check_semiring``), times the products, the closures at
N = 28 (the L1 graph, from numpy) and the JAX graph benchmark's 48 and 128,
the closure kernel against the loop of products up to its capacity, and
the L1 graph's five queries (``time_semiring_kernels``), and stops, without
the ``ok`` line.  ``python3 chip_smoke.py --train`` builds only the two
flash-attention sources, runs ``train_path`` and stops, without the ``ok``
line; ``--flash`` builds the same two, holds both kernels against their
plain versions (``check_flash``, ``check_flash_bwd``), times them
(``time_flash_attention``) and stops, without the ``ok`` line; ``--serve``
builds the same two, runs ``serve_path`` and ``moe_path`` and stops,
without the ``ok`` line; ``--families`` builds the same two, runs
``families_path`` and stops, without the ``ok`` line; ``--train-families``
builds the same two, holds both at ``FAMILY_TRAIN_SHAPES``, runs
``family_train_path`` and stops, without the ``ok`` line; ``--launch``
builds the same two, runs ``launch_path`` and stops, without the ``ok``
line.  A copy of this
script placed at the root of another checkout (a
parent commit unpacked with ``git archive``) times that checkout's kernels
with the same code.

Every line of standard output is one JSON object; the last one is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed.  The script exits non-zero, before any work, when no CUDA device is
visible, and it imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NUM_ACTIVITIES = 26
ROW_GROUP_ROWS = 524_288
SEED = 1
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the non-tensor-core
# 32-bit rate (the counting kernels do one integer add per event)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# SIMT issue on the whole card, in slots of a 32-bit float add / multiply /
# multiply-add, 128 results a clock an SM (CUDA C++ Programming Guide, the
# throughput table of native arithmetic instructions, compute capability
# 9.0) x 132 SMs x 1.98 GHz: the rate at which 67e12 counts an FFMA as two
# operations. The same table gives compare / minimum / maximum and 32-bit
# bitwise AND / OR 64 results a clock an SM, two slots each. So a semiring
# candidate costs: plus_times one FFMA (1 slot), min_plus an FADD and an
# FMNMX (1 + 2), max_min two FMNMX (2 + 2).
SIMT_SLOTS_PER_S = SCALAR_OPS_PER_S / 2
CANDIDATE_SLOTS = {"plus_times": 1, "min_plus": 3, "max_min": 4}
OR_SLOTS = 2
# the same data sheet: dense bf16 and TF32 tensor-core rates (attention's
# products; the float32 route runs each as three TF32 products)
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12
# dependent float32 adds issue one per 4 cycles on an SM (the fold's chain)
ADD_CYCLES = 4
NUM_CASES = 1_000_000
PAIR_COUNT_TPU = "src/repro/kernels/segment_ops/pair_count.py:74"
HISTOGRAM_TPU = "src/repro/kernels/segment_ops/histogram.py:56"
SEGMENT_REDUCE_TPU = "src/repro/kernels/segment_ops/segment_reduce.py:92"
# the segment_reduce routes the mining paths take, timed at chunk shape
SEGMENT_REDUCE_ROUTES = ("sum_int32", "min_float32", "max_float32", "max_bool",
                         "max_uint32")
SCAN_TPU = "src/repro/kernels/segment_ops/segmented_scan.py:"
POLYHASH_TPU, AFFINE_TPU, SUM_SCAN_TPU = (SCAN_TPU + "135", SCAN_TPU + "172",
                                          SCAN_TPU + "213")
SEMIRING_TPU = "src/repro/kernels/graph_ops/semiring.py:103"
# no Pallas kernel: the JAX package's closure loops over semiring_matmul_pallas
CLOSURE_TPU = ("none: the closure loops over semiring_matmul_pallas, "
               "src/repro/kernels/graph_ops/ops.py:78-124")
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:121"
# no Pallas kernel: JAX trains through attention_chunked and XLA
# differentiates its lax.scan
FLASH_BWD_TPU = ("none: XLA's VJP of attention_chunked's lax.scan, "
                 "src/repro/models/attention.py:53-114")
# no Pallas kernel: the JAX package's row-order XLA scatter
ORDERED_FOLD_TPU = "none: XLA scatter, src/repro/kernels/segment_ops/ref.py:58"
KERNELS = ("pair_count", "histogram", "segment_reduce", "ordered_histogram",
           "segmented_polyhash", "segmented_affine", "segmented_sum_scan",
           "semiring_matmul", "semiring_closure", "flash_attention",
           "flash_attention_bwd")
SEMIRINGS = ("plus_times", "min_plus", "max_min")
# the closures: the L1 graph's 28 nodes, the JAX graph benchmark's sweep
# (benchmarks/bench_graph.py:93, density 0.25), and more sizes up to the
# closure kernel's capacity to place the crossover with the loop
CLOSURE_SIZES = (28, 48, 128)
CLOSURE_SWEEP = (28, 48, 64, 80, 96, 112, 128, 168)
# (kind, k) of the closures the graph queries run: reachability's k = N - 1
# and k = 3, the full boolean closure, shortest and widest paths
CLOSURE_CASES = (("bool", None), ("bool", 3), ("min_plus", None), ("max_min", None))
# (M, K, N) of the semiring sweep: centrality's matvec and a squaring of
# the 28-node L1 graph, ragged tiles, and the 384-node graph of the JAX
# package's graph benchmark
SEMIRING_SHAPES = ((1, 28, 28), (28, 28, 28), (17, 9, 23), (130, 7, 131),
                   (384, 384, 384))
# (B, H, KVH, Sq, Sk, D, causal, window) of the flash-attention check: the
# JAX kernel tests' shapes (tests/test_kernels.py:44-50, kv_len = Sk - 17
# past 64 keys), GQA over ragged keys at D = 16 and 128, the serving
# path's two prefills, the head dims between instantiations (96, 112:
# phi3-mini, zamba2) and at 256 (gemma3-4b) over ragged rows, and Whisper's
# non-causal shapes: cross attention of 12 and 1 queries over 1,500 frames,
# and the encoder's 1,500 x 1,500
FLASH_SHAPES = ((1, 4, 2, 128, 128, 64, True, None), (2, 8, 2, 256, 256, 64, True, 512),
                (1, 4, 4, 200, 200, 32, True, None), (1, 4, 1, 1, 384, 64, False, None),
                (1, 2, 2, 96, 96, 128, True, 32), (2, 4, 2, 64, 64, 16, False, None),
                (1, 4, 2, 200, 200, 16, True, None), (2, 6, 2, 130, 130, 128, True, 48),
                (8, 12, 12, 12, 12, 64, True, None),
                (8, 12, 12, 1_000, 1_000, 64, True, None),
                (1, 4, 2, 200, 200, 96, True, None), (2, 4, 4, 130, 130, 112, True, 48),
                (1, 4, 2, 150, 150, 256, True, None), (1, 2, 1, 77, 77, 256, False, 40),
                (1, 2, 2, 70, 70, 8, True, None), (1, 2, 2, 70, 70, 136, True, None),
                (2, 16, 16, 12, 1_500, 64, False, None), (2, 16, 16, 1, 1_500, 64, False, None),
                (2, 16, 16, 1_500, 1_500, 64, False, None))
# the head dims every view check runs: the instantiations and d between them
FLASH_HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)
# attn_p_dtype: P rounded to a 16-bit type before P.V.  The kernel rounds
# exp(s - running max), the plain version exp(s - max): each rounding moves
# a weight by at most u of itself (u = 2^-8 bf16, 2^-11 float16: 8 and 11
# significant bits), so an output by u max|v| on either side; the gate
# against the plain version with the same p_dtype is 2 u max|v| plus the
# float32 route's own FLASH_ATOL.  In the backward only dV = P^T dO sees the
# rounding: the float32 bound's magnitude term gains 2 u.
P_DTYPE_UNIT = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX kernel tests' bounds
# bf16, besides FLASH_ATOL, a bound scaled to each output's magnitude: the
# kernel rounds P = exp(s - running max) to bf16 before P.V, each weight
# within 2^-9 of itself, which moves an output by at most 2^-9 of its
# magnitude product P.|V| (P the plain softmax), and the row sum's share
# by as much again; each side then rounds its output to bf16, half an ulp
# each.  So |got - want| <= 2^-8 P.|V| + 2^-7 |want| (2^-7 |want| is at
# least one bf16 ulp of want).  Over 1,500 keys a typical output is ~0.04
# and P.|V| ~0.8: the bound is ~3e-3 where FLASH_ATOL allows 2e-2.
FLASH_BF16_MAG = 2.0 ** -8
FLASH_BF16_REL = 2.0 ** -7
FLASH_TIMED = (8, 12, 1_024, 64)                     # (B, H, S, D), causal
# (label, B, H, KVH, S, D) of the head-dim rows: phi3-mini-3.8b's and
# gemma3-4b's prefill at batch (b), rounded up to whole tiles, causal
FLASH_TIMED_HEAD_DIMS = (("d96", 8, 32, 32, 1_024, 96), ("d256", 8, 8, 4, 1_024, 256))
# (label, B, H, KVH, Sq, Sk, D) of whisper-medium's non-causal rows at
# batch (a): the encoder, the prefill's cross attention and a decode
# step's
FLASH_TIMED_WHISPER = (("whisper_enc", 8, 16, 16, 1_500, 1_500, 64),
                       ("whisper_cross", 8, 16, 16, 12, 1_500, 64),
                       ("whisper_cross_decode", 8, 16, 16, 1, 1_500, 64))
# the backward's tolerances.  The forward's log-sum-exp: within 2e-5 of the
# plain one (3xTF32 / bf16-exact scores summed in another order).  The
# kernel's gradients against the plain backward on the same inputs, each
# |got - want| <= rtol (1 + |want|) + c A, A the float32 magnitude product
# of the gradient's terms (flash_attention_bwd_magnitudes: |P|^T |dO| for
# dv, D^-1/2 |dS|^T |Q| for dk, D^-1/2 |dS| |K| for dq).  bf16: the kernel
# rounds P and dS to bf16 (8 significant bits: each within 2^-8 of itself)
# before the three gradient products, which moves a gradient by at most
# 2^-8 A; c = 2 covers that with the tensor cores' float32 sums, and the
# outputs' own bf16 roundings, one bf16 ulp apart, 2^-7 (1 + |want|).
# float32: every product 3xTF32, within 2^-20 of its magnitude product, S
# and dP carrying theirs into P and dS: 1e-5 (1 + |want|) + 2^-19 A, with A
# taken with dp_error (flash_attention_bwd_magnitudes): dS = P (dP - Delta)
# cancels, so dP's and Delta's errors, fractions of |dO| |V|^T and
# sum |dO| |o|, reach dQ and dK through P times those, not through |dS|.
# Stated after the family shapes' first run failed without it: at (8, 32,
# 4, 128, 128, 128) and (8, 16, 16, 128, 128, 64), causal, the kernel was
# 1.21 and 1.015 x the bound without it (rel err 1.35e-5, 1.02e-5: a
# causal row's first key has dS = 0 exactly, so its A_dq was 0 and only
# 1e-5 (1 + |want|) held it); the plain float32 backward alone is 0.25 x
# that old bound on the CPU at the first shape.
# FlashAttention.apply against autograd through the plain forward: the
# forward's own error enters through Delta = dO . o (float32 3xTF32 within
# 2^-20; bf16 P within 2^-8).
FLASH_LSE_ATOL = 2e-5
FLASH_BWD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
FLASH_BWD_MAG = {"float32": 2.0 ** -19, "bfloat16": 2 * 2.0 ** -8}
FLASH_GRAD_RTOL = {"float32": 5e-5, "bfloat16": 3e-2}
TRAIN_ARCH = "eventlm-100m"
# (label, batch, seq, steps): (a) the launcher's defaults, (b) the shape at
# which the forward kernel is timed (FLASH_TIMED)
TRAIN_RUNS = (("a", 8, 128, 20), ("b", 8, 1_024, 10))
# step 0 against attn_impl="ref": the loss, and each parameter's gradient as
# ||g - g_ref|| / ||g_ref||; bf16 compute rounds every product's inputs, and
# the kernel rounds P to bf16 where the plain attention does not
TRAIN_LOSS_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
TRAIN_GRAD_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}
# adamw_update on the card against the CPU from the same gradients: the
# global norm's sums run in another order and cos / pow may differ by an
# ulp, so each element of params, m and v is held within 16 float32 ulps of
# the largest magnitude among its operands (a parameter: its value before
# the updates and after them; an update can cancel a parameter to near 0,
# where ulps of the result alone measure nothing)
ADAMW_ULPS = 16
# the next step after a checkpoint round trip: the loss bitwise; the
# parameters within 1e-6 (the embedding gradient's scatter-add may sum its
# rows in another order on the card)
RESUME_ATOL = 1e-6
SERVE_ARCH = "eventlm-100m"
# (label, requests, prompt length, stride between prompts in the token
# stream, steps, max_len): (a) the defaults of launch/serve.py, (b) long
# prompts, ragged against the kernel's 64-row tiles
SERVE_BATCHES = (("a", 8, 12, 37, 8, 64), ("b", 8, 1_000, 1_000, 16, 1_024))
SERVE_LOGIT_ATOL = {"float32": 1e-3, "bfloat16": 5e-2}
SERVE_MARGIN = 0.1
# In bf16 the final hidden state keeps 8 significant bits, so each logit (a
# dot product of it with one vocabulary row) can move by 2^-8 of the row's
# magnitude product, which the row's largest logit approaches: a row's
# logits are held within the larger of SERVE_LOGIT_ATOL and
# SERVE_BF16_REL times its largest plain logit (two bf16 roundings), and a
# step's margin gate is the larger of SERVE_MARGIN and SERVE_BF16_REL
# times its top logit.  eventlm-100m's logits (|l| < 4) keep 5e-2 and 0.1;
# gemma3-4b ties its embedding (init scale 1.0), so a row's largest logit,
# the input token's own, is ~2,250 and its gate ~18.
SERVE_BF16_REL = 2.0 ** -7
# (arch, layers) served at full width beside eventlm-100m, batch (a): head
# dim 96 (phi3-mini-3.8b, 2 of 32 layers) runs on the 128 instantiation,
# 256 (gemma3-4b, 6 of 34 layers: five local layers and its first global
# one) on the 256 one; attn_p_dtype="bfloat16" goes through the first
P_DTYPE_ARCH = "phi3-mini-3.8b"
HEAD_DIM_ARCHS = ((P_DTYPE_ARCH, 2), ("gemma3-4b", 6))
# (arch, layers, batches) of moe_path, at full width with depth cut: qwen3
# 4 of 48 layers (3.12 B float32 parameters, 12.5 GB; all 48 would be
# 122 GB), mixtral 2 of 32 (3.17 B, 12.7 GB), batch (a) only
MOE_RUNS = (("qwen3-moe-30b-a3b", 4, SERVE_BATCHES), ("mixtral-8x7b", 2, SERVE_BATCHES[:1]))
MOE_EP_SHARDS = (1, 2, 4, 8)
# one MoE layer on the card against the CPU (float32): the router's logits
# are depth-D float32 dot products on either side, each within D 2^-24 of
# its magnitude product max_e sum_d |x_d| |w_de| (the standard worst case of
# a depth-D float32 dot product), so the chosen experts must agree wherever
# the k-th logit exceeds the (k+1)-th by more than twice that; outputs of
# tokens routed and kept alike on both sides within MOE_LAYER_ATOL
# (products of depth 2,048 and 768 summed in other orders).  Expert
# parallelism against the dense dispatch on the same card: the same routes
# and slots, the partials summed over shards: MOE_EP_ATOL.
MOE_LAYER_ATOL = 1e-4
MOE_EP_ATOL = 1e-4
# (arch, layers, batches) of families_path, full width with depth cut:
# zamba2 13 of 81 layers (two groups of 6 and one tail layer; 1.45 B
# float32 parameters), xlstm 16 of 48 (two groups of 7 mLSTM + 1 sLSTM;
# 1.34 B), whisper all 24 + 24 (1.01 B) and internvl2 all 24 (1.89 B)
FAMILY_RUNS = (("zamba2-7b", 13, SERVE_BATCHES), ("xlstm-1.3b", 16, SERVE_BATCHES),
               ("whisper-medium", 24, SERVE_BATCHES[:1]),
               ("internvl2-2b", 24, SERVE_BATCHES[:1]))
FRONTEND_SCALE = 0.1           # stub frontends: normals x 0.1, tests/test_models.py's
# gate 2: prefill + FAMILY_STEPS decode steps fed the true next tokens
# against forward at the same positions, with the model's bf16 K / V cache
# holding every position.
# float32: within FAMILY_CACHE_RTOL x max(1, std(logits)), the JAX
# package's own cache check (tests/test_models.py).  bf16: both sides round
# at different points, each some distance E from the float32 forward; the
# triangle inequality bounds their gap by 2 E, and FAMILY_CACHE_BF16 = 3
# leaves room for the decode path's own error to be half again the
# forward's: within 3 E + the float32 bound, E the bf16 forward's largest
# distance from the float32 one over the compared positions.
FAMILY_STEPS = 4
FAMILY_CACHE_RTOL = 3e-3
FAMILY_CACHE_BF16 = 3.0
# gate 3: one mixer on the card against the CPU, float32, on (2, 300)
# tokens (three 128-token chunks, the last padded): each output and state
# within MIXER_RTOL of its largest magnitude (products of depth up to
# 7,168 summed in other orders, each within ~depth 2^-24 of its magnitude)
MIXER_TOKENS = (2, 300)
MIXER_RTOL = 1e-4
# FLASH_SHAPES' tuples at each family's own batch (a) and (b) shapes, held
# against the plain version by check_flash_shapes before the models run:
# zamba2's shared attention (a) and (b), whisper's encoder and cross
# attention (prefill and decode), internvl2's prefill over 256 patches +
# 12 tokens
FAMILY_FLASH_SHAPES = ((8, 32, 32, 12, 12, 112, True, None),
                       (8, 32, 32, 1_000, 1_000, 112, True, None),
                       (8, 16, 16, 1_500, 1_500, 64, False, None),
                       (8, 16, 16, 12, 1_500, 64, False, None),
                       (8, 16, 16, 1, 1_500, 64, False, None),
                       (8, 16, 8, 268, 268, 128, True, None))
# (arch, layers) of family_train_path, full width with depth cut: qwen3 2
# of 48 layers, mixtral 1 of 32, zamba2 13 of 81 (two groups of 6 and one
# tail layer, as served), xlstm 16 of 48 (two groups), whisper 24 + 24 and
# internvl2 24, uncut; each trained FAMILY_TRAIN_STEPS steps at batch (a),
# FAMILY_TRAIN_BATCH, in bf16 and float32 compute under remat "full"
FAMILY_TRAIN_RUNS = (("qwen3-moe-30b-a3b", 2), ("mixtral-8x7b", 1), ("zamba2-7b", 13),
                     ("xlstm-1.3b", 16), ("whisper-medium", 24), ("internvl2-2b", 24))
FAMILY_TRAIN_BATCH = (8, 128)
FAMILY_TRAIN_STEPS = 10
# (B, H, KVH, Sq, Sk, D, causal, window) of the attention calls those runs
# make: qwen3, mixtral (window 4,096), zamba2's shared attention (d 112 on
# the 128 instantiation), whisper's encoder (1,500 frames, a ragged last
# tile of 28 keys), decoder self attention and cross attention, internvl2
# over 256 patches + 128 tokens; check_flash_shapes (forward) and
# check_flash_bwd_shapes hold both kernels at them, in both dtypes
FAMILY_TRAIN_SHAPES = ((8, 32, 4, 128, 128, 128, True, None),
                       (8, 32, 8, 128, 128, 128, True, 4_096),
                       (8, 32, 32, 128, 128, 112, True, None),
                       (8, 16, 16, 1_500, 1_500, 64, False, None),
                       (8, 16, 16, 128, 128, 64, True, None),
                       (8, 16, 16, 128, 1_500, 64, False, None),
                       (8, 16, 8, 384, 384, 128, True, None))
# (label, B, H, KVH, Sq, Sk, D, causal) of the backward rows timed at
# family_train_path's shapes: 9b.112 (zamba2), 9b.128 (qwen3) and 9b.x
# (whisper's encoder and cross attention)
FLASH_TIMED_TRAIN = (("d112", 8, 32, 32, 128, 128, 112, True),
                     ("d128", 8, 32, 4, 128, 128, 128, True),
                     ("whisper_enc", 8, 16, 16, 1_500, 1_500, 64, False),
                     ("whisper_cross", 8, 16, 16, 128, 1_500, 64, False))
# gate 2 of family_train_path: layer 0's mixers and MoE in float32 under
# autograd on MIXER_TOKENS, the card against the CPU.  Outputs within
# MIXER_RTOL of their largest magnitude, as in families_path; each input's
# and parameter's gradient within MIXER_GRAD_RTOL of its largest magnitude:
# a gradient chains two products summed in other orders, the backward of
# the mixer's projections (depth up to 7,168, zamba2's d_inner) and the sum
# over the 600 tokens, each within depth x 2^-24 of its magnitude product
# in the worst case: (7,168 + 600) 2^-24 ~ 4.6e-4 < 1e-3.  The MoE runs the
# card's routes on both sides (recorded_routes): the CPU's own routes may
# differ at near ties, which moe_layer_check's forward gate already
# covers.  Expert parallelism: each gradient within MOE_EP_ATOL x max(1,
# its largest magnitude) of the dense dispatch's on the card.
MIXER_GRAD_RTOL = 1e-3
# launch_path: the dry run's sweep in a child process (cells at once), its
# budget, the accounting's checks against real steps (arch, layers or None,
# batch, sequence, compute dtypes) and the peak's stated tolerance
LAUNCH_JOBS = 4
LAUNCH_SWEEP_BUDGET_S = 150.0
LAUNCH_CHECKS = (("eventlm-100m", None, 8, 128, ("bfloat16", "float32")),
                 ("qwen3-moe-30b-a3b", 2, 8, 128, ("bfloat16",)))
LAUNCH_PEAK_RTOL = 0.10
LAUNCH_TIMED_STEPS = 5
DISPATCH_CALLS = 2_000
SWEEP_GROUPS = (1, 2, 4, 7, 14)      # row groups each dispatch-sweep band covers
SWEEP_REPEATS = 3
APPEND_ROWS = 524_288                # new cases appended after L1's tail
APPEND_GROUP_ROWS = 8_192
SERVICE_BATCH_ROWS = 100_000         # L1 cut into host batch files of ~this size
SERVICE_ROWS = 3_500_000             # the service ingests L1's first ~7 partitions
RACE_BATCHES = 4                     # the appended cases, ingested while serving
SERVICE_ROUTES = (("health", "/health"), ("collect_dfg", "/collect?verb=dfg"),
                  ("collect_dfg_eager", "/collect?verb=dfg&engine=eager"),
                  ("collect_variants", "/collect?verb=variants"),
                  ("profile", "/profile"),
                  ("window", "/window?verb=dfg&by=groups&size=8&step=4"),
                  ("graph", "/graph?query=reachability"), ("explain", "/explain"))


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return float(out.split()[0])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: int, ops: float, ops_per_s: float = SCALAR_OPS_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def time_ms(torch, fn, n_inputs: int, iters: int = 200) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` launches (CUDA events),
    cycling through ``n_inputs`` input sets, after a warm-up."""
    for i in range(min(n_inputs, 5)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 5) -> float:
    """Mean host wall time of ``fn()`` (for plain versions that run on the
    CPU), after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def wrappers() -> dict:
    """Each kernel's wrapper, the function that counts its launches."""
    from repro_torch.kernels import flash_attention, graph_ops, segment_ops

    home = {"semiring_matmul": graph_ops, "semiring_closure": graph_ops,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention}
    return {name: getattr(home.get(name, segment_ops), name + "_cuda")
            for name in KERNELS}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def host_s(torch, fn) -> float:
    """Host wall seconds of one synchronized call of ``fn``."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_device(torch, fn) -> dict:
    """Device-side activity of ``fn`` from a ``torch.profiler`` trace:
    ``{name: (count, device microseconds)}`` over kernels, copies and
    fills only (host-side operators, which also carry their kernels'
    device time, are left out so nothing is counted twice; so are the
    program's spans, ``repro_torch.*``, which the profiler also draws on the
    device's timeline around the kernels they launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith(trace.PREFIX):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        rows[e.key] = (e.count, t)
    return rows


def graph_ms(torch, fn, launches: int, replays: int = 50, stream=None) -> float:
    """Device time per call with the host's per-call cost out of the way:
    ``fn``'s ``launches`` calls are captured once into a CUDA graph and the
    graph is replayed (each call's output allocation and zero-fill included).
    ``stream``: run and capture on it (an autograd backward runs on its
    forward's stream, so its capture stream must be that one)."""
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / launches


def recorder(torch, out: dict):
    """``record(name, got, want, what)``: hold a kernel's result against its
    plain version, raw with ``torch.equal`` (equal infinities are equal, a
    NaN is not; ``equal_nan=True`` compares NaN positions instead), and keep
    the largest error where both sides are finite in ``out[name]``."""
    def record(name, got, want, what, equal_nan=False):
        got, want = got.cpu(), want.cpu()
        diff = (got.double() - want.double()).abs()
        if got.is_floating_point() and want.is_floating_point():
            diff = diff[torch.isfinite(got) & torch.isfinite(want)]
        err = float(diff.max()) if diff.numel() else 0.0
        out[name]["cases"] += 1
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        same = got.dtype == want.dtype and torch.equal(got, want)
        if equal_nan and not same and got.dtype == want.dtype:
            nan = torch.isnan(got)
            same = (torch.equal(nan, torch.isnan(want))
                    and torch.equal(got[~nan], want[~nan]))
        if not same:
            raise AssertionError(f"{name} kernel != plain version at {what}: "
                                 f"max abs err {err}")
    return record


def check_kernels(torch, so) -> dict:
    """Each kernel against its plain version, bitwise, over the shape sweep.

    Counting kernels: ids include -1 and >= the bound, weights 0/1, signed
    and bool, ``into`` absent and given, columns aligned and sliced one row
    in; output and partials blocks filled with 0x5A first, so a bin the
    kernels leave unwritten shows; sizes 242 and 300 (and 242^2 bins) take
    the global-atomic branch.  ``segment_reduce``: sorted ids with leading
    -1s, skipped ids and ids >= S, int32 / float32 / bool / uint32 values,
    sum / min / max, up to a 524,288-row chunk into 10^6 segments, one run
    over a whole chunk (a fill stripe on both sides), and runs of up to 127
    rows that skip up to 40 ids each; every output block was filled with
    0x5A first, so a slot the kernel leaves unwritten shows.  The row-order
    float fold (and a float32 segment sum) is held against the plain
    version on CPU copies of the inputs: CUDA ``index_add_`` adds in no
    fixed order, so the card has no plain row-order fold.  The segmented
    scans: see ``check_scans``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def ids(n, hi):
        return torch.randint(-1, hi + 2, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def weights(n, kind):
        lo, hi = (0, 2) if kind == "mask" else (-3, 4)
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def fweights(n):
        mag = 10.0 ** torch.randint(-3, 5, (n,), generator=gen, device=dev)
        return (torch.randn(n, generator=gen, device=dev) * mag).float()

    def sorted_ids(n, s, single_run=False):
        if single_run == "gaps":
            step = torch.randint(0, 128, (n,), generator=gen, device=dev) == 0
            skip = torch.randint(1, 42, (n,), generator=gen, device=dev)
            return (1_000 + torch.cumsum(step * skip, 0)).to(torch.int32)
        if single_run:
            return torch.full((n,), s // 2, dtype=torch.int32, device=dev)
        p = min(1.0, (s + 3) / max(n, 1))
        step = (torch.rand(n, generator=gen, device=dev) < p).to(torch.int32)
        step[torch.rand(n, generator=gen, device=dev) < 0.01] = 3
        return (torch.cumsum(step, 0) - 2).to(torch.int32)

    sizes_e = (0, 1, 511, 524_288, 7_000_000)
    out = {name: {"cases": 0, "max_abs_err": 0.0} for name in KERNELS}
    record = recorder(torch, out)

    from repro_torch.kernels.segment_ops import counting

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def count_inputs(e, ids_hi, shape):
        # 0/1, signed and bool weights; into absent and given; every column
        # sliced one row in (off a 16-byte boundary) or not
        for kind in ("mask", "signed", "bool"):
            for with_into in (False, True):
                for offset in (0, 1):
                    cols = [ids(e + offset, hi)[offset:] for hi in ids_hi]
                    w = (torch.rand(e + offset, generator=gen, device=dev) < 0.6
                         if kind == "bool" else weights(e + offset, kind))[offset:]
                    into = (torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                          device=dev, dtype=torch.int32)
                            if with_into else None)
                    yield f"w={kind} into={with_into} offset={offset}", cols, w, into

    def poison_counting(nbins, tensors):
        # freed blocks of the output's and the partials' sizes, held at
        # once and filled with 0x5A, which the allocator hands to the call
        sizes = [4 * nbins]
        if counting.shared_route(nbins) and tensors[0].shape[0]:
            plan = counting.count_plan(tensors[0].shape[0], nbins, sms,
                                       counting.head_rows(*tensors))
            sizes.append(4 * nbins * plan.grid)
        blocks = [torch.empty(nb, dtype=torch.uint8, device=dev).fill_(0x5A)
                  for nb in sizes]
        del blocks

    shapes = [(a, a) for a in (1, 26, 129, 241, 242, 300)] + [(3, 200), (11, 7)]
    for s, d in shapes:
        for e in sizes_e:
            for what, (src, dst), w, into in count_inputs(e, (s, d), (s, d)):
                poison_counting(s * d, (src, dst, w))
                got = so.pair_count_cuda(src, dst, w, s, d, into)
                want = so.pair_count_ref(src, dst, w.to(torch.int32), s, d, into)
                record("pair_count", got, want, f"S={s} D={d} E={e} {what}")
    for b in (1, 26, 129, 241, 242, 300, 676, 241 * 241, 242 * 242):
        for e in sizes_e:
            for what, (v,), w, into in count_inputs(e, (b,), (b,)):
                poison_counting(b, (v, w))
                got = so.histogram_cuda(v, w, b, into)
                want = so.histogram_ref(v, b, w.to(torch.int32), into)
                record("histogram", got, want, f"B={b} E={e} {what}")
    for n, s, single in ((0, 10, False), (1, 10, False), (511, 300, False),
                         (524_288, 75_000, False), (524_288, NUM_CASES, False),
                         (524_288, NUM_CASES, True), (300_001, NUM_CASES, "gaps")):
        seg = sorted_ids(n, s, single)
        for dtype in ("int32", "float32", "bool", "uint32"):
            if dtype == "uint32":
                vals = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                     device=dev, dtype=torch.int32
                                     ).view(torch.uint32)
            elif dtype == "int32":
                vals = torch.randint(-1000, 1000, (n,), generator=gen,
                                     device=dev, dtype=torch.int32)
            elif dtype == "float32":
                vals = fweights(n)
            else:
                vals = (torch.rand(n, generator=gen, device=dev) < 0.3).to(torch.int32)
            for op in ("sum", "min", "max"):
                # a freed block of the output's size, filled with 0x5A,
                # which the caching allocator hands to the output
                torch.empty(4 * s, dtype=torch.uint8, device=dev).fill_(0x5A)
                got = so.segment_reduce_cuda(vals, seg, s, op)
                if dtype == "float32" and op == "sum":
                    want = so.segment_reduce_ref(vals.cpu(), seg.cpu(), s, op)
                else:
                    want = so.segment_reduce_ref(vals, seg, s, op)
                if dtype == "uint32":      # compared as bit patterns
                    got, want = got.view(torch.int32), want.view(torch.int32)
                record("segment_reduce", got, want,
                       f"N={n} S={s} single_run={single} {dtype} {op}")
    # the fold: the sweep sizes, a size that is no multiple of the counting
    # sort's tile, and every row in one bin (the longest chain); 5,000 bins
    # take its large-bin route (global cursors, 4,096-row tiles)
    for b in (1, 26, 676, 5000):
        for e, one_bin in [(e, False) for e in sizes_e[:4] + (12_365,)] + [(524_288, True)]:
            v = (torch.full((e,), b // 2, dtype=torch.int32, device=dev) if one_bin
                 else ids(e, b))
            w = fweights(e)
            for into in (None, fweights(b)):
                got = so.ordered_histogram_cuda(v, w, b, into)
                want = so.ordered_histogram_ref(
                    v.cpu(), w.cpu(), b, None if into is None else into.cpu())
                record("ordered_histogram", got, want,
                       f"B={b} E={e} one_bin={one_bin} into={into is not None}")
    check_scans(torch, so, gen, record)
    check_semiring(torch, gen, record, out)
    check_flash(torch, out)
    check_flash_bwd(torch, out)
    torch.cuda.synchronize()
    return out


def hold_flash(torch, entry, got, q, k, v, kv_len=None, *, causal, window, what) -> dict:
    """The kernel's output ``got`` against ``flash_attention_ref`` on the
    same inputs: its dtype and shape, within ``FLASH_ATOL``, and in bf16
    within ``FLASH_BF16_MAG`` P.|V| + ``FLASH_BF16_REL`` |want| (``P.|V|``
    the plain attention of |v|, in float32).  Records the case in
    ``entry``; returns its error and, in bf16, its largest ratio to the
    magnitude bound."""
    from repro_torch.kernels import flash_attention as fa

    dtype = str(q.dtype).removeprefix("torch.")
    want = fa.flash_attention_ref(q, k, v, kv_len, causal=causal, window=window)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rec = {"max_abs_err": err}
    ok = got.dtype == want.dtype and got.shape == want.shape and err <= FLASH_ATOL[dtype]
    if ok and dtype == "bfloat16" and diff.numel():
        mag = fa.flash_attention_ref(q.float(), k.float(), v.float().abs(), kv_len,
                                     causal=causal, window=window)
        bound = FLASH_BF16_MAG * mag + FLASH_BF16_REL * want.float().abs()
        # a row with no valid column has bound 0 and must be exactly 0
        ratio = torch.where(bound > 0, diff / bound.clamp_min(1e-30),
                            torch.where(diff > 0, float("inf"), 0.0))
        rec["bound_ratio"] = float(ratio.max())
        ok = rec["bound_ratio"] <= 1.0
        entry["max_bound_ratio_bfloat16"] = max(entry.get("max_bound_ratio_bfloat16", 0.0),
                                                rec["bound_ratio"])
    entry["cases"] += 1
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    key = f"max_abs_err_{dtype}"
    entry[key] = max(entry.get(key, 0.0), err)
    if not ok:
        raise AssertionError(f"flash_attention kernel != plain version at {what}: {rec}")
    return rec


def check_flash_shapes(torch, shapes, entry, gen) -> dict:
    """The kernel against its plain version (``hold_flash``) at each
    (B, H, KVH, Sq, Sk, D, causal, window) of ``shapes``, in float32 and
    bf16: ``kv_len`` as an int and again as a 0-d int32 tensor on the card
    below batch 8 past 64 keys, and ``kv_len = 0`` (every row without a
    valid column, which must be 0) at (1, 4, 128).  Returns each case's
    record."""
    from repro_torch.kernels import flash_attention as fa

    dev = "cuda"
    records = {}
    for b, h, kvh, sq, sk, d, causal, win in shapes:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
            k = torch.randn((b, kvh, sk, d), generator=gen, device=dev).to(dt)
            v = torch.randn((b, kvh, sk, d), generator=gen, device=dev).to(dt)
            lens = [None]
            if sk > 64 and b < 8:
                lens = [sk - 17, torch.tensor(sk - 17, dtype=torch.int32, device=dev)]
            if (b, h, sq) == (1, 4, 128):
                lens.append(torch.tensor(0, dtype=torch.int32, device=dev))
            for kv_len in lens:
                got = fa.flash_attention_cuda(q, k, v, kv_len, causal=causal, window=win)
                what = (f"B={b} H={h} KVH={kvh} Sq={sq} Sk={sk} D={d} causal={causal} "
                        f"window={win} kv_len={kv_len!r} {dtype}")
                records[what] = hold_flash(torch, entry, got, q, k, v, kv_len,
                                           causal=causal, window=win, what=what)
                if isinstance(kv_len, torch.Tensor) and int(kv_len) == 0 and bool(got.any()):
                    raise AssertionError(f"flash_attention at {what}: a row with no "
                                         f"valid column is not 0")
            del q, k, v, got
    return records


def check_flash(torch, out) -> None:
    """The flash-attention kernel against its plain version on the card
    (``hold_flash``): at ``FLASH_SHAPES`` and ``FAMILY_TRAIN_SHAPES``
    (``check_flash_shapes``), with
    ``p_dtype`` on the float32 route, then, at every head dim, the model's
    (B, S, H, D) buffers viewed as (B, H, S, D) (read in place, GQA, a
    window), and a CUDA-graph capture replayed after ``kv_len`` changed on
    the card."""
    from repro_torch.kernels import flash_attention as fa

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the plain attention would round")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    entry = out["flash_attention"]
    check_flash_shapes(torch, FLASH_SHAPES, entry, gen)
    check_flash_shapes(torch, FAMILY_TRAIN_SHAPES, entry, gen)
    for d in FLASH_HEAD_DIMS:
        for p_dtype, unit in P_DTYPE_UNIT.items():
            # attn_p_dtype on the float32 route (the bf16 route rounds P to bf16)
            pdt = getattr(torch, p_dtype)
            q, k, v = (torch.randn((1, 4, 150, d), generator=gen, device=dev)
                       for _ in range(3))
            got = fa.flash_attention_cuda(q, k, v, causal=True, p_dtype=pdt)
            want = fa.flash_attention_ref(q, k, v, causal=True, p_dtype=pdt)
            err = float((got - want).abs().max())
            tol = 2 * unit * float(v.abs().max()) + FLASH_ATOL["float32"]
            entry[f"p_dtype_{p_dtype}_max_abs_err"] = max(
                entry.get(f"p_dtype_{p_dtype}_max_abs_err", 0.0), err)
            if not err <= tol:
                raise AssertionError(f"flash_attention p_dtype={p_dtype} D={d}: max abs "
                                     f"err {err} > {tol}")
    for d in FLASH_HEAD_DIMS:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = torch.randn((2, 77, 6, d), generator=gen, device=dev).to(dt).transpose(1, 2)
            k = torch.randn((2, 77, 3, d), generator=gen, device=dev).to(dt).transpose(1, 2)
            v = torch.randn((2, 77, 3, d), generator=gen, device=dev).to(dt).transpose(1, 2)
            got = fa.flash_attention_cuda(q, k, v, causal=True, window=20)
            if not got.transpose(1, 2).is_contiguous():
                raise AssertionError(f"flash_attention D={d} {dtype}: the output lost "
                                     f"the (B, S, H, D) layout of its query")
            hold_flash(torch, entry, got, q, k, v, causal=True, window=20,
                       what=f"(B, S, H, D) views D={d} {dtype}")
            kv_len = torch.tensor(77, dtype=torch.int32, device=dev)
            fa.flash_attention_cuda(q, k, v, kv_len, causal=False)   # first use
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                got = fa.flash_attention_cuda(q, k, v, kv_len, causal=False)
            for n in (77, 40, 0):
                kv_len.fill_(n)
                g.replay()
                torch.cuda.synchronize()
                hold_flash(torch, entry, got, q, k, v, n, causal=False, window=None,
                           what=f"CUDA-graph replay D={d} kv_len={n} {dtype}")


def rel_err(got, want) -> float:
    """max |got - want| / (1 + |want|) in float32 (0 for empty tensors)."""
    if want.numel() == 0:
        return 0.0
    return float(((got.float() - want.float()).abs() / (1 + want.float().abs())).max())


def bwd_bound_ratio(got, want, mag, dtype: str, extra_mag: float = 0.0) -> float:
    """max |got - want| / (FLASH_BWD_RTOL (1 + |want|) + (FLASH_BWD_MAG +
    extra_mag) A): at most 1 within the backward's stated bound (0 for
    empty tensors)."""
    if want.numel() == 0:
        return 0.0
    want = want.float()
    tol = (FLASH_BWD_RTOL[dtype] * (1 + want.abs())
           + (FLASH_BWD_MAG[dtype] + extra_mag) * mag.float())
    return float(((got.float() - want).abs() / tol).max())


def hold_flash_bwd(torch, entry, q, k, v, do, kv_len, causal, win, dtype, what,
                   p_dtype=None, group="shapes"):
    """The backward kernel against its plain version at one case (see
    ``check_flash_bwd``), recorded in ``entry``; returns its gradients.  In
    float32 ``entry["float32_bound_ratio"][group]`` also keeps the largest
    ratio to the bound without ``dp_error``, which is not held."""
    from repro_torch.kernels import flash_attention as fa

    kw = dict(causal=causal, window=win)
    if p_dtype is not None:
        kw["p_dtype"] = getattr(torch, p_dtype)
    o, lse = fa.flash_attention_cuda(q, k, v, kv_len, return_lse=True, **kw)
    _, lse_ref = fa.flash_attention_lse_ref(q, k, v, kv_len, **kw)
    fin = torch.isfinite(lse_ref)
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    if not (torch.equal(torch.isfinite(lse), fin) and lse_err <= FLASH_LSE_ATOL):
        raise AssertionError(f"flash_attention lse != plain at {what}: {lse_err}")
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_len, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_len, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd at {what}: two calls on the same "
                             f"inputs differ")
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, kv_len, **kw)
    mag = fa.flash_attention_bwd_magnitudes(q, k, v, o, lse, do, kv_len,
                                            causal=causal, window=win,
                                            dp_error=dtype == "float32")
    extra = (0.0, 0.0, 2 * P_DTYPE_UNIT[p_dtype]) if p_dtype else (0.0,) * 3
    for x, y in zip(got, want):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"flash_attention_bwd at {what}: {x.dtype} "
                                 f"{tuple(x.shape)} != plain {y.dtype} {tuple(y.shape)}")
    err = max(rel_err(x, y) for x, y in zip(got, want))
    ratio = max(bwd_bound_ratio(x, y, m, dtype, c)
                for x, y, m, c in zip(got, want, mag, extra))
    abs_err = max(float((x.float() - y.float()).abs().max()) if y.numel() else 0.0
                  for x, y in zip(got, want))
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention_bwd kernel != plain version at "
                             f"{what}: {ratio} x its bound (rel err {err})")
    if dtype == "float32":
        mag = fa.flash_attention_bwd_magnitudes(q, k, v, o, lse, do, kv_len,
                                                causal=causal, window=win)
        without = max(bwd_bound_ratio(x, y, m, dtype, c)
                      for x, y, m, c in zip(got, want, mag, extra))
        seen = entry.setdefault("float32_bound_ratio", {}).setdefault(
            group, {"with_dp_error": 0.0, "without_dp_error": 0.0})
        seen["with_dp_error"] = max(seen["with_dp_error"], ratio)
        seen["without_dp_error"] = max(seen["without_dp_error"], without)
    del mag
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fa.ops.flash_attention(*leaves, kv_len, **kw).backward(do)
    if p_dtype is not None:
        # the autograd function passes p_dtype on: the same kernels on the
        # same inputs give the direct calls' bits
        fn_err = 0.0
        if not all(torch.equal(a.grad, x) for a, x in zip(leaves, got)):
            raise AssertionError(f"FlashAttention gradients != the kernels' at {what}")
    else:
        plain = [t.detach().requires_grad_() for t in (q, k, v)]
        fa.flash_attention_ref(*plain, kv_len, **kw).backward(do)
        fn_err = max(rel_err(a.grad, b.grad) for a, b in zip(leaves, plain))
    if not fn_err <= FLASH_GRAD_RTOL[dtype]:
        raise AssertionError(f"FlashAttention gradients != autograd of the plain "
                             f"forward at {what}: rel err {fn_err}")
    if (isinstance(kv_len, torch.Tensor) and int(kv_len) == 0
            and any(bool(x.any()) for x in (*got, *(a.grad for a in leaves)))):
        raise AssertionError(f"flash_attention_bwd at {what}: rows with no valid "
                             f"column have gradients")
    entry["cases"] += 1
    entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
    for key, val in ((f"max_rel_err_{dtype}", err), (f"apply_max_rel_err_{dtype}", fn_err),
                     (f"max_bound_ratio_{dtype}", ratio), ("lse_max_abs_err", lse_err)):
        entry[key] = max(entry.get(key, 0.0), val)
    return got


def check_flash_bwd(torch, out) -> None:
    """The backward kernel at ``FLASH_SHAPES`` in float32 and bf16 (``kv_len``
    as an int, as a 0-d int32 tensor on the card, and 0, whose gradients
    must be 0), then on (B, S, H, D) buffers viewed as (B, H, S, D) at every
    head dim (GQA, a window; the gradients keep the layout): the forward's
    lse against ``flash_attention_lse_ref`` (``FLASH_LSE_ATOL``, -inf where
    the plain one is), the kernel's (dq, dk, dv) against
    ``flash_attention_bwd_ref`` on the same inputs (``FLASH_BWD_RTOL`` and
    ``FLASH_BWD_MAG`` over ``flash_attention_bwd_magnitudes``), a second
    call bitwise equal to the first (no atomics), and
    ``FlashAttention.apply``'s gradients against autograd through
    ``flash_attention_ref`` (``FLASH_GRAD_RTOL``).  Then float32 with
    ``p_dtype`` bf16 and float16 (dV's magnitude term gains 2 u,
    ``P_DTYPE_UNIT``).  Last, the shapes ``train_path`` and
    ``family_train_path`` give the kernel, in both dtypes
    (``check_flash_bwd_shapes``)."""
    from repro_torch.configs import get_config

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    entry = out["flash_attention_bwd"]

    def hold(*args, **kwargs):
        return hold_flash_bwd(torch, entry, *args, **kwargs)

    for b, h, kvh, sq, sk, d, causal, win in FLASH_SHAPES:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, do = (torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
                     for _ in range(2))
            k, v = (torch.randn((b, kvh, sk, d), generator=gen, device=dev).to(dt)
                    for _ in range(2))
            lens = [None]
            if sk > 64 and b < 8:
                lens = [sk - 17, torch.tensor(sk - 17, dtype=torch.int32, device=dev)]
            if (b, h, sq) == (1, 4, 128):
                lens.append(torch.tensor(0, dtype=torch.int32, device=dev))
            for kv_len in lens:
                hold(q, k, v, do, kv_len, causal, win, dtype,
                     f"B={b} H={h} KVH={kvh} Sq={sq} Sk={sk} D={d} causal={causal} "
                     f"window={win} kv_len={kv_len!r} {dtype}")
    for d in FLASH_HEAD_DIMS:
        for p_dtype in P_DTYPE_UNIT:
            q, k, v, do = (torch.randn((1, heads, 150, d), generator=gen, device=dev)
                           for heads in (4, 2, 2, 4))
            hold(q, k, v, do, None, True, None, "float32",
                 f"p_dtype={p_dtype} D={d} float32", p_dtype=p_dtype, group="p_dtype")
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)

            def view(heads):
                return (torch.randn((2, 77, heads, d), generator=gen, device=dev)
                        .to(dt).transpose(1, 2))

            q, k, v, do = view(6), view(3), view(3), view(6)
            got = hold(q, k, v, do, None, True, 20, dtype, f"(B, S, H, D) views D={d} {dtype}",
                       group="views")
            if not all(x.transpose(1, 2).is_contiguous() for x in got):
                raise AssertionError(f"flash_attention_bwd D={d} {dtype}: the gradients "
                                     f"lost the (B, S, H, D) layout of their inputs")
    # the shapes train_path gives the kernel: eventlm-100m's (B, S, 12, 64)
    # projections viewed as (B, H, S, D), causal, no window, every key valid;
    # then family_train_path's (FAMILY_TRAIN_SHAPES)
    cfg = get_config(TRAIN_ARCH)
    check_flash_bwd_shapes(
        torch, tuple((b, cfg.num_heads, cfg.num_kv_heads, s, s, cfg.head_dim, True, None)
                     for _, b, s, _ in TRAIN_RUNS), entry, gen, "train_path")
    check_flash_bwd_shapes(torch, FAMILY_TRAIN_SHAPES, entry, gen, "family_train_path")


def check_flash_bwd_shapes(torch, shapes, entry, gen, path: str) -> None:
    """``hold_flash_bwd`` at each (B, H, KVH, Sq, Sk, D, causal, window) of
    ``shapes`` that ``path`` gives the kernel, on the model's (B, S, H, D)
    buffers viewed as (B, H, S, D), every key valid, in both dtypes."""
    for b, h, kvh, sq, sk, d, causal, win in shapes:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
                     .transpose(1, 2) for _ in range(2))
            k, v = (torch.randn((b, sk, kvh, d), generator=gen, device="cuda").to(dt)
                    .transpose(1, 2) for _ in range(2))
            hold_flash_bwd(torch, entry, q, k, v, do, None, causal, win, dtype,
                           f"{path} (B, S, H, D) views B={b} H={h} KVH={kvh} Sq={sq} "
                           f"Sk={sk} D={d} causal={causal} window={win} {dtype}",
                           group=path)
            entry["train_shapes"] = entry.get("train_shapes", 0) + 1
            del q, k, v, do


def bench_graph(n: int, density: float = 0.25, seed: int | None = None):
    """The JAX graph benchmark's random graph (``benchmarks/bench_graph.py:
    81``): 0/1 adjacency without self-loops, integer frequencies 1..999 as
    capacities (-inf elsewhere) and costs (+inf elsewhere), float32 numpy."""
    rng = np.random.default_rng(n if seed is None else seed)
    adj = rng.random((n, n)) < density
    np.fill_diagonal(adj, False)
    freq = np.where(adj, rng.integers(1, 1000, (n, n)), 0).astype(np.float32)
    return (adj, np.where(adj, freq, -np.inf).astype(np.float32),
            np.where(adj, freq, np.inf).astype(np.float32))


def closure(go, kind: str, x, k=None, impl=None):
    """The public closure of ``kind`` (``impl`` passed only when given, so a
    parent tree without it runs the same code)."""
    kw = {} if impl is None else {"impl": impl}
    if kind == "bool":
        return go.bool_closure(x, k, **kw)
    fn = go.minplus_closure if kind == "min_plus" else go.maxmin_closure
    return fn(x, **kw)


def check_semiring(torch, gen, record, out) -> None:
    """The semiring kernels against their plain versions on the card.

    Products, for the three semirings at ``SEMIRING_SHAPES``: integer-valued
    operands with the graph queries' holes (+inf for min_plus, -inf for
    max_min) must match bitwise (tropical candidates are single operations
    reduced by min / max, integer sums below 2^24 are exact in any order);
    random float ``plus_times`` operands within the rounding bound of two
    float32 dot products, 2 * K * 2^-24 * (|A| @ |B|).  Closures, against
    the loop of plain products (``impl="ref"``), bitwise: the JAX graph
    benchmark's graphs at N = 28, 48, 128, ``CLOSURE_MAX_N`` and the
    kernel's capacity, with integer weights, with non-integer weights, and
    with NaN in two places (NaN positions equal); boolean at k = None, 3 and
    N - 1."""
    from repro_torch.kernels import graph_ops as go

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the plain plus_times would round")
    dev = "cuda"
    for m, k, n in SEMIRING_SHAPES:
        for semiring in SEMIRINGS:
            a = torch.randint(0, 50, (m, k), generator=gen, device=dev).float()
            b = torch.randint(0, 50, (k, n), generator=gen, device=dev).float()
            hole = {"min_plus": float("inf"), "max_min": float("-inf")}.get(semiring)
            if hole is not None:
                a[torch.rand((m, k), generator=gen, device=dev) < 0.4] = hole
                b[torch.rand((k, n), generator=gen, device=dev) < 0.4] = hole
            got = go.semiring_matmul_cuda(a, b, semiring)
            record("semiring_matmul", got, go.semiring_matmul_ref(a, b, semiring),
                   f"M={m} K={k} N={n} {semiring} integer operands")
        a = torch.randn((m, k), generator=gen, device=dev)
        b = torch.randn((k, n), generator=gen, device=dev)
        got = go.semiring_matmul_cuda(a, b, "plus_times").double()
        want = go.semiring_matmul_ref(a, b, "plus_times").double()
        diff = (got - want).abs()
        limit = 2 * k * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
        entry = out["semiring_matmul"]
        entry["cases"] += 1
        entry["max_abs_err"] = max(entry["max_abs_err"], float(diff.max()))
        entry["float_plus_times_max_err_over_bound"] = max(
            entry.get("float_plus_times_max_err_over_bound", 0.0),
            float((diff / limit.clamp(min=1e-30)).max()))
        if not bool((diff <= limit).all()):
            raise AssertionError(f"semiring_matmul plus_times at M={m} K={k} "
                                 f"N={n}: beyond the rounding bound")
    sizes = sorted({28, 48, 128, go.CLOSURE_MAX_N, go.CLOSURE_CAPACITY})
    for n in sizes:
        adj_np, cap_np, cost_np = bench_graph(n)
        adj = torch.from_numpy(adj_np).to(dev)
        for k in (None, 3, n - 1):
            record("semiring_closure", go.semiring_closure_cuda(adj, "bool", k),
                   closure(go, "bool", adj, k, impl="ref"), f"N={n} bool k={k}")
        for kind, w_np in (("min_plus", cost_np), ("max_min", cap_np)):
            w = torch.from_numpy(w_np).to(dev)
            frac = torch.where(torch.isfinite(w), w / 7.0, w)      # non-integer
            nan = frac.clone()
            nan[torch.randint(0, n, (2,), generator=gen, device=dev),
                torch.randint(0, n, (2,), generator=gen, device=dev)] = float("nan")
            for label, x in (("integer", w), ("non-integer", frac), ("nan", nan)):
                record("semiring_closure", go.semiring_closure_cuda(x, kind),
                       closure(go, kind, x, impl="ref"), f"N={n} {kind} {label}",
                       equal_nan=label == "nan")


def scan_starts(torch, gen, n: int, runs: str, flag0: bool):
    """Start flags for runs of one row, ~7 rows (L1's mean case), 64 rows
    (L1's longest case), or one run over everything; row 0 flagged or not
    (an unflagged row 0 continues the carry)."""
    dev = "cuda"
    if runs == "one":
        starts = torch.ones(n, dtype=torch.bool, device=dev)
    elif runs == "short":
        starts = torch.rand(n, generator=gen, device=dev) < 1 / 7
    elif runs == "64":
        starts = torch.arange(n, device=dev) % 64 == 0
    else:
        starts = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        starts[0] = flag0
    return starts


def fold_affine(mul, add, starts, carry):
    """The sequential affine fold in Python integers: the oracle for one
    run over a whole chunk, where the plain version would step once per
    row."""
    m = mul.cpu().numpy().view(np.uint32).tolist()
    b = add.cpu().numpy().view(np.uint32).tolist()
    f = starts.cpu().numpy().tolist()
    h = int(carry.cpu().numpy().view(np.uint32))
    out = []
    for mi, bi, fi in zip(m, b, f):
        h = ((0 if fi else h) * mi + bi) & 0xFFFFFFFF
        out.append(h)
    return np.array(out, np.uint32).view(np.int32)


def fold_sum(x, starts, carry):
    """Row-order float32 prefix sums run by run (``np.add.accumulate`` is
    sequential): the oracle for one run over a whole chunk."""
    xs = x.cpu().numpy().reshape(x.shape[0], -1)
    f, c = starts.cpu().numpy(), carry.cpu().numpy().reshape(-1)
    out = np.empty_like(xs)
    heads = np.flatnonzero(f | (np.arange(len(f)) == 0))
    for lo, hi in zip(heads, list(heads[1:]) + [len(f)]):
        seed = np.zeros_like(c) if f[lo] else c
        out[lo:hi] = np.add.accumulate(np.concatenate([seed[None], xs[lo:hi]]),
                                       axis=0)[1:]
    return out.reshape(x.shape)


def check_scans(torch, so, gen, record) -> None:
    """The three segmented scans against their plain versions, bitwise:
    n = 0, 1, 511, 524,288; runs of 1, ~7 and 64 rows and one run over
    everything; row 0 flagged and not; carries 0 and non-zero.  polyhash
    and affine (random uint32 maps) are compared with the plain version on
    the card; the float32 sums (non-integer rows across eight decades,
    (N, 26) and (N,)) with the plain version on CPU copies.  One run over a
    whole chunk, a ghost-shaped chunk, a 2^20-row run, misaligned views and
    a ragged last tile are held against the sequential folds above, and so
    are the sum scan's tile edges: runs past a tile and its halo, rows at an
    odd row offset, tiles without a head, K = 1, 26 and 300."""
    from repro_torch.core.polyhash import BASE1, BASE2

    dev = "cuda"
    for n in (0, 1, 511, 524_288):
        for runs in ("one", "short", "64", "whole"):
            for flag0 in (True, False):
                starts = scan_starts(torch, gen, n, runs, flag0)
                serial = runs == "whole" and n > 511
                what = f"N={n} runs={runs} row0_flagged={flag0}"
                for c, base in ((0, BASE1), (0x9E3779B9 - 2**32, BASE2)):
                    carry = torch.tensor(c, dtype=torch.int32, device=dev)
                    vals = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                         device=dev, dtype=torch.int32)
                    mul = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                        device=dev, dtype=torch.int32)
                    ys, out = so.segmented_polyhash_cuda(vals, starts, carry, base)
                    ya, oa = so.segmented_affine_cuda(mul, vals, starts, carry)
                    if serial:
                        want = torch.from_numpy(fold_affine(
                            torch.full_like(vals, base), vals, starts, carry))
                        want_a = torch.from_numpy(fold_affine(mul, vals, starts, carry))
                    else:
                        want, _ = so.segmented_scan_ref(vals, starts, carry,
                                                        "polyhash", base)
                        want_a, _ = so.segmented_affine_ref(mul, vals, starts, carry)
                    record("segmented_polyhash", ys, want, f"{what} carry={c}")
                    record("segmented_affine", ya, want_a, f"{what} carry={c}")
                    if n:
                        record("segmented_polyhash", out, ys[-1], f"{what} carry_out")
                        record("segmented_affine", oa, ya[-1], f"{what} carry_out")
                for shape in ((n, 26), (n,)):
                    mag = 10.0 ** torch.randint(-3, 5, shape, generator=gen, device=dev)
                    x = (torch.randn(shape, generator=gen, device=dev) * mag).float()
                    carry = torch.randn(shape[1:], generator=gen, device=dev)
                    ys, out = so.segmented_sum_scan_cuda(x, starts, carry)
                    if serial:
                        want = torch.from_numpy(fold_sum(x, starts, carry))
                    else:
                        want, _ = so.segmented_scan_ref(x.cpu(), starts.cpu(),
                                                        carry.cpu(), "sum")
                    record("segmented_sum_scan", ys, want, f"{what} shape={shape}")
                    if n:
                        record("segmented_sum_scan", out, ys[-1], f"{what} carry_out")
    # where the head-of-run design was serial: a ghost-shaped chunk (2^17
    # rows, one per case segment, the last ~56,000 one padding run of
    # identity maps) and one run over 2^20 rows; then views one element off
    # 16-byte alignment (the one-row-a-load path) and a ragged last tile.
    # Held against the sequential fold.
    carry = torch.tensor(0x9E3779B9 - 2**32, dtype=torch.int32, device=dev)
    for label, n, off in (("ghost", 1 << 17, 0), ("one_run", 1 << 20, 0),
                          ("unaligned", 100_003, 1), ("ragged", 3 * 4096 * 7 + 1234, 0)):
        starts = torch.zeros(n + off, dtype=torch.bool, device=dev)
        vals = torch.randint(-2**31, 2**31 - 1, (n + off,), generator=gen, device=dev,
                             dtype=torch.int32)
        mul = torch.randint(-2**31, 2**31 - 1, (n + off,), generator=gen, device=dev,
                            dtype=torch.int32)
        if label == "ghost":
            d = n - 56_000 + 1
            starts[:d] = True
            mul[d:], vals[d:] = 1, 0
        elif label != "one_run":
            starts[off:] = torch.rand(n, generator=gen, device=dev) < 1 / 7
        starts, vals, mul = starts[off:], vals[off:], mul[off:]
        ys, out = so.segmented_polyhash_cuda(vals, starts, carry, BASE1)
        ya, oa = so.segmented_affine_cuda(mul, vals, starts, carry)
        want = torch.from_numpy(fold_affine(torch.full_like(vals, BASE1), vals, starts, carry))
        want_a = torch.from_numpy(fold_affine(mul, vals, starts, carry))
        what = f"{label} N={n}"
        record("segmented_polyhash", ys, want, what)
        record("segmented_affine", ya, want_a, what)
        record("segmented_polyhash", out, want[-1], f"{what} carry_out")
        record("segmented_affine", oa, want_a[-1], f"{what} carry_out")
    # the tile-staged sum scan where its tiles meet: runs of 200-400 rows
    # (past a tile and its halo, continued window by window), 104-byte rows
    # viewed at an odd row offset (the 4-byte copies), tiles without a head;
    # K = 26, 1 and 300 (two column slices).  Held against the sequential
    # fold, carry_out included.
    for k in (26, 1, 300):
        for label in ("crossing_runs", "odd_row_offset", "tile_without_head"):
            n, off = 100_003, int(label == "odd_row_offset")
            starts = torch.zeros(n + off, dtype=torch.bool, device=dev)
            if label == "crossing_runs":
                starts[torch.cumsum(torch.randint(200, 400, (n // 200,), generator=gen,
                                                  device=dev), 0)[:-1].clamp(max=n - 1)] = True
            elif label == "odd_row_offset":
                starts = torch.rand(n + off, generator=gen, device=dev) < 1 / 7
            else:
                starts[::5_000] = True
            starts[off] = label == "tile_without_head"
            shape = (n + off, k) if k > 1 else (n + off,)
            mag = 10.0 ** torch.randint(-3, 5, shape, generator=gen, device=dev)
            x = (torch.randn(shape, generator=gen, device=dev) * mag).float()[off:]
            starts = starts[off:]
            carry = torch.randn(shape[1:], generator=gen, device=dev)
            ys, out = so.segmented_sum_scan_cuda(x, starts, carry)
            want = torch.from_numpy(fold_sum(x, starts, carry))
            what = f"sum {label} N={n} K={k}"
            record("segmented_sum_scan", ys, want, what)
            record("segmented_sum_scan", out, want[-1], f"{what} carry_out")


def time_kernels(torch, so, engine, frame_gpu, ghosts) -> dict:
    """Kernel, plain-version and library times at the main paths' shapes."""
    n = frame_gpu.nrows
    spans = [(lo, min(lo + ROW_GROUP_ROWS, n)) for lo in range(0, n, ROW_GROUP_ROWS)]
    spans = [s for s in spans if s[1] - s[0] == ROW_GROUP_ROWS]
    rows = time_counting(torch, so, engine, frame_gpu)
    rows.update(time_stats_kernels(torch, so, engine, frame_gpu, spans))
    rows.update(time_scan_kernels(torch, so, engine, frame_gpu, spans, ghosts))
    return rows


def graph_nodes(torch, fn) -> dict:
    """The device nodes one call of ``fn`` makes: ``fn`` captured into a CUDA
    graph, its nodes counted by type with the driver's ``cuGraphGetNodes``
    and ``cuGraphNodeGetType`` (the profiler dropped some kernels of these
    calls once earlier traces had run in the process)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    for name in ("cuGraphGetNodes", "cuGraphNodeGetType"):
        getattr(cuda, name).restype = ctypes.c_int

    def check(res, what):
        if res != 0:
            raise RuntimeError(f"{what} failed: CUresult {res}")

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}
    by_type: dict = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)),
              "cuGraphNodeGetType")
        key = kinds.get(t.value, f"type_{t.value}")
        by_type[key] = by_type.get(key, 0) + 1
    g.reset()
    return {"nodes": count.value, "nodes_by_type": by_type}


def time_counting(torch, so, engine, frame_gpu) -> dict:
    """The counting kernels at the DFG update's shapes over the L1 log, per
    524,288-row chunk (the chunks cycle, so inputs come from HBM, not L2) and
    over the whole log: the kernels' wrappers with int32 weights and no
    ``into`` (the yardstick every earlier run timed), the main path's call
    (``ops.pair_count`` / ``ops.histogram`` with a bool mask and an int32
    ``into``, as ``dfg_kernel``'s update makes it) with its device nodes,
    and one whole DFG update (``adjacent`` plus the three calls).  Only
    entry points that every tree since the first counting kernels has are
    called, so a parent tree is timed by the same code."""
    from repro_torch.core import ChunkedEventFrame, dfg_kernel

    a = NUM_ACTIVITIES
    adj = engine.adjacent(frame_gpu, engine.init_row_carry("cuda"))
    prev_act, act = adj.prev_act.contiguous(), adj.act.contiguous()
    pair_b, start_b = adj.pair.contiguous(), adj.is_start.contiguous()
    pair = pair_b.to(torch.int32)
    is_start = start_b.to(torch.int32)
    pair_key = prev_act.long() * a + act.long()
    act_long = act.long()
    n = act.shape[0]
    spans = [(lo, min(lo + ROW_GROUP_ROWS, n)) for lo in range(0, n, ROW_GROUP_ROWS)]
    spans = [s for s in spans if s[1] - s[0] == ROW_GROUP_ROWS]
    whole = [(0, n)]
    pc_out = torch.zeros(a * a, dtype=torch.int32, device="cuda")
    h_out = torch.zeros(a, dtype=torch.int32, device="cuda")
    h2_out = torch.zeros(a * a, dtype=torch.int32, device="cuda")
    pc_into = torch.randint(0, 1000, (a, a), dtype=torch.int32, device="cuda")
    h_into = torch.randint(0, 1000, (a,), dtype=torch.int32, device="cuda")
    shift_key = (prev_act * a + act).contiguous()   # the shift method's df:pair ids
    rows = {}
    for label, sp in (("chunk", spans), ("whole_log", whole)):
        e = sp[0][1] - sp[0][0]
        k = len(sp)

        def sl(t, i, sp=sp):
            lo, hi = sp[i]
            return t[lo:hi]

        rows[f"pair_count/{label}"] = {
            "E": e, "S": a, "D": a,
            "ms": time_ms(torch, lambda i: so.pair_count_cuda(
                sl(prev_act, i), sl(act, i), sl(pair, i), a, a), k),
            "plain_ms": time_ms(torch, lambda i: so.pair_count_ref(
                sl(prev_act, i), sl(act, i), sl(pair, i), a, a), k),
            "library_ms": time_ms(torch, lambda i: pc_out.index_add_(
                0, sl(pair_key, i), sl(pair, i)), k),
            **bound(12 * e + 4 * a * a, e)}
        rows[f"histogram/{label}"] = {
            "E": e, "B": a,
            "ms": time_ms(torch, lambda i: so.histogram_cuda(
                sl(act, i), sl(is_start, i), a), k),
            "plain_ms": time_ms(torch, lambda i: so.histogram_ref(
                sl(act, i), a, sl(is_start, i)), k),
            "library_ms": time_ms(torch, lambda i: h_out.index_add_(
                0, sl(act_long, i), sl(is_start, i)), k),
            **bound(8 * e + 4 * a, e)}
    # device time per call (the event times above include the host's
    # per-call cost whenever the card outruns the launches), the library
    # call's too
    for label, sp in (("chunk", spans), ("whole_log", whole)):
        rows[f"pair_count/{label}"]["graph_ms"] = graph_ms(torch, lambda sp=sp: [
            so.pair_count_cuda(prev_act[lo:hi], act[lo:hi], pair[lo:hi], a, a)
            for lo, hi in sp], len(sp))
        rows[f"pair_count/{label}"]["library_graph_ms"] = graph_ms(torch, lambda sp=sp: [
            pc_out.index_add_(0, pair_key[lo:hi], pair[lo:hi]) for lo, hi in sp], len(sp))
        rows[f"histogram/{label}"]["graph_ms"] = graph_ms(torch, lambda sp=sp: [
            so.histogram_cuda(act[lo:hi], is_start[lo:hi], a)
            for lo, hi in sp], len(sp))
        rows[f"histogram/{label}"]["library_graph_ms"] = graph_ms(torch, lambda sp=sp: [
            h_out.index_add_(0, act_long[lo:hi], is_start[lo:hi]) for lo, hi in sp], len(sp))
    e = n
    rows["histogram/shift_whole_log"] = {
        "E": e, "B": a * a,
        "ms": time_ms(torch, lambda i: so.histogram_cuda(shift_key, pair, a * a), 1),
        "plain_ms": time_ms(torch, lambda i: so.histogram_ref(shift_key, a * a, pair), 1),
        "library_ms": time_ms(torch, lambda i: h2_out.index_add_(0, pair_key, pair), 1),
        "graph_ms": graph_ms(torch, lambda: so.histogram_cuda(shift_key, pair, a * a), 1),
        **bound(8 * e + 4 * a * a, e)}

    # the main path's call: a bool mask read in place, the state as into
    k = len(spans)
    e = ROW_GROUP_ROWS

    def pc_call(i, impl=None):
        lo, hi = spans[i]
        return so.pair_count(prev_act[lo:hi], act[lo:hi], a, weights=pair_b[lo:hi],
                             into=pc_into, impl=impl)

    def h_call(i, impl=None):
        lo, hi = spans[i]
        return so.histogram(act[lo:hi], a, weights=start_b[lo:hi], into=h_into,
                            impl=impl)

    for name, call, nbytes, lib_row in (
            ("pair_count", pc_call, 9 * e + 8 * a * a, rows["pair_count/chunk"]),
            ("histogram", h_call, 5 * e + 8 * a, rows["histogram/chunk"])):
        rows[f"{name}/main_call"] = {
            "E": e, "bins": a * a if name == "pair_count" else a,
            "weights": "bool", "into": True,
            "ms": time_ms(torch, call, k),
            "graph_ms": graph_ms(torch, lambda call=call: [call(i) for i in range(k)], k),
            "plain_ms": time_ms(torch, lambda i, call=call: call(i, "ref"), k),
            # index_add_ takes no bool source: int32 weights, no into
            "library_ms": lib_row["library_ms"],
            "library_graph_ms": lib_row["library_graph_ms"],
            **graph_nodes(torch, lambda call=call: call(0)),
            **bound(nbytes, e)}

    # one DFG update: adjacent, the three counting calls, the next carry
    kernel = dfg_kernel(a)
    chunks = [c for c in ChunkedEventFrame.from_frame(frame_gpu, ROW_GROUP_ROWS)
              if c.nrows == ROW_GROUP_ROWS]
    state, carry = kernel.init("cuda")

    def update():
        return kernel.update(state, carry, chunks[0])

    def rest():
        return (engine.adjacent(chunks[0], carry),
                engine.next_row_carry(carry, chunks[0]))

    whole, others = graph_nodes(torch, update), graph_nodes(torch, rest)
    update_ms = graph_ms(torch, lambda: [kernel.update(state, carry, c)
                                         for c in chunks], len(chunks))
    rest_ms = graph_ms(torch, lambda: [(engine.adjacent(c, carry),
                                        engine.next_row_carry(carry, c))
                                       for c in chunks], len(chunks))
    rows["dfg_update/chunk"] = {
        "E": e, "nodes": whole["nodes"], "nodes_by_type": whole["nodes_by_type"],
        "counting_nodes": whole["nodes"] - others["nodes"],
        "graph_ms": update_ms, "counting_graph_ms": update_ms - rest_ms,
        "ms": time_ms(torch, lambda i: kernel.update(state, carry, chunks[i]),
                      len(chunks)),
        "counting_bound_ms": bound(9 * e + 8 * a * a + 2 * (5 * e + 8 * a), 3 * e)["bound_ms"]}
    torch.cuda.synchronize()
    return rows


def time_stats_kernels(torch, so, engine, frame_gpu, spans) -> dict:
    """The stats path's kernels at its chunk shapes over the L1 log:
    ``segment_reduce`` into 10^6 segments (int32 sum = ``case_sizes``,
    float32 min/max = ``case_durations``, bool max = the case filter,
    uint32 max = the variants' fingerprints), and
    the row-order fold of the sojourn totals (26 bins; 676 bins is the
    float ``pair_count`` shape)."""
    s_n, a = NUM_CASES, NUM_ACTIVITIES
    carry = engine.init_row_carry("cuda", seg=torch.tensor(-1, dtype=torch.int32,
                                                             device="cuda"))
    adj = engine.adjacent(frame_gpu, carry, need_ts=True)
    seg = engine.global_segments(adj, carry).contiguous()
    seg_long = seg.long()
    ts = adj.ts.contiguous()
    # the variants' unsigned max: each case's polyhash at its last row
    hs, _ = so.segmented_polyhash_cuda(
        (adj.act.to(torch.int32) + 1).contiguous(), adj.new_seg.contiguous(),
        torch.zeros((), dtype=torch.int32, device="cuda"), 1_000_003)
    ends = torch.cat([adj.new_seg[1:], torch.ones(1, dtype=torch.bool, device="cuda")])
    inputs = {"sum_int32": ("sum", adj.rv.to(torch.int32).contiguous()),
              "min_float32": ("min", ts), "max_float32": ("max", ts),
              "max_bool": ("max", (adj.act == 0).to(torch.int32).contiguous()),
              "max_uint32": ("max", torch.where(ends, hs, 0).view(torch.uint32))}
    lib_op = {"sum": "sum", "min": "amin", "max": "amax"}
    k = len(spans)
    e = spans[0][1] - spans[0][0]
    rows = {}

    def sl(t, i):
        lo, hi = spans[i]
        return t[lo:hi]

    for label, (op, vals) in inputs.items():
        # the library call reduces int64 copies of uint32 values (torch has
        # no uint32 scatter max)
        unsigned = vals.dtype == torch.uint32
        lib_vals = so.ref.u32_values(vals) if unsigned else vals
        ident = 0 if unsigned else so.reduce_identity(op, vals.dtype).item()
        lib_out = torch.full((s_n,), ident, dtype=lib_vals.dtype, device="cuda")
        rows[f"segment_reduce/{label}/chunk"] = {
            "E": e, "S": s_n, "op": op,
            "ms": time_ms(torch, lambda i: so.segment_reduce_cuda(
                sl(vals, i), sl(seg, i), s_n, op), k),
            "graph_ms": graph_ms(torch, lambda: [
                so.segment_reduce_cuda(vals[lo:hi], seg[lo:hi], s_n, op)
                for lo, hi in spans], k),
            "plain_ms": time_ms(torch, lambda i: so.segment_reduce_ref(
                sl(vals, i), sl(seg, i), s_n, op), k),
            "library_ms": time_ms(torch, lambda i: lib_out.scatter_reduce_(
                0, sl(seg_long, i), sl(lib_vals, i), lib_op[op], include_self=True), k),
            "library_graph_ms": graph_ms(torch, lambda: [lib_out.scatter_reduce_(
                0, seg_long[lo:hi], lib_vals[lo:hi], lib_op[op], include_self=True)
                for lo, hi in spans], k),
            # device microseconds a call by activity: one kernel, no fill
            "device_us_per_call": {
                key: us / count for key, (count, us) in profile_device(
                    torch, lambda op=op, vals=vals: [
                        so.segment_reduce_cuda(vals[lo:hi], seg[lo:hi], s_n, op)
                        for lo, hi in spans]).items()},
            **bound(8 * e + 4 * s_n, e)}
    # one run over a whole chunk, folded serially by the block that holds
    # its head: float32 min, and the float32 sum (a chain of dependent adds)
    one = torch.zeros(e, dtype=torch.int32, device="cuda")
    for label, op in (("single_run", "min"), ("single_run_sum", "sum")):
        rows[f"segment_reduce/{label}/chunk"] = {
            "E": e, "S": s_n, "op": op, "dtype": "float32",
            "ms": time_ms(torch, lambda i, op=op: so.segment_reduce_cuda(
                ts[:e], one, s_n, op), 1, iters=5),
            **bound(8 * e + 4 * s_n, e)}

    # the sojourn fold: bins = source activity, weights = dt, onto a state
    dt = torch.where(adj.pair, adj.ts - adj.prev_ts, 0.0).contiguous()
    prev_act = adj.prev_act.contiguous()
    prev_long = prev_act.long()
    key = (adj.prev_act * a + adj.act).contiguous()          # 676 bins
    key_long = key.long()
    for label, (vals, vlong, bins) in (("sojourn_26", (prev_act, prev_long, a)),
                                        ("pair_676", (key, key_long, a * a))):
        # the fold's floor: each call's longest bin is a chain of dependent
        # float adds, ADD_CYCLES each at the SM clock
        longest = [int(torch.bincount(sl(vlong, i)[(sl(vlong, i) >= 0)
                                                   & (sl(vlong, i) < bins)],
                                      minlength=bins).max()) for i in range(k)]
        clock = sm_clock_mhz()
        chain = {"longest_bin": float(np.mean(longest)), "sm_clock_mhz": clock,
                 "chain_bound_ms": float(np.mean(longest)) * ADD_CYCLES
                 / (clock * 1e6) * 1e3}
        into = torch.zeros(bins, dtype=torch.float32, device="cuda")
        lib_out = torch.zeros(bins, dtype=torch.float32, device="cuda")
        host = [(sl(vals, i).cpu(), sl(dt, i).cpu()) for i in range(k)]
        into_cpu = into.cpu()
        rows[f"ordered_histogram/{label}/chunk"] = {
            "E": e, "B": bins,
            "ms": time_ms(torch, lambda i: so.ordered_histogram_cuda(
                sl(vals, i), sl(dt, i), bins, into), k, iters=50),
            "graph_ms": graph_ms(torch, lambda: [
                so.ordered_histogram_cuda(vals[lo:hi], dt[lo:hi], bins, into)
                for lo, hi in spans], k, replays=5),
            # the plain row-order fold runs on the CPU (inputs already there)
            "plain_ms": host_ms(lambda: [so.ordered_histogram_ref(
                v, w, bins, into_cpu) for v, w in host]) / k,
            "plain_device": "cpu",
            # yardstick only: CUDA index_add_ adds in no fixed order
            "library_ms": time_ms(torch, lambda i: lib_out.index_add_(
                0, sl(vlong, i), sl(dt, i)), k),
            "library_graph_ms": graph_ms(torch, lambda: [lib_out.index_add_(
                0, vlong[lo:hi], dt[lo:hi]) for lo, hi in spans], k),
            **bound(8 * e + 8 * bins, e), **chain}
    torch.cuda.synchronize()
    return rows


def time_scan_kernels(torch, so, engine, frame_gpu, spans, ghosts) -> dict:
    """The segmented scans at the variants and performance paths' chunk
    shapes over the L1 log: the polyhash of ``act + 1`` (524,288 rows), the
    affine scan at the same shape (maps ``(BASE1, act + 1)``) and at the
    ghost chunks' shape, and the (524,288 x 26) float32 one-hot prefix sum
    of ``eventually_follows``.  No single PyTorch call computes a segmented
    scan (``library_ms`` is None); an unsegmented ``torch.cumsum`` of the
    same rows is recorded as a yardstick only.  ``single_run_ms``: one run
    over a whole chunk (which the sum scan walks with one thread per
    column).  ``device_us_per_call``: the profiler's device time a call,
    by kernel, memset and copy."""
    from repro_torch.core.polyhash import BASE1, SK_ADD1, SK_MUL1

    a_n = NUM_ACTIVITIES
    adj = engine.adjacent(frame_gpu, engine.init_row_carry("cuda"))
    starts = adj.new_seg.contiguous()
    vals = (adj.act.to(torch.int32) + 1).contiguous()
    mul = torch.full_like(vals, BASE1)
    onehot = ((adj.act.long()[:, None] == torch.arange(a_n, device="cuda")[None, :])
              & adj.rv[:, None]).to(torch.float32).contiguous()
    c0 = torch.zeros((), dtype=torch.int32, device="cuda")
    p0 = torch.zeros(a_n, dtype=torch.float32, device="cuda")
    k = len(spans)
    e = spans[0][1] - spans[0][0]
    one = torch.zeros(e, dtype=torch.bool, device="cuda")
    one[0] = True

    def sl(t, i):
        lo, hi = spans[i]
        return t[lo:hi]

    calls = {
        "segmented_polyhash": (
            lambda i: so.segmented_polyhash_cuda(sl(vals, i), sl(starts, i), c0, BASE1),
            lambda i: so.segmented_scan_ref(sl(vals, i), sl(starts, i), c0,
                                            "polyhash", BASE1),
            lambda: so.segmented_polyhash_cuda(vals[:e], one, c0, BASE1),
            None, 9 * e, 2 * e),
        "segmented_affine": (
            lambda i: so.segmented_affine_cuda(sl(mul, i), sl(vals, i), sl(starts, i), c0),
            lambda i: so.segmented_affine_ref(sl(mul, i), sl(vals, i), sl(starts, i), c0),
            lambda: so.segmented_affine_cuda(mul[:e], vals[:e], one, c0),
            None, 13 * e, 2 * e),
        "segmented_sum_scan": (
            lambda i: so.segmented_sum_scan_cuda(sl(onehot, i), sl(starts, i), p0),
            lambda i: so.segmented_scan_ref(sl(onehot, i), sl(starts, i), p0, "sum"),
            lambda: so.segmented_sum_scan_cuda(onehot[:e], one, p0),
            lambda i: torch.cumsum(sl(onehot, i), 0),
            (8 * a_n + 1) * e, a_n * e),
    }
    rows = {}
    for name, (kern, plain, single, yard, nbytes, ops) in calls.items():
        row = {"E": e, "ms": time_ms(torch, kern, k),
               "graph_ms": graph_ms(torch, lambda kern=kern: [kern(i) for i in range(k)], k),
               "plain_ms": time_ms(torch, plain, k, iters=10),
               "single_run_ms": time_ms(torch, lambda i: single(), 1, iters=3),
               "library_ms": None, **bound(nbytes, ops)}
        if yard is not None:
            row["yardstick_unsegmented_cumsum_ms"] = time_ms(torch, yard, k)
        # device microseconds a call by activity (the polyhash / affine
        # launcher zeroes its status words with a memset before the kernel)
        row["device_us_per_call"] = {
            key: us / count for key, (count, us) in profile_device(
                torch, lambda kern=kern: [kern(i) for i in range(k)]).items()}
        rows[f"{name}/chunk"] = row
    # the affine scan at the ghost chunks' shape: one row per case segment
    # of a 524,288-row group, padded to a power of two with the tail case,
    # so the padding is one run of up to half the rows (stepped once per
    # row by the plain version, hence one timed call)
    g = ghosts[0]
    gm, ga = g[SK_MUL1].view(torch.int32), g[SK_ADD1].view(torch.int32)
    gadj = engine.adjacent(g, engine.init_row_carry("cuda"))
    gs = gadj.new_seg.contiguous()
    m = gm.shape[0]
    rows["segmented_affine/ghost_chunk"] = {
        "E": m,
        "ms": time_ms(torch, lambda i: so.segmented_affine_cuda(gm, ga, gs, c0), 1),
        "graph_ms": graph_ms(torch, lambda: [so.segmented_affine_cuda(gm, ga, gs, c0)], 1),
        "plain_ms": 1e3 * host_s(torch, lambda: so.segmented_affine_ref(gm, ga, gs, c0)),
        "longest_run": int(torch.diff(torch.nonzero(torch.cat([
            gs, torch.ones(1, dtype=torch.bool, device="cuda")]))[:, 0]).max()),
        "library_ms": None, **bound(13 * m, 2 * m)}
    torch.cuda.synchronize()
    return rows


def numpy_dfg(case: np.ndarray, act: np.ndarray, a: int):
    """Independent host oracle of the DFG of an all-valid sorted log."""
    same = case[1:] == case[:-1]
    key = act[:-1].astype(np.int64) * a + act[1:]
    counts = np.bincount(key[same], minlength=a * a).reshape(a, a)
    start = np.concatenate([[True], ~same])
    end = np.concatenate([~same, [True]])
    return (counts.astype(np.int32),
            np.bincount(act[start], minlength=a).astype(np.int32),
            np.bincount(act[end], minlength=a).astype(np.int32))


def numpy_stats(case: np.ndarray, act: np.ndarray, ts: np.ndarray, a: int,
                num_cases: int) -> dict:
    """Independent host oracles of the four statistics of an all-valid
    sorted log: ``bincount``, ``minimum/maximum.reduceat``, and the sojourn
    totals folded with ``np.add.at`` in float32 (row order)."""
    n = case.shape[0]
    same = np.concatenate([[False], case[1:] == case[:-1]])
    starts = np.flatnonzero(~same)
    sizes = np.zeros(num_cases, np.int32)
    sizes[:starts.size] = np.diff(np.append(starts, n))
    dur = np.zeros(num_cases, np.float32)
    dur[:starts.size] = (np.maximum.reduceat(ts, starts)
                         - np.minimum.reduceat(ts, starts))
    prev = np.concatenate([[0], act[:-1]]).astype(np.int64)
    prev_ts = np.concatenate([np.zeros(1, np.float32), ts[:-1]])
    dt = np.where(same, ts - prev_ts, np.float32(0)).astype(np.float32)
    tot = np.zeros(a, np.float32)
    np.add.at(tot, prev, dt)
    cnt = np.bincount(prev[same], minlength=a).astype(np.int32)
    return {"activity_counts": np.bincount(act, minlength=a).astype(np.int32),
            "case_sizes": sizes, "case_durations": dur,
            "sojourn_times": tot / np.maximum(cnt, 1).astype(np.float32)}


def ghost_chunk(torch, case: np.ndarray, act: np.ndarray, lo: int, hi: int):
    """The ghost chunk of rows [lo, hi) on the card, as the JAX package's
    query executor builds one for a row group a pruned scan skips: one
    all-masked row per case segment (its case id; activity 0 except on the
    tail row, which keeps the halo), padded to a power of two with the tail
    case, and each segment's composed affine polyhash maps in the sketch
    columns (identity maps on padding)."""
    from repro_torch.core import ACTIVITY, CASE, EventFrame, polyhash

    c, a = case[lo:hi], act[lo:hi]
    seg_cases = c[np.flatnonzero(np.concatenate([[True], c[1:] != c[:-1]]))]
    d = seg_cases.size
    m = 1 << (d - 1).bit_length()
    cc = np.full(m, c[-1], case.dtype)
    cc[:d - 1] = seg_cases[:d - 1]
    aa = np.zeros(m, act.dtype)
    aa[d - 1:] = a[-1]
    cols = {CASE: cc, ACTIVITY: aa,
            **polyhash.sketch_columns(polyhash.segment_sketch(a, c), d, m)}
    f = EventFrame.from_numpy(cols, device="cuda")
    return EventFrame(f.columns, f.valid,
                      torch.zeros(m, dtype=torch.bool, device="cuda"))


def numpy_performance(case: np.ndarray, act: np.ndarray, ts: np.ndarray,
                      a: int) -> dict:
    """Independent host oracles of the performance overlays of an all-valid
    sorted log: edge counts by ``bincount``; float32 wait totals folded with
    ``np.add.at`` in row order on the pair key; EFG pairs counted block by
    block over cases of one length, one position offset at a time; and the
    remaining time from ``np.maximum.reduceat``."""
    n = case.shape[0]
    same = case[1:] == case[:-1]
    key = act[:-1].astype(np.int64) * a + act[1:]
    counts = np.bincount(key[same], minlength=a * a).astype(np.int32)
    dt = ts[1:] - ts[:-1]
    total = np.zeros(a * a, np.float32)
    np.add.at(total, key[same], dt[same])
    mean = total / np.maximum(counts, 1).astype(np.float32)
    starts = np.flatnonzero(np.concatenate([[True], ~same]))
    lens = np.diff(np.append(starts, n))
    efg = np.zeros(a * a, np.int64)
    for length in np.unique(lens[lens > 1]):
        block = act[starts[lens == length][:, None] + np.arange(length)]
        for d in range(1, length):
            pair = block[:, :-d].astype(np.int64) * a + block[:, d:]
            efg += np.bincount(pair.ravel(), minlength=a * a)
    remaining = np.repeat(np.maximum.reduceat(ts, starts), lens) - ts
    return {"counts": counts.reshape(a, a), "mean_wait": mean.reshape(a, a),
            "efg": efg.reshape(a, a).astype(np.int32), "remaining": remaining}


def staged_stream(torch, kernel, path: str, columns, edf):
    """One more stream of ``kernel`` over the file, each stage synchronized:
    returns the result and the seconds spent reading + decoding on the host,
    copying to the card, and in the device update."""
    t_read = t_h2d = t_dev = 0.0
    state, carry = kernel.init("cuda")
    it = edf.read_streaming(path, columns=columns, device="cpu")
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        t_read += time.perf_counter() - t0
        if item is None:
            break
        t0 = time.perf_counter()
        chunk = item[0].to("cuda")
        torch.cuda.synchronize()
        t_h2d += time.perf_counter() - t0
        t0 = time.perf_counter()
        state, carry = kernel.update(state, carry, chunk)
        torch.cuda.synchronize()
        t_dev += time.perf_counter() - t0
    return kernel.finalize(state, carry), {
        "read_decode": t_read, "host_to_device": t_h2d, "device": t_dev}


def idle_share(torch, fn, wall_s: float) -> dict:
    """Device busy time of one more run of ``fn``, from a profiler trace;
    the idle share is against the unprofiled run's wall time."""
    prof = profile_device(torch, fn)
    busy_us = sum(t for _, t in prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:12]
    return {"stream_wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "top_device": [{"name": k[:80], "count": c, "us": t}
                           for k, (c, t) in top]}


def numpy_graph(dfg_oracle, a: int) -> np.ndarray:
    """The (a + 2, a + 2) int32 frequency matrix of the process graph: the
    DFG plus the artificial source row (starts) and sink column (ends)."""
    counts, starts, ends = dfg_oracle
    freq = np.zeros((a + 2, a + 2), np.int32)
    freq[:a, :a] = counts
    freq[a, :a] = starts
    freq[:a, a + 1] = ends
    return freq


def numpy_graph_queries(freq: np.ndarray, k: int) -> dict:
    """Independent host oracles of the graph queries over the frequency
    weights: reachability horizons by repeated boolean products (BFS
    layers), and Floyd–Warshall min-plus over hop costs and max-min over
    frequency capacities in float32 (as ``benchmarks/bench_graph.py``)."""
    n = freq.shape[0]
    adj = freq > 0
    eye = np.eye(n, dtype=bool)
    reach = [eye]
    for _ in range(n):
        reach.append(reach[-1] | (reach[-1].astype(np.int64)
                                  @ adj.astype(np.int64) > 0))
    d = np.where(eye, np.float32(0), np.where(adj, np.float32(1),
                                              np.float32(np.inf))).astype(np.float32)
    w = np.where(eye, np.float32(np.inf),
                 np.where(adj, freq.astype(np.float32),
                          np.float32(-np.inf))).astype(np.float32)
    for m in range(n):
        d = np.minimum(d, d[:, m, None] + d[None, m, :])
        w = np.maximum(w, np.minimum(w[:, m, None], w[None, m, :]))
    return {"reach": reach[n - 1], "reach_k": reach[min(k, n - 1)],
            "shortest": d, "widest": w,
            "in_degree": freq.sum(0).astype(np.int32),
            "out_degree": freq.sum(1).astype(np.int32)}


def numpy_l2_counts(case: np.ndarray, act: np.ndarray, a: int) -> np.ndarray:
    """Independent host oracle of the ``a, b, a`` triple counts of an
    all-valid sorted log: three consecutive rows of one case whose first
    and last activities agree."""
    same = case[1:] == case[:-1]
    tri = same[1:] & same[:-1] & (act[2:] == act[:-2])
    key = act[:-2].astype(np.int64) * a + act[1:-1]
    return np.bincount(key[tri], minlength=a * a).reshape(a, a).astype(np.int32)


def same_result(torch, label: str, got, want, flow_atol: float = 0.0) -> None:
    """Structural equality of two query / miner results: bitwise, except
    centrality ``flow`` within ``flow_atol`` (its normalized ``plus_times``
    matvecs add floats in each lowering's own order)."""
    import dataclasses

    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            same_result(torch, f"{label}.{f.name}", getattr(got, f.name),
                        getattr(want, f.name), flow_atol)
    elif isinstance(want, torch.Tensor):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if label.endswith(".flow") and flow_atol:
            if g.shape != w.shape or not np.allclose(g, w, rtol=0, atol=flow_atol):
                raise AssertionError(f"{label}: beyond atol {flow_atol}")
        else:
            check_equal(label, g, w)
    elif isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_result(torch, f"{label}[{k}]", got[k], want[k], flow_atol)
    elif isinstance(want, tuple) and any(isinstance(w, torch.Tensor) for w in want):
        if len(got) != len(want):
            raise AssertionError(f"{label}: {len(got)} != {len(want)} parts")
        for i, (g, w) in enumerate(zip(got, want)):
            same_result(torch, f"{label}[{i}]", g, w, flow_atol)
    elif got != want:
        raise AssertionError(f"{label}: {got!r} != {want!r}")


def graph_queries(tgraph, g) -> dict:
    """The graph path's queries over one compiled graph."""
    return {"reachability": lambda: tgraph.reachability(g),
            "reachability_k3": lambda: tgraph.reachability(g, 3),
            "bottleneck_paths": lambda: tgraph.bottleneck_paths(g),
            "bottleneck_paths_performance":
                lambda: tgraph.bottleneck_paths(g, "performance"),
            "node_centrality": lambda: tgraph.node_centrality(g)}


def closure_bound(torch, go, kind: str, x, k=None) -> dict:
    """The least time of one closure on the whole card: its input read and
    its result written once, against the SIMT issue slots the closure loop's
    schedule needs on these inputs (``closure_plan``, replayed with plain
    products): N^3 tropical candidates a squaring; a boolean product one OR
    of a row of words for each set bit of the other operand's rows."""
    n = x.shape[0]
    if kind != "bool":
        squarings = len(go.closure_plan(n)[1])
        return bound(8 * n * n, CANDIDATE_SLOTS[kind] * squarings * float(n) ** 3,
                     SIMT_SLOTS_PER_S)
    from_seed, steps = go.closure_plan(n, k)
    seed = torch.eye(n, dtype=torch.bool, device=x.device) | x.to(torch.bool)
    acc = seed if from_seed else torch.eye(n, dtype=torch.bool, device=x.device)
    sq, words, ors = seed, -(-n // 32), 0

    def times(p, q):
        return go.semiring_matmul_ref(p.float(), q.float(), "plus_times") > 0

    for op in steps:
        lhs = sq if op == 2 else acc
        ors += int(lhs.sum()) * words
        if op == 2:
            sq = times(sq, sq)
        else:
            acc = times(acc, acc if op == 0 else sq)
    return bound(2 * n * n, OR_SLOTS * float(ors), SIMT_SLOTS_PER_S)


def time_semiring_kernels(torch, g) -> dict:
    """The semiring kernels at the graph path's shapes, on the L1 graph's own
    operands: a squaring of the 28-node closures' seeds (the reflexive 0/1
    adjacency for plus_times, hop costs for min_plus, frequency capacities
    for max_min) and the (1, 28) row by (28, 28) product (centrality's
    matvec for plus_times, the source row for the tropical ones); and
    random integer-valued operands with holes at the JAX package's graph
    benchmark's 384 nodes (density 0.5).  ``library_ms`` (and
    ``library_graph_ms``, replayed from a CUDA graph) is one
    ``torch.matmul`` (cuBLAS, full float32) for plus_times; no PyTorch call
    computes a tropical product.  Operation bounds count SIMT issue slots
    (``CANDIDATE_SLOTS``).

    Closures, through the public functions (``CLOSURE_CASES``): the L1
    graph's (28 nodes, plus shortest paths over its performance weights)
    and the JAX graph benchmark's at 48 and 128 nodes, host-included
    (``ms``) and graph-replayed (``graph_ms``), with the launches and device
    nodes one call makes, beside the loop of plain products (``plain_ms``;
    trees with ``impl=``); no PyTorch call computes a closure.  Then
    (trees with the closure kernel) the kernel against the loop of tiled
    products at ``CLOSURE_SWEEP``, host-included, and the largest N at
    which the kernel is no slower for every kind."""
    from repro_torch.kernels import graph_ops as go

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on")
    n = g.num_nodes
    eye = torch.eye(n, dtype=torch.bool, device="cuda")
    adj = g.adjacency
    f = g.freq.to(torch.float32)
    rowsum = f.sum(1, keepdim=True)
    p = torch.where(rowsum > 0, f / rowsum.clamp(min=1.0), 0.0)
    seeds = {"plus_times": (eye | adj).to(torch.float32),
             "min_plus": torch.where(eye, 0.0, torch.where(adj, 1.0, float("inf"))),
             "max_min": torch.where(eye, float("inf"),
                                    torch.where(adj, f, float("-inf")))}
    rows = {"plus_times": (torch.full((1, n), 1.0 / n, device="cuda"), p)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    big = 384
    keep = torch.rand((big, big), generator=gen, device="cuda") < 0.5
    vals = torch.randint(1, 1000, (big, big), generator=gen, device="cuda").float()
    dense = {"plus_times": torch.where(keep, vals, 0.0),
             "min_plus": torch.where(keep, vals, float("inf")),
             "max_min": torch.where(keep, vals, float("-inf"))}
    out = {}
    for semiring in SEMIRINGS:
        sq = seeds[semiring]
        cases = {f"{n}x{n}x{n}": (sq, sq),
                 f"1x{n}x{n}": rows.get(semiring, (sq[g.source:g.source + 1], sq)),
                 f"{big}x{big}x{big}": (dense[semiring], dense[semiring])}
        for shape, (a, b) in cases.items():
            m, k = a.shape
            nn = b.shape[1]
            kern = (lambda a=a, b=b, s=semiring: go.semiring_matmul_cuda(a, b, s))
            row = {"M": m, "K": k, "N": nn,
                   "ms": time_ms(torch, lambda i: kern(), 1),
                   "graph_ms": graph_ms(torch, lambda: [kern() for _ in range(20)], 20),
                   "plain_ms": time_ms(torch, lambda i, a=a, b=b, s=semiring:
                                       go.semiring_matmul_ref(a, b, s), 1, iters=50),
                   "library_ms": None,
                   **bound(4 * (m * k + k * nn + m * nn),
                           CANDIDATE_SLOTS[semiring] * m * nn * k, SIMT_SLOTS_PER_S)}
            if semiring == "plus_times":
                lib = (lambda a=a, b=b: torch.matmul(a, b))
                row["library_ms"] = time_ms(torch, lambda i: lib(), 1)
                row["library_graph_ms"] = graph_ms(
                    torch, lambda: [lib() for _ in range(20)], 20)
            out[f"semiring_matmul/{semiring}/{shape}"] = row

    kern = getattr(go, "semiring_closure_cuda", None)
    has_kernel = kern is not None

    def counts():
        return (kern.launches if has_kernel else 0, go.semiring_matmul_cuda.launches)

    graphs = {n: {"bool": adj, "min_plus": torch.where(adj, 1.0, float("inf")),
                  "max_min": torch.where(adj, f, float("-inf")),
                  "min_plus_perf": torch.where(adj, g.perf, float("inf"))}}
    for size in CLOSURE_SIZES[1:]:
        a_np, cap_np, cost_np = bench_graph(size)
        graphs[size] = {"bool": torch.from_numpy(a_np).cuda(),
                        "min_plus": torch.from_numpy(cost_np).cuda(),
                        "max_min": torch.from_numpy(cap_np).cuda()}
    for size, xs in graphs.items():
        cases = [(kind, k, kind) for kind, k in CLOSURE_CASES]
        if size == n:
            cases += [("bool", n - 1, "bool"), ("min_plus", None, "min_plus_perf")]
        for kind, k, label in cases:
            x = xs[label]
            fn = (lambda kind=kind, x=x, k=k: closure(go, kind, x, k))
            c0 = counts()
            fn()
            c1 = counts()
            name = label if kind != "bool" else f"bool_k{'None' if k is None else k}"
            row = {"N": size, "k": k,
                   "launches": {"closure": c1[0] - c0[0], "products": c1[1] - c0[1]},
                   "ms": time_ms(torch, lambda i: fn(), 1),
                   "graph_ms": graph_ms(torch, lambda fn=fn: [fn() for _ in range(20)], 20),
                   **graph_nodes(torch, fn), "library_ms": None}
            if has_kernel:
                row["plain_ms"] = time_ms(torch, lambda i: closure(go, kind, x, k, "ref"),
                                          1, iters=20)
                row.update(closure_bound(torch, go, kind, x, k))
            out[f"semiring_closure/{name}/N{size}"] = row
    if has_kernel:
        loop_wins = {}
        swept = [size for size in CLOSURE_SWEEP if size <= go.CLOSURE_CAPACITY]
        for size in swept:
            a_np, cap_np, cost_np = bench_graph(size)
            for kind, x_np in (("bool", a_np), ("min_plus", cost_np), ("max_min", cap_np)):
                x = torch.from_numpy(x_np).cuda()
                k = size - 1 if kind == "bool" else None
                kern_ms = time_ms(torch, lambda i: go.semiring_closure_cuda(x, kind, k), 1,
                                  iters=50)
                loop_ms = time_ms(torch, lambda i: go.ref.closure_loop(
                    x, kind, k, go.semiring_matmul_cuda), 1, iters=50)
                out[f"semiring_closure/sweep/{kind}/N{size}"] = {
                    "N": size, "k": k, "kernel_ms": kern_ms, "loop_ms": loop_ms}
                if loop_ms < kern_ms:
                    loop_wins.setdefault(kind, size)
        smallest = min(loop_wins.values(), default=None)
        out["semiring_closure/crossover"] = {
            "CLOSURE_MAX_N": go.CLOSURE_MAX_N,
            "first_swept_N_where_the_loop_wins": loop_wins,
            "largest_swept_N_where_the_kernel_wins_every_kind": max(
                [sz for sz in swept if smallest is None or sz < smallest],
                default=None)}
    torch.cuda.synchronize()
    return out


def time_graph_queries(torch, tgraph, g) -> dict:
    """Each of the graph path's queries on ``g``: the closure and product
    launches one call makes, and its finalize time on the host clock,
    synchronized (the median of 9 calls)."""
    from repro_torch.kernels import graph_ops as go

    kern = getattr(go, "semiring_closure_cuda", None)
    out = {}
    for name, q in graph_queries(tgraph, g).items():
        q()
        torch.cuda.synchronize()
        c0 = (kern.launches if kern else 0, go.semiring_matmul_cuda.launches)
        q()
        torch.cuda.synchronize()
        out[name] = {"closure_launches": (kern.launches if kern else 0) - c0[0],
                     "product_launches": go.semiring_matmul_cuda.launches - c0[1],
                     "query_ms": 1e3 * float(np.median([host_s(torch, q)
                                                        for _ in range(9)]))}
    return out


def l1_graph(torch, tgraph, synthetic, cols_names):
    """The L1 log's timed process graph from numpy (the DFG and its mean
    waits, float32 totals folded in row order), on the card: the graph
    path's graph, without the mining kernels."""
    case_c, act_c, ts_c = cols_names
    cols, _ = synthetic.generate_numpy(**synthetic.paper_table6_config(1))
    case, act, ts = cols[case_c], cols[act_c], cols[ts_c]
    a = NUM_ACTIVITIES
    freq = numpy_graph(numpy_dfg(case, act, a), a)
    same = case[1:] == case[:-1]
    key = (act[:-1].astype(np.int64) * a + act[1:])[same]
    total = np.zeros(a * a, np.float32)
    np.add.at(total, key, (ts[1:] - ts[:-1])[same].astype(np.float32))
    counts = np.bincount(key, minlength=a * a).astype(np.float32)
    perf = np.zeros((a + 2, a + 2), np.float32)
    perf[:a, :a] = (total / np.maximum(counts, 1)).reshape(a, a)
    return tgraph.ProcessGraph.from_numpy(freq, a, perf, device="cuda")


def instantiation(d: int) -> int:
    """The kernels' head dim that runs ``d`` (the smallest one at least d)."""
    return next(n for n in (16, 32, 64, 128, 256) if n >= d)


def time_flash_attention(torch) -> dict:
    """The flash-attention kernel at the serving path's long prefill shape,
    rounded up to whole tiles: q, k, v ``FLASH_TIMED``, causal, in bf16 (the
    ``wgmma`` route) and in float32 (the 3xTF32 ``mma.sync`` route); then
    the same at ``FLASH_TIMED_HEAD_DIMS`` (keys ending in ``_d96`` /
    ``_d256``), and the forward at Whisper's non-causal shapes
    (``FLASH_TIMED_WHISPER``, keys ending in their labels).  ``library_ms`` / ``library_graph_ms`` are
    ``scaled_dot_product_attention`` on the same inputs, a yardstick the port
    never calls.  The bound counts q, k, v read and o written once, and the
    two products over the causal pairs only, at the true head dim: at the
    bf16 tensor-core rate (bf16; all Sq x Sk pairs where not causal), or as
    three TF32 products each at the TF32
    rate (float32; ``simt_bound_ms`` is the same operations once each at the
    float32 rate outside the tensor cores).  ``padded_ops_share`` is the
    share of the products the kernel runs on zero columns (d below its
    instantiation)."""
    b, h, s, d = FLASH_TIMED
    rows = time_flash_shape(torch, b, h, h, s, d, "")
    rows.update(time_flash_attention_bwd(torch, b, h, h, s, d, ""))
    for label, b, h, kvh, s, d in FLASH_TIMED_HEAD_DIMS:
        rows.update(time_flash_shape(torch, b, h, kvh, s, d, "_" + label))
        rows.update(time_flash_attention_bwd(torch, b, h, kvh, s, d, "_" + label))
    for label, b, h, kvh, sq, sk, d in FLASH_TIMED_WHISPER:
        rows.update(time_flash_shape(torch, b, h, kvh, sk, d, "_" + label, sq=sq,
                                     causal=False))
    for label, b, h, kvh, sq, sk, d, causal in FLASH_TIMED_TRAIN:
        rows.update(time_flash_attention_bwd(torch, b, h, kvh, sk, d, "_" + label, sq=sq,
                                             causal=causal))
    torch.cuda.synchronize()
    return rows


def head_dim_rows(times: dict, prefix: str) -> dict:
    """The ``FLASH_TIMED_HEAD_DIMS`` rows of ``prefix`` for the kernels line."""
    labels = tuple("_" + label for label, *_ in FLASH_TIMED_HEAD_DIMS)
    return {key[len(prefix):]: {f: times[key][f] for f in (
        "B", "H", "KVH", "S", "D", "instantiation", "padded_ops_share", "ms", "graph_ms",
        "nodes_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_graph_ms")
        if f in times[key]}
        for key in times if key.startswith(prefix) and key.endswith(labels)}


def time_flash_shape(torch, b, h, kvh, s, d, suffix: str, *, sq=None,
                     causal: bool = True) -> dict:
    """The forward rows of ``time_flash_attention`` at one shape: ``s`` keys
    and ``sq`` (default ``s``) queries."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sq = s if sq is None else sq
    pairs = s * (s + 1) // 2 if causal else sq * s
    ops = 4 * d * pairs * b * h
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((b, kvh, s, d), generator=gen, device="cuda").to(dt)
                for _ in range(2))

        def kern(q=q, k=k, v=v):
            return fa.flash_attention_cuda(q, k, v, causal=causal)

        def sdpa(q=q, k=k, v=v):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=kvh != h)

        nbytes = 2 * (b * h * sq + b * kvh * s) * d * q.element_size()
        row = {"B": b, "H": h, "KVH": kvh, "S": s, "Sq": sq, "D": d, "dtype": dtype,
               "causal": causal,
               "instantiation": instantiation(d),
               "padded_ops_share": 1 - d / instantiation(d),
               "ms": time_ms(torch, lambda i: kern(), 1, iters=50),
               "graph_ms": graph_ms(torch, lambda: [kern() for _ in range(5)], 5,
                                    replays=10),
               "plain_ms": time_ms(torch, lambda i: fa.flash_attention_ref(
                   q, k, v, causal=causal), 1, iters=10),
               "library_ms": time_ms(torch, lambda i: sdpa(), 1, iters=50),
               "library_graph_ms": graph_ms(torch, lambda: [sdpa() for _ in range(5)], 5,
                                            replays=10)}
        if dtype == "bfloat16":
            row.update(bound(nbytes, ops, BF16_TENSOR_OPS_PER_S))
        else:
            row.update(bound(nbytes, 3 * ops, TF32_TENSOR_OPS_PER_S))
            simt = bound(nbytes, ops, SCALAR_OPS_PER_S)
            row.update(simt_bound_ms=simt["bound_ms"], simt_bound_by=simt["bound_by"])
        route = "" if dtype == "bfloat16" else "_float32"
        rows[f"flash_attention/prefill_{s}{route}{suffix}"] = row
    return rows


def time_flash_attention_bwd(torch, b, h, kvh, s, d, suffix: str, *, sq=None,
                             causal: bool = True) -> dict:
    """The backward kernel at ``FLASH_TIMED``, causal, in bf16 and float32:
    one call (three kernel nodes), and each node's device time from a
    profile of five calls (``nodes_ms``: Delta, dK/dV, dQ; None where the
    trace shows no such kernel).  ``library_ms``
    is the backward of ``scaled_dot_product_attention`` under autograd on
    the same inputs (``torch.autograd.grad`` of a forward run once), a
    yardstick the port never calls, and ``library_graph_ms`` the same call
    replayed from a CUDA graph (the forward run on the capture stream, where
    autograd runs its backward; ``library_ops`` names the aten kernels it
    launches); ``plain_ms`` the plain backward on the card.  The bound
    counts q, k, v, o, dO read and dq, dk, dv written once, and the five
    products of the backward over the causal pairs: at the bf16 tensor-core
    rate (bf16), or as three TF32 products each (float32;
    ``simt_bound_ms`` the same operations once each on the SIMT cores).
    At (B, H, KVH, S, D), keys ending in ``suffix``; ``sq`` queries (default
    ``s``) and, with ``causal`` False, all Sq x S pairs."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    sq = s if sq is None else sq
    pairs = s * (s + 1) // 2 if causal else sq * s
    ops = 5 * 2 * d * pairs * b * h
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, do = (torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn((b, kvh, s, d), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)

        def kern(q=q, k=k, v=v, o=o, lse=lse, do=do):
            return fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)

        def plain(q=q, k=k, v=v, o=o, lse=lse, do=do):
            return fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=kvh != h)
        torch.cuda.current_stream().wait_stream(side)

        def library(out=sdpa_out, leaves=leaves, do=do):
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        kern()
        torch.cuda.synchronize()
        for _ in range(2):   # a trace that shows none of the nodes is taken again
            nodes = profile_device(torch, lambda: [kern() for _ in range(5)])
            nodes_ms = {label: sum(us for key, (_, us) in nodes.items() if name in key) / 5e3
                        or None for label, name in (("delta", "attn_bwd_delta"),
                                                    ("dkdv", "attn_bwd_dkdv"),
                                                    ("dq", "attn_bwd_dq"))}
            if any(nodes_ms.values()):
                break
        lib_ops = sorted(key for key in profile_device(torch, library))
        try:
            lib_graph = graph_ms(torch, lambda: [library() for _ in range(3)], 3, replays=5,
                                 stream=side)
            lib_graph_error = None
        except RuntimeError as e:   # a capture the autograd call does not allow
            lib_graph, lib_graph_error = None, str(e).splitlines()[0]
        nbytes = 4 * (b * h * sq + b * kvh * s) * d * q.element_size()
        row = {"B": b, "H": h, "KVH": kvh, "S": s, "Sq": sq, "D": d, "dtype": dtype,
               "causal": causal,
               "instantiation": instantiation(d),
               "padded_ops_share": 1 - d / instantiation(d),
               "ms": time_ms(torch, lambda i: kern(), 1, iters=20),
               "graph_ms": graph_ms(torch, lambda: [kern() for _ in range(3)], 3,
                                    replays=5),
               "nodes_ms": nodes_ms,
               "plain_ms": time_ms(torch, lambda i: plain(), 1, iters=3),
               "library_ms": time_ms(torch, lambda i: library(), 1, iters=20),
               "library_graph_ms": lib_graph, "library_ops": lib_ops}
        if lib_graph_error is not None:
            row["library_graph_error"] = lib_graph_error
        if dtype == "bfloat16":
            row.update(bound(nbytes, ops, BF16_TENSOR_OPS_PER_S))
        else:
            row.update(bound(nbytes, 3 * ops, TF32_TENSOR_OPS_PER_S))
        simt = bound(nbytes, ops, SCALAR_OPS_PER_S)
        row.update(simt_bound_ms=simt["bound_ms"], simt_bound_by=simt["bound_by"])
        route = "" if dtype == "bfloat16" else "_float32"
        rows[f"flash_attention_bwd/{s}{route}{suffix}"] = row
        del leaves, sdpa_out, side
    return rows


def greedy_trace(torch, engine, prompts, steps: int, frontend=None):
    """``engine.generate``'s greedy tokens, and for each the top-2 margin of
    the logits that chose it and the top logit's magnitude."""
    logits, cache = engine.prefill(prompts, frontend)
    toks, margins, tops = [], [], []
    for _ in range(steps):
        top = logits.float().topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        tops.append(top[:, 0].abs())
        tok = logits.argmax(-1)[:, None]
        toks.append(tok[:, 0])
        logits, cache = engine.decode(cache, tok)
    return (torch.stack(toks, 1).to(torch.int32).cpu().numpy(),
            torch.stack(margins, 1).cpu().numpy(), torch.stack(tops, 1).cpu().numpy())


def token_stream(torch):
    """The tokenized synthetic log ``launch/serve.py`` builds its prompts
    from (32 activities, seed 0), on the card; and its build seconds."""
    from repro_torch.core.eventframe import ACTIVITY
    from repro_torch.data import pipeline, synthetic, tokenizer

    t0 = time.perf_counter()
    frame, tables = synthetic.generate(num_cases=2_000, num_activities=32, seed=0,
                                       device="cuda")
    tok = tokenizer.ActivityTokenizer(tables[ACTIVITY])
    stream = pipeline.frame_to_token_stream(frame, tok)
    torch.cuda.synchronize()
    return stream, time.perf_counter() - t0


def random_model(torch, cfg):
    """``cfg``'s model with random weights from seed 0, on the card."""
    from repro_torch.models import model as Mdl
    from repro_torch.models.module import Initializer

    return Mdl.init_params(cfg, Initializer(
        torch.Generator(device="cuda").manual_seed(0), cfg.param_dtype))


def serve_runs(torch, cfg, model, stream, batches, name: str, *, mesh=None,
               step_profile: bool = False, frontend=None,
               expect: tuple[int, int] | None = None) -> tuple[list, dict]:
    """``model`` served by ``serve.engine.Engine`` at each of ``batches``
    ((label, requests, prompt length, stride, steps, max_len)) in float32
    and bf16 compute, held against the same engine and weights with
    ``attn_impl="ref"``: prefill logits within ``SERVE_LOGIT_ATOL``, greedy
    tokens identical (bf16: up to a request's first divergence at a top-2
    margin of at most ``SERVE_MARGIN``), the kernel exactly ``expect`` =
    (launches a prefill, launches a decode step) times, by default once a
    prefill layer and never in decode.  ``frontend(requests)`` gives the
    vlm / audio frontend of a batch.  Returns the runs and the launch
    counts of the driven ``generate`` calls (counts set to 0 just before
    each and read after).  ``step_profile`` adds the idle share of one
    decode step."""
    from repro_torch.serve.engine import Engine

    per_prefill, per_step = expect or (cfg.num_layers, 0)
    vocab = cfg.vocab_size
    runs, total = [], {}
    for label, requests, plen, stride, steps, max_len in batches:
        prompts = np.stack([stream[i * stride:i * stride + plen] for i in range(requests)])
        if prompts.shape != (requests, plen):
            raise AssertionError(f"stream of {len(stream)} tokens too short for {label}")
        fe = frontend(requests) if frontend else None
        for compute in ("float32", "bfloat16"):
            c = cfg.with_overrides(compute_dtype=compute)
            engine = Engine(c, model, max_len=max_len, device="cuda", mesh=mesh)
            plain = Engine(c.with_overrides(attn_impl="ref"), model, max_len=max_len,
                           device="cuda", mesh=mesh)
            what = f"{name} ({label}) {compute}"
            engine.generate(prompts, steps, frontend=fe)    # warm-up
            torch.cuda.synchronize()

            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = engine.generate(prompts, steps, frontend=fe)
            torch.cuda.synchronize()
            t_gen = time.perf_counter() - t0
            run_l = read_launches()
            peak = torch.cuda.max_memory_allocated()
            for kernel, n in run_l.items():
                total[kernel] = total.get(kernel, 0) + n
            # the kernel exactly per_prefill times a prefill, per_step a step
            reset_launches()
            logits, cache = engine.prefill(prompts, fe)
            torch.cuda.synchronize()
            pre_l = read_launches()["flash_attention"]
            engine.decode(cache, logits.argmax(-1)[:, None])
            torch.cuda.synchronize()
            dec_l = read_launches()["flash_attention"] - pre_l
            if (run_l["flash_attention"] != per_prefill + steps * per_step
                    or pre_l != per_prefill or dec_l != per_step):
                raise AssertionError(f"{what} did not go through the kernel {per_prefill} "
                                     f"times a prefill and {per_step} a decode step: "
                                     f"generate {run_l}, prefill {pre_l}, decode {dec_l}")

            def decode_loop(logits=logits, cache=cache):
                nxt = logits.argmax(-1)[:, None]
                for _ in range(steps):
                    step_logits, cache = engine.decode(cache, nxt)
                    nxt = step_logits.argmax(-1)[:, None]

            prefill_s = float(np.median([host_s(torch, lambda: engine.prefill(prompts, fe))
                                         for _ in range(3)]))
            decode_s = host_s(torch, decode_loop)

            want_logits, _ = plain.prefill(prompts, fe)
            want_tokens, margins, tops = greedy_trace(torch, plain, prompts, steps, fe)
            if (tuple(logits.shape) != (requests, vocab)
                    or not bool(torch.isfinite(logits).all())
                    or res.tokens.shape != (requests, steps)
                    or res.tokens.min() < 0 or res.tokens.max() >= vocab):
                raise AssertionError(f"{what}: logits {tuple(logits.shape)} / tokens "
                                     f"{res.tokens.shape} malformed or not finite")
            diff = (logits.float() - want_logits.float()).abs()
            err = float(diff.max())
            tol = torch.full_like(diff[:, :1], SERVE_LOGIT_ATOL[compute])
            if compute == "bfloat16":
                tol = torch.maximum(tol, SERVE_BF16_REL * want_logits.float().abs().amax(
                    1, keepdim=True))
            ratio = float((diff / tol).max())
            if not ratio <= 1.0:
                raise AssertionError(f"{what}: prefill logits {err} from the plain "
                                     f"attention's, {ratio} x the gate")
            agree = compared = diverged = 0
            for r in range(requests):
                for i in range(steps):
                    compared += 1
                    if res.tokens[r, i] == want_tokens[r, i]:
                        agree += 1
                        continue
                    gate = max(SERVE_MARGIN, SERVE_BF16_REL * tops[r, i])
                    if compute == "float32" or margins[r, i] > gate:
                        raise AssertionError(
                            f"{what}: request {r} step {i} token {res.tokens[r, i]} != "
                            f"plain {want_tokens[r, i]} at top-2 margin {margins[r, i]}")
                    diverged += 1
                    break            # later tokens follow different prefixes
            runs.append({
                "batch": label, "compute_dtype": compute, "requests": requests,
                "prompt_len": plen, "steps": steps, "max_len": max_len,
                "generate_s": t_gen, "prefill_s": prefill_s,
                "prefill_tokens_per_s": requests * plen / prefill_s,
                "decode_s": decode_s, "decode_tokens_per_s": requests * steps / decode_s,
                "decode_ms_per_step": decode_s / steps * 1e3,
                "max_memory_allocated": peak,
                "prefill_logits_max_abs_err": err,
                "prefill_logits_atol": SERVE_LOGIT_ATOL[compute],
                "prefill_logits_gate_ratio": ratio,
                "tokens": requests * steps, "tokens_compared": compared,
                "tokens_agree": agree, "diverged_at_small_margin": diverged,
                "launches": {"generate": run_l["flash_attention"], "prefill": pre_l,
                             "decode_step": dec_l}})
            if fe is not None:
                runs[-1]["frontend_rows"] = int(fe.shape[1])
            if compute == cfg.compute_dtype:      # the configuration as published
                runs[-1]["profile"] = {
                    "prefill": idle_share(torch, lambda: engine.prefill(prompts, fe),
                                          prefill_s)}
                if step_profile:
                    nxt = logits.argmax(-1)[:, None]
                    step_s = float(np.median([host_s(torch, lambda: engine.decode(cache, nxt))
                                              for _ in range(3)]))
                    runs[-1]["profile"]["decode_step"] = idle_share(
                        torch, lambda: engine.decode(cache, nxt), step_s)
                else:
                    runs[-1]["profile"]["decode"] = idle_share(torch, decode_loop, decode_s)
            del engine, plain, logits, cache, want_logits
    return runs, total


def add_launches(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in set(total) | set(more)}


def serve_path(torch, smi: str) -> tuple[dict, dict]:
    """EventLM serving at full width (see the module docstring), then the
    head dims between and above the kernels' first instantiations served
    at full width (``HEAD_DIM_ARCHS``, batch (a)), and ``attn_p_dtype``
    bf16 through the kernel (``p_dtype_check``).  Returns the phase line
    and the launch counts of the driven runs."""
    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = random_model(torch, cfg)
    stream, _ = token_stream(torch)
    setup_s = time.perf_counter() - t0
    runs, total = serve_runs(torch, cfg, model, stream, SERVE_BATCHES, "serve_path")
    del model
    head_dims = []
    for arch, layers in HEAD_DIM_ARCHS:
        c = get_config(arch).with_overrides(num_layers=layers)
        m = random_model(torch, c)
        hd_runs, more = serve_runs(torch, c, m, stream, SERVE_BATCHES[:1],
                                   f"serve_path {arch}")
        total = add_launches(total, more)
        entry = {"arch": arch, "layers": layers, "layers_published":
                 get_config(arch).num_layers, "head_dim": c.resolved_head_dim,
                 "d_model": c.d_model, "heads": c.num_heads, "kv_heads": c.num_kv_heads,
                 "layer_kinds": list(c.layer_kinds()), "params": c.param_count(),
                 "runs": hd_runs}
        if arch == P_DTYPE_ARCH:
            entry["p_dtype"], more = p_dtype_check(torch, c, m, stream)
            total = add_launches(total, more)
        head_dims.append(entry)
        del m
        torch.cuda.empty_cache()
    phase = {"phase": "serve_path", "arch": cfg.name, "layers": cfg.num_layers,
             "d_model": cfg.d_model, "heads": cfg.num_heads, "head_dim":
             cfg.resolved_head_dim, "vocab": cfg.vocab_size, "params": cfg.param_count(),
             "stream_tokens": int(len(stream)), "setup_s": setup_s, "runs": runs,
             "head_dim_configs": head_dims,
             "reference": "same engine and weights, attn_impl='ref'",
             "nvidia_smi": smi}
    return phase, total


def p_dtype_check(torch, cfg, model, stream) -> tuple[dict, dict]:
    """``attn_p_dtype="bfloat16"`` on the card: one float32 prefill of batch
    (a) through the engine (the kernel once a layer, finite logits), and
    the first layer's attention on that batch's own q, k, v through the
    kernel against the plain chunked attention with the same ``p_dtype``,
    on the card, within ``2 P_DTYPE_UNIT max|v| + FLASH_ATOL``."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as Mdl
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    c = cfg.with_overrides(compute_dtype="float32", attn_p_dtype="bfloat16")
    _, requests, plen, stride, _, max_len = SERVE_BATCHES[0]
    prompts = np.stack([stream[i * stride:i * stride + plen] for i in range(requests)])
    engine = Engine(c, model, max_len=max_len, device="cuda")
    reset_launches()
    logits, _ = engine.prefill(prompts)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["flash_attention"] != c.num_layers or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"attn_p_dtype=bfloat16 prefill: launches {launches}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device="cuda").long()
        h = Mdl._embed(c, model, tokens)
        window, theta = T.layer_window_theta(c, c.layer_kinds()[0])
        positions = torch.arange(plen, device="cuda")
        q, k, v = L.attn_qkv(model.layers[0].attn, L.rmsnorm(h, model.layers[0].ln1), c,
                             positions, theta)
        reset_launches()
        got = A.attention(q, k, v, impl="chunked", window=window, p_dtype=torch.bfloat16)
        more = read_launches()
        want = A.attention_chunked(q, k, v, window=window, chunk=c.attn_chunk,
                                   p_dtype=torch.bfloat16)
    err = float((got - want).abs().max())
    tol = 2 * P_DTYPE_UNIT["bfloat16"] * float(v.abs().max()) + FLASH_ATOL["float32"]
    if more["flash_attention"] != 1 or not err <= tol:
        raise AssertionError(f"attn_p_dtype=bfloat16 attention: launches {more}, max abs "
                             f"err {err} > {tol} against the plain chunked path")
    return ({"arch": cfg.name, "prefill_launches": launches["flash_attention"],
             "attention_max_abs_err": err, "tolerance": tol}, add_launches(launches, more))


def moe_layer_check(torch, cfg, model, shape) -> dict:
    """Layer 0's MoE in float32 on tokens of ``shape`` (B, S) drawn from
    seed ``SEED``: on the card against the CPU (routes where decisive,
    outputs of tokens routed and kept alike; ``MOE_LAYER_ATOL``), and
    ``moe_apply_ep`` on meshes of ``MOE_EP_SHARDS`` shards of the card
    against the dense dispatch (``MOE_EP_ATOL``)."""
    from repro_torch.distributed.mesh import mesh_for
    from repro_torch.models import layers as L
    from repro_torch.models.moe_ep import moe_apply_ep

    c = cfg.with_overrides(compute_dtype="float32")
    D, E, K = c.d_model, c.num_experts, c.num_experts_per_tok
    b, s = shape
    x = torch.randn((b, s, D), generator=torch.Generator().manual_seed(SEED))
    p_gpu = model.layers[0].moe
    p_cpu = {k: t.detach().cpu() for k, t in p_gpu.items()}
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = L.moe_apply_dense(p_gpu, x.cuda(), c)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = L.moe_apply_dense(p_cpu, x, c)
        cpu_s = time.perf_counter() - t0
        xt = x.reshape(-1, D)
        routes = {}
        for side, xx, p in (("card", xt.cuda(), p_gpu), ("cpu", xt, p_cpu)):
            _, idx = L.route(xx, p["router"], c)
            _, keep = L.dispatch_slots(idx.reshape(-1), E, L.capacity(c, xt.shape[0]))
            routes[side] = (idx.cpu(), keep.cpu().reshape(-1, K))
        logits = (xt @ p_cpu["router"]).sort(dim=-1, descending=True).values
        gap = logits[:, K - 1] - logits[:, K]
        bound = 2 * D * 2.0 ** -24 * (xt.abs() @ p_cpu["router"].abs()).amax(1)
        decisive = gap > bound
        (gi, gk), (ci, ck) = routes["card"], routes["cpu"]
        same_route = (gi.sort(1).values == ci.sort(1).values).all(1)
        if not bool(same_route[decisive].all()):
            raise AssertionError(f"moe layer: {int((~same_route & decisive).sum())} tokens "
                                 f"routed differently on the card at a decisive gap")
        # a token's slots count the tokens before it, so one differing route
        # can change later drops; compare the tokens routed and kept alike
        alike = same_route & (gk.sort(1).values == ck.sort(1).values).all(1)
        if bool(same_route.all()) and not bool(alike.all()):
            raise AssertionError("moe layer: identical routes, different drops")
        diff = (got.cpu().reshape(-1, D) - want.reshape(-1, D)).abs()
        err = float(diff[alike].max())
        if not err <= MOE_LAYER_ATOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"moe layer on the card != CPU: max abs err {err}")
        ep = []
        c_ep = c.with_overrides(moe_impl="shard_map")
        for n in MOE_EP_SHARDS:
            t0 = time.perf_counter()
            sharded = moe_apply_ep(p_gpu, x.cuda(), c_ep, mesh_for(n, "cuda"))
            torch.cuda.synchronize()
            ep_s = time.perf_counter() - t0
            ep_err = float((sharded - got).abs().max())
            if not ep_err <= MOE_EP_ATOL:
                raise AssertionError(f"moe_apply_ep at {n} shards != dense: {ep_err}")
            ep.append({"shards": n, "max_abs_err": ep_err, "seconds": ep_s})
    return {"shape": [b, s, D], "tokens": int(xt.shape[0]), "capacity": L.capacity(c, xt.shape[0]),
            "decisive_tokens": int(decisive.sum()), "routes_differ": int((~same_route).sum()),
            "dropped_rows_card": int((~gk).sum()), "compared_tokens": int(alike.sum()),
            "max_abs_err": err, "atol": MOE_LAYER_ATOL, "card_s": card_s, "cpu_s": cpu_s,
            "expert_parallel": ep, "ep_atol": MOE_EP_ATOL}


def moe_path(torch, smi: str) -> tuple[dict, dict]:
    """The MoE family served at full width (``MOE_RUNS``), each through
    ``serve_runs`` (the flash-attention kernel once a prefill layer, none
    in decode; a decode step's idle share), then one MoE layer on the card
    against the CPU and expert parallelism over 1, 2, 4 and 8 shards of the
    card (``moe_layer_check``: at batch (b)'s prefill shape for qwen3,
    (a)'s for mixtral).  Returns the phase line and the launch counts."""
    from repro_torch.configs import get_config

    stream, _ = token_stream(torch)
    models, total = [], {}
    for arch, layers, batches in MOE_RUNS:
        cfg = get_config(arch).with_overrides(num_layers=layers)
        t0 = time.perf_counter()
        model = random_model(torch, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        runs, more = serve_runs(torch, cfg, model, stream, batches, f"moe_path {arch}",
                                step_profile=True)
        total = add_launches(total, more)
        _, requests, plen, *_ = batches[-1]
        layer = moe_layer_check(torch, cfg, model, (requests, plen))
        models.append({"arch": arch, "layers": layers,
                       "layers_published": get_config(arch).num_layers,
                       "d_model": cfg.d_model, "heads": cfg.num_heads,
                       "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
                       "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
                       "moe_d_ff": cfg.moe_d_ff, "window": cfg.window, "vocab": cfg.vocab_size,
                       "params": cfg.param_count(),
                       "params_published": get_config(arch).param_count(),
                       "init_s": init_s, "runs": runs, "moe_layer": layer})
        del model
        torch.cuda.empty_cache()
    return ({"phase": "moe_path", "models": models,
             "reference": "same engine and weights, attn_impl='ref'; the MoE layer on "
                          "the CPU; moe_apply_dense on the card", "nvidia_smi": smi},
            total)


def stub_frontend(torch, cfg):
    """``requests -> (requests, enc_seq | num_patches, d_model)`` normals x
    ``FRONTEND_SCALE`` from seed ``SEED`` on the card, or None for a family
    without a frontend."""
    n = {"audio": cfg.enc_seq, "vlm": cfg.num_patches}.get(cfg.family)
    if n is None:
        return None

    def make(requests):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return torch.randn((requests, n, cfg.d_model), generator=gen,
                           device="cuda") * FRONTEND_SCALE
    return make


def expected_launches(cfg) -> tuple[int, int]:
    """(flash-attention launches a prefill, a decode step) of ``cfg``'s
    family: hybrid one a whole group, ssm none, audio the encoder's, the
    decoder's self and cross attention a prefill and the cross attention a
    step, others one a layer a prefill; decode self attention is plain."""
    fam = cfg.family
    if fam == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every, 0
    if fam == "ssm":
        return 0, 0
    if fam == "audio":
        return cfg.enc_layers + 2 * cfg.num_layers, cfg.num_layers
    return cfg.num_layers, 0


def cache_vs_forward(torch, cfg, model, stream, frontend) -> dict:
    """Gate 2 at batch (a): the engine's prefill on 12 tokens, then
    ``FAMILY_STEPS`` decode steps fed the true next tokens, against
    ``forward`` over all 16 at the same 5 positions, with the model's bf16
    K / V cache holding every position (patches included).  float32 within
    ``FAMILY_CACHE_RTOL`` x max(1, std), bf16 within ``FAMILY_CACHE_BF16``
    x the bf16 forward's own distance from the float32 one plus that
    bound."""
    from repro_torch.models import model as Mdl
    from repro_torch.serve.engine import Engine

    _, requests, plen, stride, _, _ = SERVE_BATCHES[0]
    n = plen + FAMILY_STEPS
    toks = np.stack([stream[i * stride:i * stride + n] for i in range(requests)])
    fe = frontend(requests) if frontend else None
    first = (cfg.num_patches if cfg.family == "vlm" else 0) + plen - 1
    out, full = {}, {}

    def prefill_decode(engine):
        logits, cache = engine.prefill(toks[:, :plen], fe)
        got = [logits.float()]
        for t in range(FAMILY_STEPS):
            logits, cache = engine.decode(
                cache, torch.as_tensor(toks[:, plen + t:plen + t + 1], device="cuda"))
            got.append(logits.float())
        return torch.stack(got, 1)

    for compute in ("float32", "bfloat16"):
        c = cfg.with_overrides(compute_dtype=compute)
        engine = Engine(c, model, max_len=first + 1 + FAMILY_STEPS, device="cuda")
        with torch.inference_mode():
            full[compute] = Mdl.forward(c, model, torch.as_tensor(toks, device="cuda"),
                                        frontend=fe)[:, first:].float()
            got = prefill_decode(engine)
        tol = FAMILY_CACHE_RTOL * max(1.0, float(full["float32"].std()))
        entry = {"positions": FAMILY_STEPS + 1}
        if compute == "bfloat16":
            dist = float((full["bfloat16"] - full["float32"]).abs().max())
            tol = FAMILY_CACHE_BF16 * dist + tol
            entry["bf16_forward_vs_float32"] = dist
        err = float((got - full[compute]).abs().max())
        entry.update(tol=tol, max_abs_err=err, ratio=err / tol)
        if not bool(torch.isfinite(got).all()) or not err <= tol:
            raise AssertionError(f"families_path {cfg.name} {compute}: prefill + decode "
                                 f"{err} from forward, over the bound {tol}")
        out[compute] = entry
        del engine, got
    return out


def rel_to_max(got, want) -> float:
    """max |got - want| / max |want| (got moved to want's device)."""
    return float((got.cpu() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def mixer_check(torch, cfg, model, grad: bool = False) -> dict:
    """Layer 0's mixers in float32 on ``MIXER_TOKENS`` random tokens (seed
    ``SEED``), on the card against the CPU on the same inputs, each result
    within a bound relative to its largest magnitude.  Gate 3 of
    ``families_path``: the chunked apply with its state, then one step from
    that state, each output and state within ``MIXER_RTOL``.  With
    ``grad``, gate 2 of ``family_train_path``: the apply under autograd
    with a random cotangent, the MoE (moe) too, on the card's routes on
    both sides (``recorded_routes``); the output within ``MIXER_RTOL`` and
    the gradient of the input and of every parameter within
    ``MIXER_GRAD_RTOL``; then ``moe_apply_ep`` on ``MOE_EP_SHARDS`` shards
    of the card against the dense dispatch's gradients there
    (``MOE_EP_ATOL`` x max(1, the largest magnitude))."""
    from repro_torch.distributed.mesh import mesh_for
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import xlstm as X
    from repro_torch.models.moe_ep import moe_apply_ep

    c = cfg.with_overrides(compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    b, s = MIXER_TOKENS
    u = torch.randn((b, s, c.d_model), generator=gen)
    # the step's token, or the cotangent
    v = torch.randn((b, s if grad else 1, c.d_model), generator=gen)
    # (name, parameters, apply -> (output, state), step)
    if cfg.family == "hybrid":
        mixers = (("mamba2", model.layers[0].mamba,
                   lambda p, x: M.mamba2_apply(p, x, c, return_state=True), M.mamba2_step),)
    elif cfg.family == "ssm":
        grp = model.groups[0]
        mixers = (("mlstm", grp.mlstm[0],
                   lambda p, x: X.mlstm_apply(p, x, c, return_state=True), X.mlstm_step),
                  ("slstm", grp.slstm, lambda p, x: X.slstm_apply(p, x, c), X.slstm_step))
    else:
        mixers = (("moe", model.layers[0].moe,
                   lambda p, x: (L.moe_apply_dense(p, x, c), {}), None),)

    def serve(apply, step, p, dev):
        with torch.inference_mode():
            y, st = apply(p, u.to(dev))
            z, st2 = step(p, v.to(dev), st, c)
        return {"apply": y, "step": z, **{f"state_{k}": t for k, t in st.items()},
                **{f"step_state_{k}": t for k, t in st2.items()}}

    def train(apply, p, dev):
        leaves = {k: t.detach().clone().requires_grad_() for k, t in p.items()}
        x = u.to(dev).clone().requires_grad_()
        y = apply(leaves, x)[0]
        (y * v.to(dev)).sum().backward()
        return {"output": y.detach(), "grad_input": x.grad,
                **{f"grad_{k}": t.grad for k, t in leaves.items()}}

    what = "family_train_path" if grad else "families_path"
    out = {}
    for name, p_gpu, apply, step in mixers:
        run = functools.partial(train, apply) if grad else functools.partial(serve, apply, step)
        p_cpu = {k: t.detach().cpu() for k, t in p_gpu.items()}
        with recorded_routes(torch) as log:
            t0 = time.perf_counter()
            got = run(p_gpu, "cuda")
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        with recorded_routes(torch, replay=log) as rlog:
            t0 = time.perf_counter()
            want = run(p_cpu, "cpu")
            cpu_s = time.perf_counter() - t0
        errs = {k: rel_to_max(got[k], want[k]) for k in want}
        bad = {k: e for k, e in errs.items()
               if not e <= (MIXER_GRAD_RTOL if k.startswith("grad_") else MIXER_RTOL)}
        finite = all(bool(torch.isfinite(t).all()) for t in got.values())
        if bad or not finite:
            raise AssertionError(f"{what} {cfg.name} {name} on the card != CPU: {bad}, "
                                 f"finite {finite}")
        entry = {"rel_err": errs, "card_s": card_s, "cpu_s": cpu_s}
        if name == "moe":
            entry["cpu_routes"] = {k: rlog[k] for k in ("tokens", "differ", "differ_decisive")}
            ep = []
            c_ep = c.with_overrides(moe_impl="shard_map")
            for n in MOE_EP_SHARDS:
                mesh = mesh_for(n, "cuda")
                t0 = time.perf_counter()
                sharded = train(lambda p, x: (moe_apply_ep(p, x, c_ep, mesh), {}), p_gpu, "cuda")
                torch.cuda.synchronize()
                ep_s = time.perf_counter() - t0
                errs_ep = {"output": float((sharded["output"] - got["output"]).abs().max())}
                errs_ep.update({k: float((sharded[k] - got[k]).abs().max()
                                         / max(1.0, float(got[k].abs().max())))
                                for k in got if k.startswith("grad_")})
                if not max(errs_ep.values()) <= MOE_EP_ATOL:
                    raise AssertionError(f"{what} {cfg.name}: moe_apply_ep at {n} shards "
                                         f"under autograd != dense: {errs_ep}")
                ep.append({"shards": n, "err": errs_ep, "seconds": ep_s})
                del sharded
            entry["expert_parallel"] = ep
        out[name] = entry
        del got, want, p_cpu
    bounds = {"grad_rtol": MIXER_GRAD_RTOL, "ep_atol": MOE_EP_ATOL} if grad else {}
    return {"tokens": [b, s], "rtol": MIXER_RTOL, **bounds, **out}


def families_path(torch, smi: str) -> tuple[dict, dict]:
    """The hybrid, ssm, audio and vlm families served at full width
    (``FAMILY_RUNS``; see the module docstring): the kernel at each
    family's shapes, then each model through ``serve_runs`` (gates 1 and 4,
    a decode step's idle share), ``cache_vs_forward`` (gate 2) and, for the
    hybrid and ssm families, ``mixer_check`` (gate 3); each model freed
    before the next.  Returns the phase line and the launch counts of the
    driven runs."""
    from repro_torch.configs import get_config

    flash = {"cases": 0, "max_abs_err": 0.0}
    flash["shapes"] = check_flash_shapes(
        torch, FAMILY_FLASH_SHAPES, flash, torch.Generator(device="cuda").manual_seed(SEED))
    stream, _ = token_stream(torch)
    models, total = [], {}
    for arch, layers, batches in FAMILY_RUNS:
        t_model = time.perf_counter()
        published = get_config(arch)
        cfg = published.with_overrides(num_layers=layers)
        if cfg.num_patches:          # max_len counts the patch prefix's positions too
            batches = tuple((*b[:-1], b[-1] + cfg.num_patches) for b in batches)
        t0 = time.perf_counter()
        model = random_model(torch, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        frontend = stub_frontend(torch, cfg)
        expect = expected_launches(cfg)
        runs, more = serve_runs(torch, cfg, model, stream, batches, f"families_path {arch}",
                                step_profile=True, frontend=frontend, expect=expect)
        total = add_launches(total, more)
        reduced = []
        if layers != published.num_layers:
            reduced.append(f"num_layers {published.num_layers} -> {layers}")
        if len(batches) < len(SERVE_BATCHES):
            reduced.append("batch (b) not run")
        entry = {"arch": arch, "family": cfg.family, "layers": layers,
                 "layers_published": published.num_layers, "d_model": cfg.d_model,
                 "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                 "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
                 "params": cfg.param_count(), "params_published": published.param_count(),
                 "params_held": sum(p.numel() for p in model.parameters()),
                 "reduced": reduced, "init_s": init_s,
                 "expected_launches": {"prefill": expect[0], "decode_step": expect[1]},
                 "runs": runs, "cache_vs_forward": cache_vs_forward(
                     torch, cfg, model, stream, frontend)}
        if cfg.family == "ssm":
            entry["gate_1"] = ("vacuous: the family runs no attention, so attn_impl='ref' "
                               "runs the same computation")
        if cfg.family in ("hybrid", "ssm"):
            entry["mixers"] = mixer_check(torch, cfg, model)
        if frontend is not None:
            entry["frontend"] = {"rows": cfg.enc_seq or cfg.num_patches,
                                 "scale": FRONTEND_SCALE, "seed": SEED}
        entry["seconds"] = time.perf_counter() - t_model
        models.append(entry)
        del model
        torch.cuda.empty_cache()
    return ({"phase": "families_path", "family_flash_check": flash, "models": models,
             "reference": "same engine and weights, attn_impl='ref'; forward at the same "
                          "positions; the mixers on the CPU", "nvidia_smi": smi}, total)


def ulps_apart(torch, a, b, operand=None) -> float:
    """The largest |a - b| of two float32 tensors in float32 ulps of the
    larger magnitude of a, b and ``operand`` (an input of the computation
    whose result may have cancelled), element by element."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    if a.numel() == 0:
        return 0.0
    mag = torch.maximum(a.abs(), b.abs())
    if operand is not None:
        mag = torch.maximum(mag, operand.detach().cpu().double().abs())
    mag = mag.float()
    ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).double()
    return float(((a - b).abs() / ulp).max())


def train_path(torch, smi: str) -> tuple[dict, dict]:
    """EventLM training at full width (see the module docstring).  Returns
    the phase line and the launch counts of the driven runs (counts set to
    0 just before each run's steps and read just after)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    from repro_torch.models import model as Mdl
    from repro_torch.models.module import Initializer
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainstep as TS
    from repro_torch.train.checkpoint import CheckpointManager, load_train_state

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: float32 training would round")
    cfg0 = get_config(TRAIN_ARCH)
    layers = cfg0.num_layers
    runs, total = [], {}
    for label, batch, seq, steps in TRAIN_RUNS:
        data, _ = LT.make_data(cfg0, batch, seq, seed=0)
        batches = [LT.to_device(next(data), "cuda") for _ in range(steps + 3)]
        oc = LT.opt_config(steps)
        for compute in ("bfloat16", "float32"):
            cfg = cfg0.with_overrides(compute_dtype=compute)
            what = f"train_path ({label}) {compute}"
            model = Mdl.init_params(cfg, Initializer(
                torch.Generator(device="cuda").manual_seed(0), cfg.param_dtype))
            params = dict(model.named_parameters())

            # step 0's loss and gradients against the plain attention
            def grads_of(c):
                for p in params.values():
                    p.grad = None
                loss = TS.loss_fn(c, model, batches[0])
                loss.backward()
                g = {n: p.grad for n, p in params.items()}
                for p in params.values():
                    p.grad = None
                return loss.detach(), g

            reset_launches()
            loss_k, g_k = grads_of(cfg)
            one = read_launches()
            loss_r, g_r = grads_of(cfg.with_overrides(attn_impl="ref"))
            loss_err = abs(float(loss_k) - float(loss_r))
            grad_err = {n: float((g_k[n] - g_r[n]).norm() / g_r[n].norm()) for n in g_k}
            worst = max(grad_err, key=grad_err.get)
            if not (loss_err <= TRAIN_LOSS_ATOL[compute]
                    and grad_err[worst] <= TRAIN_GRAD_RTOL[compute]):
                raise AssertionError(f"{what}: step 0 loss {float(loss_k)} vs plain "
                                     f"{float(loss_r)}, gradient {worst} rel err "
                                     f"{grad_err[worst]}")
            del g_r

            # adamw_update on the card against the CPU, from the same gradients
            on_card = {n: p.detach().clone() for n, p in params.items()}
            on_cpu = {n: t.cpu() for n, t in on_card.items()}
            p_before = {n: t.clone() for n, t in on_cpu.items()}
            g_cpu = {n: t.cpu() for n, t in g_k.items()}
            opt_card, opt_cpu = O.init_opt_state(on_card), O.init_opt_state(on_cpu)
            for _ in range(2):
                _, opt_card, om_card = O.adamw_update(oc, on_card, g_k, opt_card)
                _, opt_cpu, om_cpu = O.adamw_update(oc, on_cpu, g_cpu, opt_cpu)
            adamw_ulps = max(max(ulps_apart(torch, x[n], y[n], z and z[n]) for n in x)
                             for x, y, z in ((on_card, on_cpu, p_before),
                                             (opt_card["m"], opt_cpu["m"], None),
                                             (opt_card["v"], opt_cpu["v"], None)))
            if adamw_ulps > ADAMW_ULPS:
                raise AssertionError(f"{what}: adamw_update on the card is {adamw_ulps} "
                                     f"ulps from the CPU's")
            adamw = {"ulps": adamw_ulps,
                     "lr_ulps": ulps_apart(torch, om_card["lr"], om_cpu["lr"]),
                     "grad_norm_ulps": ulps_apart(torch, om_card["grad_norm"],
                                                  om_cpu["grad_norm"])}
            del on_card, on_cpu, p_before, g_cpu, opt_card, opt_cpu, g_k

            # the run
            state = TS.init_state(cfg, model)
            step_fn = TS.make_train_step(cfg, oc)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, step_s, per_step = [], [], []
            reset_launches()
            for i in range(steps):
                before = read_launches()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batches[i])
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t0)
                after = read_launches()
                per_step.append({n: after[n] - before[n] for n in after if after[n] - before[n]})
            run_l = read_launches()
            peak = torch.cuda.max_memory_allocated()
            for name, n in run_l.items():
                total[name] = total.get(name, 0) + n
            want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers}
            if any(st != want for st in per_step) or one != {**{n: 0 for n in one},
                                                            "flash_attention": 2 * layers,
                                                            "flash_attention_bwd": layers}:
                raise AssertionError(f"{what} did not launch the forward kernel 24 and "
                                     f"the backward 12 times a step: {per_step}, step 0 {one}")
            if not all(np.isfinite(losses)) or not np.mean(losses[-5:]) < np.mean(losses[:5]):
                raise AssertionError(f"{what}: losses {losses}")

            # one synchronized step split into forward / backward / optimizer
            def split_step(b):
                for p in params.values():
                    p.grad = None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = TS.loss_fn(cfg, model, b)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loss.backward()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                state["opt"] = O.adamw_update(
                    oc, params, {n: p.grad for n, p in params.items()}, state["opt"])[1]
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                for p in params.values():
                    p.grad = None
                return {"forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
                        "optimizer_ms": 1e3 * (t3 - t2)}

            split = split_step(batches[steps])
            wall = float(np.median(step_s[2:]))
            prof = idle_share(torch, lambda: step_fn(state, batches[steps + 1]), wall)

            # a checkpoint saved, restored and resumed gives the same next step
            ckdir = ROOT / "build" / "chip_smoke" / f"ckpt_{label}_{compute}"
            shutil.rmtree(ckdir, ignore_errors=True)
            mgr = CheckpointManager(str(ckdir), keep=1)
            t0 = time.perf_counter()
            mgr.save(steps, state)
            save_s = time.perf_counter() - t0
            got_step, tree = mgr.restore_latest()
            restored = load_train_state(cfg, tree, "cuda")
            del tree
            shutil.rmtree(ckdir, ignore_errors=True)
            same = got_step == steps and int(restored["opt"]["step"]) == int(
                state["opt"]["step"])
            for (n, p), q in zip(model.named_parameters(), restored["params"].parameters()):
                same = same and torch.equal(p, q) and torch.equal(
                    state["opt"]["m"][n], restored["opt"]["m"][n]) and torch.equal(
                    state["opt"]["v"][n], restored["opt"]["v"][n])
            _, m_a = step_fn(state, batches[steps + 2])
            _, m_b = step_fn(restored, batches[steps + 2])
            resume_err = max(float((p.detach() - q.detach()).abs().max()) for p, q in zip(
                model.parameters(), restored["params"].parameters()))
            if not (same and float(m_a["loss"]) == float(m_b["loss"])
                    and resume_err <= RESUME_ATOL):
                raise AssertionError(f"{what}: the checkpoint round trip differs: state "
                                     f"equal {same}, next loss {float(m_a['loss'])} vs "
                                     f"{float(m_b['loss'])}, params {resume_err}")
            tok = batch * seq
            runs.append({
                "run": label, "compute_dtype": compute, "batch": batch, "seq": seq,
                "steps": steps, "opt": {"lr": oc.lr, "warmup_steps": oc.warmup_steps,
                                        "total_steps": oc.total_steps},
                "losses": losses, "step_s": step_s,
                "tokens_per_s": float(np.median([tok / dt for dt in step_s[2:]])),
                "step_ms_median": 1e3 * wall, "split_step": split,
                "max_memory_allocated": peak, "profile": prof,
                "launches": run_l, "launches_per_step": per_step[0],
                "step0": {"loss": float(loss_k), "loss_ref": float(loss_r),
                          "loss_abs_err": loss_err, "loss_atol": TRAIN_LOSS_ATOL[compute],
                          "grad_max_rel_err": grad_err[worst], "grad_worst": worst,
                          "grad_rtol": TRAIN_GRAD_RTOL[compute]},
                "adamw_card_vs_cpu": {**adamw, "bound_ulps": ADAMW_ULPS},
                "resume": {"state_bitwise": same, "next_loss_bitwise": True,
                           "params_max_abs_err": resume_err, "atol": RESUME_ATOL,
                           "save_s": save_s}})
            del state, restored, model, params, step_fn, m_a, m_b
            torch.cuda.empty_cache()
    phase = {"phase": "train_path", "arch": cfg0.name, "layers": layers,
             "d_model": cfg0.d_model, "heads": cfg0.num_heads,
             "head_dim": cfg0.resolved_head_dim, "vocab": cfg0.vocab_size,
             "params": cfg0.param_count(), "remat_policy": cfg0.remat_policy,
             "runs": runs, "reference": "same model and batch, attn_impl='ref'",
             "nvidia_smi": smi}
    return phase, total


@contextlib.contextmanager
def recorded_routes(torch, replay=None):
    """Within the block, ``models.layers.route`` keeps each call's expert
    ids in the yielded log (calls in order: a forward pass, then the
    recompute of remat "full").  Given ``replay``, an earlier run's log of
    the same calls, each call takes that call's ids instead, with softmax
    gates of its own logits at them, and the log counts the tokens whose own
    top k differs (``differ``) and those of them whose k-th logit leads the
    (k+1)-th by more than 2 D 2^-24 max_e sum_d |x_d| |w_de|, the float32
    error bound of ``moe_layer_check`` (``differ_decisive``)."""
    from repro_torch.models import layers as L

    real = L.route
    log = {"ids": [], "calls": 0, "tokens": 0, "differ": 0, "differ_decisive": 0}

    def route(xt, router, cfg):
        gates, idx = real(xt, router, cfg)
        if replay is None:
            log["ids"].append(idx.detach())
            return gates, idx
        want = replay["ids"][log["calls"]].to(idx.device)
        log["calls"] += 1
        K = cfg.num_experts_per_tok
        logits = (xt @ router.to(xt.dtype)).float()
        with torch.no_grad():
            top = logits.sort(dim=-1, descending=True).values
            bound = 2 * xt.shape[1] * 2.0 ** -24 * (
                xt.float().abs() @ router.float().abs()).amax(1)
            differ = (idx.sort(1).values != want.sort(1).values).any(1)
            log["tokens"] += int(xt.shape[0])
            log["differ"] += int(differ.sum())
            log["differ_decisive"] += int((differ & (top[:, K - 1] - top[:, K] > bound)).sum())
        return torch.softmax(logits.gather(-1, want), dim=-1), want

    L.route = route
    try:
        yield log
    finally:
        L.route = real


def family_train_path(torch, smi: str, check_shapes: bool = False) -> tuple[dict, dict]:
    """The moe, hybrid, ssm, audio and vlm families trained at full width
    with depth cut (``FAMILY_TRAIN_RUNS``; see the module docstring).  With
    ``check_shapes`` first both attention kernels against their plain
    versions at ``FAMILY_TRAIN_SHAPES`` (the full smoke's kernels_check has
    done so already).  Returns the phase line and the launch counts of the
    driven runs (set to 0 just before each run's steps and read just
    after); each model is freed before the next is built."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainstep as TS

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: float32 training would round")
    flash = None
    if check_shapes:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        flash = {name: {"cases": 0, "max_abs_err": 0.0}
                 for name in ("flash_attention", "flash_attention_bwd")}
        check_flash_shapes(torch, FAMILY_TRAIN_SHAPES, flash["flash_attention"], gen)
        check_flash_bwd_shapes(torch, FAMILY_TRAIN_SHAPES, flash["flash_attention_bwd"], gen,
                               "family_train_path")
    batch, seq = FAMILY_TRAIN_BATCH
    steps = FAMILY_TRAIN_STEPS
    oc = LT.opt_config(steps)
    models, total = [], {}
    for arch, layers in FAMILY_TRAIN_RUNS:
        t_model = time.perf_counter()
        published = get_config(arch)
        cfg0 = published.with_overrides(num_layers=layers)
        data, _ = LT.make_data(cfg0, batch, seq, seed=0)
        batches = [LT.to_device(next(data), "cuda") for _ in range(steps + 2)]
        frontend = stub_frontend(torch, cfg0)
        if frontend is not None:
            for bt in batches:
                bt["frontend"] = frontend(batch)
        calls = expected_launches(cfg0)[0]
        want = {"flash_attention": 2 * calls, "flash_attention_bwd": calls}
        runs, mixers = [], None
        for compute in ("float32", "bfloat16"):
            cfg = cfg0.with_overrides(compute_dtype=compute)
            what = f"family_train_path {arch} {compute}"
            model = random_model(torch, cfg)
            params = dict(model.named_parameters())
            held = sum(p.numel() for p in params.values())

            def grads_of(c, b=batches[0]):
                for p in params.values():
                    p.grad = None
                loss = TS.loss_fn(c, model, b)
                loss.backward()
                g = {n: p.grad for n, p in params.items()}
                for p in params.values():
                    p.grad = None
                return loss.detach(), g

            # gates 1, 4, 5: step 0 through the kernels twice, bitwise alike,
            # then against the plain attention on the same routes
            with recorded_routes(torch) as routes:
                reset_launches()
                loss_k, g_k = grads_of(cfg)
                one = read_launches()
            _, g_again = grads_of(cfg)
            differ = [n for n in g_k if not torch.equal(g_k[n], g_again[n])]
            del g_again
            if differ:
                raise AssertionError(f"{what}: a second backward on the step-0 batch "
                                     f"changed the gradients of {differ[:5]}")
            with recorded_routes(torch, replay=routes) as ref_routes:
                loss_r, g_r = grads_of(cfg.with_overrides(attn_impl="ref"))
            del routes
            loss_err = abs(float(loss_k) - float(loss_r))
            grad_err = {n: float((g_k[n] - g_r[n]).norm() / g_r[n].norm().clamp_min(1e-30))
                        for n in g_k}
            worst = max(grad_err, key=grad_err.get)
            finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
            del g_k, g_r
            if not (finite and loss_err <= TRAIN_LOSS_ATOL[compute]
                    and grad_err[worst] <= TRAIN_GRAD_RTOL[compute]):
                raise AssertionError(f"{what}: step 0 loss {float(loss_k)} vs plain "
                                     f"{float(loss_r)}, gradient {worst} rel err "
                                     f"{grad_err[worst]}, finite {finite}")

            # the run
            state = TS.init_state(cfg, model)
            step_fn = TS.make_train_step(cfg, oc)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, gnorms, step_s, per_step = [], [], [], []
            reset_launches()
            for i in range(steps):
                before = read_launches()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batches[i])
                losses.append(float(metrics["loss"]))
                gnorms.append(float(metrics["grad_norm"]))
                step_s.append(time.perf_counter() - t0)
                after = read_launches()
                per_step.append({n: after[n] - before[n] for n in after if after[n] - before[n]})
            run_l = read_launches()
            peak = torch.cuda.max_memory_allocated()
            total = add_launches(total, run_l)
            want_step = {n: k for n, k in want.items() if k}
            if any(st != want_step for st in per_step) or one != {
                    **{n: 0 for n in one}, **want}:
                raise AssertionError(f"{what}: launches a step {per_step}, step 0 {one}; "
                                     f"want {want}")
            if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()
                    and np.mean(losses[-5:]) < np.mean(losses[:5])):
                raise AssertionError(f"{what}: losses {losses}, grad norms {gnorms}")

            # one synchronized step split into forward / backward / optimizer
            for p in params.values():
                p.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = TS.loss_fn(cfg, model, batches[steps])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            state["opt"] = O.adamw_update(
                oc, params, {n: p.grad for n, p in params.items()}, state["opt"])[1]
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for p in params.values():
                p.grad = None
            del loss
            wall = float(np.median(step_s[2:]))
            prof = idle_share(torch, lambda: step_fn(state, batches[steps + 1]), wall)
            tok = batch * seq
            run = {"compute_dtype": compute, "params_held": held,
                   "losses": losses, "grad_norms": gnorms, "step_s": step_s,
                   "tokens_per_s": float(np.median([tok / dt for dt in step_s[2:]])),
                   "step_ms_median": 1e3 * wall,
                   "split_step": {"forward_ms": 1e3 * (t1 - t0),
                                  "backward_ms": 1e3 * (t2 - t1),
                                  "optimizer_ms": 1e3 * (t3 - t2)},
                   "max_memory_allocated": peak, "profile": prof,
                   "launches": run_l, "launches_per_step": per_step[0],
                   "step0": {"loss": float(loss_k), "loss_ref": float(loss_r),
                             "loss_abs_err": loss_err, "loss_atol": TRAIN_LOSS_ATOL[compute],
                             "grad_max_rel_err": grad_err[worst], "grad_worst": worst,
                             "grad_rtol": TRAIN_GRAD_RTOL[compute],
                             "second_backward_bitwise": True}}
            if cfg.num_experts:
                run["step0"]["ref_routes"] = {k: ref_routes[k] for k in (
                    "calls", "tokens", "differ", "differ_decisive")}
            runs.append(run)
            del state, step_fn, params, prof
            if compute == "float32" and cfg.family in ("hybrid", "ssm", "moe"):
                mixers = mixer_check(torch, cfg, model, grad=True)
            del model
            torch.cuda.empty_cache()
        entry = {"arch": arch, "family": cfg0.family, "layers": layers,
                 "layers_published": published.num_layers, "d_model": cfg0.d_model,
                 "heads": cfg0.num_heads, "kv_heads": cfg0.num_kv_heads,
                 "head_dim": cfg0.resolved_head_dim, "vocab": cfg0.vocab_size,
                 "params": cfg0.param_count(), "params_published": published.param_count(),
                 "batch": batch, "seq": seq, "steps": steps,
                 "remat_policy": cfg0.remat_policy,
                 "opt": {"lr": oc.lr, "warmup_steps": oc.warmup_steps,
                         "total_steps": oc.total_steps},
                 "attention_calls": calls, "launches_per_step_expected": want,
                 "reduced": [] if layers == published.num_layers
                 else [f"num_layers {published.num_layers} -> {layers}"], "runs": runs}
        if cfg0.family == "ssm":
            entry["gate_1"] = ("vacuous: the family runs no attention, so attn_impl='ref' "
                               "runs the same computation")
        if mixers is not None:
            entry["layer0_under_autograd"] = mixers
        if frontend is not None:
            entry["frontend"] = {"rows": cfg0.enc_seq or cfg0.num_patches,
                                 "scale": FRONTEND_SCALE, "seed": SEED}
        entry["seconds"] = time.perf_counter() - t_model
        models.append(entry)
        del batches, data
    phase = {"phase": "family_train_path", "models": models,
             "reference": "same model, batch and routes, attn_impl='ref'; layer 0 under "
                          "autograd on the CPU; moe_apply_dense on the card",
             "nvidia_smi": smi}
    if flash is not None:
        phase["family_flash_check"] = flash
    return phase, total


def start_launch_sweep(out_dir: str):
    """``python -m repro_torch.launch.dryrun --all`` in a child process with
    no card visible (the dry run needs none), its records and log in
    ``out_dir``; returns (process, records path, log path, start time on
    the wall clock)."""
    import os

    out = str(Path(out_dir) / "dryrun.jsonl")
    log = str(Path(out_dir) / "dryrun.log")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                             "--jobs", str(LAUNCH_JOBS), "--out", out],
                            stdout=open(log, "w"), stderr=subprocess.STDOUT, env=env,
                            cwd=out_dir)
    return proc, out, log, time.time()


def launch_sweep(sweep) -> dict:
    """(a): the sweep's records, each cell's line, and the sweep's wall
    seconds (to the records' last write: the join may come later, when the
    phases beside it are done)."""
    from repro_torch.configs import ARCH_IDS, cells
    from repro_torch.launch import roofline as RL

    proc, out, log, t0 = sweep
    try:
        rc = proc.wait(timeout=1200)
    finally:
        if proc.poll() is None:
            proc.kill()
    seconds = (Path(out).stat().st_mtime if Path(out).exists() else time.time()) - t0
    recs = [json.loads(line) for line in open(out)] if Path(out).exists() else []
    got = {(r["arch"], r["shape"]): r for r in recs}
    want = [(a, s) for a in ARCH_IDS for s in cells(a)]
    missing = [c for c in want if c not in got]
    failed = [c for c in want if c in got and not got[c]["ok"]]
    if rc != 0 or missing or failed:
        tail = Path(log).read_text()[-3000:] if Path(log).exists() else ""
        raise AssertionError(f"launch_path: dry-run sweep rc {rc}, missing {missing}, "
                             f"ok: false {[(c, got[c].get('error')) for c in failed]}\n"
                             + "".join(got[c].get("trace", "")[-2000:] for c in failed)
                             + f"\n{tail}")
    rows = {}
    for a, s in want:
        r = got[(a, s)]
        row = RL.analyze_record(r, RL.chips_of(r["mesh"]))
        rows[f"{a}/{s}"] = {
            "fits": row["fits"], "peak_GB": r["memory"]["peak_bytes"] / 1e9,
            "bottleneck": row["bottleneck"], "t_compute_ms": row["t_compute"] * 1e3,
            "t_memory_ms": row["t_memory"] * 1e3, "t_collective_ms": row["t_collective"] * 1e3,
            "roofline_fraction": row["roofline_fraction"], "useful_ratio": row["useful_ratio"],
            "microbatches": r["num_microbatches"], "seconds": r["trace_s"],
            **({"moe_dispatch": r["moe_dispatch"]} if "moe_dispatch" in r else {})}
    return {"mesh": "32x8", "cells": len(rows), "seconds": seconds,
            "within_budget": seconds <= LAUNCH_SWEEP_BUDGET_S,
            "budget_s": LAUNCH_SWEEP_BUDGET_S, "jobs": LAUNCH_JOBS, "rows": rows}


def dispatch_cost(torch) -> dict:
    """Host microseconds a call of the flash-attention forward through its
    custom op (``torch.ops.repro_torch.flash_attention``) and of the bare
    launch function it wraps, at a one-tile shape, same run."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v = (torch.randn((1, 1, 64, 64), device="cuda") for _ in range(3))
    args = (q, k, v, None, 64, True, -1, 0, False)
    out = {}
    for label, fn in (("custom_op_us", torch.ops.repro_torch.flash_attention),
                      ("bare_us", fa.flash_attention_launch),
                      ("custom_op_us_again", torch.ops.repro_torch.flash_attention),
                      ("bare_us_again", fa.flash_attention_launch)):
        for _ in range(50):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn(*args)
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) / DISPATCH_CALLS * 1e6
    out["dispatch_us"] = (out["custom_op_us"] + out["custom_op_us_again"]
                          - out["bare_us"] - out["bare_us_again"]) / 2
    return out


def launch_check(torch, arch: str, layers, batch: int, seq: int, compute: str) -> tuple:
    """(b) and (c) for one real step: the dry run on a 1 x 1 mesh against a
    step on the card.  Returns (row, launch counts of the measured step)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.kernels.flash_attention.flash_attention import attention_flops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.train import trainstep as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(arch).with_overrides(compute_dtype=compute)
    if layers:
        cfg = cfg.with_overrides(num_layers=layers)
    shape = Shape(f"{batch}x{seq}", "train", seq, batch)
    t0 = time.perf_counter()
    with fake_world(1):
        dry = D.account_cell(cfg, shape, make_mesh({"data": 1, "model": 1}), 1)
    dry_s = time.perf_counter() - t0

    model = random_model(torch, cfg)
    state = TS.init_state(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tok = torch.randint(3, cfg.vocab_size, (batch, seq + 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    data = {"tokens": tok[:, :-1].contiguous(), "targets": tok[:, 1:].contiguous(),
            "loss_mask": torch.ones((batch, seq), device="cuda")}
    step = TS.make_train_step(cfg, OptConfig(), 1)
    step(state, data)                       # warm-up: workspaces, first launches
    torch.cuda.synchronize()
    L = cfg.num_layers
    args = (sum(p.nbytes for p in model.parameters())
            + sum(t.nbytes for key in ("m", "v") for t in state["opt"][key].values())
            + state["opt"]["step"].nbytes + sum(t.nbytes for t in data.values()))
    other = torch.cuda.memory_allocated() - args
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with FlopCounterMode(display=False) as fc:
        step(state, data)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - other
    if launches["flash_attention"] != 2 * L or launches["flash_attention_bwd"] != L:
        raise AssertionError(f"launch_path {arch} {compute}: a remat 'full' step of {L} "
                             f"layers must launch the forward kernel {2 * L} and the "
                             f"backward {L} times: {launches}")
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    b, h, d = batch, cfg.num_heads, cfg.resolved_head_dim
    q_shape, k_shape = (b, h, seq, d), (b, cfg.num_kv_heads, seq, d)
    window = cfg.window or None
    kernel = {"flash_attention": attention_flops(q_shape, k_shape, True, window),
              "flash_attention_bwd": attention_flops(q_shape, k_shape, True, window,
                                                     backward=True)}
    by_kernel = {name: counts.get(f"repro_torch.{name}", 0) for name in kernel}
    for name, f in kernel.items():
        if by_kernel[name] != f * launches[name]:
            raise AssertionError(f"launch_path {arch} {compute}: FlopCounterMode counts "
                                 f"{by_kernel[name]} for {name}, formula x launches "
                                 f"{f} x {launches[name]}")
    real_dots = fc.get_total_flops() - sum(by_kernel.values()) + sum(
        kernel[n] * launches[n] for n in kernel)
    mem = dry["memory"]
    what = f"launch_path {arch} ({layers or cfg.num_layers} layers) {compute}"
    if mem["argument_bytes"] != args:
        raise AssertionError(f"{what}: dry-run argument bytes {mem['argument_bytes']} != "
                             f"{args} on the card")
    if dry["counts"]["dot_flops"] != real_dots:
        raise AssertionError(f"{what}: dry-run dot FLOPs {dry['counts']['dot_flops']} != "
                             f"{real_dots} of the real step")
    peak_err = abs(mem["peak_bytes"] - peak) / peak
    if peak_err > LAUNCH_PEAK_RTOL:
        raise AssertionError(f"{what}: dry-run peak {mem['peak_bytes']} vs "
                             f"{peak} on the card, {peak_err:.3f} > {LAUNCH_PEAK_RTOL}")

    secs = []
    for _ in range(LAUNCH_TIMED_STEPS):
        secs.append(host_s(torch, lambda: step(state, data)))
    sec = sorted(secs)[len(secs) // 2]
    n_active = cfg.active_param_count()
    row = {"arch": arch, "layers": layers or cfg.num_layers, "batch": batch, "seq": seq,
           "compute_dtype": compute, "argument_bytes": args,
           "dot_flops": real_dots, "flop_counter_total": fc.get_total_flops(),
           "kernel_flops": by_kernel, "launches": launches,
           "peak_bytes": peak, "dry_peak_bytes": mem["peak_bytes"], "peak_rel_err": peak_err,
           "dry_s": dry_s, "step_s": sec, "step_s_all": secs,
           "model_flops": RL.model_flops(n_active, batch * seq, "train"),
           "mfu": RL.mfu(n_active, batch * seq, "train", sec, compute),
           "peak_flops": RL.peak_flops(compute),
           **({"moe_dispatch": "upper bound"} if dry["counts"]["upper_bound"] else {})}
    del model, state, data
    torch.cuda.empty_cache()
    return row, launches


def dashboard_check() -> dict:
    """(d): ``examples/dashboard_torch.py`` on the card and on the CPU (two
    processes at once), its panels' answers compared."""
    import os
    import tempfile

    out = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for device in ("cuda", "cpu"):
            path = str(Path(d) / f"{device}.json")
            procs[device] = (subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / "dashboard_torch.py"), "--device",
                 device, "--json", path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env), path, time.perf_counter())
        for device, (proc, path, t0) in procs.items():
            try:
                log = proc.communicate(timeout=600)[0]
            finally:
                if proc.poll() is None:
                    proc.kill()
            if proc.returncode != 0:
                raise AssertionError(f"launch_path: dashboard on {device} failed\n"
                                     f"{log[-3000:]}")
            out[device] = {"answers": json.loads(Path(path).read_text()),
                           "seconds": time.perf_counter() - t0}
    if out["cuda"]["answers"] != out["cpu"]["answers"]:
        raise AssertionError("launch_path: the dashboard's answers on the card differ "
                             "from the CPU's")
    return {"equal": True, "panels": sorted(out["cpu"]["answers"]),
            "seconds": {k: v["seconds"] for k, v in out.items()}}


def launch_path(torch, smi: str, sweep) -> tuple[dict, dict]:
    """The launch tooling (see the module docstring).  Returns the phase line
    and the launch counts of the measured real steps (counts set to 0 just
    before each and read just after)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: float32 training would round")
    t0 = time.perf_counter()
    checks, total = [], {}
    for arch, layers, batch, seq, dtypes in LAUNCH_CHECKS:
        for compute in dtypes:
            row, launches = launch_check(torch, arch, layers, batch, seq, compute)
            checks.append(row)
            total = add_launches(total, launches)
            print(json.dumps({"launch_mfu": f"{arch} {compute}", "mfu": row["mfu"],
                              "step_s": row["step_s"], "nvidia_smi": smi}), flush=True)
    dispatch = dispatch_cost(torch)
    dash = dashboard_check()
    sw = launch_sweep(sweep)
    return {"phase": "launch_path", "nvidia_smi": smi, "sweep": sw, "checks": checks,
            "peak_rtol": LAUNCH_PEAK_RTOL, "custom_op_dispatch": dispatch,
            "dashboard": dash, "seconds": time.perf_counter() - t0}, total


def numpy_dfg_masked(case: np.ndarray, act: np.ndarray, rv: np.ndarray, a: int):
    """Independent host oracle of the DFG of a sorted log under a row mask,
    with the engine's semantics: a pair is two adjacent rows of one case,
    both kept; a start (end) is a kept row that opens (closes) its case."""
    same = case[1:] == case[:-1]
    pair = same & rv[1:] & rv[:-1]
    key = act[:-1].astype(np.int64) * a + act[1:]
    counts = np.bincount(key[pair], minlength=a * a).reshape(a, a)
    start = np.concatenate([[True], ~same]) & rv
    end = np.concatenate([~same, [True]]) & rv
    return (counts.astype(np.int32),
            np.bincount(act[start], minlength=a).astype(np.int32),
            np.bincount(act[end], minlength=a).astype(np.int32))


QUERY_PLANS = ("case_band", "time_range", "variant_in", "cases_containing")


def query_plans(query, path: str, case_np, act_np, ts_np, sk) -> dict:
    """The query path's four plans over the L1 file, each with its row mask
    (a numpy oracle of the filter):

    * ``case_band`` — a case-id range the zone maps refute for about three
      quarters of the row groups (interior groups proved, edges residual);
    * ``time_range`` — a timestamp range; L1's case start times are
      uniform, so every group's zone spans it and every group is read with
      a residual mask;
    * ``variant_in`` — the three most frequent variants, resolved from the
      header sketches with no phase-one I/O;
    * ``cases_containing`` — cases containing the rarest activity, the
      fused single-pass schedule.
    """
    from repro_torch.core import CASE, TIMESTAMP

    cases = int(case_np[-1]) + 1
    lo, hi = int(0.40 * cases), int(0.62 * cases)
    t_lo, t_hi = 250_000.0, 750_000.0
    seg = np.cumsum(np.concatenate([[True], case_np[1:] != case_np[:-1]])) - 1
    pairs = np.stack([sk["add1"], sk["add2"]], axis=1).astype(np.int64)
    uniq, inv, n_per = np.unique(pairs, axis=0, return_inverse=True,
                                 return_counts=True)
    top = np.argsort(-n_per, kind="stable")[:3]
    keep_var = np.isin(inv.reshape(-1), top)
    counts = np.bincount(act_np, minlength=NUM_ACTIVITIES)
    rare = int(np.flatnonzero(counts == counts[counts > 0].min())[0])
    keep_rare = np.zeros(seg[-1] + 1, bool)
    keep_rare[seg[act_np == rare]] = True
    col = query.col
    return {
        "case_band": (query.Plan(path).filter(col(CASE).between(lo, hi)),
                      (case_np >= lo) & (case_np <= hi),
                      {"cases": [lo, hi]}),
        "time_range": (query.Plan(path).filter(col(TIMESTAMP).between(t_lo, t_hi)),
                       (ts_np >= np.float32(t_lo)) & (ts_np <= np.float32(t_hi)),
                       {"timestamps": [t_lo, t_hi]}),
        "variant_in": (query.Plan(path).filter(query.variant_in(
                           [tuple(int(x) for x in uniq[t]) for t in top])),
                       keep_var[seg], {"variants": 3,
                                       "cases": int(n_per[top].sum())}),
        "cases_containing": (query.Plan(path).filter(query.cases_containing(rare)),
                             keep_rare[seg], {"activity": rare,
                                              "cases": int(keep_rare.sum())}),
    }


def query_path(torch, smi: str, path: str, case_np, act_np, ts_np, sk,
               frame_gpu, chunks: int) -> tuple[dict, dict, dict, dict]:
    """The pruned query layer on the card (``repro_torch.query``): four
    plans over the L1 file, each mined with the DFG and the variants
    kernels, held against the port's eager filter-then-mine on the card,
    the same plan through the plain lowerings on the card, and numpy
    oracles; the group-state algebra over L1's row groups for every
    mergeable verb, held against ``run_streaming`` on the card and the CPU
    plain stream; ``execute_grouped``
    served from the state cache; and the prefetch thread at depth 0 and 1.
    Returns the phase's line, the launch counts of its main drive (the
    eight plan executions), those of the group-state folds, merges and
    finalizes, and each mergeable verb's CPU plain stream over L1."""
    import warnings

    from repro_torch import query
    from repro_torch.core import (ACTIVITY, CASE, TIMESTAMP, ChunkedEventFrame,
                                  dfg_kernel, engine, filtering, ops,
                                  run_streaming, variants)
    from repro_torch.kernels import segment_ops as so
    from repro_torch.query import exec as qexec
    from repro_torch.query import statecache
    from repro_torch.storage import edf

    t_phase = time.perf_counter()
    ncases = query.count_cases(query.Plan(path))
    if ncases != int(sk["add1"].shape[0]):
        raise AssertionError(f"count_cases {ncases} != {sk['add1'].shape[0]}")
    total_bytes = edf.file_sizes(path)["total"]
    plans = query_plans(query, path, case_np, act_np, ts_np, sk)
    kernels = {"dfg": dfg_kernel(NUM_ACTIVITIES),
               "variants": variants.variants_kernel(NUM_CASES)}
    plain = {"dfg": dfg_kernel(NUM_ACTIVITIES, "segment"),
             "variants": variants.variants_kernel(NUM_CASES, "ref")}
    for plan, _, _ in plans.values():            # warm-up: first-use costs
        for k in kernels.values():
            query.execute(plan, k)
    torch.cuda.synchronize()

    # the ghost chunks each scan builds, counted where it builds them
    ghost_chunk, built = qexec._ghost_chunk, {"n": 0}

    def counted_ghost_chunk(*args, **kwargs):
        built["n"] += 1
        return ghost_chunk(*args, **kwargs)

    reset_launches()
    got, reports, seconds, affine, ghosts = {}, {}, {}, {}, {}
    qexec._ghost_chunk = counted_ghost_chunk
    try:
        for name, (plan, _, _) in plans.items():
            for kname, k in kernels.items():
                before, built["n"] = so.segmented_affine_cuda.launches, 0
                t0 = time.perf_counter()
                got[name, kname], reports[name, kname] = query.execute(plan, k)
                torch.cuda.synchronize()
                seconds[name, kname] = time.perf_counter() - t0
                affine[name, kname] = so.segmented_affine_cuda.launches - before
                ghosts[name, kname] = built["n"]
    finally:
        qexec._ghost_chunk = ghost_chunk
    launches = read_launches()

    def fp_host(res):
        return tuple(x.cpu().numpy() for x in res)

    def dfg_host(d):
        return tuple(getattr(d, f).cpu().numpy() for f in ("counts", "starts", "ends"))

    v_oracle = []
    for key in ("add1", "add2"):
        fp = np.zeros(NUM_CASES, np.int64)
        fp[:ncases] = sk[key]
        v_oracle.append(fp)
    v_oracle.append(np.asarray(ncases, np.int32))
    plans_out, plain_s = {}, {}
    c_gpu = frame_gpu[CASE]
    for name, (plan, rows, what) in plans.items():
        # the port's eager filter on the card, its row mask held against
        # the numpy one
        if name == "case_band":
            lo, hi = what["cases"]
            eager = ops.proj(frame_gpu, (c_gpu >= lo) & (c_gpu <= hi))
        elif name == "time_range":
            eager = ops.proj(frame_gpu, filtering.time_range_mask(
                frame_gpu, TIMESTAMP, *what["timestamps"]))
        elif name == "variant_in":
            fp1, fp2, seg = variants.variant_fingerprints(frame_gpu)
            keep = torch.zeros_like(fp1, dtype=torch.bool)
            for a, b in plan.steps[0].pairs:
                keep |= (fp1 == a) & (fp2 == b)
            eager = ops.proj(frame_gpu, keep[seg.long()])
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                eager = filtering.filter_cases_containing(
                    frame_gpu, what["activity"], NUM_CASES)
        check_equal(f"query {name} eager row mask vs numpy",
                    eager.rows_valid().cpu().numpy(), rows)
        for kname in kernels:
            res = got[name, kname]
            host = dfg_host if kname == "dfg" else fp_host
            t0 = time.perf_counter()
            ref_res, _ = query.execute(plan, plain[kname])
            torch.cuda.synchronize()
            plain_s[name, kname] = time.perf_counter() - t0
            eager_res = engine.run_single(kernels[kname], eager)
            for label, other in (("plain_lowering", host(ref_res)),
                                 ("eager_filter_then_mine", host(eager_res))):
                for i, (x, y) in enumerate(zip(host(res), other)):
                    check_equal(f"query {name}/{kname}[{i}] vs {label}", x, y)
            oracle = (numpy_dfg_masked(case_np, act_np, rows, NUM_ACTIVITIES)
                      if kname == "dfg" else tuple(v_oracle))
            for i, (x, y) in enumerate(zip(host(res), oracle)):
                check_equal(f"query {name}/{kname}[{i}] vs numpy oracle", x, y)
        rep, n_ghosts = reports[name, "variants"], ghosts[name, "variants"]
        if affine[name, "variants"] < 2 * n_ghosts:
            raise AssertionError(f"query {name}: {affine[name, 'variants']} "
                                 f"affine launches for {n_ghosts} ghost chunks")
        plans_out[name] = {
            **what, "rows_kept": int(rows.sum()), "ghost_chunks": n_ghosts,
            "affine_launches": affine[name, "variants"],
            "groups_total": rep.groups_total, "groups_read": rep.groups_read,
            "groups_skipped": rep.groups_skipped,
            "groups_proved": rep.groups_proved,
            "phase1_groups_read": rep.phase1_groups_read,
            "bytes_read": rep.bytes_read, "bytes_total": rep.bytes_total,
            "file_bytes": total_bytes,
            "seconds": {k: seconds[name, k] for k in kernels},
            "plain_lowering_s": {k: plain_s[name, k] for k in kernels},
            "log_events_answered_per_s": {k: len(case_np) / seconds[name, k]
                                          for k in kernels},
            "rows_read_per_s": {k: reports[name, k].rows_read / seconds[name, k]
                                for k in kernels}}
    band = plans_out["case_band"]
    if not (band["groups_skipped"] >= band["groups_total"] // 2
            and band["ghost_chunks"] >= 2 and band["groups_proved"] >= 1):
        raise AssertionError(f"case band did not prune: {band}")
    if plans_out["variant_in"]["phase1_groups_read"]:
        raise AssertionError("variant_in read data in phase one")
    for key in ("pair_count", "histogram", "segmented_polyhash",
                "segment_reduce", "segmented_affine"):
        if launches[key] == 0:
            raise AssertionError(f"query path launched no {key}: {launches}")

    # the group-state algebra: per-group folds of L1 on the card, merged
    # and finalized, held against run_streaming on the card and the plain
    # stream on the CPU (centrality flow within 1e-6, as in graph_path,
    # its plus_times matvecs add in each lowering's order).  Each verb's
    # launches are counted from its folds, merge and finalize alone.
    dims = engine.Dims(NUM_ACTIVITIES, NUM_CASES)
    gs_cols = [CASE, ACTIVITY, TIMESTAMP]
    groups = list(ChunkedEventFrame.from_edf(path, columns=gs_cols,
                                             device="cuda"))
    cpu_groups = ChunkedEventFrame.from_edf(path, columns=gs_cols,
                                            device="cpu")
    merged_ok, t_fold, t_merge, t_plain, cpu_results = [], 0.0, 0.0, 0.0, {}
    gs_launches, by_verb = dict.fromkeys(wrappers(), 0), {}
    for vname, spec in sorted(engine.kernel_specs().items()):
        kernel = spec.make(dims)
        if not engine.mergeable(kernel):
            continue
        reset_launches()
        t0 = time.perf_counter()
        states = [engine.fold_group(kernel, [ch]) for ch in groups]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = engine.finalize_group(kernel, engine.merge_tree(kernel, states))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        by_verb[vname] = {k: n for k, n in read_launches().items() if n}
        for k, n in by_verb[vname].items():
            gs_launches[k] += n
        t_fold += t1 - t0
        t_merge += t2 - t1
        same_result(torch, f"merge_tree {vname} vs run_streaming", out,
                    run_streaming(kernel, groups, device="cuda"))
        t3 = time.perf_counter()
        want = cpu_results[vname] = run_streaming(kernel, cpu_groups)
        t_plain += time.perf_counter() - t3
        same_result(torch, f"merge_tree {vname} vs cpu_plain_stream", out, want,
                    flow_atol=1e-6)
        merged_ok.append(vname)
    del groups, states, out
    if not by_verb["eventually_follows"].get("segmented_sum_scan"):
        raise AssertionError(f"eventually_follows group states launched no "
                             f"segmented_sum_scan: {by_verb}")
    for vname in ("reachability", "bottleneck_paths", "node_centrality"):
        if not (by_verb[vname].get("semiring_closure")
                or by_verb[vname].get("semiring_matmul")):
            raise AssertionError(f"{vname} group states launched no semiring "
                                 f"kernel: {by_verb}")

    # execute_grouped twice: the second collect is served from the cache
    statecache.state_cache().clear()
    grouped = {}
    band_plan = plans["case_band"][0]
    for kname, k in kernels.items():
        fp = statecache.spec_fingerprint(kname, dims)
        t0 = time.perf_counter()
        first, rep1 = qexec.execute_grouped(band_plan, k, fp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        second, rep2 = qexec.execute_grouped(band_plan, k, fp)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = dfg_host if kname == "dfg" else fp_host
        for i, (x, y, z) in enumerate(zip(host(first), host(second),
                                          host(got["case_band", kname]))):
            check_equal(f"execute_grouped {kname}[{i}] first vs execute", x, z)
            check_equal(f"execute_grouped {kname}[{i}] cached vs first", y, x)
        if not (rep2.groups_read == 0 and rep2.groups_cached == rep1.groups_read > 0):
            raise AssertionError(f"execute_grouped {kname} missed the cache: "
                                 f"{rep1.to_dict()} then {rep2.to_dict()}")
        grouped[kname] = {"first_s": t1 - t0, "cached_s": t2 - t1,
                          "first": {f: getattr(rep1, f) for f in (
                              "groups_read", "groups_folded", "groups_cached",
                              "groups_skipped", "groups_proved")},
                          "cached": {f: getattr(rep2, f) for f in (
                              "groups_read", "groups_folded", "groups_cached",
                              "groups_skipped", "groups_proved")},
                          "cache_bytes": statecache.state_cache().bytes}

    # the prefetch thread: a full scan of L1 through the query layer (the
    # DFG, two columns) at depth 0 and 1, in turns 0, 1, 1, 0
    reader = edf.pooled_reader(path)
    decode = {"s": 0.0}
    inner = reader.read_group_numpy

    def timed_read(index, columns=None):
        t0 = time.perf_counter()
        out = inner(index, columns)
        decode["s"] += time.perf_counter() - t0
        return out

    full = query.Plan(path).project([CASE, ACTIVITY])
    runs, results = [], {}
    reader.read_group_numpy = timed_read
    try:
        for depth in (0, 1, 1, 0):
            decode["s"] = 0.0
            t0 = time.perf_counter()
            res, rep = query.execute(full, kernels["dfg"], prefetch=depth)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append({"depth": depth, "wall_s": wall,
                         "read_decode_s": decode["s"],
                         "read_decode_share": decode["s"] / wall,
                         "events_per_s": len(case_np) / wall,
                         "groups_read": rep.groups_read})
            results.setdefault(depth, dfg_host(res))
    finally:
        del reader.read_group_numpy
    for i, (x, y) in enumerate(zip(results[0], results[1])):
        check_equal(f"prefetch depth 1 vs 0 [{i}]", y, x)
    for i, (x, y) in enumerate(zip(results[0], numpy_dfg(case_np, act_np,
                                                         NUM_ACTIVITIES))):
        check_equal(f"full query scan [{i}] vs numpy oracle", x, y)
    return ({"phase": "query_path", "events": len(case_np), "chunks": chunks,
             "num_cases": ncases, "file_bytes": total_bytes, "plans": plans_out,
             "launches": launches,
             "group_states": {"verbs": merged_ok, "fold_s": t_fold,
                              "merge_finalize_s": t_merge,
                              "cpu_plain_stream_s": t_plain,
                              "launches": gs_launches,
                              "launches_by_verb": by_verb,
                              "bitwise_equal_to": [
                                  "run_streaming",
                                  "cpu_plain_stream (flow within 1e-6)"]},
             "execute_grouped": grouped, "prefetch": runs,
             "bitwise_equal_to": ["eager_filter_then_mine_on_card",
                                  "plain_lowering_on_card", "numpy_oracle"],
             "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi},
            launches, gs_launches, cpu_results)


def json_same(label: str, got, want, flow_atol: float = 1e-6) -> None:
    """Two JSON payloads equal value for value (their dumps equal), except
    centrality ``flow`` lists, within ``flow_atol``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{label}: keys differ")
        for k in want:
            if k == "flow":
                if not np.allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=flow_atol):
                    raise AssertionError(f"{label}.flow: beyond {flow_atol}")
            else:
                json_same(f"{label}.{k}", got[k], want[k], flow_atol)
    elif isinstance(want, list) and any(isinstance(w, (dict, list)) for w in want):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{label}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            json_same(f"{label}[{i}]", g, w, flow_atol)
    elif json.dumps(got) != json.dumps(want):
        raise AssertionError(f"{label}: {got!r} != {want!r}")


def new_cases(first_case: int, rows: int, dtypes: dict) -> dict:
    """``rows`` rows of fresh cases numbered from ``first_case`` (another
    seed's process model), as host columns in the file's dtypes: the batch
    an append or a later ingest brings."""
    from repro_torch.core import CASE
    from repro_torch.data import synthetic

    cols, _ = synthetic.generate_numpy(num_cases=rows // 4,
                                       num_activities=NUM_ACTIVITIES,
                                       seed=SEED + 1, extra_numeric_attrs=0)
    out = {k: v[:rows] for k, v in cols.items()}
    out[CASE] = out[CASE] + first_case
    return {k: np.ascontiguousarray(v.astype(dtypes[k])) for k, v in out.items()}


def read_counter(reader_cls):
    """Counts every row-group decode of any reader (``read_group_numpy``);
    returns the counter dict and an undo function."""
    inner, count = reader_cls.read_group_numpy, {"n": 0}

    def counted(self, *args, **kwargs):
        count["n"] += 1
        return inner(self, *args, **kwargs)

    reader_cls.read_group_numpy = counted

    def undo():
        reader_cls.read_group_numpy = inner
    return count, undo


def dataset_path(torch, smi: str, path: str, tables: dict, cpu_plain: dict,
                 case_np, act_np, frame_gpu, chunks: int):
    """The ``Dataset`` facade on the card over the L1 file
    (``repro_torch.open(path, device="cuda")``): every registered verb
    through ``collect`` under the eager and the streaming engine and one
    ``profile()`` (the counted drive), each result bitwise equal across
    the engines, to ``run_streaming`` on the card and to the CPU plain
    streams of the earlier phases (centrality ``flow`` within 1e-6); the
    result memo (zero reads on a re-collect, a CPU dataset never served
    the card's result); the dispatch sweep over case bands of 1, 2, 4, 7
    and 14 groups (memo off, state cache cleared before every call,
    synchronized, median of 3) with ``fit_calibration`` over it and
    ``auto``'s regret; windows by groups and by time; and an append of
    524,288 rows of new cases as 8,192-row groups.  Returns the phase's
    line, the drive's launch counts and the appended batch."""
    import dataclasses
    import os
    import shutil

    import repro_torch
    from repro_torch.core import (ACTIVITY, CASE, TIMESTAMP, ChunkedEventFrame,
                                  EventFrame, concat_frames, dfg_kernel, engine,
                                  run_streaming)
    from repro_torch.dataset import engines
    from repro_torch.query import statecache
    from repro_torch.storage import edf

    t_phase = time.perf_counter()
    engines.clear_result_cache()
    statecache.state_cache().clear()
    ds = repro_torch.open(path, device="cuda")
    verbs = tuple(n for n, s in engine.kernel_specs().items() if not s.members)
    dims = engine.Dims(ds.num_activities, ds.num_cases)
    if dims != (NUM_ACTIVITIES, NUM_CASES):
        raise AssertionError(f"dataset dims {dims}")

    # the counted drive: 16 verbs x 2 engines, then profile()
    reset_launches()
    got, secs = {}, {}
    for verb in verbs:
        for eng in ("eager", "streaming"):
            t0 = time.perf_counter()
            res = ds.collect(verb, engine=eng)
            torch.cuda.synchronize()
            secs[verb, eng] = time.perf_counter() - t0
            if res.engine != eng:
                raise AssertionError(f"{verb}: asked {eng}, ran {res.engine}")
            got[verb, eng] = res
    t0 = time.perf_counter()
    prof = ds.profile(engine="eager")
    torch.cuda.synchronize()
    t_profile = time.perf_counter() - t0
    launches = read_launches()
    for key in ("pair_count", "histogram", "segment_reduce", "segmented_polyhash",
                "segmented_sum_scan", "semiring_matmul", "ordered_histogram"):
        if launches[key] == 0:
            raise AssertionError(f"dataset path launched no {key}: {launches}")

    src = ChunkedEventFrame.from_edf(path, device="cuda")
    for verb in verbs:
        eager, streamed = got[verb, "eager"].result, got[verb, "streaming"].result
        same_result(torch, f"dataset {verb} streaming vs eager", streamed, eager)
        same_result(torch, f"dataset {verb} profile vs eager", prof[verb], eager)
        ref = run_streaming(engine.kernel_spec(verb).make(dims), src)
        same_result(torch, f"dataset {verb} vs run_streaming", eager, ref)
        same_result(torch, f"dataset {verb} vs cpu_plain_stream", eager,
                    cpu_plain[verb], flow_atol=1e-6)
    del src, prof

    # the memo: a re-collect reads nothing; a CPU dataset mines anew
    count, undo = read_counter(edf.EDFReader)
    try:
        first = got["dfg", "streaming"]
        again = ds.collect("dfg", engine="streaming")
        memo_reads = count["n"]
        on_cpu = repro_torch.open(path, device="cpu").collect("dfg", engine="streaming")
        cpu_reads = count["n"] - memo_reads
    finally:
        undo()
    if again is not first or memo_reads:
        raise AssertionError(f"memoized collect read {memo_reads} groups")
    if on_cpu is first or on_cpu.result.counts.device.type != "cpu" or not cpu_reads:
        raise AssertionError("the CPU dataset was served the card's result")
    same_result(torch, "dataset dfg on the CPU", first.result, on_cpu.result)
    del got, again, on_cpu

    # the dispatch sweep: DFG over case bands, memo off, cache cleared
    reader = edf.pooled_reader(path)
    zones = [reader.group_meta(g)["zones"] for g in range(reader.num_groups)]
    mins = [int(z[CASE]["min"]) for z in zones]
    spec = engine.kernel_spec("dfg")
    sweep = []
    os.environ[engines.RESULT_CACHE_ENV] = "0"
    try:
        for k in SWEEP_GROUPS:
            hi = mins[k] - 1 if k < len(mins) else int(case_np[-1])
            band = ds.filter(repro_torch.col(CASE) <= hi)
            times = {"eager": [], "streaming": []}
            for _ in range(SWEEP_REPEATS):
                for eng in ("eager", "streaming"):
                    statecache.state_cache().clear()
                    t0 = time.perf_counter()
                    res = band.collect("dfg", engine=eng)
                    torch.cuda.synchronize()
                    times[eng].append(time.perf_counter() - t0)
                    if eng == "streaming":
                        rep = res.report
            est = engines.estimate(band)
            sweep.append({"case_hi": hi, "groups_total": rep.groups_total,
                          "groups_skipped": rep.groups_skipped,
                          "bytes_total": rep.bytes_total, "bytes_read": rep.bytes_read,
                          "read_fraction": rep.bytes_read / rep.bytes_total,
                          "us_eager": 1e6 * float(np.median(times["eager"])),
                          "us_streaming": 1e6 * float(np.median(times["streaming"])),
                          "eager_s": times["eager"], "streaming_s": times["streaming"],
                          "estimate": {"bytes_est": est.bytes_est,
                                       "groups_est": est.groups_est},
                          "auto_builtin": engines.choose(band, spec, est)})
    finally:
        del os.environ[engines.RESULT_CACHE_ENV]
    fitted = engines.fit_calibration({"sweep": sweep})
    builtin = engines.calibration()
    for p in sweep:
        band = ds.filter(repro_torch.col(CASE) <= p["case_hi"])
        est = engines.estimate(band)
        pick = "streaming" if fitted.streaming_us(est) <= fitted.eager_us(est) else "eager"
        best = min(p["us_eager"], p["us_streaming"])
        p["auto_fitted"] = pick
        p["regret_fitted"] = p["us_" + pick] / best
        p["regret_builtin"] = p["us_" + p["auto_builtin"]] / best

    # windows by row groups: each window bitwise the scratch mine of its
    # rows; a second sweep folds nothing
    statecache.state_cache().clear()
    w = ds.window(by="groups", size=4, step=2)
    t0 = time.perf_counter()
    wres = w.collect("dfg")
    torch.cuda.synchronize()
    t_win = time.perf_counter() - t0
    kern = dfg_kernel(NUM_ACTIVITIES)
    for (lo, hi), res in zip(wres.bounds, wres.results):
        rows = slice(lo * ROW_GROUP_ROWS, min(hi * ROW_GROUP_ROWS, len(case_np)))
        part = EventFrame({k: v[rows] for k, v in frame_gpu.columns.items()})
        same_result(torch, f"window groups {lo}:{hi} vs scratch", res,
                    engine.run_single(kern, part))
    t0 = time.perf_counter()
    wres2 = w.collect("dfg")
    torch.cuda.synchronize()
    t_win2 = time.perf_counter() - t0
    if wres2.report.groups_folded or wres2.report.groups_read:
        raise AssertionError(f"second window sweep folded: {wres2.report.to_dict()}")
    # windows by time: four tumbling windows, each the same filter collected
    t_lo = min(float(z[TIMESTAMP]["min"]) for z in zones)
    t_hi = max(float(z[TIMESTAMP]["max"]) for z in zones)
    size = (t_hi - t_lo) / 4 * 1.0001
    wt = ds.window(by="time", size=size, step=size)
    t0 = time.perf_counter()
    tres = wt.collect("dfg")
    torch.cuda.synchronize()
    t_time = time.perf_counter() - t0
    if len(tres.bounds) != 4:
        raise AssertionError(f"time windows: {tres.bounds}")
    for (a, b), res in zip(tres.bounds, tres.results):
        direct = ds.filter(repro_torch.col(TIMESTAMP).between(a, b)).collect(
            "dfg", engine="eager").result
        same_result(torch, f"time window {a}..{b} vs filter", res, direct)

    # append: 524,288 rows of new cases after L1's tail, as 8,192-row groups
    out_dir = Path(path).parent
    grown, again_np = str(out_dir / "L1_append.edf"), str(out_dir / "L1_append_np.edf")
    shutil.copyfile(path, grown)
    shutil.copyfile(path, again_np)
    dtypes = {k: np.dtype(m["dtype"]) for k, m in reader.schema.items()}
    batch = new_cases(int(case_np[-1]) + 1, APPEND_ROWS, dtypes)
    cap = 1 << 20
    gds = repro_torch.open(grown, num_cases=cap, device="cuda")
    statecache.state_cache().clear()
    gds.collect("dfg", engine="streaming")           # warms the state cache
    batch_gpu = EventFrame.from_numpy(batch, device="cuda")
    t0 = time.perf_counter()
    gds.append(batch_gpu, row_group_rows=APPEND_GROUP_ROWS)
    t_append = time.perf_counter() - t0
    edf.append(again_np, EventFrame.from_numpy(batch, device="cpu"),
               row_group_rows=APPEND_GROUP_ROWS)
    same_bytes = Path(grown).read_bytes() == Path(again_np).read_bytes()
    if not same_bytes:
        raise AssertionError("the append from the card and the numpy re-run differ")
    t0 = time.perf_counter()
    after = gds.collect("dfg", engine="streaming")
    torch.cuda.synchronize()
    t_recollect = time.perf_counter() - t0
    fresh = -(-APPEND_ROWS // APPEND_GROUP_ROWS)
    rep = after.report
    if not (rep.groups_cached == chunks and rep.groups_folded == fresh == rep.groups_read):
        raise AssertionError(f"re-collect after append: {rep.to_dict()}")
    whole = concat_frames([frame_gpu.select([CASE, ACTIVITY]),
                           batch_gpu.select([CASE, ACTIVITY])])
    same_result(torch, "appended dfg vs whole-log mine", after.result,
                engine.run_single(kern, whole))
    oracle = numpy_dfg(np.concatenate([case_np, batch[CASE]]),
                       np.concatenate([act_np, batch[ACTIVITY]]), NUM_ACTIVITIES)
    for name, x in zip(("counts", "starts", "ends"), oracle):
        check_equal(f"appended dfg {name} vs numpy", getattr(after.result, name).cpu().numpy(), x)
    for p in (grown, again_np):
        Path(p).unlink()
    engines.clear_result_cache()
    statecache.state_cache().clear()
    return ({"phase": "dataset_path", "events": len(case_np), "chunks": chunks,
             "verbs": list(verbs),
             "seconds": {f"{v}/{e}": t for (v, e), t in secs.items()},
             "profile_eager_s": t_profile, "launches": launches,
             "bitwise_equal_to": ["eager == streaming == profile",
                                  "run_streaming on the card",
                                  "cpu_plain_stream (flow within 1e-6)"],
             "memo": {"reads_on_recollect": memo_reads, "cpu_dataset_reads": cpu_reads},
             "sweep": sweep,
             "calibration_fitted": dataclasses.asdict(fitted),
             "calibration_builtin": dataclasses.asdict(builtin),
             "windows": {"groups": {"bounds": len(wres.bounds), "first_s": t_win,
                                    "second_s": t_win2,
                                    "first": wres.report.to_dict(),
                                    "second": wres2.report.to_dict()},
                         "time": {"bounds": [list(b) for b in tres.bounds],
                                  "seconds": t_time}},
             "append": {"rows": APPEND_ROWS, "group_rows": APPEND_GROUP_ROWS,
                        "append_s": t_append, "recollect_s": t_recollect,
                        "groups_cached": rep.groups_cached,
                        "groups_folded": rep.groups_folded,
                        "bytes_equal_numpy_rerun": same_bytes},
             "seconds_total": time.perf_counter() - t_phase, "nvidia_smi": smi},
            launches, batch)


SHARD_COUNTS = (1, 2, 4, 8)
SHARD_VERBS = ("dfg", "discovery", "alpha", "heuristics", "graph", "reachability",
               "bottleneck_paths", "node_centrality")
MERGE_TREE_VERBS = ("case_sizes", "case_durations", "activity_counts",
                    "eventually_follows")
SHARD_BAND = (400_000, 620_000)      # query_path's case band: 10 of 14 groups refuted
SORT_SHARDS = 8


def numpy_sort_buckets(case, act, ts, n: int, slack: float):
    """Independent host oracle of the distributed sort-by-case: shard *i*
    (rows ``[i N/n, (i+1) N/n)``) sends its rows of ``case % n == j``, in
    order, to shard *j* in a bucket of ``cap`` slots (fill -1 / -1 / inf);
    each shard lexsorts what it received by (case, ts).  Returns the
    per-shard ``(case, act, ts)`` and whether a bucket overflowed."""
    per = case.shape[0] // n
    cap = int(per * slack / n + 1)
    bc = np.full((n, n, cap), -1, np.int32)
    ba = np.full((n, n, cap), -1, np.int32)
    bt = np.full((n, n, cap), np.inf, np.float32)
    overflow = False
    for i in range(n):
        c, a, t = (x[i * per:(i + 1) * per] for x in (case, act, ts))
        for j in range(n):
            rows = np.nonzero(c % n == j)[0]
            overflow |= rows.size > cap
            rows = rows[:cap]
            bc[i, j, :rows.size], ba[i, j, :rows.size] = c[rows], a[rows]
            bt[i, j, :rows.size] = t[rows]
    out = []
    for j in range(n):
        cc, aa, tt = bc[:, j].reshape(-1), ba[:, j].reshape(-1), bt[:, j].reshape(-1)
        o = np.lexsort((tt, cc))
        out.append((cc[o], aa[o], tt[o]))
    return out, overflow


def distributed_path(torch, smi: str, path: str, cpu_plain: dict, case_np,
                     act_np, ts_np, chunks: int):
    """The sharded engine on the card: ``repro_torch.open(L1).collect(...,
    engine="sharded", num_shards=n)`` for n = 1, 2, 4, 8 (every shard on the
    one card, the single-controller mesh).  The counted drive: the DFG,
    discovery / alpha / heuristics, the four graph verbs, variants over a
    pruned case band (ghost rows), the merge-tree verbs and one
    ``collect_many``, each bitwise equal to the streaming engine on the
    card, the CPU plain streams and the numpy oracles (centrality ``flow``
    within 1e-6 of the CPU).  Then the DFG's events/s at each n beside the
    streaming DFG (median of 3, memo off), the stage split of one more
    collect at each n (gather, host padding, copies to the shards, shard
    updates, ``psum``, tail fix; each stage synchronized), the idle share
    of one 8-shard collect, and ``sort_by_case_sharded`` of L1 scrambled
    over 8 shards against a numpy oracle.  Returns the phase's line and the
    drive's launch counts."""
    import os

    import repro_torch
    from repro_torch.core import ACTIVITY, CASE, TIMESTAMP, EventFrame
    from repro_torch.dataset import engines
    from repro_torch.distributed import dfg as ddfg
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed import query as dq
    from repro_torch.distributed import sort as dsort
    from repro_torch.query import statecache

    t_phase = time.perf_counter()
    engines.clear_result_cache()
    statecache.state_cache().clear()
    col = repro_torch.col
    ds = repro_torch.open(path, device="cuda")
    band = ds.filter((col(CASE) >= SHARD_BAND[0]) & (col(CASE) <= SHARD_BAND[1]))
    ds.collect("dfg", engine="sharded", num_shards=8)      # warm-up: first use
    torch.cuda.synchronize()
    engines.clear_result_cache()

    # the counted drive
    reset_launches()
    got, secs, by_collect = {}, {}, {}

    def drive(key, fn):
        before = read_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        by_collect[key] = {k: v - before[k] for k, v in read_launches().items()
                           if v - before[k]}
        if res.engine != "sharded":
            raise AssertionError(f"{key}: ran {res.engine}")
        got[key] = res
    for n in SHARD_COUNTS:
        for verb in SHARD_VERBS + MERGE_TREE_VERBS:
            drive(f"{verb}@{n}", lambda: ds.collect(verb, engine="sharded", num_shards=n))
        drive(f"variants_band@{n}",
              lambda: band.collect("variants", engine="sharded", num_shards=n))
        drive(f"collect_many@{n}", lambda: ds.collect_many(
            ("dfg", "alpha", "heuristics", "variants", "graph"),
            engine="sharded", num_shards=n))
    launches = read_launches()

    # gates: launches, then every result against the streaming engine on
    # the card, the CPU plain streams and the numpy oracles
    for n in SHARD_COUNTS:
        d_l, v_l = by_collect[f"dfg@{n}"], by_collect[f"variants_band@{n}"]
        if d_l.get("pair_count", 0) < n or d_l.get("histogram", 0) < 2 * n:
            raise AssertionError(f"sharded dfg@{n} launched {d_l}")
        if (v_l.get("segmented_affine") != 4 * n
                or v_l.get("segment_reduce") != 2 * n):
            raise AssertionError(f"sharded variants@{n} launched {v_l}")
        if by_collect[f"discovery@{n}"].get("pair_count", 0) < 2 * n:
            raise AssertionError(f"sharded discovery@{n}: {by_collect}")
    for key in ("pair_count", "histogram", "segment_reduce", "segmented_affine",
                "semiring_matmul", "semiring_closure", "segmented_sum_scan"):
        if launches[key] == 0:
            raise AssertionError(f"distributed path launched no {key}: {launches}")
    oracle = numpy_dfg(case_np, act_np, NUM_ACTIVITIES)
    l2_oracle = numpy_l2_counts(case_np, act_np, NUM_ACTIVITIES)
    streamed = {v: ds.collect(v, engine="streaming").result
                for v in SHARD_VERBS + MERGE_TREE_VERBS}
    band_streamed = band.collect("variants", engine="streaming")
    for n in SHARD_COUNTS:
        for verb in SHARD_VERBS + MERGE_TREE_VERBS:
            res = got[f"{verb}@{n}"]
            same_result(torch, f"sharded {verb}@{n} vs streaming", res.result,
                        streamed[verb])
            same_result(torch, f"sharded {verb}@{n} vs cpu_plain_stream",
                        res.result, cpu_plain[verb], flow_atol=1e-6)
        d = got[f"dfg@{n}"].result
        for name, x in zip(("counts", "starts", "ends"), oracle):
            check_equal(f"sharded dfg@{n} {name} vs numpy", getattr(d, name).cpu().numpy(), x)
        check_equal(f"sharded l2@{n} vs numpy",
                    got[f"discovery@{n}"].result.l2_counts.cpu().numpy(), l2_oracle)
        vb = got[f"variants_band@{n}"]
        if vb.report.groups_skipped == 0:
            raise AssertionError(f"variants band@{n} skipped no group")
        if vb.report.groups_skipped != band_streamed.report.groups_skipped:
            raise AssertionError(f"variants band@{n} skipped {vb.report.to_dict()}, "
                                 f"streaming {band_streamed.report.to_dict()}")
        same_result(torch, f"sharded variants band@{n} vs streaming", vb.result,
                    band_streamed.result)
        many = got[f"collect_many@{n}"]
        for verb in ("dfg", "alpha", "heuristics", "graph"):
            same_result(torch, f"collect_many {verb}@{n}", many[verb], streamed[verb])
        same_result(torch, f"collect_many variants@{n}", many["variants"],
                    cpu_plain["variants"])
        counts = got[f"dfg@{n}"].result.counts
        if counts.device.type != "cpu" or not counts.is_pinned():
            raise AssertionError("the sharded answer is not in pinned host memory")

    # throughput: the DFG at each shard count beside streaming, memo off
    os.environ[engines.RESULT_CACHE_ENV] = "0"
    try:
        rates = {}
        for n in (0,) + SHARD_COUNTS:       # 0: the streaming engine
            times = []
            for _ in range(3):
                statecache.state_cache().clear()
                t0 = time.perf_counter()
                if n:
                    ds.collect("dfg", engine="sharded", num_shards=n)
                else:
                    ds.collect("dfg", engine="streaming")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            rates["streaming" if n == 0 else f"sharded@{n}"] = {
                "seconds": times, "median_s": float(np.median(times)),
                "events_per_s": len(case_np) / float(np.median(times))}

        # the stage split: each stage synchronized on both sides
        split = {}
        stages = ((dq, "_gather", "gather"), (dq, "_pad_to_shards", "pad"),
                  (dq, "shard_columns", "copy"), (ddfg, "_update_shards", "update"),
                  (ddfg, "psum", "psum"), (dq, "_finish_state", "tail_fix"))
        inner = {(m, name): getattr(m, name) for m, name, _ in stages}

        def timed(fn, key, acc):
            def wrapped(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
                return out
            return wrapped
        for n in SHARD_COUNTS:
            acc = {}
            for m, name, key in stages:
                setattr(m, name, timed(inner[m, name], key, acc))
            try:
                t0 = time.perf_counter()
                ds.collect("dfg", engine="sharded", num_shards=n)
                torch.cuda.synchronize()
                acc["wall"] = time.perf_counter() - t0
            finally:
                for m, name, _ in stages:
                    setattr(m, name, inner[m, name])
            split[n] = acc
        wall8 = rates["sharded@8"]["median_s"]
        idle = idle_share(torch, lambda: ds.collect("dfg", engine="sharded",
                                                    num_shards=8), wall8)
    finally:
        del os.environ[engines.RESULT_CACHE_ENV]

    # the distributed sort: L1 scrambled, padded to 8 shards with -1 rows
    pad = (-len(case_np)) % SORT_SHARDS
    s_case = np.concatenate([case_np.astype(np.int32), np.full(pad, -1, np.int32)])
    s_act = np.concatenate([act_np.astype(np.int32), np.full(pad, -1, np.int32)])
    s_ts = np.concatenate([ts_np.astype(np.float32), np.full(pad, -1, np.float32)])
    perm = np.random.default_rng(SEED).permutation(s_case.shape[0])
    s_case, s_act, s_ts = s_case[perm], s_act[perm], s_ts[perm]
    scrambled = EventFrame.from_numpy({CASE: s_case, ACTIVITY: s_act, TIMESTAMP: s_ts},
                                      device="cuda")
    mesh = dmesh.mesh_for(SORT_SHARDS, "cuda")
    dsort.sort_by_case_sharded(scrambled, mesh)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc, sa, st, overflow = dsort.sort_by_case_sharded(scrambled, mesh)
    torch.cuda.synchronize()
    t_sort = time.perf_counter() - t0
    sort_profile = idle_share(torch, lambda: dsort.sort_by_case_sharded(scrambled, mesh),
                              t_sort)
    want, want_over = numpy_sort_buckets(s_case, s_act, s_ts, SORT_SHARDS, 2.0)
    if int(overflow) != 0 or want_over:
        raise AssertionError(f"sort overflowed at slack 2: {int(overflow)}, {want_over}")
    for j, (c, a, t) in enumerate(want):
        for label, x, y in (("case", sc[j], c), ("act", sa[j], a), ("ts", st[j], t)):
            if x.device.type != "cuda":
                raise AssertionError("a sorted shard left the card")
            check_equal(f"sorted shard {j} {label} vs numpy", x.cpu().numpy(), y)
    engines.clear_result_cache()
    statecache.state_cache().clear()
    return ({"phase": "distributed_path", "events": len(case_np), "chunks": chunks,
             "shard_counts": list(SHARD_COUNTS), "devices": torch.cuda.device_count(),
             "mesh": "single controller, shard i on cuda:(i % device_count)",
             "seconds": secs, "launches": launches, "launches_by_collect": by_collect,
             "dfg_rates": rates,
             "dfg_stage_split_s": {str(n): v for n, v in split.items()},
             "profile_8_shards": idle,
             "sort": {"shards": SORT_SHARDS, "rows": int(s_case.shape[0]),
                      "slack": 2.0, "overflow": int(overflow), "seconds": t_sort,
                      "profile": sort_profile,
                      "bitwise_equal_to": ["numpy_bucket_oracle"]},
             "bitwise_equal_to": ["streaming engine on the card",
                                  "cpu_plain_stream (flow within 1e-6)",
                                  "numpy_dfg_oracle", "numpy_triple_oracle"],
             "seconds_total": time.perf_counter() - t_phase, "nvidia_smi": smi},
            launches)


def http_get(port: int, route: str, timeout: float = 600.0) -> tuple[dict, float]:
    """One GET against the local service: the decoded JSON and the
    client's wall seconds."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=timeout) as r:
        body = r.read()
    return json.loads(body), time.perf_counter() - t0


def batch_files(out: Path, cols: dict, tables: dict, rows: int, prefix: str) -> int:
    """Cut host columns at case boundaries into batch ``.edf`` files of
    about ``rows`` rows each (one row group a file); returns the count."""
    from repro_torch.core import CASE, EventFrame
    from repro_torch.storage import edf

    out.mkdir(parents=True, exist_ok=True)
    case = cols[CASE]
    heads = np.flatnonzero(np.r_[True, case[1:] != case[:-1]])
    cuts = [0]
    for target in range(rows, len(case), rows):
        i = int(np.searchsorted(heads, target))
        if i < len(heads) and heads[i] > cuts[-1]:
            cuts.append(int(heads[i]))
    cuts.append(len(case))
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        frame = EventFrame.from_numpy({k: v[lo:hi] for k, v in cols.items()},
                                      device="cpu")
        edf.write(str(out / f"{prefix}_{i:05d}.edf"), frame, tables, version=3)
    return len(cuts) - 1


def service_path(torch, smi: str, tables: dict, case_np, act_np, ts_np,
                 new_batch: dict):
    """The mining service on the card: the first ``SERVICE_ROWS`` rows of
    L1 (to a case boundary) cut into batch files on the host, ingested
    with the defaults (500,000-row partitions, 8,192-row groups), then
    ``serve(...)`` on 127.0.0.1, port
    0, answering ``/health``, ``/collect`` (dfg, auto and eager; variants),
    ``/profile``, ``/window``, ``/graph?query=reachability`` and
    ``/explain`` (the counted drive), each result JSON-equal to the same
    verb mined eagerly on the card from the claimed rows (``flow`` within
    1e-6); then three ``/collect?verb=dfg`` raced against an ingest
    thread appending ``new_batch``, each equal to the eager mine of the
    rows its snapshot claims; and the idle share of one ``/collect``."""
    import shutil
    import threading

    import repro_torch
    from repro_torch.core import ACTIVITY, CASE, TIMESTAMP, EventFrame, concat_frames
    from repro_torch.dataset import engines
    from repro_torch.query import statecache
    from repro_torch.service import Ingestor, serve, to_jsonable
    from repro_torch.storage import edf

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "service"
    shutil.rmtree(root, ignore_errors=True)
    # the first partitions only: ingesting the whole log made the phase
    # ~75 s on the card, over its ~60 s share of the script
    base = int(np.searchsorted(case_np, case_np[min(SERVICE_ROWS, len(case_np)) - 1],
                               side="right"))
    cols = {CASE: case_np[:base], ACTIVITY: act_np[:base], TIMESTAMP: ts_np[:base]}
    t0 = time.perf_counter()
    n_batches = batch_files(root / "batches", cols, tables, SERVICE_BATCH_ROWS,
                            "batch")
    t_cut = time.perf_counter() - t0
    ing = Ingestor(str(root / "parts"), str(root / "batches"))
    t0 = time.perf_counter()
    applied = ing.run_once()
    t_ingest = time.perf_counter() - t0
    parts = ing.paths
    groups = sum(edf.num_row_groups(p) for p in parts)
    if applied != n_batches or sum(edf.read_header(p)[0]["nrows"] for p in parts) \
            != base:
        raise AssertionError(f"ingest applied {applied} of {n_batches} batches")

    engines.clear_result_cache()
    statecache.state_cache().clear()
    httpd = serve(str(root / "parts"), host="127.0.0.1", port=0, device="cuda")
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    frame_gpu = EventFrame.from_numpy(cols, device="cuda")
    prefix_cache = {}

    def eager_ds(rows: int, cap: int):
        """The claimed rows (a prefix of L1, then of the appended batch) as
        an in-memory dataset on the card."""
        frame = prefix_cache.get(rows)
        if frame is None:
            if rows <= base:
                frame = EventFrame({k: v[:rows] for k, v in frame_gpu.columns.items()})
            else:
                extra = EventFrame.from_numpy(
                    {k: v[:rows - base] for k, v in new_batch.items()},
                    device="cuda")
                frame = concat_frames([frame_gpu, extra])
            prefix_cache.clear()
            prefix_cache[rows] = frame
        return repro_torch.open(frame, tables=tables, num_cases=cap, device="cuda")

    def reference(label, out, fn):
        claim = out["snapshot"]
        want = to_jsonable(fn(eager_ds(claim["rows"], claim["num_cases"])))
        json_same(label, out["result"] if "result" in out else out["results"], want)

    try:
        requests, results = {}, {}
        reset_launches()
        for name, route in SERVICE_ROUTES:
            out, secs = http_get(port, route)
            torch.cuda.synchronize()
            if not out.get("ok"):
                raise AssertionError(f"{route}: {out}")
            results[name] = out
            rep = out.get("report") or {}
            requests[name] = {"route": route, "seconds": secs,
                              "elapsed_us": out.get("elapsed_us"),
                              "engine": out.get("engine"),
                              "groups_read": rep.get("groups_read"),
                              "groups_cached": rep.get("groups_cached"),
                              "groups_folded": rep.get("groups_folded")}
        launches = read_launches()
        for key in ("pair_count", "histogram", "segmented_polyhash", "segment_reduce"):
            if launches[key] == 0:
                raise AssertionError(f"service path launched no {key}: {launches}")

        health = results["health"]
        if health["rows"] != base or len(health["files"]) != len(parts):
            raise AssertionError(f"health: {health}")
        for name in ("collect_dfg", "collect_dfg_eager"):
            reference(name, results[name],
                      lambda ds: ds.collect("dfg", engine="eager").result)
        reference("collect variants", results["collect_variants"],
                  lambda ds: ds.collect("variants", engine="eager").result)
        reference("profile", results["profile"],
                  lambda ds: ds.profile(engine="eager").results)
        win = results["window"]
        claim = win["snapshot"]
        offsets = np.cumsum([0] + [g["nrows"] for p in parts
                                   for g in edf.read_header(p)[0]["groups"]
                                   if g["nrows"]])
        claimed = eager_ds(claim["rows"], claim["num_cases"])
        for (lo, hi), res in zip(win["bounds"], win["results"]):
            part = EventFrame({k: v[int(offsets[lo]):int(offsets[hi])]
                               for k, v in claimed.frame.columns.items()})
            want = repro_torch.open(part, tables=tables, num_cases=claim["num_cases"],
                                    device="cuda").collect("dfg", engine="eager").result
            json_same(f"window {lo}:{hi}", res, to_jsonable(want))
        g = results["graph"]
        ds = eager_ds(g["snapshot"]["rows"], g["snapshot"]["num_cases"])
        graph = ds.collect("graph", engine="eager").result.with_labels(tables[ACTIVITY])
        json_same("graph freq", g["graph"]["freq"], to_jsonable(graph.freq))
        json_same("graph query", g["query"], to_jsonable(
            ds.collect("reachability", engine="eager").result))
        if g["graph"]["labels"] != list(graph.node_labels()):
            raise AssertionError("graph labels")
        explain = results["explain"]["explain"]
        if "state-cache" not in explain or "engine " not in explain:
            raise AssertionError(f"explain: {explain}")

        # the idle share of one cold /collect (memo and state cache cleared)
        def cold_collect():
            engines.clear_result_cache()
            statecache.state_cache().clear()
            http_get(port, "/collect?verb=dfg&engine=streaming")

        t0 = time.perf_counter()
        cold_collect()
        torch.cuda.synchronize()
        idle = idle_share(torch, cold_collect, time.perf_counter() - t0)

        # a raced request: an ingest thread appends the new cases while
        # three /collect?verb=dfg requests run
        n_race = batch_files(root / "batches2", new_batch, tables,
                             -(-len(new_batch[CASE]) // RACE_BATCHES), "race")
        racer = Ingestor(str(root / "parts"), str(root / "batches2"), poll_interval=0.01)
        raced, errors = [], []

        def client():
            try:
                raced.append(http_get(port, "/collect?verb=dfg"))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client) for _ in range(3)]
        clients[0].start()                     # pins the pre-ingest snapshot
        racer.start()
        for c in clients[1:]:
            time.sleep(0.05)
            c.start()
        for c in clients:
            c.join(timeout=600)
        while racer.ingested < n_race and time.perf_counter() - t0 < 600:
            time.sleep(0.05)
        racer.stop()
        t_race = time.perf_counter() - t0
        if errors or len(raced) != 3 or racer.ingested != n_race:
            raise AssertionError(f"raced requests: {errors}, {len(raced)} answers, "
                                 f"{racer.ingested} of {n_race} batches")
        race_rows = []
        for i, (out, secs) in enumerate(raced):
            reference(f"raced collect {i}", out,
                      lambda ds: ds.collect("dfg", engine="eager").result)
            race_rows.append({"seconds": secs, "rows": out["snapshot"]["rows"],
                              "files": len(out["snapshot"]["files"]),
                              "engine": out["engine"]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
        engines.clear_result_cache()
        statecache.state_cache().clear()
    return ({"phase": "service_path", "events": base,
             "reduced": {"rows": base, "of": len(case_np),
                         "reason": "the first partitions of L1 only: the whole log "
                                   "made the phase ~75 s on the card, over its "
                                   "~60 s share of the script"},
             "batches": n_batches, "batch_rows": SERVICE_BATCH_ROWS,
             "partitions": len(parts), "groups": groups,
             "partition_rows": ing.partition_rows, "row_group_rows": ing.row_group_rows,
             "cut_s": t_cut, "ingest_s": t_ingest, "ingest_rows_per_s": base / t_ingest,
             "requests": requests, "launches": launches,
             "collect_profile": idle,
             "raced": {"batches": n_race, "rows": len(new_batch[CASE]), "seconds": t_race,
                       "requests": race_rows},
             "bitwise_equal_to": ["eager mine on the card of the claimed rows "
                                  "(JSON; flow within 1e-6)"],
             "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi},
            launches)


def check_equal(label: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.dtype != want.dtype or got.shape != want.shape \
            or not np.array_equal(got, want):
        raise AssertionError(f"{label}: not bitwise equal")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import graph as tgraph
    from repro_torch.core import (ACTIVITY, CASE, TIMESTAMP, ChunkedEventFrame,
                                  EventFrame, conformance, dfg, dfg_kernel,
                                  discovery, engine, filtering, performance,
                                  polyhash, run_streaming, stats_kernel,
                                  variants)
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_ops as so
    from repro_torch.storage import edf

    # ---------------------------------------------------------------- device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ----------------------------------------------------------------- build
    counting_only = "--counting" in sys.argv[1:]
    semiring_only = "--semiring" in sys.argv[1:]
    train_only = "--train" in sys.argv[1:]
    flash_only = "--flash" in sys.argv[1:]
    serve_only = "--serve" in sys.argv[1:]
    families_only = "--families" in sys.argv[1:]
    train_families_only = "--train-families" in sys.argv[1:]
    launch_only = "--launch" in sys.argv[1:]
    t0 = time.perf_counter()
    log = _build.build(("pair_count", "histogram") if counting_only
                       else ("semiring",) if semiring_only
                       else ("flash_attention", "flash_attention_bwd")
                       if (train_only or flash_only or serve_only or families_only
                           or train_families_only or launch_only)
                       else _build.SOURCES)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                       if "Used" in ln or "spill" in ln
                                       or "entry function" in ln]}
                      for name, v in log.items()}})

    import tempfile

    sweep_dir = tempfile.mkdtemp(prefix="launch_sweep_")
    if launch_only:
        # the launch tooling alone: the sweep beside the real steps
        t0 = time.perf_counter()
        phase, launches = launch_path(torch, smi, start_launch_sweep(sweep_dir))
        emit({**phase, "seconds": time.perf_counter() - t0, "launches": launches})
        return 0

    if counting_only:
        # the counting kernels' times alone; a copy of this script placed in
        # another checkout (a parent commit) times that tree's kernels
        cols, _ = synthetic.generate_numpy(**synthetic.paper_table6_config(1))
        frame_gpu = EventFrame.from_numpy(
            {c: cols[c] for c in (CASE, ACTIVITY, TIMESTAMP)}, device="cuda")
        emit({"phase": "counting_times", "root": str(ROOT), "nvidia_smi": smi,
              "rows": time_counting(torch, so, engine, frame_gpu)})
        return 0

    if semiring_only:
        # the semiring kernels alone; a copy of this script placed in another
        # checkout (a parent commit) times that tree's kernels
        from repro_torch.kernels import graph_ops as go

        if hasattr(go, "semiring_closure_cuda"):
            t0 = time.perf_counter()
            out = {name: {"cases": 0, "max_abs_err": 0.0}
                   for name in ("semiring_matmul", "semiring_closure")}
            check_semiring(torch, torch.Generator(device="cuda").manual_seed(SEED),
                           recorder(torch, out), out)
            torch.cuda.synchronize()
            emit({"phase": "semiring_check", "seconds": time.perf_counter() - t0,
                  "tolerance": "bitwise (closures: NaN positions equal); float "
                               "plus_times within 2 K 2^-24 (|A| @ |B|)", **out})
        g = l1_graph(torch, tgraph, synthetic, (CASE, ACTIVITY, TIMESTAMP))
        emit({"phase": "semiring_times", "root": str(ROOT), "nvidia_smi": smi,
              "nodes": g.num_nodes, "queries": time_graph_queries(torch, tgraph, g),
              "rows": time_semiring_kernels(torch, g)})
        return 0

    if flash_only:
        # the flash-attention kernels alone, checked and timed; a copy of
        # this script placed in another checkout (a parent commit) runs that
        # tree's kernels
        t0 = time.perf_counter()
        out = {name: {"cases": 0, "max_abs_err": 0.0}
               for name in ("flash_attention", "flash_attention_bwd")}
        check_flash(torch, out)
        check_flash_bwd(torch, out)
        torch.cuda.synchronize()
        emit({"phase": "flash_check", "seconds": time.perf_counter() - t0, **out})
        emit({"phase": "flash_times", "root": str(ROOT), "nvidia_smi": smi,
              "rows": time_flash_attention(torch)})
        return 0

    if serve_only:
        # the serving paths alone: eventlm-100m and the head-dim configs,
        # then the MoE family
        for fn in (serve_path, moe_path):
            t0 = time.perf_counter()
            phase, launches = fn(torch, smi)
            emit({**phase, "seconds": time.perf_counter() - t0, "launches": launches})
        return 0

    if families_only:
        # the four other families' serving alone
        t0 = time.perf_counter()
        phase, launches = families_path(torch, smi)
        emit({**phase, "seconds": time.perf_counter() - t0, "launches": launches})
        return 0

    if train_families_only:
        # the families' training alone, after both kernels at its shapes
        t0 = time.perf_counter()
        phase, launches = family_train_path(torch, smi, check_shapes=True)
        emit({**phase, "seconds": time.perf_counter() - t0, "launches": launches})
        return 0

    if train_only:
        # the training path alone; a copy of this script placed in another
        # checkout (a parent commit) runs that tree's training path
        t0 = time.perf_counter()
        train, launches = train_path(torch, smi)
        emit({**train, "root": str(ROOT), "seconds": time.perf_counter() - t0,
              "launches": launches})
        return 0

    # --------------------------------------------------- kernels vs plain
    t0 = time.perf_counter()
    checks = check_kernels(torch, so)
    emit({"phase": "kernels_check", "seconds": time.perf_counter() - t0,
          "tolerance": "bitwise (integer counts, float32 min/max, row-order "
                       "float32 sums, uint32 scans); flash_attention within 2e-5 "
                       "(float32, 3xTF32 products: each within 2^-20 of itself) / "
                       "2e-2 and 2^-8 P.|V| + 2^-7 |want| (bf16, P rounded to "
                       "bf16 before P.V: each weight within 2^-9 of itself, and "
                       "each output rounded to bf16); its lse within 2e-5; "
                       "flash_attention_bwd within 1e-5 (1 + |want|) + 2^-19 A "
                       "(A with dP's and Delta's error through P) "
                       "(float32) / 2^-7 (1 + |want|) + 2 2^-8 A (bf16, P and dS "
                       "rounded to bf16) of the plain backward, A its magnitude "
                       "product, two calls bitwise equal; FlashAttention "
                       "gradients within 5e-5 / 3e-2 x (1 + |want|) of autograd "
                       "through the plain forward", **checks})

    # ------------------------------------------------------ data: L1 log
    cfg = synthetic.paper_table6_config(1)
    t0 = time.perf_counter()
    cols, tables = synthetic.generate_numpy(**cfg)
    case_np, act_np, ts_np = cols[CASE], cols[ACTIVITY], cols[TIMESTAMP]
    del cols
    events = int(case_np.shape[0])
    cases = int((case_np[1:] != case_np[:-1]).sum()) + 1
    t_gen = time.perf_counter() - t0

    frame_cpu = EventFrame.from_numpy(
        {CASE: case_np, ACTIVITY: act_np, TIMESTAMP: ts_np}, device="cpu")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "L1.edf")
    t0 = time.perf_counter()
    header = edf.write(path, frame_cpu, {ACTIVITY: tables[ACTIVITY]},
                       codec="zlib1", row_group_rows=ROW_GROUP_ROWS, version=3)
    t_write = time.perf_counter() - t0
    chunks = len(header["groups"])
    emit({"phase": "data", "level": "L1", "config": cfg, "events": events,
          "cases": cases, "row_group_rows": ROW_GROUP_ROWS, "groups": chunks,
          "columns": [CASE, ACTIVITY, TIMESTAMP],
          "file_bytes": Path(path).stat().st_size,
          "generate_s": t_gen, "write_s": t_write})
    launches = {}

    try:
        # ----------------------------------------- main path: streamed DFG
        cols_proj = [CASE, ACTIVITY]
        source = ChunkedEventFrame.from_edf(path, columns=cols_proj, device="cuda")
        kernel = dfg_kernel(NUM_ACTIVITIES)
        run_streaming(kernel, source)          # warm-up: first-use costs
        torch.cuda.synchronize()

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d_gpu = run_streaming(kernel, source)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        launches["main_path"] = read_launches()
        peak = torch.cuda.max_memory_allocated()

        d_staged, stages = staged_stream(torch, kernel, path, cols_proj, edf)
        d_cpu = run_streaming(dfg_kernel(NUM_ACTIVITIES), ChunkedEventFrame.from_edf(
            path, columns=cols_proj, device="cpu"))
        frame_gpu = frame_cpu.to("cuda")
        d_whole = dfg(frame_gpu, NUM_ACTIVITIES)
        d_shift = dfg(frame_gpu, NUM_ACTIVITIES, method="shift")
        oracle = numpy_dfg(case_np, act_np, NUM_ACTIVITIES)

        def host(d):
            return tuple(getattr(d, f).cpu().numpy()
                         for f in ("counts", "starts", "ends"))

        got = host(d_gpu)
        for label, other in (("cpu_plain_stream", host(d_cpu)),
                             ("staged_stream", host(d_staged)),
                             ("whole_log", host(d_whole)),
                             ("shift", host(d_shift)),
                             ("numpy_oracle", oracle)):
            for name, x, y in zip(("counts", "starts", "ends"), got, other):
                check_equal(f"streamed DFG {name} vs {label}", x, y)
        invariants = {
            "counts_sum": int(got[0].sum()), "events_minus_cases": events - cases,
            "starts_sum": int(got[1].sum()), "ends_sum": int(got[2].sum()),
            "cases": cases}
        if not (invariants["counts_sum"] == events - cases
                and invariants["starts_sum"] == cases == invariants["ends_sum"]):
            raise AssertionError(f"count invariants fail: {invariants}")
        main_l = launches["main_path"]
        if main_l["pair_count"] < chunks or main_l["histogram"] < 2 * chunks:
            raise AssertionError(f"main path did not go through the kernels: "
                                 f"{main_l} for {chunks} chunks")
        emit({"phase": "main_path", "events": events, "chunks": chunks,
              "seconds": t_stream, "events_per_s": events / t_stream,
              "stages_s": stages, "max_memory_allocated": peak,
              "launches": main_l,
              "bitwise_equal_to": ["cpu_plain_stream", "staged_stream",
                                   "whole_log", "shift", "numpy_oracle"],
              "invariants": invariants, "nvidia_smi": smi})
        emit({"phase": "main_path_profile",
              **idle_share(torch, lambda: run_streaming(kernel, source), t_stream)})

        # --------------------------- stats path: four statistics, one pass
        stats_cols = [CASE, ACTIVITY, TIMESTAMP]
        s_source = ChunkedEventFrame.from_edf(path, columns=stats_cols, device="cuda")
        s_kernel = stats_kernel(NUM_ACTIVITIES, NUM_CASES)
        run_streaming(s_kernel, s_source)      # warm-up
        torch.cuda.synchronize()

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st_gpu = run_streaming(s_kernel, s_source)
        torch.cuda.synchronize()
        t_stats = time.perf_counter() - t0
        launches["stats_path"] = read_launches()
        s_peak = torch.cuda.max_memory_allocated()

        st_staged, s_stages = staged_stream(torch, s_kernel, path, stats_cols, edf)
        st_cpu = run_streaming(s_kernel, ChunkedEventFrame.from_edf(
            path, columns=stats_cols, device="cpu"))
        st_whole = engine.run_single(s_kernel, frame_gpu)
        st_oracle = numpy_stats(case_np, act_np, ts_np, NUM_ACTIVITIES, NUM_CASES)
        st_got = {k: v.cpu().numpy() for k, v in st_gpu.items()}
        for label, other in (("cpu_plain_stream", st_cpu),
                             ("staged_stream", st_staged),
                             ("whole_log", st_whole),
                             ("numpy_oracle", st_oracle)):
            for name, x in st_got.items():
                y = other[name]
                y = y if isinstance(y, np.ndarray) else y.cpu().numpy()
                check_equal(f"streamed {name} vs {label}", x, y)
        st_l = launches["stats_path"]
        if (st_l["segment_reduce"] < 3 * chunks
                or st_l["ordered_histogram"] < chunks
                or st_l["histogram"] < 2 * chunks):
            raise AssertionError(f"stats path did not go through the kernels: "
                                 f"{st_l} for {chunks} chunks")
        emit({"phase": "stats_path", "events": events, "chunks": chunks,
              "num_cases": NUM_CASES, "seconds": t_stats,
              "events_per_s": events / t_stats, "stages_s": s_stages,
              "max_memory_allocated": s_peak, "launches": st_l,
              "bitwise_equal_to": ["cpu_plain_stream", "staged_stream",
                                   "whole_log", "numpy_oracle"],
              "checks": {"activity_counts_sum": int(st_got["activity_counts"].sum()),
                         "case_sizes_sum": int(st_got["case_sizes"].sum()),
                         "events": events,
                         "sojourn_finite": bool(np.isfinite(
                             st_got["sojourn_times"]).all())},
              "nvidia_smi": smi})
        emit({"phase": "stats_path_profile",
              **idle_share(torch, lambda: run_streaming(s_kernel, s_source), t_stats)})
        stats_cpu = st_cpu                     # dataset_path's stats oracle

        # ----------- filter path: most common activity, case filter, DFG
        def filter_path(src, device):
            act = filtering.streaming_most_common_activity(src, NUM_ACTIVITIES)
            keep = filtering.streaming_cases_containing(src, act, NUM_CASES)
            d = run_streaming(dfg_kernel(NUM_ACTIVITIES),
                              filtering.stream_apply_case_mask(src, keep),
                              device=device)
            return act, keep, d

        filter_path(source, "cuda")            # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        f_act, f_keep, f_dfg = filter_path(source, "cuda")
        torch.cuda.synchronize()
        t_filter = time.perf_counter() - t0
        launches["filter_path"] = read_launches()

        counts_np = np.bincount(act_np, minlength=NUM_ACTIVITIES)
        o_act = int(np.argmax(counts_np))
        seg_np = np.cumsum(np.concatenate([[True], case_np[1:] != case_np[:-1]])) - 1
        o_keep = np.zeros(NUM_CASES, bool)
        o_keep[seg_np[act_np == o_act]] = True
        rows_kept = o_keep[seg_np]
        o_dfg = numpy_dfg(case_np[rows_kept], act_np[rows_kept], NUM_ACTIVITIES)
        if f_act != o_act:
            raise AssertionError(f"most common activity {f_act} != oracle {o_act}")
        check_equal("case keep mask vs numpy oracle", f_keep.cpu().numpy(), o_keep)
        for name, x, y in zip(("counts", "starts", "ends"), host(f_dfg), o_dfg):
            check_equal(f"filtered DFG {name} vs numpy oracle", x, y)
        f_l = launches["filter_path"]
        if (f_l["histogram"] < 3 * chunks or f_l["segment_reduce"] < chunks
                or f_l["pair_count"] < chunks):
            raise AssertionError(f"filter path did not go through the kernels: "
                                 f"{f_l} for {chunks} chunks")
        emit({"phase": "filter_path", "events": events, "chunks": chunks,
              "passes": 3, "seconds": t_filter,
              "events_per_s": 3 * events / t_filter,
              "most_common_activity": f_act, "cases_kept": int(o_keep.sum()),
              "events_kept": int(rows_kept.sum()), "launches": f_l,
              "bitwise_equal_to": ["numpy_oracle"], "nvidia_smi": smi})

        # ------------- variants path: fingerprints, and a ghost stream
        v_kernel = variants.variants_kernel(NUM_CASES)
        run_streaming(v_kernel, source)        # warm-up
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        v_gpu = run_streaming(v_kernel, source)
        torch.cuda.synchronize()
        t_var = time.perf_counter() - t0
        launches["variants_path"] = read_launches()
        v_peak = torch.cuda.max_memory_allocated()

        v_staged, v_stages = staged_stream(torch, v_kernel, path, cols_proj, edf)
        v_cpu = run_streaming(v_kernel, ChunkedEventFrame.from_edf(
            path, columns=cols_proj, device="cpu"))
        v_whole = variants.variant_fingerprints(frame_gpu)
        # every other row group replaced by its ghost chunk
        cuts = list(range(0, events, ROW_GROUP_ROWS))
        g_chunks = list(ChunkedEventFrame.from_cuts(frame_cpu, cuts, device="cuda"))
        ghosts = []
        for gi, lo in enumerate(cuts):
            if gi % 2:
                g_chunks[gi] = ghost_chunk(torch, case_np, act_np, lo,
                                           min(lo + ROW_GROUP_ROWS, events))
                ghosts.append(g_chunks[gi])
        reset_launches()
        v_ghost = run_streaming(v_kernel, g_chunks, device="cuda")
        torch.cuda.synchronize()
        launches["ghost_stream"] = read_launches()
        sk = polyhash.segment_sketch(act_np, case_np)
        v_oracle = []
        for key in ("add1", "add2"):
            fp = np.zeros(NUM_CASES, np.int64)
            fp[:cases] = sk[key]
            v_oracle.append(fp)
        v_oracle.append(np.asarray(cases, np.int32))

        def fps(res):
            return tuple(x.cpu().numpy() for x in res)

        v_got = fps(v_gpu)
        whole_fp = fps(v_whole)
        for label, other in (("cpu_plain_stream", fps(v_cpu)),
                             ("staged_stream", fps(v_staged)),
                             ("whole_log", (whole_fp[0][:NUM_CASES],
                                            whole_fp[1][:NUM_CASES], v_got[2])),
                             ("ghost_stream", fps(v_ghost)),
                             ("numpy_sketch_oracle", tuple(v_oracle))):
            for name, x, y in zip(("fp1", "fp2", "ncases"), v_got, other):
                check_equal(f"streamed variants {name} vs {label}", x, y)
        pairs = np.stack([sk["add1"], sk["add2"]], axis=1).astype(np.int64)
        uniq, n_per = np.unique(pairs, axis=0, return_counts=True)
        o_counts = {(int(u[0]), int(u[1])): int(c) for u, c in zip(uniq, n_per)}
        if variants.variant_counts(frame_gpu) != o_counts:
            raise AssertionError("variant_counts on the card != np.unique oracle")
        if variants.streaming_variant_counts(source, NUM_CASES) != o_counts:
            raise AssertionError("streamed variant counts != np.unique oracle")
        var_l, gh_l = launches["variants_path"], launches["ghost_stream"]
        if (var_l["segmented_polyhash"] < 2 * chunks
                or var_l["segment_reduce"] < 2 * chunks
                or gh_l["segmented_affine"] < 2 * len(ghosts)):
            raise AssertionError(f"variants path did not go through the kernels: "
                                 f"{var_l}, ghost stream {gh_l}, for {chunks} "
                                 f"chunks and {len(ghosts)} ghost chunks")
        emit({"phase": "variants_path", "events": events, "chunks": chunks,
              "num_cases": NUM_CASES, "seconds": t_var,
              "events_per_s": events / t_var, "stages_s": v_stages,
              "max_memory_allocated": v_peak, "launches": var_l,
              "ghost_stream": {"ghost_chunks": len(ghosts),
                               "ghost_rows": [g.nrows for g in ghosts],
                               "launches": gh_l},
              "bitwise_equal_to": ["cpu_plain_stream", "staged_stream",
                                   "whole_log", "ghost_stream",
                                   "numpy_sketch_oracle"],
              "variants": len(o_counts), "nvidia_smi": smi})
        emit({"phase": "variants_path_profile",
              **idle_share(torch, lambda: run_streaming(v_kernel, source), t_var)})

        # ------ performance path: timed DFG + eventually-follows, one pass
        p_kernel = engine.compose({
            "performance_dfg": performance.performance_dfg_kernel(NUM_ACTIVITIES),
            "eventually_follows": performance.eventually_follows_kernel(NUM_ACTIVITIES)})
        run_streaming(p_kernel, s_source)      # warm-up
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p_gpu = run_streaming(p_kernel, s_source)
        torch.cuda.synchronize()
        t_perf = time.perf_counter() - t0
        launches["performance_path"] = read_launches()
        p_peak = torch.cuda.max_memory_allocated()

        p_staged, p_stages = staged_stream(torch, p_kernel, path, stats_cols, edf)
        p_cpu = run_streaming(p_kernel, ChunkedEventFrame.from_edf(
            path, columns=stats_cols, device="cpu"))
        p_whole = engine.run_single(p_kernel, frame_gpu)
        p_oracle = numpy_performance(case_np, act_np, ts_np, NUM_ACTIVITIES)

        def perf(res):
            counts, mean = res["performance_dfg"]
            return {"counts": counts.cpu().numpy(), "mean_wait": mean.cpu().numpy(),
                    "efg": res["eventually_follows"].cpu().numpy()}

        p_got = perf(p_gpu)
        for label, other in (("cpu_plain_stream", perf(p_cpu)),
                             ("staged_stream", perf(p_staged)),
                             ("whole_log", perf(p_whole)),
                             ("numpy_oracle", p_oracle)):
            for name, x in p_got.items():
                check_equal(f"streamed {name} vs {label}", x, other[name])
        rt = performance.remaining_time_targets(frame_gpu).cpu().numpy()
        check_equal("remaining_time_targets vs numpy oracle", rt, p_oracle["remaining"])
        check_equal("remaining_time_targets vs CPU plain", rt,
                    performance.remaining_time_targets(frame_cpu).numpy())
        p_l = launches["performance_path"]
        if (p_l["pair_count"] < chunks or p_l["ordered_histogram"] < chunks
                or p_l["segmented_sum_scan"] < chunks):
            raise AssertionError(f"performance path did not go through the "
                                 f"kernels: {p_l} for {chunks} chunks")
        emit({"phase": "performance_path", "events": events, "chunks": chunks,
              "seconds": t_perf, "events_per_s": events / t_perf,
              "stages_s": p_stages, "max_memory_allocated": p_peak,
              "launches": p_l,
              "bitwise_equal_to": ["cpu_plain_stream", "staged_stream",
                                   "whole_log", "numpy_oracle"],
              "checks": {"dfg_edges": int(p_got["counts"].sum()),
                         "events_minus_cases": events - cases,
                         "efg_pairs": int(p_got["efg"].sum()),
                         "mean_wait_finite": bool(np.isfinite(
                             p_got["mean_wait"]).all()),
                         "remaining_time_targets": "bitwise numpy oracle"},
              "nvidia_smi": smi})
        emit({"phase": "performance_path_profile",
              **idle_share(torch, lambda: run_streaming(p_kernel, s_source), t_perf)})

        # -------- graph path: the timed process graph and its queries
        g_kernel = tgraph.graph_kernel(NUM_ACTIVITIES, timed=True)
        g_warm = run_streaming(g_kernel, s_source)          # warm-up
        for q in graph_queries(tgraph, g_warm).values():
            q()
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g_gpu = run_streaming(g_kernel, s_source)
        torch.cuda.synchronize()
        t_graph = time.perf_counter() - t0
        stream_l = read_launches()
        q_gpu, q_l = {}, {}
        queries = graph_queries(tgraph, g_gpu)

        def semiring_launches():
            by = read_launches()
            return {"closure": by["semiring_closure"], "products": by["semiring_matmul"]}

        for name, q in queries.items():
            before = semiring_launches()
            q_gpu[name] = q()
            torch.cuda.synchronize()
            q_l[name] = {key: v - before[key] for key, v in semiring_launches().items()}
        launches["graph_path"] = read_launches()
        g_peak = torch.cuda.max_memory_allocated()
        # finalize time of each query on the host clock, synchronized: the
        # median of 9 calls (these launches are not the path's)
        q_ms = {name: 1e3 * float(np.median([host_s(torch, q) for _ in range(9)]))
                for name, q in queries.items()}

        _, g_stages = staged_stream(torch, g_kernel, path, stats_cols, edf)
        g_cpu = run_streaming(g_kernel, ChunkedEventFrame.from_edf(
            path, columns=stats_cols, device="cpu"))
        q_cpu = {name: q() for name, q in graph_queries(tgraph, g_cpu).items()}
        same_result(torch, "graph vs cpu_plain_stream", g_gpu, g_cpu)
        for name in q_gpu:
            same_result(torch, f"{name} vs cpu_plain_stream", q_gpu[name],
                        q_cpu[name], flow_atol=1e-6)
        freq_np = numpy_graph(oracle, NUM_ACTIVITIES)
        check_equal("graph freq vs numpy oracle", g_gpu.freq.cpu().numpy(), freq_np)
        go_np = numpy_graph_queries(freq_np, 3)
        for label, got_np, want_np in (
                ("reachability", q_gpu["reachability"].mask, go_np["reach"]),
                ("reachability k=3", q_gpu["reachability_k3"].mask, go_np["reach_k"]),
                ("shortest (hops)", q_gpu["bottleneck_paths"].shortest,
                 go_np["shortest"]),
                ("widest", q_gpu["bottleneck_paths"].widest, go_np["widest"]),
                ("widest (perf graph)", q_gpu["bottleneck_paths_performance"].widest,
                 go_np["widest"]),
                ("in_degree", q_gpu["node_centrality"].in_degree, go_np["in_degree"]),
                ("out_degree", q_gpu["node_centrality"].out_degree,
                 go_np["out_degree"])):
            check_equal(f"{label} vs numpy oracle", got_np.cpu().numpy(), want_np)
        bp = q_gpu["bottleneck_paths"]
        src, snk = g_gpu.source, g_gpu.sink
        caps = [int(freq_np[x, y]) for x, y in zip(bp.path[:-1], bp.path[1:])]
        if not (bp.path and bp.path[0] == src and bp.path[-1] == snk
                and min(caps) == bp.bottleneck == float(go_np["widest"][src, snk])):
            raise AssertionError(f"bottleneck path {bp.path} / {bp.bottleneck} "
                                 f"disagrees with the numpy widest path")
        flow = q_gpu["node_centrality"].flow.cpu().numpy()
        if not (np.isfinite(flow).all() and abs(float(flow.sum()) - 1.0) < 1e-5):
            raise AssertionError(f"centrality flow does not sum to 1: {flow.sum()}")
        sp = q_gpu["bottleneck_paths_performance"].shortest.cpu().numpy()
        if not (np.isfinite(sp[src, snk]) and sp[src, snk] >= 0):
            raise AssertionError(f"performance distance source->sink {sp[src, snk]}")
        g_l = launches["graph_path"]
        # each closure of the 28-node graph is one closure launch and no
        # product; centrality's 16 matvecs are products
        need = {"reachability": {"closure": 1, "products": 0},
                "reachability_k3": {"closure": 1, "products": 0},
                "bottleneck_paths": {"closure": 2, "products": 0},
                "bottleneck_paths_performance": {"closure": 2, "products": 0},
                "node_centrality": {"closure": 0, "products": 16}}
        if (q_l != need
                or stream_l["pair_count"] < chunks or stream_l["histogram"] < 2 * chunks
                or stream_l["ordered_histogram"] < chunks):
            raise AssertionError(f"graph path did not go through the kernels: "
                                 f"stream {stream_l}, queries {q_l}, for {chunks} chunks")
        emit({"phase": "graph_path", "events": events, "chunks": chunks,
              "nodes": g_gpu.num_nodes, "seconds": t_graph,
              "events_per_s": events / t_graph, "stages_s": g_stages,
              "query_ms": q_ms, "query_ms_total": sum(q_ms.values()),
              "query_semiring_launches": q_l, "max_memory_allocated": g_peak,
              "launches": g_l, "stream_launches": stream_l,
              "bottleneck": {"path": list(bp.path), "capacity": bp.bottleneck},
              "bitwise_equal_to": ["cpu_plain_stream (flow within 1e-6)",
                                   "numpy_bfs_and_floyd_warshall"],
              "nvidia_smi": smi})
        emit({"phase": "graph_path_profile",
              **idle_share(torch, lambda: run_streaming(g_kernel, s_source), t_graph)})

        # the registered graph verbs, streamed through kernel_spec(...).make
        dims = engine.Dims(NUM_ACTIVITIES, NUM_CASES)
        verbs = {"reachability": ("reachability", {}, source),
                 "reachability_k3": ("reachability", {"k": 3}, source),
                 "bottleneck_paths": ("bottleneck_paths", {}, source),
                 "bottleneck_paths_performance": (
                     "bottleneck_paths", {"weights": "performance"}, s_source),
                 "node_centrality": ("node_centrality", {}, source)}
        reset_launches()
        v_s, v_l = {}, {}
        for name, (verb, kw, src_) in verbs.items():
            before = semiring_launches()
            t0 = time.perf_counter()
            res = run_streaming(engine.kernel_spec(verb).make(dims, **kw), src_)
            torch.cuda.synchronize()
            v_s[name] = time.perf_counter() - t0
            v_l[name] = {key: v - before[key] for key, v in semiring_launches().items()}
            same_result(torch, f"verb {name} vs graph path", res, q_gpu[name])
        launches["graph_verbs"] = read_launches()
        gv_l = launches["graph_verbs"]
        if v_l != need or gv_l["pair_count"] < len(verbs) * chunks:
            raise AssertionError(f"graph verbs did not go through the kernels: "
                                 f"{gv_l}, per verb {v_l}")
        emit({"phase": "graph_verbs", "seconds": v_s,
              "events_per_s": {k: events / v for k, v in v_s.items()},
              "launches": gv_l, "semiring_launches": v_l,
              "bitwise_equal_to": ["graph_path"],
              "nvidia_smi": smi})

        # ------ discovery path: heuristics + alpha miners over the stream
        h_kernel = discovery.heuristics_kernel(NUM_ACTIVITIES)
        run_streaming(h_kernel, source)        # warm-up
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net_gpu = run_streaming(h_kernel, source)
        torch.cuda.synchronize()
        t_disc = time.perf_counter() - t0
        launches["discovery_path"] = read_launches()
        d_peak = torch.cuda.max_memory_allocated()

        dk = discovery.discovery_kernel(NUM_ACTIVITIES)
        st_gpu, d_stages = staged_stream(torch, dk, path, cols_proj, edf)
        net2 = discovery.discover_heuristics(st_gpu)
        alpha_gpu = discovery.discover_alpha(st_gpu.dfg)
        heur_ms = 1e3 * float(np.median([host_s(
            torch, lambda: discovery.discover_heuristics(st_gpu)) for _ in range(9)]))
        alpha_ms = 1e3 * float(np.median([host_s(torch, lambda: discovery.discover_alpha(
            st_gpu.dfg)) for _ in range(3)]))
        st_cpu = run_streaming(dk, ChunkedEventFrame.from_edf(
            path, columns=cols_proj, device="cpu"))
        same_result(torch, "discovery state vs cpu_plain_stream", st_gpu, st_cpu)
        same_result(torch, "heuristics vs cpu_plain_stream", net_gpu,
                    discovery.discover_heuristics(st_cpu))
        same_result(torch, "heuristics stream vs state finalize", net_gpu, net2)
        alpha_cpu = discovery.discover_alpha(st_cpu.dfg)
        same_result(torch, "alpha vs cpu_plain_stream", alpha_gpu, alpha_cpu)
        check_equal("l2_counts vs numpy triple oracle",
                    st_gpu.l2_counts.cpu().numpy(),
                    numpy_l2_counts(case_np, act_np, NUM_ACTIVITIES))
        for name, x, y in zip(("counts", "starts", "ends"), host(st_gpu.dfg), oracle):
            check_equal(f"discovery DFG {name} vs numpy oracle", x, y)
        fit_alpha = conformance.alpha_fitness(st_gpu.dfg, alpha_gpu)
        fit_fp = conformance.footprint_conformance(st_gpu.dfg, alpha_gpu)
        fit_heur = conformance.heuristics_fitness(st_gpu.dfg, net_gpu)
        c32 = oracle[0].astype(np.float32)
        heur_np = np.float32(c32[net_gpu.graph.cpu().numpy()].sum()) / np.float32(c32.sum())
        if float(fit_alpha) != 1.0 or float(fit_fp) != 1.0:
            raise AssertionError(f"the log does not fit its own alpha model: "
                                 f"{float(fit_alpha)}, {float(fit_fp)}")
        check_equal("heuristics fitness vs numpy oracle",
                    fit_heur.cpu().numpy(), np.asarray(heur_np, np.float32))
        d_l = launches["discovery_path"]
        if d_l["pair_count"] < 2 * chunks or d_l["histogram"] < 2 * chunks:
            raise AssertionError(f"discovery path did not go through the kernels: "
                                 f"{d_l} for {chunks} chunks")
        emit({"phase": "discovery_path", "events": events, "chunks": chunks,
              "seconds": t_disc, "events_per_s": events / t_disc,
              "stages_s": d_stages, "max_memory_allocated": d_peak,
              "finalize_ms": {"heuristics": heur_ms, "alpha": alpha_ms},
              "launches": d_l, "alpha_places": len(alpha_gpu.places),
              "heuristics_edges": len(net_gpu.edges()),
              "l2_triples": int(st_gpu.l2_counts.sum()),
              "fitness": {"alpha": float(fit_alpha), "footprint": float(fit_fp),
                          "heuristics": float(fit_heur)},
              "bitwise_equal_to": ["cpu_plain_stream", "numpy_triple_oracle",
                                   "numpy_dfg_oracle", "numpy_fitness_oracle"],
              "nvidia_smi": smi})
        emit({"phase": "discovery_path_profile",
              **idle_share(torch, lambda: run_streaming(h_kernel, source), t_disc)})

        # ------ query path: pruned plans, group states, the prefetch thread
        (q_phase, launches["query_path"], launches["query_group_states"],
         cpu_plain) = query_path(torch, smi, path, case_np, act_np, ts_np, sk,
                                 frame_gpu, chunks)
        emit(q_phase)

        # --------- dataset path: the facade's verbs, dispatch, windows, append
        cpu_plain.update({"stats": stats_cpu,
                          "sojourn_times": stats_cpu["sojourn_times"],
                          "performance_dfg": p_cpu["performance_dfg"]})
        ds_phase, launches["dataset"], new_batch = dataset_path(
            torch, smi, path, {ACTIVITY: tables[ACTIVITY]}, cpu_plain, case_np,
            act_np, frame_gpu, chunks)
        emit(ds_phase)

        # ------- distributed path: the sharded engine over 1/2/4/8 shards
        dist_phase, launches["distributed"] = distributed_path(
            torch, smi, path, cpu_plain, case_np, act_np, ts_np, chunks)
        emit(dist_phase)
        del cpu_plain

        # ----------- service path: ingest L1, answer HTTP requests on the card
        svc_phase, launches["service"] = service_path(
            torch, smi, {ACTIVITY: tables[ACTIVITY]}, case_np, act_np, ts_np,
            new_batch)
        emit(svc_phase)
        del new_batch

        # the dry run's sweep runs beside the model phases (host work only,
        # no card), after the mining phases whose host times it would move
        sweep = start_launch_sweep(sweep_dir)

        # ------------------- serve path: eventlm-100m, prefill + decode
        serve, launches["serve_path"] = serve_path(torch, smi)
        emit(serve)

        # ------------- moe path: qwen3-moe and mixtral at full width
        moe, launches["moe_path"] = moe_path(torch, smi)
        emit(moe)

        # --- families path: zamba2, xlstm, whisper, internvl2 at full width
        t0 = time.perf_counter()
        fams, launches["families_path"] = families_path(torch, smi)
        emit({**fams, "seconds": time.perf_counter() - t0})

        # ------------- train path: eventlm-100m, forward + backward kernels
        train, launches["train_path"] = train_path(torch, smi)
        emit(train)

        # ---- family train path: moe, hybrid, ssm, audio, vlm at full width
        t0 = time.perf_counter()
        ftrain, launches["family_train_path"] = family_train_path(torch, smi)
        emit({**ftrain, "seconds": time.perf_counter() - t0})

        # ------ launch path: the dry run's sweep and its checks on the card
        lp, launches["launch_path"] = launch_path(torch, smi, sweep)
        emit(lp)

        # ------------------------------------------- kernel times on card
        times = time_kernels(torch, so, engine, frame_gpu, ghosts)
        times.update(time_semiring_kernels(torch, g_gpu))
        times.update(time_flash_attention(torch))
        emit({"phase": "kernel_times", "nvidia_smi": smi, "rows": times})
    finally:
        Path(path).unlink(missing_ok=True)

    def entry(name, source_file, replaces, row):
        return {"name": name, "route": "cuda", "source": source_file,
                "replaces": replaces,
                "launches": sum(by[name] for by in launches.values()),
                "launches_by_path": {p: by[name] for p, by in launches.items()},
                "max_abs_err": checks[name]["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                **{key: row[key] for key in ("chain_bound_ms", "graph_ms", "library_graph_ms")
                   if key in row}}

    csrc = "src/repro_torch/kernels/csrc/"
    main_keys = ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "nodes",
                 "nodes_by_type", "library_ms", "library_graph_ms")
    emit({"kernels": [
        {**entry("pair_count", csrc + "pair_count.cu", PAIR_COUNT_TPU,
                 times["pair_count/chunk"]),
         "main_call": {key: times["pair_count/main_call"][key] for key in main_keys},
         "dfg_update": times["dfg_update/chunk"]},
        {**entry("histogram", csrc + "histogram.cu", HISTOGRAM_TPU,
                 times["histogram/chunk"]),
         "main_call": {key: times["histogram/main_call"][key] for key in main_keys}},
        {**entry("segment_reduce", csrc + "segment_reduce.cu", SEGMENT_REDUCE_TPU,
                 times["segment_reduce/sum_int32/chunk"]),
         "routes": {label: {key: times[f"segment_reduce/{label}/chunk"][key]
                            for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "library_graph_ms")}
                    for label in SEGMENT_REDUCE_ROUTES},
         "single_run_ms": {label: times[f"segment_reduce/{label}/chunk"]["ms"]
                           for label in ("single_run", "single_run_sum")}},
        entry("ordered_histogram", csrc + "ordered_histogram.cu",
              ORDERED_FOLD_TPU, times["ordered_histogram/sojourn_26/chunk"]),
        entry("segmented_polyhash", csrc + "segmented_scan.cu", POLYHASH_TPU,
              times["segmented_polyhash/chunk"]),
        {**entry("segmented_affine", csrc + "segmented_scan.cu", AFFINE_TPU,
                 times["segmented_affine/chunk"]),
         "ghost_chunk": {key: times["segmented_affine/ghost_chunk"][key]
                         for key in ("E", "longest_run", "ms", "graph_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}},
        {**entry("segmented_sum_scan", csrc + "segmented_scan.cu", SUM_SCAN_TPU,
                 times["segmented_sum_scan/chunk"]),
         "single_run_ms": times["segmented_sum_scan/chunk"]["single_run_ms"]},
        {**entry("semiring_matmul", csrc + "semiring.cu", SEMIRING_TPU,
                 times["semiring_matmul/plus_times/28x28x28"]),
         "rows": {key.split("/", 1)[1]: {f: times[key][f] for f in (
             "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_graph_ms") if f in times[key]}
             for key in times if key.startswith("semiring_matmul/")}},
        {**entry("semiring_closure", csrc + "semiring.cu", CLOSURE_TPU,
                 times["semiring_closure/min_plus/N28"]),
         "rows": {key.split("/", 1)[1]: times[key]
                  for key in times if key.startswith("semiring_closure/")}},
        {**entry("flash_attention", csrc + "flash_attention.cu", FLASH_TPU,
                 times[f"flash_attention/prefill_{FLASH_TIMED[2]}"]),
         "float32_route": {key: times[f"flash_attention/prefill_{FLASH_TIMED[2]}_float32"][key]
                           for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                       "bound_by", "simt_bound_ms", "library_ms",
                                       "library_graph_ms")},
         "head_dims": head_dim_rows(times, "flash_attention/"),
         "whisper": {label: {f: times[key][f] for f in (
             "B", "H", "KVH", "Sq", "S", "D", "causal", "ms", "graph_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_graph_ms")}
             for label, *_ in FLASH_TIMED_WHISPER
             for key in [f"flash_attention/prefill_1500_{label}"]}},
        {**entry("flash_attention_bwd", csrc + "flash_attention_bwd.cu", FLASH_BWD_TPU,
                 times[f"flash_attention_bwd/{FLASH_TIMED[2]}"]),
         "simt_bound_ms": times[f"flash_attention_bwd/{FLASH_TIMED[2]}"]["simt_bound_ms"],
         "nodes_ms": times[f"flash_attention_bwd/{FLASH_TIMED[2]}"]["nodes_ms"],
         "float32_route": {key: times[f"flash_attention_bwd/{FLASH_TIMED[2]}_float32"][key]
                           for key in ("ms", "graph_ms", "nodes_ms", "plain_ms", "bound_ms",
                                       "bound_by", "simt_bound_ms", "library_ms",
                                       "library_graph_ms")},
         "head_dims": head_dim_rows(times, "flash_attention_bwd/"),
         "family_train": {label + route: {f: times[key][f] for f in (
             "B", "H", "KVH", "Sq", "S", "D", "causal", "ms", "graph_ms", "nodes_ms",
             "plain_ms", "bound_ms", "bound_by", "simt_bound_ms", "library_ms",
             "library_graph_ms")}
             for label, _, _, _, _, sk, _, _ in FLASH_TIMED_TRAIN
             for route in ("", "_float32")
             for key in [f"flash_attention_bwd/{sk}{route}_{label}"]}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
