#!/usr/bin/env python3
"""Drive harmony_tpu_torch on one NVIDIA GPU and hold its CUDA kernels to their
plain PyTorch versions.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

1. Build: compile every ``harmony_tpu_torch/csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit. Print the
   registers and shared memory of the tensor-core flash kernels, and fail if
   ``ptxas`` reports spills for one of them at D = 64 or D = 128.
2. Kernels: run gather_rows (K1), segment_sum_rows (K2) and
   weighted_histogram (K3) on the card at the shapes of the Wide&Deep job
   below and at edge cases. K1 must be byte-identical to its plain version
   (16-, 8-, 4- and 2-byte units, aligned and not; f32, bf16, f16 and int32
   tables); K2 and K3 must give the
   same bits as their plain version on the CPU (``index_add_``, index order)
   and as themselves run twice, on every case (the slice, out-of-range ids,
   64 heavy rows, one row, Zipf-skewed ids, W = 1, W = 300, 4.5M rows,
   300,000 ids, bf16 and f16 weights, and for K3 the trio's fold: NMF's init,
   [4096, 256] f32 into 4096 rows). Time each kernel, its plain version
   and one PyTorch library call (a yardstick that the port never calls): call
   ms by CUDA events (the host's enqueue included), device ms by
   torch.profiler (every kernel a call launches), and the wrapper's host us
   per call; and the fold on the skewed cases.
2b. Flash attention: K4 (forward), K5a (dK/dV) and K5b (dQ) against their
   plain versions at the LM's shape ([32, 8, 1024, 64] bf16, causal, blocks
   128) and at edge cases (f32 operands, not causal, D = 16 and 128, one
   block, a nonzero LSE cotangent, block_k 64 with D = 32, Sq != Sk, block_k
   32 with D = 16, block_k 16, the bf16 tiles the tensor cores do not
   take: 100 keys and 256, and bench-vit's attention, [128, 12, 197, 64]
   bf16 and [8, 12, 197, 64] f32, not causal, blocks 197: a partial last q
   tile and key chunk); in each case all three must take the route its
   table row names (``mma``, the tensor cores, for bf16 at block_k 16, 32, 64
   or 128; ``simt`` for f32 and the other bf16 tiles), and each run twice must
   agree bit for bit. Timed (call ms by CUDA events, device ms by
   torch.profiler) beside their plain versions, their first (scalar) versions
   and ``scaled_dot_product_attention``'s forward and backward, at the LM's
   shape and at bench-vit's (on ``simt``).
2c. The hash table (``table/hashtable.py``): its ops on the card against the
   port's CPU route on the same inputs, byte for byte (slot keys, values,
   returned values, overflow counts): same-slot races, overflow, an exhausted
   probe budget, each update mode on float deltas, put of -0.0, and
   bench-fm-hash's table at full width.
2d. The push-route autotune at bench-widedeep's push: the device ms of the
   ``mxu`` (K3) and ``sparse`` (K2) arms and the route chosen (``mxu``
   unless ``sparse`` is faster by more than the autotune's margin), first
   while another tenant keeps the card busy on its own stream, then on an
   idle card; the second choice is cached for the jobs below that leave
   ``HARMONY_PUSH_VIA`` unset (3g, 5).
3. The slice: ``python -m harmony_tpu_torch.cli run widedeep`` at the
   ``bench-widedeep`` size of ``benchmarks/apps.py`` (vocab 100,000, 16 slots,
   emb 16, hidden 128, 32,768 examples in 8 mini-batches) for 2 epochs on the
   card on the ``mxu`` route (``HARMONY_PUSH_VIA=mxu``), with the launch
   counts set to 0 just before and read just after (K1 and K3 once a step,
   plus the comm probe's: one warm-up and three timed calls each of PULL,
   K1, and PULL+PUSH, K1 and the fold); then the same job on the CPU (plain
   versions), step for step.
3b. The LM at full width: ``cli run lm`` at the size of ``benchmarks/lm.py``
   (vocab 8192, d_model 512, 8 heads, 8 layers, d_ff 2048, max_seq 1024, bf16,
   batch 32 x 1024 tokens) for 2 epochs of 4 steps, launch counts (K4, K5a
   and K5b on the ``mma`` route) read around it; then the same run with
   ``--set attn=blockwise``, step for step.
3c. The ``lm`` preset as shipped (f32, head dim 16, 64 tokens) on the card, on
   the ``simt`` route, and on the CPU, step for step.
3n. ViT: the ``vit`` preset (f32) on the card against the CPU, step for
   step; ``bench-vit``, ViT-B/16 (12 layers, d_model 768, 12 heads, MLP
   3,072, 224 x 224 x 3 images in 16 x 16 patches, 1,000 classes, bf16) on
   1,024 synthetic images in 8 mini-batches for 2 epochs through ``cli run
   vit``, launch counts read around it (K4, K5a and K5b 12 times a step, all
   on ``simt``), the loss finite and falling, then with ``attn=blockwise``
   step for step; samples/s.
3o. The MoE LM: the ``lm`` preset with 4 experts every 2nd block (f32) on
   the card against the CPU; ``bench-lm-moe``, phase 3b's run with 8
   experts in blocks 1, 3, 5 and 7 (capacity factor 1.5, aux weight 0.01),
   launch counts read around it (K4, K5a and K5b on ``mma``), a second run
   bit for bit with each block's dropped share and aux loss recorded, and
   the run with blockwise attention; tokens/s.
3p. Generation: bench-lm trained as phase 3b trains it (the same losses,
   bit for bit), then ``make_generate_fn`` from its weights, batch 32, a
   512-token prompt, 512 new tokens: greedy twice and at temperature 1.0
   twice with one key give the same tokens; prefill ms, decode ms a token,
   tokens/s. The model's f32 copy (blockwise attention): every decode step's
   logits within GEN_F32_REL of the full forward's at that position, and the
   greedy tokens the full forward's argmax except at near-ties (counted).
3d. The BASELINE config-4 trio through ``harmony_tpu_torch.bench``'s
   ``run_concurrent``: MLR, NMF and LDA submitted together to one JobServer on
   the card at ``bench.py``'s full size, a 1-epoch warm-up, then 12 measured
   epochs with the launch counts read around them (K3 once, NMF's init; no
   other kernel); the three must overlap (every job starts before any
   finishes). Then the CPU baseline (scale 0.125, best of two), the trio at
   scale 0.125 for 2 epochs on the card and on the CPU, batch for batch, and
   LDA's assignments on both (its first batch, then after 2 epochs), with an
   int32 ``multi_get`` of LDA's local table (K1) byte-identical to
   ``pull_array``. The measured pass must call no ``data_fn`` and miss
   neither data cache (host arrays, device stacks), and each job must run
   the reference's windows (8 then 4 epochs after the epoch-0 comm probe);
   then each job alone with CUDA's sync debug mode set to raise while each
   window is enqueued: no blocking host copy and no other sync inside a
   window, one drain after it.
3e. The unfused step (``HARMONY_FUSED_STEP=0``) on the Wide&Deep job of
   phase 3, on the mxu and the sparse push routes: losses
   bit-identical to the fused runs of phases 3 and 4, K1 and the route's
   fold once a step each, and the mean PULL, COMP and PUSH seconds.
3f. The async step on ``bench.py``'s MLR job at full size, through the
   JobServer: staleness bound 0 bit-identical to the fused step, bound 1
   with finite losses and a lag of at most 1; samples/s of each.
3g. The prefetch pipeline on the Wide&Deep job with a shuffling provider:
   losses bit-identical with ``input_prefetch`` on and off; under
   torch.profiler the staged batches are ``Memcpy HtoD (Pinned -> Device)``
   copies on a stream that runs none of the steps' kernels; the ring's stall
   and idle seconds.
3h. ``bench-fm-hash`` (``benchmarks/apps.py:68-81``) at full width: an FM
   over a DeviceHashTable of 524,288 slots x 17 f32, ids from the whole
   int32 domain, through the JobServer on the card for 2 epochs, launch
   counts read around it (K1 and K2 once a step, and the comm probe's); the
   loss falls and the overflow count is printed. Then the JobServer's set-up
   of the same job on the card, with CUDA's sync debug mode raising inside
   each fused window (no host sync: the refused-key counts stay on the
   device until the drain), bit-identical to the first card run, and on the
   CPU: slot keys byte-identical, losses within LOSS_ATOL.
3i. Sparse LDA at the trio's width (V 8,192, K 64, 2,048 documents of 128
   tokens): the same, for 2 epochs; the counts, slot keys and assignments
   identical on the card and the CPU.
3j. The ModelAccessor path: FusedSparseStep at bench-widedeep's width
   (PULL K1, PUSH K3) bit-identical to the accessor's unfused loop, and
   accessor_async_step at staleness bound 0 bit-identical to the
   synchronous cycle.
2e. The kernels at this slice's shapes: K3 at bench-gbt's deepest level
   (1,900,544 ids of width 3 into 229,408 rows), K2 at bench-pagerank's add
   fold (~67.9M ids of width 1 into 4,847,571 rows) and K1 at its edge
   gather (8-byte rows), and at shortest path's and connected components'
   (4-byte rows, ~67.9M and ~135.7M ids): the CPU's bits, the same bits run
   twice; timed
   beside the plain versions, ``index_select`` and atomic and deterministic
   ``index_add_``, with the fold's scratch bytes.
3k. GBT: the ``gbt`` preset on the card and on the CPU (trees equal in
   structure, leaf values within GBT_LEAF_ATOL), and in ``hist_mode``
   ``scatter`` on the card (K2 once a level, the same trees bit for bit);
   bench-gbt (XGBoost's hist defaults at HIGGS's shape, 524,288 rows, 16
   rounds) through the JobServer with the launch counts read around it (K3
   once a level, nothing else), the loss falling, a second run bit-identical
   with each step held to the CPU on the card's own inputs (each K3 call
   the plain version's bits, gradients within GBT_GRAD_ATOL, each tree
   equal in structure, leaf values within GBT_LEAF_ATOL), and the same job
   run through on the CPU, reported; samples/s and rounds/s.
3l. The Pregel engine: the ``pagerank``, ``shortest-path`` and
   ``connected-components`` presets on the card and on the CPU (distances
   and labels exact, ranks within PR_RTOL); each at bench-pagerank's scale
   (random_graph(4,847,571, 14), SNAP LiveJournal's size) through the
   JobServer, launch counts read around it (K1 once a superstep, K2 once a
   superstep for PageRank), PageRank's rank mass, a second run of each
   bit-identical, each against the same job on the CPU (the same supersteps,
   distances and labels exact, ranks within PR_RTOL); edges/s a superstep.
3m. The ``lasso``, ``addvector`` and ``addinteger`` presets on the card and
   on the CPU: Lasso's losses within LOSS_ATOL, the AddVector and
   AddInteger tables at ``expected_value`` exactly.
4. The sparse push route (``HARMONY_PUSH_VIA=sparse``): the Wide&Deep job
   of phase 3, which folds its pushes with K2.
5. Where a step's time goes: a steady epoch of the Wide&Deep job on the host
   clock, and one under ``torch.profiler`` for the device's busy time by kernel
   (the port's own kernels summed over their launches: the fold is two).
5b. The same for the full-width LM.
5c. Phase 3d's measured pass again (``run_concurrent``, full size, 12 epochs)
   under torch.profiler: the device's busy time and idle share over the pass,
   within each job's training span and where MLR trains alone (if it
   does); the host-to-device copies' share of it, and their count and bytes
   by kind from the profile's Chrome trace; and the top kernels.
5d. The same for a bench-fm-hash step and a sparse LDA step, with the
   device's operations (kernels, copies, fills) a step.
5e. The same for a bench-gbt step, a bench-pagerank superstep and a step of
   the lasso preset.
5f. The same for a bench-vit step, a bench-lm-moe step and one decode step
   of bench-generate.
6. A ``kernels`` JSON line: ``launches`` sums each kernel's launches over
   the main paths, each read with the counts set to 0 just before it
   (``launches_by_path``: bench-widedeep, bench-lm, bench-vit, bench-lm-moe,
   bench-generate, bench-trio,
   bench-fm-hash, sparse-lda-hash, fused-sparse-step, bench-gbt,
   bench-pagerank, bench-shortest-path, bench-connected-components); K1-K3
   also carry ``device_ms``, ``library_device_ms``,
   ``library_deterministic_device_ms``, ``host_us`` and their timing at
   phase 2e's shapes, K4-K5b their timing at bench-vit's shape; the card's
   name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet), at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# The H100's L2 (50 MB): a profiled time below the bytes bound is a lost
# record where a call moves more than this (it cannot stay warm in L2).
L2_BYTES = 50e6
BF16_FLOPS = 989e12

# bench-widedeep (benchmarks/apps.py) through the CLI's widedeep preset.
SLICE_ARGS = [
    "run", "widedeep", "--batches", "8",
    "--set", "vocab_size=100000", "--set", "num_slots=16",
    "--set", "emb_dim=16", "--set", "hidden=128", "--set", "step_size=0.1",
    "--data", "n=32768", "--data", "vocab_size=100000", "--data", "num_slots=16",
]
EPOCHS = 2
BATCHES = 8
N_EXAMPLES = 32768

# torch.profiler on the card (an H100 80GB HBM3) drops a prefix of a
# profile's device records: once a process has run for a minute or so, the
# first few kernel records of a profile go missing, by count whatever the
# kernels' lengths, and now and then a whole profile comes back empty. So
# every profile starts with PROFILE_MARKERS tiny marker kernels, whose
# records that loss may take, and ends with one more. A profile is kept only
# if its first record and its last are markers: then nothing of the profiled
# work was dropped at either end. A profile that fails this is taken again,
# up to PROFILE_ATTEMPTS times in all, each retake printed, and then the run
# fails. PROFILE_LOG counts, over the run, the markers each kept profile
# lost, and the retakes.
PROFILE_MARKERS = 64
PROFILE_ATTEMPTS = 4
MARKER_KERNEL = "spin_kernel"   # torch.cuda._sleep's kernel
PROFILE_LOG = {"markers_lost": {}, "retakes": 0}

# Per-step losses of two f32 runs of a job that differ only in where their sums
# are taken (cuBLAS against the CPU's matrix products, the card's reductions
# against the CPU's, the flash kernels against the plain blockwise route)
# agree to this, absolutely: f32 keeps ~7 digits, the losses are ~0.69
# (Wide&Deep) and ~4.8 (the lm preset), and 16 or 12 steps of SGD do not
# amplify a last-digit change this far.
LOSS_ATOL = 1e-4
# Unit roundoff of f32: a sum of n terms taken in any order lies within
# (n - 1) * U * sum(|x|) of the exact sum, so two orders lie within twice that.
U_F32 = 2.0 ** -24

# The LM of benchmarks/lm.py:63-66 at batch 32 (:121) through the CLI's lm preset.
LM_ARGS = [
    "run", "lm", "--epochs", "2", "--batches", "4",
    "--set", "vocab_size=8192", "--set", "d_model=512", "--set", "n_heads=8",
    "--set", "n_layers=8", "--set", "d_ff=2048", "--set", "max_seq=1024",
    "--set", "dtype=bfloat16", "--set", "step_size=0.1",
    "--data", "num_seqs=128", "--data", "seq_len=1025", "--data", "vocab_size=8192",
]
LM_LAYERS = 8
LM_STEPS = 8
LM_TOKENS_PER_STEP = 32 * 1024
# bench-vit: ViT-B/16 (Dosovitskiy et al. 2021, Table 1: 12 layers, d_model
# 768, 12 heads, MLP 3,072, patch 16, 224 x 224 x 3, 1,000 classes) in bf16
# through the CLI's vit preset; synthetic class templates at ImageNet's shape
# (ImageNet is not in the repo), 1,024 images in 8 mini-batches of 128, cut to
# 2 epochs. 197 tokens a sequence: K4/K5a/K5b non-causal on the simt route.
VIT_ARGS = [
    "run", "vit", "--epochs", "2", "--batches", "8",
    "--set", "image_size=224", "--set", "patch_size=16", "--set", "num_classes=1000",
    "--set", "channels=3", "--set", "d_model=768", "--set", "n_heads=12",
    "--set", "n_layers=12", "--set", "d_ff=3072", "--set", "dtype=bfloat16",
    "--set", "step_size=0.05", "--data", "n=1024",
]
VIT_LAYERS = 12
VIT_STEPS = 16
VIT_BATCH = 128
# bench-lm-moe: bench-lm with the expert-parallel section's MoE of
# benchmarks/lm.py:272-277 at the repo's four-device layout (moe_experts = 2n =
# 8, moe_every 2), every expert local on one card; capacity factor 1.5 (C =
# 6,144 of 32,768 tokens), aux weight 0.01. Blocks 1, 3, 5 and 7 are MoE.
MOE_ARGS = LM_ARGS + ["--set", "moe_experts=8", "--set", "moe_every=2",
                      "--set", "moe_capacity_factor=1.5", "--set", "moe_aux_weight=0.01"]
MOE_BLOCKS = 4
# bench-generate: bench-lm's model (bf16) as phase 3b trains it, batch 32, a
# 512-token prompt from make_lm_data, 512 new tokens, greedy and at temperature
# 1.0; the cache 2 x [8, 32, 8, 1024, 64] bf16.
GEN_BATCH = 32
GEN_PROMPT = 512
GEN_NEW = 512
# The f32 copy of the model: each decode step's logits against the full
# forward's at that position. Both are f32 sums of the same products in
# another order (the cache's masked softmax against blockwise attention), over
# 8 layers of d 512: 1e-4 of the largest logit (or of 1), ~800 f32 ulps.
GEN_F32_REL = 1e-4
# Flash kernels against their plain versions. bf16 operands: both sides take
# exact products and round p where the TPU does, so their f32 sums differ in
# order only; the outputs are then rounded to bf16, where that difference can
# become one ulp (2**-8 relative), and a p or ds rounded differently moves a
# sum by about as much: allow two ulps at the largest magnitude. f32 operands:
# reordering alone, over at most 1024 terms: 2 * 1024 * 2**-24 = 2**-12 of the
# largest magnitude.
FLASH_BF16_REL = 2.0 ** -7
FLASH_F32_REL = 2.0 ** -12
# Per-step losses of the full-width LM with flash attention against the same
# run with blockwise attention: both round activations to bf16 (8 significant
# bits), but flash rounds p to bf16 before PV where blockwise keeps it f32, so
# attention outputs differ by about one bf16 ulp and the step's later bf16
# roundings carry that on. Allowed: 2**-7 of the loss (two bf16 ulps).
LM_BF16_REL = 2.0 ** -7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, samples: int = 25, inner: int = 10) -> float:
    """Call time: the median over ``samples`` of the mean time of ``inner``
    back-to-back calls, by CUDA events, the host's enqueue included (a kernel
    of a few microseconds ends before the host has enqueued the next call, so
    this is then mostly the wrapper's host cost). The table stays warm in L2,
    as it does between the job's steps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profiled(run, cpu: bool = False):
    """torch.profiler (CUDA activity, and the host's with ``cpu``) over one
    ``run()``, between the marker kernels; returns the profile and its
    device events in start order, the markers taken out. A profile whose
    first or last device record is not a marker is taken again (see
    PROFILE_MARKERS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [MARKER_KERNEL in e.name for e in events]
        if marks.count(True) >= 2 and marks[0] and marks[-1]:
            lost = PROFILE_MARKERS + 1 - marks.count(True)
            PROFILE_LOG["markers_lost"][lost] = PROFILE_LOG["markers_lost"].get(lost, 0) + 1
            return prof, [e for e, m in zip(events, marks) if not m]
        PROFILE_LOG["retakes"] += 1
        ends = [events[i].name[:40] for i in (0, -1)] if events else []
        print(f"chip_smoke: profile {attempt} of {PROFILE_ATTEMPTS} lost device records "
              f"at an end ({len(events)} records, {marks.count(True)} of "
              f"{PROFILE_MARKERS + 1} markers, first and last {ends})",
              file=sys.stderr, flush=True)
    fail(f"the profiler lost device records in {PROFILE_ATTEMPTS} profiles")


def device_kernels(fn, calls: int = 100) -> dict:
    """Device time of one call by kernel name: the durations of the kernels
    that torch.profiler records over ``calls`` back-to-back calls, summed
    per name and divided by ``calls``. Every call launches the same kernels,
    so each name's record count must be a multiple of ``calls``."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(calls):
            fn()

    _, events = profiled(run)
    by_name, count = {}, {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / calls
        count[e.name] = count.get(e.name, 0) + 1
    check(by_name and all(n % calls == 0 for n in count.values()),
          f"the profiler's record counts {count} over {calls} calls: records lost")
    return by_name


def device_ms(fn, calls: int = 100) -> float:
    """Device time of one call: every kernel it launches, summed (the keyed
    fold launches two)."""
    return sum(device_kernels(fn, calls).values())


def host_us(fn, calls: int = 1000, batch: int = 100) -> float:
    """The host's microseconds per call: a perf_counter over ``calls``
    enqueues, taken ``batch`` at a time between two synchronises, so that the
    card's queue of launches (about a thousand) never fills and holds the host
    back: the fold launches two kernels a call."""
    fn()
    seconds = 0.0
    for _ in range(calls // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        seconds += time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / (calls // batch * batch) * 1e6


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, type and bytes (so -0.0 differs from 0.0 and NaNs compare)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(as_int), b.view(as_int))


def run_cli(argv):
    """``python -m harmony_tpu_torch.cli`` in this process; returns the one
    worker's result from the printed JSON line."""
    from harmony_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli {' '.join(argv)} returned {rc}")
    line = buf.getvalue().strip().splitlines()[-1]
    (worker,) = json.loads(line)["result"]["workers"].values()
    return worker


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        for route in getattr(w, "launches_by_route", {}):
            w.launches_by_route[route] = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- phase 2: the kernels against their plain versions ------------------------


def slice_operands(dev, batch: int = N_EXAMPLES // BATCHES):
    """The table and the flat row ids of one step of the slice: the keys the
    first mini-batch (of ``batch`` examples) pulls and pushes, located as
    TableSpec.pull locates them."""
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic
    from harmony_tpu_torch.table.table import TableSpec

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                              hidden=128, step_size=0.1)
    spec = TableSpec(trainer.model_table_config())
    ids, _ = make_synthetic(N_EXAMPLES, 100000, 16)
    batch_ids = torch.as_tensor(ids[:batch], device=dev)
    keys = trainer.pull_keys((batch_ids, None))
    b, o = spec.partitioner.locate(keys)
    idx = (b * spec.block_size + o).to(torch.int32).contiguous()
    rng = np.random.default_rng(0)
    width = spec.value_shape[0]
    table = torch.as_tensor(
        rng.standard_normal((spec.num_rows, width), dtype=np.float32), device=dev)
    return table, idx


def fold_tolerance(x: torch.Tensor, idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Elementwise bound on the gap between two f32 keyed folds of ``x`` taken
    in different orders: 2 * (n - 1) * U * sum(|x|) per destination row."""
    from harmony_tpu_torch.ops.sparse import segment_sum_rows_plain

    abs_sum = segment_sum_rows_plain(x.abs().double(), idx, num_rows)
    ones = torch.ones((idx.shape[0], 1), dtype=torch.float64, device=x.device)
    count = segment_sum_rows_plain(ones, idx, num_rows)
    return 2.0 * (count - 1).clamp_min(0) * U_F32 * abs_sum


def fold_cases(dev, idx, R, W):
    """The keyed fold's cases, each (name, x, ids, rows, exact against the
    card's atomic index_add_), and the cases only K3 takes (bf16 and f16
    weights). Two cases take the kernels' paths for large inputs: a table of
    more rows than the bucket kernel keeps cursors for in shared memory
    (8,192 tiles of 512), and more chunks of ids than a rows block has
    threads (512 chunks of 512)."""
    N = idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    ints = torch.randint(-8, 9, (N, W), generator=g, device=dev).float()
    floats = torch.randn((N, W), generator=g, device=dev)
    wild = torch.randint(-5000, R + 5000, (N,), generator=g, device=dev, dtype=torch.int32)
    dup = torch.randint(0, 64, (N,), generator=g, device=dev, dtype=torch.int32)
    one_row = torch.zeros((N,), dtype=torch.int32, device=dev)
    zipf = torch.as_tensor(np.random.default_rng(5).zipf(1.1, N) % R, dtype=torch.int32,
                           device=dev)
    wide = torch.randn((min(N, 4096), 300), generator=g, device=dev)
    tall = 4_500_000
    many = 300_000
    both = [
        ("slice, integer-valued", ints, idx, R, True),
        ("slice, float", floats, idx, R, False),
        ("negative and out-of-range ids", ints, wild, R, True),
        ("heavy duplicates (64 rows), integer-valued", ints, dup, R, True),
        ("heavy duplicates (64 rows), float", floats, dup, R, False),
        ("one row (all ids on row 0), float", floats, one_row, R, False),
        ("Zipf(1.1) ids, float", floats, zipf, R, False),
        ("N=0", floats[:0], idx[:0], R, True),
        ("W=1", floats[:, :1].contiguous(), idx, R, False),
        ("W=300", wide, idx[: wide.shape[0]] % 5000, R, False),
        (f"{tall:,} rows (cursors in device memory)", floats[:, :2].contiguous(),
         torch.randint(-10, tall + 10, (N,), generator=g, device=dev, dtype=torch.int32),
         tall, False),
        (f"{many:,} ids (586 chunks)", torch.randn((many, 3), generator=g, device=dev),
         torch.randint(0, R, (many,), generator=g, device=dev, dtype=torch.int32), R, False),
    ]
    # the trio's one fold: NMF's init multi_update, bench.py's full size
    nmf_init = np.random.default_rng(0).uniform(0, 0.1, (4096, 256)).astype(np.float32)
    k3_only = [
        ("bf16 weights, integer-valued", ints.to(torch.bfloat16), idx, R, True),
        ("bf16 weights, float", floats.to(torch.bfloat16), idx, R, False),
        ("f16 weights, float", floats.to(torch.float16), idx, R, False),
        ("NMF's init: [4096, 256] f32, ids 0..4095 into 4096 rows",
         torch.as_tensor(nmf_init, device=dev),
         torch.arange(4096, dtype=torch.int32, device=dev), 4096, True),
    ]
    return both, k3_only


def check_kernels(dev):
    """Each kernel against its plain version on the card at the slice's shape
    and at edge cases: K1 byte-identical; K2 and K3 the same bits as the plain
    version on the CPU (index_add_ in index order), the same bits when run
    twice, and within the f32 reordering bound of the card's atomic
    index_add_ (exact for integer values). Returns the table, the slice's ids
    and per-kernel max |kernel - plain on the card| over the cases."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import (
        gather_rows,
        gather_rows_plain,
        segment_sum_rows,
        segment_sum_rows_plain,
    )

    table, idx = slice_operands(dev)
    R, W = table.shape
    N = idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(1)
    err = {"gather_rows": 0.0, "segment_sum_rows": 0.0, "weighted_histogram": 0.0}

    # K1: byte-identical to table[clamp(idx)]
    wild = torch.randint(-5000, R + 5000, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    bf16_64 = torch.randn((R, 64), generator=g, device=dev).to(torch.bfloat16)
    k1_cases = [
        ("slice f32", table, idx),
        ("negative and out-of-range ids", table, wild),
        ("slice bf16", table.to(torch.bfloat16), idx),
        ("N=0", table, idx[:0]),
        ("W=1", table[:, :1].contiguous(), idx),
        ("W=128 (16-byte units, a warp a row)", torch.randn((4096, 128), generator=g,
                                                            device=dev), wild % 5000 - 400),
        ("bf16 W=64 (16-byte units)", bf16_64, idx),
        ("a view one row in, W=17 (4-byte units)", table[1:], wild),
        ("bf16 W=64, a view one element in (2-byte units)",
         bf16_64.view(-1)[1:1 + (R - 1) * 64].view(R - 1, 64), idx),
        ("int32 W=128 (LDA's local table)",
         torch.randint(-1, 64, (R, 128), generator=g, device=dev, dtype=torch.int32), wild),
        ("f16 W=17 (2-byte units)", table.to(torch.float16), idx),
    ]
    for name, t, i in k1_cases:
        got = gather_rows(t, i)
        torch.cuda.synchronize()
        check(same_bits(got, gather_rows_plain(t, i)),
              f"gather_rows {name}: not byte-identical to the plain version")
    print(f"phase 2: gather_rows byte-identical on {len(k1_cases)} cases", flush=True)

    both, k3_only = fold_cases(dev, idx, R, W)
    for kname, kernel, plain, args, cases in (
        ("segment_sum_rows", segment_sum_rows, segment_sum_rows_plain,
         lambda x, i, rows: (x, i, rows), both),
        ("weighted_histogram", weighted_histogram, weighted_histogram_plain,
         lambda x, i, rows: (i, x, rows), both + k3_only),
    ):
        for name, x, i, rows, exact in cases:
            got = kernel(*args(x, i, rows))
            again = kernel(*args(x, i, rows))
            torch.cuda.synchronize()
            check(got.shape == (rows, x.shape[1]) and got.dtype == torch.float32,
                  f"{kname} {name}: {tuple(got.shape)} {got.dtype}")
            check(same_bits(got, again), f"{kname} {name}: two runs differ")
            check(same_bits(got.cpu(), plain(*args(x.cpu(), i.cpu(), rows))),
                  f"{kname} {name}: not the same bits as the CPU's index_add_")
            want = plain(*args(x, i, rows))
            gap = (got - want).abs()
            err[kname] = max(err[kname], float(gap.max()) if gap.numel() else 0.0)
            if exact:
                check(torch.equal(got, want), f"{kname} {name}: not exact")
            else:
                tol = fold_tolerance(x.float(), i, rows).float()
                check(bool((gap <= tol).all()),
                      f"{kname} {name}: |kernel - plain| {float(gap.max())} "
                      "over the f32 reordering bound")
        print(f"phase 2: {kname} the same bits as the CPU's index_add_ and as itself "
              f"run twice on {len(cases)} cases", flush=True)
    launches = weighted_histogram.launches
    try:  # the library owns the fold's limits: a width past 2**21 is refused unlaunched
        weighted_histogram(idx[:1], torch.zeros((1, 2 ** 21 + 1), device=dev), R)
    except ValueError:
        check(weighted_histogram.launches == launches, "a refused fold counted a launch")
    else:
        fail("weighted_histogram took a width past 2**21")
    return table, idx, err


def time_kernels(dev, table, idx):
    """Per kernel at the slice's shape: call ms (CUDA events, the host's
    enqueue included), device ms (torch.profiler, every kernel of a call), the
    plain version's and one library call's, the wrapper's host us per call,
    and the bound: the larger of bytes moved over HBM bandwidth and f32
    operations over the f32 peak, for this input (each input read once, each
    output written once). The folds have two library calls: ``index_add_`` as
    it runs by default (atomic adds, whose order changes from run to run) and
    under ``torch.use_deterministic_algorithms(True)``, which computes the
    folds' function, a fixed-order sum. Then the fold's call and device ms on
    the skewed cases of phase 2."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import (
        gather_rows,
        gather_rows_plain,
        segment_sum_rows,
        segment_sum_rows_plain,
    )

    R, W = table.shape
    N = idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(2)
    deltas = torch.randn((N, W), generator=g, device=dev)
    idx64 = idx.long()

    def bound(nbytes, nops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def timed(kernel, plain, library):
        return dict(ms=time_ms(kernel), device_ms=device_ms(kernel), plain_ms=time_ms(plain),
                    library_ms=time_ms(library), library_device_ms=device_ms(library),
                    host_us=host_us(kernel))

    rows_read = int(torch.unique(idx).numel())
    out = {}
    b, by = bound(N * 4 + rows_read * W * 4 + N * W * 4, 0)
    out["gather_rows"] = dict(
        timed(lambda: gather_rows(table, idx), lambda: gather_rows_plain(table, idx),
              lambda: torch.index_select(table, 0, idx64)),
        bound_ms=b, bound_by=by)

    def index_add():
        return torch.zeros((R, W), device=dev).index_add_(0, idx64, deltas)

    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        deterministic = dict(library_deterministic_ms=time_ms(index_add),
                             library_deterministic_device_ms=device_ms(index_add))
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    b, by = bound(N * W * 4 + N * 4 + R * W * 4, N * W)
    for name, kernel, plain in (
        ("segment_sum_rows", lambda: segment_sum_rows(deltas, idx, R),
         lambda: segment_sum_rows_plain(deltas, idx, R)),
        ("weighted_histogram", lambda: weighted_histogram(idx, deltas, R),
         lambda: weighted_histogram_plain(idx, deltas, R)),
    ):
        out[name] = dict(timed(kernel, plain, index_add), **deterministic, bound_ms=b,
                         bound_by=by)

    skew = {}
    for name, x, i, _, _ in fold_cases(dev, idx, R, W)[0]:
        if x.shape == deltas.shape and name.endswith("float"):
            skew[name] = dict(ms=time_ms(lambda: weighted_histogram(i, x, R)),
                              device_ms=device_ms(lambda: weighted_histogram(i, x, R)))
    return out, skew


# -- phase 2b: flash attention against its plain versions ----------------------

FLASH_KERNELS = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")


# (name, (B, H, Sq, D), Sk, dtype, causal, block, nonzero LSE cotangent, the route
# K4, K5a and K5b must take: ops/attention.py::flash_route)
FLASH_CASES = [
    ("the LM's shape, bf16, causal", (32, 8, 1024, 64), 1024, torch.bfloat16, True, 128,
     False, "mma"),
    ("f32 operands", (4, 8, 1024, 64), 1024, torch.float32, True, 128, False, "simt"),
    ("causal=False", (4, 8, 1024, 64), 1024, torch.bfloat16, False, 128, False, "mma"),
    ("D=16, the lm preset's shape, f32", (16, 4, 64, 16), 64, torch.float32, True, 64, False,
     "simt"),
    ("D=128", (4, 4, 512, 128), 512, torch.bfloat16, True, 128, False, "mma"),
    ("one block (S=128)", (8, 8, 128, 64), 128, torch.bfloat16, True, 128, False, "mma"),
    ("nonzero LSE cotangent", (4, 8, 256, 64), 256, torch.bfloat16, True, 128, True, "mma"),
    ("block_k=64, D=32", (4, 8, 512, 32), 512, torch.bfloat16, True, 64, False, "mma"),
    ("Sq != Sk, causal=False", (4, 8, 512, 64), 1024, torch.bfloat16, False, 128, False,
     "mma"),
    ("block_k=32, D=16, bf16", (8, 4, 256, 16), 256, torch.bfloat16, True, 32, False, "mma"),
    ("block_k=16, bf16", (4, 8, 256, 64), 256, torch.bfloat16, True, 16, False, "mma"),
    ("an odd tile, bf16 (the LM at S=100)", (4, 8, 100, 64), 100, torch.bfloat16, True, 100,
     False, "simt"),
    ("the default block_k=256, bf16", (2, 8, 1024, 64), 1024, torch.bfloat16, True, 256,
     False, "simt"),
    # bench-vit's attention: ViT-B/16's 197 tokens, the default blocks clamped to 197
    # (a partial last q tile and key chunk, 84.7 KB of shared memory for K4)
    ("bench-vit's shape, bf16, not causal", (128, 12, 197, 64), 197, torch.bfloat16, False,
     197, False, "simt"),
    ("bench-vit's tiles at f32", (8, 12, 197, 64), 197, torch.float32, False, 197, False,
     "simt"),
]
VIT_FLASH_CASE = FLASH_CASES[-2]


def flash_operands(dev, shape, dtype, seed, g_lse=False, sk=None):
    """q, dO [B, H, Sq, D], k, v [B, H, Sk, D], the LSE cotangent (zero unless
    asked) and the scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kv_shape = shape[:2] + (sk or shape[2],) + shape[3:]
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in (shape, kv_shape, kv_shape, shape))
    glse = (torch.randn(shape[:-1], generator=g, device=dev) if g_lse
            else torch.zeros(shape[:-1], device=dev))
    return q, k, v, do, glse, shape[-1] ** -0.5


def mma_build_report(report: str):
    """Registers, spills and dynamic shared memory of each tensor-core flash
    kernel (by its template's head dim and key tile) from nvcc's -Xptxas -v
    report of csrc/flash_attention_mma.cu."""
    import re

    from harmony_tpu_torch.ops import cuda_lib

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?:\s|$)",
                      line)
        if m:
            k = re.search(r"(flash_(?:forward|backward_dkv|backward_dq)_mma_kernel)ILi(\d+)E"
                          r"(?:Li(\d+)E)?",
                          m.group(1))
            name = (k.group(1), int(k.group(2)), int(k.group(3) or 0)) if k else None
            continue
        if name is None:
            continue
        entry = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    codes = {"flash_forward_mma_kernel": 0, "flash_backward_dkv_mma_kernel": 1,
             "flash_backward_dq_mma_kernel": 2}
    for (kernel, d, bk), entry in out.items():
        entry["shared_bytes"] = cuda_lib.call(
            "harmony_flash_mma_shared_bytes", codes[kernel], d, bk)
    return out


def check_flash_kernels(dev):
    """K4, K5a and K5b against their plain versions on every case of
    FLASH_CASES, each on the route the case names and the same bit for bit
    when run again. Returns each kernel's max |kernel - plain| over the
    cases."""
    from harmony_tpu_torch.ops import attention as A

    err = {"flash_forward": 0.0, "flash_backward_dkv": 0.0, "flash_backward_dq": 0.0}

    def same_bits(a, b):
        return torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))

    def compare(kernel, name, case, got, want, dtype):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{kernel} {case}: {name} {tuple(got.shape)} {got.dtype}")
        gap = float((got.float() - want.float()).abs().max())
        rel = FLASH_BF16_REL if dtype == torch.bfloat16 and name != "lse" else FLASH_F32_REL
        tol = rel * float(want.float().abs().max())
        check(math.isfinite(gap) and gap <= tol,
              f"{kernel} {case}: {name} |kernel - plain| {gap} > {tol}")
        err[kernel] = max(err[kernel], gap)

    for i, (case, shape, sk, dtype, causal, block, g_lse, route) in enumerate(FLASH_CASES):
        q, k, v, do, glse, scale = flash_operands(dev, shape, dtype, 10 + i, g_lse, sk)
        args = (causal, block, block, scale)
        check(A.flash_route(dtype, shape[-1], block) == route,
              f"{case}: flash_route gives {A.flash_route(dtype, shape[-1], block)}, "
              f"expected {route}")
        wrappers = (A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)
        before = [w.launches_by_route[route] for w in wrappers]
        out, lse = A.flash_forward(q, k, v, *args)
        out2, lse2 = A.flash_forward(q, k, v, *args)
        torch.cuda.synchronize()
        out_p, lse_p = A.flash_forward_plain(q, k, v, *args)
        compare("flash_forward", "out", case, out, out_p, dtype)
        compare("flash_forward", "lse", case, lse, lse_p, dtype)
        delta = (do.float() * out_p.float()).sum(dim=-1) - glse
        dk, dv = A.flash_backward_dkv(q, k, v, do, lse_p, delta, *args)
        dk2, dv2 = A.flash_backward_dkv(q, k, v, do, lse_p, delta, *args)
        dq = A.flash_backward_dq(q, k, v, do, lse_p, delta, *args)
        dq2 = A.flash_backward_dq(q, k, v, do, lse_p, delta, *args)
        torch.cuda.synchronize()
        check([w.launches_by_route[route] for w in wrappers] == [n + 2 for n in before],
              f"{case}: K4/K5a/K5b did not launch on the {route} route")
        check(all(same_bits(a, b) for a, b in
                  ((out, out2), (lse, lse2), (dk, dk2), (dv, dv2), (dq, dq2))),
              f"{case}: K4/K5a/K5b run twice on the same inputs differ")
        dk_p, dv_p = A.flash_backward_dkv_plain(q, k, v, do, lse_p, delta, *args)
        dq_p = A.flash_backward_dq_plain(q, k, v, do, lse_p, delta, *args)
        compare("flash_backward_dkv", "dk", case, dk, dk_p, dtype)
        compare("flash_backward_dkv", "dv", case, dv, dv_p, dtype)
        compare("flash_backward_dq", "dq", case, dq, dq_p, dtype)
        print(f"phase 2b: flash kernels within tolerance on {case} {list(shape)} "
              f"Sk={sk} {str(dtype)[6:]} causal={causal} block={block}, K4/K5a/K5b on "
              f"route {route}, bit-identical when run twice", flush=True)
    return err


def time_flash_kernels(dev, case=FLASH_CASES[0]):
    """ms of each flash kernel, its plain version and the SDPA yardstick at the
    shape of ``case`` (the LM's, unless another is given), and the bound: the
    larger of the bytes over HBM bandwidth and the matrix products' operations
    over the bf16 tensor-core peak, counting only the (row, col) pairs the
    causal mask keeps. On the ``mma`` route also the first (scalar) kernels on
    the same operands; on ``simt`` they are the kernels timed."""
    import torch.nn.functional as F

    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops import cuda_lib

    _, shape, sk, dtype, causal, block, _, route = case
    B, H, S, D = shape
    check(sk == S, "the timed flash cases have Sq == Sk")
    q, k, v, do, glse, scale = flash_operands(dev, shape, dtype, 3)
    args = (causal, block, block, scale)
    out, lse = A.flash_forward(q, k, v, *args)
    delta = (do.float() * out.float()).sum(dim=-1) - glse
    stream = torch.cuda.current_stream().cuda_stream
    o1, lse1, dk1, dv1, dq1 = (torch.empty_like(t) for t in (out, lse, k, v, q))

    def first_forward():  # the first, scalar kernel on the same bf16 operands
        cuda_lib.launch("harmony_flash_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o1.data_ptr(), lse1.data_ptr(), 1, B * H, S, S, D, block,
                        float(scale), int(causal), stream)

    def first_dkv():
        cuda_lib.launch("harmony_flash_backward_dkv", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk1.data_ptr(), dv1.data_ptr(), 1, B * H, S, S, D, float(scale),
                        int(causal), stream)

    def first_dq():
        cuda_lib.launch("harmony_flash_backward_dq", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq1.data_ptr(), 1, B * H, S, S, D, float(scale), int(causal), stream)
    bh, e = B * H, q.element_size()
    pairs = bh * S * (S + 1) // 2 if causal else bh * S * S
    io = bh * S * D * e      # one of q, k, v, dO, O, dQ, dK, dV
    rows = bh * S * 4        # one of lse, delta

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def sdpa_forward():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_forward_backward():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal).backward(do)

    t = dict(samples=10, inner=3)
    sdpa_fwd = time_ms(sdpa_forward, **t)
    sdpa_bwd = time_ms(sdpa_forward_backward, **t) - sdpa_fwd
    # device time (torch.profiler, every kernel of a call): SDPA's backward is
    # its forward + backward less its forward
    sdpa_fwd_dev = device_ms(sdpa_forward, calls=20)
    sdpa_bwd_dev = device_ms(sdpa_forward_backward, calls=20) - sdpa_fwd_dev
    out = {}
    b, by = bound(4 * io + rows, 4 * D * pairs)
    kernel = lambda: A.flash_forward(q, k, v, *args)  # noqa: E731
    out["flash_forward"] = dict(
        ms=time_ms(kernel, **t), device_ms=device_ms(kernel, calls=20),
        plain_ms=time_ms(lambda: A.flash_forward_plain(q, k, v, *args), **t),
        **({"first_version_ms": time_ms(first_forward, **t)} if route == "mma" else {}),
        library_ms=sdpa_fwd, library_device_ms=sdpa_fwd_dev, bound_ms=b, bound_by=by)
    b, by = bound(6 * io + 2 * rows, 8 * D * pairs)
    kernel = lambda: A.flash_backward_dkv(q, k, v, do, lse, delta, *args)  # noqa: E731
    out["flash_backward_dkv"] = dict(
        ms=time_ms(kernel, **t), device_ms=device_ms(kernel, calls=20),
        plain_ms=time_ms(lambda: A.flash_backward_dkv_plain(q, k, v, do, lse, delta, *args),
                         **t),
        **({"first_version_ms": time_ms(first_dkv, **t)} if route == "mma" else {}),
        library_ms=sdpa_bwd, library_device_ms=sdpa_bwd_dev, bound_ms=b, bound_by=by)
    b, by = bound(5 * io + 2 * rows, 6 * D * pairs)
    kernel = lambda: A.flash_backward_dq(q, k, v, do, lse, delta, *args)  # noqa: E731
    out["flash_backward_dq"] = dict(
        ms=time_ms(kernel, **t), device_ms=device_ms(kernel, calls=20),
        plain_ms=time_ms(lambda: A.flash_backward_dq_plain(q, k, v, do, lse, delta, *args),
                         **t),
        **({"first_version_ms": time_ms(first_dq, **t)} if route == "mma" else {}),
        library_ms=sdpa_bwd, library_device_ms=sdpa_bwd_dev, bound_ms=b, bound_by=by)
    return out


# -- phases 3 and 4: the slice --------------------------------------------------


def run_slice():
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    steps = EPOCHS * BATCHES
    # K3 held against the CPU on the job where it does its main work; phase 4
    # takes the sparse route (K2), phase 2d the autotune's choice
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        reset_counts(*wrappers)
        gpu = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS)])
        launches = {w.__name__: w.launches for w in wrappers}
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        cpu = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS), "--device", "cpu"])
        cpu_seconds = time.perf_counter() - t0
        cpu_launches = [w.launches for w in wrappers]
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    losses = gpu["batch_losses"]
    check(len(losses) == steps, f"{len(losses)} step losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(gpu["losses"][1] < gpu["losses"][0]
          and sum(losses[BATCHES:]) < sum(losses[:BATCHES]),
          f"loss is not falling: {losses}")
    k1, fold = probe_launches(gpu)
    route = gpu["push_route"]
    check(route == "mxu", f"push route {route}, expected mxu")
    expected = {"gather_rows": steps + k1, "segment_sum_rows": 0,
                "weighted_histogram": steps + fold}
    check(launches == expected,
          f"launches on the card {launches}, expected K1 and K3 once a step and "
          f"{k1} and {fold} in the comm probe")
    print(f"phase 3: card losses {losses}, push route {route}, launches "
          f"{launches} ({k1} of K1 and {fold} of the fold in "
          f"{gpu['comm_probe']['probes']} comm probe), windows {gpu['windows']}",
          flush=True)

    check(not any(cpu_launches), "a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(losses, cpu["batch_losses"]))
    check(gap <= LOSS_ATOL, f"card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    print(f"phase 3: CPU losses {cpu['batch_losses']}, max |card - CPU| {gap}",
          flush=True)

    os.environ["HARMONY_PUSH_VIA"] = "sparse"
    try:
        reset_counts(*wrappers)
        sparse = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS)])
        sparse_launches = {w.__name__: w.launches for w in wrappers}
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    k1, fold = probe_launches(sparse)
    check(sparse_launches == {"gather_rows": steps + k1, "segment_sum_rows": steps + fold,
                              "weighted_histogram": 0},
          f"launches on the sparse route {sparse_launches}")
    sgap = max(abs(a - b) for a, b in zip(sparse["batch_losses"], losses))
    check(sgap <= LOSS_ATOL, f"sparse and {route} routes differ by {sgap} > {LOSS_ATOL}")
    print(f"phase 4: sparse-route losses {sparse['batch_losses']}, "
          f"max |sparse - {route}| {sgap}, launches {sparse_launches}", flush=True)

    summary = {
        "steps": steps,
        "examples_per_step": N_EXAMPLES // BATCHES,
        "epoch_seconds": gpu["epoch_seconds"],
        "samples_per_sec": N_EXAMPLES / gpu["epoch_seconds"][-1],
        "cpu_epoch_seconds": cpu["epoch_seconds"],
        "cpu_samples_per_sec": N_EXAMPLES / cpu["epoch_seconds"][-1],
        "cpu_run_seconds": cpu_seconds,
        "max_abs_loss_gap_card_vs_cpu": gap,
        "max_abs_loss_gap_sparse_vs_mxu": sgap,
        "final_loss": losses[-1],
        "push_route": route,
    }
    launches["segment_sum_rows"] += sparse_launches["segment_sum_rows"]
    return launches, summary, gpu, sparse


def probe_launches(result):
    """K1 and fold (K3, or K2 on the sparse route) launches of a keyed job's
    comm probes: each probe calls PULL (K1) and PULL+PUSH (K1, then the fold)
    once to warm up and PROBE_SAMPLES times to time."""
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    calls = result["comm_probe"]["probes"] * (1 + WorkerTasklet.PROBE_SAMPLES)
    return 2 * calls, calls


def run_unfused_slice(fused, fused_sparse):
    """Phase 3e: the Wide&Deep job of phase 3 on the unfused step
    (HARMONY_FUSED_STEP=0), on the mxu and the sparse push routes: its losses
    bit-identical to the fused runs of phases 3 and 4, K1 and the route's
    fold launched once a step each (no comm probe on the unfused path), and
    the mean phase seconds."""
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    steps = EPOCHS * BATCHES
    out = {}
    for route, reference, fold in (("mxu", fused, "weighted_histogram"),
                                   ("sparse", fused_sparse, "segment_sum_rows")):
        os.environ["HARMONY_FUSED_STEP"] = "0"
        os.environ["HARMONY_PUSH_VIA"] = route
        try:
            reset_counts(*wrappers)
            unfused = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS)])
            launches = {w.__name__: w.launches for w in wrappers}
        finally:
            os.environ.pop("HARMONY_FUSED_STEP")
            os.environ.pop("HARMONY_PUSH_VIA")
        expected = dict.fromkeys(launches, 0)
        expected.update({"gather_rows": steps, fold: steps})
        check(unfused["step_mode"] == "unfused", f"step mode {unfused['step_mode']}")
        check(launches == expected,
              f"unfused launches on the {route} route {launches}, expected {expected}")
        check(unfused["batch_losses"] == reference["batch_losses"],
              f"unfused losses on the {route} route {unfused['batch_losses']} are not "
              f"bit-identical to the fused {reference['batch_losses']}")
        out[route] = {"launches": launches, "phase_seconds": unfused["phase_seconds"],
                      "epoch_seconds": unfused["epoch_seconds"],
                      "fused_epoch_seconds": reference["epoch_seconds"]}
        print(f"phase 3e: unfused Wide&Deep on the {route} route bit-identical to the "
              f"fused step, launches {launches}, mean phase seconds "
              f"{unfused['phase_seconds']}", flush=True)
    return out


def path_launches(run):
    """``run()`` with every kernel's launch count set to 0 just before it; returns
    its result, the counts just after, and the flash kernels' counts by route."""
    from harmony_tpu_torch.ops import attention as A

    wrappers = all_wrappers()
    reset_counts(*wrappers)
    out = run()
    launches = {w.__name__: w.launches for w in wrappers}
    routes = {w.__name__: dict(w.launches_by_route)
              for w in (A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)}
    return out, launches, routes


def card_against_cpu(argv, phase):
    """A small f32 preset on the card and on the CPU, step for step, within
    LOSS_ATOL; returns the largest gap and the card run's flash launches."""
    card, launches, routes = path_launches(lambda: run_cli(argv))
    cpu, cpu_launches, _ = path_launches(lambda: run_cli(argv + ["--device", "cpu"]))
    check(not any(cpu_launches.values()), f"phase {phase}: a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(card["batch_losses"], cpu["batch_losses"]))
    check(all(math.isfinite(v) for v in card["batch_losses"]) and gap <= LOSS_ATOL,
          f"phase {phase}: {argv[1]} card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    check(all(launches[k] > 0 and routes[k]["mma"] == 0 for k in FLASH_KERNELS),
          f"phase {phase}: the f32 preset's flash launches {routes}, expected all on simt")
    return gap, launches


def flash_against_blockwise(argv, losses, phase):
    """The same run with attn=blockwise (no kernel launches), step for step within
    LM_BF16_REL of the loss; returns the blockwise result and the largest gap."""
    blockwise, launches, _ = path_launches(lambda: run_cli(argv + ["--set", "attn=blockwise"]))
    check(not any(launches.values()), f"phase {phase}: a kernel launched on the blockwise run")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, blockwise["batch_losses"]))
    check(rel <= LM_BF16_REL,
          f"phase {phase}: flash and blockwise losses differ by {rel} (relative) > {LM_BF16_REL}")
    return blockwise, rel


def finite_and_falling(losses, steps, what):
    half = steps // 2
    check(len(losses) == steps, f"{what}: {len(losses)} step losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss {losses}")
    check(sum(losses[half:]) < sum(losses[:half]), f"{what}: the loss is not falling {losses}")


def run_lm():
    """Phase 3b: the full-width LM through the CLI with flash attention, launch
    counts read around it, then the same run with blockwise attention."""
    gpu, launches, routes = path_launches(lambda: run_cli(LM_ARGS))
    losses = gpu["batch_losses"]
    finite_and_falling(losses, LM_STEPS, "LM")
    per_path = LM_STEPS * LM_LAYERS
    expected = {"gather_rows": 0, "segment_sum_rows": 0, "weighted_histogram": 0,
                **dict.fromkeys(FLASH_KERNELS, per_path)}
    check(launches == expected, f"LM launches {launches}, expected {expected}")
    check(all(r == {"mma": per_path, "simt": 0} for r in routes.values()),
          f"LM launches by route {routes}, expected all {per_path} on mma")
    print(f"phase 3b: LM losses {losses}, launches {launches}, by route {routes}",
          flush=True)
    blockwise, rel = flash_against_blockwise(LM_ARGS, losses, "3b")
    print(f"phase 3b: blockwise losses {blockwise['batch_losses']}, "
          f"max |flash - blockwise| / |blockwise| {rel}", flush=True)
    half = LM_STEPS // 2
    steady = gpu["epoch_seconds"][-1]
    return launches, {
        "steps": LM_STEPS,
        "tokens_per_step": LM_TOKENS_PER_STEP,
        "epoch_seconds": gpu["epoch_seconds"],
        "tokens_per_sec": half * LM_TOKENS_PER_STEP / steady,
        "step_ms": steady * 1e3 / half,
        "blockwise_epoch_seconds": blockwise["epoch_seconds"],
        "blockwise_tokens_per_sec":
            half * LM_TOKENS_PER_STEP / blockwise["epoch_seconds"][-1],
        "losses": losses,
        "max_rel_loss_gap_flash_vs_blockwise": rel,
    }


def run_lm_preset():
    """Phase 3c: the lm preset as shipped on the card, then on the CPU."""
    from harmony_tpu_torch.ops import attention as A

    flash = (A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)
    reset_counts(*flash)
    card = run_cli(["run", "lm"])
    launches = {w.__name__: w.launches for w in flash}
    steps = len(card["batch_losses"])  # the preset: 3 epochs of 4 steps, 2 layers
    check(steps == 12 and all(n == steps * 2 for n in launches.values()),
          f"lm preset: {steps} steps, launches {launches}")
    check(all(w.launches_by_route == {"mma": 0, "simt": steps * 2} for w in flash),
          "lm preset: K4/K5a/K5b did not take the simt route on f32 operands")
    reset_counts(*flash)
    cpu = run_cli(["run", "lm", "--device", "cpu"])
    check(all(w.launches == 0 for w in flash), "a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(card["batch_losses"], cpu["batch_losses"]))
    check(all(math.isfinite(v) for v in card["batch_losses"]) and gap <= LOSS_ATOL,
          f"lm preset: card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    print(f"phase 3c: lm preset card losses {card['batch_losses']}, "
          f"max |card - CPU| {gap}, launches {launches}", flush=True)
    return {"max_abs_loss_gap_card_vs_cpu": gap, "launches": launches}


# -- phases 3n, 3o and 3p: ViT, the MoE LM and generation ------------------------

def run_vit():
    """Phase 3n: the vit preset (f32) on the card against the CPU; bench-vit
    through the CLI with its launch counts read around it (K4, K5a and K5b 12
    times a step on simt), then with blockwise attention, step for step."""
    gap, preset_launches = card_against_cpu(["run", "vit"], "3n")
    gpu, launches, routes = path_launches(lambda: run_cli(VIT_ARGS))
    finite_and_falling(gpu["batch_losses"], VIT_STEPS, "bench-vit")
    per_path = VIT_STEPS * VIT_LAYERS
    expected = {"gather_rows": 0, "segment_sum_rows": 0, "weighted_histogram": 0,
                **dict.fromkeys(FLASH_KERNELS, per_path)}
    check(launches == expected, f"bench-vit launches {launches}, expected {expected}")
    check(all(r == {"mma": 0, "simt": per_path} for r in routes.values()),
          f"bench-vit launches by route {routes}, expected all {per_path} on simt")
    print(f"phase 3n: vit preset card against CPU within {gap}; bench-vit losses "
          f"{gpu['batch_losses']}, launches {launches}, by route {routes}", flush=True)
    blockwise, rel = flash_against_blockwise(VIT_ARGS, gpu["batch_losses"], "3n")
    steady = gpu["epoch_seconds"][-1]
    per_epoch = VIT_STEPS // 2 * VIT_BATCH
    out = {
        "preset_max_abs_loss_gap_card_vs_cpu": gap, "preset_launches": preset_launches,
        "losses": gpu["batch_losses"], "epoch_seconds": gpu["epoch_seconds"],
        "samples_per_sec": per_epoch / steady, "step_ms": steady * 1e3 / (VIT_STEPS // 2),
        "blockwise_epoch_seconds": blockwise["epoch_seconds"],
        "blockwise_samples_per_sec": per_epoch / blockwise["epoch_seconds"][-1],
        "max_rel_loss_gap_flash_vs_blockwise": rel,
    }
    print(f"phase 3n: bench-vit {out['samples_per_sec']:.1f} samples/s (blockwise "
          f"{out['blockwise_samples_per_sec']:.1f}), flash against blockwise within {rel}",
          flush=True)
    return launches, out


def run_moe():
    """Phase 3o: the lm preset with 4 experts (f32) on the card against the CPU;
    bench-lm-moe through the CLI with its launch counts read around it, a second
    run bit for bit with each MoE block's routing recorded (the share of tokens
    dropped, the aux loss), and the run with blockwise attention."""
    from harmony_tpu_torch.models import moe

    preset = ["run", "lm", "--set", "moe_experts=4", "--set", "moe_every=2"]
    gap, preset_launches = card_against_cpu(preset, "3o")
    gpu, launches, routes = path_launches(lambda: run_cli(MOE_ARGS))
    finite_and_falling(gpu["batch_losses"], LM_STEPS, "bench-lm-moe")
    per_path = LM_STEPS * LM_LAYERS
    expected = {"gather_rows": 0, "segment_sum_rows": 0, "weighted_histogram": 0,
                **dict.fromkeys(FLASH_KERNELS, per_path)}
    check(launches == expected, f"bench-lm-moe launches {launches}, expected {expected}")
    check(all(r == {"mma": per_path, "simt": 0} for r in routes.values()),
          f"bench-lm-moe launches by route {routes}, expected all {per_path} on mma")

    route, stats = moe.route, []

    def recorded(x, router, num_experts, capacity):
        r = route(x, router, num_experts, capacity)
        stats.append(torch.stack([(~r.keep).float().mean(), r.aux.detach()]))
        return r

    moe.route = recorded
    try:
        again = run_cli(MOE_ARGS)
    finally:
        moe.route = route
    check(again["batch_losses"] == gpu["batch_losses"],
          f"bench-lm-moe: two runs differ: {gpu['batch_losses']} and {again['batch_losses']}")
    check(len(stats) == LM_STEPS * MOE_BLOCKS,
          f"bench-lm-moe: {len(stats)} routings recorded, expected {LM_STEPS * MOE_BLOCKS}")
    per_step = torch.stack(stats).view(LM_STEPS, MOE_BLOCKS, 2).cpu()
    print(f"phase 3o: moe lm preset card against CPU within {gap}; bench-lm-moe losses "
          f"{gpu['batch_losses']}, the same bits run again; launches {launches}, by route "
          f"{routes}", flush=True)
    blockwise, rel = flash_against_blockwise(MOE_ARGS, gpu["batch_losses"], "3o")
    steady = gpu["epoch_seconds"][-1]
    half = LM_STEPS // 2
    out = {
        "preset_max_abs_loss_gap_card_vs_cpu": gap, "preset_launches": preset_launches,
        "losses": gpu["batch_losses"], "epoch_seconds": gpu["epoch_seconds"],
        "tokens_per_sec": half * LM_TOKENS_PER_STEP / steady, "step_ms": steady * 1e3 / half,
        "dropped_share_by_step_and_block": per_step[:, :, 0].tolist(),
        "aux_by_step_and_block": per_step[:, :, 1].tolist(),
        "blockwise_tokens_per_sec": half * LM_TOKENS_PER_STEP / blockwise["epoch_seconds"][-1],
        "max_rel_loss_gap_flash_vs_blockwise": rel,
    }
    print(f"phase 3o: bench-lm-moe {out['tokens_per_sec']:.0f} tokens/s, dropped share by "
          f"block at the first and last step {per_step[0, :, 0].tolist()} "
          f"{per_step[-1, :, 0].tolist()}, aux {per_step[0, :, 1].tolist()} "
          f"{per_step[-1, :, 1].tolist()}; flash against blockwise within {rel}", flush=True)
    return launches, out


def run_generate(lm_losses):
    """Phase 3p: bench-lm trained as phase 3b trains it (the JobServer's set-up of
    the same job; its losses must be phase 3b's bits), then generation from its
    weights: greedy twice and at temperature 1.0 twice with one key, the same
    tokens each time; prefill ms, decode ms a token, tokens/s. Then the f32 copy
    of the model (blockwise attention): every decode step's logits against the
    full forward's at that position, and the greedy tokens against the full
    forward's stepwise argmax, except at near-ties. Returns the launch counts
    around the generation, the summary, and one decode step for phase 5f."""
    import dataclasses

    from harmony_tpu_torch import cli
    from harmony_tpu_torch.models.generate import (
        cast_params,
        decode_step,
        init_kv_cache,
        make_generate_fn,
        prefill,
    )
    from harmony_tpu_torch.models.pytree_trainer import unravel
    from harmony_tpu_torch.models.transformer import TransformerLM, make_lm_data
    from harmony_tpu_torch.utils import prng

    args = cli.build_parser().parse_args(LM_ARGS)
    entity, worker = job_worker(cli.build_config(args.app, args), "cuda")
    try:
        trained = worker.run()
        trainer = worker.trainer
        flat = trainer._section(worker.ctx.model_table.pull_array(), 0)
    finally:
        entity.cleanup()
    same = trained["batch_losses"] == lm_losses
    check(same, f"phase 3p: the trained LM's losses {trained['batch_losses']} are not "
                f"phase 3b's {lm_losses}")
    params = unravel(flat, trainer._shapes)
    model = trainer.model
    dev = torch.device("cuda")
    prompt = torch.as_tensor(make_lm_data(GEN_BATCH, GEN_PROMPT, 8192, seed=1), device=dev)
    key = prng.PRNGKey(torch.tensor(1, device=dev))
    greedy = make_generate_fn(model, GEN_PROMPT, GEN_NEW)
    sample = make_generate_fn(model, GEN_PROMPT, GEN_NEW, temperature=1.0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run():
        return [timed(lambda: greedy(params, prompt)) for _ in range(2)] + [
            timed(lambda: sample(params, prompt, key)) for _ in range(2)]

    runs, launches, _ = path_launches(run)
    (g1, _), (g2, greedy_s), (s1, _), (s2, sample_s) = runs
    check(torch.equal(g1, g2), "phase 3p: two greedy generations differ")
    check(torch.equal(s1, s2), "phase 3p: two generations at temperature 1.0 with one key differ")
    check(g1.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW) and torch.equal(g1[:, :GEN_PROMPT],
                                                                        prompt.int()),
          f"phase 3p: generated {tuple(g1.shape)}, the prompt not kept")
    prefill_s = []
    for _ in range(3):
        cache = init_kv_cache(model.config, GEN_BATCH, dev)
        prefill_s.append(timed(lambda: prefill(model, params, cache, prompt))[1])
    prefill_ms = min(prefill_s) * 1e3
    decode_ms = (greedy_s * 1e3 - prefill_ms) / GEN_NEW

    # the f32 copy: each step's logits against the full forward's
    model32 = TransformerLM(dataclasses.replace(model.config, dtype=torch.float32,
                                                attn="blockwise"))
    with torch.no_grad():
        cache = init_kv_cache(model32.config, GEN_BATCH, dev)
        logits, cache = prefill(model32, params, cache, prompt)
        steps, toks = [logits], []
        positions = torch.arange(GEN_PROMPT, GEN_PROMPT + GEN_NEW, device=dev)
        for j in range(GEN_NEW):
            toks.append(torch.argmax(logits, dim=-1))
            logits, cache = decode_step(model32, params, cache, toks[-1], positions[j:j + 1])
            steps.append(logits)
        seq = torch.cat([prompt.long(), torch.stack(toks, dim=1)], dim=1)
        full = model32.apply(params, seq)[:, GEN_PROMPT - 1:]        # [B, 513, V]
        steps = torch.stack(steps, dim=1)
        gen32 = make_generate_fn(model32, GEN_PROMPT, GEN_NEW)(params, prompt)
        check(torch.equal(gen32, seq.int()),
              "phase 3p: make_generate_fn's f32 tokens differ from its own steps")
        tol = GEN_F32_REL * max(1.0, float(full.abs().max()))
        gap = float((steps - full).abs().max())
        check(math.isfinite(gap) and gap <= tol,
              f"phase 3p: f32 decode logits differ from the full forward's by {gap} > {tol}")
        top2 = torch.topk(full[:, :-1], 2, dim=-1).values
        near_tie = (top2[..., 0] - top2[..., 1]) <= tol
        differ = torch.argmax(full[:, :-1], dim=-1) != seq[:, GEN_PROMPT:]
        check(not bool((differ & ~near_tie).any()),
              "phase 3p: a greedy token differs from the full forward's argmax off a near-tie")
    out = {
        "trained_losses_bit_identical_to_phase_3b": same,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "greedy_tokens_per_sec": GEN_BATCH * GEN_NEW / greedy_s,
        "sampled_tokens_per_sec": GEN_BATCH * GEN_NEW / sample_s,
        "f32_max_abs_logit_gap": gap, "f32_tolerance": tol,
        "f32_near_ties": int(near_tie.sum()), "f32_tokens_off_argmax_at_near_ties":
            int((differ & near_tie).sum()),
    }
    print(f"phase 3p: generation deterministic (greedy, temperature 1.0); f32 decode within "
          f"{gap} of the full forward (limit {tol}), near-ties {out['f32_near_ties']}; "
          f"{json.dumps(out)}", flush=True)

    # one decode step as generate runs it: the weights cast once, position 512
    cast = cast_params(model.config, params)
    cache = init_kv_cache(model.config, GEN_BATCH, dev)
    with torch.no_grad():
        prefill(model, cast, cache, prompt)
    tok, pos = g1[:, GEN_PROMPT], positions[:1]

    def decode_once():
        with torch.no_grad():
            decode_step(model, cast, cache, tok, pos)

    return launches, out, decode_once


# -- phase 3d: the BASELINE config-4 trio ----------------------------------------

TRIO_SCALE = 1.0
BASELINE_SCALE = 0.125
AGREE_EPOCHS = 2
# The trio's per-batch primary metrics, card against CPU at BASELINE_SCALE for
# AGREE_EPOCHS epochs: MLR and NMF within 1e-4 * max(1, |value|) (f32 sums in
# another order: cuBLAS against the CPU's products, the card's reductions
# against the CPU's; the losses are ~5 and ~100-250).
TRIO_REL = 1e-4
# LDA: the card's and the CPU's logs differ in the last bit, so a near-tie can
# flip a draw, and a flip moves later counts. Its first batch's assignments
# must agree on at least 99.99% of tokens, and each epoch's mean
# log-likelihood within 1% of the CPU's.
LDA_FIRST_BATCH_SHARE = 0.9999
LDA_LL_REL = 0.01
# The reference's windows for a 12-epoch job with comm_probe_period 6: the
# epoch-0 probe, then windows of 8 and 4 epochs (the next probe is due at 48).
TRIO_WINDOWS = [8, 4]


def all_wrappers():
    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    return (gather_rows, segment_sum_rows, weighted_histogram,
            A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)


def run_trio():
    """Phase 3d: MLR, NMF and LDA submitted together to one JobServer on the
    card through harmony_tpu_torch.bench.run_concurrent, at full size: a
    1-epoch warm-up, then the measured pass with the launch counts read around
    it; then the CPU baseline. Under the JobServer each job runs per-batch
    epochs under TaskUnit admission (the reference's schedule); the fused
    windows are held by trio_windows_without_syncs, outside it. Returns the
    launches, the summary and run_concurrent's jobs."""
    from harmony_tpu_torch import bench

    from harmony_tpu_torch.data import devcache

    wrappers = all_wrappers()
    dev = torch.device("cuda")
    epochs = bench.EPOCHS
    with counted_data_fns() as calls:
        bench.run_concurrent([dev], TRIO_SCALE, job_timeout=600.0, epochs=1)
        warmup_calls = dict(calls)
        calls.clear()
        before = {"device": devcache.stats(), "host": devcache.host_data.stats()}
        reset_counts(*wrappers)
        rate, walls, jobs = bench.run_concurrent([dev], TRIO_SCALE, job_timeout=600.0,
                                                 epochs=epochs)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers}
        measured_calls = dict(calls)
    caches = {name: {k: stats[k] - before[name][k] for k in ("hits", "misses")}
              for name, stats in (("device", devcache.stats()),
                                  ("host", devcache.host_data.stats()))}
    windows = {k: j["worker"]["windows"] for k, j in jobs.items()}
    # under the JobServer every job runs per-batch epochs under TaskUnit
    # admission (its windows are batched epochs with one drain)
    fused = {k: j["worker"]["fused_epochs"] for k, j in jobs.items()}
    check(not any(fused.values()), f"fused windows under the JobServer: {fused}")
    check(sum(measured_calls.values()) == 0,
          f"the measured pass called data_fn {measured_calls}")
    check(caches["device"]["misses"] == 0 and caches["host"]["misses"] == 0,
          f"the measured pass missed a data cache: {caches}")
    check(all(w == TRIO_WINDOWS for w in windows.values()),
          f"windows {windows}, expected {TRIO_WINDOWS} for every job")
    print(f"phase 3d: data_fn calls: warm-up {warmup_calls}, measured pass "
          f"{measured_calls}; cache hits and misses over the measured pass {caches}; "
          f"per-batch epochs under TaskUnit admission in windows {windows}; grants "
          f"{json.dumps({k: j['grants'] for k, j in jobs.items()})}", flush=True)
    expected = dict.fromkeys(launches, 0)
    expected["weighted_histogram"] = 1   # NMF's init multi_update
    check(launches == expected, f"trio launches {launches}, expected {expected}")
    batch = {job_id: j["worker"]["batch_losses"] for job_id, j in jobs.items()}
    per_epoch = {job_id: j["worker"]["losses"] for job_id, j in jobs.items()}
    # NMF at these settings (bench.py's) diverges from its second epoch in both
    # packages (tests/test_torch_apps.py::
    # test_nmf_at_the_bench_settings_collapses_in_both_packages): only its
    # first epoch is held finite and falling
    nmf_first = batch["bench-nmf"][:bench.BATCHES]
    for job_id, losses in {**batch, "bench-nmf": nmf_first}.items():
        check(len(losses) == (bench.BATCHES if losses is nmf_first else epochs * bench.BATCHES)
              and all(math.isfinite(v) for v in losses),
              f"{job_id}: {len(losses)} batch metrics, or not finite: {losses}")
    check(per_epoch["bench-mlr"][-1] < per_epoch["bench-mlr"][0] and nmf_first[-1] < nmf_first[0],
          f"MLR's or NMF's first-epoch loss is not falling: {per_epoch}")
    check(per_epoch["bench-lda"][-1] > per_epoch["bench-lda"][0],
          f"LDA log-likelihood is not rising: {per_epoch['bench-lda']}")
    starts = [j["setup_start_s"] for j in jobs.values()]
    ends = [j["end_s"] for j in jobs.values()]
    check(max(starts) < min(ends), f"the jobs did not overlap: starts {starts}, ends {ends}")
    train_overlap = (max(j["train_start_s"] for j in jobs.values())
                     < min(j["train_end_s"] for j in jobs.values()))
    train_spans = {k: [j["train_start_s"], j["train_end_s"]] for k, j in jobs.items()}
    print(f"phase 3d: trio on the card {rate:.1f} samples/s, walls {walls}, "
          f"launches {launches}, every job started before any finished; training "
          f"spans (s from the first submission) {train_spans}, all overlap: "
          f"{train_overlap}", flush=True)
    t0 = time.perf_counter()
    cpu_rate = bench.cpu_baseline_rate(BASELINE_SCALE, epochs)
    summary = {
        "samples_per_sec": rate,
        "data_fn_calls": {"warm_up": warmup_calls, "measured": measured_calls},
        "cache_hits_misses": caches,
        "windows": windows,
        "fused_epochs": fused,
        "grants": {k: j["grants"] for k, j in jobs.items()},
        "comm_probe": {k: j["worker"]["comm_probe"] for k, j in jobs.items()},
        "cpu_rate": cpu_rate,
        "vs_baseline": rate / cpu_rate,
        "cpu_baseline_seconds": time.perf_counter() - t0,
        "epochs": epochs,
        "job_walls_s": walls,
        "steady_epoch_s": bench.steady_epoch_seconds(jobs),
        "epoch_seconds": {k: j["worker"]["epoch_seconds"] for k, j in jobs.items()},
        "spans_s": {k: [j["setup_start_s"], j["train_start_s"], j["train_end_s"], j["end_s"]]
                    for k, j in jobs.items()},
        "training_spans_overlap": train_overlap,
        "per_epoch_metric": per_epoch,
    }
    return launches, summary, jobs


@contextlib.contextmanager
def counted_data_fns():
    """Count the calls of the trio's data generators (resolved by name at
    each job's set-up, so the wrappers are what the entity calls)."""
    from harmony_tpu_torch.apps import lda, mlr, nmf

    calls = {}
    saved = {m: m.make_synthetic for m in (mlr, nmf, lda)}

    def counted(module, fn):
        def wrapper(*args, **kw):
            name = module.__name__.rsplit(".", 1)[-1]
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapper

    for m, fn in saved.items():
        m.make_synthetic = counted(m, fn)
    try:
        yield calls
    finally:
        for m, fn in saved.items():
            m.make_synthetic = fn


def trio_windows_without_syncs():
    """Phase 3d: each trio job alone at full size (its data and stack from the
    caches), outside a JobServer so that it runs the fused windows, with CUDA's
    sync debug mode set to raise while each window is enqueued and cleared for
    its one drain: a window makes no blocking host copy and no other sync. The
    jobs run one after another, on this thread alone, because the mode is
    process-wide. Returns each job's windows, epoch seconds and per-batch
    losses."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    out = {}
    for config in bench.job_configs(TRIO_SCALE, bench.EPOCHS)[0]:
        master = ETMaster(DevicePool([torch.device("cuda")]))
        entity = DolphinJobEntity(config)
        entity.setup(master, [e.id for e in master.add_executors(1)])
        worker = entity.make_worker()
        enqueue = worker._enqueue_fused_window
        drains = []

        def checked(first_epoch, k, enqueue=enqueue, drains=drains):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return enqueue(first_epoch, k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                drains.append(k)

        worker._enqueue_fused_window = checked
        try:
            result = worker.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            entity.cleanup()
        check(drains == result["windows"] == TRIO_WINDOWS and result["fused_epochs"],
              f"{config.job_id}: windows {drains}, {result['windows']}, fused "
              f"{result['fused_epochs']}")
        out[config.job_id] = {"windows": drains, "epoch_seconds": result["epoch_seconds"],
                              "batch_losses": result["batch_losses"]}
    print(f"phase 3d: every window of each trio job enqueued with no host sync "
          f"(sync debug mode 'error'): {json.dumps(out)}", flush=True)
    return out


def run_async_mlr():
    """Phase 3f: bench.py's MLR job (full size, 12 epochs) alone through the
    JobServer on the fused step, then on the async step at staleness bound 0
    (bit-identical to the fused step) and bound 1 (finite losses, lag at most
    1)."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    config = bench.job_configs(TRIO_SCALE, bench.EPOCHS)[0][0]
    examples = bench.job_configs(TRIO_SCALE, bench.EPOCHS)[1][config.job_id]
    runs = {}
    for name, changes in (("fused", {}),
                          ("bound0", {"async_step": True, "staleness_bound": 0}),
                          ("bound1", {"async_step": True, "staleness_bound": 1})):
        cfg = config.replace(job_id=f"async-{name}",
                             params=config.params.replace(**changes))
        server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
        server.start()
        try:
            (worker,) = server.submit(cfg).result(timeout=600)["workers"].values()
        finally:
            server.shutdown()
        runs[name] = worker
    b0, b1 = runs["bound0"], runs["bound1"]
    check(b0["step_mode"] == b1["step_mode"] == "async", "the async step did not run")
    check(b0["batch_losses"] == runs["fused"]["batch_losses"],
          f"async bound 0 losses {b0['batch_losses']} are not bit-identical to the "
          f"fused step's {runs['fused']['batch_losses']}")
    check(all(math.isfinite(v) for v in b1["batch_losses"])
          and b1["staleness"]["max_lag"] <= 1,
          f"async bound 1: losses {b1['batch_losses']}, {b1['staleness']}")

    def rate(w):
        return examples / (w["train_span"][1] - w["train_span"][0])

    out = {name: {"samples_per_sec": rate(w), "epoch_seconds": w["epoch_seconds"],
                  "phase_seconds": w.get("phase_seconds"),
                  "staleness": w.get("staleness"), "final_loss": w["losses"][-1]}
           for name, w in runs.items()}
    print(f"phase 3f: async MLR bound 0 bit-identical to the fused step; samples/s "
          f"fused {out['fused']['samples_per_sec']:.0f}, bound 0 "
          f"{out['bound0']['samples_per_sec']:.0f}, bound 1 "
          f"{out['bound1']['samples_per_sec']:.0f}; bound 1 staleness "
          f"{b1['staleness']}", flush=True)
    return out


def chrome_trace(prof, name: str) -> list:
    """The profile's trace events, through a Chrome trace written into the
    kernels' build directory (git-ignored) and removed after reading."""
    out_dir = os.path.join(REPO, "harmony_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def event_stream(e: dict):
    args = e.get("args", {})
    return args.get("stream", e.get("tid"))


def run_prefetch():
    """Phase 3g: the Wide&Deep job of phase 3 (full width, 2 epochs) on a
    shuffling provider, through WorkerTasklet with input_prefetch on and off:
    bit-identical losses; under torch.profiler the staged batches are
    `Memcpy HtoD (Pinned -> Device)` copies on a stream that runs none of the
    steps' kernels; the ring's stall and idle seconds."""
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic
    from harmony_tpu_torch.config.params import TrainerParams
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    arrays = list(make_synthetic(N_EXAMPLES, 100000, 16))

    def run(prefetch):
        trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                                  hidden=128, step_size=0.1)
        table = DenseTable(TableSpec(trainer.model_table_config()), "cuda")
        params = TrainerParams(num_epochs=EPOCHS, num_mini_batches=BATCHES,
                               input_prefetch=prefetch)
        data = TrainingDataProvider(arrays, BATCHES, shuffle_each_epoch=True, seed=5)
        worker = WorkerTasklet("prefetch", TrainerContext(params=params, model_table=table),
                               trainer, data)
        return worker.run()

    off = run(False)
    got = {}
    prof, _ = profiled(lambda: got.update(on=run(True)), cpu=True)
    on = got["on"]
    check(on["batch_losses"] == off["batch_losses"],
          f"losses with prefetch {on['batch_losses']} are not bit-identical to "
          f"those without {off['batch_losses']}")
    events = [e for e in chrome_trace(prof, "prefetch") if e.get("ph") == "X"]
    pinned = [e for e in events if e.get("name") == "Memcpy HtoD (Pinned -> Device)"]
    copy_streams = {event_stream(e) for e in pinned}
    step_streams = {event_stream(e) for e in events
                    if e.get("cat") == "kernel" and "gather_rows" in e.get("name", "")}
    staged = on["input"]["staged"]
    check(staged == EPOCHS * BATCHES and on["input"]["prefetch_hits"] == staged,
          f"prefetch input stats {on['input']}")
    check(len(pinned) >= staged * len(arrays),
          f"{len(pinned)} pinned host-to-device copies for {staged} staged batches")
    check(step_streams and not copy_streams & step_streams,
          f"pinned copies on streams {copy_streams}, the steps' K1 on {step_streams}")
    out = {"input": on["input"], "pinned_copies": len(pinned),
           "copy_streams": sorted(map(str, copy_streams)),
           "step_streams": sorted(map(str, step_streams)),
           "epoch_seconds_on": on["epoch_seconds"], "epoch_seconds_off": off["epoch_seconds"]}
    print(f"phase 3g: prefetch on and off bit-identical; {len(pinned)} pinned copies on "
          f"streams {out['copy_streams']}, the steps on {out['step_streams']}; ring "
          f"stall {on['input']['consumer_stall_sec']} s, producer idle "
          f"{on['input']['producer_idle_sec']} s", flush=True)
    return out


def trio_agreement():
    """Phase 3d: the trio at BASELINE_SCALE for AGREE_EPOCHS epochs on the card
    and on the CPU, per-batch primary metrics compared."""
    from harmony_tpu_torch import bench

    runs = [bench.run_concurrent([torch.device(d)], BASELINE_SCALE, epochs=AGREE_EPOCHS)[2]
            for d in ("cuda", "cpu")]
    card, cpu = ({k: np.array(j["worker"]["batch_losses"]) for k, j in r.items()}
                 for r in runs)
    out = {}
    for job_id in ("bench-mlr", "bench-nmf"):
        rel = float(np.max(np.abs(card[job_id] - cpu[job_id])
                           / np.maximum(1.0, np.abs(cpu[job_id]))))
        check(rel <= TRIO_REL, f"{job_id}: card and CPU batch metrics differ by {rel} "
              f"(relative to max(1, |value|)) > {TRIO_REL}")
        out[f"{job_id}_max_rel_gap"] = rel
    lda_card, lda_cpu = (x["bench-lda"].reshape(AGREE_EPOCHS, -1).mean(axis=1)
                         for x in (card, cpu))
    gap = np.abs(lda_card - lda_cpu)
    check(bool(np.all(gap <= LDA_LL_REL * np.abs(lda_cpu))),
          f"LDA per-epoch log-likelihood: card {lda_card}, CPU {lda_cpu}")
    out.update(lda_epoch_ll_card=lda_card.tolist(), lda_epoch_ll_cpu=lda_cpu.tolist(),
               lda_max_epoch_ll_gap=float(gap.max()),
               lda_max_batch_ll_gap=float(np.max(np.abs(card["bench-lda"]
                                                        - cpu["bench-lda"]))))
    print(f"phase 3d: card against CPU at scale {BASELINE_SCALE}, {AGREE_EPOCHS} epochs: "
          f"{json.dumps(out)}", flush=True)
    return out


def lda_assignments():
    """Phase 3d: LDA's assignments on the card against the CPU at
    BASELINE_SCALE (its first batch, then after AGREE_EPOCHS epochs), and the
    int32 read-back of the card's local table through multi_get (K1)."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.ops.sparse import gather_rows
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    config = bench.job_configs(BASELINE_SCALE, AGREE_EPOCHS)[0][2]
    entities, workers = [], {}
    for d in ("cuda", "cpu"):   # the JobServer's set-up of the job, on each device
        master = ETMaster(DevicePool([torch.device(d)]))
        entity = DolphinJobEntity(config)
        entity.setup(master, [e.id for e in master.add_executors(1)])
        entities.append(entity)
        workers[d] = entity.make_worker()
    first = {}
    for d, w in workers.items():
        w.trainer.init_global_settings(w.ctx)
        w.trainer.on_training_start(w.ctx, 0)
        batch = w._to_device(next(iter(w.data.epoch_batches())))
        with torch.no_grad():
            _, new_local, _ = w.trainer.compute_with_local(
                w.ctx.model_table.pull_array(), w.ctx.local_table.pull_array(), batch,
                w._hyper())
        first[d] = new_local[batch[0].long()].cpu()
    first_share = float((first["cuda"] == first["cpu"]).float().mean())
    check(first_share >= LDA_FIRST_BATCH_SHARE,
          f"LDA's first batch: {first_share} of assignments identical < {LDA_FIRST_BATCH_SHARE}")
    results = {d: w.run() for d, w in workers.items()}
    local_card = workers["cuda"].ctx.local_table
    final = local_card.pull_array().cpu()
    final_share = float((final == workers["cpu"].ctx.local_table.pull_array()).float().mean())
    before = gather_rows.launches
    got = local_card.multi_get(np.arange(config.params.app_params["num_docs"]))
    check(gather_rows.launches == before + 1, "multi_get of the int32 table did not launch K1")
    check(got.dtype == np.int32 and got.tobytes() == final.numpy().tobytes(),
          "multi_get of LDA's int32 local table is not byte-identical to pull_array")
    for entity in entities:
        entity.cleanup()
    out = {"first_batch_identical_share": first_share,
           "final_identical_share": final_share,
           "epoch_ll_card": results["cuda"]["losses"],
           "epoch_ll_cpu": results["cpu"]["losses"]}
    print(f"phase 3d: LDA assignments {json.dumps(out)}; int32 multi_get of "
          f"{got.shape} byte-identical to pull_array (K1)", flush=True)
    return out


# -- the sparse path: hash tables, bench-fm-hash, sparse LDA, the accessor ----

# bench-fm-hash (benchmarks/apps.py:68-81, BASELINE config 5's true shape) at
# full width: the model in a DeviceHashTable of 256 blocks of 2,048 slots x 17
# f32, ids from the whole int32 domain; cut to EPOCHS epochs.
FM_HASH_APP = {"vocab_size": 100_000, "num_slots": 16, "emb_dim": 16,
               "step_size": 0.1, "sparse": True}
FM_HASH_DATA = {"n": N_EXAMPLES, "vocab_size": 100_000, "num_slots": 16}
# sparse LDA at the trio's width (bench.py's LDA with sparse=True): 64 blocks
# of 1,024 slots x 64 f32; cut to AGREE_EPOCHS epochs.
SPARSE_LDA_APP = {"vocab_size": 8192, "num_topics": 64, "num_docs": 2048,
                  "max_doc_len": 128, "sparse": True}
SPARSE_LDA_DATA = {"num_docs": 2048, "vocab_size": 8192, "num_topics": 64,
                   "doc_len": 128}
# bench-fm-hash's table values, card against CPU, after EPOCHS epochs. The
# push folds in the same order on both (K2 against its plain version); the
# deltas differ only where the FM's gradient sums are taken in another order
# (last bits, like the losses under LOSS_ATOL). The values stay below 1 in
# magnitude, where one f32 rounding is at most 6e-8, and 16 steps of such
# deltas stay within 1e-6. Measured: 3.7e-9 on an H100 80GB HBM3 at 700 W.
HASH_VALUE_ATOL = 1e-6


def hash_job(kind: str, epochs: int, **params):
    """The JobConfig of bench-fm-hash (kind "fm") or sparse LDA ("lda");
    ``params`` override its TrainerParams (comm_probe_period 6, as bench's)."""
    from harmony_tpu_torch.config.params import JobConfig, TrainerParams

    app, trainer, app_params, data = {
        "fm": ("widedeep", "FMTrainer", FM_HASH_APP, FM_HASH_DATA),
        "lda": ("lda", "LDATrainer", SPARSE_LDA_APP, SPARSE_LDA_DATA)}[kind]
    return JobConfig(
        job_id=f"bench-{kind}-hash", app_type="dolphin",
        trainer=f"harmony_tpu_torch.apps.{app}:{trainer}",
        params=TrainerParams(**{"num_epochs": epochs, "num_mini_batches": BATCHES,
                                "comm_probe_period": 6, "app_params": app_params,
                                **params}),
        num_workers=1,
        user={"data_fn": f"harmony_tpu_torch.apps.{app}:make_synthetic_sparse",
              "data_args": data})


def job_worker(config, device):
    """The JobServer's set-up of ``config`` (DolphinJobEntity) on ``device``:
    returns the entity (for cleanup) and its worker."""
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool([torch.device(device)]))
    entity = DolphinJobEntity(config)
    entity.setup(master, [e.id for e in master.add_executors(1)])
    return entity, entity.make_worker()


def windows_without_syncs(worker):
    """Set CUDA's sync debug mode to raise while each fused window of
    ``worker`` is enqueued (cleared for its drain); returns the windows seen."""
    enqueue = worker._enqueue_fused_window
    seen = []

    def checked(first_epoch, k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return enqueue(first_epoch, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            seen.append(k)

    worker._enqueue_fused_window = checked
    return seen


def check_hash_ops(dev):
    """Phase 2c: the hash table's ops on the card against the port's CPU route
    on the same inputs, byte for byte (slot keys, values, every returned value
    and overflow count): same-slot races between distinct keys and duplicates,
    overflow, an exhausted probe budget, each update mode (add, add_nonneg's
    post, min, max, assign) on float deltas with refused keys, put of -0.0,
    and bench-fm-hash's table at full width (two steps' pulls and pushes of
    65,537 keys). The push folds duplicates with K2 (no float atomics), so
    float deltas give the same bits on both."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer, SPARSE_EXTRA_BASE, make_synthetic_sparse
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.table.hashtable import MAX_KEY, DeviceHashTable, HashTableSpec

    rng = np.random.default_rng(7)

    def keys_of(n):
        return rng.choice(MAX_KEY, size=n, replace=False).astype(np.int32) + 1

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def run_case(name, ops, max_probes=16, **cfg):
        config = TableConfig(table_id="h", is_ordered=False, sparse=True, **cfg)
        tables = [DeviceHashTable(HashTableSpec(config, max_probes=max_probes), d)
                  for d in (dev, torch.device("cpu"))]
        for op, *args in ops:
            card, cpu = (getattr(t, op)(*args) for t in tables)
            torch.cuda.synchronize()
            same = (card.tobytes() == cpu.tobytes() if isinstance(card, np.ndarray)
                    else card == cpu)
            check(same, f"hash ops {name}: {op} differs on the card and the CPU")
        for a, b in zip(tables[0].state, tables[1].state):
            check(same_bits(a.cpu(), b), f"hash ops {name}: state not byte-identical")
        check(tables[0].overflow_count == tables[1].overflow_count,
              f"hash ops {name}: overflow {tables[0].overflow_count} != "
              f"{tables[1].overflow_count}")
        return {"present": tables[0].num_present(), "overflow": tables[0].overflow_count}

    out = {}
    race = np.arange(24, dtype=np.int32) * 7919 + 13
    race = np.concatenate([race, race[::3], race[5:9]])
    out["races"] = run_case("races", [("multi_update", race, normal(len(race), 4)),
                                      ("multi_get_or_init", race[::-1].copy())],
                            max_probes=32, capacity=32, value_shape=(4,), num_blocks=1)
    over = keys_of(40)
    out["overflow"] = run_case("overflow", [("multi_update", over, normal(40, 4)),
                                            ("multi_get_or_init", over),
                                            ("multi_get", over)],
                               capacity=16, value_shape=(4,), num_blocks=1)
    out["probe budget"] = run_case("probe budget", [("multi_update", keys_of(60), normal(60, 4))],
                                   max_probes=2, capacity=64, value_shape=(4,), num_blocks=2)
    universe = np.concatenate([keys_of(40), [0, -3, 2**31 - 1]]).astype(np.int32)
    for mode in ("add", "add_nonneg", "min", "max", "assign"):
        ops = []
        for _ in range(4):
            k = universe[rng.integers(0, len(universe), 30)]
            ops.append(("multi_update", k, normal(30, 4)))
        ops.append(("multi_get", universe))
        out[mode] = run_case(mode, ops, capacity=64, value_shape=(4,), num_blocks=2,
                             update_fn=mode)
    zeros = np.asarray([[-0.0, 1.5], [0.0, -0.0]], np.float32)
    out["put -0.0"] = run_case("put -0.0", [("multi_put", keys_of(2), zeros)],
                               capacity=64, value_shape=(2,), num_blocks=2, update_fn="assign")
    trainer = FMTrainer(**FM_HASH_APP)
    ids, _ = make_synthetic_sparse(**FM_HASH_DATA)
    steps = []
    per_step = N_EXAMPLES // BATCHES
    for b in range(2):
        k = np.concatenate([ids[b * per_step:(b + 1) * per_step].reshape(-1),
                            [SPARSE_EXTRA_BASE]]).astype(np.int32)
        steps += [("multi_get_or_init", k), ("multi_update", k, normal(len(k), 17) * 0.1)]
    cfg = trainer.model_table_config()
    out["bench-fm-hash"] = run_case(
        "bench-fm-hash", steps, capacity=cfg.capacity, value_shape=cfg.value_shape,
        num_blocks=cfg.num_blocks, update_fn=cfg.update_fn)
    print(f"phase 2c: hash ops byte-identical on the card and the CPU on {len(out)} "
          f"cases: {json.dumps(out)}", flush=True)
    return out


def run_autotune(dev):
    """Phase 2d: the push-route autotune at bench-widedeep's push (67,480 keys
    into 102,144 rows of 17 f32): each arm's device ms and the route chosen,
    first beside a tenant (a thread running 4096 x 4096 f32 products on the
    default stream, as another job of the JobServer does), then on an idle
    card. The idle card's choice is cached for the process, so the jobs that
    leave HARMONY_PUSH_VIA unset find it and make no measurement launches."""
    import threading

    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer
    from harmony_tpu_torch.table import autotune
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16, hidden=128,
                              step_size=0.1)
    table = DenseTable(TableSpec(trainer.model_table_config()), dev)
    nkeys = N_EXAMPLES // BATCHES * 16 + trainer.num_extra_rows
    stop = threading.Event()
    products = [0]

    def tenant():
        a = torch.randn(4096, 4096, device=dev)
        while not stop.is_set():
            for _ in range(4):
                a = a @ a
                a /= a.norm()
            torch.cuda.current_stream(dev).synchronize()
            products[0] += 4

    out = {"keys": nkeys}
    thread = threading.Thread(target=tenant, daemon=True)
    thread.start()
    try:
        while products[0] == 0 and thread.is_alive():
            time.sleep(0.001)
        for when in ("beside_a_tenant", "idle"):
            if when == "idle":
                stop.set()
                thread.join()
            autotune.reset()
            route = autotune.choose_push_route(table.spec, dev, nkeys, table=table)
            (meas,) = autotune.measurements().values()
            check(all(v is not None and math.isfinite(v) and v > 0 for v in meas.values()),
                  f"autotune {when}: an arm was not measured: {meas}")
            check(route == autotune.pick(meas), f"autotune {when} chose {route} over {meas}")
            out[when] = {"route": route, **meas}
            print(f"phase 2d: push-route autotune at bench-widedeep's push ({nkeys} keys), "
                  f"{when.replace('_', ' ')}: {json.dumps(out[when])}", flush=True)
    finally:
        stop.set()
        thread.join()
    check(products[0] > 0, "the tenant ran no product")
    out["tenant_products"] = products[0]
    return out


def hash_path_launches(result, steps):
    """K1 and K2 launches of a hash job: one pull (K1) and one push (K2) a
    step; each comm probe calls PULL (K1) and PULL+PUSH (K1, then K2) once to
    warm up and PROBE_SAMPLES times to time."""
    k1, fold = probe_launches(result)
    return {"gather_rows": steps + k1, "segment_sum_rows": steps + fold,
            "weighted_histogram": 0}


def run_hash_job(kind: str, epochs: int):
    """Phases 3h (bench-fm-hash) and 3i (sparse LDA): the job through the
    JobServer on the card with the launch counts read around it; then the
    JobServer's set-up of the same job on the card (CUDA's sync debug mode
    raising inside each fused window) and on the CPU, compared: the card's
    two runs bit for bit, the slot keys byte for byte, the overflow counts,
    and for LDA the counts and assignments exactly, for FM the losses within
    LOSS_ATOL."""
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.parallel.mesh import DevicePool

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    phase = {"fm": "3h", "lda": "3i"}[kind]
    config = hash_job(kind, epochs)
    steps = epochs * BATCHES
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        (card,) = server.submit(config).result(timeout=600)["workers"].values()
        seconds = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
    finally:
        server.shutdown()
    losses = card["batch_losses"]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{config.job_id}: step metrics {losses}")
    if kind == "fm":
        check(card["losses"][-1] < card["losses"][0]
              and sum(losses[BATCHES:]) < sum(losses[:BATCHES]),
              f"{config.job_id}: loss is not falling: {losses}")
    else:
        check(card["losses"][-1] > card["losses"][0],
              f"{config.job_id}: log-likelihood is not rising: {card['losses']}")
    expected = hash_path_launches(card, steps)
    check(launches == expected, f"{config.job_id} launches {launches}, expected {expected}")
    print(f"phase {phase}: {config.job_id} through the JobServer on the card: losses "
          f"{card['losses']}, overflow_count {card['overflow_count']}, launches "
          f"{launches} (K1 and K2 once a step, {steps} steps, and the comm probe's), "
          f"windows {card['windows']}, {seconds:.2f} s", flush=True)

    runs = {}
    for d in ("cuda", "cpu"):
        entity, worker = job_worker(config, d)
        seen = windows_without_syncs(worker) if d == "cuda" else None
        try:
            result = worker.run()
            model, local = worker.ctx.model_table, worker.ctx.local_table
            runs[d] = (result, [t.cpu() for t in model.state],
                       None if local is None else local.pull_array().cpu())
        finally:
            torch.cuda.set_sync_debug_mode(0)
            entity.cleanup()
        if seen is not None:
            check(seen == result["windows"], f"windows {seen}, {result['windows']}")
    (rc, (kc, vc), lc), (rp, (kp, vp), lp) = runs["cuda"], runs["cpu"]
    check(rc["batch_losses"] == losses,
          f"{config.job_id}: two card runs differ: {rc['batch_losses']} and {losses}")
    check(same_bits(kc, kp), f"{config.job_id}: slot keys differ on the card and the CPU")
    check(rc["overflow_count"] == rp["overflow_count"] == card["overflow_count"],
          f"{config.job_id}: overflow counts {rc['overflow_count']}, {rp['overflow_count']}")
    gap = max(abs(a - b) for a, b in zip(rc["batch_losses"], rp["batch_losses"]))
    out = {"steps": steps, "losses": card["losses"], "batch_losses": losses,
           "cpu_batch_losses": rp["batch_losses"], "max_abs_gap_card_vs_cpu": gap,
           "overflow_count": card["overflow_count"], "launches": launches,
           "windows": card["windows"], "comm_probe": card["comm_probe"],
           "epoch_seconds": card["epoch_seconds"], "run_seconds": seconds,
           "present_slots": int((kc < 0).sum())}
    if kind == "lda":
        check(same_bits(vc, vp), f"{config.job_id}: counts differ on the card and the CPU")
        check(torch.equal(lc, lp), f"{config.job_id}: assignments differ")
        out["counts_identical"] = out["assignments_identical"] = True
    else:
        check(gap <= LOSS_ATOL, f"{config.job_id}: card and CPU losses differ by {gap}")
        vgap = float((vc - vp).abs().max())
        vmax = float(vc.abs().max())
        check(vmax < 1.0,
              f"{config.job_id}: |values| reach {vmax}, past HASH_VALUE_ATOL's premise")
        out["max_abs_value"] = vmax
        check(vgap <= HASH_VALUE_ATOL,
              f"{config.job_id}: card and CPU table values differ by {vgap} > "
              f"{HASH_VALUE_ATOL}")
        out["max_abs_value_gap_card_vs_cpu"] = vgap
    out["samples_per_sec"] = (N_EXAMPLES if kind == "fm" else SPARSE_LDA_DATA["num_docs"]) \
        / card["epoch_seconds"][-1]
    print(f"phase {phase}: the card against the CPU after {epochs} epochs: slot keys "
          f"byte-identical ({out['present_slots']} present), overflow "
          f"{card['overflow_count']} on both, max |loss gap| {gap}"
          + (", counts and assignments identical" if kind == "lda" else "")
          + "; no sync inside any window of the card run", flush=True)
    return out


def run_host_driven_steps():
    """Phase 3j: the ModelAccessor path on the card. FusedSparseStep at
    bench-widedeep's width (102,144 rows of 17 f32, 8 batches of 65,536 keys:
    PULL K1, PUSH K3 on the table's mxu_auto route) against the accessor's
    unfused pull -> compute -> push, and accessor_async_step at bound 0
    against the synchronous pull_all -> compute -> push_all cycle, bit for
    bit; the launch counts of the fused run."""
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.dolphin.accessor import ModelAccessor
    from harmony_tpu_torch.dolphin.worker import accessor_async_step
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    cfg = TableConfig(table_id="emb", capacity=102_144, value_shape=(17,), num_blocks=256,
                      is_ordered=False)
    # 65,536 keys a batch over 102,144 rows: duplicates fold in the push
    batches = [(rng.integers(0, 102_144, 65_536).astype(np.int32),
                rng.standard_normal((65_536, 17)).astype(np.float32)) for _ in range(BATCHES)]

    def sgd(rows, targets):
        err = rows - targets
        return -0.05 * err, {"loss": torch.mean(torch.sum(err * err, -1))}

    def table():
        t = DenseTable(TableSpec(cfg), dev)
        t.write_all(np.random.default_rng(12).standard_normal((102_144, 17)).astype(np.float32))
        return t

    fused_t = table()
    fs = ModelAccessor(fused_t).fused_step(sgd)
    reset_counts(*wrappers)
    t0 = time.perf_counter()
    auxes = fs.run_batches(batches)
    fused_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    check(fs.push_route == "mxu_auto" and launches == {
        "gather_rows": BATCHES, "segment_sum_rows": 0, "weighted_histogram": BATCHES},
        f"FusedSparseStep launches {launches} on {fs.push_route}")
    unfused_t = table()
    acc = ModelAccessor(unfused_t)
    t0 = time.perf_counter()
    unfused = []
    for keys, tgt in batches:
        delta, aux = sgd(torch.as_tensor(acc.pull(keys), device=dev),
                         torch.as_tensor(tgt, device=dev))
        acc.push(keys, delta.cpu().numpy())
        unfused.append(float(aux["loss"]))
    unfused_s = time.perf_counter() - t0
    fused = [float(a["loss"]) for a in auxes]
    check(fused == unfused and all(math.isfinite(v) for v in fused) and fused[-1] < fused[0],
          f"FusedSparseStep losses {fused}, unfused {unfused}: not bit-identical, finite "
          "and falling")
    check(same_bits(fused_t.pull_array(), unfused_t.pull_array()),
          "FusedSparseStep's table differs from the unfused loop's")

    acfg = TableConfig(table_id="dense", capacity=4096, value_shape=(256,), num_blocks=64)
    targets = [torch.as_tensor(rng.standard_normal((4096, 256)).astype(np.float32),
                               device=dev) for _ in range(BATCHES)]

    def compute(model, target):
        return -0.3 * (model - target), {"gap": torch.mean(torch.abs(model - target))}

    tables = [DenseTable(TableSpec(acfg), dev) for _ in range(2)]
    drv = accessor_async_step(tables[0], compute, staleness_bound=0)
    try:
        gaps = [drv.submit(t)["gap"] for t in targets]
        drv.drain()
    finally:
        drv.shutdown()
    spec = tables[1].spec
    sync_gaps = []
    for t in targets:
        def cycle(arr, t=t):
            delta, m = compute(spec.pull_all(arr).clone(), t)
            sync_gaps.append(m["gap"])
            return spec.push_all(arr, delta), None
        tables[1].apply_step(cycle)
    check(torch.equal(torch.stack(gaps), torch.stack(sync_gaps))
          and same_bits(tables[0].pull_array(), tables[1].pull_array()),
          "accessor_async_step at bound 0 is not bit-identical to the synchronous cycle")
    out = {"fused_sparse_step": {"launches": launches, "seconds": fused_s,
                                 "unfused_seconds": unfused_s, "losses": fused},
           "accessor_async_step": {"staleness": drv.staleness_stats(),
                                   "phase_seconds": drv.mean_phase_seconds()}}
    print(f"phase 3j: FusedSparseStep bit-identical to the accessor's unfused loop "
          f"({fused_s:.3f} s against {unfused_s:.3f} s for {BATCHES} batches), launches "
          f"{launches}; accessor_async_step at bound 0 bit-identical to the synchronous "
          f"cycle", flush=True)
    return launches, out


# -- phases 2e, 3k, 3l and 3m: GBT, the Pregel engine, Lasso and AddVector -----

# bench-gbt: XGBoost's documented defaults for tree_method="hist" (max_depth 6,
# max_bin 256, eta 0.3, lambda 1) at HIGGS's shape (28 features, binary
# logistic loss). 524,288 synthetic rows (HIGGS has 11M and is not in the repo)
# in 8 mini-batches of 65,536 for 2 epochs: 16 rounds.
GBT_APP = {"num_features": 28, "num_examples": 524_288, "num_rounds": 16,
           "loss": "logistic", "num_bins": 256, "max_depth": 6, "lam": 1.0,
           "step_size": 0.3}
GBT_DATA = {"n": 524_288, "num_features": 28, "num_bins": 256, "task": "binary"}
GBT_BATCH = GBT_DATA["n"] // BATCHES
GBT_N_NODES = 2 ** (GBT_APP["max_depth"] + 1) - 1
# K3 calls a step: one a level, the histograms and the node totals together
GBT_FOLDS_PER_STEP = GBT_APP["max_depth"] + 1
# The gbt preset's leaf values, card against CPU: the folds add in index order
# on both and the prefix sums are sequential f32 on both, and the squared loss's
# gradients are one f32 subtraction, so they agree exactly; allowed: 1e-5, the
# tier-1 limit against the JAX package.
GBT_LEAF_ATOL = 1e-5
# bench-gbt's gradients p - y and hessians p (1 - p), card against CPU at the
# same margins: p = sigmoid(m) lies within a few f32 ulps of the true value on
# each device (CUDA's expf is within 2 ulps, the CPU's within 1, then two
# roundings), and an ulp of a p in [0.5, 1) is 2**-24; p - y subtracts
# exactly and p (1 - p) adds one rounding at most a quarter that size.
# Allowed: 8 ulps at 1, absolutely. Their step losses: LOSS_ATOL.
GBT_GRAD_ATOL = 8 * 2.0 ** -24
# bench-pagerank: SNAP soc-LiveJournal1's scale (4,847,571 vertices, 68,993,773
# edges) as random_graph(V, 14): uniform out-degree 14, ~67.9M edges once the
# self-loops are dropped (LiveJournal's file is not in the repo). 10 PageRank
# iterations, 11 supersteps.
PR_VERTICES = 4_847_571
PR_DEGREE = 14
PR_ITERATIONS = 10
# PageRank's ranks, card against CPU: 1e-6 relative, the tier-1 limit against
# the JAX package (the add fold gives the CPU's bits, so they may agree exactly).
PR_RTOL = 1e-6
# Rank mass after 10 iterations: 1 less the mass that dangling vertices hold
# (their rank leaves along no edge), within f32 summation error of 4.8M ranks.
RANK_MASS_ATOL = 1e-3


def preset_config(app: str, epochs: int = 3, batches: int = 4, **params):
    """The CLI's JobConfig of ``app`` (``cli.build_config``, no overrides);
    ``params`` override its TrainerParams."""
    import argparse

    from harmony_tpu_torch import cli

    ns = argparse.Namespace(set=[], data=[], job_id=None, epochs=epochs, batches=batches,
                            graph_file=None, max_supersteps=100)
    config = cli.build_config(app, ns)
    return config.replace(params=config.params.replace(**params)) if params else config


def gbt_job(epochs: int, **params):
    from harmony_tpu_torch.config.params import JobConfig, TrainerParams

    return JobConfig(
        job_id="bench-gbt", app_type="dolphin",
        trainer="harmony_tpu_torch.apps.gbt:GBTTrainer",
        params=TrainerParams(num_epochs=epochs, num_mini_batches=BATCHES,
                             app_params=GBT_APP, **params),
        num_workers=1,
        user={"data_fn": "harmony_tpu_torch.apps.gbt:make_binned_synthetic",
              "data_args": GBT_DATA})


def graph_job(app: str, num_vertices: int):
    """bench-pagerank's graph (random_graph(V, 14), seed 0) under ``app``'s
    preset: pagerank (10 iterations), shortest-path (weighted, source 0) or
    connected-components."""
    config = preset_config(app)
    args = {**config.user["graph_args"], "num_vertices": num_vertices,
            "avg_degree": PR_DEGREE}
    return config.replace(job_id=f"bench-{app}", user={**config.user, "graph_args": args})


def gbt_level_operands(dev):
    """K3's operands at bench-gbt's deepest histogram level (depth 5, 32 nodes):
    a mini-batch of 65,536 rows binned as the job bins them, each row at a node
    of that level or settled (node -1, about 1 in 33), the rows [g | h | live]
    of the logistic loss at margins drawn from N(0, 1), ids (node * 28 + f) *
    256 + bin and then the node totals: 1,900,544 ids of width 3 into 229,408
    rows."""
    from harmony_tpu_torch.apps.gbt import make_binned_synthetic

    bins, y = make_binned_synthetic(GBT_BATCH, GBT_DATA["num_features"],
                                    num_bins=GBT_DATA["num_bins"], task="binary")
    rng = np.random.default_rng(6)
    E, F = bins.shape
    B = GBT_DATA["num_bins"]
    n_level = 2 ** (GBT_APP["max_depth"] - 1)
    node = rng.integers(-1, n_level, E).astype(np.int32)
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(E).astype(np.float32)))
    live = (node >= 0).astype(np.float32)
    stats = np.stack([(p - y) * live, p * (1 - p) * live, live], axis=1).astype(np.float32)
    flat = ((node[:, None] * F + np.arange(F)) * B + bins).reshape(-1)
    nb = n_level * F * B
    ids = np.concatenate([flat, np.where(node >= 0, node + nb, -1)]).astype(np.int32)
    w = np.concatenate([np.repeat(stats, F, axis=0), stats])
    return (torch.as_tensor(ids, device=dev), torch.as_tensor(w, device=dev),
            nb + n_level)


def pagerank_graph():
    """bench-pagerank's graph on the host (the reference's draws)."""
    from harmony_tpu_torch.pregel.graph import random_graph

    return random_graph(PR_VERTICES, PR_DEGREE)


def check_slice_kernels(dev, graph):
    """Phase 2e: K3 at bench-gbt's deepest level, K2 at bench-pagerank's add
    fold (the edge messages of its first superstep, [E, 1] f32 into 4.85M
    rows) and K1 at its edge gather (PageRank's state, [V, 2] f32, 8-byte
    rows, at the edges' sources), and at shortest path's ([V, 1] f32,
    4-byte rows, the same sources) and connected components' (the ~135.7M
    sources of the symmetrised edges). Each must give the same bits as its plain
    version on the CPU and as itself run twice; K1 also as its plain version
    on the card, K2 and K3 within the f32 reordering bound of it (the card's
    atomic index_add_). Timed (fewer samples than phase 2: one fold of 68M
    ids takes milliseconds) beside the plain version and the library calls:
    ``index_select`` for K1, atomic and deterministic ``index_add_`` for the
    folds. A profiled time under the bytes bound of a call that cannot stay
    in L2 fails the run. Returns per-case timing and max |kernel - plain on
    the card|."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import (
        fold_scratch_ints,
        gather_rows,
        gather_rows_plain,
        segment_sum_rows,
        segment_sum_rows_plain,
    )

    V = graph.num_vertices
    src = torch.as_tensor(graph.src, device=dev)
    dst = torch.as_tensor(graph.dst, device=dev)
    deg = torch.as_tensor(np.maximum(graph.out_degree, 1.0), device=dev)
    state = torch.stack([torch.full((V,), 1.0 / V, device=dev), deg], dim=1)
    sent = gather_rows_plain(state, src)
    msgs = (sent[:, 0] / sent[:, 1])[:, None].contiguous()
    ids, w, rows = gbt_level_operands(dev)
    cases = {
        "weighted_histogram": (weighted_histogram, weighted_histogram_plain,
                               (ids, w, rows), ids, w, rows),
        "segment_sum_rows": (segment_sum_rows, segment_sum_rows_plain,
                             (msgs, dst, V), dst, msgs, V),
    }
    err, timing = {}, {}
    for name, (kernel, plain, args, i, x, R) in cases.items():
        got, again = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        check(same_bits(got, again), f"phase 2e {name}: two runs differ")
        check(same_bits(got.cpu(), plain(*(a.cpu() if torch.is_tensor(a) else a
                                            for a in args))),
              f"phase 2e {name}: not the same bits as the CPU's index_add_")
        gap = (got - plain(*args)).abs()
        check(bool((gap <= fold_tolerance(x.float(), i, R).float()).all()),
              f"phase 2e {name}: |kernel - plain| {float(gap.max())} over the bound")
        err[name] = float(gap.max())
        N, W = x.shape
        nbytes = N * 4 + N * W * 4 + R * W * 4
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, N * W / F32_FLOPS * 1e3
        i64, xf = i.long().clamp(0, R - 1), torch.where((i >= 0)[:, None], x.float(), 0.0)

        def index_add():
            return torch.zeros((R, W), device=dev).index_add_(0, i64, xf)

        mode = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True)
        try:
            det = dict(library_deterministic_ms=time_ms(index_add, samples=5, inner=3),
                       library_deterministic_device_ms=device_ms(index_add, calls=5))
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
        timing[name] = dict(
            ids=N, width=W, rows=R,
            scratch_bytes=4 * fold_scratch_ints(N, W, R),
            ms=time_ms(lambda: kernel(*args), samples=5, inner=3),
            device_ms=device_ms(lambda: kernel(*args), calls=10),
            plain_ms=time_ms(lambda: plain(*args), samples=5, inner=3),
            library_ms=time_ms(index_add, samples=5, inner=3),
            library_device_ms=device_ms(index_add, calls=10), **det, bytes=nbytes,
            bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
    # K1 at PageRank's gather (state [V, 2], 8-byte rows) and at shortest
    # path's and connected components' (distances and labels [V, 1], 4-byte
    # rows: another instance of the kernel), the latter on the symmetrised
    # edges' ~135.7M sources
    sym_src = torch.cat([src, dst])
    gathers = {
        "gather_rows": (state, src),
        "gather_rows [V, 1], shortest path": (
            torch.rand((V, 1), generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev) * 1e3, src),
        "gather_rows [V, 1], connected components": (
            torch.arange(V, dtype=torch.float32, device=dev)[:, None], sym_src),
    }
    for name, (table, i) in gathers.items():
        got = gather_rows(table, i)
        torch.cuda.synchronize()
        check(same_bits(got, gather_rows(table, i)), f"phase 2e {name}: two runs differ")
        check(same_bits(got, gather_rows_plain(table, i)),
              f"phase 2e {name}: not byte-identical to the plain version")
        check(same_bits(got.cpu(), gather_rows_plain(table.cpu(), i.cpu())),
              f"phase 2e {name}: not byte-identical to the CPU's")
        del got
        N, W = i.shape[0], table.shape[1]
        nbytes = N * 4 + int(torch.unique(i).numel()) * W * 4 + N * W * 4
        i64 = i.long()
        timing[name] = dict(
            ids=N, width=W, rows=V,
            ms=time_ms(lambda: gather_rows(table, i), samples=5, inner=3),
            device_ms=device_ms(lambda: gather_rows(table, i), calls=10),
            plain_ms=time_ms(lambda: gather_rows_plain(table, i), samples=5, inner=3),
            library_ms=time_ms(lambda: torch.index_select(table, 0, i64), samples=5, inner=3),
            library_device_ms=device_ms(lambda: torch.index_select(table, 0, i64), calls=10),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        del i64
    err["gather_rows"] = 0.0
    for name, t in timing.items():
        if t.get("bytes", 0) > L2_BYTES:
            check(t["device_ms"] >= t["bound_ms"],
                  f"phase 2e {name}: profiled {t['device_ms']} ms, under its bound of "
                  f"{t['bound_ms']} ms for {t['bytes']} bytes: records lost")
    print(f"phase 2e: K3 at bench-gbt's deepest level, K2 at bench-pagerank's fold, K1 "
          f"at its edge gather and at shortest path's and connected components': the CPU's "
          f"bits, the same bits run twice; "
          f"{json.dumps(timing)}", flush=True)
    return timing, err


def run_gbt():
    """Phase 3k. The gbt preset on the card and on the CPU (the JobServer's
    set-up of the job): the trees equal in structure, leaf values within
    GBT_LEAF_ATOL; with hist_mode="scatter" on the card, K2 once a level and
    the same trees bit for bit. Then bench-gbt through the JobServer on the
    card, launch counts read around it (K3 once a level, GBT_FOLDS_PER_STEP a
    step, and no other kernel); the loss falls; a second run (the entity's
    worker, the same job) bit-identical to it, each of its steps held to the
    CPU on the card's own inputs: every K3 call (every level's shape) the
    plain version's bits, the gradients within GBT_GRAD_ATOL, the tree grown
    from the card's gradients equal in structure to the CPU's, leaf values
    within GBT_LEAF_ATOL; the same job run through on the CPU, reported;
    samples/s and rounds/s."""
    from harmony_tpu_torch.apps import gbt as gbt_app
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.ops.histogram import weighted_histogram_plain
    from harmony_tpu_torch.parallel.mesh import DevicePool

    wrappers = all_wrappers()
    preset = preset_config("gbt")
    runs = {}
    for d in ("cuda", "cpu"):
        entity, worker = job_worker(preset, d)
        try:
            runs[d] = (worker.run(), worker.ctx.model_table.pull_array().cpu(), worker.trainer)
        finally:
            entity.cleanup()
    (rc, tc, trainer), (rp, tp, _) = runs["cuda"], runs["cpu"]
    n = trainer.num_nodes
    check(trainer.resolved_hist_mode(torch.zeros(1, device="cuda")) == "matmul",
          "hist_mode auto did not resolve to matmul on the card")
    check(torch.equal(tc[:, :3 * n], tp[:, :3 * n]),
          "gbt preset: the card's trees differ in structure from the CPU's")
    leaf_gap = float((tc - tp).abs().max())
    check(leaf_gap <= GBT_LEAF_ATOL, f"gbt preset: leaf values differ by {leaf_gap}")
    loss_gap = max(abs(a - b) for a, b in zip(rc["batch_losses"], rp["batch_losses"]))
    check(loss_gap <= LOSS_ATOL, f"gbt preset: losses differ by {loss_gap}")
    # hist_mode="scatter" on the card: one K2 call a level, the same
    # index-order fold, so the same trees bit for bit
    app_params = {**preset.params.app_params, "hist_mode": "scatter"}
    entity, worker = job_worker(
        preset.replace(params=preset.params.replace(app_params=app_params)), "cuda")
    try:
        reset_counts(*wrappers)
        worker.run()
        scatter_launches = {w.__name__: w.launches for w in wrappers}
        ts = worker.ctx.model_table.pull_array().cpu()
    finally:
        entity.cleanup()
    folds = (app_params["max_depth"] + 1) * len(rc["batch_losses"])
    check(scatter_launches["segment_sum_rows"] == folds
          and sum(scatter_launches.values()) == folds,
          f"gbt preset, scatter mode: launches {scatter_launches}, expected {folds} of K2")
    check(same_bits(ts, tc), "gbt preset: the scatter mode's trees differ from matmul's")
    print(f"phase 3k: gbt preset on the card and the CPU: trees equal in structure, "
          f"max |leaf value gap| {leaf_gap} (bit-identical: {same_bits(tc, tp)}), max "
          f"|loss gap| {loss_gap}; hist_mode=scatter on the card: {folds} K2 launches, "
          f"the matmul mode's trees bit for bit", flush=True)

    steps = EPOCHS * BATCHES
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        (card,) = server.submit(gbt_job(EPOCHS)).result(timeout=900)["workers"].values()
        seconds = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
    finally:
        server.shutdown()
    losses = card["batch_losses"]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"bench-gbt: step losses {losses}")
    check(card["losses"][-1] < card["losses"][0] and losses[-1] < losses[0],
          f"bench-gbt: the loss is not falling: {losses}")
    expected = {name: 0 for name in launches}
    expected["weighted_histogram"] = steps * GBT_FOLDS_PER_STEP
    check(launches == expected, f"bench-gbt launches {launches}, expected {expected}")
    # the second run, each step held to the CPU on the card's own inputs:
    # every K3 call to its plain version (bits), the gradients to the CPU's
    # at the same margins (GBT_GRAD_ATOL), the tree grown from the card's
    # gradients to the CPU's from the same (structure exact, leaf values and
    # predictions within GBT_LEAF_ATOL)
    levels, grads, grown = [], [], []
    real_hist = gbt_app.weighted_histogram

    def hist_held(ids, w, rows):
        out = real_hist(ids, w, rows)
        want = weighted_histogram_plain(ids.cpu(), w.cpu(), rows)
        levels.append((ids.shape[0], rows, same_bits(out.cpu(), want)))
        return out

    def grad_hess_held(m, y):
        out = real_grad_hess(m, y)
        want = real_grad_hess(m.cpu(), y.cpu())
        grads.append([float((a.cpu() - b).abs().max()) for a, b in zip(out, want)])
        return out

    def grow_held(bins, g, h):
        out = real_grow(bins, g, h)
        want = real_grow(bins.cpu(), g.cpu(), h.cpu())
        grown.append((all(torch.equal(a.cpu(), b) for a, b in zip(out[:3], want[:3])),
                      max(float((a.cpu() - b).abs().max()) for a, b in zip(out[3:], want[3:]))))
        return out

    gbt_app.weighted_histogram = hist_held
    entity, worker = job_worker(gbt_job(EPOCHS), "cuda")
    trainer = worker.trainer
    real_grad_hess, real_grow = trainer._grad_hess, trainer._grow_tree
    trainer._grad_hess, trainer._grow_tree = grad_hess_held, grow_held
    try:
        again = worker.run()
        trees = worker.ctx.model_table.pull_array().cpu()
    finally:
        gbt_app.weighted_histogram = real_hist
        entity.cleanup()
    check(again["batch_losses"] == losses,
          f"bench-gbt: a second run differs: {again['batch_losses']} and {losses}")
    shapes = sorted({(n, r) for n, r, _ in levels})
    check(len(levels) == steps * GBT_FOLDS_PER_STEP and all(ok for _, _, ok in levels),
          f"bench-gbt: K3 against the CPU's plain version, (ids, rows, same bits): "
          f"{sorted(set(levels))}")
    grad_gap = [max(col) for col in zip(*grads)]   # gradients, hessians, loss
    check(len(grads) == steps and max(grad_gap[:2]) <= GBT_GRAD_ATOL
          and grad_gap[2] <= LOSS_ATOL,
          f"bench-gbt: |gradient, hessian, loss gap| against the CPU's at the same "
          f"margins, each step: {grads}")
    grow_gap = max(gap for _, gap in grown)
    check(len(grown) == steps and all(same for same, _ in grown) and grow_gap <= GBT_LEAF_ATOL,
          f"bench-gbt: trees against the CPU's from the same gradients: {grown}")
    # the same job run through on the CPU, for the record: its gradients
    # round apart from the card's in a last bit from round 1 on, and an
    # exact tie between splits can then go either way
    entity, worker = job_worker(gbt_job(EPOCHS), "cpu")
    try:
        cpu = worker.run()
        cpu_trees = worker.ctx.model_table.pull_array()
    finally:
        entity.cleanup()
    apart = [r for r in range(trees.shape[0])
             if not torch.equal(trees[r, :3 * GBT_N_NODES], cpu_trees[r, :3 * GBT_N_NODES])]
    free_run = {"rounds_apart_in_structure": apart,
                "max_abs_loss_gap": max(abs(a - b) for a, b in zip(losses, cpu["batch_losses"])),
                "cpu_epoch_seconds": cpu["epoch_seconds"]}
    leaves = (trees[:, 2 * GBT_N_NODES:3 * GBT_N_NODES] > 0.5).sum(dim=1).tolist()
    epoch_s = card["epoch_seconds"][-1]
    out = {"steps": steps, "losses": card["losses"], "batch_losses": losses,
           "launches": launches, "windows": card["windows"],
           "epoch_seconds": card["epoch_seconds"], "run_seconds": seconds,
           "samples_per_sec": GBT_DATA["n"] / epoch_s, "rounds_per_sec": BATCHES / epoch_s,
           "leaves_per_tree": leaves, "preset_leaf_gap_card_vs_cpu": leaf_gap,
           "preset_bit_identical_card_vs_cpu": same_bits(tc, tp),
           "k3_calls_held_to_cpu": len(levels), "k3_shapes_ids_rows": shapes,
           "trees_held_to_cpu": len(grown), "max_leaf_or_pred_gap_held": grow_gap,
           "max_grad_hess_loss_gap_held": grad_gap,
           "cpu_free_run": free_run}
    print(f"phase 3k: bench-gbt through the JobServer: losses {card['losses']}, launches "
          f"{launches} (K3 {GBT_FOLDS_PER_STEP} a step, {steps} steps), "
          f"{out['samples_per_sec']:.1f} samples/s, {out['rounds_per_sec']:.2f} rounds/s; "
          f"a second run bit-identical, its {len(levels)} K3 calls ({len(shapes)} shapes) "
          f"the CPU's bits, its {len(grown)} trees the CPU's from the same gradients "
          f"(max |leaf or prediction gap| {grow_gap}); the CPU's own run: "
          f"{json.dumps(free_run)}", flush=True)
    return out


def graph_entity_run(config, device):
    """A Pregel job's result through the JobServer's set-up (build_entity) on
    ``device``, its tables dropped afterwards."""
    from harmony_tpu_torch.jobserver.entity import build_entity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool([torch.device(device)]))
    entity = build_entity(config)
    try:
        entity.setup(master, [e.id for e in master.add_executors(1)])
        return entity.run()
    finally:
        entity.cleanup()


def same_vertex_values(app: str, a: np.ndarray, b: np.ndarray) -> bool:
    """Exact for distances and labels, PR_RTOL for ranks."""
    if app == "pagerank":
        return bool(np.allclose(a, b, rtol=PR_RTOL, atol=0))
    return bool(np.array_equal(a, b))


def run_pregel(graph):
    """Phase 3l. The three graph presets on the card and on the CPU (the
    JobServer's set-up): the same supersteps, distances and labels exactly,
    ranks within PR_RTOL. Then bench-pagerank, shortest path and connected
    components at full width through the JobServer, the launch counts read
    around each (K1 once a superstep; K2 once a superstep for PageRank's add
    fold); the rank mass; a second run of each bit-identical (PageRank's on
    ``graph``, built for phase 2e); then each on the CPU: the same
    supersteps, distances and labels exactly, ranks within PR_RTOL."""
    from harmony_tpu_torch.apps.pagerank import PageRankComputation
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.pregel import PregelMaster

    apps = ("pagerank", "shortest-path", "connected-components")
    out = {"presets": {}, "full": {}}
    card_values = {}
    for app in apps:
        card = graph_entity_run(preset_config(app), "cuda")
        cpu = graph_entity_run(preset_config(app), "cpu")
        check(card["supersteps"] == cpu["supersteps"]
              and same_vertex_values(app, card["vertex_values"], cpu["vertex_values"]),
              f"{app} preset: card and CPU differ")
        out["presets"][app] = {
            "supersteps": card["supersteps"],
            "bit_identical": bool(np.array_equal(card["vertex_values"], cpu["vertex_values"]))}
    print(f"phase 3l: the graph presets on the card and the CPU agree: "
          f"{json.dumps(out['presets'])}", flush=True)

    wrappers = all_wrappers()
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        for app in apps:
            reset_counts(*wrappers)
            t0 = time.perf_counter()
            res = server.submit(graph_job(app, PR_VERTICES)).result(timeout=900)
            seconds = time.perf_counter() - t0
            launches = {w.__name__: w.launches for w in wrappers}
            s = res["supersteps"]
            expected = {name: 0 for name in launches}
            expected["gather_rows"] = s
            expected["segment_sum_rows"] = s if app == "pagerank" else 0
            check(launches == expected, f"bench-{app} launches {launches}, expected {expected}")
            values = res["vertex_values"][:, 0]
            check(bool(np.isfinite(values).all()), f"bench-{app}: non-finite values")
            edges = graph.num_edges * (2 if app == "connected-components" else 1)
            entry = {"supersteps": s, "launches": launches, "wall_sec": res["wall_sec"],
                     "run_seconds": seconds, "edges": edges,
                     "edges_per_sec_per_superstep": edges * s / res["wall_sec"]}
            if app == "pagerank":
                check(s == PR_ITERATIONS + 1, f"bench-pagerank: {s} supersteps")
                dangling = float(values[graph.out_degree == 0].astype(np.float64).sum())
                mass = float(values.astype(np.float64).sum())
                check(abs(mass - (1.0 - dangling)) <= RANK_MASS_ATOL,
                      f"bench-pagerank: rank mass {mass}, dangling {dangling}")
                master = PregelMaster(graph, PageRankComputation(graph, PR_ITERATIONS), "cuda")
                try:
                    again = master.run()
                finally:
                    master.close()
                check(np.array_equal(again["vertex_values"][:, 0], values),
                      "bench-pagerank: a second run differs")
                entry.update(rank_mass=mass, dangling_mass=dangling)
            else:
                if app == "shortest-path":
                    check(values[0] == 0.0 and bool((values >= 0).all()),
                          "bench-shortest-path: bad distances")
                    entry["reached"] = int((values < 1e9).sum())
                else:
                    check(bool((values <= np.arange(len(values))).all()),
                          "bench-connected-components: a label above its vertex id")
                    entry["components"] = int(np.unique(values).size)
                again = graph_entity_run(graph_job(app, PR_VERTICES), "cuda")
                check(np.array_equal(again["vertex_values"][:, 0], values),
                      f"bench-{app}: a second run differs")
            out["full"][app] = entry
            card_values[app] = res
            print(f"phase 3l: bench-{app} through the JobServer: {json.dumps(entry)}",
                  flush=True)
    finally:
        server.shutdown()

    for app in apps:
        card, cpu = card_values[app], graph_entity_run(graph_job(app, PR_VERTICES), "cpu")
        check(card["supersteps"] == cpu["supersteps"]
              and same_vertex_values(app, card["vertex_values"], cpu["vertex_values"]),
              f"bench-{app}: card and CPU differ")
        out["full"][app].update(
            max_abs_gap_card_vs_cpu=float(
                np.abs(card["vertex_values"] - cpu["vertex_values"]).max()),
            bit_identical_card_vs_cpu=bool(
                np.array_equal(card["vertex_values"], cpu["vertex_values"])),
            cpu_wall_sec=cpu["wall_sec"])
    agreement = {app: {k: v for k, v in e.items() if "cpu" in k}
                 for app, e in out["full"].items()}
    print(f"phase 3l: at full width the card agrees with the CPU: {json.dumps(agreement)}",
          flush=True)
    return out


def run_linear_apps():
    """Phase 3m: the lasso, addvector and addinteger presets on the card and on
    the CPU (the JobServer's set-up): Lasso's losses within LOSS_ATOL, the
    AddVector and AddInteger tables at expected_value exactly on both."""
    out = {}
    for app in ("lasso", "addvector", "addinteger"):
        runs = {}
        for d in ("cuda", "cpu"):
            entity, worker = job_worker(preset_config(app), d)
            try:
                runs[d] = (worker.run(), worker.ctx.model_table.pull_array().cpu(),
                           worker.trainer)
            finally:
                entity.cleanup()
        (rc, tc, trainer), (rp, tp, _) = runs["cuda"], runs["cpu"]
        gap = max(abs(a - b) for a, b in zip(rc["batch_losses"], rp["batch_losses"]))
        check(gap <= LOSS_ATOL, f"{app}: card and CPU losses differ by {gap}")
        entry = {"batch_losses": rc["batch_losses"], "max_abs_loss_gap": gap}
        if app == "lasso":
            check(rc["losses"][-1] < rc["batch_losses"][0], "lasso: the loss is not falling")
            entry["nnz"] = int((tc.abs() > 1e-6).sum())
            entry["max_abs_weight_gap"] = float((tc - tp).abs().max())
        else:
            n = preset_config(app).user["data_args"]["n"]
            want = torch.full_like(tc, trainer.expected_value(3 * n))
            check(torch.equal(tc, want) and torch.equal(tp, want),
                  f"{app}: totals {tc.unique().tolist()}, {tp.unique().tolist()}, "
                  f"expected {trainer.expected_value(3 * n)}")
            entry["total"] = float(tc.reshape(-1)[0])
        out[app] = entry
    print(f"phase 3m: lasso, addvector and addinteger on the card and the CPU: "
          f"{json.dumps(out)}", flush=True)
    return out

# -- phase 3q: TaskUnit admission, multi-worker SSP jobs and shared tables ----

# bench-widedeep with two workers on one model table (the CLI's --workers 2
# --slack 1): each worker on half the examples, 8 mini-batches of 2,048.
WD2_ARGS = SLICE_ARGS + ["--epochs", str(EPOCHS), "--workers", "2", "--slack", "1"]
WD2_WORKERS = 2
# AddVector with two workers on a table made before the job (a shared table):
# every key ends at examples x epochs, an integer below 2**24, so exact in f32.
ADDV2 = {"num_keys": 1024, "vector_dim": 16, "n": 65536}
# PageRank beside bench MLR: a random graph of 262,144 vertices and ~3.7M edges
# (a 1/18 cut of bench-pagerank's, built in well under a second).
PR2_GRAPH = {"num_vertices": 262144, "avg_degree": 14}


def serve(configs, device):
    """Submit ``configs`` together to one JobServer on ``device``; returns the
    results in order and the TaskUnit grants by job and kind."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    server = JobServer(1, device_pool=DevicePool([torch.device(device)]))
    server.start()
    try:
        futures = [server.submit(c) for c in configs]
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.shutdown(timeout=120)
    check(server.master.table_ids() == [],
          f"tables left after the jobs: {server.master.table_ids()}")
    return results, bench.grants_by_job(server.global_taskunit.grant_order())


def wd2_config(lockstep: bool):
    from harmony_tpu_torch import cli

    config = cli.build_config("widedeep", cli.build_parser().parse_args(WD2_ARGS))
    if lockstep:
        config = config.replace(user={**config.user, "force_lockstep": True})
    return config


def check_wd2_kernels(dev):
    """K1 and K3 at the 2-worker step's shape (one worker's first batch of
    2,048 examples) against their plain versions: K1 byte-identical, K3 the
    CPU's index_add_ bits and its own run twice. Returns max |kernel - plain|."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import gather_rows, gather_rows_plain

    table, idx = slice_operands(dev, batch=N_EXAMPLES // WD2_WORKERS // BATCHES)
    got = gather_rows(table, idx)
    check(same_bits(got, gather_rows_plain(table, idx)),
          "phase 3q: gather_rows at the 2-worker shape is not byte-identical")
    x = torch.randn((idx.shape[0], table.shape[1]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    fold = weighted_histogram(idx, x, table.shape[0])
    again = weighted_histogram(idx, x, table.shape[0])
    torch.cuda.synchronize()
    check(same_bits(fold, again), "phase 3q: weighted_histogram run twice differs")
    check(same_bits(fold.cpu(), weighted_histogram_plain(idx.cpu(), x.cpu(), table.shape[0])),
          "phase 3q: weighted_histogram at the 2-worker shape is not the CPU's bits")
    err = float((fold - weighted_histogram_plain(idx, x, table.shape[0])).abs().max())
    print(f"phase 3q: K1 byte-identical and K3 the CPU's bits at the 2-worker step's "
          f"{idx.shape[0]} ids", flush=True)
    return {"gather_rows": 0.0, "weighted_histogram": err}


def run_multiworker(trio_jobs, fused_trio):
    """Phase 3q: the paths of TaskUnit admission, multi-worker SSP jobs and
    shared tables on the card. bench-widedeep with two workers on one table
    under SSP slack 1 (K1 and K3 from two threads); the same job in lockstep
    twice (the same bits) and on the CPU (within LOSS_ATOL a step); AddVector
    with two workers on a shared table (exact); PageRank beside bench MLR
    under one JobServer (K1 and K2; values bit-identical to a solo run); and
    the trio of phase 3d, whose per-batch losses under the JobServer must be
    the bits of its fused windows outside it."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.apps.pagerank import PageRankComputation
    from harmony_tpu_torch.config.params import JobConfig, TableConfig, TrainerParams
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.pregel.graph import random_graph
    from harmony_tpu_torch.pregel.master import PregelMaster

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    out, launches = {}, {}
    steps = WD2_WORKERS * EPOCHS * BATCHES

    # the trio: per-batch under the JobServer, the bits of the fused windows
    for job_id, job in trio_jobs.items():
        worker = job["worker"]
        check(not worker["fused_epochs"], f"{job_id} ran fused windows under the JobServer")
        check(float_bits(worker["batch_losses"]) == float_bits(fused_trio[job_id]),
              f"{job_id}: the per-batch losses under the JobServer are not the bits "
              f"of its fused windows")
    out["trio_grants"] = {k: j["grants"] for k, j in trio_jobs.items()}
    print(f"phase 3q: the trio's per-batch losses under the JobServer are the bits of "
          f"its fused windows; grants by job {json.dumps(out['trio_grants'])}", flush=True)

    # bench-widedeep, two workers, SSP slack 1
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        (ssp,), grants = serve([wd2_config(False)], "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["bench-widedeep-2-workers"] = {w.__name__: w.launches for w in wrappers}
        lock = []
        for _ in range(2):
            (r,), _ = serve([wd2_config(True)], "cuda")
            lock.append(r)
        (lock_cpu,), _ = serve([wd2_config(True)], "cpu")
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    workers = ssp["workers"]
    chief = workers[f"{ssp['job_id']}/w0"]
    k1, fold = probe_launches(chief)
    expected = {"gather_rows": steps + k1, "segment_sum_rows": 0,
                "weighted_histogram": steps + fold}
    got = launches["bench-widedeep-2-workers"]
    check(got == expected, f"phase 3q: 2-worker Wide&Deep launches {got}, expected {expected}")
    for wid, w in workers.items():
        finite_and_falling(w["batch_losses"], EPOCHS * BATCHES, f"phase 3q {wid}")
        check(not w["fused_epochs"] and w["windows"] == [1] * EPOCHS,
              f"phase 3q {wid}: fused {w['fused_epochs']}, windows {w['windows']}")
    job_grants = grants[ssp["job_id"]]
    want = {"CPU": 1 + EPOCHS * BATCHES, "NET": EPOCHS}
    check(job_grants == want, f"phase 3q: 2-worker grants {job_grants}, expected {want}")
    lock_losses = [{w: r["batch_losses"] for w, r in run["workers"].items()}
                   for run in (*lock, lock_cpu)]
    check(lock_losses[0] == lock_losses[1],
          "phase 3q: the lockstep 2-worker Wide&Deep differs run to run")
    lock_gap = max(abs(a - b) for w in lock_losses[0]
                   for a, b in zip(lock_losses[0][w], lock_losses[2][w]))
    check(lock_gap <= LOSS_ATOL,
          f"phase 3q: lockstep card and CPU losses differ by {lock_gap} > {LOSS_ATOL}")
    out["bench-widedeep-2-workers"] = {
        "launches": got, "grants": job_grants, "wall_s": wall,
        "samples_per_sec": EPOCHS * N_EXAMPLES / wall,
        "batch_losses": {w: r["batch_losses"] for w, r in workers.items()},
        "lockstep_batch_losses": lock_losses[0],
        "lockstep_max_abs_gap_card_vs_cpu": lock_gap,
    }
    print(f"phase 3q: bench-widedeep, 2 workers, slack 1: launches {got}, grants "
          f"{job_grants}, {EPOCHS * N_EXAMPLES / wall:.1f} samples/s over the job; "
          f"losses {json.dumps(out['bench-widedeep-2-workers']['batch_losses'])}; "
          f"lockstep bit-identical twice, max |card - CPU| {lock_gap}", flush=True)

    # AddVector, two workers, a shared table made before the job
    shared = TableConfig(table_id="shared-addvector", capacity=ADDV2["num_keys"],
                         value_shape=(ADDV2["vector_dim"],), num_blocks=64)
    config = JobConfig(
        job_id="addvector-2-workers", app_type="dolphin",
        trainer="harmony_tpu_torch.apps.addvector:AddVectorTrainer", tables=[shared],
        params=TrainerParams(num_epochs=EPOCHS, num_mini_batches=BATCHES, clock_slack=1,
                             app_params={"num_keys": ADDV2["num_keys"],
                                         "vector_dim": ADDV2["vector_dim"]}),
        num_workers=2,
        user={"data_fn": "harmony_tpu_torch.apps.addvector:make_marks",
              "data_args": {"n": ADDV2["n"]}})
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        table = server.master.create_table(shared, server.master.executor_ids())
        server.submit(config).result(timeout=600)
        values = table.pull_array().cpu()
        check(server.master.table_ids() == ["shared-addvector"],
              "phase 3q: the job's cleanup freed the caller's shared table")
        server.master.drop_table("shared-addvector")
    finally:
        server.shutdown(timeout=120)
    total = float(EPOCHS * ADDV2["n"])
    check(torch.equal(values, torch.full_like(values, total)),
          f"phase 3q: AddVector values {values.unique().tolist()}, expected {total}")
    out["addvector-2-workers"] = {"shape": list(values.shape), "value": total,
                                  "unique_values": values.unique().tolist()}
    print(f"phase 3q: AddVector, 2 workers on a shared {list(values.shape)} table: every "
          f"value {values.unique().tolist()} (expected {total})", flush=True)

    # PageRank beside bench MLR under one JobServer
    pregel = JobConfig(
        job_id="pagerank-beside-mlr", app_type="pregel",
        trainer="harmony_tpu_torch.apps.pagerank:PageRankComputation",
        params=TrainerParams(app_params={"num_iterations": PR_ITERATIONS}),
        user={"graph_fn": "harmony_tpu_torch.pregel.graph:random_graph",
              "graph_args": PR2_GRAPH, "max_supersteps": 100})
    mlr = bench.job_configs(TRIO_SCALE, EPOCHS)[0][0]
    reset_counts(*wrappers)
    (pr, mlr_result), grants = serve([pregel, mlr], "cuda")
    torch.cuda.synchronize()
    launches["pagerank-beside-mlr"] = {w.__name__: w.launches for w in wrappers}
    graph = random_graph(**PR2_GRAPH)
    solo = PregelMaster(graph, PageRankComputation(graph, PR_ITERATIONS), "cuda")
    try:
        alone = solo.run()
    finally:
        solo.close()
    check(np.array_equal(pr["vertex_values"], alone["vertex_values"]),
          "phase 3q: PageRank beside MLR is not bit-identical to its solo run")
    n = pr["supersteps"]
    want = {"gather_rows": n, "segment_sum_rows": n, "weighted_histogram": 0}
    check(launches["pagerank-beside-mlr"] == want,
          f"phase 3q: PageRank beside MLR launches {launches['pagerank-beside-mlr']}, "
          f"expected {want}")
    check(grants.get("pagerank-beside-mlr") == {"CPU": n} and "bench-mlr" in grants,
          f"phase 3q: grants {grants}")
    (mlr_worker,) = mlr_result["workers"].values()
    check(all(math.isfinite(v) for v in mlr_worker["batch_losses"]),
          "phase 3q: MLR beside PageRank has a non-finite loss")
    out["pagerank-beside-mlr"] = {
        "supersteps": n, "launches": launches["pagerank-beside-mlr"], "grants": grants,
        "wall_s": pr["wall_sec"], "solo_wall_s": alone["wall_sec"],
        "values_sum": float(pr["vertex_values"].sum()),
    }
    print(f"phase 3q: PageRank ({PR2_GRAPH}) beside bench MLR: {n} supersteps, launches "
          f"{launches['pagerank-beside-mlr']}, values bit-identical to the solo run, "
          f"grants {json.dumps(grants)}", flush=True)
    return launches, out


def float_bits(values):
    """The f32 bit patterns of a list of floats (NaN payloads included)."""
    return np.asarray(values, dtype=np.float32).view(np.uint32).tolist()


def top_kernels(by_name: dict, top_n: int) -> dict:
    """The ``top_n`` largest device times by kernel name cut to 90
    characters, the names that share a cut summed (template instances of one
    kernel), largest first."""
    short = {}
    for name, ms in by_name.items():
        short[name[:90]] = short.get(name[:90], 0.0) + ms
    return dict(sorted(short.items(), key=lambda kv: -kv[1])[:top_n])


def busy_ms(intervals, lo: float, hi: float) -> float:
    """Milliseconds of [lo, hi] (seconds) that the union of ``intervals``
    covers."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy * 1e3


def profile_trio(top_n: int = 12):
    """Phase 5c: phase 3d's measured pass again, bench.run_concurrent at full
    size for 12 epochs (its schedule and nothing else), under torch.profiler.
    The device's busy time (the union of its kernels' and copies' intervals)
    over the pass, within each job's training span and where MLR trains
    alone (the other two have ended); the host-to-device copies' share of
    each; the kernels that fill it. A marker read on the host clock inside
    the profile puts the device's intervals on the jobs' clock."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from harmony_tpu_torch import bench

    marker = "chip_smoke: host clock"
    got = {}

    def run():
        with record_function(marker):   # its end stamp, then the host clock
            pass
        got["clock"] = time.perf_counter()
        got["pass"] = bench.run_concurrent([torch.device("cuda")], TRIO_SCALE,
                                           job_timeout=600.0, epochs=bench.EPOCHS)

    prof, device_events = profiled(run, cpu=True)
    clock, (rate, _, jobs) = got["clock"], got["pass"]
    htod = {}
    for e in chrome_trace(prof, "trio"):
        if e.get("ph") == "X" and e.get("name", "").startswith("Memcpy HtoD"):
            entry = htod.setdefault(e["name"], {"copies": 0, "bytes": 0})
            entry["copies"] += 1
            entry["bytes"] += int(e.get("args", {}).get("bytes", 0))
    (mark_us,) = [e.time_range.end for e in prof.events()
                  if e.name == marker and e.device_type == DeviceType.CPU]
    # run_concurrent's spans count from its own start, `origin` on perf_counter
    some = next(iter(jobs.values()))
    origin = some["worker"]["train_span"][0] - some["train_start_s"]
    shift = clock - origin
    intervals, copies, by_name = [], [], {}
    for e in device_events:
        span = ((e.time_range.start - mark_us) / 1e6 + shift,
                (e.time_range.end - mark_us) / 1e6 + shift)
        intervals.append(span)
        if e.name.startswith("Memcpy HtoD"):
            copies.append(span)
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    check(intervals, "the profiler saw no device time")

    def window(lo, hi):
        busy = busy_ms(intervals, lo, hi)
        copy = busy_ms(copies, lo, hi)
        return {"from_s": lo, "to_s": hi, "device_busy_ms": busy,
                "device_idle_share": max(0.0, 1.0 - busy / ((hi - lo) * 1e3)),
                "htod_copy_ms": copy, "htod_copy_share_of_busy": copy / busy if busy else 0.0}

    wall = max(j["end_s"] for j in jobs.values())
    steps = sum(len(j["worker"]["batch_losses"]) for j in jobs.values())
    mlr = jobs["bench-mlr"]
    others_end = max(j["train_end_s"] for k, j in jobs.items() if k != "bench-mlr")
    alone = (max(mlr["train_start_s"], others_end), mlr["train_end_s"])
    return {
        "samples_per_sec": rate,
        "htod_copies": htod,
        "htod_bytes": sum(v["bytes"] for v in htod.values()),
        "pass": window(0.0, wall),
        # device operations (kernels, copies, fills) over the pass's steps
        "steps": steps,
        "device_operations_per_step": len(device_events) / steps,
        "grants": {k: j["grants"] for k, j in jobs.items()},
        "fused_epochs": {k: j["worker"]["fused_epochs"] for k, j in jobs.items()},
        "training_spans_overlap": (max(j["train_start_s"] for j in jobs.values())
                                   < min(j["train_end_s"] for j in jobs.values())),
        "training": {k: window(j["train_start_s"], j["train_end_s"])
                     for k, j in jobs.items()},
        "mlr_trains_alone": window(*alone) if alone[1] > alone[0] else None,
        "steady_epoch_s": bench.steady_epoch_seconds(jobs),
        "top_device_ms": top_kernels(by_name, top_n),
        "ours_device_ms": {
            kernel: sum(ms for name, ms in by_name.items() if kernel in name)
            for kernel in ("gather_rows", "keyed_fold", "flash_")},
    }


def profile_worker(worker, steps: int, top_n: int):
    """Where a step's time goes, on the card: ``profile_run`` over the
    worker's epochs (the first seeds the table)."""

    def run():
        worker.run()
        worker.global_init = False

    return profile_run(run, steps, top_n)


def profile_run(run, steps: int, top_n: int):
    """Where a step's time goes, on the card: the host clock over one steady
    ``run()`` of ``steps`` steps (after a first that warms up), then a third
    under torch.profiler for the device's busy time and the kernels that fill
    it. One stream, so device intervals do not overlap."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    _, events = profiled(run, cpu=True)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / steps
    busy, ops = sum(by_name.values()), len(events)
    return {
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / step_ms),
        # the device's kernels, copies and fills a step, each one launch
        "device_ops_per_step": ops / steps,
        "top_device_ms_per_step": top_kernels(by_name, top_n),
        # the port's own kernels, every launch of each summed (the fold is two)
        "ours_device_ms_per_step": {
            kernel: sum(ms for name, ms in by_name.items() if kernel in name)
            for kernel in ("gather_rows", "keyed_fold", "flash_")},
    }


def profile_new_paths(graph):
    """Phase 5e: a bench-gbt step, a bench-pagerank superstep (on ``graph``)
    and a step of the lasso preset (its sequential sweep), each as phase 5d
    measures a step."""
    from harmony_tpu_torch.apps.pagerank import PageRankComputation
    from harmony_tpu_torch.pregel import PregelMaster

    out = {}
    for name, config, steps, per_step in (
            ("bench-gbt", gbt_job(1, comm_probe_period=0), BATCHES, GBT_BATCH),
            ("lasso", preset_config("lasso", epochs=1, comm_probe_period=0), 4, 512)):
        entity, worker = job_worker(config, "cuda")
        try:
            out[name] = profile_worker(worker, steps, top_n=10)
        finally:
            entity.cleanup()
        out[name]["samples_per_sec"] = per_step / out[name]["step_ms"] * 1e3
    master = PregelMaster(graph, PageRankComputation(graph, PR_ITERATIONS), "cuda")
    try:
        out["bench-pagerank"] = profile_run(master.run, PR_ITERATIONS + 1, top_n=10)
    finally:
        master.close()
    out["bench-pagerank"]["edges_per_sec"] = (graph.num_edges
                                              / out["bench-pagerank"]["step_ms"] * 1e3)
    return out

def _worker(trainer, arrays, batches: int):
    from harmony_tpu_torch.config.params import TrainerParams
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    table = DenseTable(TableSpec(trainer.model_table_config()), "cuda")
    ctx = TrainerContext(params=TrainerParams(num_epochs=1, num_mini_batches=batches),
                         model_table=table)
    return WorkerTasklet("profile", ctx, trainer, TrainingDataProvider(arrays, batches))


def profile_slice():
    """Phase 5: the Wide&Deep job's step."""
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                              hidden=128, step_size=0.1)
    worker = _worker(trainer, list(make_synthetic(N_EXAMPLES, 100000, 16)), BATCHES)
    return profile_worker(worker, BATCHES, top_n=6)


def profile_hash():
    """Phase 5d: a bench-fm-hash step and a sparse LDA step (the JobServer's
    set-up of each, one epoch a run, no comm probe): step ms, device busy ms,
    idle share and the device operations a step."""
    out = {}
    for kind in ("fm", "lda"):
        entity, worker = job_worker(hash_job(kind, 1, comm_probe_period=0), "cuda")
        try:
            out[kind] = profile_worker(worker, BATCHES, top_n=8)
        finally:
            entity.cleanup()
    return out


def profile_lm():
    """Phase 5b: the full-width LM's step, and its tokens/s."""
    from harmony_tpu_torch.models.transformer import TransformerTrainer, make_lm_data

    trainer = TransformerTrainer(vocab_size=8192, d_model=512, n_heads=8, n_layers=8,
                                 d_ff=2048, max_seq=1024, dtype="bfloat16", step_size=0.1)
    worker = _worker(trainer, [make_lm_data(128, 1025, 8192)], LM_STEPS // 2)
    out = profile_worker(worker, LM_STEPS // 2, top_n=12)
    out["tokens_per_sec"] = LM_TOKENS_PER_STEP / out["step_ms"] * 1e3
    return out


def profile_models(decode_once):
    """Phase 5f: a bench-vit step and a bench-lm-moe step (each on a worker
    over the job's trainer), and one decode step of bench-generate
    (``decode_once``, phase 3p's bf16 model at position 512 of its cache):
    step ms, device busy ms, idle share, device operations and top kernels."""
    from harmony_tpu_torch.models.transformer import TransformerTrainer, make_lm_data
    from harmony_tpu_torch.models.vit import ViTTrainer, make_synthetic

    vit = dict(image_size=224, patch_size=16, num_classes=1000, channels=3)
    trainer = ViTTrainer(**vit, d_model=768, n_heads=12, n_layers=12, d_ff=3072,
                         dtype="bfloat16", step_size=0.05, row_width=512)
    out = {"bench-vit": profile_worker(
        _worker(trainer, list(make_synthetic(2 * VIT_BATCH, **vit)), 2), 2, top_n=12)}
    out["bench-vit"]["samples_per_sec"] = VIT_BATCH / out["bench-vit"]["step_ms"] * 1e3
    trainer = TransformerTrainer(vocab_size=8192, d_model=512, n_heads=8, n_layers=8,
                                 d_ff=2048, max_seq=1024, dtype="bfloat16", step_size=0.1,
                                 moe_experts=8, moe_every=2, moe_capacity_factor=1.5,
                                 moe_aux_weight=0.01)
    worker = _worker(trainer, [make_lm_data(128, 1025, 8192)], LM_STEPS // 2)
    out["bench-lm-moe"] = profile_worker(worker, LM_STEPS // 2, top_n=12)
    out["bench-lm-moe"]["tokens_per_sec"] = (LM_TOKENS_PER_STEP
                                             / out["bench-lm-moe"]["step_ms"] * 1e3)
    out["bench-generate decode step"] = profile_run(decode_once, 1, top_n=10)
    out["bench-generate decode step"]["tokens_per_sec"] = (
        GEN_BATCH / out["bench-generate decode step"]["step_ms"] * 1e3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import harmony_tpu_torch
        from harmony_tpu_torch.ops import cuda_lib
    except ImportError as e:
        fail(f"harmony_tpu_torch is not importable beside this script: {e}")
    package_dir = os.path.dirname(os.path.abspath(harmony_tpu_torch.__file__))
    check(package_dir == os.path.join(REPO, "harmony_tpu_torch"),
          f"harmony_tpu_torch came from {package_dir}, not from beside this script")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    libs = cuda_lib.build()
    build_s = time.perf_counter() - t0
    ident = gpu_identity()
    print(f"phase 1: built {sorted(libs)} in {build_s:.1f} s on {ident}", flush=True)
    reports = cuda_lib.build_reports()
    for stem, report in sorted(reports.items()):
        if stem == "flash_attention_mma":
            continue
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")
    mma = mma_build_report(reports.get("flash_attention_mma", ""))
    check(mma, "no ptxas report for the tensor-core flash kernels")
    for (kernel, d, bk), entry in sorted(mma.items()):
        print(f"  ptxas {kernel} D={d}" + (f" block_k={bk}" if bk else "") + f": "
              f"{entry.get('registers')} registers, {entry.get('spill_bytes')} bytes "
              f"spilled, {entry['shared_bytes']} bytes dynamic shared memory", flush=True)
        check(d not in (64, 128) or entry.get("spill_bytes") == 0,
              f"{kernel} D={d} block_k={bk}: ptxas reports spills ({entry})")

    table, idx, err = check_kernels(dev)
    timing, skew = time_kernels(dev, table, idx)
    print(f"phase 2: timing {json.dumps(timing)}", flush=True)
    print(f"phase 2: fold (K3) timing on the skewed cases {json.dumps(skew)}", flush=True)
    del table, idx
    err.update(check_flash_kernels(dev))
    timing.update(time_flash_kernels(dev))
    print(f"phase 2b: timing {json.dumps({k: timing[k] for k in FLASH_KERNELS})}",
          flush=True)
    vit_timing = time_flash_kernels(dev, VIT_FLASH_CASE)
    print(f"phase 2b: timing at bench-vit's shape {json.dumps(vit_timing)}", flush=True)

    hash_ops = check_hash_ops(dev)
    tune = run_autotune(dev)
    launches, summary, fused, fused_sparse = run_slice()
    print("slice: " + json.dumps(summary), flush=True)
    print("unfused: " + json.dumps(run_unfused_slice(fused, fused_sparse)), flush=True)
    lm_launches, lm_summary = run_lm()
    print("lm: " + json.dumps(lm_summary), flush=True)
    print("lm preset: " + json.dumps(run_lm_preset()), flush=True)
    vit_launches, vit = run_vit()
    print("vit: " + json.dumps(vit), flush=True)
    moe_launches, moe = run_moe()
    print("moe: " + json.dumps(moe), flush=True)
    gen_launches, generation, decode_once = run_generate(lm_summary["losses"])
    print("generate: " + json.dumps(generation), flush=True)
    trio_launches, trio, trio_jobs = run_trio()
    print("trio: " + json.dumps(trio), flush=True)
    fused_trio = trio_windows_without_syncs()
    print("trio windows: " + json.dumps(fused_trio), flush=True)
    print("trio agreement: " + json.dumps(trio_agreement()), flush=True)
    print("lda assignments: " + json.dumps(lda_assignments()), flush=True)
    print("async: " + json.dumps(run_async_mlr()), flush=True)
    print("prefetch: " + json.dumps(run_prefetch()), flush=True)
    fm_hash = run_hash_job("fm", EPOCHS)
    print("fm hash: " + json.dumps(fm_hash), flush=True)
    lda_hash = run_hash_job("lda", AGREE_EPOCHS)
    print("sparse lda: " + json.dumps(lda_hash), flush=True)
    host_launches, host_steps = run_host_driven_steps()
    print("host-driven steps: " + json.dumps(host_steps), flush=True)
    graph = pagerank_graph()
    slice_timing, slice_err = check_slice_kernels(dev, graph)
    for name, e in slice_err.items():
        err[name] = max(err[name], e)
    gbt = run_gbt()
    print("gbt: " + json.dumps(gbt), flush=True)
    pregel = run_pregel(graph)
    print("pregel: " + json.dumps(pregel), flush=True)
    print("linear apps: " + json.dumps(run_linear_apps()), flush=True)
    for name, e in check_wd2_kernels(dev).items():
        err[name] = max(err[name], e)
    mw_launches, multiworker = run_multiworker(
        trio_jobs, {k: v["batch_losses"] for k, v in fused_trio.items()})
    print("multi-worker: " + json.dumps(multiworker), flush=True)
    by_path = {name: {"bench-widedeep": launches.get(name, 0),
                      "bench-lm": lm_launches[name],
                      "bench-vit": vit_launches[name],
                      "bench-lm-moe": moe_launches[name],
                      "bench-generate": gen_launches[name],
                      "bench-trio": trio_launches[name],
                      "bench-fm-hash": fm_hash["launches"].get(name, 0),
                      "sparse-lda-hash": lda_hash["launches"].get(name, 0),
                      "fused-sparse-step": host_launches.get(name, 0),
                      "bench-gbt": gbt["launches"].get(name, 0),
                      **{f"bench-{app}": entry["launches"].get(name, 0)
                         for app, entry in pregel["full"].items()},
                      **{path: counts.get(name, 0) for path, counts in mw_launches.items()}}
               for name in lm_launches}
    print("profile: " + json.dumps(profile_slice()), flush=True)
    print("lm profile: " + json.dumps(profile_lm()), flush=True)
    print("models profile: " + json.dumps(profile_models(decode_once)), flush=True)
    trio_profile = profile_trio()
    print("trio profile: " + json.dumps(trio_profile), flush=True)
    print(f"phase 3q: the trio on the per-batch TaskUnit path: {trio['samples_per_sec']:.1f} "
          f"samples/s (phase 3d), device idle share {trio_profile['pass']['device_idle_share']:.4f} "
          f"and {trio_profile['device_operations_per_step']:.1f} device operations a step "
          f"(phase 5c, {trio_profile['samples_per_sec']:.1f} samples/s), grants by job "
          f"{json.dumps(trio['grants'])}", flush=True)
    print("hash profile: " + json.dumps(profile_hash()), flush=True)
    print("new paths profile: " + json.dumps(profile_new_paths(graph)), flush=True)
    print("hash ops: " + json.dumps(hash_ops) + "; autotune: " + json.dumps(tune), flush=True)
    print("profiler: markers lost by the kept profiles (lost: profiles), retakes: "
          + json.dumps(PROFILE_LOG), flush=True)

    mma_source = "harmony_tpu_torch/csrc/flash_attention_mma.cu"
    sources = {
        "gather_rows": ("harmony_tpu_torch/csrc/gather_rows.cu",
                        "harmony_tpu/ops/sparse.py:71"),
        "segment_sum_rows": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                             "harmony_tpu/ops/sparse.py:146"),
        "weighted_histogram": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                               "harmony_tpu/ops/histogram.py:94"),
        "flash_forward": (mma_source, "harmony_tpu/ops/attention.py:191"),
        "flash_backward_dkv": (mma_source, "harmony_tpu/ops/attention.py:345"),
        "flash_backward_dq": (mma_source, "harmony_tpu/ops/attention.py:367"),
    }
    # which kernel of each flash entry the LM's bf16 path runs and this line times
    variants = dict.fromkeys(FLASH_KERNELS, "mma: bf16 mma.sync, cp.async double-buffered")
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timing[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
        if name in variants:
            entry["variant"] = variants[name]
        if name in slice_timing:
            entry["at_gbt_and_pagerank_shapes"] = slice_timing[name]
        if name in vit_timing:
            entry["at_bench_vit_shape"] = {"route": "simt", **vit_timing[name]}
        if name == "gather_rows":
            entry["at_sssp_and_cc_shapes"] = {
                k: t for k, t in slice_timing.items() if k.startswith("gather_rows [")}
        for key in ("device_ms", "library_device_ms", "library_deterministic_ms",
                    "library_deterministic_device_ms", "host_us"):
            if key in t:
                entry[key] = t[key]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
