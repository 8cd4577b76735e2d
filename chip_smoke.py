#!/usr/bin/env python3
"""Drive harmony_tpu_torch on one NVIDIA GPU and hold its CUDA kernels to their
plain PyTorch versions.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

1. Build: compile every ``harmony_tpu_torch/csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit.
2. Kernels: run gather_rows (K1), segment_sum_rows (K2) and
   weighted_histogram (K3) on the card at the shapes of the Wide&Deep job
   below and at edge cases, compare each with its plain version, and time the
   kernel, the plain version and one PyTorch library call (a yardstick that
   the port never calls) with CUDA events.
2b. Flash attention: K4 (forward), K5a (dK/dV) and K5b (dQ) against their
   plain versions at the LM's shape ([32, 8, 1024, 64] bf16, causal, blocks
   128) and at edge cases (f32 operands, not causal, D = 16 and 128, one
   block, a nonzero LSE cotangent); timed beside their plain versions and
   ``scaled_dot_product_attention``'s forward and backward.
3. The slice: ``python -m harmony_tpu_torch.cli run widedeep`` at the
   ``bench-widedeep`` size of ``benchmarks/apps.py`` (vocab 100,000, 16 slots,
   emb 16, hidden 128, 32,768 examples in 8 mini-batches) for 2 epochs on the
   card, with the launch counts set to 0 just before and read just after;
   then the same job on the CPU (plain versions), step for step.
3b. The LM at full width: ``cli run lm`` at the size of ``benchmarks/lm.py``
   (vocab 8192, d_model 512, 8 heads, 8 layers, d_ff 2048, max_seq 1024, bf16,
   batch 32 x 1024 tokens) for 2 epochs of 4 steps, launch counts read around
   it; then the same run with ``--set attn=blockwise``, step for step.
3c. The ``lm`` preset as shipped (f32, head dim 16, 64 tokens) on the card and
   on the CPU, step for step.
4. The sparse push route (``HARMONY_PUSH_VIA=sparse``): one epoch of the
   Wide&Deep job, which folds its pushes with K2.
5. Where a step's time goes: a steady epoch of the Wide&Deep job on the host
   clock, and one under ``torch.profiler`` for the device's busy time by kernel.
5b. The same for the full-width LM.
6. A ``kernels`` JSON line, the card's name and power limit, and the last line
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
    """Median over ``samples`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events (the table stays warm in L2, as it does between the
    job's steps)."""
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- phase 2: the kernels against their plain versions ------------------------


def slice_operands(dev):
    """The table and the flat row ids of one step of the slice: the keys the
    first mini-batch pulls and pushes, located as TableSpec.pull locates them."""
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic
    from harmony_tpu_torch.table.table import TableSpec

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                              hidden=128, step_size=0.1)
    spec = TableSpec(trainer.model_table_config())
    ids, _ = make_synthetic(N_EXAMPLES, 100000, 16)
    batch_ids = torch.as_tensor(ids[: N_EXAMPLES // BATCHES], device=dev)
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


def check_kernels(dev):
    """Each kernel against its plain version on the card at the slice's shape
    and at edge cases. Returns per-kernel max |kernel - plain| over the cases
    and whether the folds match a CPU scatter-add bit for bit."""
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
    k1_cases = [
        ("slice f32", table, idx),
        ("negative and out-of-range ids", table, wild),
        ("slice bf16", table.to(torch.bfloat16), idx),
        ("N=0", table, idx[:0]),
        ("W=1", table[:, :1].contiguous(), idx),
        ("W=128", torch.randn((4096, 128), generator=g, device=dev),
         wild % 5000 - 400),
    ]
    for name, t, i in k1_cases:
        got = gather_rows(t, i)
        torch.cuda.synchronize()
        want = gather_rows_plain(t, i)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"gather_rows {name}: {tuple(got.shape)} {got.dtype}")
        check(torch.equal(got.view(torch.int16 if t.dtype == torch.bfloat16
                                   else torch.int32),
                          want.view(torch.int16 if t.dtype == torch.bfloat16
                                    else torch.int32)),
              f"gather_rows {name}: not byte-identical to the plain version")
    print(f"phase 2: gather_rows exact on {len(k1_cases)} cases", flush=True)

    # K2 and K3: exact for integer-valued rows, within fold_tolerance otherwise
    ints = torch.randint(-8, 9, (N, W), generator=g, device=dev).float()
    floats = torch.randn((N, W), generator=g, device=dev)
    dup = torch.randint(0, 64, (N,), generator=g, device=dev, dtype=torch.int32)
    wide = torch.randn((min(N, 4096), 300), generator=g, device=dev)
    fold_cases = [
        ("slice, integer-valued", ints, idx, True),
        ("slice, float", floats, idx, False),
        ("negative and out-of-range ids", ints, wild, True),
        ("heavy duplicates (64 rows), integer-valued", ints, dup, True),
        ("heavy duplicates (64 rows), float", floats, dup, False),
        ("N=0", floats[:0], idx[:0], True),
        ("W=1", floats[:, :1].contiguous(), idx, False),
        ("W=300 (two column tiles)", wide, idx[: wide.shape[0]] % 5000, False),
    ]
    bitwise_cpu = True
    for kname, kernel, plain, args in (
        ("segment_sum_rows", segment_sum_rows, segment_sum_rows_plain,
         lambda x, i: (x, i, R)),
        ("weighted_histogram", weighted_histogram, weighted_histogram_plain,
         lambda x, i: (i, x, R)),
    ):
        for name, x, i, exact in fold_cases:
            got = kernel(*args(x, i))
            torch.cuda.synchronize()
            want = plain(*args(x, i))
            check(got.shape == (R, x.shape[1]) and got.dtype == torch.float32,
                  f"{kname} {name}: {tuple(got.shape)} {got.dtype}")
            gap = (got - want).abs()
            err[kname] = max(err[kname], float(gap.max()) if gap.numel() else 0.0)
            if exact:
                check(torch.equal(got, want), f"{kname} {name}: not exact")
            else:
                tol = fold_tolerance(x, i, R).float()
                check(bool((gap <= tol).all()),
                      f"{kname} {name}: |kernel - plain| {float(gap.max())} "
                      "over the f32 reordering bound")
            cpu = plain(*args(x.cpu(), i.cpu()))
            bitwise_cpu &= torch.equal(got.cpu(), cpu)
        print(f"phase 2: {kname} within bounds on {len(fold_cases)} cases", flush=True)
        # bf16 weights (K3 takes any float): integer values are exact in bf16
        if kname == "weighted_histogram":
            got = weighted_histogram(idx, ints.to(torch.bfloat16), R)
            check(torch.equal(got, weighted_histogram_plain(idx, ints.to(torch.bfloat16), R)),
                  "weighted_histogram bf16 weights: not exact")
    return table, idx, err, bitwise_cpu


def time_kernels(dev, table, idx):
    """ms of kernel, plain version and library call at the slice's shape, and
    the bound: the larger of bytes moved over HBM bandwidth and f32 operations
    over the f32 peak, for this input (each input read once, each output
    written once)."""
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

    rows_read = int(torch.unique(idx).numel())
    fold_bytes = N * W * 4 + N * 4 + R * W * 4
    fold_ops = N * W
    out = {}
    b, by = bound(N * 4 + rows_read * W * 4 + N * W * 4, 0)
    out["gather_rows"] = dict(
        ms=time_ms(lambda: gather_rows(table, idx)),
        plain_ms=time_ms(lambda: gather_rows_plain(table, idx)),
        library_ms=time_ms(lambda: torch.index_select(table, 0, idx64)),
        bound_ms=b, bound_by=by)
    b, by = bound(fold_bytes, fold_ops)
    library = time_ms(lambda: torch.zeros((R, W), device=dev).index_add_(0, idx64, deltas))
    out["segment_sum_rows"] = dict(
        ms=time_ms(lambda: segment_sum_rows(deltas, idx, R)),
        plain_ms=time_ms(lambda: segment_sum_rows_plain(deltas, idx, R)),
        library_ms=library, bound_ms=b, bound_by=by)
    out["weighted_histogram"] = dict(
        ms=time_ms(lambda: weighted_histogram(idx, deltas, R)),
        plain_ms=time_ms(lambda: weighted_histogram_plain(idx, deltas, R)),
        library_ms=library, bound_ms=b, bound_by=by)
    return out


# -- phase 2b: flash attention against its plain versions ----------------------

FLASH_KERNELS = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")


# (name, (B, H, S, D), dtype, causal, block, nonzero LSE cotangent)
FLASH_CASES = [
    ("the LM's shape, bf16, causal", (32, 8, 1024, 64), torch.bfloat16, True, 128, False),
    ("f32 operands", (4, 8, 1024, 64), torch.float32, True, 128, False),
    ("causal=False", (4, 8, 1024, 64), torch.bfloat16, False, 128, False),
    ("D=16, the lm preset's shape, f32", (16, 4, 64, 16), torch.float32, True, 64, False),
    ("D=128", (4, 4, 512, 128), torch.bfloat16, True, 128, False),
    ("one block (S=128)", (8, 8, 128, 64), torch.bfloat16, True, 128, False),
    ("nonzero LSE cotangent", (4, 8, 256, 64), torch.bfloat16, True, 128, True),
]


def flash_operands(dev, shape, dtype, seed, g_lse=False):
    """q, k, v, dO, the LSE cotangent (zero unless asked) and the scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
    glse = (torch.randn(shape[:-1], generator=g, device=dev) if g_lse
            else torch.zeros(shape[:-1], device=dev))
    return q, k, v, do, glse, shape[-1] ** -0.5


def check_flash_kernels(dev):
    """K4, K5a and K5b against their plain versions on every case of
    FLASH_CASES. Returns each kernel's max |kernel - plain| over the cases."""
    from harmony_tpu_torch.ops import attention as A

    err = {"flash_forward": 0.0, "flash_backward_dkv": 0.0, "flash_backward_dq": 0.0}

    def compare(kernel, name, case, got, want, dtype):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{kernel} {case}: {name} {tuple(got.shape)} {got.dtype}")
        gap = float((got.float() - want.float()).abs().max())
        rel = FLASH_BF16_REL if dtype == torch.bfloat16 and name != "lse" else FLASH_F32_REL
        tol = rel * float(want.float().abs().max())
        check(math.isfinite(gap) and gap <= tol,
              f"{kernel} {case}: {name} |kernel - plain| {gap} > {tol}")
        err[kernel] = max(err[kernel], gap)

    for i, (case, shape, dtype, causal, block, g_lse) in enumerate(FLASH_CASES):
        q, k, v, do, glse, scale = flash_operands(dev, shape, dtype, 10 + i, g_lse)
        args = (causal, block, block, scale)
        out, lse = A.flash_forward(q, k, v, *args)
        torch.cuda.synchronize()
        out_p, lse_p = A.flash_forward_plain(q, k, v, *args)
        compare("flash_forward", "out", case, out, out_p, dtype)
        compare("flash_forward", "lse", case, lse, lse_p, dtype)
        delta = (do.float() * out_p.float()).sum(dim=-1) - glse
        dk, dv = A.flash_backward_dkv(q, k, v, do, lse_p, delta, *args)
        dq = A.flash_backward_dq(q, k, v, do, lse_p, delta, *args)
        torch.cuda.synchronize()
        dk_p, dv_p = A.flash_backward_dkv_plain(q, k, v, do, lse_p, delta, *args)
        dq_p = A.flash_backward_dq_plain(q, k, v, do, lse_p, delta, *args)
        compare("flash_backward_dkv", "dk", case, dk, dk_p, dtype)
        compare("flash_backward_dkv", "dv", case, dv, dv_p, dtype)
        compare("flash_backward_dq", "dq", case, dq, dq_p, dtype)
        print(f"phase 2b: flash kernels within tolerance on {case} {list(shape)} "
              f"{str(dtype)[6:]} causal={causal} block={block}", flush=True)
    return err


def time_flash_kernels(dev):
    """ms of each flash kernel, its plain version and the SDPA yardstick at the
    LM's shape, and the bound: the larger of the bytes over HBM bandwidth and
    the matrix products' operations over the bf16 tensor-core peak, counting
    only the (row, col) pairs the causal mask keeps."""
    import torch.nn.functional as F

    from harmony_tpu_torch.ops import attention as A

    _, shape, dtype, causal, block, _ = FLASH_CASES[0]
    B, H, S, D = shape
    q, k, v, do, glse, scale = flash_operands(dev, shape, dtype, 3)
    args = (causal, block, block, scale)
    out, lse = A.flash_forward(q, k, v, *args)
    delta = (do.float() * out.float()).sum(dim=-1) - glse
    bh, e = B * H, q.element_size()
    pairs = bh * S * (S + 1) // 2
    io = bh * S * D * e      # one of q, k, v, dO, O, dQ, dK, dV
    rows = bh * S * 4        # one of lse, delta

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def sdpa_forward():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_forward_backward():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(do)

    t = dict(samples=10, inner=3)
    sdpa_fwd = time_ms(sdpa_forward, **t)
    sdpa_bwd = time_ms(sdpa_forward_backward, **t) - sdpa_fwd
    out = {}
    b, by = bound(4 * io + rows, 4 * D * pairs)
    out["flash_forward"] = dict(
        ms=time_ms(lambda: A.flash_forward(q, k, v, *args), **t),
        plain_ms=time_ms(lambda: A.flash_forward_plain(q, k, v, *args), **t),
        library_ms=sdpa_fwd, bound_ms=b, bound_by=by)
    b, by = bound(6 * io + 2 * rows, 8 * D * pairs)
    out["flash_backward_dkv"] = dict(
        ms=time_ms(lambda: A.flash_backward_dkv(q, k, v, do, lse, delta, *args), **t),
        plain_ms=time_ms(lambda: A.flash_backward_dkv_plain(q, k, v, do, lse, delta, *args),
                         **t),
        library_ms=sdpa_bwd, bound_ms=b, bound_by=by)
    b, by = bound(5 * io + 2 * rows, 6 * D * pairs)
    out["flash_backward_dq"] = dict(
        ms=time_ms(lambda: A.flash_backward_dq(q, k, v, do, lse, delta, *args), **t),
        plain_ms=time_ms(lambda: A.flash_backward_dq_plain(q, k, v, do, lse, delta, *args),
                         **t),
        library_ms=sdpa_bwd, bound_ms=b, bound_by=by)
    return out


# -- phases 3 and 4: the slice --------------------------------------------------


def run_slice():
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    steps = EPOCHS * BATCHES
    os.environ.pop("HARMONY_PUSH_VIA", None)

    reset_counts(*wrappers)
    gpu = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS)])
    launches = {w.__name__: w.launches for w in wrappers}
    losses = gpu["batch_losses"]
    check(len(losses) == steps, f"{len(losses)} step losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(gpu["losses"][1] < gpu["losses"][0]
          and sum(losses[BATCHES:]) < sum(losses[:BATCHES]),
          f"loss is not falling: {losses}")
    check(launches == {"gather_rows": steps, "segment_sum_rows": 0,
                       "weighted_histogram": steps},
          f"launches on the card {launches}, expected K1 and K3 once a step")
    print(f"phase 3: card losses {losses}, launches {launches}", flush=True)

    reset_counts(*wrappers)
    t0 = time.perf_counter()
    cpu = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS), "--device", "cpu"])
    cpu_seconds = time.perf_counter() - t0
    check(all(w.launches == 0 for w in wrappers), "a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(losses, cpu["batch_losses"]))
    check(gap <= LOSS_ATOL, f"card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    print(f"phase 3: CPU losses {cpu['batch_losses']}, max |card - CPU| {gap}",
          flush=True)

    os.environ["HARMONY_PUSH_VIA"] = "sparse"
    try:
        reset_counts(*wrappers)
        sparse = run_cli(SLICE_ARGS + ["--epochs", "1"])
        sparse_launches = {w.__name__: w.launches for w in wrappers}
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    check(sparse_launches == {"gather_rows": BATCHES, "segment_sum_rows": BATCHES,
                              "weighted_histogram": 0},
          f"launches on the sparse route {sparse_launches}")
    sgap = max(abs(a - b) for a, b in zip(sparse["batch_losses"], losses[:BATCHES]))
    check(sgap <= LOSS_ATOL, f"sparse and mxu routes differ by {sgap} > {LOSS_ATOL}")
    print(f"phase 4: sparse-route losses {sparse['batch_losses']}, "
          f"max |sparse - mxu| {sgap}, launches {sparse_launches}", flush=True)

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
    }
    launches["segment_sum_rows"] = sparse_launches["segment_sum_rows"]
    return launches, summary


def run_lm():
    """Phase 3b: the full-width LM through the CLI with flash attention, launch
    counts read around it, then the same run with blockwise attention."""
    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram,
                A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)
    reset_counts(*wrappers)
    gpu = run_cli(LM_ARGS)
    launches = {w.__name__: w.launches for w in wrappers}
    losses = gpu["batch_losses"]
    half = LM_STEPS // 2
    check(len(losses) == LM_STEPS, f"{len(losses)} step losses, expected {LM_STEPS}")
    check(all(math.isfinite(v) for v in losses), f"non-finite LM loss: {losses}")
    check(sum(losses[half:]) < sum(losses[:half]), f"LM loss is not falling: {losses}")
    per_path = LM_STEPS * LM_LAYERS
    expected = {"gather_rows": 0, "segment_sum_rows": 0, "weighted_histogram": 0,
                "flash_forward": per_path, "flash_backward_dkv": per_path,
                "flash_backward_dq": per_path}
    check(launches == expected, f"LM launches {launches}, expected {expected}")
    print(f"phase 3b: LM losses {losses}, launches {launches}", flush=True)

    reset_counts(*wrappers)
    blockwise = run_cli(LM_ARGS + ["--set", "attn=blockwise"])
    check(all(w.launches == 0 for w in wrappers), "a kernel launched on the blockwise run")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, blockwise["batch_losses"]))
    check(rel <= LM_BF16_REL,
          f"flash and blockwise LM losses differ by {rel} (relative) > {LM_BF16_REL}")
    print(f"phase 3b: blockwise losses {blockwise['batch_losses']}, "
          f"max |flash - blockwise| / |blockwise| {rel}", flush=True)
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
    reset_counts(*flash)
    cpu = run_cli(["run", "lm", "--device", "cpu"])
    check(all(w.launches == 0 for w in flash), "a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(card["batch_losses"], cpu["batch_losses"]))
    check(all(math.isfinite(v) for v in card["batch_losses"]) and gap <= LOSS_ATOL,
          f"lm preset: card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    print(f"phase 3c: lm preset card losses {card['batch_losses']}, "
          f"max |card - CPU| {gap}, launches {launches}", flush=True)
    return {"max_abs_loss_gap_card_vs_cpu": gap, "launches": launches}


def profile_worker(worker, steps: int, top_n: int):
    """Where a step's time goes, on the card: the host clock over one steady
    epoch (after a first epoch that seeds the table and warms up), then a
    second epoch under torch.profiler for the device's busy time and the
    kernels that fill it. One stream, so device intervals do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    worker.run()
    worker.global_init = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worker.run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        worker.run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / steps
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    return {
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / step_ms),
        "top_device_ms_per_step": {name[:90]: ms for name, ms in top},
    }


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


def profile_lm():
    """Phase 5b: the full-width LM's step, and its tokens/s."""
    from harmony_tpu_torch.models.transformer import TransformerTrainer, make_lm_data

    trainer = TransformerTrainer(vocab_size=8192, d_model=512, n_heads=8, n_layers=8,
                                 d_ff=2048, max_seq=1024, dtype="bfloat16", step_size=0.1)
    worker = _worker(trainer, [make_lm_data(128, 1025, 8192)], LM_STEPS // 2)
    out = profile_worker(worker, LM_STEPS // 2, top_n=12)
    out["tokens_per_sec"] = LM_TOKENS_PER_STEP / out["step_ms"] * 1e3
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
    for stem, report in sorted(cuda_lib.build_reports().items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    table, idx, err, bitwise_cpu = check_kernels(dev)
    print(f"phase 2: folds bit-identical to the CPU scatter-add: {bitwise_cpu}",
          flush=True)
    timing = time_kernels(dev, table, idx)
    print(f"phase 2: timing {json.dumps(timing)}", flush=True)
    del table, idx
    err.update(check_flash_kernels(dev))
    timing.update(time_flash_kernels(dev))
    print(f"phase 2b: timing {json.dumps({k: timing[k] for k in FLASH_KERNELS})}",
          flush=True)

    launches, summary = run_slice()
    print("slice: " + json.dumps(summary), flush=True)
    lm_launches, lm_summary = run_lm()
    print("lm: " + json.dumps(lm_summary), flush=True)
    print("lm preset: " + json.dumps(run_lm_preset()), flush=True)
    launches.update({k: lm_launches[k] for k in FLASH_KERNELS})
    print("profile: " + json.dumps(profile_slice()), flush=True)
    print("lm profile: " + json.dumps(profile_lm()), flush=True)

    flash_source = "harmony_tpu_torch/csrc/flash_attention.cu"
    sources = {
        "gather_rows": ("harmony_tpu_torch/csrc/gather_rows.cu",
                        "harmony_tpu/ops/sparse.py:71"),
        "segment_sum_rows": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                             "harmony_tpu/ops/sparse.py:146"),
        "weighted_histogram": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                               "harmony_tpu/ops/histogram.py:94"),
        "flash_forward": (flash_source, "harmony_tpu/ops/attention.py:191"),
        "flash_backward_dkv": (flash_source, "harmony_tpu/ops/attention.py:345"),
        "flash_backward_dq": (flash_source, "harmony_tpu/ops/attention.py:367"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
