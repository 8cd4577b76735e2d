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
3. The slice: ``python -m harmony_tpu_torch.cli run widedeep`` at the
   ``bench-widedeep`` size of ``benchmarks/apps.py`` (vocab 100,000, 16 slots,
   emb 16, hidden 128, 32,768 examples in 8 mini-batches) for 2 epochs on the
   card, with the launch counts set to 0 just before and read just after;
   then the same job on the CPU (plain versions), step for step.
4. The sparse push route (``HARMONY_PUSH_VIA=sparse``): one epoch of the same
   job, which folds its pushes with K2.
5. Where a step's time goes: a steady epoch of the job on the host clock, and
   one under ``torch.profiler`` for the device's busy time by kernel.
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

# Per-step losses of two runs of the job that differ only in where their sums
# are taken (cuBLAS against the CPU's matrix products, the card's reductions
# against the CPU's) agree to this, absolutely: f32 keeps ~7 digits, the loss
# is ~0.69, and 16 steps of SGD at lr 0.1 do not amplify a last-digit change.
LOSS_ATOL = 1e-4
# Unit roundoff of f32: a sum of n terms taken in any order lies within
# (n - 1) * U * sum(|x|) of the exact sum, so two orders lie within twice that.
U_F32 = 2.0 ** -24


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


def profile_slice():
    """Where a step's time goes, on the card: the host clock over one steady
    epoch of the slice (after a first epoch that seeds the table and warms up),
    then a second epoch under torch.profiler for the device's busy time and
    the kernels that fill it. One stream, so device intervals do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic
    from harmony_tpu_torch.config.params import TrainerParams
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                              hidden=128, step_size=0.1)
    table = DenseTable(TableSpec(trainer.model_table_config()), "cuda")
    ctx = TrainerContext(params=TrainerParams(num_epochs=1, num_mini_batches=BATCHES),
                         model_table=table)
    data = TrainingDataProvider(list(make_synthetic(N_EXAMPLES, 100000, 16)), BATCHES)
    worker = WorkerTasklet("profile", ctx, trainer, data)
    worker.run()
    worker.global_init = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worker.run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / BATCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        worker.run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / BATCHES
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / step_ms),
        "top_device_ms_per_step": {name[:90]: ms for name, ms in top},
    }


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

    launches, summary = run_slice()
    print("slice: " + json.dumps(summary), flush=True)
    print("profile: " + json.dumps(profile_slice()), flush=True)

    sources = {
        "gather_rows": ("harmony_tpu_torch/csrc/gather_rows.cu",
                        "harmony_tpu/ops/sparse.py:71"),
        "segment_sum_rows": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                             "harmony_tpu/ops/sparse.py:146"),
        "weighted_histogram": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                               "harmony_tpu/ops/histogram.py:94"),
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
