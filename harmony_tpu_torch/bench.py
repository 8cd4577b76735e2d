"""The headline benchmark: MLR, NMF and LDA training concurrently under one
JobServer on one device (BASELINE config 4), scored as aggregate samples/s.

Counterpart of the repository's ``bench.py`` (``job_configs``,
``run_concurrent``, the CPU baseline), for this package:

    python -m harmony_tpu_torch.bench                     # on the card
    python -m harmony_tpu_torch.bench --device cpu --scale 0 --baseline-scale 0 --epochs 1

The three jobs (MLR 256 classes x 8,192 features, NMF rank 256 over 4,096
columns, LDA V 8,192 x K 64 at 128 tokens a document, 8 mini-batches an
epoch) are submitted together to a JobServer whose share-all scheduler runs
them at once. As in the reference, each job's worker runs under TaskUnit
admission: per-batch epochs, each batch group a COMP unit and each metric
drain a NET unit, with at most 2 steps in flight while the jobs contend
(the fused epoch windows run only outside a JobServer). A 1-epoch warm-up
pass (kernel builds, allocator, library handles, and each job's dataset:
generated once into the host data cache and uploaded once into the device
cache) comes first; the measured pass runs
``--epochs`` epochs at ``--scale`` with the same data arguments. Its wall, from
the first submission to the last job's end, counts each job's set-up (tables,
global init) but not data generation, which the caches serve, as in the
reference. The baseline is this package on the CPU at ``--baseline-scale``
(``scale`` shrinks each job's dataset, not its per-sample work: rates are
compared), best of two measured passes after a warm-up. The last line of standard output is one JSON
object: ``metric``, ``value`` (samples/s), ``unit``, ``vs_baseline``,
``cpu_rate``, ``mode`` and ``accel_job_walls_s``; per-job details (walls,
epoch seconds, start and end, TaskUnit grants by kind, whether the epochs ran
fused) go to standard error before it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Dict, List, Sequence, Tuple

import torch

from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.utils.platform import DeviceLike, resolve_device

EPOCHS = 12
BATCHES = 8
METRIC = "aggregate throughput, concurrent MLR+NMF+LDA (multi-tenant jobserver)"


def job_configs(scale: float, epochs: int = EPOCHS) -> Tuple[List[JobConfig], Dict[str, int]]:
    """The three BASELINE config-4 jobs at ``bench.py``'s sizes; ``scale``
    shrinks each dataset only. Returns the configs and each job's examples."""
    mlr_n = max(int(16384 * scale), BATCHES * 64)
    nmf_rows = max(int(4096 * scale), BATCHES * 8)
    lda_docs = max(int(2048 * scale), BATCHES * 8)

    def job(job_id, app, trainer, app_params, data_args):
        return JobConfig(
            job_id=job_id, app_type="dolphin",
            trainer=f"harmony_tpu_torch.apps.{app}:{trainer}",
            params=TrainerParams(num_epochs=epochs, num_mini_batches=BATCHES,
                                 comm_probe_period=6, app_params=app_params),
            num_workers=1,
            user={"data_fn": f"harmony_tpu_torch.apps.{app}:make_synthetic",
                  "data_args": data_args})

    configs = [
        job("bench-mlr", "mlr", "MLRTrainer",
            {"num_classes": 256, "num_features": 8192, "features_per_partition": 512,
             "step_size": 0.05},
            {"n": mlr_n, "num_features": 8192, "num_classes": 256}),
        job("bench-nmf", "nmf", "NMFTrainer",
            {"num_rows": nmf_rows, "num_cols": 4096, "rank": 256, "step_size": 0.01},
            {"num_rows": nmf_rows, "num_cols": 4096, "rank": 256}),
        job("bench-lda", "lda", "LDATrainer",
            {"vocab_size": 8192, "num_topics": 64, "num_docs": lda_docs,
             "max_doc_len": 128},
            {"num_docs": lda_docs, "vocab_size": 8192, "num_topics": 64, "doc_len": 128}),
    ]
    totals = {"bench-mlr": epochs * mlr_n, "bench-nmf": epochs * nmf_rows,
              "bench-lda": epochs * lda_docs}
    return configs, totals


def run_concurrent(devices: Sequence[DeviceLike], scale: float, job_timeout: float = 900.0,
                   epochs: int = EPOCHS) -> Tuple[float, Dict[str, float], Dict[str, Any]]:
    """Submit the three jobs together to one JobServer over ``devices``.

    Returns (aggregate samples/s = all examples / wall, each job's wall in
    seconds from the common start, and per job: its worker's result, the
    seconds from the common start at which its set-up began, its training
    began and ended, and it finished, and its TaskUnit grants by kind)."""
    configs, totals = job_configs(scale, epochs)
    server = JobServer(num_executors=len(devices), device_pool=DevicePool(devices))
    server.start()
    try:
        t0 = time.perf_counter()
        walls: Dict[str, float] = {}

        def stamp(job_id):
            return lambda _f: walls.setdefault(job_id, time.perf_counter() - t0)

        futures = []
        for c in configs:
            f = server.submit(c)
            f.add_done_callback(stamp(c.job_id))
            futures.append(f)
        results = [f.result(timeout=job_timeout) for f in futures]
        wall = time.perf_counter() - t0
    finally:
        server.shutdown(timeout=120)
    grants = grants_by_job(server.global_taskunit.grant_order())
    jobs = {}
    for r in results:
        (worker,) = r["workers"].values()
        jobs[r["job_id"]] = {
            "worker": worker,
            "setup_start_s": r["span"][0] - t0,
            "train_start_s": worker["train_span"][0] - t0,
            "train_end_s": worker["train_span"][1] - t0,
            "end_s": r["span"][1] - t0,
            "grants": grants.get(r["job_id"], {}),
        }
    rate = sum(totals.values()) / wall
    print(f"  {len(configs)} jobs, {sum(totals.values())} examples, {wall:.2f} s -> "
          f"{rate:,.0f} samples/s aggregate; per-job walls {walls}", file=sys.stderr)
    return rate, walls, jobs


def grants_by_job(grant_order) -> Dict[str, Dict[str, int]]:
    """TaskUnit grants of a JobServer's ``grant_order()``, counted by job and
    unit kind."""
    out: Dict[str, Dict[str, int]] = {}
    for job_id, _seq, kind in grant_order:
        counts = out.setdefault(job_id, {})
        counts[kind] = counts.get(kind, 0) + 1
    return out


def steady_epoch_seconds(jobs: Dict[str, Any]) -> Dict[str, float]:
    """Each job's median epoch seconds past its first epoch (all of them for a
    one-epoch run)."""
    out = {}
    for job_id, j in jobs.items():
        secs = j["worker"]["epoch_seconds"]
        out[job_id] = statistics.median(secs[1:] or secs)
    return out


def cpu_baseline_rate(scale: float, epochs: int = EPOCHS) -> float:
    """This package's CPU rate: the best of two measured passes after a
    one-epoch warm-up (the best pass is the conservative denominator: a
    transient load on the host only lowers a pass)."""
    cpu = [torch.device("cpu")]
    print("cpu warm-up pass:", file=sys.stderr)
    run_concurrent(cpu, scale, job_timeout=3600.0, epochs=1)
    rates = []
    for i in range(2):
        print(f"concurrent MLR+NMF+LDA on the cpu (scale {scale}, pass {i + 1}/2):",
              file=sys.stderr)
        rates.append(run_concurrent(cpu, scale, job_timeout=3600.0, epochs=epochs)[0])
    return max(rates)


def main(argv: "List[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m harmony_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs only when asked for")
    ap.add_argument("--scale", type=float, default=1.0, help="dataset scale of the measured pass")
    ap.add_argument("--baseline-scale", type=float, default=0.125,
                    help="dataset scale of the CPU baseline passes")
    ap.add_argument("--epochs", type=int, default=EPOCHS,
                    help="epochs of the measured and the baseline passes")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)   # raises when the card is asked for and absent
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    print(f"{kind} warm-up pass:", file=sys.stderr)
    run_concurrent([device], args.scale, epochs=1)
    print(f"concurrent MLR+NMF+LDA on {kind} (scale {args.scale}):", file=sys.stderr)
    rate, walls, jobs = run_concurrent([device], args.scale, epochs=args.epochs)
    detail = {job_id: {"wall_s": walls[job_id], "steady_epoch_s": steady,
                       "epoch_seconds": jobs[job_id]["worker"]["epoch_seconds"],
                       "fused_epochs": jobs[job_id]["worker"]["fused_epochs"],
                       **{k: v for k, v in jobs[job_id].items() if k != "worker"}}
              for job_id, steady in steady_epoch_seconds(jobs).items()}
    print("per-job: " + json.dumps(detail), file=sys.stderr)
    cpu_rate = cpu_baseline_rate(args.baseline_scale, args.epochs)
    print(json.dumps({
        "metric": METRIC,
        "value": rate,
        "unit": "samples/sec",
        "vs_baseline": rate / cpu_rate if cpu_rate > 0 else 0.0,
        "cpu_rate": cpu_rate,
        "mode": f"3 concurrent jobs, num_workers=1 each, one device ({kind}), per-batch "
                "epochs under TaskUnit admission; "
                "steady state after a 1-epoch warm-up; baseline: this package on the cpu "
                f"at scale {args.baseline_scale}",
        "accel_job_walls_s": walls,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
