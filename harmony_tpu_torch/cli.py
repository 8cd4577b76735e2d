"""Command-line entry point: ``python -m harmony_tpu_torch.cli run <app>``.

Counterpart of ``harmony_tpu/cli.py``'s ``run`` subcommand (the standalone
launcher: an in-process JobServer on one device, one job, exit), for the
apps this port runs: the training apps ``mlr``, ``nmf``, ``lda``, ``lasso``,
``gbt``, ``addvector``, ``addinteger``, ``fm``, ``widedeep`` and ``lm``, and
the graph apps ``pagerank``, ``connected-components`` and ``shortest-path``.
Presets are the reference's, with the trainer (or computation) and the data
or graph generator resolved in this package; override them with ``--set
key=value`` (app hyper-parameters) and ``--data key=value`` (data or graph
arguments). A graph app reads an edge-list file with ``--graph-file`` and
stops after ``--max-supersteps``. The job runs on the card unless ``--device
cpu`` is given; with no card it raises. The reference's dolphin-only flags
(``--optimizer``, ``--model-chkp-period``, ``--offline-eval``,
``--auto-resume``), which it refuses on graph apps, are not ported.

Prints ``{"job_id": ..., "result": ...}`` as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

import numpy as np

from harmony_tpu_torch.config.params import JobConfig, TrainerParams

# The reference's presets (harmony_tpu/cli.py), trainer and data generator
# resolved in this package. One differs: lasso's data function drops the
# ground truth, which the reference's preset hands its provider as a third
# array of another length (its run fails there).
PRESETS: Dict[str, Dict[str, Any]] = {
    "mlr": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.mlr:MLRTrainer",
        app_params={"num_classes": 10, "num_features": 784,
                    "features_per_partition": 98, "step_size": 0.1},
        data_fn="harmony_tpu_torch.apps.mlr:make_synthetic",
        data_args={"n": 4096, "num_features": 784, "num_classes": 10},
    ),
    "nmf": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.nmf:NMFTrainer",
        app_params={"num_rows": 256, "num_cols": 256, "rank": 16,
                    "step_size": 0.05},
        data_fn="harmony_tpu_torch.apps.nmf:make_synthetic",
        data_args={"num_rows": 256, "num_cols": 256, "rank": 16},
    ),
    "lda": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.lda:LDATrainer",
        app_params={"vocab_size": 500, "num_topics": 10, "num_docs": 256,
                    "max_doc_len": 64},
        data_fn="harmony_tpu_torch.apps.lda:make_synthetic",
        data_args={"num_docs": 256, "vocab_size": 500, "doc_len": 64,
                   "num_topics": 10},
    ),
    "fm": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.widedeep:FMTrainer",
        app_params={"vocab_size": 10000, "num_slots": 8, "emb_dim": 8,
                    "step_size": 0.2},
        data_fn="harmony_tpu_torch.apps.widedeep:make_synthetic",
        data_args={"n": 8192, "vocab_size": 10000, "num_slots": 8},
    ),
    "widedeep": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.widedeep:WideDeepTrainer",
        app_params={"vocab_size": 10000, "num_slots": 8, "emb_dim": 8,
                    "hidden": 64, "step_size": 0.2},
        data_fn="harmony_tpu_torch.apps.widedeep:make_synthetic",
        data_args={"n": 8192, "vocab_size": 10000, "num_slots": 8},
    ),
    "lasso": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.lasso:LassoTrainer",
        app_params={"num_features": 256, "lam": 0.05},
        data_fn="harmony_tpu_torch.apps.lasso:make_training_data",
        data_args={"n": 2048, "num_features": 256},
    ),
    "gbt": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.gbt:GBTTrainer",
        app_params={"num_features": 16, "num_examples": 2048,
                    "num_rounds": 16, "loss": "squared", "max_depth": 4},
        data_fn="harmony_tpu_torch.apps.gbt:make_binned_synthetic",
        data_args={"n": 2048, "num_features": 16},
    ),
    "addvector": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.addvector:AddVectorTrainer",
        app_params={"num_keys": 32, "vector_dim": 8},
        data_fn="harmony_tpu_torch.apps.addvector:make_marks",
        data_args={"n": 1024},
    ),
    "addinteger": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.apps.addvector:AddIntegerTrainer",
        app_params={"num_keys": 16},
        data_fn="harmony_tpu_torch.apps.addvector:make_marks",
        data_args={"n": 1024},
    ),
    "lm": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.models.transformer:TransformerTrainer",
        app_params={"vocab_size": 128, "d_model": 64, "n_heads": 4,
                    "n_layers": 2, "d_ff": 256, "max_seq": 64,
                    "step_size": 0.2},
        data_fn="harmony_tpu_torch.models.transformer:make_lm_data",
        data_args={"num_seqs": 64, "seq_len": 65, "vocab_size": 128},
    ),
    "pagerank": dict(
        app_type="pregel",
        trainer="harmony_tpu_torch.apps.pagerank:PageRankComputation",
        app_params={"num_iterations": 10},
        graph_fn="harmony_tpu_torch.pregel.graph:random_graph",
        graph_args={"num_vertices": 1000, "avg_degree": 5},
    ),
    "connected-components": dict(
        app_type="pregel",
        trainer="harmony_tpu_torch.apps.concomp:ConnectedComponentsComputation",
        app_params={},
        graph_fn="harmony_tpu_torch.pregel.graph:random_graph",
        graph_args={"num_vertices": 1000, "avg_degree": 5},
    ),
    "shortest-path": dict(
        app_type="pregel",
        trainer="harmony_tpu_torch.apps.sssp:ShortestPathComputation",
        app_params={"source": 0},
        graph_fn="harmony_tpu_torch.pregel.graph:random_graph",
        graph_args={"num_vertices": 1000, "avg_degree": 5, "weighted": True},
    ),
}

# Parameters of models.transformer:load_text_tokens, which replaces the LM's
# synthetic corpus when --data path=... is given.
FILE_CORPUS_KEYS = frozenset({"path", "seq_len", "num_seqs", "vocab_size"})

# Model/data-coupled keys: an explicit override on either side wins over the
# preset, and a conflicting pair fails before the job starts.
COUPLED = {"lm": ("vocab_size",)}


def _parse_kv(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"bad override {p!r}: expected key=value")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)   # numbers, bools, lists, quoted strings
        except json.JSONDecodeError:
            out[k] = v               # bare string
    return out


def build_config(app: str, args: argparse.Namespace) -> JobConfig:
    preset = PRESETS[app]
    set_kv, data_kv = _parse_kv(args.set), _parse_kv(args.data)
    app_params = {**preset["app_params"], **set_kv}
    if preset["app_type"] == "pregel":
        if args.graph_file:
            graph_fn = "harmony_tpu_torch.pregel.graph:load_edge_list"
            graph_args = {"path": args.graph_file}
        else:
            graph_fn, graph_args = preset["graph_fn"], dict(preset["graph_args"])
        user = {"graph_fn": graph_fn, "graph_args": {**graph_args, **data_kv},
                "max_supersteps": args.max_supersteps}
        return _job_config(app, args, preset, app_params, user)
    data_fn = preset["data_fn"]
    data_args = {**preset["data_args"], **data_kv}
    if app == "lm" and "path" in data_args:
        # a text file replaces the synthetic corpus; the preset's seq_len,
        # num_seqs and vocab_size carry over (load_text_tokens shares the names)
        data_fn = "harmony_tpu_torch.models.transformer:load_text_tokens"
        stray = set(data_args) - FILE_CORPUS_KEYS
        if stray:
            raise SystemExit(
                f"--data keys {sorted(stray)} do not apply to file corpora "
                f"(load_text_tokens takes {sorted(FILE_CORPUS_KEYS)})")
    for key in COUPLED.get(app, ()):
        set_v, data_v = set_kv.get(key), data_kv.get(key)
        if set_v is not None and data_v is not None and set_v != data_v:
            raise SystemExit(f"conflicting {key}: --set {set_v} vs --data {data_v}")
        value = set_v if set_v is not None else data_args.get(
            key, data_v if data_v is not None else app_params[key])
        app_params[key] = data_args[key] = value
    return _job_config(app, args, preset, app_params,
                       {"data_fn": data_fn, "data_args": data_args})


def _job_config(app: str, args: argparse.Namespace, preset: Dict[str, Any],
                app_params: Dict[str, Any], user: Dict[str, Any]) -> JobConfig:
    return JobConfig(
        job_id=args.job_id or f"{app}-job",
        app_type=preset["app_type"],
        trainer=preset["trainer"],
        params=TrainerParams(
            num_epochs=args.epochs,
            num_mini_batches=args.batches,
            app_params=app_params,
        ),
        num_workers=1,
        user=user,
    )


def _jsonable(obj: Any) -> Any:
    """The result with its numpy arrays and scalars as JSON values (a graph
    job's ``vertex_values``)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.ndarray, np.generic)):
        return obj.tolist()
    return obj


def _cmd_run(args: argparse.Namespace) -> int:
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    cfg = build_config(args.app, args)
    # raises here when the card is asked for and absent
    server = JobServer(1, device_pool=DevicePool([args.device]))
    server.start()
    try:
        result = server.submit(cfg).result()
    finally:
        server.shutdown()
    print(json.dumps({"job_id": cfg.job_id, "result": _jsonable(result)}))
    return 0


def main(argv: "List[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="harmony-tpu-torch",
        description="harmony_tpu's training framework on PyTorch and CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="run one job standalone (in-process server)")
    p.add_argument("app", choices=sorted(PRESETS))
    p.add_argument("--job-id", default=None)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batches", type=int, default=4, help="mini-batches per epoch")
    p.add_argument("--set", action="append", metavar="K=V", default=[],
                   help="override an app hyper-parameter")
    p.add_argument("--data", action="append", metavar="K=V", default=[],
                   help="override a synthetic-data or graph argument")
    p.add_argument("--graph-file", default=None,
                   help="edge-list file (graph apps; replaces the synthetic graph)")
    p.add_argument("--max-supersteps", type=int, default=100,
                   help="superstep bound of a graph app")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the CPU runs only when asked for")
    args = ap.parse_args(argv)
    return _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
