"""Command-line entry point: ``python -m harmony_tpu_torch.cli <command>``.

Counterpart of ``harmony_tpu/cli.py``'s ``run``, ``start-jobserver``,
``submit``, ``status`` and ``shutdown`` subcommands. ``run`` is the
standalone launcher (an in-process JobServer, one job, exit): like
``start-jobserver`` it has ``--num-executors`` executors, 0 one per visible
card (one on the CPU), and a job's tables split block-major over all of them;
``start-jobserver`` starts a long-running JobServer with its TCP command
plane (``--port``, 0 picks a free one; it prints ``jobserver ready on port
N`` and runs until a ``shutdown``, with ``--chkp-root`` for the jobs'
checkpoint chains and the serving plane's pinned reads); ``submit`` sends
one job to it (the same presets and flags as ``run``) and prints the reply,
``status`` and ``shutdown`` send those commands. ``run`` and
``start-jobserver`` run on the card unless ``--device cpu`` is given; the
thin client commands touch no device. ``start-pod`` starts one process of a
pod (``jobserver/pod.py``): ``--coordinator HOST:PORT`` (or ``file:///path``),
``--num-processes`` and ``--process-id``, or the environment ``torchrun``
sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); every
process drives the cards it is given (``CUDA_VISIBLE_DEVICES``, ``--device``,
or under ``torchrun`` the card of its ``LOCAL_RANK``; two processes may share
``cuda:0``, and ``--device cpu`` runs on the CPU), process 0 serves the pod's control plane on ``--pod-port`` and
the commands on ``--port`` and prints the reference's ready line, and the
others follow it. ``--scheduler`` names the pod's scheduler (``share_all``,
``pod_carve``, or ``pod_carve:K`` for carves of at most K processes).
``--chkp-root`` (else ``HARMONY_POD_CHKP_ROOT``) is the chains' root, shared by
every process; process 0 prints ``pod jobserver closed: {"eval_results":
..., "broken": ..., "auto_resumed": ..., "reinstated": ..., "elastic_events":
..., "job_events": ...}`` (the deferred evaluations, why the pod was marked
broken, or null, the jobs auto-resumed, the followers reinstated, the pod's
recovery events and the event rings of the jobs they name) once it has shut
down.
``--device`` may name several devices, comma-separated (``cpu,cpu``: two
slots of the CPU in one process). ``pod-reshard`` asks a pod's leader to move
``--blocks`` blocks of a running job's table from executor ``--src`` to
``--dst`` at epoch ``--epoch`` in every process (``jobserver/pod.py``) and
prints the reply.

With ``HARMONY_HA_LOG_DIR`` set, ``start-jobserver`` runs one replica of an
HA control plane (``jobserver/ha.py``): it prints ``HA replica <id> standing
by on port N``, contends on the lease in that directory (``HARMONY_HA_LEASE_S``
seconds, 10 by default), and once it wins prints ``HA replica <id> is LEADER
on port N (epoch E, replay R ms, K entries replayed, J submission(s)
re-armed: [...])``; its server is built only then, on ``--device``.
``--ha-replica-id`` names the replica, ``--ha-advertise`` is the address the
others redirect clients to, ``--ha-recv-port`` receives the leader's log
stream (``HARMONY_HA_REPLICAS`` lists the receivers; it binds the loopback
interface) and ``--ha-bind`` is the interface the submit and standby
endpoints bind. ``start-pod --pod-leader-addrs`` lists the
control-plane endpoints a follower JOINs again after losing its leader. The
reference's ``obs``, ``dashboard`` and ``inputsvc`` are not ported (ROADMAP
A.10).

The presets cover the apps this port runs: the training apps ``mlr``,
``nmf``, ``lda``, ``lasso``, ``gbt``, ``addvector``, ``addinteger``, ``fm``,
``widedeep``, ``lm`` (an MoE LM with ``--set moe_experts=N``) and ``vit``, and
the graph apps ``pagerank``, ``connected-components`` and ``shortest-path``.
Presets are the reference's, with the trainer (or computation) and the data
or graph generator resolved in this package; override them with ``--set
key=value`` (app hyper-parameters) and ``--data key=value`` (data or graph
arguments); ``--set data_axis=D`` is no hyper-parameter but the data axis
of the job's mesh (its tables D rows of replicas deep, the batch split over
the rows). A graph app reads an edge-list file with ``--graph-file`` and
stops after ``--max-supersteps``. ``--workers`` sets the job's workers (0,
the default, is one per executor) and ``--slack`` the SSP clock slack
of a multi-worker job (0 is BSP). ``--model-chkp-period N`` chains a
snapshot of the model table every N epochs (into a temporary directory, as
the reference's ``run`` does), and ``--offline-eval`` evaluates the chain at
the server's shutdown; both apply to training apps only, and
``--offline-eval`` needs a period. ``--auto-resume`` (``user.auto_resume``)
resubmits the job from its chain when a pod follower it ran on is lost
(``jobserver/pod.py``); it needs ``--model-chkp-period`` > 0 and a training
app. ``--set elastic_shrink=true`` is no hyper-parameter but
``user.elastic_shrink``: on a pod the job then keeps its one submission
through the loss or silence of a follower (shrinking onto the survivors and
re-growing when the follower is back). ``--optimizer NAME`` (homogeneous,
heterogeneous, add_one_server, delete_one_server, empty, or a dotted path to
an Optimizer class) runs the job's elasticity loop every
``--optimizer-period`` seconds: it moves the job's model table between the
server's executors while the job trains (training apps only; a typo'd name
fails before the job starts). A job takes every executor the server has, so
an optimizer that adds one needs a pool with free slots beside them. The job
runs on the card unless ``--device cpu`` is given; with no card it raises.

``run`` prints ``{"job_id": ..., "result": ...}`` as one JSON line, with
``"offline_eval"`` (the chain's evaluations) when ``--offline-eval`` is
given; ``submit``, ``status`` and ``shutdown`` print the server's JSON reply
and exit 1 when it is not ``ok``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

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
    "vit": dict(
        app_type="dolphin",
        trainer="harmony_tpu_torch.models.vit:ViTTrainer",
        app_params={"image_size": 16, "patch_size": 4, "num_classes": 4,
                    "channels": 3, "d_model": 64, "n_heads": 4,
                    "n_layers": 2, "d_ff": 128, "row_width": 512,
                    "step_size": 0.05},
        data_fn="harmony_tpu_torch.models.vit:make_synthetic",
        data_args={"n": 128, "image_size": 16, "patch_size": 4,
                   "num_classes": 4, "channels": 3},
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
COUPLED = {"lm": ("vocab_size",),
           "vit": ("image_size", "patch_size", "num_classes", "channels")}


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
    period = getattr(args, "model_chkp_period", 0)
    offline_eval = getattr(args, "offline_eval", False)
    optimizer = getattr(args, "optimizer", None)
    auto_resume = getattr(args, "auto_resume", False)
    # dolphin-only flags fail loudly on graph apps, before any work
    if preset["app_type"] == "pregel" and (optimizer or period or offline_eval
                                           or auto_resume):
        raise SystemExit(
            "--optimizer / --model-chkp-period / --offline-eval / --auto-resume apply "
            "to dolphin (training) apps only; pregel jobs have no model table or "
            "checkpoint chain")
    if offline_eval and period <= 0:
        raise SystemExit(
            "--offline-eval needs --model-chkp-period > 0: deferred evaluation "
            "replays the checkpoint chain, and 0 chains nothing")
    if auto_resume and period <= 0:
        raise SystemExit(
            "--auto-resume needs --model-chkp-period > 0: resume restores the last "
            "chain checkpoint, and 0 chains nothing")
    if optimizer:
        from harmony_tpu_torch.config.base import resolve_symbol
        from harmony_tpu_torch.jobserver.entity import DolphinJobEntity

        ref = DolphinJobEntity._OPTIMIZERS.get(optimizer, optimizer)
        try:
            resolve_symbol(ref)
        except Exception as e:  # a typo'd name fails at submit, not mid-job
            raise SystemExit(
                f"unknown --optimizer {optimizer!r} "
                f"(registry: {sorted(DolphinJobEntity._OPTIMIZERS)}): {e}")
    set_kv, data_kv = _parse_kv(args.set), _parse_kv(args.data)
    # --set data_axis=D sizes the data axis of the job's mesh (the entity
    # reads it from the config's user dict, as the reference's does)
    data_axis = set_kv.pop("data_axis", None)
    # so is --set elastic_shrink=true (user.elastic_shrink); --auto-resume is
    # user.auto_resume
    flags = {}
    if set_kv.pop("elastic_shrink", False):
        flags["elastic_shrink"] = True
    if auto_resume:
        flags["auto_resume"] = True
    app_params = {**preset["app_params"], **set_kv}
    if preset["app_type"] == "pregel":
        if args.graph_file:
            graph_fn = "harmony_tpu_torch.pregel.graph:load_edge_list"
            graph_args = {"path": args.graph_file}
        else:
            graph_fn, graph_args = preset["graph_fn"], dict(preset["graph_args"])
        user = {"graph_fn": graph_fn, "graph_args": {**graph_args, **data_kv},
                "max_supersteps": args.max_supersteps, **flags}
        return _job_config(app, args, preset, app_params, user, data_axis)
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
                       {"data_fn": data_fn, "data_args": data_args, **flags}, data_axis)


def _job_config(app: str, args: argparse.Namespace, preset: Dict[str, Any],
                app_params: Dict[str, Any], user: Dict[str, Any],
                data_axis: Any = None) -> JobConfig:
    if data_axis is not None:
        user = dict(user, data_axis=int(data_axis))
    return JobConfig(
        job_id=args.job_id or f"{app}-job",
        app_type=preset["app_type"],
        trainer=preset["trainer"],
        optimizer=getattr(args, "optimizer", None),
        optimizer_period=getattr(args, "optimizer_period", 5.0),
        params=TrainerParams(
            num_epochs=args.epochs,
            num_mini_batches=args.batches,
            clock_slack=getattr(args, "slack", 0),
            model_chkp_period=getattr(args, "model_chkp_period", 0),
            offline_model_eval=getattr(args, "offline_eval", False),
            app_params=app_params,
        ),
        # callers that build the namespace themselves may leave both out
        num_workers=getattr(args, "workers", 0),
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
    cfg = build_config(args.app, args)
    # raises here when the card is asked for and absent
    server = _make_server(args)
    try:
        result = server.submit(cfg).result()
    finally:
        server.shutdown()  # runs the deferred offline evaluation
    out = {"job_id": cfg.job_id, "result": _jsonable(result)}
    if cfg.params.offline_model_eval:
        out["offline_eval"] = server.eval_results.get(cfg.job_id)
    print(json.dumps(out))
    return 0


def _build_server(args: argparse.Namespace):
    """An unstarted JobServer on ``--device``: ``--num-executors`` executors,
    0 one per slot of the pool (a slot a visible card; one on the CPU)."""
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    if args.device == "cpu":
        pool = DevicePool(["cpu"])
    else:
        pool = DevicePool() if args.device == "cuda" else DevicePool([args.device])
    n = args.num_executors or len(pool)
    return JobServer(n, device_pool=pool, chkp_root=getattr(args, "chkp_root", None))


def _make_server(args: argparse.Namespace):
    """:func:`_build_server`, started."""
    server = _build_server(args)
    server.start()
    return server


def _cmd_start_jobserver(args: argparse.Namespace) -> int:
    from harmony_tpu_torch.jobserver import ha

    if ha.ha_enabled():
        return _cmd_start_jobserver_ha(args)
    server = _make_server(args)
    port = server.serve_tcp(args.port)
    print(f"jobserver ready on port {port}", flush=True)
    try:
        while server.state != "CLOSED":
            time.sleep(0.5)
    except KeyboardInterrupt:
        server.shutdown()
    return 0


def _cmd_start_jobserver_ha(args: argparse.Namespace) -> int:
    """One replica of an HA control plane (``HARMONY_HA_LOG_DIR`` set):
    stand by on the submit port (NOT_LEADER with the leader's address),
    contend on the shared lease, and on winning it replay the durable job
    log, re-arm every in-flight submission and serve. The server is built
    at the takeover, so a standby holds no executor and no CUDA context."""
    import os
    import socket

    from harmony_tpu_torch.jobserver.ha import HAController
    from harmony_tpu_torch.jobserver.lease import ha_log_dir
    # the server's modules load while standing by (no device is touched), so
    # a takeover builds the server without importing them
    from harmony_tpu_torch.jobserver import server  # noqa: F401

    replica = args.ha_replica_id or os.environ.get("HOSTNAME") or socket.gethostname()
    ctl = HAController(
        lambda: _build_server(args), log_dir=ha_log_dir(), replica_id=replica,
        submit_port=args.port,
        # --port 0: the standby endpoint's bound port is advertised
        advertise_addr=args.ha_advertise or (f"127.0.0.1:{args.port}" if args.port else None),
        recv_port=args.ha_recv_port, bind_host=args.ha_bind,
    ).start()
    print(f"HA replica {replica} standing by on port {ctl.port} (log dir {ha_log_dir()})",
          flush=True)
    try:
        while not ctl.wait_leader(timeout=0.5):
            pass
        print(f"HA replica {replica} is LEADER on port {ctl.port} (epoch {ctl.lease.epoch}, "
              f"replay {ctl.replay_ms} ms, {ctl.replayed_entries} entries replayed, "
              f"{len(ctl.rearmed)} submission(s) re-armed: {json.dumps(ctl.rearmed)})",
              flush=True)
        while ctl.server is not None and ctl.server.state != "CLOSED":
            time.sleep(0.5)
    except KeyboardInterrupt:
        ctl.stop()
    return 0


def _pod_scheduler(name: str):
    """A make_scheduler name, or ``pod_carve:K``: carves of at most K whole
    processes (the reference's test harness's spelling)."""
    from harmony_tpu_torch.jobserver.scheduler import ProcessCarveScheduler, make_scheduler

    if name.startswith("pod_carve:"):
        return ProcessCarveScheduler(max_procs=int(name.split(":", 1)[1]))
    return make_scheduler(name)


def _pod_devices(device: str) -> Optional[List[str]]:
    """The devices a pod process drives: ``--device`` when it names the CPU
    or cards (a comma-separated list is a slot each: ``cpu,cpu`` is two slots
    of the CPU), under torchrun the card of its ``LOCAL_RANK``, else every
    visible card (None)."""
    import os

    if device != "cuda":
        return device.split(",")
    if os.environ.get("LOCAL_RANK") is not None:
        return [f"cuda:{int(os.environ['LOCAL_RANK'])}"]
    return None


def _cmd_start_pod(args: argparse.Namespace) -> int:
    """One pod process: join the torch.distributed world, then process 0
    becomes the pod JobServer (commands and the follower control plane) and
    every other process enters the follower loop."""
    import os

    from harmony_tpu_torch.parallel import multihost
    from harmony_tpu_torch.parallel.mesh import DevicePool

    coordinator = args.coordinator
    if coordinator is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    nprocs = args.num_processes or int(os.environ.get("WORLD_SIZE", 0))
    pid = args.process_id if args.process_id >= 0 else int(os.environ.get("RANK", -1))
    if not coordinator or nprocs < 2 or pid < 0:
        print("start-pod needs --coordinator/--num-processes/--process-id (or "
              "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK); for one process "
              "use start-jobserver", file=sys.stderr)
        return 2
    multihost.initialize_distributed(coordinator, nprocs, pid, devices=_pod_devices(args.device))
    try:
        pool = DevicePool(multihost.global_slots())
        n_exec = args.num_executors or len(pool)
        if pid == 0:
            from harmony_tpu_torch.jobserver.pod import PodJobServer

            server = PodJobServer(n_exec, scheduler=_pod_scheduler(args.scheduler),
                                  device_pool=pool, num_followers=nprocs - 1,
                                  chkp_root=_chkp_root_of(args))
            server.start()
            server.serve_pod(args.pod_port)
            port = server.serve_tcp(args.port)
            print(f"pod jobserver ready: {nprocs} processes, {len(pool)} global devices, "
                  f"submit port {port}", flush=True)
            try:
                while server.state != "CLOSED":
                    time.sleep(0.2)
            except KeyboardInterrupt:
                server.shutdown()
            from harmony_tpu_torch.jobserver import joblog
            from harmony_tpu_torch.jobserver.server import _json_sanitize

            named = {ev.get("job_id") for ev in server.elastic_events}
            print("pod jobserver closed: " + json.dumps(_json_sanitize(
                {"eval_results": server.eval_results, "broken": server.pod_broken,
                 "auto_resumed": server.auto_resumed, "reinstated": server.reinstated,
                 "elastic_events": server.elastic_events,
                 "job_events": {j: evs for j, evs in joblog.job_events().items()
                                if j in named}})), flush=True)
            return 0
        from harmony_tpu_torch.jobserver.pod import PodFollower

        leader = ("127.0.0.1" if coordinator.startswith("file://")
                  else coordinator.removeprefix("tcp://").rpartition(":")[0])
        print(f"pod follower {pid} joining {leader}:{args.pod_port}", flush=True)
        leader_addrs = None
        if args.pod_leader_addrs:
            leader_addrs = []
            for a in args.pod_leader_addrs.split(","):
                if a.strip():
                    host, _, port = a.strip().rpartition(":")
                    leader_addrs.append((host or "127.0.0.1", int(port)))
        PodFollower(leader, args.pod_port, pid, n_exec, pool=pool,
                    leader_addrs=leader_addrs).run()
        return 0
    finally:
        multihost.shutdown_distributed()


def _chkp_root_of(args: argparse.Namespace) -> Optional[str]:
    """``--chkp-root``, else ``HARMONY_POD_CHKP_ROOT``: the root of the
    jobs' chains, shared by every process of a pod. Without one a chain,
    a resume or a deferred evaluation over several processes is refused, job
    by job."""
    import os

    return getattr(args, "chkp_root", None) or os.environ.get("HARMONY_POD_CHKP_ROOT")


def _sender(port):
    """An explicit --port wins; otherwise the HARMONY_JOBSERVER_ADDRS replica
    list, then the default port 43110."""
    from harmony_tpu_torch.jobserver.client import CommandSender

    if port is not None:
        return CommandSender(int(port))
    return CommandSender.from_env()


def _cli_command(fn) -> Dict[str, Any]:
    """One client command; a NOT_LEADER refusal comes back as the documented
    one-line JSON reply, never a traceback."""
    from harmony_tpu_torch.jobserver.client import NotLeaderError

    try:
        return fn()
    except NotLeaderError as e:
        return {"ok": False, "not_leader": True, "error": str(e), "leader": e.leader}


def _cmd_client(args: argparse.Namespace) -> int:
    """``submit``, ``pod-reshard``, ``status`` and ``shutdown``: one command
    to a running jobserver; prints its reply."""
    sender = _sender(args.port)
    if args.cmd == "submit":
        cfg = build_config(args.app, args)
        resp = _cli_command(lambda: sender.send_job_submit_command(cfg))
    elif args.cmd == "pod-reshard":
        resp = _cli_command(lambda: sender.send_pod_reshard_command(
            args.job, args.src, args.dst, args.blocks, args.epoch))
    elif args.cmd == "status":
        resp = _cli_command(sender.send_status_command)
    else:
        resp = _cli_command(sender.send_shutdown_command)
    print(json.dumps(resp))
    return 0 if resp.get("ok") else 1


def _common_job_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("app", choices=sorted(PRESETS))
    p.add_argument("--job-id", default=None)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batches", type=int, default=4, help="mini-batches per epoch")
    p.add_argument("--workers", type=int, default=0,
                   help="0 = one worker per executor")
    p.add_argument("--slack", type=int, default=0,
                   help="SSP clock slack (0 = BSP)")
    p.add_argument("--set", action="append", metavar="K=V", default=[],
                   help="override an app hyper-parameter")
    p.add_argument("--data", action="append", metavar="K=V", default=[],
                   help="override a synthetic-data or graph argument")
    p.add_argument("--graph-file", default=None,
                   help="edge-list file (graph apps; replaces the synthetic graph)")
    p.add_argument("--max-supersteps", type=int, default=100,
                   help="superstep bound of a graph app")
    p.add_argument("--optimizer", default=None,
                   help="the job's elasticity loop: homogeneous | heterogeneous"
                        " | add_one_server | delete_one_server | empty | dotted path")
    p.add_argument("--optimizer-period", type=float, default=5.0,
                   help="seconds between optimization rounds")
    p.add_argument("--model-chkp-period", type=int, default=0,
                   help="snapshot the model table every N epochs (0 = off)")
    p.add_argument("--offline-eval", action="store_true",
                   help="evaluate the checkpoint chain at the server's shutdown")
    p.add_argument("--auto-resume", action="store_true",
                   help="pod: when a follower the job ran on is lost, resubmit it from "
                        "its last chain checkpoint onto the survivors (needs "
                        "--model-chkp-period > 0)")


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the CPU runs only when asked for")


def _num_executors_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num-executors", type=int, default=0,
                   help="0 = one per visible card (one on the CPU)")


def _port_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--port", type=int, default=None,
                   help="jobserver TCP port (default: the HARMONY_JOBSERVER_ADDRS "
                        "replica list, then 43110)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="harmony-tpu-torch",
        description="harmony_tpu's training framework on PyTorch and CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="run one job standalone (in-process server)")
    _common_job_flags(p)
    _device_flag(p)
    _num_executors_flag(p)
    p = sub.add_parser("start-jobserver", help="long-running multi-tenant job server")
    _num_executors_flag(p)
    p.add_argument("--port", type=int, default=43110, help="TCP port (0 = a free one)")
    p.add_argument("--chkp-root", default=None,
                   help="root of the jobs' checkpoint chains (and of pinned reads)")
    p.add_argument("--ha-replica-id", default=None,
                   help="HA (with HARMONY_HA_LOG_DIR set): this replica's stable "
                        "identity (default: the host name)")
    p.add_argument("--ha-advertise", default=None,
                   help="HA: the host:port other replicas redirect clients to for this "
                        "replica (default 127.0.0.1:--port)")
    p.add_argument("--ha-recv-port", type=int, default=None,
                   help="HA: bind the standby's log receiver here (peer replication, "
                        "HARMONY_HA_REPLICAS); omit when replicas share HARMONY_HA_LOG_DIR")
    p.add_argument("--ha-bind", default="127.0.0.1",
                   help="HA: the interface the submit and standby endpoints bind")
    _device_flag(p)
    p = sub.add_parser("start-pod", help="one process of a multi-process pod")
    _num_executors_flag(p)
    p.add_argument("--port", type=int, default=43110, help="TCP port of process 0's commands")
    p.add_argument("--pod-port", type=int, default=43111,
                   help="TCP port of process 0's follower control plane")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of the torch.distributed store (or file:///path); "
                        "default MASTER_ADDR:MASTER_PORT")
    p.add_argument("--num-processes", type=int, default=0, help="default WORLD_SIZE")
    p.add_argument("--process-id", type=int, default=-1, help="default RANK")
    p.add_argument("--scheduler", default="share_all",
                   help="share_all | fifo | carve | pod_carve | pod_carve:K")
    p.add_argument("--chkp-root", default=None,
                   help="root of the jobs' checkpoint chains, shared by every process "
                        "(default HARMONY_POD_CHKP_ROOT)")
    p.add_argument("--pod-leader-addrs", default=None,
                   help="HA: comma-separated host:port control-plane endpoints a follower "
                        "may JOIN again after losing its leader (default: the leader it "
                        "first joined)")
    _device_flag(p)
    p = sub.add_parser("submit", help="submit a job to a running jobserver")
    _common_job_flags(p)
    _port_flag(p)
    p = sub.add_parser("pod-reshard",
                       help="move table blocks of a RUNNING pod job (applied at the "
                            "given epoch in every process)")
    _port_flag(p)
    p.add_argument("--job", required=True)
    p.add_argument("--src", required=True, help="source executor id")
    p.add_argument("--dst", required=True, help="destination executor id")
    p.add_argument("--blocks", type=int, required=True)
    p.add_argument("--epoch", type=int, required=True,
                   help="apply epoch; needs a full window horizon of lead")
    p = sub.add_parser("status", help="query a running jobserver")
    _port_flag(p)
    p = sub.add_parser("shutdown", help="graceful jobserver shutdown")
    _port_flag(p)
    return ap


def main(argv: "List[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "start-jobserver":
        return _cmd_start_jobserver(args)
    if args.cmd == "start-pod":
        return _cmd_start_pod(args)
    return _cmd_client(args)


if __name__ == "__main__":
    sys.exit(main())
