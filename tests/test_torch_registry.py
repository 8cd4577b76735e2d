"""The port's metric registry (``harmony_tpu_torch/metrics/registry.py``)
against the reference's (``harmony_tpu/metrics/registry.py``) on the CPU.

Both registries are fresh ``MetricRegistry`` objects driven by the same
operations (the same seeded numpy values); their ``expose()`` texts must be
byte-identical: the same families, labels, escapes, cumulative buckets and
number spellings, and the same ``pid`` label, since both run in this
process. The parser, the linter and the cross-scrape monotonicity check must
give the same answers (the same errors) on the same texts. Then the names the
port declares: a worker run, a checkpoint written and restored, an
in-process block move and a demoted prefetch pipeline fill a fresh process
registry, whose exposition must pass ``lint_exposition`` in both packages.
No assertion reads a clock.
"""
import math

import numpy as np
import pytest
import torch

from harmony_tpu.metrics import registry as jreg
from harmony_tpu_torch.metrics import registry as treg


@pytest.fixture()
def fresh():
    """A fresh process registry in both packages, and no ledger or budget (a
    new one installs its gauges in the registry of its day), restored after."""
    from harmony_tpu_torch.metrics import accounting, phases

    def reset():
        accounting.reset_ledger()
        phases.reset_budget()
        return (treg.set_registry(treg.MetricRegistry()),
                jreg.set_registry(jreg.MetricRegistry()))

    yield reset()
    reset()


def _drive(mod, reg, seed):
    """One sequence of registry operations, its values drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    c = reg.counter("harmony_ops_total", "Operations by job", ("job", "op"))
    for job in ("a", 'q"uote', "back\\slash", "new\nline"):
        for op in ("pull", "push"):
            c.labels(job=job, op=op).inc(float(rng.integers(0, 1000)))
    c.labels(job="a", op="pull").inc(float(rng.random()))
    g = reg.gauge("harmony_depth", "Queue depth\nsecond line")
    g.set(float(rng.normal()))
    g.inc(3)
    g.dec(float(rng.random()))
    lat = reg.histogram("harmony_lat_seconds", "Latency", ("worker",))
    for v in rng.exponential(0.05, 64):
        lat.labels(worker=f"w{int(v * 100) % 3}").observe(float(v))
    lat.labels(worker="edge").observe(mod.STEP_TIME_BUCKETS[3])   # on a bound
    sizes = reg.histogram("harmony_size_bytes", "Sizes", buckets=mod.TRANSFER_SIZE_BUCKETS)
    for v in rng.lognormal(12, 3, 32):
        sizes.observe(float(v))
    epochs = reg.histogram("harmony_epoch_seconds", "Epochs", buckets=mod.EPOCH_TIME_BUCKETS)
    epochs.observe(1e9)   # past every bound: the +Inf bucket
    big = reg.gauge("harmony_big", "Large and odd values", ("kind",))
    for kind, v in (("int", 12345.0), ("huge", 1e16), ("tiny", 1e-7), ("neg", -2.5),
                    ("nan", math.nan), ("inf", math.inf), ("ninf", -math.inf)):
        big.labels(kind=kind).set(v)
    reg.register_callback("harmony_cb", "A callback number", "gauge", lambda: 7.5)
    reg.register_callback(
        "harmony_cb_labeled_total", "A labeled callback counter", "counter",
        lambda: [({"site": "s2", "a": 1}, 2.0), ({"site": "s1", "a": 0}, 1.0)])
    reg.register_callback("harmony_cb_broken", "Raises: left out", "gauge",
                          lambda: 1 / 0)
    return reg.expose()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_same_operations_expose_the_same_bytes(seed):
    text = _drive(treg, treg.MetricRegistry(), seed)
    assert text == _drive(jreg, jreg.MetricRegistry(), seed)
    assert treg.lint_exposition(text) == jreg.lint_exposition(text) == []
    # repr: a NaN sample equals itself only as text
    assert repr(treg.parse_exposition(text)) == repr(jreg.parse_exposition(text))


def test_an_empty_registry_and_the_process_collectors():
    assert treg.MetricRegistry().expose() == jreg.MetricRegistry().expose() == "\n"
    reg = treg.MetricRegistry()    # as get_registry() first makes it
    treg._install_process_collectors(reg)
    text = reg.expose()
    fams = treg.parse_exposition(text)
    assert {"harmony_process_start_time_seconds", "harmony_process_uptime_seconds"} <= set(fams)
    assert "harmony_flight_dumps_total" not in fams   # the flight recorder is not ported
    assert treg.lint_exposition(text) == []


def test_the_same_misuse_raises_in_both():
    for mod in (treg, jreg):
        reg = mod.MetricRegistry()
        c = reg.counter("harmony_same_total", "x", ("job",))
        assert reg.counter("harmony_same_total", "x", ("job",)) is c
        with pytest.raises(ValueError):
            reg.gauge("harmony_same_total")
        with pytest.raises(ValueError):
            reg.counter("harmony_same_total", labelnames=("other",))
        with pytest.raises(ValueError):
            c.labels(wrong="x")
        with pytest.raises(ValueError):
            c.labels(job="a").inc(-1)
        with pytest.raises(ValueError):
            c.inc()                       # a labeled family has no solo child
        with pytest.raises(ValueError):
            reg.counter("0bad", "x")
        with pytest.raises(ValueError):
            reg.counter("harmony_le_total", "x", ("le",))
        reg.register_callback("harmony_cb", "x", "gauge", lambda: 1.0)
        with pytest.raises(ValueError):
            reg.counter("harmony_cb")
        with pytest.raises(ValueError):
            reg.register_callback("harmony_same_total", "x", "gauge", lambda: 1.0)
        with pytest.raises(ValueError):
            reg.register_callback("harmony_h", "x", "histogram", lambda: 1.0)
        with pytest.raises(ValueError):
            reg.register_callback("harmony_none", "x")


BAD_TEXTS = [
    "# HELP harmony_x_total x\n# TYPE harmony_x_total counter\nharmony_x_total -1\n",
    "# HELP harmony_x x\n# TYPE harmony_x counter\nharmony_x 1\n",
    "# TYPE harmony_x gauge\nharmony_x 1\n",
    "harmony_orphan 1\n",
    "# HELP harmony_x x\n# TYPE harmony_x gauge\nharmony_x{a=1} 1\n",
    "# HELP harmony_x x\n# TYPE harmony_x gauge\n# TYPE harmony_x gauge\n",
    "# HELP harmony_x x\n# TYPE harmony_x bogus\n",
    "# HELP harmony_h x\n# TYPE harmony_h histogram\n"
    'harmony_h_bucket{le="1"} 3\nharmony_h_bucket{le="+Inf"} 2\n'
    "harmony_h_sum 1\nharmony_h_count 2\n",
    "# HELP harmony_h x\n# TYPE harmony_h histogram\n"
    'harmony_h_bucket{le="1"} 1\nharmony_h_sum 1\nharmony_h_count 1\n',
    "# HELP harmony_h x\n# TYPE harmony_h histogram\n"
    'harmony_h_bucket{le="+Inf"} 2\nharmony_h_sum 1\nharmony_h_count 3\n',
    "# HELP harmony_h x\n# TYPE harmony_h histogram\n"
    'harmony_h_bucket{le="+Inf"} 2\n',
    "# HELP harmony_x x\n# TYPE harmony_x gauge\nharmony_x 1",
    "# HELP harmony_x x\n# TYPE harmony_x gauge\nharmony_x one\n",
]


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_lint_and_parse_agree_on_broken_texts(text):
    got = treg.lint_exposition(text)
    assert got and got == jreg.lint_exposition(text)
    try:
        want = jreg.parse_exposition(text)
    except ValueError as e:
        with pytest.raises(ValueError, match=None) as mine:
            treg.parse_exposition(text)
        assert str(mine.value) == str(e)
    else:
        assert treg.parse_exposition(text) == want


def test_counters_monotone_agrees():
    before = _drive(treg, treg.MetricRegistry(), 5)
    reg = treg.MetricRegistry()
    _drive(treg, reg, 5)
    reg.counter("harmony_ops_total", "Operations by job", ("job", "op")).labels(
        job="a", op="push").inc(5)
    after = reg.expose()
    assert treg.counters_monotone(before, after) == jreg.counters_monotone(before, after) == []
    back = treg.counters_monotone(after, before)
    assert back and back == jreg.counters_monotone(after, before)


def _port_instrumented_paths(tmp_path):
    """Fill the process registry through every instrumented path of the
    port, on the CPU at tiny sizes."""
    from harmony_tpu_torch.apps import mlr
    from harmony_tpu_torch.checkpoint.manager import CheckpointManager
    from harmony_tpu_torch.config.params import TableConfig, TrainerParams
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.prefetch import PrefetchPipeline
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet
    from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh
    from harmony_tpu_torch.runtime.master import ETMaster, TableHandle
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    trainer = mlr.MLRTrainer(num_classes=4, num_features=8, features_per_partition=4)
    x, y = mlr.make_synthetic(16, 8, 4)
    for fused in (True, False):   # the stack, and the prefetch pipeline
        table = DenseTable(TableSpec(trainer.model_table_config(num_blocks=8)), "cpu")
        WorkerTasklet("reg-j", TrainerContext(
            params=TrainerParams(num_epochs=2, num_mini_batches=2, fused_step=fused),
            model_table=table), trainer, TrainingDataProvider([x, y], 2)).run()
    master = ETMaster(DevicePool(["cpu"]))
    ex = [e.id for e in master.add_executors(1)]
    handle = TableHandle(master, master.create_table(
        TableConfig(table_id="reg-t", capacity=16, value_shape=(4,), num_blocks=8), ex), ex)
    mgr = CheckpointManager(str(tmp_path / "t"), str(tmp_path / "c"))
    cid = mgr.checkpoint(handle, commit=True)
    handle.drop()
    mgr.restore(master, cid, ex).drop()
    slots = DevicePool.virtual("cpu", 2).slots
    spec = TableSpec(TableConfig(table_id="reg-m", capacity=16, value_shape=(4,),
                                 num_blocks=8))
    moved = DenseTable(spec, build_mesh(slots[:1], data=1, model=1))
    moved.reshard(build_mesh(slots, data=1, model=2))
    pipe = PrefetchPipeline(TrainingDataProvider([x, y], 2), torch.device("cpu"), lambda: 2)
    for _ in pipe:
        pipe.stop_staging()   # drops the copies the producer staged ahead
        break
    pipe.close()
    return moved


def test_the_ports_instrumented_paths_expose_lint_clean_names(fresh, tmp_path):
    port_reg, _ = fresh
    _port_instrumented_paths(tmp_path)
    from harmony_tpu_torch.metrics import accounting, phases

    accounting.ledger()
    phases.budget()
    text = treg.get_registry().expose()
    assert treg.lint_exposition(text) == jreg.lint_exposition(text) == []
    fams = treg.parse_exposition(text)
    declared = {
        "harmony_step_time_seconds", "harmony_epoch_time_seconds",
        "harmony_chkp_io_seconds", "harmony_chkp_inflight_bytes",
        "harmony_checkpoint_blocks_read_total", "harmony_checkpoint_read_bytes_total",
        "harmony_blockmove_migrations_total", "harmony_blockmove_sent_blocks_total",
        "harmony_blockmove_sent_bytes_total", "harmony_blockmove_transport_retries_total",
        "harmony_blockmove_transfer_bytes", "harmony_move_leg_seconds",
        "harmony_tenant_device_seconds_total", "harmony_tenant_samples_per_sec",
        "harmony_phase_budget_seconds",
    }
    assert declared <= set(fams), sorted(declared - set(fams))
    ops = {s[1]["op"] for s in fams["harmony_chkp_io_seconds"]["samples"]}
    assert {"write", "read"} <= ops
    moves = {s[1]["transport"]: s[2]
             for s in fams["harmony_blockmove_migrations_total"]["samples"]}
    assert moves == {"device": 1.0}
    # MFU is unknown here (no FLOP count): absent from the scrape, never 0
    assert "harmony_tenant_mfu{" not in text
    assert not fams.get("harmony_tenant_mfu", {}).get("samples")
