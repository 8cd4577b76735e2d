"""GBT (``apps/gbt.py``) against harmony_tpu's on the CPU.

The same numpy data goes through the JAX trainer (its "matmul" histograms on
``weighted_histogram``'s CPU route, a one-hot product) and the port's.
Tolerances:

* Binning, data, table schemas, tree structure (feature, threshold, leaf
  flag), round counters and the budget mask: exact.
* Gradients, hessians and losses: 1e-6 relative (``sigmoid``, ``softmax`` and
  the means may round differently in the last bit).
* Leaf values, predictions and per-round losses: 1e-5 relative and absolute;
  the node sums add the same f32 terms in another order (a one-hot product or
  XLA's scatter against index order).
* Margins from stored trees: exact (a selection, then the rounds summed in
  order on both sides).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.apps import gbt as jax_gbt
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import TrainerContext as JaxTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JaxData
from harmony_tpu.dolphin import WorkerTasklet as JaxWorker
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu_torch import cli, convert
from harmony_tpu_torch.apps import gbt
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.table.table import DenseTable, TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GRAD_RTOL = 1e-6
RTOL = ATOL = 1e-5

# (loss, outputs, make_synthetic's task): tests/test_gbt.py's three losses
LOSSES = [("squared", 1, "regression"), ("logistic", 1, "binary"),
          ("softmax", 3, "multiclass")]
F, BINS, DEPTH = 6, 16, 3


def _kw(loss, k, **extra):
    return dict(num_features=F, num_examples=256, num_rounds=16, loss=loss,
                num_outputs=k, num_bins=BINS, max_depth=DEPTH, step_size=0.4, **extra)


def _data(task, n=256, seed=5):
    x, y = jax_gbt.make_synthetic(n, F, seed=seed, task=task, num_classes=3)
    bins, _ = jax_gbt.bin_features(x, BINS)
    return bins, y


def _structure(vec, n):
    return vec[..., :3 * n]


def _mesh():
    return build_mesh(jax.devices()[:1])


@pytest.mark.parametrize("task", ["regression", "binary", "multiclass"])
def test_make_synthetic_and_binning_are_byte_identical(task):
    for a, b in zip(jax_gbt.make_synthetic(300, 7, seed=3, task=task, num_classes=4),
                    gbt.make_synthetic(300, 7, seed=3, task=task, num_classes=4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    x, _ = gbt.make_synthetic(300, 7, seed=3, task=task)
    x[:, 1] = np.round(np.abs(x[:, 1]) * 3)                 # a categorical column
    cat = np.array([False, True] + [False] * 5)
    for a, b in zip(jax_gbt.bin_features(x, 16, categorical=cat),
                    gbt.bin_features(x, 16, categorical=cat)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    _, edges = gbt.bin_features(x, 16)
    held = gbt.make_synthetic(50, 7, seed=9, task=task)[0]
    np.testing.assert_array_equal(gbt.apply_bins(held, edges),
                                  jax_gbt.apply_bins(held, edges))
    for a, b in zip(jax_gbt.make_binned_synthetic(200, 5, num_bins=8, seed=2, task=task),
                    gbt.make_binned_synthetic(200, 5, num_bins=8, seed=2, task=task)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("loss,k,task", LOSSES)
def test_table_schemas_and_checks_match(loss, k, task):
    jt, tt = jax_gbt.GBTTrainer(**_kw(loss, k)), gbt.GBTTrainer(**_kw(loss, k))
    for fn in ("model_table_config", "local_table_config"):
        a, b = getattr(jt, fn)(), getattr(tt, fn)()
        for field in ("table_id", "capacity", "value_shape", "num_blocks", "is_ordered",
                      "update_fn", "dtype"):
            assert getattr(b, field) == getattr(a, field), (fn, field)
    assert tt.tree_vec_len == jt.tree_vec_len and tt.num_nodes == jt.num_nodes
    assert tt.hyperparams() == jt.hyperparams()
    for bad, match in ((dict(loss="huber"), "unknown loss"),
                       (dict(loss="softmax", num_outputs=1), "num_outputs >= 2"),
                       (dict(loss="squared", num_outputs=2), "single-output"),
                       (dict(hist_mode="sort"), "unknown hist_mode")):
        kw = {**_kw(loss, k), **bad}
        for cls in (jax_gbt.GBTTrainer, gbt.GBTTrainer):
            with pytest.raises(ValueError, match=match):
                cls(**kw)


@pytest.mark.parametrize("loss,k,task", LOSSES)
def test_grad_hess_matches(loss, k, task):
    _, y = _data(task)
    m = np.random.default_rng(1).normal(scale=0.7, size=(256, k)).astype(np.float32)
    jg, jh, jl = jax.jit(jax_gbt.GBTTrainer(**_kw(loss, k))._grad_hess)(
        jnp.asarray(m), jnp.asarray(y))
    tg, th, tl = gbt.GBTTrainer(**_kw(loss, k))._grad_hess(torch.as_tensor(m),
                                                           torch.as_tensor(y))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=GRAD_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_RTOL)


@pytest.mark.parametrize("mode", ["scatter", "matmul"])
@pytest.mark.parametrize("loss,k,task", LOSSES)
def test_grow_tree_matches(loss, k, task, mode):
    """One tree from the same gradients and hessians, in each hist_mode:
    feat/thr/is_leaf exact, leaf values and per-example predictions within
    1e-5."""
    bins, y = _data(task)
    m = np.random.default_rng(2).normal(scale=0.3, size=(256, k)).astype(np.float32)
    jt = jax_gbt.GBTTrainer(**_kw(loss, k, hist_mode=mode))
    tt = gbt.GBTTrainer(**_kw(loss, k, hist_mode=mode))
    g, h, _ = jt._grad_hess(jnp.asarray(m), jnp.asarray(y))
    want = jax.jit(jt._grow_tree)(jnp.asarray(bins), g, h)
    got = tt._grow_tree(torch.as_tensor(bins), torch.as_tensor(np.asarray(g)),
                        torch.as_tensor(np.asarray(h)))
    for name, a, b in zip(("feat", "thr", "is_leaf"), want[:3], got[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert got[2].numpy().any()
    for name, a, b in zip(("leaf_val", "pred"), want[3:], got[3:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode,fold", [("matmul", "weighted_histogram"),
                                       ("scatter", "segment_sum_rows")])
def test_each_level_folds_once_per_route(monkeypatch, mode, fold):
    """The route's wiring on the CPU: each level's histograms AND node totals
    in one call of width 2K+1, to weighted_histogram (K3) for "matmul" and to
    segment_sum_rows (K2) for "scatter"; the other wrapper is never called.
    The root's fold takes F * BINS histogram rows and one row of totals,
    which every example's last id names."""
    calls = {"weighted_histogram": [], "segment_sum_rows": []}
    for name in calls:
        real = getattr(gbt, name)

        def spy(*args, _real=real, _name=name):
            calls[_name].append(args)
            return _real(*args)

        monkeypatch.setattr(gbt, name, spy)
    bins, y = _data("multiclass")
    tt = gbt.GBTTrainer(**_kw("softmax", 3, hist_mode=mode))
    g, h, _ = tt._grad_hess(torch.zeros((256, 3)), torch.as_tensor(y))
    tt._grow_tree(torch.as_tensor(bins), g, h)
    assert len(calls[fold]) == DEPTH + 1
    assert all(not v for k, v in calls.items() if k != fold)
    first = calls[fold][0]
    ids, w, rows = first if fold == "weighted_histogram" else (first[1], first[0], first[2])
    assert ids.dtype == torch.int32 and rows == F * BINS + 1
    assert w.shape[1] == 7
    np.testing.assert_array_equal(ids[-256:].numpy(), np.full(256, F * BINS))


def test_hist_mode_auto_resolves_by_device():
    tt = gbt.GBTTrainer(**_kw("squared", 1))
    assert tt.hist_mode == "auto"
    assert tt.resolved_hist_mode(torch.zeros(1)) == "scatter"
    assert gbt.GBTTrainer(**_kw("squared", 1, hist_mode="matmul")).resolved_hist_mode(
        torch.zeros(1)) == "matmul"


def _boost_jax(jt, bins, y, epochs, batches=4):
    mesh = _mesh()
    model = JaxDenseTable(JaxTableSpec(jt.model_table_config()), mesh)
    state = JaxDenseTable(JaxTableSpec(jt.local_table_config()), mesh)
    ctx = JaxTrainerContext(params=JaxTrainerParams(num_epochs=epochs,
                                                    num_mini_batches=batches),
                            model_table=model, local_table=state)
    res = JaxWorker("gbt", ctx, jt, JaxData([bins, y], batches), mesh).run()
    return model, state, res


def _boost_torch(tt, bins, y, epochs, batches=4):
    model = DenseTable(TableSpec(tt.model_table_config()), "cpu")
    state = DenseTable(TableSpec(tt.local_table_config()), "cpu")
    ctx = TrainerContext(params=TrainerParams(num_epochs=epochs, num_mini_batches=batches),
                         model_table=model, local_table=state)
    worker = WorkerTasklet("gbt", ctx, tt, TrainingDataProvider([bins, y], batches))
    return model, state, worker.run(), worker


def _assert_same_trees(got: np.ndarray, want: np.ndarray, n: int) -> None:
    np.testing.assert_array_equal(_structure(got, n), _structure(want, n))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _settled_at(tree: np.ndarray, bins: np.ndarray, n: int) -> np.ndarray:
    """The node at which each example of ``bins`` settles in ``tree``."""
    feat, thr = tree[:n].astype(np.int64), tree[n:2 * n].astype(np.int64)
    leaf = tree[2 * n:3 * n] > 0.5
    pos = np.zeros(len(bins), np.int64)
    while not leaf[pos].all():
        right = bins[np.arange(len(bins)), feat[pos]] > thr[pos]
        pos = np.where(leaf[pos], pos, 2 * pos + 1 + right)
    return pos


def _assert_equivalent_trees(got: np.ndarray, want: np.ndarray, batches, n: int) -> None:
    """The trees of several rounds grown alike: leaf flags exact, every
    example of the round's mini-batch (``batches[r % len(batches)]``) settles
    at the same node, values within 1e-5. A split (feature, bin) may differ
    only where both send every example of that batch the same way: an exact
    tie between two splits that part the node's examples alike, which the
    last bit of the gradients decides once the margins of earlier rounds
    differ by an ulp (2 of 120 nodes in 8 rounds of the logistic and softmax
    jobs below)."""
    np.testing.assert_array_equal(got[:, 2 * n:3 * n], want[:, 2 * n:3 * n])
    np.testing.assert_allclose(got[:, 3 * n:], want[:, 3 * n:], rtol=RTOL, atol=ATOL)
    for r in range(got.shape[0]):
        if not (got[r, 2 * n:3 * n] > 0.5).any():
            assert not want[r].any() and not got[r].any()     # not boosted
            continue
        b = batches[r % len(batches)]
        np.testing.assert_array_equal(_settled_at(got[r], b, n), _settled_at(want[r], b, n),
                                      err_msg=f"round {r}")


@pytest.mark.parametrize("loss,k,task", LOSSES)
def test_two_epoch_job_matches_the_jax_worker(loss, k, task):
    """tests/test_gbt.py's boost set-up (F=6, 16 bins, depth 3, 2 epochs of 4
    mini-batches) through both packages' WorkerTasklet: the per-epoch losses,
    the round counter, the stored trees (grown alike on their batches),
    un-boosted rows zero, and the evaluation of one ensemble."""
    bins, y = _data(task, seed=1)
    jt = jax_gbt.GBTTrainer(**_kw(loss, k, hist_mode="matmul"))
    tt = gbt.GBTTrainer(**_kw(loss, k))
    jm, js, jres = _boost_jax(jt, bins, y, epochs=2)
    tm, ts, tres, worker = _boost_torch(tt, bins, y, epochs=2)
    assert len(tres["batch_losses"]) == 8
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=RTOL, atol=ATOL)
    assert float(ts.get(0)[0]) == float(np.asarray(js.get(0))[0]) == 8.0
    rows = tm.pull_array().numpy()
    _assert_equivalent_trees(rows, np.asarray(jm.pull_array()), np.split(bins, 4),
                             tt.num_nodes)
    assert (rows[8:] == 0).all()
    # evaluate: of the same (JAX's) ensemble in both; the port's own, run by
    # its worker, may split a tie the other way for the examples of other batches
    jmodel = np.asarray(jm.pull_array())
    je = jax.jit(jt.evaluate)(jnp.asarray(jmodel), (jnp.asarray(bins), jnp.asarray(y)))
    te = tt.evaluate(torch.as_tensor(jmodel), (torch.as_tensor(bins), torch.as_tensor(y)))
    assert set(te) == set(je) == set(worker.evaluate((bins, y)))
    for key in te:
        np.testing.assert_allclose(float(te[key]), float(je[key]), rtol=RTOL, atol=ATOL)


def test_predict_margins_sums_rounds_in_order_and_unboosted_rows_predict_zero():
    """Margins from the same stored ensemble (8 boosted rows, 8 zero rows):
    exactly JAX's lax.scan sum, exactly a round-order f32 sum of the
    per-tree predictions, and exactly 0 from an all-zero model."""
    bins, y = _data("multiclass", seed=1)
    jt = jax_gbt.GBTTrainer(**_kw("softmax", 3, hist_mode="matmul"))
    tt = gbt.GBTTrainer(**_kw("softmax", 3))
    jm, _, _ = _boost_jax(jt, bins, y, epochs=2)
    model = np.asarray(jm.pull_array())
    want = np.asarray(jax.jit(jt.predict_margins)(jnp.asarray(model), jnp.asarray(bins)))
    got = tt.predict_margins(torch.as_tensor(model), torch.as_tensor(bins)).numpy()
    np.testing.assert_array_equal(got, want)
    per_tree = tt._traverse(torch.as_tensor(model), torch.as_tensor(bins)).numpy()
    acc = np.zeros_like(got)
    for r in range(per_tree.shape[0]):
        acc = acc + per_tree[r]
    np.testing.assert_array_equal(got, acc)
    one = tt._traverse(torch.as_tensor(model[0]), torch.as_tensor(bins)).numpy()
    np.testing.assert_array_equal(one, per_tree[0])
    zero = tt.predict_margins(torch.zeros_like(torch.as_tensor(model)), torch.as_tensor(bins))
    assert (zero.numpy() == 0).all() and not np.signbit(zero.numpy()).any()


@pytest.mark.parametrize("rnd", [3, 15, 16, 40])
def test_compute_with_local_and_the_round_budget(rnd):
    """One step from the same ensemble, counter and batch: the tree lands at
    row ``rnd`` (structure exact, values within 1e-5), the counter goes up by
    one, and past the budget the delta is all zeros (+0.0)."""
    bins, y = _data("regression", seed=1)
    jt = jax_gbt.GBTTrainer(**_kw("squared", 1, hist_mode="matmul"))
    tt = gbt.GBTTrainer(**_kw("squared", 1))
    jm, _, _ = _boost_jax(jt, bins, y, epochs=1)
    model = np.asarray(jm.pull_array())
    local = np.full((1, 1), rnd, np.float32)
    batch = (bins[64:128], y[64:128])
    jd, jl, jmet = jax.jit(jt.compute_with_local)(
        jnp.asarray(model), jnp.asarray(local), tuple(map(jnp.asarray, batch)),
        {"step": jnp.asarray(0.4, jnp.float32)})
    td, tl, tmet = tt.compute_with_local(
        torch.as_tensor(model), torch.as_tensor(local), tuple(map(torch.as_tensor, batch)),
        {"step": torch.tensor(0.4)})
    _assert_same_trees(td.numpy(), np.asarray(jd), tt.num_nodes)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert float(tl[0, 0]) == rnd + 1 and float(tmet["round"]) == rnd
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=RTOL)
    nonzero = np.nonzero(td.numpy().any(axis=1))[0].tolist()
    assert nonzero == ([rnd] if rnd < 16 else [])


def test_the_same_ensemble_carried_across_boosts_on_alike():
    """convert.gbt_tables_from_numpy: the JAX ensemble after one epoch (4
    rounds) installed in the port's tables; one more epoch in each package
    from that state gives the same trees and counters."""
    bins, y = _data("binary", seed=4)
    jt = jax_gbt.GBTTrainer(**_kw("logistic", 1, hist_mode="matmul"))
    tt = gbt.GBTTrainer(**_kw("logistic", 1))
    jm, js, _ = _boost_jax(jt, bins, y, epochs=1)
    tm, ts = convert.gbt_tables_from_numpy(tt, np.asarray(jm.pull_array()),
                                           int(np.asarray(js.get(0))[0]), "cpu")
    with pytest.raises(ValueError, match="tree rows"):
        convert.gbt_tables_from_numpy(tt, np.zeros((3, 4), np.float32), 0, "cpu")
    mesh = _mesh()
    JaxWorker("gbt", JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=1, num_mini_batches=4), model_table=jm,
        local_table=js), jt, JaxData([bins, y], 4), mesh, global_init=False).run()
    WorkerTasklet("gbt", TrainerContext(
        params=TrainerParams(num_epochs=1, num_mini_batches=4), model_table=tm,
        local_table=ts), tt, TrainingDataProvider([bins, y], 4), global_init=False).run()
    assert float(ts.get(0)[0]) == float(np.asarray(js.get(0))[0]) == 8.0
    _assert_equivalent_trees(tm.pull_array().numpy(), np.asarray(jm.pull_array()),
                             np.split(bins, 4), tt.num_nodes)


def test_cli_run_gbt_on_the_cpu(capsys):
    """The gbt preset (16 features, depth 4, squared) through cli -> JobServer
    -> DolphinJobEntity -> WorkerTasklet: 3 epochs of 4 rounds, the loss
    falls, within 1e-5 of the reference's CLI run on its one executor."""
    from harmony_tpu import cli as jax_cli

    args = ["run", "gbt", "--epochs", "3", "--batches", "4"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(args + ["--num-executors", "1"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (tw,) = got["result"]["workers"].values()
    (jw,) = want["result"]["workers"].values()
    assert len(tw["batch_losses"]) == 12 and tw["losses"][-1] < tw["losses"][0]
    np.testing.assert_allclose(tw["losses"], jw["losses"], rtol=RTOL, atol=ATOL)
