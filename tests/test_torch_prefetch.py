"""The port's input path on the CPU: the provider against harmony_tpu's, the
staging ring, the prefetch pipeline, and the epochs served from the device
cache.

* The provider's permutations and batches are numpy draws and slices, the
  same in both packages: compared exactly.
* Losses with the pipeline on and off (and in each step mode) do the same
  operations on the same batches: compared bit for bit.
"""
import threading
import time

import numpy as np
import pytest
import torch

from harmony_tpu.dolphin import TrainingDataProvider as JaxData
from harmony_tpu_torch.apps import mlr, widedeep
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.data import devcache
from harmony_tpu_torch.data.loader import StageRing
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.prefetch import PrefetchPipeline
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


CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _empty_caches():
    devcache.clear()
    devcache.host_data.clear()
    yield
    devcache.clear()
    devcache.host_data.clear()


def _arrays(n=40):
    rng = np.random.default_rng(3)
    return [rng.standard_normal((n, 3)).astype(np.float32),
            np.arange(n, dtype=np.int32), rng.integers(0, 9, (n, 2, 2)).astype(np.int64)]


def test_provider_matches_the_jax_provider():
    arrays = _arrays(43)                  # 43 rows into 5 batches: 3 trimmed
    mine = TrainingDataProvider(arrays, 5, shuffle_each_epoch=True, seed=11)
    ref = JaxData(arrays, 5, shuffle_each_epoch=True, seed=11)
    assert mine.is_shuffling and mine.dataset_key is None
    assert mine.array_specs() == ref.array_specs()
    for x, y in zip(mine.first_rows(7), ref.first_rows(7)):
        np.testing.assert_array_equal(x, y)
    for epoch in (0, 1, 2, 1, 4, 0):       # in order, backward, a gap
        np.testing.assert_array_equal(mine.epoch_permutation(epoch),
                                      ref.epoch_permutation(epoch))
    for epoch in (3, 2):
        for a, b in zip(mine.epoch_batches_at(epoch), ref.epoch_batches_at(epoch)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    for _ in range(3):                     # the sequential draws, untouched above
        for a, b in zip(mine.epoch_batches(), ref.epoch_batches()):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        mine.batch_at(0)
    stable, jstable = (cls(arrays, 5, dataset_key=("src",)) for cls in
                       (TrainingDataProvider, JaxData))
    assert stable.dataset_key == jstable.dataset_key == ("src",)
    for b in range(5):
        for x, y in zip(stable.batch_at(b), jstable.batch_at(b)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(IndexError):
        stable.batch_at(5)
    with pytest.raises(ValueError):
        stable.epoch_permutation(0)


def test_the_replay_lock_keeps_permutations_pure_under_threads():
    """Explicit-epoch reads from several threads at once each get the
    permutation a fresh generator draws for their epoch."""
    arrays = _arrays(64)
    provider = TrainingDataProvider(arrays, 4, shuffle_each_epoch=True, seed=2)
    ref = JaxData(arrays, 4, shuffle_each_epoch=True, seed=2)
    want = {e: ref.epoch_permutation(e) for e in range(6)}
    errors = []

    def reader(order):
        for e in order:
            if not np.array_equal(provider.epoch_permutation(e), want[e]):
                errors.append(e)

    threads = [threading.Thread(target=reader, args=(list(range(6)) * 3,))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and errors == []


def test_the_ring_never_exceeds_its_cap_and_rereads_it():
    cap = [3]
    ring = StageRing(lambda: cap[0])
    depths = []

    def produce():
        for i in range(40):
            assert ring.put(i)
            depths.append((i, ring.depth(), cap[0]))
        ring.finish()

    t = threading.Thread(target=produce)
    t.start()
    got = []
    while True:
        time.sleep(0.002)
        if len(got) == 15:
            cap[0] = 1                     # a smaller cap applies to new puts
        item = ring.get()
        if item is StageRing.DONE:
            break
        got.append(item)
    t.join(timeout=10)
    assert not t.is_alive() and got == list(range(40))
    assert ring.max_depth <= 3 and ring.staged == 40
    assert all(depth <= c for _, depth, c in depths if _ > 20)
    assert ring.producer_idle_sec > 0


def test_a_producer_error_surfaces_after_the_staged_prefix():
    class Broken(TrainingDataProvider):
        def epoch_batches(self):
            for i, b in enumerate(super().epoch_batches()):
                if i == 2:
                    raise RuntimeError("bad batch")
                yield b

    pipeline = PrefetchPipeline(Broken(_arrays(), 4), CPU, lambda: 8)
    got = []
    with pytest.raises(RuntimeError, match="bad batch"):
        for staged in pipeline:
            got.append(staged.index)
    assert got == [0, 1]
    pipeline.close()
    assert not pipeline.thread_alive


def test_an_early_close_joins_the_producer():
    provider = TrainingDataProvider(_arrays(64), 32)
    pipeline = PrefetchPipeline(provider, CPU, lambda: 1, job_id="early")
    first = next(iter(pipeline))
    assert first.index == 0
    pipeline.close()
    pipeline.close()                        # idempotent
    assert not pipeline.thread_alive
    assert not any(t.name.startswith("prefetch-early") for t in threading.enumerate())


def test_staged_batches_are_copies_of_their_host_batches():
    """The pinned pool is reused, so a staged tensor must never alias a pool
    buffer: with every batch staged before the first is read, each still
    holds its own values."""
    arrays = _arrays(40)
    provider = TrainingDataProvider(arrays, 10)
    pipeline = PrefetchPipeline(provider, CPU, lambda: 16)
    pipeline._thread.join(timeout=10)        # all ten staged through two buffers
    staged = list(pipeline)
    pipeline.close()
    assert [s.index for s in staged] == list(range(10))
    for s, host in zip(staged, provider.epoch_batches()):
        for t, h in zip(s.take(), host):
            np.testing.assert_array_equal(t.numpy(), h)
    assert pipeline.stats()["staged"] == 10 and pipeline.stats()["max_depth"] == 10


def test_stop_staging_demotes_to_host_only():
    pipeline = PrefetchPipeline(TrainingDataProvider(_arrays(40), 10), CPU, lambda: 16)
    pipeline._thread.join(timeout=10)
    assert pipeline.stop_staging() == 10
    staged = list(pipeline)
    pipeline.close()
    assert all(s.device is None and s.take() is None for s in staged)
    assert pipeline.stats()["dropped_batches"] == 10


WD = dict(vocab_size=300, num_slots=4, emb_dim=4, hidden=8)


def _wd_run(prefetch, fused=True, shuffle=True, epochs=3):
    arrays = list(widedeep.make_synthetic(256, WD["vocab_size"], WD["num_slots"], seed=4))
    trainer = widedeep.WideDeepTrainer(**WD)
    table = DenseTable(TableSpec(trainer.model_table_config()), CPU)
    params = TrainerParams(num_epochs=epochs, num_mini_batches=4, input_prefetch=prefetch,
                           fused_step=fused)
    worker = WorkerTasklet("wd", TrainerContext(params=params, model_table=table), trainer,
                           TrainingDataProvider(arrays, 4, shuffle_each_epoch=shuffle, seed=8))
    return worker.run(), table


@pytest.mark.parametrize("fused", [True, False])
def test_losses_are_bit_identical_with_prefetch_on_and_off(fused):
    on, ton = _wd_run(True, fused)
    off, toff = _wd_run(False, fused)
    assert on["batch_losses"] == off["batch_losses"]
    assert torch.equal(ton.array, toff.array)
    assert on["input"]["staged"] == on["input"]["prefetch_hits"] == 12
    assert on["input"]["pipelines"] == 3 and off["input"]["pipelines"] == 0
    assert on["windows"] == ([3] if fused else [1, 1, 1])
    assert not any(t.name.startswith("prefetch-") for t in threading.enumerate())


class _Counted(TrainingDataProvider):
    """Counts the provider's host assembly: epoch_batches and batch_at calls."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = {"epoch_batches": 0, "batch_at": 0}

    def epoch_batches(self):
        self.calls["epoch_batches"] += 1
        return super().epoch_batches()

    def batch_at(self, b):
        self.calls["batch_at"] += 1
        return super().batch_at(b)


def _mlr_worker(data, **params):
    trainer = mlr.MLRTrainer(num_classes=4, num_features=16, features_per_partition=8)
    table = DenseTable(TableSpec(trainer.model_table_config()), CPU)
    return WorkerTasklet("c", TrainerContext(
        params=TrainerParams(num_epochs=3, num_mini_batches=4, **params),
        model_table=table), trainer, data)


@pytest.mark.parametrize("prefetch", [True, False])
def test_an_epoch_from_the_device_cache_does_no_host_assembly(prefetch):
    """On the batched path the first epoch assembles its batches once (through
    the pipeline, or in line) and fills the caches; the next epochs, and a
    second worker over the same data source, assemble nothing."""
    arrays = list(mlr.make_synthetic(64, 16, 4, seed=1))
    data = _Counted(arrays, 4, dataset_key=("mlr-src",))
    first = _mlr_worker(data, fused_step=False, input_prefetch=prefetch).run()
    assert data.calls == {"epoch_batches": 1, "batch_at": 0}
    assert first["input"]["pipelines"] == (1 if prefetch else 0)
    again = _Counted(arrays, 4, dataset_key=("mlr-src",))
    second = _mlr_worker(again, fused_step=False, input_prefetch=prefetch).run()
    assert again.calls == {"epoch_batches": 0, "batch_at": 0}
    assert second["batch_losses"] == first["batch_losses"]
    assert devcache.stats()["entries"] == 4


def test_the_fused_path_uploads_the_stack_once():
    arrays = list(mlr.make_synthetic(64, 16, 4, seed=1))
    data = _Counted(arrays, 4, dataset_key=("mlr-src",))
    first = _mlr_worker(data).run()
    assert data.calls == {"epoch_batches": 1, "batch_at": 0}
    again = _Counted(arrays, 4, dataset_key=("mlr-src",))
    second = _mlr_worker(again).run()
    assert again.calls == {"epoch_batches": 0, "batch_at": 0}
    assert second["batch_losses"] == first["batch_losses"]
    assert first["windows"] == [3] and first["input"]["pipelines"] == 0
