"""harmony_tpu_torch's bulk loader against harmony_tpu's, on the CPU.

The cases of the reference's ``tests/test_data.py``, each run through both
packages on the same files: exactly-N splits, the parsers and their
registry, ``TableHandle.load`` into a dense table (keys from the data, and
generated keys) and into a hash table (generated keys from ``MIN_KEY``),
``load_dataset`` and the storer. Exact comparisons throughout: the loaders
move bytes.
"""
import os

import jax
import numpy as np
import pytest
import torch

from harmony_tpu import data as jax_data
from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.runtime.master import ETMaster as JaxETMaster
from harmony_tpu_torch import data
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle
from harmony_tpu_torch.table.hashtable import MIN_KEY


@pytest.fixture()
def text_file(tmp_path):
    p = tmp_path / "data.txt"
    lines = [f"{i} {i * 1.0} {i * 2.0}" for i in range(100)]
    p.write_text("\n".join(lines) + "\n")
    return str(p), lines


def _pieces(splits):
    return [[tuple(x) for x in s.pieces] for s in splits]


# -- splits ----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 7, 16])
def test_exactly_n_splits_cover_every_record_once_as_the_reference(text_file, n):
    path, lines = text_file
    splits = data.compute_splits([path], n)
    assert len(splits) == n
    assert [r for s in splits for r in data.fetch_split(s)] == lines
    assert _pieces(splits) == _pieces(jax_data.compute_splits([path], n))


def test_more_splits_than_bytes(tmp_path):
    p = tmp_path / "tiny.txt"
    p.write_text("a\nb\n")
    splits = data.compute_splits([str(p)], 8)
    assert len(splits) == 8
    assert [r for s in splits for r in data.fetch_split(s)] == ["a", "b"]
    assert _pieces(splits) == _pieces(jax_data.compute_splits([str(p)], 8))


def test_a_split_spans_files(tmp_path):
    pa, pb = tmp_path / "a.txt", tmp_path / "b.txt"
    pa.write_text("1\n2\n3\n")
    pb.write_text("4\n5\n")
    paths = [str(pa), str(pb)]
    splits = data.compute_splits(paths, 4)
    got = [data.fetch_split(s) for s in splits]
    assert sorted(r for recs in got for r in recs) == ["1", "2", "3", "4", "5"]
    assert got == [jax_data.fetch_split(s) for s in jax_data.compute_splits(paths, 4)]


def test_a_split_round_trips_through_json_and_the_references_config(text_file):
    path, _ = text_file
    s = data.compute_splits([path], 2)[1]
    clone = type(s).from_json(s.to_json())
    assert data.fetch_split(clone) == data.fetch_split(s)
    ref = jax_data.compute_splits([path], 2)[1]
    assert s.to_dict() == ref.to_dict()


# -- parsers ---------------------------------------------------------------


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name, kwargs, records", [
    ("libsvm", {"num_features": 4}, ["1 1:0.5 3:2.0", "-1 2:1.0"]),
    ("libsvm", {"num_features": 3, "base": 0}, ["0 0:1.5 2:-2.25 7:9", "1"]),
    ("csv", {"label_col": 0}, ["1,2.5,3.5", "0,4.5,5.5"]),
    ("csv", {}, ["1,2", "3,4", "5,6"]),
    ("keyvec", {}, ["7 1.0 2.0", "9 3.0 4.0"]),
])
def test_parsers_give_the_references_arrays(name, kwargs, records):
    got = data.get_parser(name, **kwargs).parse(records)
    _same(got, jax_data.get_parser(name, **kwargs).parse(records))


def test_libsvm_parser_values():
    x, y = data.LibSvmParser(num_features=4).parse(["1 1:0.5 3:2.0", "-1 2:1.0"])
    np.testing.assert_array_equal(y, [1.0, -1.0])
    np.testing.assert_array_equal(x, [[0.5, 0.0, 2.0, 0.0], [0.0, 1.0, 0.0, 0.0]])


def test_registry():
    assert isinstance(data.get_parser("libsvm", num_features=2), data.LibSvmParser)
    assert sorted(data.parsers._REGISTRY) == sorted(jax_data.parsers._REGISTRY)
    with pytest.raises(KeyError):
        data.get_parser("nope")


# -- TableHandle.load --------------------------------------------------------


def _port_handle(cfg):
    master = ETMaster(DevicePool([torch.device("cpu")]))
    ex = [e.id for e in master.add_executors(1)]
    return TableHandle(master, master.create_table(cfg, ex), ex)


def _jax_handle(kw, n_exec=4):
    master = JaxETMaster(JaxDevicePool(jax.devices()[:8]))
    execs = master.add_executors(n_exec)
    return master.create_table(JaxTableConfig(**kw), [e.id for e in execs])


def _handles(n_exec=4, **kw):
    """The same table config in each package: (port handle, reference handle)."""
    return _port_handle(TableConfig(**kw)), _jax_handle(kw, n_exec)


def test_load_keys_from_the_data_as_the_reference(tmp_path):
    p = tmp_path / "rows.txt"
    p.write_text("\n".join(f"{i} {float(i)} {float(i) + 0.5}" for i in range(32)) + "\n")
    mine, ref = _handles(table_id="bulk", capacity=32, value_shape=(2,), num_blocks=8)
    assert mine.load([str(p)], data.KeyValueVectorParser(), num_splits=4) == 32
    assert ref.load([str(p)], jax_data.KeyValueVectorParser()) == 32
    keys = list(range(32))
    got, want = mine.table.multi_get(keys), np.asarray(ref.table.multi_get(keys))
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got[5], [5.0, 5.5])


def test_generated_keys_as_the_reference(tmp_path):
    p = tmp_path / "vals.csv"
    p.write_text("\n".join(f"{float(i)},{float(i) + 0.5}" for i in range(24)) + "\n")
    mine, ref = _handles(table_id="nk", capacity=24, value_shape=(2,), num_blocks=8)
    assert mine.load([str(p)], data.CsvParser(), num_splits=3, generate_keys=True) == 24
    assert ref.load([str(p)], jax_data.CsvParser(), num_splits=3, generate_keys=True) == 24
    keys = list(range(24))
    got = mine.table.multi_get(keys)
    assert got.tobytes() == np.asarray(ref.table.multi_get(keys)).tobytes()
    np.testing.assert_array_equal(got[:, 0], np.arange(24, dtype=np.float32))
    # a keyed parser with generated keys is refused, not a silent key loss
    with pytest.raises(ValueError, match="values-only"):
        mine.load([str(p)], data.CsvParser(label_col=0), generate_keys=True)
    # the generator persists across loads: a second load would pass the
    # capacity, and is refused instead of overwriting rows from key 0
    with pytest.raises(ValueError, match="capacity"):
        mine.load([str(p)], data.CsvParser(), generate_keys=True)


def test_generated_keys_start_at_min_key_on_a_hash_table(tmp_path):
    p = tmp_path / "vals.csv"
    p.write_text("\n".join(f"{float(i)},{float(i) + 0.5}" for i in range(16)) + "\n")
    mine, ref = _handles(n_exec=2, table_id="nk-sparse", capacity=256, value_shape=(2,),
                         num_blocks=2, sparse=True)
    # two splits each: one multi_put a split, so the same inserts in the same order
    assert mine.load([str(p)], data.CsvParser(), num_splits=2, generate_keys=True) == 16
    assert ref.load([str(p)], jax_data.CsvParser(), num_splits=2, generate_keys=True) == 16
    assert MIN_KEY == 1 and mine.table.overflow_count == 0
    assert sorted(mine.table.items()) == list(range(MIN_KEY, MIN_KEY + 16))
    keys = list(range(0, 20))
    got = mine.table.multi_get(keys)
    assert got.tobytes() == np.asarray(ref.table.multi_get(keys)).tobytes()
    np.testing.assert_array_equal(got[1:17, 0], np.arange(16, dtype=np.float32))
    # the slot placement is the reference's, byte for byte
    sk, _ = ref.table.state
    assert mine.table.state[0].numpy().tobytes() == np.asarray(sk).tobytes()


def test_load_dataset_for_training(text_file):
    path, _ = text_file
    keys, vals = data.load_dataset([path], data.KeyValueVectorParser(), num_splits=3)
    assert keys.shape == (100,) and vals.shape == (100, 2)
    np.testing.assert_array_equal(keys, np.arange(100))
    _same((keys, vals), jax_data.load_dataset([path], jax_data.KeyValueVectorParser(),
                                              num_splits=3))


@pytest.mark.parametrize("num_splits", [1, 5, 7])
def test_load_dataset_reads_splits_in_order(text_file, num_splits):
    path, lines = text_file
    got = data.load_dataset([path], data.KeyValueVectorParser(), num_splits=num_splits)
    _same(got, data.KeyValueVectorParser().parse(lines))
    _same(got, jax_data.load_dataset([path], jax_data.KeyValueVectorParser(),
                                     num_splits=num_splits))


# -- storer ----------------------------------------------------------------


def test_storer_writes_the_references_files(tmp_path):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = []
    for mod, root in ((data, tmp_path / "port"), (jax_data, tmp_path / "ref")):
        st = mod.FileDataStorer(str(root))
        st.store_array("model/final.npy", arr)
        st.store_json("result.json", {"loss": 0.5})
        st.store_text("log.txt", "done")
        np.testing.assert_array_equal(st.load_array("model/final.npy"), arr)
        assert [f for f in os.listdir(root) if f.endswith(".tmp")] == []
        outs.append({rel: (root / rel).read_bytes()
                     for rel in ("model/final.npy", "result.json", "log.txt")})
    assert outs[0] == outs[1]
