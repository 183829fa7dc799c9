"""The port's readers (``elasticdl_tpu_torch/data/{reader,vectorized,
odps_reader}.py``, the zoo's ``CriteoRecordReader``) against the JAX
package's on the same files: the shards the master builds, each task's
records, the vectorized parse, the ODPS reader over one fake client, and
the reader a data path selects."""

import types

import numpy as np
import pytest

from elasticdl_tpu.data import odps_reader as jax_odps
from elasticdl_tpu.data import reader as jax_reader
from elasticdl_tpu.data import recordfile as jax_rf
from elasticdl_tpu.data import vectorized as jax_vec
from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.common.model_utils import load_model_spec
from elasticdl_tpu_torch.data import odps_reader as port_odps
from elasticdl_tpu_torch.data import reader as port_reader
from elasticdl_tpu_torch.data import vectorized as port_vec
from elasticdl_tpu_torch.zoo import deepfm as port_deepfm
from model_zoo.deepfm import deepfm_functional_api as jax_deepfm


def _task(shard, start, end):
    return types.SimpleNamespace(task_id=1, shard_name=shard, start=start, end=end, epoch=0)


def _same(got, want):
    """Records equal in structure, values and dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _write_csv(directory, with_quotes):
    directory.mkdir()
    rng = np.random.RandomState(3)
    for name, rows in (("a.csv", 700), ("b.csv", 41), ("c.csv", 0)):
        with open(directory / name, "w") as f:
            f.write("x,y,z\n")
            for i in range(rows):
                text = f'"line {i}\nwrapped"' if with_quotes and i % 9 == 0 else f"t{i}"
                f.write(f"{i},{rng.rand():.6f},{text}\n")
    return str(directory)


def _write_text(directory):
    directory.mkdir()
    for name, rows in (("part-0", 500), ("part-1", 3)):
        (directory / name).write_text("".join(f"line {i}\r\n" for i in range(rows)))
    (directory / "_SUCCESS").write_text("")
    return str(directory)


def _write_rio(directory):
    directory.mkdir()
    for name, rows in (("p0.rio", 333), ("p1.recordio", 20)):
        jax_rf.write_records(str(directory / name), [f"r{i}".encode() * (i % 7)
                                                      for i in range(rows)])
    return str(directory)


def _write_etrf(directory, shards=(600, 257)):
    directory.mkdir()
    rng = np.random.RandomState(11)
    for i, n in enumerate(shards):
        port_deepfm.write_criteo_etrf(
            str(directory / f"part-{i:05d}.etrf"), rng.rand(n, 13).astype(np.float32),
            rng.randint(0, 1000, (n, 26)).astype(np.int32), rng.randint(0, 2, (n, 1)))
    return str(directory)


READERS = {
    "csv": lambda d: (jax_reader.CSVDataReader(data_dir=_write_csv(d, False)),
                      lambda p: port_reader.CSVDataReader(data_dir=p)),
    "csv_quoted_newlines": lambda d: (jax_reader.CSVDataReader(data_dir=_write_csv(d, True)),
                                      lambda p: port_reader.CSVDataReader(data_dir=p)),
    "textline": lambda d: (jax_reader.TextLineDataReader(data_dir=_write_text(d)),
                           lambda p: port_reader.TextLineDataReader(data_dir=p)),
    "recordio": lambda d: (jax_reader.RecordIODataReader(data_dir=_write_rio(d)),
                           lambda p: port_reader.RecordIODataReader(data_dir=p)),
    "etrf": lambda d: (jax_deepfm.CriteoRecordReader(_write_etrf(d)),
                       lambda p: port_deepfm.CriteoRecordReader(p)),
}


@pytest.mark.parametrize("kind", sorted(READERS))
def test_readers_equal_jax_per_task(tmp_path, kind):
    jax_r, make_port = READERS[kind](tmp_path / "data")
    path = getattr(jax_r, "_data_dir", None) or jax_r._path
    port_r = make_port(path)
    assert port_r.shard_names() == jax_r.shard_names()
    shards = jax_r.create_shards()
    assert port_r.create_shards() == shards
    assert port_r.metadata.column_names == jax_r.metadata.column_names
    fresh = make_port(path)  # a worker's reader: no counting pass, the index rebuilt on demand
    for shard, count in shards.items():
        for start, end in [(0, 64), (5, 70), (200, 300), (count - 3, count + 10), (count, count)]:
            want = list(jax_r.read_records(_task(shard, start, end)))
            for reader in (port_r, fresh):
                got = list(reader.read_records(_task(shard, start, end)))
                assert len(got) == len(want)
                _same(got, want)


LAYOUT = [("dense", np.float32, 13), ("cat", np.int32, 26), ("label", np.uint8, 1),
          ("w", np.float64, 2)]


@pytest.mark.parametrize("copy", [True, False])
def test_record_layout_parse_equals_jax(copy):
    jax_l, port_l = jax_vec.RecordLayout(LAYOUT), port_vec.RecordLayout(LAYOUT)
    assert port_l.record_bytes == jax_l.record_bytes
    rng = np.random.RandomState(0)
    rows = [dict(dense=rng.rand(13), cat=rng.randint(-5, 10**6, 26), label=[i % 2],
                 w=rng.rand(2)) for i in range(300)]
    packed = [port_l.pack(**r) for r in rows]
    assert packed == [jax_l.pack(**r) for r in rows]
    buf = np.frombuffer(b"".join(packed), np.uint8)
    lengths = np.full(len(rows), port_l.record_bytes, np.uint32)
    got, want = port_l.parse_buffer(buf, lengths, copy=copy), jax_l.parse_buffer(buf, lengths,
                                                                                  copy=copy)
    _same(got, want)
    assert got["cat"].flags.writeable == want["cat"].flags.writeable
    _same(port_l.parse_batch(packed), jax_l.parse_batch(packed))
    for layout in (port_l, jax_l):
        with pytest.raises(ValueError, match="fixed-width"):
            layout.parse_buffer(buf, lengths[1:])
        with pytest.raises(ValueError, match="multiple of the record width"):
            layout.parse_buffer(buf[:-1])


def _fake_client(package):
    class FakeTableClient(package.TableClient):
        def __init__(self):
            self.rows = [[i, f"v{i}"] for i in range(100)]
            self.read_calls = []

        def row_count(self, table, partition):
            return len(self.rows)

        def read_rows(self, table, partition, start, count, columns):
            self.read_calls.append((start, count, tuple(columns)))
            yield from self.rows[start:start + count]

        def column_names(self, table):
            return ["a", "b"]

    return FakeTableClient()


@pytest.mark.parametrize("kwargs", [dict(table="mytable"), dict(data_dir="odps://mytable"),
                                    dict(table="t", partition="dt=20260730", columns="b;a")])
def test_odps_reader_with_a_fake_client_equals_jax(kwargs):
    readers = [package.ODPSDataReader(client=_fake_client(package), **kwargs)
               for package in (jax_odps, port_odps)]
    jax_r, port_r = readers
    assert port_r.shard_names() == jax_r.shard_names()
    assert port_r.create_shards() == jax_r.create_shards()
    assert port_r.metadata.column_names == jax_r.metadata.column_names
    shard = port_r.shard_names()[0]
    for start, end in [(40, 45), (7, 7), (-3, 4), (98, 120)]:
        assert list(port_r.read_records(_task(shard, start, end))) == \
            list(jax_r.read_records(_task(shard, start, end)))
    assert port_r._client.read_calls == jax_r._client.read_calls


def test_odps_reader_without_client_raises_as_jax(monkeypatch):
    for var in ("ODPS_ACCESS_ID", "ODPS_ACCESS_KEY", "ODPS_PROJECT_NAME"):
        monkeypatch.delenv(var, raising=False)
    for package in (jax_odps, port_odps):
        with pytest.raises(ValueError, match="ODPS credentials"):
            package.ODPSDataReader(table="mytable")
        with pytest.raises(ValueError, match="table name"):
            package.ODPSDataReader(client=_fake_client(package))
    for package in (jax_odps, port_odps):  # credentials, but no SDK on this machine
        with pytest.raises(RuntimeError, match="odps"):
            package.ODPSDataReader(table="t", access_id="i", access_key="k", project="p")


def _origins(tmp_path):
    _write_csv(tmp_path / "csvdir", False)
    _write_text(tmp_path / "textdir")
    _write_rio(tmp_path / "riodir")
    _write_etrf(tmp_path / "etrfdir", shards=(10,))
    return [str(tmp_path / "csvdir"), str(tmp_path / "csvdir" / "a.csv"),
            str(tmp_path / "textdir"), str(tmp_path / "riodir"),
            "recordio:" + str(tmp_path / "riodir"), "textline:" + str(tmp_path / "csvdir"),
            "csv:" + str(tmp_path / "csvdir" / "*.csv"), str(tmp_path / "etrfdir"),
            "recordio:" + str(tmp_path / "etrfdir"),
            str(tmp_path / "etrfdir" / "part-00000.etrf"), "synthetic://criteo?n=32&vocab=9"]


def test_build_data_reader_dispatch_equals_jax(tmp_path):
    from elasticdl_tpu.common import args as jax_args
    from elasticdl_tpu.common.model_utils import load_model_spec as jax_load_model_spec

    argv = ["--model_zoo", "model_zoo", "--model_def", "deepfm.deepfm_functional_api",
            "--model_params", "vocab_size=9"]
    jax_a, port_a = jax_args.parse_master_args(argv), port_args.parse_master_args(argv)
    jax_spec, port_spec = jax_load_model_spec(jax_a), load_model_spec(port_a)
    for origin in _origins(tmp_path):
        want = jax_reader.build_data_reader(jax_a, jax_spec, origin)
        got = port_reader.build_data_reader(port_a, port_spec, origin)
        assert got.create_shards() == want.create_shards(), origin
        if origin.startswith("synthetic"):  # the zoos' own reader classes
            assert isinstance(got, port_reader.AbstractDataReader)
        else:
            assert type(got).__name__ == type(want).__name__, origin
            want = jax_reader.create_data_reader(origin)
            got = port_reader.create_data_reader(origin)
            assert type(got).__name__ == type(want).__name__, origin
