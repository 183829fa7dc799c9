"""The port's ETRF codec (``elasticdl_tpu_torch/data/recordfile.py``, the
native host codec ``elasticdl_tpu_torch/native``) against the JAX
package's (``elasticdl_tpu/data/recordfile.py``): the same bytes on disk,
each package reading the other's files, the same ranges and chunks, the
same errors, with each package's native codec and with its Python codec
(``ELASTICDL_DISABLE_NATIVE``)."""

import os
import zlib

import numpy as np
import pytest

from elasticdl_tpu.data import recordfile as jax_rf
from elasticdl_tpu_torch import native as port_native
from elasticdl_tpu_torch.data import recordfile as port_rf


def _records(kind: str, n: int = 3000):
    rng = np.random.RandomState(7)
    if kind == "empty":
        return []
    if kind == "fixed":  # Criteo-width records
        return [rng.bytes(157) for _ in range(n)]
    lengths = rng.randint(0, 600, size=n)
    lengths[::97] = 0  # empty payloads too
    return [rng.bytes(int(k)) for k in lengths]


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Each package's native codec, or both packages' Python codecs."""
    if request.param == "python":
        monkeypatch.setenv("ELASTICDL_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("ELASTICDL_DISABLE_NATIVE", raising=False)
        assert port_native.record_file() is not None, "g++ builds the port's codec here"
    assert port_rf.codec() == request.param
    return request.param


@pytest.mark.parametrize("kind", ["empty", "fixed", "variable"])
def test_port_writes_the_jax_bytes(tmp_path, kind):
    records = _records(kind)
    jax_path, port_path = tmp_path / "jax.etrf", tmp_path / "port.etrf"
    assert jax_rf.write_records(str(jax_path), records) == len(records)
    assert port_rf.write_records(str(port_path), records) == len(records)
    assert port_path.read_bytes() == jax_path.read_bytes()
    native_path = tmp_path / "native.etrf"
    assert port_native.record_file().write_records(str(native_path), records) == len(records)
    assert native_path.read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("kind", ["fixed", "variable"])
def test_each_package_reads_the_others_files(tmp_path, codec, kind):
    records = _records(kind)
    jax_path, port_path = str(tmp_path / "jax.etrf"), str(tmp_path / "port.etrf")
    jax_rf.write_records(jax_path, records)
    port_rf.write_records(port_path, records)
    assert list(port_rf.read_all(jax_path)) == records
    assert list(jax_rf.read_all(port_path)) == records
    assert port_rf.count_records(jax_path) == jax_rf.count_records(port_path) == len(records)


RANGES = [(0, 0), (5, 5), (9, 3), (2990, 4000), (4000, 5000), (-4, 10), (0, 3000), (100, 2177)]


@pytest.mark.parametrize("start,end", RANGES)
@pytest.mark.parametrize("max_bytes", [0, 1000, 157 * 64 + 1])
def test_ranges_and_chunks_equal_jax(tmp_path, codec, start, end, max_bytes):
    path = str(tmp_path / "r.etrf")
    records = _records("variable")
    jax_rf.write_records(path, records)
    assert port_rf.count_records(path) == jax_rf.count_records(path)
    assert list(port_rf.read_range(path, start, end)) == list(jax_rf.read_range(path, start, end))
    got = list(port_rf.read_range_buffers(path, start, end, max_bytes=max_bytes))
    want = list(jax_rf.read_range_buffers(path, start, end, max_bytes=max_bytes))
    assert len(got) == len(want)
    for (gb, gl), (wb, wl) in zip(got, want):
        assert gb.dtype == wb.dtype == np.uint8 and gl.dtype == wl.dtype == np.uint32
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)
    joined = b"".join(bytes(b) for b, _ in got)
    assert joined == b"".join(records[max(0, start):min(end, len(records))])


def _torn_footer(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-3])


def _bad_crc(path):
    data = bytearray(open(path, "rb").read())
    data[8 + 8 + 5] ^= 0xFF  # a payload byte of record 0
    open(path, "wb").write(bytes(data))


def _bad_magic(path):
    data = bytearray(open(path, "rb").read())
    data[0:4] = b"XXXX"
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("damage", [_torn_footer, _bad_crc, _bad_magic])
def test_damaged_files_raise_as_jax(tmp_path, codec, damage):
    path = str(tmp_path / "d.etrf")
    jax_rf.write_records(path, _records("fixed", 50))
    damage(path)
    errors = []
    for package in (jax_rf, port_rf):
        with pytest.raises(IOError) as err:
            list(package.read_range(path, 0, 50))
        assert type(err.value).__name__ == "RecordFileError"
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    if damage is _bad_crc:
        assert "CRC mismatch" in errors[1]
        assert port_rf.count_records(path) == 50  # the footer is intact


def test_native_codec_equals_python_codec(tmp_path, monkeypatch):
    monkeypatch.delenv("ELASTICDL_DISABLE_NATIVE", raising=False)
    native = port_native.record_file()
    assert native is not None and os.path.exists(port_native.SO_PATH)
    records = _records("variable")
    path = str(tmp_path / "n.etrf")
    port_rf.write_records(path, records)
    for start, end in RANGES:
        want = list(port_rf._read_range_py(path, start, end))
        assert list(native.read_range(path, start, end)) == want
        chunks = list(native.read_range_buffers(path, start, end))
        assert [int(n) for _, lengths in chunks for n in lengths] == [len(r) for r in want]
        assert all(len(lengths) <= native.CHUNK_RECORDS for _, lengths in chunks)
    assert native.count_records(path) == port_rf._count_records_py(path) == len(records)
    # One chunk for a whole-task budget, its records where they belong.
    (buf, lengths), = native.read_range_buffers(path, 0, len(records), max_bytes=1 << 30)
    offsets = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    assert all(zlib.crc32(bytes(buf[offsets[i]:offsets[i + 1]])) == zlib.crc32(records[i])
               for i in range(0, len(records), 101))
    monkeypatch.setenv("ELASTICDL_DISABLE_NATIVE", "1")
    assert port_rf.codec() == "python"
