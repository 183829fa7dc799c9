"""The shardable binary record file format ("ETRF"): the port's copy of
``elasticdl_tpu/data/recordfile.py``, byte for byte the same format:

    header:  magic b"ETRF" + u32 version (little-endian)
    record:  u32 payload_length + u32 crc32(payload) + payload bytes
    footer:  u64 record_count + u64 index_offset + magic b"FTRE"
             where index (at index_offset) is record_count u64 file offsets

The index footer makes ``count_records`` and ``read_range`` O(1) seeks,
which is what makes dynamic sharding cheap for the master.  The native
host codec (``elasticdl_tpu_torch/native``, built at first use with the
host C++ compiler) reads the same format and serves ``count_records``,
``read_range`` and ``read_range_buffers`` when it is built; this module's
Python codec serves otherwise, and always when ``ELASTICDL_DISABLE_NATIVE``
is set.  ``codec()`` names the one that serves.  Writers are Python.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List

import numpy as np

MAGIC = b"ETRF"
FOOTER_MAGIC = b"FTRE"
VERSION = 1

_HEADER = struct.Struct("<4sI")       # magic, version
_RECORD_HEAD = struct.Struct("<II")   # length, crc32
_FOOTER = struct.Struct("<QQ4s")      # record_count, index_offset, magic

#: Chunk bounds of ``read_range_buffers`` (the native codec's too): a
#: chunk ends after CHUNK_RECORDS records or CHUNK_BYTES payload bytes.
CHUNK_RECORDS = 4096
CHUNK_BYTES = 128 * 1024 * 1024


class RecordFileError(IOError):
    pass


def _native():
    if os.environ.get("ELASTICDL_DISABLE_NATIVE"):
        return None
    from elasticdl_tpu_torch import native

    return native.record_file()


def codec() -> str:
    """``"native"`` when the native host codec serves this process's
    reads, else ``"python"``."""
    return "native" if _native() is not None else "python"


class Writer:
    def __init__(self, path: str):
        self._file = open(path, "wb")
        self._file.write(_HEADER.pack(MAGIC, VERSION))
        self._offsets: List[int] = []

    def write(self, payload: bytes):
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            raise TypeError("record payload must be bytes")
        payload = bytes(payload)
        self._offsets.append(self._file.tell())
        self._file.write(_RECORD_HEAD.pack(len(payload), zlib.crc32(payload)))
        self._file.write(payload)

    def close(self):
        index_offset = self._file.tell()
        for offset in self._offsets:
            self._file.write(struct.pack("<Q", offset))
        self._file.write(_FOOTER.pack(len(self._offsets), index_offset, FOOTER_MAGIC))
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, records) -> int:
    with Writer(path) as writer:
        count = 0
        for record in records:
            writer.write(record)
            count += 1
    return count


def _read_footer(f) -> tuple:
    f.seek(0, os.SEEK_END)
    size = f.tell()
    if size < _HEADER.size + _FOOTER.size:
        raise RecordFileError("File too small to be an ETRF record file")
    f.seek(size - _FOOTER.size)
    count, index_offset, magic = _FOOTER.unpack(f.read(_FOOTER.size))
    if magic != FOOTER_MAGIC:
        raise RecordFileError("Bad footer magic (truncated or not an ETRF file)")
    return count, index_offset


def _native_call(gen):
    """Run a native codec generator, its ``OSError`` as ``RecordFileError``."""
    try:
        yield from gen
    except RecordFileError:
        raise
    except OSError as e:
        raise RecordFileError(str(e)) from e


def count_records(path: str) -> int:
    native = _native()
    if native is not None:
        try:
            return native.count_records(path)
        except RecordFileError:
            raise
        except OSError as e:
            raise RecordFileError(str(e)) from e
    return _count_records_py(path)


def _count_records_py(path: str) -> int:
    with open(path, "rb") as f:
        magic, _version = _HEADER.unpack(f.read(_HEADER.size))
        if magic != MAGIC:
            raise RecordFileError(f"Bad magic in {path}")
        count, _ = _read_footer(f)
        return count


def read_range(path: str, start: int, end: int) -> Iterator[bytes]:
    """Yield records ``[start, end)``, seeking through the index footer
    (the native codec: one C call per chunk)."""
    native = _native()
    if native is not None:
        yield from _native_call(native.read_range(path, start, end))
        return
    yield from _read_range_py(path, start, end)


def _read_range_py(path: str, start: int, end: int) -> Iterator[bytes]:
    with open(path, "rb") as f:
        magic, _version = _HEADER.unpack(f.read(_HEADER.size))
        if magic != MAGIC:
            raise RecordFileError(f"Bad magic in {path}")
        count, index_offset = _read_footer(f)
        start = max(0, start)
        end = min(end, count)
        if start >= end:
            return
        f.seek(index_offset + 8 * start)
        first_offset = struct.unpack("<Q", f.read(8))[0]
        f.seek(first_offset)
        for _ in range(end - start):
            length, crc = _RECORD_HEAD.unpack(f.read(_RECORD_HEAD.size))
            payload = f.read(length)
            if len(payload) != length:
                raise RecordFileError("Truncated record")
            if zlib.crc32(payload) != crc:
                raise RecordFileError("CRC mismatch (corrupt record)")
            yield payload


def read_all(path: str) -> Iterator[bytes]:
    yield from read_range(path, 0, count_records(path))


def read_range_buffers(path: str, start: int, end: int, max_bytes: int = 0):
    """Yield ``(payloads np.uint8, lengths np.uint32)`` chunks of records
    ``[start, end)``: the payloads back to back in one buffer per chunk,
    no per-record Python object, ready for ``RecordLayout.parse_buffer``.

    ``max_bytes`` replaces the chunk bound: a consumer that concatenates
    the chunks anyway (the columnar task path) passes its whole-task
    budget and gets one chunk.  The Python codec keeps its chunks at
    most ``CHUNK_RECORDS`` records and ``CHUNK_BYTES`` bytes whatever
    ``max_bytes`` asks (it holds a chunk's records as objects before the
    join); consumers handle several chunks."""
    native = _native()
    if native is not None:
        yield from _native_call(native.read_range_buffers(path, start, end,
                                                          max_bytes=max_bytes))
        return
    max_bytes = min(max_bytes or CHUNK_BYTES, CHUNK_BYTES)

    def emit(records):
        buf = np.frombuffer(b"".join(records), np.uint8)
        return buf, np.asarray([len(r) for r in records], np.uint32)

    chunk_records: list = []
    chunk_bytes = 0
    for payload in _read_range_py(path, start, end):
        chunk_records.append(payload)
        chunk_bytes += len(payload)
        if len(chunk_records) >= CHUNK_RECORDS or chunk_bytes >= max_bytes:
            yield emit(chunk_records)
            chunk_records, chunk_bytes = [], 0
    if chunk_records:
        yield emit(chunk_records)
