"""Shard-addressable data readers: the port's copy of
``elasticdl_tpu/data/reader.py``.

A reader exposes ``create_shards()`` (the master builds the task queue
from it) and ``read_records(task)`` (a worker streams a task's record
range).  Readers: ``NumpyDataReader`` (in-memory arrays),
``CSVDataReader``, ``TextLineDataReader``, ``RecordIODataReader`` and
``FixedWidthEtrfReader`` (ETRF shards of fixed-width records with the
columnar surface ``read_columns``, ``data/columnar.py``) over
``data/recordfile.py``, and the ODPS table reader
(``data/odps_reader.py``).  The zoo's ``custom_data_reader`` serves its
``synthetic://`` data and its ETRF layouts (``zoo/deepfm.py``).
``etrf_per_record_reads()`` counts the tasks this process read record by
record through an ETRF reader, so a job can show that its columnar path
served every task.
"""

from __future__ import annotations

import csv
import glob
import os
from abc import ABC, abstractmethod
from typing import Dict, Iterator

import numpy as np

from elasticdl_tpu_torch.common.params import parse_dict_params
from elasticdl_tpu_torch.data import recordfile

#: Tasks read record by record through ``FixedWidthEtrfReader.read_records``.
_etrf_per_record_reads = 0


def etrf_per_record_reads() -> int:
    """How many tasks this process has read through the per-record
    ``read_records`` of an ETRF reader (the columnar path reads none)."""
    return _etrf_per_record_reads


class Metadata:
    """Feed metadata handed to the zoo's ``dataset_fn``."""

    def __init__(self, column_names=None, column_dtypes=None):
        self.column_names = column_names or []
        self.column_dtypes = column_dtypes or {}


class AbstractDataReader(ABC):
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @abstractmethod
    def create_shards(self) -> Dict[str, object]:
        """shard_name -> record count (or (start, count))."""

    @abstractmethod
    def read_records(self, task) -> Iterator:
        """Yield raw records for task.shard_name[task.start:task.end]."""

    def shard_names(self):
        """Deterministic shard-name listing without counting records
        (workers index the task broadcast with it); readers whose
        counting is expensive override it."""
        return list(self.create_shards().keys())

    @property
    def metadata(self) -> Metadata:
        return Metadata()


class NumpyDataReader(AbstractDataReader):
    """In-memory ``(features, labels)`` arrays; records are ``(feature_row,
    label_row)`` tuples."""

    def __init__(self, features: np.ndarray, labels: np.ndarray, shard_name="memory", **kwargs):
        super().__init__(**kwargs)
        if len(features) != len(labels):
            raise ValueError("features and labels must have equal length")
        self._features = features
        self._labels = labels
        self._shard_name = shard_name

    def create_shards(self):
        return {self._shard_name: len(self._features)}

    def read_records(self, task):
        for i in range(task.start, min(task.end, len(self._features))):
            yield (self._features[i], self._labels[i])


class _ByteLines:
    """Line iterator over a binary file that tracks bytes consumed — the
    probe the offset index uses to learn where record N starts."""

    def __init__(self, f):
        self._f = f
        self.consumed = f.tell()

    def __iter__(self):
        return self

    def __next__(self):
        line = self._f.readline()
        if not line:
            raise StopIteration
        self.consumed += len(line)
        return line.decode("utf-8")


class _StridedOffsetIndex:
    """Byte offset of every STRIDE-th record per file, built during the
    counting pass `create_shards` already pays.  A task seek becomes
    O(STRIDE + records_per_task) instead of O(file): a scan from byte 0
    for every task would cost O(n^2) per epoch on one big file.  Entries
    invalidate on (mtime, size) change."""

    STRIDE = 64

    def __init__(self):
        self._entries: Dict[str, tuple] = {}

    @staticmethod
    def _stamp(path):
        stat = os.stat(path)
        return (stat.st_mtime_ns, stat.st_size)

    def put(self, path, count, offsets):
        self._entries[path] = (self._stamp(path), count, offsets)

    def get(self, path):
        entry = self._entries.get(path)
        if entry is None or entry[0] != self._stamp(path):
            return None
        return entry[1], entry[2]

    def position(self, path, start):
        """(byte_offset, records_to_skip) to reach record `start`, or
        None when the file isn't indexed (or changed since)."""
        entry = self.get(path)
        if entry is None or not entry[1]:
            return None
        _count, offsets = entry
        bucket = min(start // self.STRIDE, len(offsets) - 1)
        return offsets[bucket], start - bucket * self.STRIDE


def _resolve_position(index, scan, task):
    """Index lookup with self-healing: a miss (index never built — e.g. a
    Local-mode worker whose shard list came from the master — or
    invalidated by an mtime change) triggers ONE rebuilding scan when the
    task starts deep enough in the file that streaming from the top would
    cost more than the scan amortizes over subsequent tasks.  Shallow
    tasks just stream (no full-file pre-scan before row 0)."""
    position = index.position(task.shard_name, task.start)
    if position is None and task.start >= 4 * _StridedOffsetIndex.STRIDE:
        scan(task.shard_name)
        position = index.position(task.shard_name, task.start)
    return position


class CSVDataReader(AbstractDataReader):
    """One shard per CSV file; a record is a list of string fields.

    Record offsets index PARSED rows (quoted fields may contain newlines),
    probed through _ByteLines while csv.reader pulls lines — csv consumes
    lazily, so bytes-consumed after row i is exactly row i+1's offset.
    """

    def __init__(self, data_dir: str = "", sep: str = ",", with_header: bool = True, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir or kwargs.get("data_path", "")
        self._sep = sep
        self._with_header = with_header
        self._columns = None
        self._index = _StridedOffsetIndex()

    def _files(self):
        if os.path.isdir(self._data_dir):
            return sorted(glob.glob(os.path.join(self._data_dir, "*.csv")))
        return sorted(glob.glob(self._data_dir))

    def shard_names(self):
        # Shard name == file path: workers list shards without the
        # counting scan create_shards pays (only the master needs counts).
        return self._files()

    def _scan(self, path):
        """One pass: record count + strided record offsets (+ header)."""
        with open(path, "rb") as f:
            lines = _ByteLines(f)
            reader = csv.reader(lines, delimiter=self._sep)
            if self._with_header:
                header = next(reader, None)
                if header is not None and self._columns is None:
                    self._columns = header
            count = 0
            offsets = []
            mark = lines.consumed
            for _row in reader:
                if count % _StridedOffsetIndex.STRIDE == 0:
                    offsets.append(mark)
                count += 1
                mark = lines.consumed
        self._index.put(path, count, offsets)
        return count

    def create_shards(self):
        return {path: self._scan(path) for path in self._files()}

    def read_records(self, task):
        position = self._resolve_position(task)
        with open(task.shard_name, "rb") as f:
            if position is not None:
                offset, skip = position
                f.seek(offset)
            else:
                # Unindexed near the top of the file: stream, bounded by
                # task.end — no full-file pre-scan before row 0.
                skip = task.start
            reader = csv.reader(_ByteLines(f), delimiter=self._sep)
            if position is None and self._with_header:
                next(reader, None)
            want = task.end - task.start
            for index, row in enumerate(reader):
                if index < skip:
                    continue
                if index - skip >= want:
                    break
                yield row

    def _resolve_position(self, task):
        return _resolve_position(self._index, self._scan, task)

    @property
    def metadata(self):
        if (
            self._columns is None
            and self._with_header
            and not getattr(self, "_header_scanned", False)
        ):
            # Header row from the first NON-EMPTY file — never the
            # counting scan create_shards pays (workers read metadata at
            # boot).  Scanned-flag caches the no-header outcome so empty
            # datasets don't re-open files on every access.
            self._header_scanned = True
            for path in self._files():
                with open(path, "rb") as f:
                    header = next(
                        csv.reader(_ByteLines(f), delimiter=self._sep), None
                    )
                if header:
                    self._columns = header
                    break
        return Metadata(column_names=self._columns)


class TextLineDataReader(AbstractDataReader):
    """One shard per text file; a record is a line (str, no newline).

    Strided line-offset index (built during the counting pass) gives
    O(STRIDE + range) task seeks, same as the CSV reader.
    """

    def __init__(self, data_dir: str = "", **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir or kwargs.get("data_path", "")
        self._index = _StridedOffsetIndex()

    def _files(self):
        if os.path.isdir(self._data_dir):
            return sorted(
                path
                for name in os.listdir(self._data_dir)
                # Skip markers (_SUCCESS), hidden files, and subdirectories.
                if not name.startswith(("_", "."))
                and os.path.isfile(path := os.path.join(self._data_dir, name))
            )
        return sorted(p for p in glob.glob(self._data_dir) if os.path.isfile(p))

    def shard_names(self):
        return self._files()

    def _scan(self, path):
        with open(path, "rb") as f:
            count = 0
            offsets = []
            mark = 0
            for line in f:
                if count % _StridedOffsetIndex.STRIDE == 0:
                    offsets.append(mark)
                count += 1
                mark += len(line)
        self._index.put(path, count, offsets)
        return count

    def create_shards(self):
        return {path: self._scan(path) for path in self._files()}

    def read_records(self, task):
        position = _resolve_position(self._index, self._scan, task)
        with open(task.shard_name, "rb") as f:
            if position is not None:
                offset, skip = position
                f.seek(offset)
            else:
                # Unindexed near the top: stream, bounded by task.end.
                skip = task.start
            want = task.end - task.start
            for index, line in enumerate(f):
                if index < skip:
                    continue
                if index - skip >= want:
                    break
                yield line.decode("utf-8").rstrip("\r\n")


class RecordIODataReader(AbstractDataReader):
    """Shardable binary record files (``.rio``/``.recordio`` in ETRF
    format), read through ``data/recordfile.py`` (the native host codec
    when built, else the Python codec); a record is its payload bytes."""

    def __init__(self, data_dir: str = "", **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir or kwargs.get("data_path", "")

    def _files(self):
        if os.path.isdir(self._data_dir):
            return sorted(
                os.path.join(self._data_dir, name)
                for name in os.listdir(self._data_dir)
                if name.endswith((".rio", ".recordio"))
            )
        return sorted(p for p in glob.glob(self._data_dir) if os.path.isfile(p))

    def shard_names(self):
        return self._files()

    def create_shards(self):
        return {path: recordfile.count_records(path) for path in self._files()}

    def read_records(self, task):
        yield from recordfile.read_range(task.shard_name, task.start, task.end)


def is_etrf_dir(path: str) -> bool:
    """True when `path` is a directory holding .etrf shard files (the
    reference's RecordIO-directory dataset layout)."""
    return os.path.isdir(path) and any(
        name.endswith(".etrf") for name in os.listdir(path)
    )


class FixedWidthEtrfReader(AbstractDataReader):
    """ETRF shards of fixed-width binary records with the vectorized
    columnar surface (data/vectorized.py + data/columnar.py).

    `path` is one .etrf file or a DIRECTORY of them — the reference's
    RecordIO-directory layout (†data/reader/recordio_reader.py): each
    file is one shard in the master's dynamic-sharding queue, tasks
    address [start, end) WITHIN their shard.  Subclasses supply the
    record layout and the per-row assembly for the per-record fallback
    path; the columnar fast path needs nothing else."""

    #: subclasses whose columnar consumers immediately gather into fresh
    #: arrays (the image crop) set False to skip the defensive copy.
    copy_columns = True
    #: per-chunk payload budget for the columnar path; 0 = the codec's
    #: default (128 MB).  Readers of large records raise it so a whole
    #: task arrives as ONE chunk — skipping the downstream concatenate
    #: and halving peak memory (data/recordfile.read_range_buffers).
    columnar_chunk_bytes = 0

    def __init__(self, path: str, **kwargs):
        super().__init__(**kwargs)
        self._path = path

    def _files(self):
        if os.path.isdir(self._path):
            files = sorted(
                os.path.join(self._path, name)
                for name in os.listdir(self._path)
                if name.endswith(".etrf")
            )
            if not files:
                raise ValueError(f"no .etrf shards under {self._path}")
            return files
        return [self._path]

    def shard_names(self):
        return self._files()

    def create_shards(self):
        return {p: recordfile.count_records(p) for p in self._files()}

    def layout(self):
        """The RecordLayout shared by every shard."""
        raise NotImplementedError

    def _task_path(self, task) -> str:
        # Tasks carry their shard (file) name; harnesses that fake a
        # task over a SINGLE-file reader may omit it.  A directory
        # reader must never guess — serving shard 0 for every task
        # would be silently wrong data.
        path = getattr(task, "shard_name", None)
        if path:
            return path
        files = self._files()
        if len(files) > 1:
            raise ValueError(
                "task has no shard_name but this reader holds "
                f"{len(files)} shards under {self._path}"
            )
        return files[0]

    def record_count(self, task) -> int:
        """Record count of one task WITHOUT materializing anything: a
        task is a [start, end) range by contract, so the count is pure
        arithmetic.  The parse pool's bounded read-ahead (data/
        pipeline.py) sizes its lookahead from this instead of listing
        an epoch's records."""
        return max(0, int(task.end) - int(task.start))

    def read_columns(self, task, parse_pool=None):
        """Columnar chunks for one task.  With a `parse_pool`
        (data/pipeline.ParsePool), `parse_buffer` for chunk k+1..k+n
        runs on pool threads while the consumer transforms chunk k —
        numpy releases the GIL for the big view-copy, so the parse
        scales with host cores.  Ordering is deterministic either way
        (the pool reassembles by submission index)."""
        layout = self.layout()
        buffers = recordfile.read_range_buffers(
            self._task_path(task), task.start, task.end,
            max_bytes=self.columnar_chunk_bytes,
        )
        if parse_pool is not None and getattr(parse_pool, "workers", 0):
            yield from parse_pool.imap(
                lambda chunk: layout.parse_buffer(
                    chunk[0], chunk[1], copy=self.copy_columns
                ),
                buffers,
            )
            return
        for buf, lengths in buffers:
            yield layout.parse_buffer(
                buf, lengths, copy=self.copy_columns
            )

    def _row(self, cols, i):
        """One record of a columnar chunk -> the per-record dataset
        item (the reference-parity fallback path)."""
        raise NotImplementedError

    def read_records(self, task):
        global _etrf_per_record_reads
        _etrf_per_record_reads += 1
        for cols in self.read_columns(task):
            n = len(next(iter(cols.values())))
            for i in range(n):
                yield self._row(cols, i)



def _odps_reader(**kwargs):
    from elasticdl_tpu_torch.data.odps_reader import ODPSDataReader

    return ODPSDataReader(**kwargs)


_READERS = {
    "numpy": NumpyDataReader,
    "csv": CSVDataReader,
    "textline": TextLineDataReader,
    "recordio": RecordIODataReader,
    "odps": _odps_reader,
}


def build_data_reader(args, model_spec, data_path: str):
    """The model's ``custom_data_reader`` wins, else the path decides.
    Shared by the master and the workers."""
    reader_params = parse_dict_params(args.data_reader_params)
    if model_spec.custom_data_reader is not None:
        reader = model_spec.custom_data_reader(data_path, **reader_params)
        if reader is not None:
            return reader
    return create_data_reader(data_path, **reader_params)


def create_data_reader(data_origin: str, records_per_task=None, **kwargs):
    """``data_origin`` is ``'reader_type:path'`` or a bare path, whose
    extension picks the reader (``.csv`` csv, ``.rio``/``.recordio``
    recordio, else textline; a directory by its first entry)."""
    if ":" in data_origin and data_origin.split(":", 1)[0] in _READERS:
        reader_type, path = data_origin.split(":", 1)
    else:
        path = data_origin
        sample = path
        if os.path.isdir(path):
            entries = sorted(os.listdir(path))
            sample = entries[0] if entries else ""
        if sample.endswith(".csv"):
            reader_type = "csv"
        elif sample.endswith((".rio", ".recordio")):
            reader_type = "recordio"
        else:
            reader_type = "textline"
    return _READERS[reader_type](data_dir=path, **kwargs)
