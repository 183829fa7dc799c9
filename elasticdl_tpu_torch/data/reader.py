"""Shard-addressable data readers: the port's copy of the parts of
``elasticdl_tpu/data/reader.py`` the job needs (``AbstractDataReader``
:33, ``NumpyDataReader`` :58, ``build_data_reader`` :475,
``create_data_reader`` :488).

A reader exposes ``create_shards()`` (the master builds the task queue
from it) and ``read_records(task)`` (a worker streams a task's record
range).  The zoo's readers (``zoo/deepfm.py``, ``zoo/transformer_lm.py``
``custom_data_reader``) serve their ``synthetic://`` data; the record
file readers (csv, textline, recordio, ETRF, odps) are not ported.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Iterator

import numpy as np

from elasticdl_tpu_torch.common.params import parse_dict_params

#: Where the record-file readers are queued.
READERS_ITEM = ("ROADMAP.md Queue 1 item 6, what the job slice leaves: the readers "
                "(csv, textline, recordio, ETRF, odps) with the columnar path")

_FILE_READERS = ("csv", "textline", "recordio", "odps")


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
        """Deterministic shard-name listing (workers index the task
        broadcast with it)."""
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


def build_data_reader(args, model_spec, data_path: str):
    """The model's ``custom_data_reader`` wins, else the path decides."""
    reader_params = parse_dict_params(args.data_reader_params)
    if model_spec.custom_data_reader is not None:
        reader = model_spec.custom_data_reader(data_path, **reader_params)
        if reader is not None:
            return reader
    return create_data_reader(data_path, **reader_params)


def create_data_reader(data_origin: str, records_per_task=None, **kwargs):
    """``'reader_type:path'`` or a bare path: every type is a record file
    reader, which the port has not ported yet."""
    reader_type = data_origin.split(":", 1)[0]
    if reader_type not in _FILE_READERS:
        reader_type = "the reader its extension selects"
    raise NotImplementedError(
        f"{data_origin!r} needs {reader_type}, which is not ported: {READERS_ITEM}; "
        "the port's zoo reads synthetic:// data through its custom_data_reader"
    )
