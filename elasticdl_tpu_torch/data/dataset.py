"""A host-side record pipeline: the port's copy of
``elasticdl_tpu/data/dataset.py`` (``Dataset`` :21, ``shuffle`` :57,
``_stack`` :102, ``SequentialRecords`` :112).

The zoo's ``dataset_fn(dataset, mode, metadata)`` returns a transformed
dataset: records stream from the data reader on the host, are parsed,
shuffled (``random.Random(seed)``, the JAX package's draws exactly, so
both packages give one task the same batches) and stacked, and land on
the device as whole batches.
"""

from __future__ import annotations

import random
from typing import Callable, Iterable, Iterator, Optional

import numpy as np


class Dataset:
    """Lazy record pipeline: from_generator -> map -> shuffle -> batch."""

    def __init__(self, source: Callable[[], Iterator]):
        # `source` is a zero-arg callable returning a fresh iterator so the
        # dataset can be re-iterated (e.g. retry of a failed task).
        self._source = source

    @staticmethod
    def from_generator(generator_fn: Callable[[], Iterator]) -> "Dataset":
        return Dataset(generator_fn)

    @staticmethod
    def from_iterable(iterable: Iterable) -> "Dataset":
        materialized = list(iterable) if not isinstance(iterable, (list, tuple)) else iterable
        return Dataset(lambda: iter(materialized))

    def map(self, fn: Callable) -> "Dataset":
        source = self._source

        def mapped():
            for record in source():
                yield fn(record)

        return Dataset(mapped)

    def filter(self, predicate: Callable) -> "Dataset":
        source = self._source

        def filtered():
            for record in source():
                if predicate(record):
                    yield record

        return Dataset(filtered)

    def shuffle(self, buffer_size: int, seed: Optional[int] = None) -> "Dataset":
        source = self._source

        def shuffled():
            rng = random.Random(seed)
            buffer = []
            for record in source():
                buffer.append(record)
                if len(buffer) >= buffer_size:
                    index = rng.randrange(len(buffer))
                    buffer[index], buffer[-1] = buffer[-1], buffer[index]
                    yield buffer.pop()
            rng.shuffle(buffer)
            yield from buffer

        return Dataset(shuffled)

    def batch(self, batch_size: int, drop_remainder: bool = False) -> "Dataset":
        source = self._source

        def batched():
            batch = []
            for record in source():
                batch.append(record)
                if len(batch) == batch_size:
                    yield _stack(batch)
                    batch = []
            if batch and not drop_remainder:
                yield _stack(batch)

        return Dataset(batched)

    def repeat(self, count: int) -> "Dataset":
        source = self._source

        def repeated():
            for _ in range(count):
                yield from source()

        return Dataset(repeated)

    def __iter__(self):
        return self._source()


def _stack(records):
    """Stack a list of examples into a batch, handling nested structures."""
    first = records[0]
    if isinstance(first, tuple):
        return tuple(_stack([r[i] for r in records]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in records]) for k in first}
    return np.stack([np.asarray(r) for r in records])


class SequentialRecords:
    """Bounded-memory sequential access to a dataset's records.  Batch
    ranges advance monotonically (parallel/elastic.iter_local_batch_ranges),
    so a one-pass cursor suffices: records stream from the iterator, only
    the requested slice is resident, and skipped ranges are pulled and
    dropped.  `template()` peeks the first record without consuming it
    (ragged-tail batches need a shape exemplar)."""

    def __init__(self, dataset):
        self._it = iter(dataset)
        self._pending = None  # one-record lookahead (template peek)
        self._template = None  # first record ever seen (shape exemplar)
        self._pos = 0  # absolute index of the next un-consumed record

    def _next(self):
        if self._pending is not None:
            rec, self._pending = self._pending, None
        else:
            rec = next(self._it, None)
        if rec is not None and self._template is None:
            self._template = rec
        return rec

    def template(self):
        """The first record (cached; peeked without consuming if nothing
        has been pulled yet) — empty/ragged batches shape from it."""
        if self._template is None and self._pending is None:
            self._pending = next(self._it, None)
            self._template = self._pending
        if self._template is None:
            # Stacking a None "record" would produce an object-dtype batch
            # and an inscrutable downstream failure; the real problem is a
            # source that yielded nothing for a range its shard metadata
            # claims (short file, reader bug).
            raise ValueError(
                "dataset produced zero records — no batch-shape template "
                "exists (does the reader's shard metadata overstate the "
                "source's rows?)"
            )
        return self._template

    def slice(self, lo: int, hi: int) -> list:
        """Records [lo, hi); requires lo >= last consumed position."""
        if lo < self._pos:
            raise ValueError(
                f"SequentialRecords is one-pass: asked for [{lo},{hi}) "
                f"after position {self._pos}"
            )
        while self._pos < lo:
            if self._next() is None:
                return []
            self._pos += 1
        out = []
        while self._pos < hi:
            rec = self._next()
            if rec is None:
                break
            out.append(rec)
            self._pos += 1
        return out
