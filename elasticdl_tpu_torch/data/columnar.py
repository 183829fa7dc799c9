"""The columnar task path: the port's copy of
``elasticdl_tpu/data/columnar.py`` (``ColumnarTask`` :51,
``materialize_columnar_task`` :69, ``training_permutation`` :115).

A task keeps its contract (the records ``[task.start, task.end)``, the
same on every rank for a given task and mode) but travels as columns: a
reader with ``read_columns(task)`` hands columnar chunks straight from
the file codec, the zoo's ``columnar_dataset_fn`` transforms whole
columns (its shuffle included), and the worker's batches are row-range
views.  A reader without ``read_columns`` or a zoo without
``columnar_dataset_fn`` leaves the worker on the per-record path.
"""

from __future__ import annotations

import functools
import inspect
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("data.columnar")

Tree = Any  # nested dict/tuple of np.ndarray, all sharing axis-0 length


def _tree_len(tree: Tree) -> int:
    if isinstance(tree, dict):
        return _tree_len(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _tree_len(tree[0])
    return len(tree)


def _tree_slice(tree: Tree, lo: int, hi: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _tree_slice(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_slice(v, lo, hi) for v in tree)
    return tree[lo:hi]


class ColumnarTask:
    """One task's records as ``(features_tree, labels_or_None)``."""

    def __init__(self, features: Tree, labels: Optional[np.ndarray]):
        self.features = features
        self.labels = labels
        self.n = _tree_len(features)
        if labels is not None and len(labels) != self.n:
            raise ValueError(f"labels length {len(labels)} != features length {self.n}")

    def slice(self, lo: int, hi: int) -> Tuple[Tree, Optional[np.ndarray]]:
        """Row-range views ``[lo, hi)`` (no copies)."""
        return (
            _tree_slice(self.features, lo, hi),
            None if self.labels is None else self.labels[lo:hi],
        )


def task_seed(task) -> int:
    """The seed of a task's transforms: a function of the task's fields
    alone, so every rank draws the same (lockstep collectives need it),
    and different for every task and epoch."""
    return (
        1_000_003 * int(getattr(task, "epoch", 0))
        + 31 * int(getattr(task, "start", 0))
        + int(getattr(task, "end", 0))
    ) % (2**31)


def materialize_columnar_task(reader, task, columnar_dataset_fn: Optional[Callable], mode: str,
                              metadata, parse_pool=None) -> Optional[ColumnarTask]:
    """The task as a ``ColumnarTask``, or None when the reader or the zoo
    lacks the columnar surface (the caller takes the per-record path).
    A ``parse_pool`` (``data/pipeline.ParsePool``) parses the chunks on
    its threads for readers that accept one."""
    read_columns = getattr(reader, "read_columns", None)
    if read_columns is None or columnar_dataset_fn is None:
        return None
    if parse_pool is not None and "parse_pool" in inspect.signature(read_columns).parameters:
        chunks = list(read_columns(task, parse_pool=parse_pool))
    else:
        chunks = list(read_columns(task))
    if not chunks:
        return None
    if len(chunks) == 1:
        columns: Dict[str, np.ndarray] = chunks[0]
    else:
        columns = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    kwargs = {}
    if "seed" in inspect.signature(columnar_dataset_fn).parameters:
        kwargs["seed"] = task_seed(task)
    features, labels = columnar_dataset_fn(columns, mode, metadata, **kwargs)
    return ColumnarTask(features, labels)


def materialize_for_worker(reader, task, columnar_dataset_fn: Callable, mode: str, metadata,
                           stats: dict, logged: set, parse_pool=None) -> Optional[ColumnarTask]:
    """A worker's columnar route for one task: ``materialize_columnar_task``
    with its seconds booked into ``stats`` (``columnar_s``: read, parse
    and transform; ``columnar_transform_s``: the zoo's transform), and
    "Columnar task path engaged" logged the first time a mode (added to
    ``logged``) takes it.  None for an empty task."""
    start = time.monotonic()
    transform_s = 0.0

    @functools.wraps(columnar_dataset_fn)  # keeps the signature's ``seed``
    def timed_fn(*args, **kwargs):
        nonlocal transform_s
        t0 = time.monotonic()
        try:
            return columnar_dataset_fn(*args, **kwargs)
        finally:
            transform_s += time.monotonic() - t0

    columnar = materialize_columnar_task(reader, task, timed_fn, mode, metadata,
                                         parse_pool=parse_pool)
    if columnar is None:
        return None
    stats.update(columnar_s=round(time.monotonic() - start, 6),
                 columnar_transform_s=round(transform_s, 6))
    if mode not in logged:
        logged.add(mode)
        shape = (f" of {list(columnar.features.shape[1:])}"
                 if isinstance(columnar.features, np.ndarray) else "")
        logger.info("Columnar task path engaged (%s, %d rows%s, zero per-record Python)",
                    mode, columnar.n, shape)
    return columnar


def training_permutation(n: int, seed: int = 0) -> np.ndarray:
    """The deterministic full-range shuffle of columnar training
    transforms, the same on every rank."""
    return np.random.RandomState(seed).permutation(n)
