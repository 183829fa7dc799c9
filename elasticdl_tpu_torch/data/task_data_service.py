"""A task's dataset: the port of ``elasticdl_tpu/data/task_data_service.py``
(``TaskDataService`` :13-51).

The task's record range streams from the reader through the zoo's
``dataset_fn`` (parse, shuffle) and is batched by the worker's
minibatch size, on the port's ``Dataset``; with a lookahead the batches
come through a bounded ``Prefetcher`` thread, whose ``close()`` the
caller owns.
"""

from __future__ import annotations

from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.pipeline import Prefetcher


class TaskDataService:
    def __init__(self, data_reader, dataset_fn, metadata=None):
        self._reader = data_reader
        self._dataset_fn = dataset_fn
        self._metadata = metadata if metadata is not None else data_reader.metadata

    @property
    def reader(self):
        return self._reader

    def get_dataset(self, task, mode: str) -> Dataset:
        reader = self._reader
        dataset = Dataset.from_generator(lambda: reader.read_records(task))
        return self._dataset_fn(dataset, mode, self._metadata)

    def get_batches(self, task, mode: str, batch_size: int, lookahead: int = 0):
        """The task's minibatch iterator; ``lookahead > 0`` wraps it in a
        ``Prefetcher`` holding at most that many batches."""
        batches = iter(self.get_dataset(task, mode).batch(batch_size))
        if lookahead <= 0:
            return batches
        return Prefetcher(batches, max_inflight=lookahead)
