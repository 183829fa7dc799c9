"""The columnar task path of the port (``data/columnar.py``, the zoo's
``columnar_dataset_fn``, the worker's columnar route) against the JAX
package's on the same ETRF files: the materialised task bit for bit,
the worker's batches ``(features, labels, mask)`` of worlds of 1, 2 and 3
against the JAX worker's ``_local_batches`` of each rank (the port's
worker assembles the global batch, every rank's slice in rank order),
and a requeued task replaying the same batches."""

import types

import numpy as np
import pytest

from elasticdl_tpu.data import columnar as jax_columnar
from elasticdl_tpu.data import pipeline as jax_pipeline
from elasticdl_tpu.parallel import elastic as jax_elastic
from elasticdl_tpu.worker.collective_worker import CollectiveWorker as JaxCollectiveWorker
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.data import columnar as port_columnar
from elasticdl_tpu_torch.data import pipeline as port_pipeline
from elasticdl_tpu_torch.data.reader import etrf_per_record_reads
from elasticdl_tpu_torch.parallel import elastic as port_elastic
from elasticdl_tpu_torch.worker.collective_worker import CollectiveWorker
from elasticdl_tpu_torch.zoo import deepfm as port_deepfm
from model_zoo.deepfm import deepfm_functional_api as jax_deepfm

SHARD, PER_TASK, MB = 600, 256, 32


@pytest.fixture(scope="module")
def etrf(tmp_path_factory):
    directory = tmp_path_factory.mktemp("etrf")
    rng = np.random.RandomState(5)
    for i, n in enumerate((SHARD, 131)):
        port_deepfm.write_criteo_etrf(
            str(directory / f"part-{i:05d}.etrf"), rng.rand(n, 13).astype(np.float32),
            rng.randint(0, 1000, (n, 26)).astype(np.int32), rng.randint(0, 2, (n, 1)))
    return str(directory)


def _task(shard, start, end, epoch=0, task_id=1, task_type=msg.TRAINING):
    return types.SimpleNamespace(task_id=task_id, shard_name=shard, start=start, end=end,
                                 epoch=epoch, type=task_type, model_version=-1)


def _tasks(etrf):
    shard = port_deepfm.CriteoRecordReader(etrf).shard_names()[0]
    return [_task(shard, lo, min(lo + PER_TASK, SHARD)) for lo in range(0, SHARD, PER_TASK)]


def _bits_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _bits_equal(got[key], want[key])
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", ["training", "evaluation"])
@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("workers", [0, 2])
def test_materialized_task_equals_jax(etrf, mode, epoch, workers):
    jax_reader, port_reader = jax_deepfm.CriteoRecordReader(etrf), \
        port_deepfm.CriteoRecordReader(etrf)
    jax_pool, port_pool = jax_pipeline.ParsePool(workers), port_pipeline.ParsePool(workers)
    try:
        for task in _tasks(etrf):
            task.epoch = epoch
            assert port_columnar.task_seed(task) == (
                1_000_003 * epoch + 31 * task.start + task.end) % (2**31)
            want = jax_columnar.materialize_columnar_task(
                jax_reader, task, jax_deepfm.columnar_dataset_fn, mode, None, parse_pool=jax_pool)
            got = port_columnar.materialize_columnar_task(
                port_reader, task, port_deepfm.columnar_dataset_fn, mode, None,
                parse_pool=port_pool)
            assert got.n == want.n == task.end - task.start
            _bits_equal(got.features, want.features)
            _bits_equal(got.labels, want.labels)
            _bits_equal(got.slice(7, 40)[0], want.slice(7, 40)[0])
    finally:
        jax_pool.close()
        port_pool.close()
    # Small chunks: several per task, joined as in JAX.
    port_reader.columnar_chunk_bytes = jax_reader.columnar_chunk_bytes = 157 * 50
    task = _tasks(etrf)[0]
    assert len(list(port_reader.read_columns(task))) > 1
    _bits_equal(
        port_columnar.materialize_columnar_task(port_reader, task,
                                                port_deepfm.columnar_dataset_fn, mode, None).labels,
        jax_columnar.materialize_columnar_task(jax_reader, task, jax_deepfm.columnar_dataset_fn,
                                               mode, None).labels)
    # Without the columnar surface on either side: the per-record route.
    assert port_columnar.materialize_columnar_task(port_reader, task, None, mode, None) is None
    assert port_columnar.training_permutation(10, 4).tolist() == \
        jax_columnar.training_permutation(10, 4).tolist()


def _port_worker(etrf, world_size, pipeline=None):
    spec = types.SimpleNamespace(columnar_dataset_fn=port_deepfm.columnar_dataset_fn,
                                 dataset_fn=port_deepfm.dataset_fn)
    return CollectiveWorker(master_client=None, model_spec=spec,
                            data_reader=port_deepfm.CriteoRecordReader(etrf),
                            minibatch_size=MB,
                            world=port_elastic.WorldInfo(0, world_size, 1, ""),
                            trainer=types.SimpleNamespace(), pipeline=pipeline)


def _jax_batches(etrf, task, mode, rank, world_size):
    """The JAX worker's ``_local_batches`` of one rank (a worker with only
    the fields that method reads)."""
    from elasticdl_tpu.proto import elasticdl_pb2 as pb

    worker = object.__new__(JaxCollectiveWorker)
    reader = jax_deepfm.CriteoRecordReader(etrf)
    worker._readers = {pb.TRAINING: reader, pb.EVALUATION: reader}
    worker._spec = types.SimpleNamespace(columnar_dataset_fn=jax_deepfm.columnar_dataset_fn)
    worker._metadata, worker._parse_pool, worker._mb, worker._block = None, None, MB, MB
    worker._world = jax_elastic.WorldInfo(rank, world_size, 1, "")
    worker._columnar_logged = False
    return list(worker._local_batches(task, mode))


@pytest.mark.parametrize("world_size", [1, 2, 3])
@pytest.mark.parametrize("mode", ["training", "evaluation"])
def test_worker_columnar_batches_equal_jax_ranks(etrf, world_size, mode):
    worker = _port_worker(etrf, world_size)
    reads = etrf_per_record_reads()
    for task in _tasks(etrf):
        got = list(worker._local_batches(task, mode))
        ranks = [_jax_batches(etrf, task, mode, r, world_size) for r in range(world_size)]
        assert len(got) == len(ranks[0]) == -(-(task.end - task.start) // (MB * world_size))
        for step, (features, labels, mask, global_real) in enumerate(got):
            parts = [rank[step] for rank in ranks]
            _bits_equal(features, {k: np.concatenate([p[0][k] for p in parts])
                                   for k in features})
            _bits_equal(labels, np.concatenate([p[1] for p in parts]))
            _bits_equal(mask, np.concatenate([p[2] for p in parts]))
            assert global_real == parts[0][3] and mask.sum() == global_real
        assert set(worker._host_seconds) == {"columnar_s", "columnar_transform_s"}
    assert worker._columnar_logged == {mode}
    assert etrf_per_record_reads() == reads  # the columnar route reads none record by record


def test_requeued_task_replays_the_same_batches(etrf):
    pipeline = port_pipeline.PipelineConfig(mode="async", parse_workers=2)
    worker = _port_worker(etrf, 2, pipeline)
    try:
        task = _tasks(etrf)[1]
        first = list(worker._local_batches(task, "training"))
        # The master requeues the task: a fresh id, the same fields.
        again = list(worker._local_batches(_task(task.shard_name, task.start, task.end,
                                                 task_id=9), "training"))
        for a, b in zip(first, again, strict=True):
            _bits_equal(a[0], b[0])
            _bits_equal(a[1], b[1])
        # Another epoch draws another order of the same records.
        later = list(worker._local_batches(_task(task.shard_name, task.start, task.end,
                                                 epoch=1), "training"))
        assert not np.array_equal(first[0][1], later[0][1]) or not np.array_equal(
            first[0][0]["cat"], later[0][0]["cat"])
        sums = [np.sort(np.concatenate([b[0]["dense"][b[2] > 0].sum(1) for b in run]))
                for run in (first, later)]
        np.testing.assert_array_equal(sums[0], sums[1])
    finally:
        worker._parse_pool.close()
