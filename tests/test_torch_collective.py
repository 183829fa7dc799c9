"""The port's control-plane collectives (``parallel/collective.py``:
``allreduce``, ``broadcast``, ``barrier``) against the JAX package's
``CollectiveCommunicator`` semantics, on the CPU.

- One process (JAX's CPU mesh of 8 virtual devices, the port's
  in-process mesh and no mesh): the same values and dtypes from both
  packages, exactly (each process contributes one value, whatever slots
  it drives); an unknown op raises ``ValueError`` in both.
- The gloo world of 4 ranks (``tests/torch_mesh_worker.py``): MEAN and
  SUM of one value per rank, ``barrier``, the ``ValueError``; a rank
  SIGKILLed while the others are in an ``allreduce`` gives them
  ``FAILED`` (no exception) within the group's timeout.
"""

import numpy as np
import pytest

import torch_mesh_worker as worker
from elasticdl_tpu.parallel import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.collective import CollectiveCommunicator as JaxCommunicator
from elasticdl_tpu_torch.parallel.collective import CollectiveCommunicator, CollectiveResult
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices

VALUES = [np.array([2.0, 4.0]), np.array([1.0], np.float32), np.array([3, 5], np.int32),
          np.float32(7.5)]


@pytest.mark.parametrize("mesh", ["none", "in_process"])
@pytest.mark.parametrize("op", ["MEAN", "SUM"])
def test_one_process_allreduce_matches_jax(mesh, op):
    port = CollectiveCommunicator(
        None if mesh == "none" else build_mesh(MeshConfig(2, 4),
                                               devices=virtual_devices(8, "cpu")))
    jax_comm = JaxCommunicator(jax_build_mesh(JaxMeshConfig()))
    for value in VALUES:
        (p_status, p_out), (j_status, j_out) = port.allreduce(value, op), \
            jax_comm.allreduce(value, op)
        assert p_status.name == j_status.name == "SUCCEEDED"
        assert np.asarray(p_out).dtype == np.asarray(j_out).dtype
        assert np.array_equal(p_out, j_out)


def test_one_process_barrier_broadcast_and_bad_op_match_jax():
    port, jax_comm = CollectiveCommunicator(None), JaxCommunicator(jax_build_mesh(JaxMeshConfig()))
    assert port.barrier("sync") == CollectiveResult.SUCCEEDED
    assert jax_comm.barrier("sync").name == "SUCCEEDED"
    status, same = port.broadcast(np.array([3.0]))
    assert status == CollectiveResult.SUCCEEDED and np.array_equal(same, [3.0])
    for comm in (port, jax_comm):
        with pytest.raises(ValueError, match="Unknown allreduce op"):
            comm.allreduce(np.ones(2), op="MAX")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.mesh_world(tmp_path_factory)[0]


def test_process_mesh_allreduce_mean_sum_and_barrier(world):
    values = np.asarray([[r, 2.0 * r + 1] for r in range(worker.WORLD)], np.float32)
    for result in world:
        assert result["coll_mean_ok"] and result["coll_sum_ok"] and result["coll_barrier_ok"]
        np.testing.assert_array_equal(result["coll_sum"], values.sum(axis=0))
        np.testing.assert_array_equal(result["coll_mean"], values.sum(axis=0) / worker.WORLD)
        assert result["coll_bad_op_raises"]


def test_killed_peer_gives_failed_within_the_group_timeout(world):
    for rank, result in enumerate(world):
        if rank == worker.KILLED:
            assert "kill_failed" not in result
            continue
        assert bool(result["kill_failed"]), rank
        assert float(result["kill_seconds"]) < worker.TIMEOUT_S, rank
