"""Phase 36 of ``chip_smoke.py``, the continuous loop fed by an unbounded
stream, on the CPU at a small DeepFM (vocab 100 a field, split tables),
at the scale of the JAX package's own scenario
(``tests/test_stream_e2e.py``: 400 then 1600 records/s, tasks of 64):
the streaming master, three draining workers, a worker's churn, the
master SIGKILLed at tick 17 and rebuilt from its journal, a stalled
source, a torn delta, a failed apply, an in-process ServingReplica moved
by a DeltaWatcher under a load generator, and the freshness SLO.

The phase holds its own gates (the watermark across the rebuild, the
redo debt, no dropped request, the quarantine and the rollback, breach
then clear, served logits against a reload of the chain at rtol 1e-5);
this test runs it with ``device="cpu"`` (no kernel launches to count)
and checks its journal with ``scripts/validate_journal.py``.
"""

import importlib.util
import os
import sys

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import faults

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(chip_smoke.STREAM_LOOP, schedule=((4.0, 400.0), (2.0, 1600.0)),
             records_per_task=64, query_rows=16)
PARAMS = "vocab_size=100,embedding_dim=4,hidden=8,split_tables=true"


def _validator():
    spec = importlib.util.spec_from_file_location(
        "validate_journal", os.path.join(REPO, "scripts", "validate_journal.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["validate_journal"] = module
    spec.loader.exec_module(module)
    return module


def test_stream_loop_phase_on_the_cpu(tmp_path):
    faults.clear()
    try:
        result = chip_smoke.stream_loop_phase("cpu", 0, str(tmp_path), cfg=SMALL,
                                              params=PARAMS, device="cpu")
    finally:
        faults.clear()
        obs.journal().configure(None)
    total = result["records"]
    assert total == 4 * 400 + 1 * 1600  # the 1 s stall: 5 of the 6 virtual seconds produce
    assert result["watermark"] == total
    assert result["watermark_across_rebuild"][0] == result["watermark_across_rebuild"][1]
    assert sorted(result["redo_after_rebuild"]) == sorted(result["master_in_flight"])
    assert len(result["churned"]) == 2 and result["requests"] > 0
    assert "rolled_back" in result["swaps"] and result["swaps"][-1] == "applied"
    assert result["quarantined"] >= 1
    assert result["freshness"][0] == "breach" and result["freshness"][-1] == "clear"
    assert result["steps"] == result["tasks_trained"]  # one batch a task
    assert _validator().validate_file(result["journal"]) == []
