"""Phases 40 and 41 of ``chip_smoke.py`` on the CPU at a small split
DeepFM (vocab 1000 a field, batch 256): the model-quality plane end to
end through the port alone.

Phase 40 runs JAX's poisoned-delta canary scenario in process under
``ELASTICDL_LOCKCHECK=1`` (two replicas, each with a QualityLedger, a
CanaryGate and a DeltaWatcher; a clean link passes, a retrain on flipped
labels is held on every poll, a recovery compacted past it and a healthy
link pass; the windows equal their pairs' AUC/logloss; the drift sketch
breaches; the lock checker finds no inversion).  Phase 41 starts
``python -m elasticdl_tpu_torch.serving.replica_main --device cpu
--quality_join_window_s=8 --quality_slo_logloss=<bound> --pub_dir ...``
from phase 40's compacted full, sends traced requests and their labels
about 2 s late through the ``labels`` request, and holds the replica to
the feed (joins, the window's logloss recomputed from the responses,
the clean link passed, the poisoned link held, ``model_quality``
burning while flipped labels join, ``obs.report`` and ``obs.top``).
Each phase holds its own gates (``chip_smoke.fail`` raises); the kernel
launch counts are checked on the card only.
"""

import os

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis import runtime as lockcheck
from elasticdl_tpu_torch.common import faults

import chip_smoke

PARAMS = "vocab_size=1000,embedding_dim=4,hidden=16,split_tables=true"


def test_quality_phases_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv(lockcheck.ENV_VAR, raising=False)
    faults.clear()
    try:
        gate, chain = chip_smoke.quality_gate_phase("cpu", 0, str(tmp_path), params=PARAMS,
                                                    batch=256, device="cpu")
        process = chip_smoke.quality_replica_phase("cpu", 0, str(tmp_path), chain,
                                                   params=PARAMS, device="cpu")
    finally:
        faults.clear()
        obs.journal().configure(None)
    assert lockcheck.ENV_VAR not in os.environ  # restored after phase 40
    assert gate["outcomes"] == ["passed"] * 2 + ["held"] * 4 + ["passed"] * 2
    # The locks the phase's own objects make are checked; which module-level
    # locks are too depends on whether they were made before the phase.
    assert gate["lockcheck"]["acquisitions"] > 0
    assert {"DriftMonitor._lock", "Generation._lock", "QualityLedger._lock",
            "ReplayBuffer._lock", "ServingReplica._lock"} <= set(gate["lockcheck"]["names"])
    assert "breach" in gate["drift_edges"]
    assert process["joined_ids"] > 0 and process["held_polls"] >= 2
    assert [g["outcome"] for g in process["gates"]][0] == "passed"
    assert max(process["burn_rates"].values()) > 0
    assert abs(process["final_window"]["logloss"]
               - process["final_window"]["recomputed_logloss"]) <= chip_smoke.QUALITY_LOGLOSS_TOL
