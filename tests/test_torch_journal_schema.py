"""The port's journal schema registry (``elasticdl_tpu_torch.analysis.
journal_schema``) against the JAX package's ``scripts/validate_journal.py``,
and the ``journal-schema`` rule that reads it.

- Every event of the JAX registry keeps its exact required fields and
  its optional fields; the port adds its own events and a few fields of
  shared events, and nothing else.
- A small elastic DeepFM job of the port, on the CPU, journals only
  registered events, and its journals validate with zero errors.
- The rule tells a journal's ``record(event, ...)`` from the retry
  counters' ``RetryStats.record(...)`` through the program index, and
  raises when the registry is broken.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from elasticdl_tpu.analysis.core import SourceFile as JaxSourceFile
from elasticdl_tpu.analysis.protocol_rules import check_journal_schema as jax_check
from elasticdl_tpu_torch import analysis as analysis_pkg
from elasticdl_tpu_torch.analysis import journal_schema
from elasticdl_tpu_torch.analysis.core import SourceFile
from elasticdl_tpu_torch.analysis.protocol_rules import check_journal_schema

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "elasticdl_tpu_torch"

#: Events only the port writes.
PORT_ONLY = {"worker_task_done", "first_step", "data_readers", "worker_start",
             "worker_exit", "model_exported", "local_job_exit", "master_exit",
             "worker_launch", "evaluation_metrics", "checkpoint_restore"}


def _jax_registry():
    spec = importlib.util.spec_from_file_location(
        "validate_journal_for_port_test", REPO / "scripts" / "validate_journal.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_registry()


def test_jax_required_fields_are_kept_exactly():
    for event, fields in JAX.EVENT_REQUIRED_FIELDS.items():
        assert journal_schema.EVENT_REQUIRED_FIELDS[event] == fields, event


def test_jax_optional_fields_are_kept_and_only_documented_extras_added():
    for event, fields in JAX.EVENT_OPTIONAL_FIELDS.items():
        port = journal_schema.EVENT_OPTIONAL_FIELDS[event]
        assert port[:len(fields)] == fields, event
        extras = set(port) - set(fields)
        assert extras == set(journal_schema.PORT_OPTIONAL_EXTRAS.get(event, ())), event


def test_port_events_are_the_ones_only_the_port_writes():
    assert set(journal_schema.PORT_EVENTS) == PORT_ONLY
    assert journal_schema.KNOWN_EVENTS == JAX.KNOWN_EVENTS | PORT_ONLY
    assert set(journal_schema.EVENT_OPTIONAL_FIELDS) == set(journal_schema.KNOWN_EVENTS)
    assert set(journal_schema.PORT_OPTIONAL_EXTRAS) == {
        "master_start", "serving_replica_start", "checkpoint_saved", "sparse_kernel_selected"}
    assert {"pid"} <= set(journal_schema.PORT_OPTIONAL_EXTRAS["master_start"])
    assert {"device", "forbidden_modules", "startup_s"} <= set(
        journal_schema.PORT_OPTIONAL_EXTRAS["serving_replica_start"])
    assert {"rank", "seconds"} <= set(journal_schema.PORT_OPTIONAL_EXTRAS["checkpoint_saved"])


@pytest.mark.parametrize("record,errors", [
    ({"ts": 1.0, "event": "worker_start", "worker_id": 0, "pid": 7}, 0),
    ({"ts": 1.0, "event": "worker_start", "worker_id": 0}, 1),
    ({"ts": 1.0, "event": "master_exit"}, 1),
    ({"ts": 1.0, "event": "checkpoint_restore", "rank": 0, "step": 4, "seconds": 0.1}, 0),
    ({"ts": 1.0, "event": "rendezvous", "rendezvous_id": 1}, 1),
    ({"ts": "x", "event": "span", "name": "n", "duration_s": 1}, 1),
    ({"ts": 1.0, "event": "a_future_event", "anything": 1}, 0),
])
def test_validate_record(record, errors):
    assert len(journal_schema.validate_record(record)) == errors


def test_selftest_and_check_sources(tmp_path, capsys, monkeypatch):
    assert journal_schema.main(["--selftest"]) == 0
    monkeypatch.chdir(REPO)
    assert journal_schema.main(["--check-sources"]) == 0
    assert "check-sources OK" in capsys.readouterr().out
    drifting = tmp_path / "drifting.py"
    drifting.write_text('journal.record("model_swap", generaton=2, step=4096)\n')
    assert journal_schema.main(["--check-sources", str(tmp_path)]) == 1
    problems, scanned = journal_schema.scan_sources_counted(str(tmp_path))
    assert scanned == 1 and any("generaton" in message for _, _, message in problems)
    assert journal_schema.main(["--check-sources", str(tmp_path / "missing")]) == 2


def test_retry_stats_record_is_not_a_journal_event():
    path = PORT / "common" / "retry.py"
    text = path.read_text()
    port_found = check_journal_schema(SourceFile.parse(str(path), text))
    jax_found = jax_check(JaxSourceFile.parse(str(path), text))
    assert port_found == []
    assert len(jax_found) == 4  # the JAX rule reads RetryStats.record as events
    # A journal receiver the index cannot resolve is still checked.
    found = check_journal_schema(SourceFile.parse("fixture.py", (
        "from elasticdl_tpu_torch import obs\n"
        "def f():\n    obs.journal().record('call')\n")))
    assert len(found) == 1 and "unknown journal event 'call'" in found[0].message


def test_the_rule_raises_when_the_registry_is_broken(monkeypatch):
    """No silent degradation: a registry without its tables is an error,
    not an empty schema."""
    monkeypatch.setattr(analysis_pkg, "journal_schema", types.SimpleNamespace())
    source = SourceFile.parse("fixture.py", "def f(journal):\n    journal.record('x')\n")
    with pytest.raises(AttributeError):
        check_journal_schema(source)


def test_port_job_journal_validates(tmp_path):
    """A small elastic DeepFM job on the CPU: master and one worker
    process, a checkpoint every 4 steps and an export.  Every record of
    every journal validates, and every event is registered."""
    root = tmp_path / "job"
    root.mkdir()
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
            "--distribution_strategy=ParameterServerStrategy", "--model_zoo=model_zoo",
            "--model_def=deepfm.deepfm_functional_api",
            "--model_params=vocab_size=100,embedding_dim=4,hidden=16",
            "--training_data=synthetic://criteo?n=512&vocab=100", "--records_per_task=128",
            "--checkpoint_steps=4", "--sparse_apply_every=1", "--minibatch_size=64",
            "--device=cpu", f"--checkpoint_dir={root / 'ckpt'}", f"--output={root / 'out'}"]
    proc = subprocess.run(argv, cwd=str(REPO), capture_output=True, text=True, timeout=300,
                          env={**os.environ, "ELASTICDL_FORCE_PLATFORM": "cpu"})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    journals = sorted((root / "ckpt").glob("*.jsonl"))
    assert len(journals) >= 2, journals  # the master's and the worker's
    events = set()
    for path in journals:
        assert journal_schema.validate_file(str(path)) == [], path
        for line in path.read_text().splitlines():
            events.add(json.loads(line)["event"])
    assert events <= journal_schema.KNOWN_EVENTS, events - journal_schema.KNOWN_EVENTS
    assert {"master_start", "worker_start", "worker_task_done", "checkpoint_saved",
            "master_exit"} <= events, events


def test_journal_schema_module_runs_as_a_script():
    proc = subprocess.run([sys.executable, "-m", "elasticdl_tpu_torch.analysis.journal_schema",
                           "--selftest"], cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "selftest OK" in proc.stdout, proc.stdout + proc.stderr
