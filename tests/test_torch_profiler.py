"""The port's step profiler (``elasticdl_tpu_torch/common/profiler.py``, on
``torch.profiler``) held to the JAX package's (``jax.profiler``): the
same window rule (1-based steps, whole train windows, a window already
passed warns and captures nothing), starting and stopping at the same
calls and journaling the same ``profile_window`` events, for per-step
and windowed loops; a CPU run writes a Chrome trace with CPU events
under ``<log_dir>/profile/worker_<id>/``."""

import glob
import json
import os

import pytest
import torch

from elasticdl_tpu.common import profiler as jax_profiler
from elasticdl_tpu.obs.journal import EventJournal as JaxJournal
from elasticdl_tpu_torch.common import profiler as port_profiler
from elasticdl_tpu_torch.obs.journal import EventJournal as PortJournal

# (profile window, steps per dispatch, dispatches, first step): per-step
# and windowed loops, windows that straddle dispatches, one never
# reached, and one a restored worker has already passed.
CASES = [("5,7", 1, 10, 0), ("5,7", 4, 4, 0), ("3,12", 4, 4, 0), ("1,2", 1, 3, 0),
         ("2,3", 4, 3, 0), ("100,120", 4, 3, 0), ("2,3", 4, 3, 8)]


def _loop(module, log_dir, spec, per_dispatch, dispatches, first_step):
    """Drive the profiler as the task loops do; returns, per dispatch,
    whether a trace was open while its steps ran."""
    prof = module.StepProfiler(str(log_dir), spec, worker_id=3, **(
        {"device": "cpu"} if module is port_profiler else {}))
    step, open_at = first_step, []
    for _ in range(dispatches):
        prof.before_steps(step, per_dispatch)
        open_at.append(prof._profile is not None if module is port_profiler
                       else prof._tracing)
        torch.ones(4).sum()  # the dispatch's work
        step += per_dispatch
        prof.after_steps(step)
    prof.stop()
    return open_at


@pytest.mark.parametrize("spec,per_dispatch,dispatches,first_step", CASES)
def test_window_bookkeeping_and_events_match_jax(spec, per_dispatch, dispatches, first_step,
                                                 tmp_path, monkeypatch):
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda path: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    got = {}
    for name, module, obs_pkg, journal in (
            ("jax", jax_profiler, "elasticdl_tpu", JaxJournal()),
            ("port", port_profiler, "elasticdl_tpu_torch", PortJournal())):
        obs = __import__(obs_pkg, fromlist=["obs"]).obs
        monkeypatch.setattr(obs, "journal", lambda journal=journal: journal)
        open_at = _loop(module, tmp_path / name, spec, per_dispatch, dispatches, first_step)
        records = []
        for e in journal.tail(100):
            e = {k: v for k, v in e.items() if k not in ("ts", "trace_file")}
            e["trace_dir"] = os.path.relpath(e["trace_dir"], tmp_path / name)
            records.append(e)
        got[name] = (open_at, records)
    assert got["port"] == got["jax"]
    start, end = (int(s) for s in spec.split(","))
    open_at, records = got["port"]
    last_step = first_step + dispatches * per_dispatch
    if start > last_step or end <= first_step + 1:
        assert records == [] and not any(open_at)  # never reached, or already passed
    else:
        # Whole dispatches: every in-window step ran under the trace.
        traced = {first_step + d * per_dispatch + i + 1 for d, is_open in enumerate(open_at)
                  if is_open for i in range(per_dispatch)}
        assert set(range(start, min(end, last_step + 1))) <= traced
        assert [r["action"] for r in records] == ["open", "close"]


def test_parse_rules_match_jax():
    for spec in ("", "0,1", "10,20"):
        assert port_profiler.parse_profile_steps(spec) == jax_profiler.parse_profile_steps(spec)
    for bad in ("5", "a,b", "7,7", "-1,3"):
        for module in (port_profiler, jax_profiler):
            with pytest.raises(ValueError):
                module.parse_profile_steps(bad)
    with pytest.raises(ValueError, match="tensorboard_log_dir"):
        port_profiler.StepProfiler("", "1,2", device="cpu")
    idle = port_profiler.StepProfiler("", "", device="cpu")
    idle.before_steps(0, 4)
    idle.after_steps(4)
    assert not idle.tracing and idle.activities == []


def test_cpu_run_writes_a_chrome_trace(tmp_path):
    journal = PortJournal()
    from elasticdl_tpu_torch import obs

    saved = obs.journal
    obs.journal = lambda: journal
    try:
        prof = port_profiler.StepProfiler(str(tmp_path), "1,3", worker_id=2, device="cpu")
        assert prof.activities == [torch.profiler.ProfilerActivity.CPU]
        for step in range(4):
            prof.before_steps(step, 1)
            torch.nn.functional.linear(torch.ones(8, 16), torch.ones(4, 16)).relu().sum()
            prof.after_steps(step + 1)
        prof.stop()
    finally:
        obs.journal = saved
    (path,) = glob.glob(str(tmp_path / "profile" / "worker_2" / "*.pt.trace.json"))
    assert prof.trace_file == path
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::linear" in names and "aten::relu" in names
    close = [e for e in journal.tail(10) if e["action"] == "close"]
    assert close and close[0]["trace_file"] == path


def test_cuda_device_asks_for_cuda_activity():
    activities = port_profiler.profiler_activities(torch.device("cuda"))
    assert activities == [torch.profiler.ProfilerActivity.CPU,
                          torch.profiler.ProfilerActivity.CUDA]
    assert port_profiler.profiler_activities("cpu") == [torch.profiler.ProfilerActivity.CPU]
