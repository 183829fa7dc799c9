"""The port's SLO plane (``obs/history.py``, ``obs/slo.py``) held to the
JAX package's on one caller-driven tick timeline: the same metrics move
the same way in both registries, and ``MetricsHistory`` and
``SLORegistry.evaluate(now)`` give the same burn rates (rtol 1e-12),
budgets, alert edges (fire and clear, with evidence), journal events and
``elasticdl_slo_*`` gauges; the history keeps JAX's bounds and its
clock-regression clamp.  Then the exporter's ``/slo`` and
``/debug/vars``, the replica's SLO flags, and an alert edge reaching the
policy engine's ``note_slo_alert`` through the master's plane."""

import http.client
import json
from types import SimpleNamespace

import pytest

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.obs import history as jax_history
from elasticdl_tpu.obs import slo as jax_slo
from elasticdl_tpu.obs.journal import EventJournal as JaxJournal
from elasticdl_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from elasticdl_tpu_torch import obs as port_obs
from elasticdl_tpu_torch.master import job_runner
from elasticdl_tpu_torch.master.policy import ElasticPolicyEngine
from elasticdl_tpu_torch.obs import history as port_history
from elasticdl_tpu_torch.obs import slo as port_slo
from elasticdl_tpu_torch.obs.exporter import MetricsExporter
from elasticdl_tpu_torch.obs.journal import EventJournal as PortJournal
from elasticdl_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry
from elasticdl_tpu_torch.serving import replica_main

RTOL = 1e-12
WINDOW_S = 7200.0


def _specs(slo):
    return [slo.serving_latency_slo(20.0, objective=0.99, compliance_window_s=WINDOW_S),
            slo.serving_availability_slo(0.999, compliance_window_s=WINDOW_S),
            slo.freshness_slo(30.0, compliance_window_s=WINDOW_S),
            slo.goodput_slo(0.8, compliance_window_s=WINDOW_S)]


def _timeline(slo, registry_cls, journal, monkeypatch, obs_module):
    """240 one-second ticks: a latency regression at 60-120, a burst of
    errors at 150-170, freshness lag and goodput dips, one clock
    regression.  Returns per tick (edges, statuses, gauges)."""
    monkeypatch.setattr(obs_module, "journal", lambda: journal)
    registry = registry_cls()
    p99 = registry.gauge("elasticdl_serving_latency_p99_ms", "")
    requests = registry.counter("elasticdl_serving_requests_total", "", labelnames=("outcome",))
    lag = registry.gauge("elasticdl_freshness_lag_seconds", "")
    goodput = registry.gauge("elasticdl_goodput_ratio", "")
    plane = slo.SLOPlane(registry=registry, specs=_specs(slo), status_interval_s=10.0,
                         origin="test", max_samples=256)
    callbacks = []
    plane.slos.add_alert_callback(lambda name, alerting, ev: callbacks.append(
        (name, alerting, ev)))
    plane.slos.set_exemplar_provider(lambda name: [f"trace-{name}"])
    out = []
    for tick in range(240):
        p99.set(50.0 if 60 <= tick < 120 else 2.0 + (tick % 7) * 0.5)
        requests.inc(100, outcome="served")
        if 150 <= tick < 170:
            requests.inc(3, outcome="error")
            requests.inc(1, outcome="shed")
        lag.set(45.0 if 180 <= tick < 230 else 5.0)
        goodput.set(0.5 if tick % 11 == 0 else 0.9)
        now = float(tick) if tick != 200 else 150.0  # one regression, clamped
        edges = plane.tick(now)
        gauges = {name: metric.to_dict()["values"] for name, metric in
                  ((m.name, m) for m in registry.collect()) if name.startswith("elasticdl_slo_")}
        out.append((edges, plane.slos.statuses(), gauges))
    return out, callbacks, plane


def _close(got, want):
    """Equal, numbers within RTOL (the burn rates are rounded alike)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=0.0)
    else:
        assert got == want


def test_burn_rates_alert_edges_and_gauges_match_jax(monkeypatch):
    jax_journal, port_journal = JaxJournal(), PortJournal()
    jax_run, jax_calls, jax_plane = _timeline(jax_slo, JaxRegistry, jax_journal, monkeypatch,
                                              jax_obs)
    port_run, port_calls, port_plane = _timeline(port_slo, PortRegistry, port_journal,
                                                 monkeypatch, port_obs)
    _close(port_run, jax_run)
    _close(port_calls, jax_calls)
    fired = {(name, alerting) for name, alerting, _ in port_calls}
    assert {("serving_latency", True), ("serving_latency", False)} <= fired
    strip = lambda events: [{k: v for k, v in e.items() if k != "ts"} for e in events]  # noqa
    _close(strip(port_journal.tail(1000)), strip(jax_journal.tail(1000)))
    assert any(e["event"] == "slo_alert" and e.get("exemplars") for e in port_journal.tail(1000))
    _close(port_plane.snapshot(samples_per_series=16), jax_plane.snapshot(samples_per_series=16))


def test_history_bounds_and_clock_clamp_match_jax():
    got = {}
    for name, history, registry_cls in (("jax", jax_history, JaxRegistry),
                                        ("port", port_history, PortRegistry)):
        registry = registry_cls()
        hist = history.MetricsHistory(registry, max_series=4, max_samples=8)
        series = registry.gauge("g", "", labelnames=("k",))
        latency = registry.histogram("h_seconds", "")
        stamps = []
        for tick in range(30):
            series.set(tick, k=str(tick % 6))  # label churn past max_series
            latency.observe(0.01 * tick)
            stamps.append(hist.sample(float(tick) if tick != 20 else 3.0))
        got[name] = (stamps, hist.snapshot(max_series=16, samples_per_series=8),
                     hist.delta("h_seconds_count", 5.0, 29.0),
                     hist.threshold_fraction("g", 10.0, 10.0, 29.0),
                     hist.sparkline("g", n=8, labels={"k": "5"}))
    _close(got["port"], got["jax"])
    assert got["port"][0][20] == 19.0  # the regression clamps to the last stamp


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        response = conn.getresponse()
        return response.status, json.loads(response.read())
    finally:
        conn.close()


def test_slo_and_debug_vars_endpoints():
    registry, journal = PortRegistry(), PortJournal()
    goodput = registry.gauge("elasticdl_goodput_ratio", "")
    plane = port_slo.SLOPlane(registry=registry, specs=[port_slo.goodput_slo(0.5)],
                              origin="master")
    exporter = MetricsExporter(registry=registry, journal=journal, host="127.0.0.1").start()
    try:
        assert _get(exporter.port, "/slo")[1]["statuses"] == []  # no plane yet
        exporter.set_slo_plane(plane)
        for tick in range(5):
            goodput.set(0.9)
            plane.tick(float(tick))
        status, payload = _get(exporter.port, "/slo?n=3")
        assert status == 200 and payload["origin"] == "master" and payload["ticks"] == 5
        (row,) = payload["statuses"]
        assert row["slo"] == "goodput" and set(row["burn_rates"]) == set(port_slo.WINDOWS)
        assert len(row["sparkline"]) == 3
        journal.record("model_swap", generation=2, step=4)
        status, debug = _get(exporter.port, "/debug/vars")
        assert status == 200
        assert debug["metrics"]["elasticdl_slo_budget_remaining_ratio"]["values"] == {
            "goodput": 1.0}
        assert debug["journal"]["tail"][-1]["event"] == "model_swap"
    finally:
        exporter.stop()


def test_replica_flags_register_their_slos():
    args = replica_main.parse_replica_args(
        ["--model_dir", "m", "--serve_dir", "s", "--slo_availability_target", "0.99",
         "--slo_p99_ms", "12", "--freshness_slo_s", "30", "--pub_dir", "p"])
    plane = replica_main._build_slo_plane(args)
    specs = {spec.name: spec for spec in plane.slos.specs()}
    assert sorted(specs) == ["freshness", "serving_availability", "serving_latency"]
    assert specs["serving_latency"].threshold == 12.0
    assert specs["serving_availability"].objective == 0.99
    assert plane.slos.origin == "replica_0"
    bare = replica_main.parse_replica_args(["--model_dir", "m", "--serve_dir", "s"])
    assert replica_main._build_slo_plane(bare).slos.specs() == []


def test_an_alert_reaches_the_policy_engine(monkeypatch):
    journal = PortJournal()
    monkeypatch.setattr(port_obs, "journal", lambda: journal)
    engine = ElasticPolicyEngine(clock=lambda: 0.0)
    registry = PortRegistry()
    monkeypatch.setattr(port_obs, "registry", lambda: registry)
    goodput = registry.gauge("elasticdl_goodput_ratio", "")
    exporter = SimpleNamespace(set_slo_plane=lambda plane: setattr(exporter, "plane", plane))
    master = SimpleNamespace(metrics_exporter=exporter)
    args = SimpleNamespace(slo_enabled=True, slo_goodput_target=0.8,
                           slo_compliance_window_s=3600.0, slo_tick_interval_s=2.0)
    plane = job_runner._build_slo_plane(args, master, engine)
    assert exporter.plane is plane
    assert [s.name for s in plane.slos.specs()] == ["goodput"]
    for tick in range(40):
        goodput.set(0.1)  # far below target: the fast pair fires
        plane.tick(float(tick))
        if engine.slo_alerts():
            break
    assert "goodput" in engine.slo_alerts()
    assert engine.slo_alerts()["goodput"]["grade"] == "page"
    holds = [e for e in journal.tail(100) if e["event"] == "policy_decision"]
    assert any(e.get("reason") == "slo_alert" and e.get("slo") == "goodput" for e in holds)
    off = SimpleNamespace(slo_enabled=False)
    assert job_runner._build_slo_plane(off, master, engine) is None
