"""The port's policy engine (``elasticdl_tpu_torch/master/policy.py``)
against the JAX package's (``elasticdl_tpu/master/policy.py``).

Each script (ledger states, straggler sets, ticks and scale-up gates on
a fake clock) drives an engine of each package over its own fake ledger
and fake manager; the decision lists, the manager calls, the gates'
grants and the journaled ``policy_decision`` records must be equal.
The scripts cover scale-up amortization (cooldown, the unamortized
rescale cost, the optimistic first grant, a rescale in flight), the
thrash hold with its park-at-floor scale-down and the restore, and the
eviction of persistent stragglers within the kill budget and the floor.
The job runner's gated capacity oracle and ``PolicyConfig.from_args``
are held to JAX's too.
"""

import json
import types

import pytest

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.master import job_runner as jax_runner
from elasticdl_tpu.master import policy as jax_policy
from elasticdl_tpu_torch import obs as port_obs
from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.master import job_runner as port_runner
from elasticdl_tpu_torch.master import policy as port_policy
from elasticdl_tpu_torch.obs.goodput import PHASES


class FakeLedger:
    def __init__(self):
        self.seconds = {p: 0.0 for p in PHASES}
        self.rescales = 0
        self.last = None
        self.since = None
        self.in_flight = False

    def phase_seconds(self):
        return dict(self.seconds)

    def counts(self):
        return {"records_done": 0, "records_redone": 0, "redo_pending": 0,
                "rescales": self.rescales}

    def last_rescale(self):
        return dict(self.last) if self.last else None

    def seconds_since_last_rescale(self):
        return self.since

    def rescale_in_flight(self):
        return self.in_flight


class FakeManager:
    def __init__(self, ids):
        self.ids = list(ids)
        self.target = len(ids)
        self.calls = []

    def current_worker_ids(self):
        return list(self.ids)

    def kill_worker(self, wid, sig=9):
        self.calls.append(("kill", wid, sig))
        self.ids.remove(wid)

    def scale(self, n):
        self.calls.append(("scale", n))
        self.ids = list(range(100 + len(self.calls), 100 + len(self.calls) + n))
        self.target = n

    def set_target_num_workers(self, n):
        self.calls.append(("target", n))
        self.target = n

    def target_num_workers(self):
        return self.target


# Script ops: ("advance", s) | ("ledger", {attr: value}) | ("add", phase, s)
# | ("flag", {wid: evidence}) | ("tick",) | ("gate", needed, grant)
# | ("abort",)
SCRIPTS = {
    "scale_up_amortization": (
        dict(amortize_horizon_s=100.0, min_cooldown_s=10.0, cooldown_factor=2.0), [0, 1], [
            ("gate", 1, 1),  # unpriced: optimistic grant
            ("ledger", {"in_flight": True}), ("gate", 1, 1),
            ("ledger", {"in_flight": False, "last": {"total_s": 30.0}, "since": 5.0,
                        "rescales": 1}),
            ("gate", 2, 2),  # cooldown max(10, 2 * 30)
            ("ledger", {"since": 61.0}),
            ("gate", 1, 1),  # 30 * (2 + 1) / 1 = 90 < 100: approved
            ("ledger", {"last": {"total_s": 40.0}, "since": 200.0}),
            ("gate", 1, 1),  # 40 * 3 = 120 >= 100: unamortized
            ("gate", 4, 1),  # full grant clears (60), the partial one does not
            ("gate", 4, 4), ("abort",), ("gate", 0, 3),
            ("advance", 1.0), ("tick",),
        ]),
    "thrash_hold_then_park_and_restore": (
        dict(thrash_window_s=60.0, thrash_rescales=2, thrash_overhead_frac=0.25,
             scale_down_after=2, min_workers=1, min_cooldown_s=5.0, cooldown_factor=1.0),
        [0, 1, 2, 3], [
            ("tick",),
            ("advance", 10.0), ("add", "training", 10.0), ("tick",),
            ("advance", 10.0), ("add", "rendezvous", 8.0), ("add", "training", 2.0),
            ("ledger", {"rescales": 1}), ("tick",),
            ("advance", 10.0), ("add", "rendezvous", 6.0), ("add", "requeue_redo", 4.0),
            ("ledger", {"rescales": 2, "last": {"total_s": 6.0}, "since": 1.0}), ("tick",),
            ("gate", 1, 1),
            ("advance", 10.0), ("add", "scaling_wait", 10.0), ("ledger", {"rescales": 3}),
            ("tick",),
            ("advance", 10.0), ("add", "rendezvous", 10.0), ("ledger", {"since": 40.0}),
            ("tick",),
            ("advance", 100.0), ("add", "training", 100.0), ("tick",), ("tick",),
            ("advance", 40.0), ("add", "training", 40.0), ("tick",),
        ]),
    "evict_within_budget_and_floor": (
        dict(evict_after_ticks=3, kill_budget=1, kill_budget_window_s=100.0, min_workers=2),
        [0, 1, 2, 3], [
            ("flag", {2: {"metric": "step_time", "value": 0.5}}), ("tick",), ("tick",),
            ("flag", {}), ("tick",),
            ("flag", {2: {"metric": "step_time"}, 3: {"metric": "staleness"}}),
            ("tick",), ("tick",), ("tick",),
            ("advance", 1.0), ("tick",), ("tick",),
            ("advance", 120.0), ("tick",),
            ("flag", {0: {"metric": "step_time"}, 1: {"metric": "step_time"}}),
            ("tick",), ("tick",), ("tick",),
            ("flag", {77: {"metric": "step_time"}}), ("tick",), ("tick",), ("tick",),
        ]),
}


def _run(module, config_kwargs, ids, ops):
    clock = {"t": 1000.0}
    ledger = FakeLedger()
    manager = FakeManager(ids)
    flagged = {}
    engine = module.ElasticPolicyEngine(
        module.PolicyConfig(**config_kwargs), ledger=ledger,
        stragglers_fn=lambda: dict(flagged), clock=lambda: clock["t"]).bind(manager)
    out = []
    for op in ops:
        kind = op[0]
        if kind == "advance":
            clock["t"] += op[1]
        elif kind == "ledger":
            for attr, value in op[1].items():
                setattr(ledger, attr, value)
        elif kind == "add":
            ledger.seconds[op[1]] += op[2]
        elif kind == "flag":
            flagged.clear()
            flagged.update(op[1])
        elif kind == "tick":
            out.append(("tick", engine.tick()))
        elif kind == "gate":
            out.append(("gate", engine.gate_scale_up(op[1], op[2])))
        else:
            engine.scale_up_aborted()
        out.append(("state", engine.kill_budget_remaining(), engine.last_decision()))
    return out, manager.calls


@pytest.fixture
def journals(tmp_path):
    paths = {"jax": jax_obs.init_journal(str(tmp_path / "jax")),
             "port": port_obs.init_journal(str(tmp_path / "port"))}
    yield paths
    jax_obs.journal().configure(None)
    port_obs.journal().configure(None)


def _decisions(path):
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    return [{k: v for k, v in r.items() if k != "ts"} for r in records
            if r["event"] == "policy_decision"]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_engine_makes_the_jax_decisions(script, journals):
    config, ids, ops = SCRIPTS[script]
    jax_out, jax_calls = _run(jax_policy, config, ids, ops)
    port_out, port_calls = _run(port_policy, config, ids, ops)
    assert port_out == jax_out
    assert port_calls == jax_calls
    port_records = _decisions(journals["port"])
    assert port_records == _decisions(journals["jax"])
    for record in port_records:
        assert port_obs.missing_fields(record) == ()
    actions = [(r["action"], r["reason"]) for r in port_records]
    if script == "scale_up_amortization":
        assert [o[1] for o in port_out if o[0] == "gate"] == [1, 0, 0, 1, 0, 0, 4, 0]
        assert ("hold", "unamortized_rescale_cost") in actions
        assert ("hold", "scale_up_aborted") in actions
    if script == "thrash_hold_then_park_and_restore":
        assert ("scale", 1) in port_calls and ("target", 4) in port_calls
        assert ("hold", "rescale_thrash") in actions
        assert ("scale_down", "rescale_thrash") in actions
        assert ("hold", "target_restored") in actions
    if script == "evict_within_budget_and_floor":
        assert [c for c in port_calls if c[0] == "kill"] == [("kill", 2, 9), ("kill", 3, 9)]
        assert ("hold", "kill_budget_exhausted") in actions
        assert ("hold", "min_workers_floor") in actions


class _Oracle:
    def __init__(self, slots):
        self.slots, self.asked, self.failures, self.successes = slots, [], 0, 0

    def __call__(self, needed):
        self.asked.append(needed)
        return min(needed, self.slots)

    def failed(self):
        self.failures += 1

    def succeeded(self):
        self.successes += 1


@pytest.mark.parametrize("slots", [0, 1, 3])
def test_gated_scale_up_asks_the_policy_first(slots, journals):
    results = []
    for runner, policy in ((jax_runner, jax_policy), (port_runner, port_policy)):
        clock = {"t": 5.0}
        engine = policy.ElasticPolicyEngine(ledger=FakeLedger(), clock=lambda: clock["t"])
        engine.bind(FakeManager([0, 1]))
        oracle = _Oracle(slots)
        gated = runner._gated_scale_up(oracle, engine)
        grants = [gated(2)]
        gated.failed()
        gated.succeeded()
        results.append((grants, oracle.asked, oracle.failures, oracle.successes))
        assert runner._gated_scale_up(None, engine) is None
        assert runner._gated_scale_up(oracle, None) is oracle
    assert results[0] == results[1]


@pytest.mark.parametrize("content,needed", [("2", 3), ("5", 1), ("", 2), ("x", 2), (None, 1)])
def test_capacity_file_oracle_matches_jax(tmp_path, monkeypatch, content, needed):
    path = tmp_path / "capacity"
    if content is not None:
        path.write_text(content)
    monkeypatch.setenv("ELASTICDL_CAPACITY_FILE", str(path))
    assert (port_runner._capacity_oracle_from_env()(needed)
            == jax_runner._capacity_oracle_from_env()(needed))
    monkeypatch.delenv("ELASTICDL_CAPACITY_FILE")
    assert port_runner._capacity_oracle_from_env() is None


ZOO_FLAGS = ["--model_zoo=model_zoo", "--model_def=cifar10.cifar10_subclass", "--device=cpu"]


def test_policy_flags_select_the_engine():
    args = parse_master_args(ZOO_FLAGS + [
        "--policy_amortize_horizon_s=30", "--policy_tick_interval_s=0.5",
        "--policy_min_workers=2", "--policy_evict_after=5", "--policy_kill_budget=0",
        "--policy_kill_budget_window_s=60"])
    port = port_policy.PolicyConfig.from_args(args)
    assert port == port_policy.PolicyConfig(**vars(jax_policy.PolicyConfig.from_args(args)))
    assert (port.amortize_horizon_s, port.tick_interval_s, port.min_workers,
            port.evict_after_ticks, port.kill_budget, port.kill_budget_window_s) == (
        30.0, 0.5, 2, 5, 0, 60.0)
    master = types.SimpleNamespace(telemetry=None)
    assert isinstance(port_runner._build_policy_engine(args, master),
                      port_policy.ElasticPolicyEngine)
    off = parse_master_args(ZOO_FLAGS + ["--policy_enabled=false"])
    assert port_runner._build_policy_engine(off, master) is None
    rigid = parse_master_args(ZOO_FLAGS + ["--need_elasticity=false"])
    assert port_runner._build_policy_engine(rigid, master) is None
