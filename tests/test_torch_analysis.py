"""The port's static analyzer (``elasticdl_tpu_torch.analysis``) against
the JAX package's (``elasticdl_tpu.analysis``): the counterpart of
``tests/test_analysis.py``.

- Each of the 15 rules fires on a seeded violation and stays quiet on
  its clean twin, through ``scan`` and through the CLI.
- The control-plane and protocol rules give the same ``(rule, line)``
  findings as the JAX package's on every fixture of
  ``tests/test_analysis.py`` that they share (read from that file, the
  same source text through both analyzers; a file at a JAX path maps to
  the port's path).
- The two whole-program indexes, over one file set, agree on modules,
  imports, classes, resolved call edges and blocking facts (hot-ness is
  left out: its roots differ by design).
- Each hot-path rule is held to its JAX rule on paired fixtures: a JAX
  step doing X, and a port step (``autograd.Function``, ``nn.Module``
  or ``# hot-path``) doing X's counterpart, with equal counts.
- The port's tree gates clean, and its ``# guarded-by:`` annotations
  engage.
"""

import ast
import json
import textwrap
from pathlib import Path

import pytest

from elasticdl_tpu.analysis import rules as jax_rules
from elasticdl_tpu.analysis.core import SourceFile as JaxSourceFile
from elasticdl_tpu.analysis.program import build_program_index as jax_build_index
from elasticdl_tpu_torch.analysis.__main__ import main as analysis_main
from elasticdl_tpu_torch.analysis.core import SourceFile, run_checks, scan
from elasticdl_tpu_torch.analysis.program import build_program_index
from elasticdl_tpu_torch.analysis.rules import ALL_RULES, RULE_NAMES

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "elasticdl_tpu_torch"

CONTROL_RULES = ("rpc-deadline", "idempotency", "determinism", "thread-hygiene",
                 "lock-discipline", "metric-label-cardinality")
PROTOCOL_RULES = ("drain-discipline", "blocking-under-lock", "journal-schema")
HOT_RULES = ("jit-host-sync", "retrace-hazard", "donation-discipline",
             "async-staging-discipline", "trace-purity", "sharding-coverage")


def violations(text, rule, path="fixture.py"):
    source = SourceFile.parse(path, textwrap.dedent(text))
    found = [v for v in ALL_RULES[rule](source) if not source.suppressed(v.rule, v.line)]
    assert all(v.rule == rule for v in found)
    return found


def jax_violations(text, rule, path="fixture.py"):
    source = JaxSourceFile.parse(path, textwrap.dedent(text))
    return [v for v in jax_rules.ALL_RULES[rule](source)
            if not source.suppressed(v.rule, v.line)]


def test_rule_registry_mirrors_the_jax_package():
    assert len(RULE_NAMES) == 15
    assert set(RULE_NAMES) == set(jax_rules.RULE_NAMES)
    assert set(RULE_NAMES) == set(CONTROL_RULES + PROTOCOL_RULES + HOT_RULES)


# ---------------------------------------------------------------------------
# Seeded violations and their clean twins, one pair per rule
# ---------------------------------------------------------------------------

SEEDED = {
    "rpc-deadline": (
        "def f(s, r):\n    return s._stub.get(r)\n",
        "def f(s, r):\n    return s._stub.get(r, timeout=1.0)\n",
    ),
    "idempotency": (
        "def f(s, r):\n    s._call_idempotent('report_task_result', r)\n",
        "def f(s, r):\n    s._call_idempotent('get_task', r)\n",
    ),
    "determinism": (
        "# deterministic-replay-path\nimport time\ndef f():\n    return time.time()\n",
        "# deterministic-replay-path\nimport time\ndef f():\n    return time.monotonic()\n",
    ),
    "thread-hygiene": (
        "import threading\ndef f(t):\n    threading.Thread(target=t)\n",
        "import threading\ndef f(t):\n    threading.Thread(target=t, name='w', daemon=True)\n",
    ),
    "lock-discipline": (
        "import threading\nclass S:\n    def __init__(self):\n"
        "        self._lock = threading.Lock()\n        self._x = 0  # guarded-by: _lock\n"
        "    def bad(self):\n        self._x = 1\n",
        "import threading\nclass S:\n    def __init__(self):\n"
        "        self._lock = threading.Lock()\n        self._x = 0  # guarded-by: _lock\n"
        "    def good(self):\n        with self._lock:\n            self._x = 1\n",
    ),
    "metric-label-cardinality": (
        "def f(obs, task):\n    c = obs.counter('t_total', 'h', labelnames=('task_id',))\n",
        "def f(obs, task):\n    c = obs.counter('t_total', 'h', labelnames=('reason',))\n",
    ),
    "jit-host-sync": (
        "import torch\ndef step(x):  # hot-path\n    print(x)\n    return x\n",
        "import torch\ndef step(x):  # hot-path\n    return x\ndef host(x):\n    print(x)\n",
    ),
    "retrace-hazard": (
        "import torch\ndef run(fn, xs):\n    for x in xs:\n        torch.compile(fn)(x)\n",
        "import torch\ndef run(fn, xs):\n    compiled = torch.compile(fn)\n"
        "    for x in xs:\n        compiled(x)\n",
    ),
    "donation-discipline": (
        "import torch\nclass T:\n    def step(self, g):  # hot-path\n"
        "        self._table = self._table - 0.1 * g\n",
        "import torch\nclass T:\n    def step(self, g):  # hot-path\n"
        "        self._table.sub_(0.1 * g)\n",
    ),
    "async-staging-discipline": (
        "import torch\ndef stage(buf, dev):\n    out = buf.to(dev, non_blocking=True)\n"
        "    buf[0] = 1\n    return out\n",
        "import torch\ndef stage(buf, dev):\n    out = buf.to(dev, non_blocking=True)\n"
        "    torch.cuda.current_stream().synchronize()\n    buf[0] = 1\n    return out\n",
    ),
    "trace-purity": (
        "import torch\ndef step(x, journal):  # hot-path\n"
        "    journal.record('step', loss=x)\n    return x\n",
        "import torch\ndef step(x):  # hot-path\n    return x\n"
        "def host(x, journal):\n    journal.record('step', loss=x)\n",
    ),
    "sharding-coverage": (
        "# multi-device-path\nimport torch.distributed as dist\ndef f(t):\n"
        "    dist.all_reduce(t)\n",
        "# multi-device-path\nimport torch.distributed as dist\ndef f(t, g):\n"
        "    dist.all_reduce(t, group=g)\n",
    ),
    "drain-discipline": (
        "class Prefetcher:\n    def close(self):\n        pass\n"
        "def consume(it):\n    p = Prefetcher()\n    for _ in it:\n        pass\n",
        "class Prefetcher:\n    def close(self):\n        pass\n"
        "def consume(it):\n    p = Prefetcher()\n    try:\n        for _ in it:\n"
        "            pass\n    finally:\n        p.close()\n",
    ),
    "blocking-under-lock": (
        "import threading\nimport time\nclass S:\n    def __init__(self):\n"
        "        self._lock = threading.Lock()\n        self._x = 0  # guarded-by: _lock\n"
        "    def poke(self):\n        with self._lock:\n            self._helper()\n"
        "    def _helper(self):\n        time.sleep(1)\n",
        "import threading\nimport time\nclass S:\n    def __init__(self):\n"
        "        self._lock = threading.Lock()\n        self._x = 0  # guarded-by: _lock\n"
        "    def poke(self):\n        with self._lock:\n            self._x += 1\n"
        "        self._helper()\n    def _helper(self):\n        time.sleep(1)\n",
    ),
    "journal-schema": (
        "def f(journal):\n    journal.record('model_swap', generaton=2, step=4096)\n",
        "def f(journal):\n    journal.record('model_swap', generation=2, step=4096)\n",
    ),
}


def test_every_rule_has_a_seeded_pair():
    assert set(SEEDED) == set(RULE_NAMES)


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_seeded_violation_fires_and_clean_twin_is_quiet_through_scan(tmp_path, rule):
    bad_text, clean_text = SEEDED[rule]
    bad = tmp_path / "bad.py"
    clean = tmp_path / "clean.py"
    bad.write_text(bad_text)
    clean.write_text(clean_text)
    found = scan([str(bad)], [ALL_RULES[rule]]).violations
    assert found and {v.rule for v in found} == {rule}
    assert scan([str(clean)], [ALL_RULES[rule]]).violations == []


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_cli_exits_nonzero_on_each_seeded_violation(tmp_path, capsys, rule):
    bad_text, clean_text = SEEDED[rule]
    bad = tmp_path / f"{rule.replace('-', '_')}.py"
    bad.write_text(bad_text)
    assert analysis_main([str(bad)]) == 1, f"seeded {rule} violation not caught"
    assert f"[{rule}]" in capsys.readouterr().out
    bad.write_text(clean_text)
    assert analysis_main([str(bad), "--rule", rule]) == 0
    assert "OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The control-plane and protocol rules against the JAX package's, on the
# fixtures of tests/test_analysis.py
# ---------------------------------------------------------------------------


def _jax_fixtures():
    """(test name, rule, path, text) for every ``violations(text, rule)``
    call of tests/test_analysis.py with a control-plane or protocol rule,
    and every entry of its ``_SEEDED_VIOLATIONS``."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    namespace = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                namespace[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                continue
    shared = set(CONTROL_RULES + PROTOCOL_RULES)
    out = []
    for rule, text in namespace["_SEEDED_VIOLATIONS"].items():
        if rule in shared:
            out.append(("_SEEDED_VIOLATIONS", rule, "fixture.py", text))
    for func in tree.body:
        if not isinstance(func, ast.FunctionDef):
            continue
        local = dict(namespace)
        for node in func.body:  # fixture texts bound to a local name
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                try:
                    local[node.targets[0].id] = ast.literal_eval(node.value)
                except ValueError:
                    continue
        for call in ast.walk(func):
            if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                    and call.func.id == "violations" and len(call.args) >= 2):
                continue
            rule = call.args[1]
            if not (isinstance(rule, ast.Constant) and rule.value in shared):
                continue
            expr = ast.Expression(call.args[0])
            text = eval(compile(expr, "test_analysis.py", "eval"), {}, local)
            path = "fixture.py"
            for kw in call.keywords:
                if kw.arg == "path":
                    path = kw.value.value
            out.append((func.name, rule.value, path, text))
    return out


JAX_FIXTURES = _jax_fixtures()


def _port_path(path: str) -> str:
    return path.replace("elasticdl_tpu/", "elasticdl_tpu_torch/")


def test_jax_fixtures_cover_every_shared_rule():
    assert {rule for _, rule, _, _ in JAX_FIXTURES} == set(CONTROL_RULES + PROTOCOL_RULES)
    assert len(JAX_FIXTURES) >= 40


@pytest.mark.parametrize(
    "name,rule,path,text", JAX_FIXTURES,
    ids=[f"{name}-{i}" for i, (name, _, _, _) in enumerate(JAX_FIXTURES)])
def test_shared_rules_match_the_jax_analyzer(name, rule, path, text):
    """The rule's own findings (before suppression) on the same source
    text: the JAX package's ``(rule, line)`` list, the port's."""
    text = textwrap.dedent(text)
    jax_source = JaxSourceFile.parse(path, text)
    port_source = SourceFile.parse(_port_path(path), text)
    want = sorted((v.rule, v.line) for v in jax_rules.ALL_RULES[rule](jax_source))
    got = sorted((v.rule, v.line) for v in ALL_RULES[rule](port_source))
    assert got == want


def test_cross_module_blocking_chain_matches_the_jax_analyzer(tmp_path):
    """tests/test_analysis.py's whole-program fixture: the lock in one
    module, the sleep two calls below it in another."""
    (tmp_path / "helpers.py").write_text(
        "import time\n\ndef deep():\n    time.sleep(0.5)\n\ndef poll():\n    deep()\n")
    (tmp_path / "svc.py").write_text(
        "import threading\n\nimport helpers\n\nclass Service:\n"
        "    def __init__(self):\n        self._lock = threading.Lock()\n"
        "        self._state = 0  # guarded-by: _lock\n\n    def tick(self):\n"
        "        with self._lock:\n            helpers.poll()\n")
    from elasticdl_tpu.analysis.core import run_checks as jax_run_checks

    want = jax_run_checks([str(tmp_path)], [jax_rules.ALL_RULES["blocking-under-lock"]])
    got = run_checks([str(tmp_path)], [ALL_RULES["blocking-under-lock"]])
    assert [(v.path, v.line) for v in got] == [(v.path, v.line) for v in want]
    assert len(got) == 1 and "via" in got[0].message


# ---------------------------------------------------------------------------
# The whole-program index against the JAX package's
# ---------------------------------------------------------------------------


def _index_facts(index, sources):
    calls = set()
    for source in sources:
        for node in ast.walk(source.tree):
            if isinstance(node, ast.Call) and id(node) in index.call_targets:
                calls.add((source.path, node.lineno, node.col_offset,
                           index.call_targets[id(node)]))
    return {
        "modules": set(index.modules),
        "imports": {name: dict(mod.imports) for name, mod in index.modules.items()},
        "classes": {fq: dict(cls.methods) for fq, cls in index.classes.items()},
        "functions": set(index.functions),
        "edges": {fq: set(targets) for fq, targets in index.edges.items()},
        "calls": calls,
        "blocking": {fq: (fact.prim, fact.chain) for fq, fact in index.blocking.items()},
        "stats": index.stats(),
    }


@pytest.fixture(scope="module")
def both_indexes():
    from elasticdl_tpu.analysis.core import discover_files

    files = discover_files([str(PORT)])
    jax_sources = [JaxSourceFile.parse(path) for path in files]
    port_sources = [SourceFile.parse(path) for path in files]
    return (_index_facts(jax_build_index(jax_sources), jax_sources),
            _index_facts(build_program_index(port_sources), port_sources))


@pytest.mark.parametrize("fact", ["modules", "imports", "classes", "functions", "edges",
                                  "calls", "blocking", "stats"])
def test_program_indexes_agree_over_the_port_tree(both_indexes, fact):
    jax_facts, port_facts = both_indexes
    assert port_facts[fact] == jax_facts[fact]
    if fact in ("edges", "calls", "blocking"):
        assert port_facts[fact], f"no {fact} resolved: the comparison saw nothing"


# ---------------------------------------------------------------------------
# Hot-path rules: paired fixtures against the JAX package's rules
# ---------------------------------------------------------------------------

PAIRS = [
    # (name, rule, jax text, jax path, port text, port path, count)
    ("host-syncs-in-a-step", "jit-host-sync", """
        import jax
        import numpy as np

        @jax.jit
        def step(state, x):
            loss = float(x)
            np.asarray(state)
            print(loss)
            jax.device_get(x)
            return x.item()
        """, "fixture.py", """
        import numpy as np
        import torch

        class Step(torch.autograd.Function):
            @staticmethod
            def forward(ctx, state, x):
                loss = float(x)
                np.asarray(state)
                print(loss)
                x.cpu()
                return x.item()
        """, "fixture.py", 5),
    ("host-sync-in-a-helper", "jit-host-sync", """
        import jax
        import numpy as np

        def helper(x):
            return np.asarray(x)

        @jax.jit
        def step(x):
            return helper(x)
        """, "fixture.py", """
        import numpy as np

        def helper(x):
            return np.asarray(x)

        def step(x):  # hot-path
            return helper(x)
        """, "fixture.py", 1),
    ("host-side-and-shape-math", "jit-host-sync", """
        import jax
        import jax.numpy as jnp
        import numpy as np

        @jax.jit
        def step(x):
            b, d = x.shape
            n = int(np.prod(x.shape))
            scale = 1.0 / (d ** 0.5)
            return jnp.sum(x) * scale

        def host_loop(step_fn, batches):
            for batch in batches:
                loss = step_fn(batch)
                print(float(np.asarray(loss).item()))
        """, "fixture.py", """
        import numpy as np
        import torch

        def step(x, causal: bool = False):  # hot-path
            b, d = x.shape
            n = int(np.prod(x.shape)) + x.size(0) + x.numel()
            scale = 1.0 / (d ** 0.5)
            if causal and x.dim() == 2 and x.device.type == "cuda":
                scale = scale * 2
            return torch.sum(x) * scale

        def host_loop(step_fn, batches):
            for batch in batches:
                loss = step_fn(batch)
                print(float(loss.cpu().numpy().item()))
        """, "fixture.py", 0),
    ("transform-body", "jit-host-sync", """
        import jax

        def run(state, xs):
            def body(carry, x):
                carry.item()
                return carry, x
            return jax.lax.scan(body, state, xs)
        """, "fixture.py", """
        import torch

        def run(state, xs):
            def body(carry):
                carry.item()
                return carry
            return torch.func.vmap(body)(xs)
        """, "fixture.py", 1),
    ("module-body", "jit-host-sync", """
        import flax.linen as nn

        class Head(nn.Module):
            @nn.compact
            def __call__(self, x):
                return x.item()
        """, "fixture.py", """
        import torch.nn as nn

        class Head(nn.Module):
            def forward(self, x):
                return x.item()
        """, "fixture.py", 1),
    ("compile-in-loop-and-step", "retrace-hazard", """
        import jax

        def run(fn, xs):
            for x in xs:
                jax.jit(fn)(x)

        class T:
            def train_step(self, state, x):
                return jax.jit(self._impl)(state, x)

            def _impl(self, state, x):
                return state
        """, "fixture.py", """
        import torch

        def run(fn, xs):
            for x in xs:
                torch.compile(fn)(x)

        class T:
            def train_step(self, state, x):  # hot-path
                return torch.compile(self._impl)(state, x)

            def _impl(self, state, x):
                return state
        """, "fixture.py", 2),
    ("compile-at-init", "retrace-hazard", """
        import jax

        class T:
            def __init__(self):
                self._compile_steps()

            def _compile_steps(self):
                self._train_step = jax.jit(self._impl, donate_argnums=(0,))

            def _impl(self, state, x):
                return state
        """, "fixture.py", """
        import torch

        class T:
            def __init__(self):
                self._compile_steps()

            def _compile_steps(self):
                self._train_step = torch.compile(self._impl)

            def _impl(self, state, x):
                return state
        """, "fixture.py", 0),
    ("state-not-updated-in-place", "donation-discipline", """
        import jax

        class T:
            def __init__(self):
                self._train_step = jax.jit(self._train_step_impl)

            def _train_step_impl(self, state, batch):
                return state
        """, "fixture.py", """
        import torch

        class T:
            def train_step(self, batch):  # hot-path
                grads = torch.ones_like(self._table)
                self._tables["a"] = self._tables["a"] - 0.1 * grads
        """, "fixture.py", 1),
    ("read-after-update", "donation-discipline", """
        import jax

        class T:
            def __init__(self):
                self._train_step = jax.jit(self._train_step_impl, donate_argnums=(0,))

            def _train_step_impl(self, state, batch):
                return state, 0.0

            def run(self, state, batch):
                new_state, loss = self._train_step(state, batch)
                return state
        """, "fixture.py", """
        import torch

        class T:
            def train_step(self, batch):  # hot-path
                self._table.add_(batch)

            def run(self, batch):
                before = self._table
                self.train_step(batch)
                return before
        """, "fixture.py", 1),
    ("in-place-state-and-clean-alias", "donation-discipline", """
        import jax

        class T:
            def __init__(self):
                self._train_step = jax.jit(self._train_step_impl, donate_argnums=(0,))
                self._eval_step = jax.jit(self._eval_step_impl)

            def _train_step_impl(self, state, batch):
                return state, 0.0

            def _eval_step_impl(self, state, batch):
                return batch

            def run(self, state, batch):
                state, loss = self._train_step(state, batch)
                return self._eval_step(state, batch)
        """, "fixture.py", """
        import torch

        class T:
            def train_step(self, batch):  # hot-path
                self._table.add_(batch)

            def run(self, batch):
                before = self._table.clone()
                self.train_step(batch)
                after = self._table
                return before, after
        """, "fixture.py", 0),
    ("buffer-reused-before-sync", "async-staging-discipline", """
        import jax

        class T:
            def __init__(self):
                self._train_step = jax.jit(self._train_step_impl, donate_argnums=(0,))

            def _train_step_impl(self, staged, rows):
                return staged

            def run(self, staging, batch):
                staged = staging.stage_batch(batch)
                rows = len(batch)
                return self._train_step(staged, rows)
        """, "fixture.py", """
        import numpy as np
        import torch

        def run(pinned, dev, batch):
            staged = pinned.to(dev, non_blocking=True)
            np.copyto(pinned, batch)
            return staged
        """, "fixture.py", 1),
    ("buffer-reused-after-sync", "async-staging-discipline", """
        import jax

        class T:
            def __init__(self):
                self._train_step = jax.jit(self._train_step_impl, donate_argnums=(0,))

            def _train_step_impl(self, state, window):
                return state, 0.0

            def run(self, staging, state, pending):
                window = staging.stage_window(pending)
                count = len(pending)
                state, loss = self._train_step(state, window)
                return count
        """, "fixture.py", """
        import torch

        def run(pinned, dev, out, batch, event):
            out.copy_(pinned, non_blocking=True)
            event.record()
            pinned.copy_(batch)
            staged = pinned.to(dev, non_blocking=True)
            pinned = torch.empty_like(pinned)
            pinned[0] = 1
            return staged
        """, "fixture.py", 0),
    ("obs-io-locks-in-a-step", "trace-purity", """
        import jax

        @jax.jit
        def step(x, journal, registry):
            journal.record("step", loss=x)
            registry.counter("steps_total", "h").inc()
            with STEP_LOCK:
                y = x + 1
            open("/tmp/trace.log")
            return y
        """, "fixture.py", """
        import torch

        def step(x, journal, registry):  # hot-path
            journal.record("step", loss=x)
            registry.counter("steps_total", "h").inc()
            with STEP_LOCK:
                y = x + 1
            open("/tmp/trace.log")
            return y
        """, "fixture.py", 4),
    ("obs-on-the-host", "trace-purity", """
        import jax

        @jax.jit
        def step(state, x):
            return state, x

        def host_loop(journal, lock, state, batches):
            for batch in batches:
                state, loss = step(state, batch)
                with lock:
                    journal.record("step", loss=float(loss))
        """, "fixture.py", """
        import torch

        def step(state, x):  # hot-path
            return state, x

        def host_loop(journal, lock, state, batches):
            for batch in batches:
                state, loss = step(state, batch)
                with lock:
                    journal.record("step", loss=float(loss))
        """, "fixture.py", 0),
    ("marked-multi-device-file", "sharding-coverage", """
        # multi-device-path
        import jax

        def compile_steps(impl, shardings):
            bare = jax.jit(impl)
            good = jax.jit(impl, in_shardings=shardings, out_shardings=shardings)
            with mesh:
                contextual = jax.jit(impl)
            return bare, good, contextual
        """, "fixture.py", """
        # multi-device-path
        import torch.distributed as dist

        def reduce(t, mesh):
            dist.all_reduce(t)
            dist.all_reduce(t, group=mesh.group("data"))
            return axis_all_reduce(mesh, "data", [t])
        """, "fixture.py", 1),
    ("unmarked-file", "sharding-coverage", """
        import jax

        def compile_steps(impl):
            return jax.jit(impl)
        """, "fixture.py", """
        import torch.distributed as dist

        def reduce(t):
            dist.all_reduce(t)
        """, "fixture.py", 0),
    ("parallel-tree-by-path", "sharding-coverage",
     "import jax\nstep = jax.jit(lambda x: x + 1)\n", "elasticdl_tpu/parallel/new_trainer.py",
     "import torch.distributed as dist\ndef f(t):\n    dist.broadcast(t, src=0)\n",
     "elasticdl_tpu_torch/parallel/new_trainer.py", 1),
    ("worker-tree-by-path", "sharding-coverage",
     "import jax\nstep = jax.jit(lambda x: x + 1)\n", "elasticdl_tpu/worker/new_trainer.py",
     "import torch.distributed as dist\ndef f(t):\n    dist.broadcast(t, src=0)\n",
     "elasticdl_tpu_torch/worker/new_trainer.py", 0),
]


def test_pairs_cover_every_hot_path_rule():
    assert {rule for _, rule, *_ in PAIRS} == set(HOT_RULES)


@pytest.mark.parametrize("name,rule,jax_text,jax_path,port_text,port_path,count", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_hot_path_rule_matches_its_jax_rule(name, rule, jax_text, jax_path, port_text,
                                            port_path, count):
    want = jax_violations(jax_text, rule, jax_path)
    got = violations(port_text, rule, port_path)
    assert len(want) == count, [v.format() for v in want]
    assert len(got) == len(want), [v.format() for v in got]


# ---------------------------------------------------------------------------
# The port's own forms of the rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code,count", [
    ("t = x.sum()\n    if t > 0:\n        x = x * 2", 1),
    ("t = torch.sum(x)\n    while t:\n        t = t - 1", 1),
    ("assert torch.isfinite(x).all()", 1),
    ("y = x if x.any() else -x", 1),
    ("torch.cuda.synchronize()", 1),
    ("torch.cuda.current_stream().synchronize()", 1),
    ("idx = torch.nonzero(x)", 1),
    ("idx = x.nonzero()", 1),
    ("u = torch.unique(x)", 1),
    ("m = torch.masked_select(x, x > 0)", 1),
    ("w = torch.where(x > 0)", 1),
    ("r = torch.repeat_interleave(x, x)", 1),
    ("r = torch.repeat_interleave(x, x, output_size=8)", 0),
    ("h = x.to('cpu')", 1),
    ("h = x.to(device=torch.device('cpu'))", 1),
    ("h = x.to(x.device)", 0),
    ("b = bool(x)", 1),
    ("w = torch.where(x > 0, x, 0)", 0),
    ("if x is None:\n        x = 1", 0),
    ("t = torch.from_numpy(a).to(x.device)", 1),
    ("t = torch.from_numpy(a).cuda()", 1),
    ("t = torch.as_tensor(a, device=x.device)", 1),
    ("t = torch.tensor(0.5, device='cuda')", 1),
    ("t = torch.from_numpy(a).to(x.device, non_blocking=True)", 0),
    ("t = torch.as_tensor(a, device='cpu')", 0),
    ("t = torch.from_numpy(a)", 0),
])
def test_jit_host_sync_port_forms(code, count):
    text = f"import torch\n\ndef step(x):  # hot-path\n    {code}\n    return x\n"
    assert len(violations(text, "jit-host-sync")) == count


def test_jit_host_sync_ignores_host_code_and_flags():
    """Host code may sync; a flag parameter is no tensor; numpy of a host
    value is no sync."""
    assert violations("""
        import numpy as np
        import torch

        def step(q, scale, causal=False, layout: str = "contiguous"):  # hot-path
            scale = float(np.float32(scale))
            if causal and layout == "zigzag":
                scale = -scale
            return q * bool(causal)

        def host(x):
            torch.cuda.synchronize()
            return x.cpu().numpy(), x.item()
        """, "jit-host-sync") == []


def test_kernel_builds_only_behind_a_cache():
    found = violations("""
        import ctypes
        import functools

        def _load():
            return ctypes.CDLL("lib.so")

        @functools.lru_cache(maxsize=None)
        def library():
            return _load()

        def step(x):  # hot-path
            library().kernel(x)
            return _load()
        """, "retrace-hazard")
    # The uncached loader is hot (the step calls it): its build is flagged.
    assert len(found) == 1 and "ctypes.CDLL" in found[0].message
    assert found[0].line == 6 and "`_load`" in found[0].message


def test_a_cached_loader_is_not_hot():
    from elasticdl_tpu_torch.analysis.traced import traced_index

    source = SourceFile.parse("fixture.py", textwrap.dedent("""
        import functools

        @functools.cache
        def library():
            return open("lib.so")

        def step(x):  # hot-path
            return library()
        """))
    index = traced_index(source)
    assert "step" in index.traced and "library" not in index.traced


def test_graph_capture_and_checkpoint_make_roots():
    from elasticdl_tpu_torch.analysis.traced import traced_index

    source = SourceFile.parse("fixture.py", textwrap.dedent("""
        import torch
        import torch.utils.checkpoint

        def body(x):
            return x

        def block(x):
            return x

        def capture(g, x):
            with torch.cuda.graph(g):
                body(x)
            return torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)

        @torch.compile
        def compiled(x):
            return x
        """))
    index = traced_index(source)
    assert {"body", "block", "compiled"} <= set(index.traced)
    assert "capture" not in index.traced
    assert len(index.capture_sites) == 2  # torch.cuda.graph(...) and @torch.compile


@pytest.mark.parametrize("code,count", [
    ("self._client.call('get_task', request)", 1),
    ("self._client.call('get_task', request, IDEMPOTENT_POLICY)", 0),
    ("self._client.call('get_task', request, policy=IDEMPOTENT_POLICY)", 0),
    ("http.client.HTTPConnection(host, port)", 1),
    ("http.client.HTTPConnection(host, port, timeout=5.0)", 0),
    ("http.client.HTTPConnection(host, port, 5.0)", 0),
    ("urllib.request.urlopen(url)", 1),
    ("urllib.request.urlopen(url, timeout=5)", 0),
])
def test_rpc_deadline_port_forms(code, count):
    text = f"import http.client\nimport urllib.request\n\ndef f(self, request):\n    {code}\n"
    assert len(violations(text, "rpc-deadline")) == count


@pytest.mark.parametrize("code,count", [
    ("self._client.call('report_task_result', request, IDEMPOTENT_POLICY)", 1),
    ("self._client.call('report_task_result', request, self._no_retry_policy)", 0),
    ("self._client.call('report_evaluation_metrics', request, NON_IDEMPOTENT_POLICY)", 0),
    ("call_with_retry(fn, 'report_task_result', IDEMPOTENT_POLICY)", 1),
    ("call_with_retry(fn, 'report_task_result', NON_IDEMPOTENT_POLICY)", 0),
    ("call_with_retry(fn, 'get_task', IDEMPOTENT_POLICY)", 0),
])
def test_idempotency_port_forms(code, count):
    text = f"def f(self, fn, request):\n    {code}\n"
    assert len(violations(text, "idempotency")) == count


@pytest.mark.parametrize("path", ["elasticdl_tpu_torch/common/faults.py",
                                  "elasticdl_tpu_torch/common/retry.py",
                                  "elasticdl_tpu_torch/common/http_rpc.py"])
def test_determinism_applies_to_the_ports_replay_modules(path):
    text = "import random\nimport time\nx = time.time()\ny = random.random()\n"
    assert len(violations(text, "determinism", path=path)) == 2
    assert not violations(text, "determinism", path="elasticdl_tpu_torch/common/args.py")


# ---------------------------------------------------------------------------
# Suppression: the reason is required
# ---------------------------------------------------------------------------


def test_noqa_with_a_reason_suppresses_by_rule_and_star():
    found = violations("""
        import threading

        def f(target):
            threading.Thread(target=target)  # noqa-invariant: thread-hygiene (a test thread)
            threading.Thread(target=target)  # noqa-invariant: * (a test thread)
            threading.Thread(target=target)  # noqa-invariant: rpc-deadline (wrong rule)
        """, "thread-hygiene")
    assert len(found) == 1


def test_noqa_without_a_reason_is_a_finding(tmp_path, capsys):
    bad = tmp_path / "bare.py"
    bad.write_text("import threading\n\ndef f(t):\n"
                   "    threading.Thread(target=t)  # noqa-invariant: thread-hygiene\n")
    report = scan([str(bad)], ALL_RULES.values())
    assert len(report.violations) == 1 and report.suppressed == []
    assert "without a reason" in report.violations[0].message
    assert analysis_main([str(bad)]) == 1
    capsys.readouterr()
    bad.write_text("import threading\n\ndef f(t):\n"
                   "    threading.Thread(target=t)  # noqa-invariant: thread-hygiene ()\n")
    assert analysis_main([str(bad)]) == 1


def test_noqa_on_def_line_covers_decorator_lines():
    text = """
        import torch

        @torch.compile
        def train_step(x):
            return x

        def run(xs):
            for x in xs:
                torch.compile(train_step)(x)
        """
    assert len(violations(text, "retrace-hazard")) == 1
    text = text.replace("torch.compile(train_step)(x)",
                        "torch.compile(train_step)(x)  # noqa-invariant: retrace-hazard (test)")
    assert violations(text, "retrace-hazard") == []


# ---------------------------------------------------------------------------
# The CLI surface (the JAX package's flags and JSON fields)
# ---------------------------------------------------------------------------


def _planted(tmp_path):
    bad = tmp_path / "planted.py"
    bad.write_text(SEEDED["jit-host-sync"][0])
    return bad


def test_cli_json_format_is_machine_readable(tmp_path, capsys):
    bad = _planted(tmp_path)
    assert analysis_main([str(bad), "--format", "json"]) == 1
    data = json.loads(capsys.readouterr().out)
    assert data["files_scanned"] == 1 and data["suppressed"] == 0
    assert data["rules"] == list(RULE_NAMES)
    (finding,) = data["findings"]
    assert finding["rule"] == "jit-host-sync" and finding["line"] == 3
    assert finding["path"] == str(bad) and "col" in finding and "message" in finding
    assert "program-index" in data["timing"] and set(RULE_NAMES) <= set(data["timing"])
    assert data["graph"]["modules"] == 1


def test_cli_json_counts_noqa_suppressions(tmp_path, capsys):
    bad = tmp_path / "suppressed.py"
    bad.write_text("def step(x):  # hot-path\n"
                   "    print(x)  # noqa-invariant: jit-host-sync (a test)\n    return x\n")
    assert analysis_main([str(bad), "--format", "json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["findings"] == [] and data["suppressed"] == 1
    assert data["suppressed_by_rule"] == {"jit-host-sync": 1}


def test_cli_baseline_allowlists_known_findings(tmp_path, capsys):
    bad = _planted(tmp_path)
    assert analysis_main([str(bad), "--format", "json"]) == 1
    baseline = tmp_path / "baseline.json"
    baseline.write_text(capsys.readouterr().out)
    assert analysis_main([str(bad), "--baseline", str(baseline)]) == 0
    capsys.readouterr()
    bad.write_text(SEEDED["jit-host-sync"][0] + "\ndef step2(x):  # hot-path\n"
                   "    return x.item()\n")
    assert analysis_main([str(bad), "--baseline", str(baseline)]) == 1
    out = capsys.readouterr().out
    assert ".item()" in out and "print" not in out


def test_cli_baseline_unreadable_and_zero_files_are_usage_errors(tmp_path, capsys):
    assert analysis_main(["--baseline", str(tmp_path / "nope.json")]) == 2
    garbage = tmp_path / "garbage.json"
    garbage.write_text("not json")
    assert analysis_main(["--baseline", str(garbage)]) == 2
    assert "baseline" in capsys.readouterr().err
    empty = tmp_path / "empty_dir"
    empty.mkdir()
    assert analysis_main([str(empty)]) == 2
    assert "no .py files" in capsys.readouterr().err


def test_cli_lists_every_rule_with_a_description(capsys):
    assert analysis_main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == list(RULE_NAMES)
    assert all(line.partition(":")[2].strip() for line in lines)


def test_cli_default_scope_is_the_port_package():
    from elasticdl_tpu_torch.analysis.__main__ import default_paths

    assert [Path(p).resolve() for p in default_paths()] == [PORT]


def test_run_checks_reports_unparseable_and_undecodable_files(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    (tmp_path / "latin.py").write_bytes(b"# caf\xe9\nx = 1\n")
    found = run_checks([str(tmp_path)], ALL_RULES.values())
    assert sorted(v.rule for v in found) == ["parse", "parse"]
    assert any("could not read" in v.message for v in found)


def test_report_renders_the_per_rule_table(tmp_path, capsys):
    from elasticdl_tpu_torch.analysis import report

    bad = _planted(tmp_path)
    analysis_main([str(bad), "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    lines = report.render(data).splitlines()
    assert lines[0].split() == ["rule", "findings", "suppressed"]
    assert next(l for l in lines if l.startswith("jit-host-sync")).split() == [
        "jit-host-sync", "1", "0"]
    assert any("1 files scanned" in l for l in lines)
    assert any(l.startswith("timing:") for l in lines)
    assert any(l.startswith(f"{bad}:3:") and "[jit-host-sync]" in l for l in lines)
    empty = tmp_path / "empty.json"
    empty.write_text("")
    assert report.main([str(empty)]) == 0
    assert "no findings JSON" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The port's tree
# ---------------------------------------------------------------------------


def test_port_tree_is_invariant_clean(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    assert analysis_main(["elasticdl_tpu_torch"]) == 0
    assert "check-invariants: OK" in capsys.readouterr().out


def test_port_suppressions_all_carry_reasons():
    report = scan([str(PORT)], ALL_RULES.values())
    assert report.violations == []
    assert report.suppressed, "the port's deliberate exceptions are gone"
    for path in report.files:
        source = SourceFile.parse(path)
        assert not source.noqa_without_reason, (path, source.noqa_without_reason)


def test_production_annotations_actually_engage(tmp_path):
    """Removing one ``with self._lock`` from a copy of a guarded port
    service makes lock-discipline fire."""
    from elasticdl_tpu_torch.analysis.rules import _collect_guarded_fields

    path = PORT / "master" / "evaluation_service.py"
    text = path.read_text()
    source = SourceFile.parse(str(path), text)
    guarded = {}
    for node in ast.walk(source.tree):
        if isinstance(node, ast.ClassDef) and node.name == "EvaluationService":
            guarded = _collect_guarded_fields(source, node)
    assert guarded.get("_reported") == "_lock" and "_latest_metrics" in guarded
    assert violations(text, "lock-discipline", str(path)) == []
    marker = "with self._lock:"
    fired = 0
    for i in range(text.count(marker)):
        head, *tails = text.split(marker)
        unlocked = head + "".join(
            ("if True:" if j == i else marker) + tail for j, tail in enumerate(tails))
        copy = tmp_path / f"evaluation_service_{i}.py"
        copy.write_text(unlocked)
        found = run_checks([str(copy)], [ALL_RULES["lock-discipline"]])
        assert all("outside 'with self._lock'" in v.message for v in found)
        fired += bool(found)
    assert fired >= text.count(marker) // 2, fired


#: The eager counterparts of the JAX package's compiled steps (the
#: jax.jit / CompilePlan.compile / shard_map sites of dp_trainer,
#: ps_trainer, worker/trainer, serving/runtime and ring_attention).
HOT_STEPS = {
    ("parallel/ps_trainer.py", "ShardedEmbeddingTrainer.train_step_staged"),
    ("parallel/ps_trainer.py", "ShardedEmbeddingTrainer.train_window"),
    ("parallel/ps_trainer.py", "ShardedEmbeddingTrainer._eval_outputs"),
    ("parallel/dp_trainer.py", "DataParallelTrainer.train_step_staged"),
    ("parallel/dp_trainer.py", "DataParallelTrainer._train_window"),
    ("parallel/dp_trainer.py", "DataParallelTrainer._eval_outputs"),
    ("worker/trainer.py", "Trainer._train_step"),
    ("worker/trainer.py", "Trainer._eval_outputs"),
    ("serving/runtime.py", "ServingReplica._run"),
    ("parallel/ring_attention.py", "ring_attention_pallas"),
}


def test_hot_path_markers_are_the_jax_compiled_steps():
    from elasticdl_tpu_torch.analysis.traced import traced_index

    marked = set()
    for path in sorted(PORT.rglob("*.py")):
        index = traced_index(SourceFile.parse(str(path)))
        for qualname, reason in index.traced.items():
            if reason.startswith("marked # hot-path"):
                marked.add((str(path.relative_to(PORT)), qualname))
    assert marked == HOT_STEPS


def test_main_paths_kernels_are_hot():
    """The kernels' wrappers on the DeepFM and LM steps are reached from
    the marked steps and module roots across modules."""
    files = [SourceFile.parse(str(p)) for p in sorted(PORT.rglob("*.py"))]
    index = build_program_index(files)
    hot = {fq for fq, fn in index.functions.items()
           if fn.info.qualname in index.modules[fn.module].traced.traced}
    for fq in ("elasticdl_tpu_torch.ops.sparse_embedding.fused_lookup_fm",
               "elasticdl_tpu_torch.ops.sparse_embedding.fused_dedup_apply",
               "elasticdl_tpu_torch.ops.sparse_embedding._launch_apply",
               "elasticdl_tpu_torch.ops.flash_attention.flash_attention_fwd",
               "elasticdl_tpu_torch.ops.flash_attention.flash_attention_bwd",
               "elasticdl_tpu_torch.serving.export.ServingModel.predict",
               "elasticdl_tpu_torch.parallel.sparse_optim.SparseOptimizer.apply"):
        assert fq in hot, fq
    assert "elasticdl_tpu_torch.ops._build.library" not in hot  # behind functools.cache
    assert "elasticdl_tpu_torch.parallel.ps_trainer.ShardedEmbeddingTrainer.eval_step" \
        not in hot


def test_analyzer_full_sweep_stays_under_budget():
    import time

    start = time.perf_counter()
    report = scan([str(PORT)], ALL_RULES.values())
    assert report.files
    assert time.perf_counter() - start < 60.0


def test_function_at_maps_a_line_to_its_innermost_function():
    """What phase 42's census maps each sync's file:line through."""
    from elasticdl_tpu_torch.analysis.traced import traced_index

    source = SourceFile.parse("fixture.py", textwrap.dedent("""
        import functools

        class T:
            @functools.cache
            def outer(self, x):
                def inner(y):
                    return y
                return inner(x)

        def host():
            return 1
        """))
    index = traced_index(source)
    assert index.function_at(5).qualname == "T.outer"  # its decorator line
    assert index.function_at(8).qualname == "T.outer.inner"
    assert index.function_at(9).qualname == "T.outer"
    assert index.function_at(12).qualname == "host"
    assert index.function_at(2) is None
