"""Machine-checked invariants of the port: the counterpart of
``elasticdl_tpu/analysis/``.

- a static analyzer, ``python -m elasticdl_tpu_torch.analysis [paths]``
  (default: the ``elasticdl_tpu_torch`` package), with one checker per
  rule under the JAX package's rule names: six control-plane rules
  (``rules.py``), three whole-program protocol rules
  (``protocol_rules.py``, over the cross-module index of ``program.py``)
  and six hot-path rules (``torch_rules.py``, over the hot-ness core of
  ``traced.py``: ``nn.Module.forward``, ``autograd.Function``, and the
  steps marked ``# hot-path``).  ``journal_schema.py`` is the port's
  event registry the ``journal-schema`` rule reads; ``report.py`` renders
  the per-rule table of ``--format json``.  A deliberate exception is
  suppressed with ``# noqa-invariant: <rule> (<reason>)``;
- the runtime lock-order checker (``runtime.py``), armed by
  ``ELASTICDL_LOCKCHECK=1``: the services create their locks through its
  ``make_lock``.

Both import the standard library only, so the checks run on any box the
code does, including one without torch.

This ``__init__`` exports the analyzer's names lazily (PEP 562), as the
JAX package's does: a service that imports ``make_lock`` must never load
an analyzer, and a broken analyzer must never stop a master from
starting.
"""

_EXPORTS = {
    "SourceFile": "core",
    "Violation": "core",
    "discover_files": "core",
    "format_violations": "core",
    "run_checks": "core",
    "scan": "core",
    "ScanReport": "core",
    "ALL_RULES": "rules",
    "RULE_NAMES": "rules",
    "TORCH_RULES": "torch_rules",
    "TracedIndex": "traced",
    "traced_index": "traced",
}


def __getattr__(name):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(
        importlib.import_module(f"{__name__}.{submodule}"), name
    )


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
