"""Placement rule tables: the placement half of
``elasticdl_tpu/parallel/compile.py`` (its ``Rule``, ``RuleTable`` and
``match_partition_rules``, :69-185).

A rule table is an ordered list of ``(regex over the '/'-joined leaf
path, placement)`` entries matched over a state tree (nested dicts,
lists and tuples of tensors or arrays); the first match wins.  A
placement here is a mesh axis name (the leaf's dim 0 is split over that
axis) or None (replicated), or a callable ``(path, shape) -> placement``
for a shape-aware rule such as the sparse tables' block divisibility.
Scalar leaves (0-d, or of one element) replicate without consulting the
table; a non-scalar leaf that no rule matches raises, so every placement
is declared.

The JAX module's other half has no counterpart: PyTorch runs eagerly,
so there is nothing to jit, and ``CompilePlan``, ``select_strategy`` and
``shard_map_call`` are not ported.  The sharded sparse dispatch loops
over its shards itself (``ops/sparse_embedding.py``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Rule:
    """``pattern`` is searched in the leaf's '/'-joined path; ``spec`` is
    the placement (an axis name or None) or a callable ``(path, shape)
    -> placement``."""

    pattern: str
    spec: Any


def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return [(str(i), child) for i, child in enumerate(node)]
    return None


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` over a tree, keys '/'-joined."""
    out = []

    def walk(node, path):
        children = _children(node)
        if children is None:
            out.append(("/".join(path), node))
            return
        for key, child in children:
            walk(child, path + (str(key),))

    walk(tree, ())
    return out


def _rebuild(node, leaves):
    """``node``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(node, dict):
        return {key: _rebuild(child, leaves) for key, child in node.items()}
    if isinstance(node, (list, tuple)):
        items = [_rebuild(child, leaves) for child in node]
        return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
    return next(leaves)


class RuleTable:
    """Ordered placement rules over a tree (the JAX ``RuleTable``):
    first match wins, scalars replicate, an unmatched non-scalar leaf
    raises."""

    def __init__(self, rules: Sequence[Rule], name: str = ""):
        self.name = name
        self.rules = tuple(rules)
        self._compiled = [re.compile(rule.pattern) for rule in self.rules]

    def match(self, tree):
        """-> ``(placements tree, stats)``: ``stats`` holds the rule hits,
        the misses (always 0: a miss raises), the rules that matched
        nothing, the scalar leaves and the hits per rule."""
        hits = [0] * len(self.rules)
        scalars = 0
        placements = []
        for path, leaf in tree_paths(tree):
            shape = tuple(getattr(leaf, "shape", None) or np.shape(leaf))
            if len(shape) == 0 or int(np.prod(shape)) == 1:
                scalars += 1
                placements.append(None)
                continue
            for i, regex in enumerate(self._compiled):
                if regex.search(path) is not None:
                    hits[i] += 1
                    spec = self.rules[i].spec
                    placements.append(spec(path, shape) if callable(spec) else spec)
                    break
            else:
                raise ValueError(
                    f"rule table {self.name!r} has no rule for leaf {path!r} (shape {shape}): "
                    "every non-scalar leaf must be covered (add a rule, or a catch-all '.*' "
                    "entry that replicates)"
                )
        stats: Dict[str, Any] = {
            "rule_hits": int(sum(hits)),
            "rule_misses": 0,
            "unused_rules": int(sum(1 for h in hits if h == 0)),
            "scalars": scalars,
            "per_rule": {rule.pattern: hit for rule, hit in zip(self.rules, hits)},
        }
        return _rebuild(tree, iter(placements)), stats


def match_partition_rules(rules: Sequence[Rule], tree):
    """Functional form: the placements tree only."""
    return RuleTable(rules).match(tree)[0]
