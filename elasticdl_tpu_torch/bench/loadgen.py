"""The delayed-label feed of the model-quality plane: the label half of
the JAX package's ``scripts/loadgen.py`` (``label_mapping``,
``run_label_feed``).

A served request's label arrives later than its prediction, keyed by the
trace id the request carried.  ``label_mapping`` computes the labels of a
group of served requests with ``data/stream.feedback_labels`` (the
stream's ``click_label_rule`` through the ``stream.labels`` fault site:
``error`` flips every label, a poisoned feed; ``truncate`` withholds the
group, an outage).  ``run_label_feed`` replays groups to every replica's
``labels`` request (``PredictClient.send_labels``): the feed does not know
which replica served a prediction, so every replica sees every label and
the ones that did not sample it count an orphan.

The request side of the JAX load generator (its seeded request stream,
open and closed loops and client spans) is not here: the port's callers
(``chip_smoke.py``) send their own traced requests and hand the feed
``(trace_id, features)`` pairs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch.data.stream import feedback_labels

#: One served request: its trace id and the features it sent.
Request = Tuple[str, Dict[str, np.ndarray]]


def label_mapping(requests: Iterable[Request]) -> Optional[Dict[str, np.ndarray]]:
    """Ground-truth labels of ``requests`` keyed by their trace ids, in the
    order given; None when the feed withholds the group (an outage loses
    the whole group, as in JAX)."""
    mapping: Dict[str, np.ndarray] = {}
    for trace_id, features in requests:
        labels = feedback_labels(features)
        if labels is None:
            return None
        mapping[trace_id] = labels
    return mapping


def run_label_feed(send_fns: Sequence[Callable[[Dict[str, np.ndarray]], dict]],
                   requests: Sequence[Request], group: int = 32, delay_s: float = 0.0,
                   sleep=time.sleep) -> dict:
    """Replay the labels of ``requests`` in groups of ``group``, each
    group BROADCAST to every send_fn.  Returns the feed summary (the JAX
    package's keys); send failures and outages are counted, never
    raised."""
    stats = {"groups": 0, "outages": 0, "send_errors": 0, "labels_sent": 0, "received": 0,
             "joined": 0}
    group = max(1, group)
    for start in range(0, len(requests), group):
        if delay_s > 0:
            sleep(delay_s)
        mapping = label_mapping(requests[start:start + group])
        stats["groups"] += 1
        if mapping is None:
            stats["outages"] += 1
            continue
        stats["labels_sent"] += len(mapping)
        for send_fn in send_fns:
            try:
                reply = send_fn(mapping)
            except Exception:  # the feed keeps going; the gate degrades
                stats["send_errors"] += 1
                continue
            if isinstance(reply, dict):
                stats["received"] += int(reply.get("received", 0))
                stats["joined"] += int(reply.get("joined", 0))
    return stats
