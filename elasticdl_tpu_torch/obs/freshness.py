"""Freshness SLO: event-time -> servable-model lag as a metric, the
port's copy of ``elasticdl_tpu/obs/freshness.py``.

The continuous train->serve loop has three frontiers, each an event
time on the stream's clock:

    watermark   every record with an earlier event time is trained
                (``master/stream.StreamingTaskManager.
                watermark_event_time``)
    published   the newest committed full/delta artifact's frontier
                (checkpoint/delta.py)
    served      the generation currently answering requests
                (serving/runtime.py: ``model_swap`` outcome=applied)

**Freshness lag** is ``now - served``.  The SLO bounds it;
``evaluate(now)`` journals a ``freshness_slo`` event on every state
CHANGE (breach or clear), with the breach attributed to the stage owning
the largest component:

    stream   now       - watermark
    publish  watermark - published
    serving  published - served      (torn delta quarantined, apply
                                      rolled back)

All times are caller-supplied (the driver owns the clock), so a test
evaluates the SLO on a scripted timeline.
"""

from __future__ import annotations

from typing import Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.freshness")


def _metrics():
    return (
        obs.gauge(
            "elasticdl_freshness_lag_seconds",
            "Event-time -> servable-model lag at last evaluation",
        ),
        obs.gauge(
            "elasticdl_freshness_slo_seconds",
            "Configured freshness SLO (0 = unset)",
        ),
        obs.gauge(
            "elasticdl_freshness_breached",
            "1 while the freshness SLO is in breach",
        ),
        obs.counter(
            "elasticdl_freshness_breaches_total",
            "Freshness SLO breach transitions",
        ),
    )


class FreshnessTracker:
    """Tracks the three frontiers and defends the SLO.

    Not thread-safe by design: one owner (a driver, or a replica's
    DeltaWatcher poll loop) feeds and evaluates it."""

    def __init__(self, slo_s: float = 0.0):
        self.slo_s = float(slo_s)
        self._watermark_et: Optional[float] = None
        self._published_et: Optional[float] = None
        self._served_et: Optional[float] = None
        self._served_generation = 0
        self._served_step = 0
        self._breached = False
        lag_g, slo_g, breached_g, _breaches = _metrics()
        slo_g.set(self.slo_s)
        breached_g.set(0)

    # -- frontier feeds --------------------------------------------------

    def note_watermark(self, event_time: float) -> None:
        self._watermark_et = float(event_time)

    def note_published(self, step: int, event_time: float) -> None:
        self._published_et = float(event_time)

    def note_served(
        self, generation: int, step: int, event_time: float
    ) -> None:
        self._served_generation = int(generation)
        self._served_step = int(step)
        self._served_et = float(event_time)

    # -- readouts --------------------------------------------------------

    @property
    def breached(self) -> bool:
        return self._breached

    def lag_s(self, now: float) -> float:
        """Event-time -> servable-model lag; `now` before anything was
        served measures against the stream epoch (lag == now)."""
        served = self._served_et if self._served_et is not None else 0.0
        return max(0.0, float(now) - served)

    def components(self, now: float) -> dict:
        """Per-stage lag decomposition (each >= 0; stages that have not
        reported yet inherit the previous frontier)."""
        now = float(now)
        watermark = self._watermark_et if self._watermark_et is not None else 0.0
        published = (
            self._published_et if self._published_et is not None else watermark
        )
        served = self._served_et if self._served_et is not None else published
        return {
            "stream": max(0.0, now - watermark),
            "publish": max(0.0, watermark - min(published, watermark)),
            "serving": max(0.0, published - min(served, published)),
        }

    def attribute(self, now: float) -> str:
        """The stage owning the largest lag component."""
        comps = self.components(now)
        return max(comps, key=comps.get)

    # -- SLO evaluation --------------------------------------------------

    def evaluate(self, now: float) -> Optional[dict]:
        """Update gauges; on a breach/clear TRANSITION journal (and
        return) the `freshness_slo` event.  No-op without an SLO."""
        lag = self.lag_s(now)
        lag_g, _slo_g, breached_g, breaches = _metrics()
        lag_g.set(lag)
        if self.slo_s <= 0:
            return None
        breach = lag > self.slo_s
        if breach == self._breached:
            return None
        self._breached = breach
        breached_g.set(1 if breach else 0)
        event = dict(
            event="freshness_slo",
            state="breach" if breach else "clear",
            lag_s=round(lag, 6),
            slo_s=self.slo_s,
            stage=self.attribute(now),
            generation=self._served_generation,
            step=self._served_step,
        )
        if breach:
            breaches.inc()
            logger.warning(
                "Freshness SLO BREACH: lag %.3fs > slo %.3fs (stage: %s)",
                lag, self.slo_s, event["stage"],
            )
        else:
            logger.info(
                "Freshness SLO cleared: lag %.3fs <= slo %.3fs",
                lag, self.slo_s,
            )
        obs.journal().record(**event)
        return event
