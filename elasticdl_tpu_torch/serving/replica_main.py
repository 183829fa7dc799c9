"""Serving replica process entrypoint: the port of
``elasticdl_tpu/serving/replica_main.py``.

One replica = one process = one ``ServingReplica`` (device runtime, on
the card unless ``--device cpu``) + one ``MicroBatcher`` (front door) +
one ``ServingFrontend`` (the HTTP edge) + one ``MetricsExporter``; with
``--pub_dir`` a ``DeltaWatcher`` keeps it tracking the published delta
chain.  SIGTERM or SIGINT ends the serve loop, and one ``finally`` tears
everything down; the process exits 0.

    python -m elasticdl_tpu_torch.serving.replica_main \
        --model_dir <full artifact> --serve_dir <dir> [--pub_dir <dir>]

Discovery rides the shared ``--serve_dir``:

- ``replica-<id>.json``: this replica's bound predict port, metrics port
  and pid (atomic tmp+rename write).  ``live_replicas()`` is the reader:
  it skips entries whose pid is gone.
- ``events.jsonl``: every replica journals into the shared serve-dir
  journal (append mode): ``serving_replica_start`` (with the seconds from
  process start to serving and the JAX/gRPC modules loaded, none),
  ``model_swap``, ``request_shed``, and ``serving_telemetry`` once per
  ``--telemetry_interval_s`` and once at exit.

The JAX package's flags are kept, with their names and defaults, and
select their planes as in JAX (``replica_main.py:184-212,318-352``):

- request tracing: an ``ExemplarSampler`` (``serving/ledger.py``) with
  ``--trace_head_every``, ``--trace_exemplar_capacity`` and
  ``--trace_tail_threshold_ms`` (0 ties it to ``--slo_p99_ms``) samples
  the requests that carry a trace id; its spans name the process
  ``replica_<id>``, and ``serving_telemetry`` carries the slowest
  exemplar;
- the SLO plane (``obs/slo.py``), ticked by the telemetry loop and served
  on ``/slo``: ``--slo_availability_target`` > 0 registers the
  availability SLO, ``--slo_p99_ms`` > 0 the p99 latency SLO,
  ``--freshness_slo_s`` > 0 with ``--pub_dir`` the freshness SLO, each
  over ``--slo_compliance_window_s``; a fired latency alert carries the
  slowest exemplars' trace ids.

- the model-quality plane (``obs/quality.py``), all or nothing on
  ``--quality_join_window_s`` > 0: the sampler notes each sampled served
  request in a ``QualityLedger`` that the frontend's ``labels`` request
  joins, the joins fill the ``ReplayBuffer`` of the ``CanaryGate`` that
  the ``DeltaWatcher`` runs every delta link through, and the batcher's
  dispatch hook feeds the serve side of a ``DriftMonitor``.  The
  telemetry loop journals the ``quality_window`` (and sets the
  ``elasticdl_quality_*`` gauges) before the SLO tick, then evaluates
  the drift; ``--quality_slo_logloss`` > 0 registers the
  ``model_quality`` SLO over the logloss gauge.

``serving/supervisor.py`` runs a fleet of these processes and replaces a
dead one with a fresh id.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import tempfile
import threading
import time
from typing import List

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.boundary import forbidden_modules_loaded
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("serving.replica")


# ---------------------------------------------------------------------------
# Serve-dir discovery
# ---------------------------------------------------------------------------


def replica_info_file(serve_dir: str, replica_id: int) -> str:
    return os.path.join(serve_dir, f"replica-{replica_id}.json")


def write_replica_info(serve_dir: str, replica_id: int, info: dict) -> str:
    """Atomic tmp+rename publish (a reader never sees a torn write)."""
    path = replica_info_file(serve_dir, replica_id)
    fd, tmp = tempfile.mkstemp(prefix="replica.", dir=serve_dir)
    with os.fdopen(fd, "w") as f:
        json.dump(info, f)
    os.replace(tmp, path)
    return path


def live_replicas(serve_dir: str) -> List[dict]:
    """Every published replica whose pid is still alive, sorted by
    replica id.  Stale files from SIGKILLed replicas (their relaunch
    gets a FRESH id) are skipped, not deleted — the journal, not the
    serve dir, is the record of what happened."""
    out = []
    try:
        names = os.listdir(serve_dir)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith("replica-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(serve_dir, name)) as f:
                info = json.load(f)
            os.kill(int(info["pid"]), 0)
        except (OSError, ValueError, KeyError):
            continue
        out.append(info)
    return sorted(out, key=lambda i: i.get("replica_id", 0))


# ---------------------------------------------------------------------------
# Entrypoint
# ---------------------------------------------------------------------------


def parse_replica_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="elasticdl_tpu_torch serving replica")
    parser.add_argument("--model_dir", required=True,
                        help="export.py artifact to serve")
    parser.add_argument("--serve_dir", required=True,
                        help="shared discovery + journal directory")
    parser.add_argument("--replica_id", type=int, default=0)
    parser.add_argument("--port", type=int, default=0,
                        help="predict port (0 = ephemeral)")
    parser.add_argument("--metrics_port", type=int, default=0)
    parser.add_argument("--model_zoo", default="",
                        help="accepted for the JAX package's argv; the port "
                             "resolves model_def in its own zoo")
    parser.add_argument("--sparse_kernel", default="auto",
                        choices=("xla", "fused", "auto"),
                        help="accepted for the JAX package's argv; the port "
                             "has one route, the hand-written kernel")
    parser.add_argument("--device", default="cuda",
                        help="the card (default) or cpu; without CUDA only "
                             "--device cpu runs")
    parser.add_argument("--max_batch_size", type=int, default=64)
    parser.add_argument("--max_wait_us", type=int, default=2000)
    parser.add_argument("--queue_limit", type=int, default=256)
    parser.add_argument("--telemetry_interval_s", type=float, default=1.0)
    parser.add_argument("--pub_dir", default="",
                        help="delta-chain publish dir (checkpoint/delta.py); "
                             "when set, a DeltaWatcher keeps this replica "
                             "tracking the newest servable generation")
    parser.add_argument("--pub_poll_interval_s", type=float, default=2.0)
    parser.add_argument("--freshness_slo_s", type=float, default=0.0,
                        help="event-time -> servable-model lag SLO; 0 "
                             "disables breach evaluation")
    parser.add_argument("--warmup_features", default="",
                        help="npz file of one example request; every "
                             "padded bucket runs once from it before traffic")
    parser.add_argument("--slo_availability_target", type=float, default=0.0,
                        help="serving-availability SLO objective (e.g. "
                             "0.999); 0 registers no availability SLO")
    parser.add_argument("--slo_p99_ms", type=float, default=0.0,
                        help="p99 latency bound for the serving-latency "
                             "SLO; 0 registers no latency SLO")
    parser.add_argument("--slo_compliance_window_s", type=float,
                        default=3600.0,
                        help="rolling error-budget window for this "
                             "replica's SLOs")
    parser.add_argument("--trace_head_every", type=int, default=128,
                        help="deterministic head-sampling period of the "
                             "request-trace exemplar sampler (1-in-N "
                             "traced requests journal; 0 disables head "
                             "samples)")
    parser.add_argument("--trace_exemplar_capacity", type=int, default=64,
                        help="bounded in-memory exemplar ring size")
    parser.add_argument("--trace_tail_threshold_ms", type=float, default=0.0,
                        help="tail-exemplar latency threshold; 0 ties it "
                             "to --slo_p99_ms (the SLO the fleet pages "
                             "on defines 'slow')")
    parser.add_argument("--quality_join_window_s", type=float, default=0.0,
                        help="label-join watermark window of the model-"
                             "quality plane (obs/quality.py): sampled "
                             "predictions wait this long for their "
                             "delayed label; 0 disables the whole plane "
                             "(ledger, drift sketches, canary gate)")
    parser.add_argument("--quality_window_size", type=int, default=2048,
                        help="joined (prediction, label) pairs in the "
                             "online AUC/logloss window")
    parser.add_argument("--quality_gate_max_logloss_regress", type=float,
                        default=0.10,
                        help="candidate-vs-live logloss regression that "
                             "HOLDs a delta swap")
    parser.add_argument("--quality_gate_max_auc_drop", type=float,
                        default=0.05,
                        help="candidate-vs-live AUC drop that HOLDs a "
                             "delta swap")
    parser.add_argument("--quality_gate_min_rows", type=int, default=64,
                        help="labeled replay rows required before the "
                             "gate can score (below = quality unknown)")
    parser.add_argument("--quality_unknown_policy", default="open",
                        choices=("open", "closed"),
                        help="gate verdict when quality is unknown "
                             "(label outage / cold buffer): open passes "
                             "the swap, closed holds it")
    parser.add_argument("--quality_gate_force", action="store_true",
                        help="escape hatch: swap even on a beyond-"
                             "threshold regression (journaled "
                             "outcome=forced)")
    parser.add_argument("--quality_drift_threshold", type=float,
                        default=0.25,
                        help="train-serve sketch divergence (total "
                             "variation) that journals a quality_drift "
                             "breach")
    parser.add_argument("--quality_slo_logloss", type=float, default=0.0,
                        help="online-logloss bound for the model_quality "
                             "SLO; 0 registers no quality SLO")
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        logger.warning("Ignoring unknown replica args: %s", unknown)
    return args


def _build_slo_plane(args):
    """This replica's SLO plane over the process registry: the history
    sampler always runs (it feeds /slo); each SLO registers when its
    flag asks for it.  The telemetry loop ticks it."""
    from elasticdl_tpu_torch.obs.slo import (
        SLOPlane,
        freshness_slo,
        quality_slo,
        serving_availability_slo,
        serving_latency_slo,
    )

    specs = []
    window_s = float(args.slo_compliance_window_s)
    if args.slo_availability_target > 0:
        specs.append(serving_availability_slo(args.slo_availability_target,
                                              compliance_window_s=window_s))
    if args.slo_p99_ms > 0:
        specs.append(serving_latency_slo(args.slo_p99_ms, compliance_window_s=window_s))
    if args.freshness_slo_s > 0 and args.pub_dir:
        specs.append(freshness_slo(args.freshness_slo_s, compliance_window_s=window_s))
    if args.quality_slo_logloss > 0 and args.quality_join_window_s > 0:
        specs.append(quality_slo(args.quality_slo_logloss, compliance_window_s=window_s))
    return SLOPlane(specs=specs, origin=f"replica_{args.replica_id}")


def _build_quality_plane(args):
    """The model-quality plane (``obs/quality.py``), all or nothing on
    ``--quality_join_window_s``: the label-join ledger feeding a replay
    buffer, the drift monitor, and the canary gate the DeltaWatcher runs
    every delta link through.  (quality, drift, gate), or three Nones
    when disabled, so the rest of main() wires nothing."""
    if args.quality_join_window_s <= 0:
        return None, None, None
    from elasticdl_tpu_torch.obs.quality import (
        CanaryGate,
        DriftMonitor,
        QualityLedger,
        ReplayBuffer,
    )

    origin = f"replica_{args.replica_id}"
    replay = ReplayBuffer()
    quality = QualityLedger(window_size=args.quality_window_size,
                            join_window_s=args.quality_join_window_s, origin=origin,
                            replay=replay)
    drift = DriftMonitor(threshold=args.quality_drift_threshold, origin=origin)
    gate = CanaryGate(replay, max_logloss_regress=args.quality_gate_max_logloss_regress,
                      max_auc_drop=args.quality_gate_max_auc_drop,
                      min_rows=args.quality_gate_min_rows,
                      unknown_policy=args.quality_unknown_policy, force=args.quality_gate_force)
    return quality, drift, gate


def _telemetry_loop(stop: threading.Event, interval_s: float, replica, batcher,
                    replica_id: int, slo_plane=None, sampler=None, quality=None, drift=None):
    from elasticdl_tpu_torch.serving.ledger import ledger

    while not stop.wait(interval_s):
        if quality is not None:
            try:
                # The window's gauges BEFORE the SLO tick samples the
                # registry, so the quality SLO never scores stale data.
                quality.journal_window(time.monotonic())
            except Exception:
                logger.exception("quality window journal failed")
        if drift is not None:
            try:
                drift.evaluate(time.monotonic())
            except Exception:
                logger.exception("drift evaluation failed")
        if slo_plane is not None:
            try:
                slo_plane.tick()
            except Exception:
                logger.exception("SLO tick failed")
        _journal_telemetry(replica, batcher, replica_id, ledger().snapshot(), sampler)


def _journal_telemetry(replica, batcher, replica_id: int, snap: dict, sampler=None):
    stats = replica.stats()
    phase_p99 = snap.get("phase_p99_ms", {})
    extra = {}
    slowest = sampler.slowest() if sampler is not None else None
    if slowest is not None:
        # The slowest recent exemplar (obs.top --serving's footer).
        extra["exemplar"] = {"trace_id": slowest["trace_id"],
                             "latency_ms": slowest["latency_ms"],
                             "dominant_phase": slowest["dominant_phase"]}
    obs.journal().record(
        "serving_telemetry",
        replica_id=replica_id,
        generation=stats["generation"],
        step=stats["step"],
        model_event_time=stats.get("model_event_time", 0.0),
        inflight=stats["inflight"],
        queue_depth=batcher.queue_depth(),
        qps=snap["qps"],
        p50_ms=snap["p50_ms"],
        p99_ms=snap["p99_ms"],
        queue_p99_ms=phase_p99.get("queue", 0.0),
        batch_p99_ms=phase_p99.get("batch", 0.0),
        execute_p99_ms=phase_p99.get("execute", 0.0),
        respond_p99_ms=phase_p99.get("respond", 0.0),
        availability_ratio=snap["availability_ratio"],
        served=snap["counts"]["served"],
        dropped=snap["counts"]["dropped"],
        shed=snap["counts"]["shed"],
        errors=snap["counts"]["error"],
        **extra,
    )


#: The JAX, gRPC or JAX-package modules this process has imported (the
#: port imports none; the start event records the proof).
_loaded_forbidden = forbidden_modules_loaded


def main(argv=None) -> int:
    args = parse_replica_args(argv)
    os.makedirs(args.serve_dir, exist_ok=True)
    obs.init_journal(args.serve_dir)

    from elasticdl_tpu_torch.common import faults
    from elasticdl_tpu_torch.obs import tracing
    from elasticdl_tpu_torch.obs.exporter import MetricsExporter
    from elasticdl_tpu_torch.obs.freshness import FreshnessTracker
    from elasticdl_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
    from elasticdl_tpu_torch.serving.continuous import DeltaWatcher
    from elasticdl_tpu_torch.serving.frontend import ServingFrontend, decode_features
    from elasticdl_tpu_torch.serving.ledger import ExemplarSampler, ledger
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    if faults.install_from_env():
        logger.warning("Replica %d: fault injection armed from env", args.replica_id)
    # Every replica of a fleet appends to one serve-dir journal; its span
    # records carry their own process name.
    tracing.set_process(f"replica_{args.replica_id}")

    t_start = time.perf_counter()
    replica = ServingReplica(args.model_dir, device=args.device)
    quality, drift, gate = _build_quality_plane(args)
    book = ledger()
    batcher = MicroBatcher(
        replica.execute,
        BatcherConfig(
            max_batch_size=args.max_batch_size,
            max_wait_us=args.max_wait_us,
            queue_limit=args.queue_limit,
        ),
        on_request=book.record_request,
        on_shed=book.record_shed,
        on_batch=drift.observe_serve if drift is not None else None,
    ).start()
    sampler = ExemplarSampler(head_every=args.trace_head_every,
                              tail_threshold_ms=args.trace_tail_threshold_ms or args.slo_p99_ms,
                              capacity=args.trace_exemplar_capacity, replica_id=args.replica_id,
                              quality=quality)
    # Every resource below owns a daemon thread and/or a listening
    # socket; a failure anywhere between start() and the serve loop
    # (warmup decode, bind error, pub_dir scan) must still drain them
    # all, so teardown lives in one finally covering the whole lifetime.
    frontend = None
    exporter = None
    watcher = None
    telemetry = None
    slo_plane = None
    stop = threading.Event()
    try:
        if args.warmup_features:
            with open(args.warmup_features, "rb") as f:
                example = decode_features(f.read())
            replica.warmup(example, batcher.buckets)
            logger.info("Warmed %d bucket shapes", len(batcher.buckets))

        frontend = ServingFrontend(replica, batcher, port=args.port, sampler=sampler,
                                   quality=quality)
        port = frontend.start()
        slo_plane = _build_slo_plane(args)
        # A latency page carries the slowest sampled trace ids.
        slo_plane.slos.set_exemplar_provider(lambda _slo: sampler.trace_ids(4))
        exporter = MetricsExporter(port=args.metrics_port, slo_plane=slo_plane).start()
        write_replica_info(args.serve_dir, args.replica_id, {
            "replica_id": args.replica_id,
            "pid": os.getpid(),
            "port": port,
            "metrics_port": exporter.port,
            "model_dir": args.model_dir,
        })
        obs.journal().record(
            "serving_replica_start",
            replica_id=args.replica_id,
            port=port,
            model_dir=args.model_dir,
            generation=replica.stats()["generation"],
            device=str(replica.device),
            startup_s=round(time.perf_counter() - t_start, 6),
            forbidden_modules=_loaded_forbidden(),
        )

        def _shutdown(signum, frame):
            logger.info("Replica %d: signal %d, shutting down", args.replica_id, signum)
            stop.set()

        signal.signal(signal.SIGTERM, _shutdown)
        signal.signal(signal.SIGINT, _shutdown)

        telemetry = threading.Thread(
            target=_telemetry_loop,
            args=(stop, args.telemetry_interval_s, replica, batcher, args.replica_id,
                  slo_plane, sampler, quality, drift),
            name="serving-telemetry",
            daemon=True,
        )
        telemetry.start()

        if args.pub_dir:
            freshness = (FreshnessTracker(args.freshness_slo_s)
                         if args.freshness_slo_s > 0 else None)
            watcher = DeltaWatcher(
                replica, args.pub_dir, freshness=freshness, gate=gate, buckets=batcher.buckets,
                origin=f"replica_{args.replica_id}",
            ).start(args.pub_poll_interval_s)
            logger.info("Tracking delta chain in %s every %.1fs%s", args.pub_dir,
                        args.pub_poll_interval_s, " (canary-gated)" if gate is not None else "")

        while not stop.wait(0.5):
            pass
    finally:
        stop.set()
        if watcher is not None:
            watcher.stop()
        if frontend is not None:
            frontend.stop()
        batcher.stop()
        if exporter is not None:
            exporter.stop()
        if slo_plane is not None:
            slo_plane.stop()
        if telemetry is not None:
            telemetry.join(timeout=5)
            # The last word of this replica: its final counts.
            _journal_telemetry(replica, batcher, args.replica_id, book.snapshot(), sampler)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
