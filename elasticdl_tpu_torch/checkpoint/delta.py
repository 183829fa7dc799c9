"""Incremental (delta) serving checkpoints: the port of
``elasticdl_tpu/checkpoint/delta.py``, in its on-disk layout.

A full serving artifact (``serving/export.py``) holds every table row;
between publishes only the storage blocks the optimizer touched change,
and the exporter recovers them by diffing the packed tables against the
last published ones (its *head*, held in host memory).  A delta:

    <pub_dir>/delta_<base_step>_<step>/
      delta.json       - chain link: format "elasticdl_tpu_delta/1",
                         base_step -> step, event_time, per-table
                         changed-block inventory
      dense.pkl        - the FULL dense variables tree (the artifact's
                         variables.pkl; table leaves stay
                         {"__table__": "tables/<i>.npy"} references)
      rows_<i>.npy     - int64 changed packed-block indices of table i
      vals_<i>.npy     - those blocks' new values, same order
      integrity.json   - CRC32 over all of the above, written before the
                         atomic commit rename

Fulls live beside deltas (``full_<step>/``, an artifact plus the same
integrity manifest), forming a chain ``full_100 <- delta_100_120 <-
delta_120_140 <- ...``.  ``resolve_chain`` walks it from the newest good
full, QUARANTINES a link that fails its manifest (renamed aside, never
deleted) and stops at the first gap: the consumer serves what survives.
``compact`` folds the head back into a fresh full, which bounds the
chain and repairs a quarantine gap.

The exporter is one process's: on a process mesh ``export_model`` is a
collective every rank calls, and the publishing belongs to rank 0.
``ckpt.delta`` is a fault site of every ``publish_delta``: a ``truncate``
fault tears the largest file of the delta after the manifest recorded
its CRC, so the consumer quarantines the link, and journals
``checkpoint_quarantined``.  Each publish observes the
``elasticdl_checkpoint_*`` metrics (kinds ``serving_full`` and
``delta``) and journals the JAX package's events with its fields:
``checkpoint_saved`` (a full), ``delta_checkpoint`` (``step``,
``base_step``, ``rows``, ``tables``, ``event_time``) and
``delta_compaction`` (``step``, ``deltas_folded``, ``event_time``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.checkpoint.saver import (
    _ckpt_metrics,
    verify_integrity,
    write_integrity_manifest,
)
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.serving.export import export_model, read_variables

logger = get_logger("checkpoint.delta")

DELTA_FORMAT = "elasticdl_tpu_delta/1"
DELTA_MANIFEST = "delta.json"
_DENSE_FILE = "dense.pkl"
_QUARANTINE_SUFFIX = ".quarantined"


def _full_name(step: int) -> str:
    return f"full_{step:012d}"


def _delta_name(base_step: int, step: int) -> str:
    return f"delta_{base_step:012d}_{step:012d}"


def quarantine_artifact(path: str, reason: str) -> str:
    """Move a corrupt full or delta aside (never deleted: it is the
    evidence) so no later chain walk picks it again."""
    target = path + _QUARANTINE_SUFFIX
    n = 2
    while os.path.exists(target):
        target = f"{path}{_QUARANTINE_SUFFIX}.{n}"
        n += 1
    logger.error("Quarantining corrupt artifact %s -> %s (%s)", path, target, reason)
    _ckpt_metrics()[3].inc()
    try:
        os.rename(path, target)
    except OSError:
        logger.exception("Quarantine rename failed for %s", path)
    obs.journal().record("checkpoint_quarantined", path=path, reason=reason)
    return target


def _apply_delta_write_fault(tmp_dir: str, filenames: List[str]) -> None:
    """The ``ckpt.delta`` fault site: tear the largest inventoried file
    after the manifest recorded its checksum."""
    spec = faults.fire("ckpt.delta")
    if spec is None or spec.kind != "truncate":
        return
    target = max((os.path.join(tmp_dir, name) for name in filenames), key=os.path.getsize)
    size = os.path.getsize(target)
    keep = int(spec.arg) if spec.arg else size // 2
    with open(target, "r+b") as f:
        f.truncate(keep)
    logger.warning("FAULT INJECTION: truncated delta file %s to %d of %d bytes",
                   target, keep, size)


class DeltaExporter:
    """Publishes the full/delta chain of one trainer (the port's
    ``ShardedEmbeddingTrainer``) into ``pub_dir``.  The head holds the
    last published packed tables in host memory, so each delta is a pure
    array diff; it costs one model's tables, as the export does."""

    def __init__(self, pub_dir: str, model_zoo: str = "", model_def: str = "",
                 model_params: str = "", keep_fulls: int = 2):
        self._pub_dir = pub_dir
        self._model_zoo = model_zoo
        self._model_def = model_def
        self._model_params = model_params
        self._keep_fulls = max(1, keep_fulls)
        os.makedirs(pub_dir, exist_ok=True)
        self._head: Dict[str, np.ndarray] = {}  # table key -> packed table
        self._head_step: Optional[int] = None
        self._head_signature: Optional[dict] = None
        self._head_dense: Optional[bytes] = None  # the pickled ref-tree
        self._head_event_time = 0.0
        self._deltas_since_full = 0

    @property
    def head_step(self) -> Optional[int]:
        return self._head_step

    @property
    def deltas_since_full(self) -> int:
        return self._deltas_since_full

    def _export_to_tmp(self, trainer) -> str:
        tmp_dir = tempfile.mkdtemp(prefix="publish.tmp", dir=self._pub_dir)
        export_model(trainer, tmp_dir, model_zoo=self._model_zoo, model_def=self._model_def,
                     model_params=self._model_params)
        return tmp_dir

    def _ingest_tmp(self, tmp_dir: str, event_time: float) -> dict:
        """The freshly exported artifact becomes the head."""
        with open(os.path.join(tmp_dir, "signature.json")) as f:
            signature = json.load(f)
        # In memory (np.load reads, it does not map): the tmp dir is
        # renamed or deleted next.
        self._head = {meta["key"]: np.load(os.path.join(tmp_dir, meta["file"]))
                      for meta in signature["tables"]}
        with open(os.path.join(tmp_dir, "variables.pkl"), "rb") as f:
            self._head_dense = f.read()
        self._head_step = int(signature["step"])
        self._head_signature = signature
        self._head_event_time = float(event_time)
        return signature

    def publish_full(self, trainer, event_time: float = 0.0) -> str:
        """Export a full artifact as the new chain base (with the integrity
        manifest) and reset the head."""
        start = time.monotonic()
        tmp_dir = self._export_to_tmp(trainer)
        signature = self._ingest_tmp(tmp_dir, event_time)
        step = int(signature["step"])
        # The event-time frontier for freshness readers (load_for_serving
        # ignores extra keys).
        signature["event_time"] = float(event_time)
        with open(os.path.join(tmp_dir, "signature.json"), "w") as f:
            json.dump(signature, f, indent=2)
        files = ["signature.json", "variables.pkl"] + [m["file"] for m in signature["tables"]]
        write_integrity_manifest(tmp_dir, files)
        final_dir = os.path.join(self._pub_dir, _full_name(step))
        if os.path.exists(final_dir):
            shutil.rmtree(tmp_dir, ignore_errors=True)
            return final_dir
        os.rename(tmp_dir, final_dir)
        self._deltas_since_full = 0
        self._note_saved(start, "serving_full")
        obs.journal().record("checkpoint_saved", step=step, kind="serving_full",
                             event_time=float(event_time))
        logger.info("Published full serving artifact at step %d -> %s", step, final_dir)
        self._garbage_collect()
        return final_dir

    def publish_delta(self, trainer, event_time: float = 0.0) -> Optional[str]:
        """Export only the blocks changed since the last publish; the
        committed delta dir, or None when the step has not advanced past
        the head."""
        if self._head_step is None:
            raise RuntimeError("publish_full must seed the chain first")
        start = time.monotonic()
        tmp_dir = self._export_to_tmp(trainer)
        with open(os.path.join(tmp_dir, "signature.json")) as f:
            signature = json.load(f)
        step = int(signature["step"])
        base_step = self._head_step
        if step <= base_step:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            logger.info("Skipping delta publish: step %d has not advanced past head %d",
                        step, base_step)
            return None

        delta_tmp = tempfile.mkdtemp(prefix="delta.tmp", dir=self._pub_dir)
        files: List[str] = [DELTA_MANIFEST, _DENSE_FILE]
        tables_meta = []
        total_rows = 0
        new_tables: Dict[str, np.ndarray] = {}
        for i, meta in enumerate(signature["tables"]):
            key = meta["key"]
            new = np.load(os.path.join(tmp_dir, meta["file"]))
            new_tables[key] = new
            old = self._head.get(key)
            if old is None or old.shape != new.shape:
                # A resized table: every block is "touched".
                rows = np.arange(new.shape[0], dtype=np.int64)
            else:
                rows = np.flatnonzero(
                    np.any(new != old, axis=tuple(range(1, new.ndim)))).astype(np.int64)
            rows_file, vals_file = f"rows_{i}.npy", f"vals_{i}.npy"
            np.save(os.path.join(delta_tmp, rows_file), rows)
            np.save(os.path.join(delta_tmp, vals_file), new[rows])
            files.extend([rows_file, vals_file])
            total_rows += int(rows.size)
            tables_meta.append({
                "key": key, "index": i, "rows_file": rows_file, "vals_file": vals_file,
                "rows": int(rows.size), "packed_shape": list(new.shape),
                "vocab_size": meta["vocab_size"], "dim": meta["dim"],
            })
        # The dense params ride along whole: the tables dwarf them.
        with open(os.path.join(tmp_dir, "variables.pkl"), "rb") as f:
            dense_bytes = f.read()
        with open(os.path.join(delta_tmp, _DENSE_FILE), "wb") as f:
            f.write(dense_bytes)
        shutil.rmtree(tmp_dir, ignore_errors=True)
        manifest = {"format": DELTA_FORMAT, "base_step": base_step, "step": step,
                    "event_time": float(event_time), "tables": tables_meta}
        with open(os.path.join(delta_tmp, DELTA_MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        write_integrity_manifest(delta_tmp, files)
        _apply_delta_write_fault(delta_tmp, files)
        final_dir = os.path.join(self._pub_dir, _delta_name(base_step, step))
        os.rename(delta_tmp, final_dir)
        # The head mirrors the trainer (from the pristine export, never
        # re-read from the published dir), even when a fault tore the
        # files: the next delta chains from here.
        self._head = new_tables
        self._head_step = step
        self._head_signature = signature
        self._head_dense = dense_bytes
        self._head_event_time = float(event_time)
        self._deltas_since_full += 1
        self._note_saved(start, "delta")
        obs.journal().record("delta_checkpoint", step=step, base_step=base_step,
                             rows=total_rows, tables=len(tables_meta),
                             event_time=float(event_time))
        logger.info("Published delta %d -> %d (%d changed blocks) -> %s",
                    base_step, step, total_rows, final_dir)
        return final_dir

    def compact(self) -> Optional[str]:
        """Fold the head into a fresh full artifact: bounds the chain and
        repairs a quarantine gap after the last full."""
        if self._head_step is None or self._head_signature is None:
            return None
        start = time.monotonic()
        step = self._head_step
        final_dir = os.path.join(self._pub_dir, _full_name(step))
        if os.path.exists(final_dir):
            return final_dir
        tmp_dir = tempfile.mkdtemp(prefix="compact.tmp", dir=self._pub_dir)
        signature = dict(self._head_signature)
        signature["event_time"] = self._head_event_time
        files = ["signature.json", "variables.pkl"]
        os.makedirs(os.path.join(tmp_dir, "tables"), exist_ok=True)
        for meta in signature["tables"]:
            np.save(os.path.join(tmp_dir, meta["file"]), self._head[meta["key"]])
            files.append(meta["file"])
        with open(os.path.join(tmp_dir, "variables.pkl"), "wb") as f:
            f.write(self._head_dense)
        with open(os.path.join(tmp_dir, "signature.json"), "w") as f:
            json.dump(signature, f, indent=2)
        write_integrity_manifest(tmp_dir, files)
        os.rename(tmp_dir, final_dir)
        folded, self._deltas_since_full = self._deltas_since_full, 0
        self._note_saved(start, "serving_full")
        obs.journal().record("delta_compaction", step=step, deltas_folded=folded,
                             event_time=self._head_event_time)
        logger.info("Compacted %d delta(s) into full artifact at step %d", folded, step)
        self._garbage_collect()
        return final_dir

    @staticmethod
    def _note_saved(start: float, metric_kind: str) -> None:
        """The save's metrics; each caller journals its event after."""
        save_hist, _restore, saves, _quarantines = _ckpt_metrics()
        save_hist.observe(time.monotonic() - start, kind=metric_kind)
        saves.inc(kind=metric_kind)

    def _garbage_collect(self) -> None:
        """Drop fulls beyond ``keep_fulls`` and deltas wholly covered by
        the oldest kept full; quarantined dirs are never touched."""
        try:
            fulls, deltas = scan_pub_dir(self._pub_dir)
        except OSError:
            logger.exception("Delta-chain GC scan failed; skipping")
            return
        keep = fulls[-self._keep_fulls:]
        if not keep:
            return
        for step in fulls[: -self._keep_fulls]:
            shutil.rmtree(os.path.join(self._pub_dir, _full_name(step)), ignore_errors=True)
        for base_step, step in deltas:
            if step <= keep[0]:
                shutil.rmtree(os.path.join(self._pub_dir, _delta_name(base_step, step)),
                              ignore_errors=True)


# ----------------------------------------------------------------------
# Consumer side: chain resolution and delta loading
# ----------------------------------------------------------------------


def scan_pub_dir(pub_dir: str) -> Tuple[List[int], List[Tuple[int, int]]]:
    """(sorted full steps, sorted (base_step, step) delta links) committed
    in ``pub_dir``; tmp and quarantined dirs excluded."""
    fulls: List[int] = []
    deltas: List[Tuple[int, int]] = []
    for name in os.listdir(pub_dir):
        if ".tmp" in name or _QUARANTINE_SUFFIX in name:
            continue
        if name.startswith("full_"):
            try:
                fulls.append(int(name[len("full_"):]))
            except ValueError:
                continue
        elif name.startswith("delta_"):
            parts = name[len("delta_"):].split("_")
            try:
                deltas.append((int(parts[0]), int(parts[1])))
            except (IndexError, ValueError):
                continue
    return sorted(fulls), sorted(deltas)


def resolve_chain(pub_dir: str, check_crc: bool = True) -> Tuple[Optional[str], List[str]]:
    """(newest good full dir, the deltas linked from it in apply order).

    Every link is integrity-checked: a corrupt full is quarantined and the
    previous full wins; a corrupt delta is quarantined and ENDS the chain.
    A transient I/O error skips a full, or ends the chain at a delta, for
    this resolve without quarantining."""
    fulls, deltas = scan_pub_dir(pub_dir)
    base_dir = base_step = None
    for step in reversed(fulls):
        full_dir = os.path.join(pub_dir, _full_name(step))
        try:
            reason = verify_integrity(full_dir, check_crc=check_crc)
        except OSError:
            logger.exception("Could not verify full artifact %s (transient I/O?); skipping "
                             "it this resolve", full_dir)
            continue
        if reason is not None:
            quarantine_artifact(full_dir, reason)
            continue
        base_dir, base_step = full_dir, step
        break
    if base_dir is None:
        return None, []
    chain: List[str] = []
    links = dict(deltas)
    cursor = base_step
    while cursor in links:
        step = links[cursor]
        delta_dir = os.path.join(pub_dir, _delta_name(cursor, step))
        try:
            reason = verify_integrity(delta_dir, check_crc=check_crc)
        except OSError:
            logger.exception("Could not verify delta %s (transient I/O?); chain stops here "
                             "this resolve", delta_dir)
            break
        if reason is not None:
            quarantine_artifact(delta_dir, reason)
            break
        chain.append(delta_dir)
        cursor = step
    return base_dir, chain


def load_delta(delta_dir: str) -> dict:
    """One committed delta: its manifest, per table key ``(rows, vals,
    meta)`` and the dense variables tree (table leaves still references),
    read with the artifact's numpy-only unpickler."""
    with open(os.path.join(delta_dir, DELTA_MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != DELTA_FORMAT:
        raise ValueError(f"{delta_dir}: unknown delta format {manifest.get('format')!r}")
    tables = {}
    for meta in manifest["tables"]:
        rows = np.load(os.path.join(delta_dir, meta["rows_file"]))
        vals = np.load(os.path.join(delta_dir, meta["vals_file"]))
        if rows.shape[0] != vals.shape[0]:
            raise ValueError(f"{delta_dir}: rows/vals length mismatch for {meta['key']} "
                             f"({rows.shape[0]} != {vals.shape[0]})")
        tables[meta["key"]] = (rows, vals, meta)
    dense = read_variables(os.path.join(delta_dir, _DENSE_FILE))
    return {"manifest": manifest, "tables": tables, "dense": dense}
