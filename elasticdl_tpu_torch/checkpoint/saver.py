"""Training-state checkpoints: the port of ``elasticdl_tpu/checkpoint/saver.py``.

The on-disk layout is the JAX package's, so either package restores
what the other wrote: one directory per step, ``step_%012d/``, written
atomically (a tmp dir, then a rename), holding the pickled host state
``state.pkl`` and a CRC32 integrity manifest ``integrity.json``
(``{"files": {name: {"crc32", "size"}}}``), written before the rename.
The state is pickled under the JAX package's class names
(``checkpoint/_pickle.py``), so ``CheckpointSaver.save(trainer.
state_to_jax_host(), step)`` writes what a JAX worker restores.

Restore verifies every inventoried file against its checksum.  A torn
write is proven corruption: the snapshot is QUARANTINED (renamed aside,
never deleted) and restore falls back to the next-newest good step.  A
transient I/O error (``OSError``) only skips the step for this restore,
and so does an environment error while loading; only a checksum or size
mismatch, a garbage manifest or an unloadable pickle quarantines; a
pickle that names a class the port does not read
(``_pickle.RefusedGlobal``) is skipped, not quarantined.
``keep_max`` checkpoints are retained.

Not ported: the checkpoint metrics, the journal events and the
``ckpt.write`` fault site (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import tempfile
import time
import zlib
from typing import Any, Dict, Optional, Tuple

from elasticdl_tpu_torch.checkpoint import _pickle

logger = logging.getLogger("elasticdl_tpu_torch.checkpoint.saver")

_STATE_FILE = "state.pkl"
_INTEGRITY_FILE = "integrity.json"
_QUARANTINE_SUFFIX = ".quarantined"

#: Tmp dirs untouched for this long are garbage from a crashed save.
#: Generous: the sweep runs at every saver construction, while a peer's
#: save may be in flight (writers refresh their tmp dir's mtime after
#: each large file), and a leaked tmp dir costs only disk.
STALE_TMP_GRACE_S = 3600.0


def file_crc32(path: str, chunk_bytes: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def write_integrity_manifest(step_dir: str, filenames) -> str:
    """Checksum ``filenames`` (relative to ``step_dir``) into
    integrity.json, before the commit rename publishes the directory."""
    manifest = {
        "files": {
            name: {
                "crc32": file_crc32(os.path.join(step_dir, name)),
                "size": os.path.getsize(os.path.join(step_dir, name)),
            }
            for name in filenames
        }
    }
    path = os.path.join(step_dir, _INTEGRITY_FILE)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


def verify_integrity(step_dir: str, check_crc: bool = True) -> Optional[str]:
    """None if ``step_dir`` passes its integrity manifest, else the reason
    -- returned ONLY for proven corruption (checksum or size mismatch,
    garbage manifest, an inventoried file missing).  Transient I/O errors
    raise ``OSError``.  A directory without a manifest passes vacuously.
    ``check_crc=False`` checks existence and size only (no data reads),
    what the non-zero ranks of a sharded restore do."""
    manifest_path = os.path.join(step_dir, _INTEGRITY_FILE)
    if not os.path.exists(manifest_path):
        return None
    with open(manifest_path) as f:
        try:
            inventory: Dict[str, dict] = json.load(f)["files"]
        except (ValueError, KeyError) as exc:
            return f"garbage integrity manifest (torn write?): {exc!r}"
    for name, meta in inventory.items():
        path = os.path.join(step_dir, name)
        try:
            size = os.path.getsize(path)
        except FileNotFoundError:
            return f"{name}: missing from committed checkpoint"
        if size != meta["size"]:
            return f"{name}: size {size} != manifest {meta['size']} (torn write)"
        if check_crc:
            crc = file_crc32(path)
            if crc != meta["crc32"]:
                return f"{name}: crc32 {crc:#010x} != manifest {meta['crc32']:#010x}"
    return None


def write_pickle(path: str, state: Any) -> None:
    """``state`` (numpy leaves) pickled under the JAX package's names."""
    with open(path, "wb") as f:
        _pickle.dump(state, f)


def read_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return _pickle.load(f, what=path)


class CheckpointSaver:
    def __init__(self, checkpoint_dir: str, keep_max: int = 3):
        self._dir = checkpoint_dir
        self._keep_max = keep_max
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.sweep_stale_tmp()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:012d}")

    def _is_committed(self, step_dir: str) -> bool:
        """A complete snapshot has a non-empty state file (the sharded
        saver asks for its manifest instead)."""
        try:
            return os.path.getsize(os.path.join(step_dir, _STATE_FILE)) > 0
        except (FileNotFoundError, NotADirectoryError):
            # Proven incomplete; any other OSError is transient and
            # propagates (a good checkpoint must not read as missing).
            return False

    def steps(self):
        # An unlistable directory raises: pretending it is empty would
        # turn one transient I/O error into a silent fresh start.
        steps = []
        for name in os.listdir(self._dir):
            if not name.startswith("step_") or ".tmp" in name or name.endswith(
                    _QUARANTINE_SUFFIX):
                continue
            try:
                step = int(name[len("step_"):])
            except ValueError:
                continue
            if not self._is_committed(os.path.join(self._dir, name)):
                logger.warning("Skipping incomplete/unreadable checkpoint %s",
                               os.path.join(self._dir, name))
                continue
            steps.append(step)
        return sorted(steps)

    def save(self, state: Any, step: int) -> str:
        """Snapshot a host state (numpy leaves, e.g. ``DataParallelTrainer.
        state_to_jax_host()``) at ``step``, atomically, with a CRC32
        manifest over the state file."""
        final_dir = self._step_dir(step)
        if os.path.exists(final_dir):
            return final_dir
        tmp_dir = tempfile.mkdtemp(prefix=f"step_{step:012d}.tmp", dir=self._dir)
        write_pickle(os.path.join(tmp_dir, _STATE_FILE), state)
        write_integrity_manifest(tmp_dir, [_STATE_FILE])
        os.rename(tmp_dir, final_dir)
        logger.info("Saved checkpoint at step %d -> %s", step, final_dir)
        self._garbage_collect()
        return final_dir

    def load_latest(self) -> Tuple[Optional[Any], int]:
        """(state, step); (None, 0) when no checkpoint loads.  A corrupt
        snapshot (checksum mismatch, unloadable pickle) is quarantined and
        the next-newest good one wins."""
        for step in reversed(self.steps()):
            step_dir = self._step_dir(step)
            try:
                reason = verify_integrity(step_dir)
            except OSError:
                logger.exception("Could not verify checkpoint %s (transient I/O error?); "
                                 "skipping it this restore", step_dir)
                continue
            if reason is not None:
                self._quarantine(step_dir, reason)
                continue
            try:
                state = read_pickle(os.path.join(step_dir, _STATE_FILE))
            except OSError:
                logger.exception("Could not read checkpoint %s (transient I/O error?); "
                                 "skipping it this restore", step_dir)
                continue
            except _pickle.RefusedGlobal:
                logger.exception("Checkpoint %s names a class this package does not read; "
                                 "skipping it this restore", step_dir)
                continue
            except (pickle.UnpicklingError, EOFError, ValueError) as exc:
                # Read fine but not a valid pickle stream: corruption a
                # (vacuously passing) manifest could not catch.
                self._quarantine(step_dir, f"unloadable state: {exc!r}")
                continue
            except Exception:
                # Environment errors (MemoryError, an ImportError after a
                # bad deploy) are not corruption: quarantining would eat
                # every snapshot, newest first.
                logger.exception("Could not load checkpoint %s (environment error, not "
                                 "corruption); skipping it this restore", step_dir)
                continue
            logger.info("Restored checkpoint from step %d", step)
            return state, step
        return None, 0

    def _quarantine(self, step_dir: str, reason: str) -> None:
        """Move a corrupt snapshot aside (never deleted: it is the
        evidence) so no later restore can pick it again."""
        target = step_dir + _QUARANTINE_SUFFIX
        n = 2
        while os.path.exists(target):  # an earlier incident keeps its evidence
            target = f"{step_dir}{_QUARANTINE_SUFFIX}.{n}"
            n += 1
        logger.error("Quarantining corrupt checkpoint %s -> %s (%s); falling back to the "
                     "previous step", step_dir, target, reason)
        try:
            os.rename(step_dir, target)
        except OSError:
            logger.exception("Quarantine rename failed for %s", step_dir)

    def sweep_stale_tmp(self, grace_s: float = STALE_TMP_GRACE_S) -> None:
        """Delete tmp dirs of crashed saves older than ``grace_s`` (a
        younger one may be a peer's save in flight)."""
        try:
            names = os.listdir(self._dir)
        except OSError:
            return
        for name in names:
            if not (name.startswith("step_") and ".tmp" in name):
                continue
            path = os.path.join(self._dir, name)
            try:
                stale = time.time() - os.path.getmtime(path) > grace_s
            except OSError:
                continue  # a peer committed (renamed) it mid-sweep
            if stale:
                logger.warning("Sweeping stale checkpoint tmp dir %s (crashed save)", path)
                shutil.rmtree(path, ignore_errors=True)

    def _garbage_collect(self) -> None:
        # Best effort: the new checkpoint is already durable, so a
        # transient error here must not fail the save.
        try:
            for step in self.steps()[: -self._keep_max]:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
        except OSError:
            logger.exception("Checkpoint GC failed (transient I/O error?); old snapshots "
                             "will be collected on a later save")
        self.sweep_stale_tmp()
