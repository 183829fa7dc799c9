"""Event journal: a timestamped, greppable JSONL timeline, the port's
copy of ``elasticdl_tpu/obs/journal.py``.

Every serving event (a model swap, a shed request, a quality-gate
verdict, a replica's telemetry) gets one JSON record, so an operator or a
test can rebuild a replica's life after the fact.  Replicas of one fleet
append to the shared serve dir's ``events.jsonl``; it is size-capped with
a single rotation (``events.jsonl`` -> ``events.jsonl.1``).

Record shape (one per line):

    {"ts": <unix seconds>, "event": "<type>", ...free-form fields}

The journal also keeps an in-memory ring of recent records whatever the
file configuration, so an unconfigured process (a test) still has an
inspectable timeline.  Writes are best-effort: an unwritable directory
degrades to the memory ring with one warning.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.journal")

DEFAULT_FILENAME = "events.jsonl"
DEFAULT_MAX_BYTES = 8 << 20
ROTATED_SUFFIX = ".1"


class EventJournal:
    def __init__(
        self,
        path: Optional[str] = None,
        max_bytes: int = DEFAULT_MAX_BYTES,
        tail_events: int = 256,
    ):
        self._lock = threading.Lock()
        self._path: Optional[str] = None  # guarded-by: _lock
        self._file = None  # guarded-by: _lock
        self._size = 0  # guarded-by: _lock
        self._max_bytes = max_bytes  # guarded-by: _lock
        self._tail: deque = deque(maxlen=tail_events)  # guarded-by: _lock
        self._write_errors = 0  # guarded-by: _lock
        if path:
            self.configure(path, max_bytes)

    def configure(
        self, path: Optional[str], max_bytes: Optional[int] = None
    ) -> Optional[str]:
        """(Re)point the journal at `path` (append mode: a relaunched
        replica continues the fleet's timeline).  `None` closes the file
        and reverts to memory-only."""
        with self._lock:
            self._close_locked()
            self._path = path
            if max_bytes is not None:
                self._max_bytes = max_bytes
            if path is None:
                return None
            try:
                self._file = open(path, "a", encoding="utf-8")
                self._size = os.path.getsize(path)
            except OSError:
                logger.exception(
                    "Event journal %s unwritable; events stay memory-only",
                    path,
                )
                self._file = None
            return path

    def _close_locked(self):
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        self._size = 0

    def record(self, event: str, **fields) -> dict:
        """Append one journal record; returns it (tests assert on the
        return value without re-reading the file)."""
        rec = {"ts": round(time.time(), 6), "event": event}
        rec.update(fields)
        with self._lock:
            self._tail.append(rec)
            if self._file is None:
                # Memory-only (unconfigured processes and tests):
                # skip serialization entirely — the tail stores the dict.
                return rec
            try:
                line = (
                    json.dumps(rec, default=str, separators=(",", ":"))
                    + "\n"
                )
                # Byte accounting, not characters: _size seeds from
                # getsize() (bytes) and the cap guards disk, so
                # multi-byte text must count at its encoded width.
                nbytes = len(line.encode("utf-8"))
                if self._size + nbytes > self._max_bytes:
                    self._rotate_locked()
                self._file.write(line)
                self._file.flush()
                self._size += nbytes
            except OSError:
                self._write_errors += 1
                if self._write_errors == 1:
                    logger.exception(
                        "Event journal write to %s failed; further events "
                        "stay memory-only until reconfigured", self._path,
                    )
                self._close_locked()
        return rec

    def _rotate_locked(self):
        """Size cap reached: the current file becomes `.1` (replacing any
        previous rotation) and a fresh file opens — at most 2x max_bytes
        on disk, and the newest events are always in the primary file."""
        self._file.close()
        self._file = None
        os.replace(self._path, self._path + ROTATED_SUFFIX)
        self._file = open(self._path, "a", encoding="utf-8")
        self._size = 0

    def tail(self, n: int = 50) -> List[dict]:
        """Last `n` events.  Served from the in-memory ring when it can
        cover the request; a larger `n` against a configured journal
        reads the files instead — including the rotated file when the
        active one holds fewer than `n` lines, so a request racing
        rotation never loses the pre-rotation events.  The read happens
        under the journal lock, which also serializes `_rotate_locked`'s
        os.replace: a tail can never observe the half-swapped state."""
        with self._lock:
            if self._file is None or len(self._tail) >= n:
                return list(self._tail)[-n:]
            return self._tail_from_disk_locked(n)

    def _tail_from_disk_locked(self, n: int) -> List[dict]:
        self._file.flush()
        lines = self._read_tail_lines(self._path, n)
        if len(lines) < n:
            rotated = self._read_tail_lines(
                self._path + ROTATED_SUFFIX, n - len(lines)
            )
            lines = rotated + lines
        events = []
        for line in lines[-n:]:
            try:
                record = json.loads(line)
            except ValueError:
                continue  # torn final line mid-write elsewhere
            if isinstance(record, dict):
                events.append(record)
        return events

    @staticmethod
    def _read_tail_lines(path: str, n: int) -> List[str]:
        """Last `n` non-empty lines, read in bounded blocks from EOF —
        this runs under the journal lock, so it must cost O(tail), not
        O(file): a /journal scrape must never stall every record()
        caller behind a multi-MB sequential read."""
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                remaining = f.tell()
                block = 1 << 16
                data = b""
                while remaining > 0 and data.count(b"\n") <= n:
                    read = min(block, remaining)
                    remaining -= read
                    f.seek(remaining)
                    data = f.read(read) + data
                    block *= 2
        except OSError:
            return []
        lines = [
            stripped
            for stripped in (
                line.strip()
                for line in data.decode(
                    "utf-8", errors="replace"
                ).splitlines()
            )
            if stripped
        ]
        if remaining > 0 and lines:
            # Didn't reach the file head: the first line is (possibly) a
            # fragment of a record; > n newlines were read, so >= n
            # complete lines remain after dropping it.
            lines = lines[1:]
        return lines[-n:]
