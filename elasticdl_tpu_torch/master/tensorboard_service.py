"""The master's TensorBoard scalar service: the port's copy of
``elasticdl_tpu/master/tensorboard_service.py``.

The master owns one event-file writer and streams the job's scalars:
each finalized evaluation round's metrics at the round's model version
(``EvaluationService`` pushes them through ``write_dict_to_summary``,
``eval/<name>``), and the training progress (``train/records_finished``,
``train/tasks_todo``, ``train/epoch``, ``train/oov_lookup_count``,
``train/model_version``, ``train/worker_restarts``) sampled on a
background thread every ``sample_interval_s`` and once more at
``close``, since the master is the one stable observer of an elastic
job.

The writer is this module's own (``EventFileWriter``), stdlib only: the
JAX package writes through ``torch.utils.tensorboard``, which needs the
``tensorboard`` package, and the card's machine has none.  An event file
is TensorBoard's: TFRecord framing (little-endian u64 length, masked
CRC-32C of the length, the payload, masked CRC-32C of the payload) around
``Event`` protocol buffers encoded by hand (``wall_time`` = 1 double,
``step`` = 2 varint, ``file_version`` = 3 string, ``summary`` = 5 with
``value`` = 1 holding ``tag`` = 1 and ``simple_value`` = 2 float).  The
file is named as ``SummaryWriter`` names it,
``events.out.tfevents.<secs>.<host>.<pid>.<n>``, and starts with the
``brain.Event:2`` version record.  ``read_events`` reads a file back and
checks every record's CRCs.  A writer that cannot open its file degrades
to a warning: observability never takes training down.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("master.tensorboard")

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli) and the TFRecord framing
# ---------------------------------------------------------------------------


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` (``crc32c(b"123456789") == 0xE3069283``)."""
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


# ---------------------------------------------------------------------------
# Event protocol buffers, by hand
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # int64 two's complement, as protobuf writes it
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(number: int, wire_type: int) -> bytes:
    return _varint((number << 3) | wire_type)


def _length_delimited(number: int, payload: bytes) -> bytes:
    return _field(number, 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, file_version: str = "",
                 scalars: Optional[Dict[str, float]] = None) -> bytes:
    """One serialized ``Event``: a version record or a scalar summary."""
    out = _field(1, 1) + struct.pack("<d", float(wall_time))
    if step:
        out += _field(2, 0) + _varint(int(step))
    if file_version:
        out += _length_delimited(3, file_version.encode("utf-8"))
    if scalars:
        summary = b"".join(
            _length_delimited(1, _length_delimited(1, tag.encode("utf-8"))
                              + _field(2, 5) + struct.pack("<f", float(value)))
            for tag, value in scalars.items())
        out += _length_delimited(5, summary)
    return out


def _read_varint(buf: bytes, pos: int):
    shift = value = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(number, wire type, value) of each field of a message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, pos = _read_varint(buf, pos)
        elif wire_type == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire_type == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire_type == 2:
            length, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield number, wire_type, value


def decode_event(payload: bytes) -> dict:
    """``{"wall_time", "step", "file_version"?, "scalars": {tag: value}}``."""
    event = {"wall_time": 0.0, "step": 0, "scalars": {}}
    for number, _wire, value in _fields(payload):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            event["step"] = value - (1 << 64) if value >= 1 << 63 else value
        elif number == 3:
            event["file_version"] = value.decode("utf-8")
        elif number == 5:
            for vnum, _w, summary_value in _fields(value):
                if vnum != 1:
                    continue
                tag, simple = None, None
                for snum, _sw, sval in _fields(summary_value):
                    if snum == 1:
                        tag = sval.decode("utf-8")
                    elif snum == 2:
                        simple = struct.unpack("<f", sval)[0]
                if tag is not None and simple is not None:
                    event["scalars"][tag] = simple
    return event


def read_events(path: str) -> List[dict]:
    """Every event of an event file, each record's CRCs checked (a
    mismatch raises ``ValueError``)."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        if len(header) < 8:
            raise ValueError(f"{path}: torn record header at byte {pos}")
        (length,) = struct.unpack("<Q", header)
        (header_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if header_crc != masked_crc32c(header):
            raise ValueError(f"{path}: length CRC mismatch at byte {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (payload_crc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if len(payload) != length or payload_crc != masked_crc32c(payload):
            raise ValueError(f"{path}: payload CRC mismatch at byte {pos}")
        events.append(decode_event(payload))
        pos += 16 + length
    return events


_FILE_SEQ = itertools.count()


class EventFileWriter:
    """Appends scalar events to one new event file in ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}."
                f"{os.getpid()}.{next(_FILE_SEQ)}")
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _write(self, payload: bytes) -> None:
        self._file.write(frame_record(payload))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), step=int(step), scalars={tag: float(value)}))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()


class TensorBoardService:
    def __init__(
        self,
        log_dir: str,
        task_manager=None,
        model_version_fn: Optional[Callable[[], int]] = None,
        restarts_fn: Optional[Callable[[], int]] = None,
        sample_interval_s: float = 10.0,
    ):
        self._log_dir = log_dir
        self._task_manager = task_manager
        self._model_version_fn = model_version_fn
        self._restarts_fn = restarts_fn
        self._sample_interval_s = sample_interval_s
        # Guards the writer: scalars arrive from servicer threads, the
        # sampler thread and close().
        self._lock = make_lock("TensorBoardService._lock")
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._writer: Optional[EventFileWriter] = None
        try:
            self._writer = EventFileWriter(log_dir)
            logger.info("TensorBoard events -> %s", self._writer.path)
        except Exception:
            logger.exception("TensorBoard writer unavailable; scalars will be dropped")

    @property
    def event_file(self) -> str:
        return self._writer.path if self._writer is not None else ""

    # -- write paths ----------------------------------------------------

    def write_dict_to_summary(self, metrics: Dict[str, float], version: int,
                              prefix: str = "eval"):
        """``EvaluationService`` pushes each finalized round's metrics here."""
        if self._writer is None:
            return
        with self._lock:
            for name, value in metrics.items():
                try:
                    self._writer.add_scalar(f"{prefix}/{name}", float(value), int(version))
                except Exception:
                    logger.exception("Dropping scalar %s", name)
            self._writer.flush()

    def write_scalar(self, tag: str, value: float, step: int):
        if self._writer is None:
            return
        with self._lock:
            try:
                self._writer.add_scalar(tag, float(value), int(step))
            except Exception:
                logger.exception("Dropping scalar %s", tag)

    def bind(self, model_version_fn: Optional[Callable[[], int]] = None,
             restarts_fn: Optional[Callable[[], int]] = None):
        """Late-bind progress sources built after this service (the
        servicer's model version, the pod manager's restart count)."""
        if model_version_fn is not None:
            self._model_version_fn = model_version_fn
        if restarts_fn is not None:
            self._restarts_fn = restarts_fn

    # -- progress sampling ----------------------------------------------

    def start(self) -> "TensorBoardService":
        if self._writer is not None:
            self._thread = threading.Thread(target=self._sample_loop,
                                            name="tensorboard-sampler", daemon=True)
            self._thread.start()
        return self

    def _sample_progress(self):
        version = int(self._model_version_fn()) if self._model_version_fn else 0
        if self._task_manager is not None:
            counts = self._task_manager.counts()
            self.write_scalar("train/records_finished",
                              self._task_manager.finished_record_count, version)
            self.write_scalar("train/tasks_todo", counts["todo"], version)
            self.write_scalar("train/epoch", counts["epoch"], version)
            from elasticdl_tpu_torch.common.constants import TaskExecCounterKey

            counters_fn = getattr(self._task_manager, "exec_counters", None)
            if counters_fn is not None:
                self.write_scalar("train/oov_lookup_count",
                                  counters_fn().get(TaskExecCounterKey.OOV_LOOKUP_COUNT, 0),
                                  version)
        if self._model_version_fn is not None:
            self.write_scalar("train/model_version", version, version)
        if self._restarts_fn is not None:
            self.write_scalar("train/worker_restarts", self._restarts_fn(), version)
        if self._writer is not None:
            with self._lock:
                self._writer.flush()

    def _sample_loop(self):
        while not self._stop_event.wait(self._sample_interval_s):
            try:
                self._sample_progress()
            except Exception:
                logger.exception("TensorBoard progress sample failed")

    def close(self):
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._writer is not None:
            try:
                self._sample_progress()  # a final point at the job's end
                with self._lock:
                    self._writer.close()
            except Exception:
                pass
