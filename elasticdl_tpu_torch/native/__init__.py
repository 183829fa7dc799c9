"""The native host codec of ETRF record files: the port's copy of the
record-file half of ``elasticdl_tpu/native/__init__.py`` (build, ABI
gate, ctypes bindings, ``NativeRecordFile``, ``record_file``).

``recordfile.cc`` is compiled at first use with the host C++ compiler,
``g++ -O3 -shared -fPIC`` (then ``c++``, ``clang++``), first with zlib's
CRC-32 (``-DEDL_USE_ZLIB -lz``), then self-contained, into
``_build/libedl_recordfile.so`` beside this file; a build that is newer
than the source is reused.  The library is written under a temporary
name and renamed into place, so processes that build at once never load
a half-written file.  ``record_file()`` returns the bound codec, or None
when no compiler or no usable library is there, and then
``data/recordfile.py`` reads with its Python codec.

The host optimizer kernels of the JAX package's library
(``kernel_api.cc``) are not part of the port.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.recordfile import CHUNK_BYTES, CHUNK_RECORDS

logger = get_logger("native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "recordfile.cc")
BUILD_DIR = os.path.join(_DIR, "_build")
SO_PATH = os.path.join(BUILD_DIR, "libedl_recordfile.so")

#: Must match ``edl_abi_version()`` in recordfile.cc; bump both on any
#: C-ABI change, so a stale library is rebuilt instead of called with
#: shifted arguments.
_ABI_VERSION = 2

_lib = None
_load_failed = False


def build_native(force: bool = False) -> Optional[str]:
    """Compile ``recordfile.cc`` -> ``SO_PATH``; the path, or None when
    there is no compiler or the source does not compile."""
    if (not force and os.path.exists(SO_PATH)
            and os.path.getmtime(SO_PATH) >= os.path.getmtime(_SOURCE)):
        return SO_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libedl_recordfile.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for compiler in ("g++", "c++", "clang++"):
            zlib_failed = False
            for extra in (["-DEDL_USE_ZLIB"], []):
                try:
                    subprocess.run(
                        [compiler, "-O3", "-shared", "-fPIC", "-std=c++17", *extra, _SOURCE,
                         "-o", tmp, *(["-lz"] if extra else [])],
                        check=True, capture_output=True, timeout=120,
                    )
                except FileNotFoundError:
                    break  # no such compiler: the next one
                except subprocess.CalledProcessError as exc:
                    if extra:
                        zlib_failed = True
                        continue  # no zlib headers: the self-contained build
                    logger.error("Native codec build failed (%s): %s", compiler,
                                 exc.stderr.decode()[:2000])
                    return None
                if zlib_failed:
                    logger.warning("zlib-CRC native build failed (no zlib dev headers?); "
                                   "built the self-contained CRC variant")
                # A fresh inode: a process that has the old library
                # mapped keeps it, a new CDLL sees this one.
                os.replace(tmp, SO_PATH)
                logger.info("Built the native record codec with %s%s -> %s", compiler,
                            " (+zlib crc)" if extra else "", SO_PATH)
                return SO_PATH
        logger.warning("No C++ compiler found; the native record codec is unavailable")
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    # The ABI gate first: a library without the symbol raises
    # AttributeError, an outdated one returns another number; both
    # lead to the rebuild in load().
    lib.edl_abi_version.argtypes = []
    lib.edl_abi_version.restype = ctypes.c_longlong
    found = int(lib.edl_abi_version())
    if found != _ABI_VERSION:
        raise AttributeError(f"native ABI {found} != expected {_ABI_VERSION} (stale library)")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    ll = ctypes.c_longlong
    voidp = ctypes.c_void_p
    lib.edl_rf_last_error.argtypes = []
    lib.edl_rf_last_error.restype = ctypes.c_char_p
    lib.edl_rf_open.argtypes = [ctypes.c_char_p]
    lib.edl_rf_open.restype = voidp
    lib.edl_rf_count.argtypes = [voidp]
    lib.edl_rf_count.restype = ll
    lib.edl_rf_range_size.argtypes = [voidp, ll, ll]
    lib.edl_rf_range_size.restype = ll
    lib.edl_rf_read_range.argtypes = [voidp, ll, ll, u8p, ll, u32p]
    lib.edl_rf_read_range.restype = ll
    lib.edl_rf_close.argtypes = [voidp]
    lib.edl_rf_close.restype = None
    lib.edl_rf_writer_open.argtypes = [ctypes.c_char_p]
    lib.edl_rf_writer_open.restype = voidp
    lib.edl_rf_writer_write.argtypes = [voidp, u8p, ctypes.c_uint32]
    lib.edl_rf_writer_write.restype = ctypes.c_int
    lib.edl_rf_writer_close.argtypes = [voidp]
    lib.edl_rf_writer_close.restype = ctypes.c_int
    return lib


def load():
    """The bound library (built if needed), or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = build_native()
    if path is None:
        _load_failed = True
        return None
    try:
        _lib = _bind(ctypes.CDLL(path))
    except (OSError, AttributeError):
        # A corrupt or foreign library, or a stale one with a newer
        # mtime (copies keep timestamps): rebuild once.
        logger.warning("Native library at %s unusable; rebuilding", path)
        path = build_native(force=True)
        if path is None:
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except Exception:
            logger.exception("Rebuilt native library still unusable")
            _load_failed = True
            return None
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeRecordFile:
    """ctypes bindings of the ETRF codec: one C call per chunk of a
    ``[start, end)`` range returns its payloads and lengths."""

    CHUNK_RECORDS = CHUNK_RECORDS
    CHUNK_BYTES = CHUNK_BYTES

    def __init__(self):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native record file unavailable (no C++ toolchain)")

    def _error(self) -> str:
        return self._lib.edl_rf_last_error().decode(errors="replace")

    def count_records(self, path: str) -> int:
        handle = self._lib.edl_rf_open(path.encode())
        if not handle:
            raise IOError(self._error())
        try:
            return int(self._lib.edl_rf_count(handle))
        finally:
            self._lib.edl_rf_close(handle)

    def read_range(self, path: str, start: int, end: int):
        """Payload bytes of records ``[start, end)`` (CRC-checked), split
        from ``read_range_buffers``'s chunks."""
        for buf, lengths in self.read_range_buffers(path, start, end):
            view = memoryview(buf)
            offset = 0
            for length in lengths:
                yield bytes(view[offset:offset + int(length)])
                offset += int(length)

    def read_range_buffers(self, path: str, start: int, end: int, max_bytes: int = 0):
        """``(payloads np.uint8, lengths np.uint32)`` chunks of records
        ``[start, end)``: at most CHUNK_RECORDS records and CHUNK_BYTES
        bytes, or, given ``max_bytes``, as many records as fit in it."""
        bytes_cap = max_bytes or self.CHUNK_BYTES
        handle = self._lib.edl_rf_open(path.encode())
        if not handle:
            raise IOError(self._error())
        try:
            count = int(self._lib.edl_rf_count(handle))
            start = max(0, start)
            end = min(end, count)
            pos = start
            while pos < end:
                n = end - pos if max_bytes else min(self.CHUNK_RECORDS, end - pos)
                total = int(self._lib.edl_rf_range_size(handle, pos, pos + n))
                if total < 0:
                    raise IOError(self._error())
                while n > 1 and total > bytes_cap:
                    n //= 2  # range_size is O(1) over the index
                    total = int(self._lib.edl_rf_range_size(handle, pos, pos + n))
                    if total < 0:
                        raise IOError(self._error())
                buf = np.empty(total, np.uint8)
                lengths = np.empty(n, np.uint32)
                read = self._lib.edl_rf_read_range(
                    handle, pos, pos + n, _u8(buf), total,
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
                if read < 0:
                    raise IOError(self._error())
                used = int(lengths[:read].sum())
                yield buf[:used], lengths[:read]
                pos += read
        finally:
            self._lib.edl_rf_close(handle)

    def write_records(self, path: str, records) -> int:
        handle = self._lib.edl_rf_writer_open(path.encode())
        if not handle:
            raise IOError(self._error())
        count = 0
        try:
            for payload in records:
                arr = np.frombuffer(bytes(payload), np.uint8)
                if self._lib.edl_rf_writer_write(handle, _u8(arr), len(arr)) != 0:
                    raise IOError(self._error())
                count += 1
        finally:
            if self._lib.edl_rf_writer_close(handle) != 0:
                raise IOError(self._error())
        return count


_record_file: Optional[NativeRecordFile] = None
_record_file_failed = False


def record_file() -> Optional[NativeRecordFile]:
    """The process's ``NativeRecordFile``, or None when the native codec
    is unavailable: whatever its construction raises (no compiler, a
    library that will not load or bind) leaves the Python codec serving."""
    global _record_file, _record_file_failed
    if _record_file is None and not _record_file_failed:
        try:
            _record_file = NativeRecordFile()
        except Exception:
            logger.exception("Native record file unavailable; using the Python codec")
            _record_file_failed = True
    return _record_file
