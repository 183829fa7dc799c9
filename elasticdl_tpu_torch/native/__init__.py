"""The native host libraries: the port's copy of
``elasticdl_tpu/native/__init__.py`` (build, ABI gate, ctypes bindings,
``NativeKernels``, ``NativeRecordFile``, ``record_file``).

Two C++ sources, each compiled at first use with the host C++ compiler,
``g++ -O3 -shared -fPIC -std=c++17`` (then ``c++``, ``clang++``), into
``_build/`` beside this file; a build that is newer than its source is
reused.  A library is written under a temporary name and renamed into
place, so processes that build at once never load a half-written file.

- ``recordfile.cc``, the ETRF codec, first with zlib's CRC-32
  (``-DEDL_USE_ZLIB -lz``), then self-contained, into
  ``libedl_recordfile.so``.  ``record_file()`` returns the bound codec,
  or None when no compiler or no usable library is there, and then
  ``data/recordfile.py`` reads with its Python codec.
- ``kernel_api.cc``, the host optimizer kernels (JAX ``:197-260``):
  dense and sparse sgd, momentum, adagrad and adam on numpy arrays, in
  place, into ``libedl_kernels.so`` (``NativeKernels``).  They are host
  code, and no main path calls them, as in JAX.
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
_KERNELS_SOURCE = os.path.join(_DIR, "kernel_api.cc")
KERNELS_SO_PATH = os.path.join(BUILD_DIR, "libedl_kernels.so")

#: Must match ``edl_abi_version()`` in recordfile.cc; bump both on any
#: C-ABI change, so a stale library is rebuilt instead of called with
#: shifted arguments.
_ABI_VERSION = 2

_lib = None
_load_failed = False


def _compile(source: str, so_path: str, variants, what: str, force: bool) -> Optional[str]:
    """Compile ``source`` -> ``so_path`` with the first compiler that
    exists, trying each of ``variants`` (``(flags, libs)``) in turn; the
    path, or None when there is no compiler or the source does not
    compile."""
    if (not force and os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(source)):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    name = os.path.basename(so_path)
    fd, tmp = tempfile.mkstemp(prefix=f".{name[:-3]}.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for compiler in ("g++", "c++", "clang++"):
            for i, (flags, libs) in enumerate(variants):
                try:
                    subprocess.run(
                        [compiler, "-O3", "-shared", "-fPIC", "-std=c++17", *flags, source,
                         "-o", tmp, *libs],
                        check=True, capture_output=True, timeout=120,
                    )
                except FileNotFoundError:
                    break  # no such compiler: the next one
                except subprocess.CalledProcessError as exc:
                    if i + 1 < len(variants):
                        continue  # e.g. no zlib headers: the next variant
                    logger.error("Native %s build failed (%s): %s", what, compiler,
                                 exc.stderr.decode()[:2000])
                    return None
                if i:
                    logger.warning("The first native %s build failed (no zlib dev headers?); "
                                   "built variant %s", what, flags or "self-contained")
                # A fresh inode: a process that has the old library
                # mapped keeps it, a new CDLL sees this one.
                os.replace(tmp, so_path)
                logger.info("Built the native %s with %s %s -> %s", what, compiler,
                            " ".join(flags), so_path)
                return so_path
        logger.warning("No C++ compiler found; the native %s is unavailable", what)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_native(force: bool = False) -> Optional[str]:
    """Compile ``recordfile.cc`` -> ``SO_PATH`` (zlib's CRC-32 first)."""
    return _compile(_SOURCE, SO_PATH, ((["-DEDL_USE_ZLIB"], ["-lz"]), ([], [])),
                    "record codec", force)


def build_kernels(force: bool = False) -> Optional[str]:
    """Compile ``kernel_api.cc`` -> ``KERNELS_SO_PATH``."""
    return _compile(_KERNELS_SOURCE, KERNELS_SO_PATH, (([], []),), "optimizer kernels", force)


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


_kernels = None
_kernels_failed = False


def _bind_kernels(lib):
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64, f32, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_int
    signatures = {
        "edl_sgd_dense": [f32p, f32p, f32, i64],
        "edl_momentum_dense": [f32p, f32p, f32p, f32, f32, i32, i64],
        "edl_adagrad_dense": [f32p, f32p, f32p, f32, f32, i64],
        "edl_adam_dense": [f32p, f32p, f32p, f32p, f32, f32, f32, f32, i64, i64],
        "edl_sgd_sparse": [f32p, i64, i64p, f32p, i64, f32],
        "edl_momentum_sparse": [f32p, f32p, i64, i64p, f32p, i64, f32, f32, i32],
        "edl_adagrad_sparse": [f32p, f32p, i64, i64p, f32p, i64, f32, f32],
        "edl_adam_sparse": [f32p, f32p, f32p, i64p, i64, i64p, f32p, i64, f32, f32, f32, f32],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)  # a library without the symbol: AttributeError
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def load_kernels():
    """The bound optimizer-kernel library (built if needed), or None."""
    global _kernels, _kernels_failed
    if _kernels is not None or _kernels_failed:
        return _kernels
    for force in (False, True):  # a stale or foreign library: rebuild once
        path = build_kernels(force=force)
        if path is None:
            break
        try:
            _kernels = _bind_kernels(ctypes.CDLL(path))
            return _kernels
        except (OSError, AttributeError):
            logger.warning("Native kernel library at %s unusable%s", path,
                           "" if force else "; rebuilding")
    _kernels_failed = True
    return None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeKernels:
    """Numpy-facing host optimizer kernels (JAX's ``NativeKernels``):
    each call updates its float32 C-contiguous arrays in place.  Sparse
    semantics are the sparse optimizers': duplicate ids sum first, each
    distinct row updates once, zero-gradient rows are skipped."""

    def __init__(self):
        self._lib = load_kernels()
        if self._lib is None:
            raise RuntimeError("native kernels unavailable (no C++ toolchain)")

    # Dense -------------------------------------------------------------

    def sgd(self, param, grad, lr):
        self._lib.edl_sgd_dense(_fp(param), _fp(grad), lr, param.size)

    def momentum(self, param, velocity, grad, lr, mu, nesterov=False):
        self._lib.edl_momentum_dense(_fp(param), _fp(velocity), _fp(grad), lr, mu,
                                     int(nesterov), param.size)

    def adagrad(self, param, accum, grad, lr, eps=1e-7):
        self._lib.edl_adagrad_dense(_fp(param), _fp(accum), _fp(grad), lr, eps, param.size)

    def adam(self, param, m, v, grad, lr, beta1, beta2, eps, step):
        self._lib.edl_adam_dense(_fp(param), _fp(m), _fp(v), _fp(grad), lr, beta1, beta2,
                                 eps, step, param.size)

    # Sparse ------------------------------------------------------------

    def sgd_sparse(self, table, ids, grads, lr):
        ids = np.ascontiguousarray(ids, np.int64)
        self._lib.edl_sgd_sparse(_fp(table), table.shape[1], _ip(ids), _fp(grads), len(ids), lr)

    def momentum_sparse(self, table, velocity, ids, grads, lr, mu, nesterov=False):
        ids = np.ascontiguousarray(ids, np.int64)
        self._lib.edl_momentum_sparse(_fp(table), _fp(velocity), table.shape[1], _ip(ids),
                                      _fp(grads), len(ids), lr, mu, int(nesterov))

    def adagrad_sparse(self, table, accum, ids, grads, lr, eps=1e-7):
        ids = np.ascontiguousarray(ids, np.int64)
        self._lib.edl_adagrad_sparse(_fp(table), _fp(accum), table.shape[1], _ip(ids),
                                     _fp(grads), len(ids), lr, eps)

    def adam_sparse(self, table, m, v, t_rows, ids, grads, lr, beta1=0.9, beta2=0.999,
                    eps=1e-8):
        ids = np.ascontiguousarray(ids, np.int64)
        self._lib.edl_adam_sparse(_fp(table), _fp(m), _fp(v), _ip(t_rows), table.shape[1],
                                  _ip(ids), _fp(grads), len(ids), lr, beta1, beta2, eps)


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
