"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled at first use for ``sm_90a``, one ``nvcc -c``
per source, all started together, then linked by one more ``nvcc`` call
into one shared library with a plain C interface, which is loaded with
``ctypes``.  Keeping PyTorch's headers out of the sources keeps the
build to seconds (a source that includes them takes minutes), and ninja
is not needed.

The library lands in ``ops/_build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the sources, the flags, the nvcc version and the
torch version, so an edited source or another toolkit rebuilds, and an
unchanged one loads the file already there.  A file lock serialises
concurrent first use across processes.  A failed build raises: nothing
falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

#: ``--split-compile=4``: each source's kernels are optimised on 4
#: threads.  The attention sources compile side by side and hold ~20
#: kernels each, so one thread a source left them the build's critical
#: path (ring_attention.cu 28.9 s alone, 16.0 s split, with the same
#: registers and spills on an H100 machine's nvcc 12.9).  K4-K6's f16
#: builds are a unit of their own (``flash_attention_f16.cu``, the
#: templates of ``flash_mma.cuh``) for the same reason: they compile
#: beside the bf16 and f32 builds instead of after them.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "--split-compile=4",
    "-Xptxas=-v",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

_FLASH_TAIL = (_I, _I, _I, _I, _LL, _LL, _LL, _F, _I, _I, _P)
# (batch, heads, tq, tk, d), q strides, k/v strides, scale, causal, dtype,
# stream.
_RING_TAIL = (_I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _I, _P)

#: argtypes of every C entry point (pointers and the stream as c_void_p,
#: so ctypes never cuts a 64-bit address to a 32-bit int; hyperparameters
#: as c_float, already rounded to f32 by the caller).
SIGNATURES = {
    # table, ids, out, n, start (-1: one card), rows_per_block, num_blocks,
    # dim_padded, dim, stream
    "edl_fused_lookup": (_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P),
    "edl_fused_lookup_fm": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    "edl_fused_dedup_apply": (
        _P, _P, _P, _LL, _I, _I, _I, _I,   # sorted ids, perm, grads, n, shape, kind
        _P, _P, _P, _P, _P,                # table, 3 slots, t_global
        _F, _F, _I, _F, _F, _F, _F, _F,    # lr_neg, mu, nesterov, eps, b1, b2, omb1, omb2
        _P,                                # stream
    ),
    "edl_block_gather": (_P, _P, _P, _LL, _I, _P),  # table, idx, out, n, num_blocks8, stream
    # flash attention: tensors, then (batch, heads, t, d), q/k/v strides
    # (batch, time, head), scale, causal, dtype code, stream.
    "edl_flash_fwd": (_P, _P, _P, _P, _P) + _FLASH_TAIL,        # q k v out lse
    "edl_flash_dq": (_P, _P, _P, _P, _P, _P, _P) + _FLASH_TAIL,  # q k v do lse delta dq
    "edl_flash_dkv": (_P,) * 8 + _FLASH_TAIL,                   # ... dk dv
    # the ring steps: tensors, positions (q_pos, k_pos), then _RING_TAIL.
    "edl_ring_fwd": (_P,) * 7 + _RING_TAIL,   # q k v acc lse q_pos k_pos
    # the backward steps: dO's dtype code after dO.
    "edl_ring_dq": (_P,) * 4 + (_I,) + (_P,) * 5 + _RING_TAIL,  # ... lse delta dq q_pos k_pos
    "edl_ring_dkv": (_P,) * 4 + (_I,) + (_P,) * 6 + _RING_TAIL,  # ... lse delta dk dv q_pos k_pos
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under CUDA_HOME nor on PATH): the "
            "port's CUDA kernels are built from ops/csrc/ at first use"
        )
    return found


def build_key(nvcc: str) -> str:
    import torch

    version = subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, text=True,
        timeout=60,
    ).stdout
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(version.encode())
    digest.update(torch.__version__.encode())
    return digest.hexdigest()[:16]


def _run_all(commands):
    """Run the commands at once; [(stdout, stderr, exit code)] in order.
    A command still running after 900 s is killed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in commands
    ]
    results = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        results.append((out, err, proc.returncode))
    return results


def build() -> Path:
    """Compile the sources if no library for their key exists yet;
    returns the library's path.  The compiler's output (``-Xptxas=-v``:
    registers, shared memory and spills per kernel) is kept beside it as
    ``<name>.log``."""
    nvcc = nvcc_path()
    lib = BUILD_DIR / f"libedl_kernels_{build_key(nvcc)}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return lib
            tmp = lib.with_suffix(f".tmp{os.getpid()}")
            cu_sources = [src for src in _sources() if src.suffix == ".cu"]
            # Each object under its source's own name, in a directory of
            # this build: the link names its device image after all the
            # objects joined, and with the build key in each name that
            # passed the 255 bytes a file name may take (cuobjdump then
            # could not extract it).
            obj_dir = lib.with_suffix(f".obj{os.getpid()}")
            obj_dir.mkdir(exist_ok=True)
            objects = [obj_dir / f"{src.stem}.o" for src in cu_sources]
            compiles = [
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for obj, src in zip(objects, cu_sources)
            ]
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
            t0 = time.monotonic()
            log = ""
            failed = False
            for cmd, (out, err, code) in zip(compiles, _run_all(compiles)):
                log += f"$ {' '.join(cmd)}\n{out}{err}[exit {code}]\n"
                failed = failed or code != 0
            if not failed:
                proc = subprocess.run(link, capture_output=True, text=True, timeout=900)
                log += f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}[exit {proc.returncode}]\n"
                failed = proc.returncode != 0
            log += f"[{time.monotonic() - t0:.1f} s]\n"
            lib.with_suffix(".log").write_text(log)
            shutil.rmtree(obj_dir, ignore_errors=True)
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed to build the kernels:\n{log}")
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


#: Times this process built or loaded the library (``library`` runs once).
_LOADS = 0


def build_counts() -> dict:
    """``{"kernel_library": n}``: the count the trainers expose as
    ``kernel_builds``, which the step anatomy watches (a dispatch during
    which it rose books ``compile``, ``obs/stepstats.BuildWatcher``)."""
    return {"kernel_library": _LOADS}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    global _LOADS
    _LOADS += 1
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.edl_error_string.argtypes = [ctypes.c_int]
    lib.edl_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        message = library().edl_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({message})")
