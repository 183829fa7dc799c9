"""Per-process sharded checkpoints: the port of
``elasticdl_tpu/checkpoint/sharded.py``, in its on-disk layout.

Every process writes only the rows it holds of the sharded arrays (the
PS trainer's tables and table-shaped slots); no host gathers a split
table.  One checkpoint is a directory per step, committed by a rank-0
rename after a barrier:

    step_000000000042/
      manifest.json        - step, process count, array shapes/dtypes and
                             the exact shard-file inventory (restores read
                             only inventoried files)
      dense.pkl            - replicated state (dense params, optimizer
                             state, step), pickled under the JAX package's
                             names (``checkpoint/_pickle.py``); rank 0 writes it
      shards_p0of2.npz     - process 0's rows: entries named
                             "<array>|<row_lo>|<row_hi>"
      shards_p1of2.npz     - process 1's rows
      integrity.json       - CRC32 over all of the above, manifest included

Rows are those of the stored arrays: a table's storage blocks (``dim0``
of ``PackedSpec.packed_shape``).  The shared tmp dir
(``step_%012d.shared.tmp``) has its mtime refreshed while the save is in
flight, so a peer's stale-tmp sweep leaves it alone; rank 0 sweeps
``shards_p*`` files of an earlier world from it before it commits.

Restore is world-size agnostic: a process reads the row intervals its
placement gives it (``load_rows``), reassembled from whichever
inventoried files cover them.  A stored (uncompressed) npz entry is
memory-mapped, so a read touches the file bytes of its rows only.  The
process count and rank are those of the initialised default process
group (the ranks of a ``parallel/mesh.py`` process mesh), one process
otherwise; ``torch.distributed.barrier()`` is the cross-process sync.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import time
import zipfile
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.checkpoint.saver import (
    _apply_write_fault,
    CheckpointSaver,
    read_pickle,
    verify_integrity,
    write_integrity_manifest,
    write_pickle,
)

logger = logging.getLogger("elasticdl_tpu_torch.checkpoint.sharded")

_MANIFEST = "manifest.json"
_DENSE = "dense.pkl"
_LOCAL_HEADER = struct.Struct("<4s22xHH")  # signature ... name and extra lengths


class ShardedArray(NamedTuple):
    """One array of a sharded save: its whole ``shape`` and numpy
    ``dtype`` name, and the ``parts`` this process writes, each ``(lo,
    hi, rows [hi - lo, ...])`` with rows a numpy array or a tensor on any
    device (copied to the host one entry at a time)."""

    shape: Sequence[int]
    dtype: str
    parts: List[Tuple[int, int, Any]]


def process_index_count() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _savez(path: str, entries: Dict[str, Any]) -> None:
    """``np.savez``'s file (one stored ``<key>.npy`` member per entry),
    each entry copied to the host only while it is written."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, value in entries.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host(value), allow_pickle=False)


class ShardFile:
    """One ``shards_p*.npz``: its entries, each read as a memory map of
    the stored member (a compressed member is decoded whole)."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path)
        self.keys = [name[: -len(".npy")] for name in self._zip.namelist()]
        self._maps: Dict[str, np.ndarray] = {}

    def array(self, key: str) -> np.ndarray:
        if key not in self._maps:
            self._maps[key] = self._open(self._zip.getinfo(key + ".npy"))
        return self._maps[key]

    def _open(self, info: zipfile.ZipInfo) -> np.ndarray:
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f, allow_pickle=False)
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            signature, name_len, extra_len = _LOCAL_HEADER.unpack(f.read(_LOCAL_HEADER.size))
            if signature != b"PK\x03\x04":
                raise ValueError(f"{self.path}: bad local header for {info.filename}")
            f.seek(info.header_offset + _LOCAL_HEADER.size + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
        if dtype.hasobject:
            raise ValueError(f"{self.path}: {info.filename} holds objects")
        if not int(np.prod(shape)):
            return np.zeros(shape, dtype)
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset, shape=shape,
                         order="F" if fortran else "C")

    def close(self) -> None:
        self._maps.clear()
        self._zip.close()


class ShardedCheckpointSaver(CheckpointSaver):
    """Collective sharded save and world-size-agnostic restore, in
    CheckpointSaver's directory layout; a step counts as committed once
    its manifest exists.  Every process calls ``save`` with the same step
    and array names; the barrier keeps the rank-0 commit from racing
    slower writers."""

    def __init__(self, checkpoint_dir: str, keep_max: int = 3):
        super().__init__(checkpoint_dir, keep_max=keep_max)
        # step -> {array name -> [(lo, hi, ShardFile, entry key)]}
        self._index_cache: Dict[int, Dict[str, List]] = {}

    def _is_committed(self, step_dir: str) -> bool:
        return os.path.exists(os.path.join(step_dir, _MANIFEST))

    def latest_step(self) -> Optional[int]:
        """The newest step that passes its integrity inventory: a full CRC
        on rank 0, existence and size elsewhere.  A torn snapshot is
        quarantined and the previous step wins; a transient I/O error
        skips the step."""
        check_crc = process_index_count()[0] == 0
        for step in reversed(self.steps()):
            step_dir = self._step_dir(step)
            try:
                reason = verify_integrity(step_dir, check_crc=check_crc)
            except OSError:
                logger.exception("Could not verify checkpoint %s (transient I/O error?); "
                                 "skipping it this restore", step_dir)
                continue
            if reason is None:
                return step
            self._quarantine(step_dir, reason)
        return None

    # -- save (collective) ----------------------------------------------

    def save(self, step: int, dense_state: Any, sharded: Dict[str, ShardedArray]) -> str:
        """``sharded``: the same array names on every process, each with
        the rows this process writes; a part covering every row is written
        by rank 0 alone.  ``dense_state`` (numpy leaves) may be None on
        ranks other than 0."""
        start = time.monotonic()
        process, n_processes = process_index_count()
        final_dir = self._step_dir(step)
        tmp_dir = final_dir + ".shared.tmp"
        if os.path.exists(final_dir):
            return final_dir
        os.makedirs(tmp_dir, exist_ok=True)

        entries: Dict[str, Any] = {}
        for name, array in sharded.items():
            for lo, hi, rows in array.parts:
                if _dtype_of(rows) != np.dtype(array.dtype):
                    raise ValueError(f"{name}: rows of {_dtype_of(rows)}, declared {array.dtype}")
                if (lo, hi) == (0, int(array.shape[0])) and process != 0:
                    continue  # replicated: rank 0 writes it
                entries[f"{name}|{lo}|{hi}"] = rows
        shard_files = [f"shards_p{i}of{n_processes}.npz" for i in range(n_processes)]
        _savez(os.path.join(tmp_dir, shard_files[process]), entries)
        os.utime(tmp_dir)  # fresh while the save is live (sweep_stale_tmp)

        if process == 0:
            write_pickle(os.path.join(tmp_dir, _DENSE), dense_state)
            os.utime(tmp_dir)

        if n_processes > 1:
            dist.barrier()

        if process == 0:
            # Files of an earlier world that died mid-save in this tmp dir
            # go; the manifest inventories exactly this world's files.
            for fname in os.listdir(tmp_dir):
                if fname.startswith("shards_p") and fname not in shard_files:
                    os.unlink(os.path.join(tmp_dir, fname))
            manifest = {
                "step": step,
                "n_processes": n_processes,
                "shard_files": shard_files,
                "arrays": {
                    name: {"shape": [int(d) for d in array.shape], "dtype": array.dtype}
                    for name, array in sharded.items()
                },
            }
            with open(os.path.join(tmp_dir, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            write_integrity_manifest(tmp_dir, shard_files + [_DENSE, _MANIFEST])
            _apply_write_fault(os.path.join(tmp_dir, _DENSE))
            try:
                os.rename(tmp_dir, final_dir)
            except OSError:
                if not os.path.exists(final_dir):
                    raise
            self._note_saved(start, step, "sharded", n_processes=n_processes)
            logger.info("Saved sharded checkpoint at step %d (%d arrays, %d procs)",
                        step, len(sharded), n_processes)
            self._garbage_collect()
        if n_processes > 1:
            dist.barrier()  # the commit is visible to every rank on return
        return final_dir

    # -- restore ----------------------------------------------------------

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)

    def load_dense(self, step: int) -> Any:
        return read_pickle(os.path.join(self._step_dir(step), _DENSE))

    def _entry_index(self, step: int) -> Dict[str, List]:
        if step not in self._index_cache:
            self._index_cache[step] = build_entry_index(
                self._step_dir(step), self.manifest(step).get("shard_files"))
        return self._index_cache[step]

    def row_reader(self, step: int, name: str) -> "RowReader":
        return RowReader.from_entries(self._entry_index(step).get(name, []))

    def load_rows(self, step: int, name: str, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of one sharded array as stored (a read-only
        view of the shard files where one entry covers them), checked
        against the manifest's dtype and row width."""
        meta = self.manifest(step)["arrays"][name]
        rows = self.row_reader(step, name).read(lo, hi)
        if rows.dtype != np.dtype(meta["dtype"]) or list(rows.shape[1:]) != meta["shape"][1:]:
            raise ValueError(f"{name}: stored rows {rows.dtype}{list(rows.shape[1:])} do not "
                             f"match the manifest's {meta['dtype']}{meta['shape'][1:]}")
        return rows

    def release(self, step: int) -> None:
        """Drop the entry index and close its files once a restore is done
        (the saver outlives the restore)."""
        index = self._index_cache.pop(step, None)
        for shard in {id(e[2]): e[2] for entries in (index or {}).values()
                      for e in entries}.values():
            shard.close()


def _dtype_of(rows) -> np.dtype:
    if isinstance(rows, torch.Tensor):
        return torch.empty((), dtype=rows.dtype).numpy().dtype
    return np.asarray(rows).dtype


def build_entry_index(step_dir: str, shard_files: Optional[List[str]] = None
                      ) -> Dict[str, List]:
    """{array name -> sorted [(lo, hi, ShardFile, entry key)]} over a
    checkpoint's shard files: the manifest's inventory, or (None) every
    ``shards_p*.npz`` of the directory."""
    if shard_files is None:
        shard_files = [f for f in sorted(os.listdir(step_dir))
                       if f.startswith("shards_p") and f.endswith(".npz")]
    index: Dict[str, List] = {}
    for fname in shard_files:
        shard = ShardFile(os.path.join(step_dir, fname))
        for key in shard.keys:
            arr_name, lo, hi = key.rsplit("|", 2)
            index.setdefault(arr_name, []).append((int(lo), int(hi), shard, key))
    for entries in index.values():
        entries.sort(key=lambda e: (e[0], e[1]))
    return index


class RowReader:
    """Reassembles any ``[lo, hi)`` row range of one named array from the
    shard files of a checkpoint written under any world size."""

    def __init__(self, step_dir: str, name: str):
        self._entries = build_entry_index(step_dir).get(name, [])

    @classmethod
    def from_entries(cls, entries: List) -> "RowReader":
        reader = cls.__new__(cls)
        reader._entries = entries
        return reader

    def read(self, lo: int, hi: int) -> np.ndarray:
        parts = []
        cursor = lo
        for e_lo, e_hi, shard, key in self._entries:
            if e_hi <= cursor or e_lo >= hi:
                continue
            if e_lo > cursor:
                raise ValueError(f"Checkpoint rows [{cursor}, {e_lo}) missing "
                                 f"(requested [{lo}, {hi}))")
            parts.append(shard.array(key)[cursor - e_lo: min(hi, e_hi) - e_lo])
            cursor = min(hi, e_hi)
            if cursor >= hi:
                break
        if cursor < hi:
            raise ValueError(f"Checkpoint rows [{cursor}, {hi}) missing "
                             f"(requested [{lo}, {hi}))")
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
