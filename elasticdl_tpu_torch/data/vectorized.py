"""Fixed-width binary records parsed as columns: the port's copy of
``elasticdl_tpu/data/vectorized.py`` (``RecordLayout`` :30).

A contiguous payload chunk (``data/recordfile.read_range_buffers``) is
viewed through one numpy structured dtype, so a chunk becomes columnar
arrays in one pass with no per-record Python:

    LAYOUT = RecordLayout([
        ("dense", np.float32, 13),
        ("cat", np.int32, 26),
        ("label", np.uint8, 1),
    ])
    for buf, lengths in recordfile.read_range_buffers(path, start, end):
        columns = LAYOUT.parse_buffer(buf, lengths)  # dict of [n, k]
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class RecordLayout:
    """Schema of one fixed-width binary record: ordered
    ``(name, dtype, count)`` fields, little-endian, packed."""

    def __init__(self, fields: Sequence[Tuple[str, type, int]]):
        if not fields:
            raise ValueError("RecordLayout needs at least one field")
        self.fields = [
            (name, np.dtype(dtype).newbyteorder("<"), int(count))
            for name, dtype, count in fields
        ]
        self._struct = np.dtype([(name, dt, (count,)) for name, dt, count in self.fields])

    @property
    def record_bytes(self) -> int:
        return self._struct.itemsize

    def pack(self, **values) -> bytes:
        """One record's field values -> its bytes (the writer's side)."""
        row = np.zeros((), dtype=self._struct)
        for name, dt, count in self.fields:
            row[name] = np.asarray(values[name], dt).reshape(count)
        return row.tobytes()

    def parse_batch(self, raw_records: List[bytes]) -> Dict[str, np.ndarray]:
        """Payloads -> ``{field: [n, count] array}`` in one numpy pass."""
        buf = b"".join(raw_records)
        n, rem = divmod(len(buf), self.record_bytes)
        if rem or n != len(raw_records):
            raise ValueError(
                f"records are not fixed-width {self.record_bytes}B "
                f"(got {len(buf)}B for {len(raw_records)} records)"
            )
        return self.parse_buffer(np.frombuffer(buf, np.uint8))

    def parse_buffer(self, buf, lengths=None, copy=True) -> Dict[str, np.ndarray]:
        """A contiguous payload buffer (``np.uint8``) -> columnar arrays.
        ``lengths``, when given, is checked against the record width.
        ``copy=False`` returns views of the (possibly read-only) buffer,
        for consumers that gather into fresh arrays anyway."""
        buf = np.ascontiguousarray(buf, np.uint8)
        n, rem = divmod(buf.size, self.record_bytes)
        if rem:
            raise ValueError(
                f"buffer size {buf.size} is not a multiple of the "
                f"record width {self.record_bytes}"
            )
        if lengths is not None and (
            len(lengths) != n or not (np.asarray(lengths) == self.record_bytes).all()
        ):
            raise ValueError(f"records are not fixed-width {self.record_bytes}B")
        table = buf.view(self._struct)
        wrap = np.array if copy else np.asarray
        return {name: wrap(table[name]) for name, _, _ in self.fields}
