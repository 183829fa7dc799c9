"""The ODPS (MaxCompute) table reader: the port's copy of
``elasticdl_tpu/data/odps_reader.py``.  A table shards by row ranges
(``create_shards`` names the table, ``read_records`` pulls a range), so
cloud tables ride the same dynamic-sharding task queue as files.

The ``odps`` SDK is installed on neither the CPU nor the card's machine,
so the transport is injectable: ``ODPSDataReader(client=...)`` takes any
object with the ``TableClient`` surface (``row_count``, ``read_rows``,
``column_names``); the default client is built from the ``odps`` package
and credentials (kwargs, or ODPS_ACCESS_ID / ODPS_ACCESS_KEY /
ODPS_PROJECT_NAME / ODPS_ENDPOINT) when the reader is constructed, and
raises there, never at import time, when either is missing.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.reader import AbstractDataReader, Metadata

logger = get_logger("data.odps_reader")


class TableClient:
    """The transport surface ODPSDataReader needs (duck-typed).

    - row_count(table, partition) -> int
    - read_rows(table, partition, start, count, columns) -> iterator of
      row tuples/lists
    - column_names(table) -> list[str]
    """

    def row_count(self, table: str, partition: Optional[str]) -> int:
        raise NotImplementedError

    def read_rows(self, table, partition, start, count, columns):
        raise NotImplementedError

    def column_names(self, table: str) -> List[str]:
        raise NotImplementedError


class _OdpsSdkClient(TableClient):
    """Real transport over the `odps` package (pyodps)."""

    def __init__(self, access_id, access_key, project, endpoint):
        try:
            from odps import ODPS  # the cloud SDK, installed by the user
        except ImportError as e:
            raise RuntimeError(
                "ODPSDataReader needs the `odps` package (pyodps) or an "
                "injected client=; neither is available"
            ) from e
        self._odps = ODPS(access_id, access_key, project, endpoint=endpoint)

    def _table(self, table):
        return self._odps.get_table(table)

    def row_count(self, table, partition):
        t = self._table(table)
        if partition:
            return t.get_partition(partition).record_num
        with t.open_reader() as reader:
            return reader.count

    def read_rows(self, table, partition, start, count, columns):
        with self._table(table).open_reader(partition=partition) as reader:
            for record in reader.read(start=start, count=count,
                                      columns=columns or None):
                yield [record[i] for i in range(len(record))]

    def column_names(self, table):
        return [c.name for c in self._table(table).table_schema.columns]


class ODPSDataReader(AbstractDataReader):
    """Shard-addressable reader over one ODPS table.

    kwargs (reference flag names, via --data_reader_params):
    table=, partition=, columns= ('a;b;c'), plus credentials
    (access_id/access_key/project/endpoint) falling back to ODPS_* env.
    """

    def __init__(
        self,
        data_dir: str = "",
        table: str = "",
        partition: str = "",
        columns: str = "",
        client: Optional[TableClient] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        # `odps://table_name` / bare table name via the data path, or
        # table= via reader params.
        path = data_dir or kwargs.get("data_path", "")
        if path.startswith("odps://"):
            path = path[len("odps://"):]
        # The factory splits 'odps://table' at the first ':', handing this
        # reader '//table'.
        self._table = table or path.lstrip("/")
        if not self._table:
            raise ValueError("ODPSDataReader needs a table name")
        self._partition = partition or None
        self._columns = (
            [c for c in columns.split(";") if c] if columns else []
        )
        self._client = client or self._default_client(kwargs)
        self._count: Optional[int] = None

    @staticmethod
    def _default_client(kwargs) -> TableClient:
        def cred(name, env):
            return kwargs.get(name, "") or os.environ.get(env, "")

        access_id = cred("access_id", "ODPS_ACCESS_ID")
        access_key = cred("access_key", "ODPS_ACCESS_KEY")
        project = cred("project", "ODPS_PROJECT_NAME")
        endpoint = cred("endpoint", "ODPS_ENDPOINT")
        if not (access_id and access_key and project):
            raise ValueError(
                "ODPS credentials missing: pass access_id/access_key/"
                "project via --data_reader_params or the ODPS_ACCESS_ID/"
                "ODPS_ACCESS_KEY/ODPS_PROJECT_NAME env vars"
            )
        return _OdpsSdkClient(access_id, access_key, project, endpoint)

    # -- AbstractDataReader ----------------------------------------------

    def _shard_name(self) -> str:
        return (
            f"{self._table}/{self._partition}"
            if self._partition
            else self._table
        )

    def shard_names(self):
        """Config-derived: no table-count RPC — N workers calling this at
        boot must not fan N redundant tunnel-reader opens at the cloud."""
        return [self._shard_name()]

    def create_shards(self):
        if self._count is None:
            self._count = int(
                self._client.row_count(self._table, self._partition)
            )
        return {self._shard_name(): self._count}

    def read_records(self, task) -> Iterator:
        start = max(0, task.start)
        count = task.end - start
        if count <= 0:
            return
        yield from self._client.read_rows(
            self._table, self._partition, start, count, self._columns
        )

    @property
    def metadata(self) -> Metadata:
        names = self._columns or self._client.column_names(self._table)
        return Metadata(column_names=list(names))
