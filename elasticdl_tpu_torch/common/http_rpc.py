"""JSON over HTTP for the master's service (``http.server`` and
``http.client``), the port's stand-in for gRPC, which the card's machine
does not have.

A call is ``POST /<method>`` with the request message as a JSON body
(``common/messages.py``); the answer is the response message as JSON
with status 200, or a gRPC code as an HTTP status (``common/retry.
HTTP_STATUS``) with the body ``{"code": <the code's name>, "message":
...}``.  An unknown method answers UNIMPLEMENTED, a body that does not
parse INVALID_ARGUMENT, a handler that raises INTERNAL, and a server
that is stopping UNAVAILABLE.

``JsonRpcClient`` keeps one keep-alive connection per calling thread for
the retried calls, and opens a fresh connection for a call made once
(``max_attempts == 1``), so a connection the server closed while idle
(a master restart) can never fail a call that is not retried.  A failed
attempt drops its connection, so a retry reconnects.
"""

from __future__ import annotations

import http.client
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.retry import (
    HTTP_STATUS,
    RetryPolicy,
    RetryStats,
    RpcError,
    call_with_retry,
)

logger = get_logger("common.http_rpc")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # Keep-alive handler threads live as long as their client's
    # connection; closing the server must not wait for them.
    block_on_close = False


class JsonRpcServer:
    """A threaded HTTP server over ``service``, whose method ``name`` takes
    the request message of ``messages.METHODS[name]`` and returns its
    response message.  ``start()`` binds (port 0 = ephemeral) and returns
    the bound port."""

    def __init__(self, service, port: int = 0, host: str = "", name: str = "rpc"):
        self._service = service
        self._requested = (host, port)
        self._name = name
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self.port: Optional[int] = None

    def _dispatch(self, method: str, body: bytes) -> bytes:
        if self._stopping.is_set():
            raise RpcError("UNAVAILABLE", "server stopping")
        if method not in messages.METHODS:
            raise RpcError("UNIMPLEMENTED", f"no method {method!r}")
        request_cls, _ = messages.METHODS[method]
        try:
            request = messages.from_json(request_cls, json.loads(body.decode("utf-8") or "{}"))
        except (ValueError, TypeError) as exc:
            raise RpcError("INVALID_ARGUMENT", f"bad {method} request: {exc}")
        response = getattr(self._service, method)(request)
        return json.dumps(messages.to_json(response)).encode("utf-8")

    def start(self) -> int:
        dispatch, stopping = self._dispatch, self._stopping

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "elasticdl-torch-rpc/1"

            def do_POST(self):  # noqa: N802 (http.server API)
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                method = self.path.partition("?")[0].strip("/")
                try:
                    out = dispatch(method, body)
                except RpcError as exc:
                    self._reply(exc.status, {"code": exc.code, "message": exc.message})
                    return
                except Exception as exc:  # the handler's bug: INTERNAL, keep serving
                    logger.exception("%s failed", method)
                    self._reply(500, {"code": "INTERNAL", "message": repr(exc)})
                    return
                self._reply(200, out)

            def _reply(self, status: int, body):
                if not isinstance(body, bytes):
                    body = json.dumps(body).encode("utf-8")
                if stopping.is_set():
                    self.close_connection = True
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, format, *args):
                pass  # every heartbeat and poll would log a line

        self._server = _Server(self._requested, Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"{self._name}-server", daemon=True)
        self._thread.start()
        return self.port

    def wait_for_termination(self) -> None:
        """Block until the server is stopped (or this thread interrupted)."""
        thread = self._thread
        if thread is not None:
            thread.join()

    def stop(self) -> None:
        """Answer UNAVAILABLE from here on (open keep-alive connections
        included), stop accepting and close the listening socket."""
        self._stopping.set()
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class JsonRpcClient:
    """Typed calls to a ``JsonRpcServer`` at ``addr`` (``host:port``)."""

    def __init__(self, addr: str, sleep: Callable[[float], None] = None,
                 clock: Callable[[], float] = None, seed: str = ""):
        import time

        host, _, port = addr.rpartition(":")
        host = host.strip("[]") or "127.0.0.1"
        self._host = "127.0.0.1" if host == "localhost" else host
        self._port = int(port)
        self._sleep = sleep or time.sleep
        self._clock = clock or time.monotonic
        self._seed = seed
        self._local = threading.local()
        self._conns = []
        self._conns_lock = threading.Lock()
        self.stats = RetryStats()

    def _connection(self, timeout_s: float, reuse: bool) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None) if reuse else None
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port, timeout=timeout_s)
            if reuse:
                self._local.conn = conn
                with self._conns_lock:
                    self._conns.append(conn)
        conn.timeout = timeout_s
        if conn.sock is not None:
            conn.sock.settimeout(timeout_s)
        return conn

    def _drop(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()

    def _once(self, method: str, body: bytes, timeout_s: float, reuse: bool) -> dict:
        conn = self._connection(timeout_s, reuse)
        try:
            conn.request("POST", f"/{method}", body=body,
                         headers={"Content-Type": "application/json"})
            response = conn.getresponse()
            payload = response.read()
        except Exception:
            if reuse:
                self._drop()
            raise
        finally:
            if not reuse:
                conn.close()
        try:
            obj = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            obj = None
        if response.status == 200 and isinstance(obj, dict):
            return obj
        if reuse:
            self._drop()  # a retry reconnects (the server may have restarted)
        if isinstance(obj, dict) and "code" in obj:
            raise RpcError(obj["code"], obj.get("message", ""))
        code = next((c for c, s in HTTP_STATUS.items() if s == response.status), "UNKNOWN")
        raise RpcError(code, payload.decode("utf-8", "replace"))

    def call(self, method: str, request, policy: RetryPolicy):
        """The response message of ``method`` for ``request`` under
        ``policy`` (``common/retry.call_with_retry``)."""
        body = json.dumps(messages.to_json(request)).encode("utf-8")
        _, response_cls = messages.METHODS[method]
        reuse = policy.max_attempts > 1
        obj = call_with_retry(
            lambda timeout_s: self._once(method, body, timeout_s, reuse),
            method, policy, stats=self.stats, sleep=self._sleep, clock=self._clock,
            seed=self._seed,
        )
        return messages.from_json(response_cls, obj)

    def close(self) -> None:
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()
