"""Predict edge of one serving replica over HTTP (``http.server``): the
port of ``elasticdl_tpu/serving/frontend.py``, whose gRPC the card's
machine does not have.

The payloads are the JAX package's, unchanged: features ride as an npz
dict (``encode_features``), outputs as one npy array (``encode_array``),
numpy's own portable serialization, so each package decodes the other's
bytes.  Requests (HTTP/1.1, keep-alive):

- ``POST /predict``: npz features -> npy outputs.  The client's deadline
  travels in the ``X-Deadline-S`` header (seconds left when sent); the
  server derives the batcher deadline from it, so per-request deadlines
  are set in one place, the caller's.
- ``POST /reload``: JSON ``{"model_dir": ...}`` -> JSON replica stats
  after the hot swap (a delta dir applies as a delta).
- ``POST /stats``: JSON replica stats, queue depth, the availability
  ledger's snapshot and the process's sparse-kernel launch counts.

gRPC's status codes become HTTP statuses, with a JSON body
``{"code": <the gRPC code's name>, "message": ...}``:
RESOURCE_EXHAUSTED (a shed request, the explicit backpressure signal)
429, DEADLINE_EXCEEDED 504, INVALID_ARGUMENT 400, INTERNAL 500; a replica
shutting down answers UNAVAILABLE 503.  ``PredictClient`` raises them as
``PredictError``, never an empty answer, and retries an idempotent
request (predict, stats) with the JAX package's policy (attempts,
backoff, jitter and budget of ``IDEMPOTENT_POLICY``) on a refused or
reset connection and on 503.

Not ported yet (ROADMAP.md Queue 1 item 8): trace ids over the transport
and the ``labels`` request of the quality plane.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.retry import HTTP_STATUS, IDEMPOTENT_POLICY, RetryPolicy
from elasticdl_tpu_torch.serving.batcher import MicroBatcher, QueueFullError

logger = get_logger("serving.frontend")

#: Server-side floor under the client deadline: leave headroom for the
#: response to travel back instead of computing a result nobody waits for.
_DEADLINE_HEADROOM_S = 0.005

DEADLINE_HEADER = "X-Deadline-S"

# ---------------------------------------------------------------------------
# Wire codec: numpy's own portable serialization as the message format
# ---------------------------------------------------------------------------


def encode_features(features: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in features.items()})
    return buf.getvalue()


def decode_features(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload)) as npz:
        return {k: npz[k] for k in npz.files}


def encode_array(array: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(array))
    return buf.getvalue()


def decode_array(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload))


class PredictError(RuntimeError):
    """A request the replica answered with a status other than OK."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.status = HTTP_STATUS.get(code, 500)


# ---------------------------------------------------------------------------
# Servicer + server
# ---------------------------------------------------------------------------


class PredictServicer:
    """Request handlers on the HTTP server's threads; the batcher thread
    owns the device, so handlers only block on ``_Pending.wait``.  Each
    returns the response bytes or raises ``PredictError``."""

    def __init__(self, replica, batcher: MicroBatcher):
        self._replica = replica
        self._batcher = batcher

    def predict(self, request: bytes, remaining: Optional[float]) -> bytes:
        try:
            features = decode_features(request)
        except Exception as exc:
            raise PredictError("INVALID_ARGUMENT", f"bad features payload: {exc}")
        deadline_s = None
        if remaining is not None and remaining < 3600:
            deadline_s = max(0.0, remaining - _DEADLINE_HEADROOM_S)
        try:
            req = self._batcher.submit(features, deadline_s=deadline_s)
            outputs = req.wait(remaining if remaining is not None else 60.0)
        except QueueFullError as exc:
            raise PredictError("RESOURCE_EXHAUSTED", str(exc))
        except TimeoutError as exc:
            raise PredictError("DEADLINE_EXCEEDED", str(exc))
        except ValueError as exc:
            raise PredictError("INVALID_ARGUMENT", str(exc))
        except RuntimeError as exc:
            # RequestError: dropped on deadline in queue, or execute failed.
            if "deadline" in str(exc):
                raise PredictError("DEADLINE_EXCEEDED", str(exc))
            raise PredictError("INTERNAL", str(exc))
        return encode_array(outputs)

    def reload(self, request: bytes) -> bytes:
        try:
            model_dir = json.loads(request.decode("utf-8"))["model_dir"]
        except Exception as exc:
            raise PredictError("INVALID_ARGUMENT", f"bad reload payload: {exc}")
        # A delta link (checkpoint/delta.py artifact) applies in place; a
        # failed apply rolled back, the old generation still answers, and
        # INTERNAL tells the caller so.
        is_delta = os.path.exists(os.path.join(model_dir, "delta.json"))
        try:
            if is_delta:
                self._replica.apply_delta(model_dir)
            else:
                self._replica.reload(model_dir)
        except Exception as exc:
            logger.exception("%s failed", "delta apply" if is_delta else "hot-swap reload")
            raise PredictError("INTERNAL", f"reload failed: {exc}")
        return self.stats(b"")

    def stats(self, request: bytes) -> bytes:
        from elasticdl_tpu_torch.ops.sparse_embedding import launch_counts
        from elasticdl_tpu_torch.serving.ledger import ledger

        payload = dict(self._replica.stats())
        payload["queue_depth"] = self._batcher.queue_depth()
        payload["ledger"] = ledger().snapshot()
        # The process's sparse-kernel launches on the card (none on the
        # CPU, where the plain versions run).
        payload["kernel_launches"] = launch_counts()
        return json.dumps(payload).encode("utf-8")


class _FrontendHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # Keep-alive handler threads live as long as their client's
    # connection; closing the server must not wait for them.
    block_on_close = False


class ServingFrontend:
    """The replica's listening edge: a threaded HTTP server over a
    ``PredictServicer``.  ``start()`` binds (port 0 = ephemeral) and
    returns the bound port."""

    def __init__(self, replica, batcher: MicroBatcher, port: int = 0, host: str = ""):
        self._servicer = PredictServicer(replica, batcher)
        self._requested = (host, port)
        self._server: Optional[_FrontendHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self.port: Optional[int] = None

    def start(self) -> int:
        servicer, stopping = self._servicer, self._stopping

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "elasticdl-serving/1"

            def do_POST(self):  # noqa: N802 (http.server API)
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                path = self.path.partition("?")[0]
                try:
                    if stopping.is_set():
                        raise PredictError("UNAVAILABLE", "replica shutting down")
                    if path == "/predict":
                        header = self.headers.get(DEADLINE_HEADER)
                        remaining = float(header) if header else None
                        out, ctype = servicer.predict(body, remaining), "application/octet-stream"
                    elif path == "/reload":
                        out, ctype = servicer.reload(body), "application/json"
                    elif path == "/stats":
                        out, ctype = servicer.stats(body), "application/json"
                    else:
                        self._reply(404, b"not found (try /predict, /reload, /stats)\n",
                                    "text/plain")
                        return
                except PredictError as exc:
                    message = str(exc)[len(exc.code) + 2:]
                    self._reply(exc.status, json.dumps(
                        {"code": exc.code, "message": message}).encode("utf-8"),
                        "application/json")
                    return
                except Exception as exc:  # the handler's bug: INTERNAL, keep serving
                    logger.exception("request %s failed", path)
                    self._reply(500, json.dumps(
                        {"code": "INTERNAL", "message": repr(exc)}).encode("utf-8"),
                        "application/json")
                    return
                self._reply(200, out, ctype)

            def _reply(self, status: int, body: bytes, ctype: str):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, format, *args):
                pass  # request traffic must not spam the replica log

        self._server = _FrontendHTTPServer(self._requested, Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serving-frontend", daemon=True)
        self._thread.start()
        logger.info("Predict frontend listening on port %d", self.port)
        return self.port

    def stop(self):
        """Answer UNAVAILABLE from here on, stop accepting, and close the
        listening socket."""
        self._stopping.set()
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


#: What a retry rides through: the replica is (re)starting or going away.
_TRANSIENT_ERRORS = (ConnectionRefusedError, ConnectionResetError, ConnectionAbortedError,
                     BrokenPipeError, http.client.RemoteDisconnected)


class PredictClient:
    """Typed client: codec + per-request deadline + retries of idempotent
    requests (a retried predict recomputes the same rows).  One
    keep-alive connection per calling thread."""

    def __init__(self, addr: str, deadline_s: float = 10.0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        host, _, port = addr.rpartition(":")
        self._addr = addr
        self._host, self._port = host.strip("[]") or "127.0.0.1", int(port)
        self._deadline_s = float(deadline_s)
        self._sleep = sleep
        self._clock = clock
        self._local = threading.local()
        self._conns = []  # every thread's connection, for close()
        self._conns_lock = threading.Lock()
        self.retries = 0

    def _conn(self, timeout_s: float) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port, timeout=timeout_s)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        conn.timeout = timeout_s
        if conn.sock is not None:
            conn.sock.settimeout(timeout_s)
        return conn

    def _drop_conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()

    def _once(self, path: str, body: bytes, timeout_s: float, headers: dict) -> bytes:
        conn = self._conn(timeout_s)
        try:
            conn.request("POST", path, body=body, headers=headers)
            response = conn.getresponse()
            payload = response.read()
        except TimeoutError as exc:
            self._drop_conn()
            raise PredictError("DEADLINE_EXCEEDED", f"no answer in {timeout_s} s: {exc}")
        except Exception:
            self._drop_conn()  # a fresh connection next attempt
            raise
        if response.status == 200:
            return payload
        try:
            err = json.loads(payload.decode("utf-8"))
            code, message = err["code"], err["message"]
        except (ValueError, KeyError, UnicodeDecodeError):
            code = next((c for c, s in HTTP_STATUS.items() if s == response.status), "UNKNOWN")
            message = payload.decode("utf-8", "replace")
        raise PredictError(code, message)

    def _call(self, method: str, body: bytes, policy: RetryPolicy, headers=None) -> bytes:
        deadline = self._clock() + policy.total_budget_s
        attempt = 0
        while True:
            attempt += 1
            try:
                return self._once(f"/{method}", body, policy.timeout_s, dict(headers or {}))
            except (PredictError, *_TRANSIENT_ERRORS) as exc:
                transient = not isinstance(exc, PredictError) or exc.code == "UNAVAILABLE"
                backoff = policy.backoff_s(method, attempt, salt=self._addr)
                out_of_budget = self._clock() + backoff + policy.timeout_s > deadline
                if not transient or attempt >= policy.max_attempts or out_of_budget:
                    raise
                if attempt == 1:
                    logger.warning("Request %s to %s hit %r; retrying with backoff",
                                   method, self._addr, exc)
                self.retries += 1
                self._sleep(backoff)

    def predict(self, features: Dict[str, np.ndarray],
                deadline_s: Optional[float] = None) -> np.ndarray:
        timeout = self._deadline_s if deadline_s is None else float(deadline_s)
        policy = RetryPolicy(timeout_s=timeout, max_attempts=IDEMPOTENT_POLICY.max_attempts)
        payload = self._call("predict", encode_features(features), policy,
                             {DEADLINE_HEADER: repr(timeout)})
        return decode_array(payload)

    def reload(self, model_dir: str, deadline_s: float = 120.0) -> dict:
        # NOT retried: a reload that already landed should not re-run.
        payload = self._call("reload", json.dumps({"model_dir": model_dir}).encode("utf-8"),
                             RetryPolicy(timeout_s=deadline_s, max_attempts=1))
        return json.loads(payload.decode("utf-8"))

    def stats(self, deadline_s: float = 10.0) -> dict:
        payload = self._call("stats", b"", RetryPolicy(timeout_s=deadline_s, max_attempts=2))
        return json.loads(payload.decode("utf-8"))

    def close(self):
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()
