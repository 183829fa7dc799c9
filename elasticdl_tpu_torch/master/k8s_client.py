"""Minimal Kubernetes API client (pods only) over the standard library:
the port's copy of ``elasticdl_tpu/master/k8s_client.py``.

The pod manager needs five verbs (create, get, list, delete, watch) plus
auth and TLS configuration, so the client speaks the REST API directly
with ``http.client`` and ``ssl``; no ``kubernetes`` package is needed.

Auth config resolution order (``K8sConfig.resolve``):
1. explicit host/token (``ELASTICDL_K8S_HOST``, ``ELASTICDL_K8S_TOKEN``,
   ``ELASTICDL_K8S_CA_FILE``, ``ELASTICDL_K8S_VERIFY``);
2. the in-cluster service account (token and CA mounted at the standard
   path);
3. ``$KUBECONFIG`` or ``~/.kube/config`` (token or client-cert users;
   reading it needs PyYAML).

Watch semantics: ``watch_pods`` yields ``(event_type, pod_dict)`` tuples
decoded from the API server's JSON-lines stream; callers resume from the
last seen ``resourceVersion`` on reconnect.  A 410 Gone (version
expired) raises ``WatchExpired``; callers re-list and restart the watch.

``render_pod`` renders one pod of a job; a GPU worker asks for its card
through the resource dict (``--worker_resource_request=nvidia.com/gpu=1``
becomes the container's request and limit).
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import ssl
import urllib.parse
from typing import Dict, Iterator, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("master.k8s_client")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Labels stamped on every pod this framework creates (reference:
# k8s_client.get_elasticdl_job_name / ELASTICDL_JOB_KEY et al.).
LABEL_APP = "app"
LABEL_JOB_NAME = "elasticdl-job-name"
LABEL_REPLICA_TYPE = "elasticdl-replica-type"
LABEL_REPLICA_INDEX = "elasticdl-replica-index"
APP_NAME = "elasticdl"


class ApiError(Exception):
    """Non-2xx response from the API server."""

    def __init__(self, status: int, reason: str, body: str = ""):
        self.status = status
        self.reason = reason
        self.body = body
        super().__init__(f"k8s API error {status} {reason}: {body[:200]}")


class WatchExpired(ApiError):
    """410 Gone on a watch: the resourceVersion is too old; re-list."""


class K8sConfig:
    """Connection + auth parameters for one API server."""

    def __init__(
        self,
        host: str,
        token: str = "",
        ca_file: str = "",
        client_cert_file: str = "",
        client_key_file: str = "",
        namespace: str = "default",
        verify_tls: bool = True,
    ):
        if "://" not in host:
            host = "https://" + host
        self.host = host.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.client_cert_file = client_cert_file
        self.client_key_file = client_key_file
        self.namespace = namespace
        self.verify_tls = verify_tls

    # -- constructors ---------------------------------------------------

    @classmethod
    def from_incluster(cls) -> "K8sConfig":
        """Service-account credentials mounted into every pod."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "Not running in a Kubernetes cluster "
                "(KUBERNETES_SERVICE_HOST unset)"
            )
        token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
        ns_path = os.path.join(SERVICE_ACCOUNT_DIR, "namespace")
        with open(token_path) as f:
            token = f.read().strip()
        namespace = "default"
        if os.path.exists(ns_path):
            with open(ns_path) as f:
                namespace = f.read().strip() or "default"
        ca = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
        return cls(
            host=f"https://{host}:{port}",
            token=token,
            ca_file=ca if os.path.exists(ca) else "",
            namespace=namespace,
        )

    @classmethod
    def from_kubeconfig(
        cls, path: str = "", context: str = ""
    ) -> "K8sConfig":
        import yaml  # PyYAML: needed only to read a kubeconfig

        path = (
            path
            or os.environ.get("KUBECONFIG", "")
            or os.path.expanduser("~/.kube/config")
        )
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context", "")
        ctx = next(
            (c["context"] for c in cfg.get("contexts", []) if c["name"] == ctx_name),
            None,
        )
        if ctx is None:
            raise ValueError(f"kubeconfig {path}: no context {ctx_name!r}")
        cluster = next(
            c["cluster"]
            for c in cfg.get("clusters", [])
            if c["name"] == ctx["cluster"]
        )
        user = next(
            (u["user"] for u in cfg.get("users", []) if u["name"] == ctx.get("user")),
            {},
        )
        base = os.path.dirname(os.path.abspath(path))

        def _materialize(entry: dict, key: str) -> str:
            """Return a file path for `key`, writing `key-data` out if inline."""
            if entry.get(key):
                p = entry[key]
                return p if os.path.isabs(p) else os.path.join(base, p)
            data = entry.get(key + "-data")
            if data:
                import base64
                import tempfile

                fd, tmp = tempfile.mkstemp(prefix="edl_k8s_", suffix=".pem")
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(data))
                return tmp
            return ""

        return cls(
            host=cluster["server"],
            token=user.get("token", ""),
            ca_file=_materialize(cluster, "certificate-authority"),
            client_cert_file=_materialize(user, "client-certificate"),
            client_key_file=_materialize(user, "client-key"),
            namespace=ctx.get("namespace", "default"),
            verify_tls=not cluster.get("insecure-skip-tls-verify", False),
        )

    @classmethod
    def resolve(cls, namespace: str = "") -> "K8sConfig":
        """Explicit env > in-cluster > kubeconfig (see module docstring)."""
        if os.environ.get("ELASTICDL_K8S_HOST"):
            config = cls(
                host=os.environ["ELASTICDL_K8S_HOST"],
                token=os.environ.get("ELASTICDL_K8S_TOKEN", ""),
                ca_file=os.environ.get("ELASTICDL_K8S_CA_FILE", ""),
                verify_tls=os.environ.get("ELASTICDL_K8S_VERIFY", "1") != "0",
            )
        elif os.environ.get("KUBERNETES_SERVICE_HOST"):
            config = cls.from_incluster()
        else:
            config = cls.from_kubeconfig()
        if namespace:
            config.namespace = namespace
        return config


class K8sClient:
    """Pods-only typed client; one instance per job, thread-safe by virtue
    of opening a connection per request (watch holds its own)."""

    def __init__(self, config: K8sConfig):
        self._config = config
        parsed = urllib.parse.urlsplit(config.host)
        self._scheme = parsed.scheme
        self._netloc = parsed.netloc
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self._scheme == "https":
            ctx = ssl.create_default_context(
                cafile=config.ca_file or None
            )
            if config.client_cert_file:
                ctx.load_cert_chain(
                    config.client_cert_file, config.client_key_file or None
                )
            if not config.verify_tls:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl_ctx = ctx

    @property
    def namespace(self) -> str:
        return self._config.namespace

    # -- transport ------------------------------------------------------

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._netloc, timeout=timeout, context=self._ssl_ctx
            )
        return http.client.HTTPConnection(self._netloc, timeout=timeout)

    def _request(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[dict] = None,
        timeout: float = 30.0,
    ) -> Tuple[http.client.HTTPConnection, http.client.HTTPResponse]:
        if query:
            path = path + "?" + urllib.parse.urlencode(query)
        headers = {"Accept": "application/json"}
        if self._config.token:
            headers["Authorization"] = f"Bearer {self._config.token}"
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        conn = self._connect(timeout)
        try:
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
        except Exception:
            conn.close()
            raise
        if resp.status >= 300:
            data = resp.read().decode(errors="replace")
            conn.close()
            if resp.status == 410:
                raise WatchExpired(resp.status, resp.reason or "", data)
            raise ApiError(resp.status, resp.reason or "", data)
        return conn, resp

    def _json(self, *args, **kwargs) -> dict:
        conn, resp = self._request(*args, **kwargs)
        try:
            return json.loads(resp.read().decode())
        finally:
            conn.close()

    def _pods_path(self, namespace: str = "", name: str = "") -> str:
        ns = namespace or self._config.namespace
        path = f"/api/v1/namespaces/{urllib.parse.quote(ns)}/pods"
        if name:
            path += "/" + urllib.parse.quote(name)
        return path

    # -- verbs ----------------------------------------------------------

    def create_pod(self, manifest: dict, namespace: str = "") -> dict:
        return self._json(
            "POST", self._pods_path(namespace), body=manifest
        )

    def get_pod(self, name: str, namespace: str = "") -> Optional[dict]:
        try:
            return self._json("GET", self._pods_path(namespace, name))
        except ApiError as e:
            if e.status == 404:
                return None
            raise

    def list_pods(
        self, label_selector: str = "", namespace: str = ""
    ) -> List[dict]:
        return self.list_pods_raw(label_selector, namespace).get("items", [])

    def list_pods_raw(
        self, label_selector: str = "", namespace: str = ""
    ) -> dict:
        """Full PodList (items + list metadata.resourceVersion, the correct
        point to resume a watch from after a re-list)."""
        query = {"labelSelector": label_selector} if label_selector else None
        return self._json("GET", self._pods_path(namespace), query=query)

    def delete_pod(
        self, name: str, namespace: str = "", grace_period_s: int = 0
    ) -> bool:
        """True if deleted, False if it was already gone."""
        try:
            self._json(
                "DELETE",
                self._pods_path(namespace, name),
                query={"gracePeriodSeconds": str(grace_period_s)},
            )
            return True
        except ApiError as e:
            if e.status == 404:
                return False
            raise

    def watch_pods(
        self,
        label_selector: str = "",
        resource_version: str = "",
        timeout_s: float = 60.0,
        namespace: str = "",
    ) -> Iterator[Tuple[str, dict]]:
        """Yield (event_type, pod) from one watch connection until the
        server closes it (or `timeout_s` of silence).  event_type is
        ADDED | MODIFIED | DELETED | BOOKMARK; a socket timeout ends the
        iterator quietly (callers loop and reconnect)."""
        query = {
            "watch": "true",
            "allowWatchBookmarks": "true",
            # Server-side cap so idle connections recycle.
            "timeoutSeconds": str(max(1, int(timeout_s))),
        }
        if label_selector:
            query["labelSelector"] = label_selector
        if resource_version:
            query["resourceVersion"] = resource_version
        conn, resp = self._request(
            "GET", self._pods_path(namespace), query=query,
            timeout=timeout_s + 5,
        )
        try:
            while True:
                try:
                    line = resp.readline()
                except (socket.timeout, ssl.SSLError, OSError):
                    return
                if not line:
                    return
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("Unparseable watch line: %r", line[:120])
                    continue
                if event.get("type") == "ERROR":
                    obj = event.get("object", {})
                    if obj.get("code") == 410:
                        raise WatchExpired(410, "Gone", json.dumps(obj))
                    raise ApiError(
                        obj.get("code", 500), "watch error", json.dumps(obj)
                    )
                yield event.get("type", ""), event.get("object", {})
        finally:
            conn.close()


# ----------------------------------------------------------------------
# Pod spec rendering
# ----------------------------------------------------------------------


def job_label_selector(job_name: str, replica_type: str = "") -> str:
    sel = f"{LABEL_APP}={APP_NAME},{LABEL_JOB_NAME}={job_name}"
    if replica_type:
        sel += f",{LABEL_REPLICA_TYPE}={replica_type}"
    return sel


def pod_name(job_name: str, replica_type: str, index: int) -> str:
    return f"elasticdl-{job_name}-{replica_type}-{index}"


def _env_list(env: Dict[str, str]) -> List[dict]:
    entries = [{"name": k, "value": v} for k, v in sorted(env.items())]
    # Every pod learns its own IP (workers advertise it to the rendezvous;
    # the master binds its endpoint to it).
    entries.append(
        {
            "name": "MY_POD_IP",
            "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}},
        }
    )
    return entries


def parse_resource_spec(spec: str) -> Dict[str, str]:
    """'cpu=1,memory=2Gi' -> {'cpu': '1', 'memory': '2Gi'} (k8s quantities
    stay strings; the API server owns their grammar)."""
    out: Dict[str, str] = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in item:
            raise ValueError(f"Malformed resource {item!r} in {spec!r}")
        key, value = item.split("=", 1)
        out[key.strip()] = value.strip()
    return out


def parse_volume_spec(spec: str):
    """Parse the --volume flag into (volumes, volumeMounts).

    Grammar (reference --volume flag): ';'-separated entries of
    'claim_name=<pvc>,mount_path=<path>' or
    'host_path=<path>,mount_path=<path>' (optionally 'sub_path=<p>',
    'read_only=true').  Shared mounts are how elastic jobs get a
    checkpoint_dir every pod can see.
    """
    volumes, mounts = [], []
    for i, entry in enumerate(filter(None, (e.strip() for e in spec.split(";")))):
        fields = {}
        for item in filter(None, (s.strip() for s in entry.split(","))):
            if "=" not in item:
                raise ValueError(f"Malformed volume field {item!r} in {spec!r}")
            key, value = item.split("=", 1)
            fields[key.strip()] = value.strip()
        if "mount_path" not in fields:
            raise ValueError(f"Volume entry {entry!r} lacks mount_path")
        name = f"edl-volume-{i}"
        if "claim_name" in fields:
            volumes.append(
                {
                    "name": name,
                    "persistentVolumeClaim": {
                        "claimName": fields["claim_name"]
                    },
                }
            )
        elif "host_path" in fields:
            volumes.append(
                {"name": name, "hostPath": {"path": fields["host_path"]}}
            )
        else:
            raise ValueError(
                f"Volume entry {entry!r} needs claim_name= or host_path="
            )
        mount = {"name": name, "mountPath": fields["mount_path"]}
        if "sub_path" in fields:
            mount["subPath"] = fields["sub_path"]
        if fields.get("read_only", "").lower() == "true":
            mount["readOnly"] = True
        mounts.append(mount)
    return volumes, mounts


def render_pod(
    job_name: str,
    replica_type: str,
    index: int,
    image: str,
    command: List[str],
    namespace: str,
    env: Optional[Dict[str, str]] = None,
    resources: Optional[Dict[str, str]] = None,
    priority_class: str = "",
    owner: Optional[dict] = None,
    image_pull_policy: str = "IfNotPresent",
    volume_spec: str = "",
    node_selector: Optional[Dict[str, str]] = None,
) -> dict:
    """One ElasticDL pod (master or worker).

    restartPolicy=Never: restarts are a *pod-manager* decision (the
    restart budget + restart-the-world recovery live there, reference
    pod_manager semantics), never kubelet's.
    """
    meta: dict = {
        "name": pod_name(job_name, replica_type, index),
        "namespace": namespace,
        "labels": {
            LABEL_APP: APP_NAME,
            LABEL_JOB_NAME: job_name,
            LABEL_REPLICA_TYPE: replica_type,
            LABEL_REPLICA_INDEX: str(index),
        },
    }
    if owner:
        # Workers are ownerReferenced to the master pod so `kubectl delete`
        # of the master garbage-collects the fleet (reference behavior).
        meta["ownerReferences"] = [
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "name": owner["metadata"]["name"],
                "uid": owner["metadata"]["uid"],
                "controller": True,
                "blockOwnerDeletion": False,
            }
        ]
    spec: dict = {
        "restartPolicy": "Never",
        "containers": [
            {
                "name": replica_type,
                "image": image,
                "imagePullPolicy": image_pull_policy,
                "command": command,
                "env": _env_list(env or {}),
            }
        ],
    }
    if resources:
        spec["containers"][0]["resources"] = {
            "requests": dict(resources),
            "limits": dict(resources),
        }
    if priority_class:
        spec["priorityClassName"] = priority_class
    if node_selector:
        spec["nodeSelector"] = dict(node_selector)
    if volume_spec:
        volumes, mounts = parse_volume_spec(volume_spec)
        spec["volumes"] = volumes
        spec["containers"][0]["volumeMounts"] = mounts
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": spec,
    }


def pod_phase(pod: dict) -> str:
    return (pod.get("status") or {}).get("phase", "Unknown")


def pod_exit_code(pod: dict) -> Optional[int]:
    """Container exit code of a terminated pod, if the kubelet reported one."""
    statuses = (pod.get("status") or {}).get("containerStatuses") or []
    for st in statuses:
        term = (st.get("state") or {}).get("terminated")
        if term is not None and term.get("exitCode") is not None:
            return int(term["exitCode"])
    return None
