"""The port's cluster launch (``elasticdl_tpu_torch/master/{k8s_client,
k8s_pod_manager,tpu_slice}.py``, ``client/submit.py``, the Kubernetes
branch of ``master/job_runner.py`` and ``client/api.py``) against the
JAX package, on the CPU: no cluster is reachable, so the pods are dicts
and the API server is ``tests/fake_k8s.py`` (standard library only).

- Rendered manifests: worker pods and the master pod, for the same
  flags (``--tpu_slice``, ``--volume``, resources, priority, owner),
  must equal JAX's; the master pod's command differs only in the module
  it runs (``elasticdl_tpu_torch.master.main``) and the port's
  ``--device`` flag.
- Submission: ``submit_job`` and ``client.main train --image_name`` create
  the master pod; the pre-flight refusals match JAX's.
- The pod manager against the fake server: completion, churn
  re-formation with fresh ids, preemption, the restart budget, the
  two-phase scale-up, the leftover sweep, a vanished pod found by a
  re-list, and a watch that drops every stream (410 Gone included).
"""

import time

import pytest

from elasticdl_tpu.client import submit as jsubmit
from elasticdl_tpu.common import args as jargs
from elasticdl_tpu.master import k8s_client as jk8s
from elasticdl_tpu.master import tpu_slice as jslice
from elasticdl_tpu_torch.client import main as client_main
from elasticdl_tpu_torch.client import submit as psubmit
from elasticdl_tpu_torch.common import args as pargs
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.master import job_runner
from elasticdl_tpu_torch.master import k8s_client as pk8s
from elasticdl_tpu_torch.master import tpu_slice as pslice
from elasticdl_tpu_torch.master.k8s_pod_manager import (
    PREEMPTED_EXIT_CODE,
    KubernetesPodManager,
)
from fake_k8s import FakeK8sApiServer

OWNER = {"metadata": {"name": "elasticdl-j-master-0", "uid": "u-1"}}
VOLUME = "claim_name=ckpt-pvc,mount_path=/ckpt;host_path=/data,mount_path=/data,read_only=true"


@pytest.fixture()
def fake_k8s():
    server = FakeK8sApiServer().start()
    yield server
    server.stop()


@pytest.fixture()
def client(fake_k8s):
    return pk8s.K8sClient(pk8s.K8sConfig(host=fake_k8s.host, namespace="testns"))


def _wait_for(predicate, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"Timed out waiting for {msg}")


class _Tasks:
    def __init__(self):
        self.recovered = []

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)

    def finished(self):
        return False


def _manager(client, n=2, **kwargs):
    tasks = _Tasks()
    kwargs.setdefault("poll_interval_s", 0.05)
    kwargs.setdefault("pod_startup_timeout_s", 0)
    manager = KubernetesPodManager(
        num_workers=n, worker_argv_fn=lambda wid: ["python", "-m", "worker", str(wid)],
        k8s_client=client, job_name="testjob", image="elasticdl:test", task_manager=tasks,
        job_finished_fn=tasks.finished, **kwargs)
    return manager, tasks


# -- rendering ------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    {},
    {"resources": {"nvidia.com/gpu": "1", "cpu": "8"}, "priority_class": "high"},
    {"env": {"B": "2", "A": "1"}, "owner": OWNER, "volume_spec": VOLUME},
    {"node_selector": {"cloud.google.com/gke-tpu-topology": "2x4"},
     "resources": {"google.com/tpu": "4"}, "image_pull_policy": "Always"},
])
def test_render_pod_matches_jax(extra):
    common = dict(job_name="j", replica_type="worker", index=3, image="img:1",
                  command=["python", "-m", "w"], namespace="ns", **extra)
    assert pk8s.render_pod(**common) == jk8s.render_pod(**common)


@pytest.mark.parametrize("spec", ["", "cpu=1,memory=2Gi", " nvidia.com/gpu=1 , cpu=4 ", "cpu"])
def test_resource_and_volume_specs_match_jax(spec):
    for parse in ("parse_resource_spec", "parse_volume_spec"):
        text = VOLUME if parse == "parse_volume_spec" and spec == "cpu=1,memory=2Gi" else spec
        try:
            want = getattr(jk8s, parse)(text)
        except ValueError as exc:
            with pytest.raises(ValueError):
                getattr(pk8s, parse)(text)
            assert str(exc)
            continue
        assert getattr(pk8s, parse)(text) == want


def test_tpu_slice_catalog_matches_jax():
    assert {k: vars(v) for k, v in pslice.TPU_SLICES.items()} == {
        k: vars(v) for k, v in jslice.TPU_SLICES.items()}
    for name in pslice.TPU_SLICES:
        assert (pslice.worker_pod_overlay(pslice.slice_spec(name))
                == jslice.worker_pod_overlay(jslice.slice_spec(name)))
    with pytest.raises(ValueError, match="known shapes"):
        pslice.slice_spec("v9z-1")
    with pytest.raises(ValueError, match="4 host"):
        pslice.validate_worker_count(pslice.slice_spec("v5e-16"), 3)


JOB = ["--job_name=subjob", "--image_name=elasticdl:test", "--namespace=testns",
       "--model_zoo=model_zoo", "--model_def=deepfm.deepfm_functional_api",
       "--training_data=/data/train", "--checkpoint_dir=/ckpt/subjob", "--volume=" + VOLUME]


@pytest.mark.parametrize("flags,mode", [
    (["--num_workers=3", "--master_resource_request=cpu=1,memory=2Gi",
      "--worker_resource_request=nvidia.com/gpu=1", "--distribution_strategy=AllreduceStrategy"],
     Mode.TRAINING),
    (["--num_workers=2", "--tpu_slice=v5e-8", "--need_elasticity=false",
      "--worker_pod_priority=high", "--distribution_strategy=ParameterServerStrategy",
      "--validation_data=/data/val"], Mode.TRAINING),
    (["--distribution_strategy=ParameterServerStrategy"], Mode.EVALUATION),
])
def test_master_pod_matches_jax(flags, mode):
    jax_args, port_args = jargs.parse_master_args(JOB + flags), pargs.parse_master_args(JOB + flags)
    jsubmit.validate_cluster_args(jax_args, mode)
    psubmit.validate_cluster_args(port_args, mode)
    want = jsubmit.render_master_pod(jax_args, mode)
    got = psubmit.render_master_pod(port_args, mode)
    command = got["spec"]["containers"][0].pop("command")
    want_command = want["spec"]["containers"][0].pop("command")
    assert got == want
    assert command[:3] == ["python", "-m", "elasticdl_tpu_torch.master.main"]
    assert want_command[:3] == ["python", "-m", "elasticdl_tpu.master.main"]
    i = command.index("--device")
    assert command[i + 1] == "cuda"
    assert command[3:i] + command[i + 2:] == want_command[3:]


@pytest.mark.parametrize("flags,match", [
    (["--distribution_strategy=AllreduceStrategy", "--checkpoint_dir="], "checkpoint_dir"),
    (["--tpu_slice=v5e-16", "--num_workers=3"], "num_workers"),
    (["--tpu_slice=v5e-8", "--num_workers=2"], "need_elasticity"),
    (["--worker_resource_request=gpu"], "Malformed resource"),
    (["--volume=mount_path=/x"], "claim_name= or host_path="),
])
def test_submit_preflight_matches_jax(client, flags, match):
    argv = JOB + flags
    for args_mod, submit in ((jargs, jsubmit), (pargs, psubmit)):
        with pytest.raises(ValueError, match=match):
            submit.submit_job(args_mod.parse_master_args(argv), Mode.TRAINING, k8s_client=client)
    assert client.list_pods() == []


def test_submit_creates_the_master_pod(client, fake_k8s, monkeypatch, capsys):
    # The cluster flags parse (they used to be refused) and submit.
    args = pargs.parse_master_args(JOB + ["--worker_resource_request=nvidia.com/gpu=1",
                                          "--distribution_strategy=ParameterServerStrategy"])
    assert (args.image_name, args.volume) == ("elasticdl:test", VOLUME)
    assert psubmit.submit_job(args, Mode.TRAINING, k8s_client=client) == 0
    assert fake_k8s.pod_names() == ["elasticdl-subjob-master-0"]
    pod = client.get_pod("elasticdl-subjob-master-0")
    joined = " ".join(pod["spec"]["containers"][0]["command"])
    assert "--worker_resource_request nvidia.com/gpu=1" in joined
    assert "--job_type=training_only" in joined
    assert pod["spec"]["volumes"][0]["persistentVolumeClaim"]["claimName"] == "ckpt-pvc"
    # The CLI: ``train --image_name`` submits through K8sConfig.resolve's
    # explicit host, with no card needed on the client.
    monkeypatch.setenv("ELASTICDL_K8S_HOST", fake_k8s.host)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = [a.replace("subjob", "clijob") for a in JOB]
    assert client_main.main(["train", *argv, "--distribution_strategy=AllreduceStrategy"]) == 0
    assert "elasticdl-clijob-master-0" in fake_k8s.pod_names()
    assert "Job clijob submitted" in capsys.readouterr().out


def test_cluster_detection_and_capacity_probe(monkeypatch, tmp_path):
    from elasticdl_tpu.master import job_runner as jrunner

    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.delenv("ELASTICDL_K8S_HOST", raising=False)
    monkeypatch.delenv("ELASTICDL_CAPACITY_FILE", raising=False)
    args = pargs.parse_master_args(JOB)
    assert not job_runner._running_on_k8s(args) and not jrunner._running_on_k8s(args)
    monkeypatch.setenv("ELASTICDL_K8S_HOST", "http://127.0.0.1:1")
    assert job_runner._running_on_k8s(args) and jrunner._running_on_k8s(args)
    args.image_name = ""
    assert not job_runner._running_on_k8s(args)
    probes = [job_runner._K8sCapacityProbe(cooldown_s=0.05), jrunner._K8sCapacityProbe(0.05)]
    for probe in probes:
        assert probe(2) == 0  # inside the first cooldown
    time.sleep(0.06)
    assert [p(2) for p in probes] == [2, 2]
    for probe in probes:
        probe.failed()
        assert probe._cooldown_s == 0.1
        probe.succeeded()
        assert probe._cooldown_s == 0.05
    (tmp_path / "cap").write_text("1")
    monkeypatch.setenv("ELASTICDL_CAPACITY_FILE", str(tmp_path / "cap"))
    assert [p(3) for p in probes] == [1, 1]  # the explicit signal wins


# -- the client against the fake API server ------------------------------------


def test_client_crud_and_watch(client, fake_k8s):
    manifest = pk8s.render_pod(job_name="w", replica_type="worker", index=0, image="img",
                               command=["run"], namespace="testns", resources={"cpu": "2"})
    created = client.create_pod(manifest)
    name = created["metadata"]["name"]
    assert client.get_pod(name)["spec"]["containers"][0]["resources"]["requests"] == {"cpu": "2"}
    assert client.get_pod("nope") is None
    assert [p["metadata"]["name"] for p in client.list_pods(pk8s.job_label_selector("w"))] == [name]
    events = []
    for etype, pod in client.watch_pods(pk8s.job_label_selector("w"), timeout_s=5.0):
        events.append(etype)
        if etype == "ADDED":
            fake_k8s.fail_pod(name, exit_code=3)
        elif etype == "MODIFIED":
            assert pk8s.pod_exit_code(pod) == 3 and pk8s.pod_phase(pod) == "Failed"
            fake_k8s.delete_pod(name)
        elif etype == "DELETED":
            break
    assert events == ["ADDED", "MODIFIED", "DELETED"]
    assert not client.delete_pod(name)


def test_kubeconfig_parsing(tmp_path, monkeypatch):
    ca = tmp_path / "ca.pem"
    ca.write_text("CERT")
    cfg = tmp_path / "config"
    cfg.write_text(
        "apiVersion: v1\ncurrent-context: dev\nclusters:\n- name: c\n  cluster:\n"
        f"    server: https://10.1.2.3:6443\n    certificate-authority: {ca}\nusers:\n"
        "- name: u\n  user:\n    token: sekrit\ncontexts:\n- name: dev\n  context:\n"
        "    cluster: c\n    user: u\n    namespace: ml\n")
    got, want = pk8s.K8sConfig.from_kubeconfig(str(cfg)), jk8s.K8sConfig.from_kubeconfig(str(cfg))
    assert vars(got) == vars(want)
    assert (got.host, got.token, got.ca_file, got.namespace) == (
        "https://10.1.2.3:6443", "sekrit", str(ca), "ml")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("ELASTICDL_K8S_HOST", "10.0.0.1:443")
    monkeypatch.setenv("ELASTICDL_K8S_VERIFY", "0")
    resolved = pk8s.K8sConfig.resolve("other")
    assert vars(resolved) == vars(jk8s.K8sConfig.resolve("other"))
    assert (resolved.host, resolved.namespace, resolved.verify_tls) == (
        "https://10.0.0.1:443", "other", False)


# -- the pod manager ------------------------------------------------------------


def test_pod_manager_completion_churn_and_preemption(client, fake_k8s):
    manager, tasks = _manager(client, n=2)
    manager.start()
    try:
        _wait_for(lambda: fake_k8s.pod_names() == [pk8s.pod_name("testjob", "worker", i)
                                                   for i in (0, 1)], msg="world 1")
        pod = client.get_pod(pk8s.pod_name("testjob", "worker", 0))
        assert {e["name"] for e in pod["spec"]["containers"][0]["env"]} == {"MY_POD_IP"}
        fake_k8s.fail_pod(pk8s.pod_name("testjob", "worker", 0), exit_code=1)
        _wait_for(lambda: sorted(manager.current_worker_ids()) == [2, 3], msg="world 2")
        assert sorted(tasks.recovered) == [0, 1]
        assert pk8s.pod_name("testjob", "worker", 1) not in fake_k8s.pod_names()
        # A pod deleted under the manager (preemption) is churn too.
        fake_k8s.delete_pod(pk8s.pod_name("testjob", "worker", 3))
        _wait_for(lambda: sorted(manager.current_worker_ids()) == [4, 5], msg="world 3")
        fake_k8s.succeed_all()
        assert manager.wait(timeout=15)
        assert manager.restarts_used == 2
    finally:
        manager.stop()


def test_pod_manager_budget_then_two_phase_scale_up(client, fake_k8s):
    capacity = {"slots": 0}
    manager, tasks = _manager(client, n=2, max_restarts=0,
                              scale_up_check_fn=lambda needed: min(needed, capacity["slots"]))
    manager.start()
    try:
        _wait_for(lambda: len(fake_k8s.pod_names()) == 2, msg="world 1")
        fake_k8s.fail_pod(pk8s.pod_name("testjob", "worker", 0))
        _wait_for(lambda: manager.current_worker_ids() == [2], msg="shrunk world")
        capacity["slots"] = 1
        # The probe pod (id 3) runs, then the world re-forms at ids 4, 5.
        _wait_for(lambda: sorted(manager.current_worker_ids()) == [4, 5], msg="regrown")
        assert 2 in tasks.recovered
        assert pk8s.pod_name("testjob", "worker", 3) not in fake_k8s.pod_names()
        fake_k8s.succeed_all()
        assert manager.wait(timeout=15)
    finally:
        manager.stop()


def test_pod_manager_sweeps_leftovers_and_resyncs(client, fake_k8s):
    client.create_pod(pk8s.render_pod(job_name="testjob", replica_type="worker", index=0,
                                      image="old", command=["run"], namespace="testns"))
    manager, _ = _manager(client, n=1)
    manager._sweep_leftover_pods()
    assert fake_k8s.pod_names() == []
    handles = manager._substrate_launch([0])
    manager._handles = handles
    manager._resync()
    assert manager._substrate_poll(handles[0]) is None
    assert client.get_pod(handles[0].name)["spec"]["containers"][0]["image"] == "elasticdl:test"
    fake_k8s.delete_pod(handles[0].name)  # vanishes while no watch runs
    manager._resync()
    assert manager._substrate_poll(handles[0]) == PREEMPTED_EXIT_CODE
    assert manager._resource_version


@pytest.mark.parametrize("event_log_cap", [0, 1], ids=["resume-from-rv", "410-re-list"])
def test_pod_manager_survives_watch_stream_chaos(event_log_cap):
    server = FakeK8sApiServer(watch_max_events=1).start()
    if event_log_cap:
        server.event_log_cap = event_log_cap
    try:
        chaos = pk8s.K8sClient(pk8s.K8sConfig(host=server.host, namespace="testns"))
        manager, tasks = _manager(chaos, n=2)
        manager.start()
        try:
            _wait_for(lambda: len(server.pod_names()) == 2, msg="world 1")
            server.fail_pod(pk8s.pod_name("testjob", "worker", 0))
            _wait_for(lambda: sorted(manager.current_worker_ids()) == [2, 3], timeout=30,
                      msg="re-formed world despite dropping watches")
            assert sorted(tasks.recovered) == [0, 1]
            server.succeed_all()
            assert manager.wait(timeout=15)
        finally:
            manager.stop()
    finally:
        server.stop()


def test_tpu_slice_and_gpu_worker_pods(client, fake_k8s):
    manager, _ = _manager(client, n=2, tpu_slice="v5e-8", worker_resources={"memory": "100Gi"})
    manager._substrate_launch([0])
    (pod,) = client.list_pods(pk8s.job_label_selector("testjob", "worker"))
    assert pod["spec"]["containers"][0]["resources"]["requests"] == {
        "memory": "100Gi", "google.com/tpu": "4"}
    assert pod["spec"]["nodeSelector"]["cloud.google.com/gke-tpu-topology"] == "2x4"
    with pytest.raises(ValueError, match="2 host"):
        _manager(client, n=3, tpu_slice="v5e-8")
    gpu, _ = _manager(client, n=1, worker_resources=pk8s.parse_resource_spec("nvidia.com/gpu=1"))
    gpu._substrate_launch([7])
    pod = client.get_pod(pk8s.pod_name("testjob", "worker", 7))
    assert pod["spec"]["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert "nodeSelector" not in pod["spec"]
