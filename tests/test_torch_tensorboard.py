"""The port's TensorBoard scalar service
(``elasticdl_tpu_torch/master/tensorboard_service.py``) and its stdlib
event-file writer: CRC-32C on the standard vector, TFRecord framing that
the port's reader checks record by record, and event files that
``tensorboard``'s own ``EventAccumulator`` reads back with the same tags,
steps and values as the JAX package's ``TensorBoardService`` (through
``torch.utils.tensorboard``) for the same calls.  A CPU job with
``--tensorboard_log_dir`` writes one ``eval/*`` scalar set per finalized
evaluation round at the round's model version, and the ``train/*``
progress scalars."""

import pytest

from elasticdl_tpu.master.tensorboard_service import TensorBoardService as JaxService
from elasticdl_tpu_torch.master import tensorboard_service as port_tb

from torch_obs_job import events, job_log, observed_job


def test_crc32c_standard_vector():
    assert port_tb.crc32c(b"123456789") == 0xE3069283
    assert port_tb.crc32c(b"") == 0
    # TFRecord's mask, checked against tensorboard's own implementation.
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3):
        assert port_tb.masked_crc32c(data) == masked_crc32c(data)


def test_event_roundtrip_and_crc_check(tmp_path):
    writer = port_tb.EventFileWriter(str(tmp_path))
    writer.add_scalar("eval/auc", 0.75, 48)
    writer.add_scalar("train/epoch", 2, 0)
    writer.add_scalar("neg", -1.5, -3)
    writer.close()
    name = writer.path.rsplit("/", 1)[1]
    prefix, _, rest = name.partition("events.out.tfevents.")
    secs, host_pid_seq = rest.split(".", 1)
    assert prefix == "" and secs.isdigit() and host_pid_seq.split(".")[-2].isdigit()
    got = port_tb.read_events(writer.path)
    assert got[0]["file_version"] == "brain.Event:2"
    assert [(e["step"], e["scalars"]) for e in got[1:]] == [
        (48, {"eval/auc": 0.75}), (0, {"train/epoch": 2.0}), (-3, {"neg": -1.5})]
    data = bytearray(open(writer.path, "rb").read())
    data[-6] ^= 0xFF  # a payload byte of the last record
    open(writer.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        port_tb.read_events(writer.path)


class _Tasks:
    finished_record_count = 4096

    def counts(self):
        return {"todo": 3, "epoch": 1}

    def exec_counters(self):
        return {"oov_lookup_count": 7}


def _drive(service):
    service.bind(model_version_fn=lambda: 48, restarts_fn=lambda: 1)
    service.write_dict_to_summary({"auc": 0.6875, "accuracy": 0.5}, 24)
    service.write_dict_to_summary({"auc": 0.75, "accuracy": 0.625}, 48)
    service.write_scalar("train/custom", 3.25, 12)
    service.close()  # the final progress sample


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_event_files_read_by_tensorboard_as_jax_writes_them(tmp_path):
    _drive(JaxService(str(tmp_path / "jax"), task_manager=_Tasks()))
    _drive(port_tb.TensorBoardService(str(tmp_path / "port"), task_manager=_Tasks()))
    jax, port = _scalars(tmp_path / "jax"), _scalars(tmp_path / "port")
    assert port == jax
    assert port["eval/auc"] == [(24, 0.6875), (48, 0.75)]
    assert port["train/records_finished"] == [(48, 4096.0)]
    assert port["train/worker_restarts"] == [(48, 1.0)]


def test_job_writes_eval_rounds_and_train_scalars(tmp_path_factory):
    root = observed_job(tmp_path_factory)
    assert (root / "rc").read_text() == "0", job_log(root)
    (event_file,) = sorted((root / "tb").glob("events.out.tfevents.*"))
    records = port_tb.read_events(str(event_file))  # every record's CRC checked
    scalars = {}
    for record in records:
        for tag, value in record["scalars"].items():
            scalars.setdefault(tag, []).append((record["step"], value))
    rounds = [e for e in events(root / "tb" / "events.jsonl")
              if e["event"] == "evaluation_metrics"]
    assert rounds
    for name in rounds[0]["metrics"]:
        assert scalars[f"eval/{name}"] == [
            (e["model_version"], pytest.approx(e["metrics"][name], rel=1e-6)) for e in rounds]
    for tag in ("train/records_finished", "train/tasks_todo", "train/epoch",
                "train/model_version", "train/worker_restarts"):
        assert tag in scalars, sorted(scalars)
    assert scalars["train/records_finished"][-1][1] == 512
    assert _scalars(root / "tb")["eval/auc"] == [
        (e["model_version"], pytest.approx(e["metrics"]["auc"], rel=1e-6)) for e in rounds]
