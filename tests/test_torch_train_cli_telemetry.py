"""The port's trainer command line with ``--telemetry`` against the
repository's ``train_dalle.py`` with the same flags, on the CPU (the
tiny model and the JAX VAE file of test_torch_train_cli.py, 8 PNGs of 32
px, batch 4: two steps):

- the flight file validates, holds two closed ``train.step`` spans (from
  dispatch to verdict, with the loss and its finiteness), and its
  records name for name, count for count, are those JAX's trainer
  records; ``train.step_s`` counts two steps;
- ``/metrics`` (``--metrics_port 0``: a free port) serves the
  ``train.step_s`` histogram on 127.0.0.1;
- the losses are bitwise those of the same run without telemetry;
- ``--nan_abort_after 1`` with a NaN at step 0 records ``train.nan_skip``
  and ``train.nan_abort`` and drains the flight file before the
  emergency save and the exit;
- a SIGTERM during a step records ``train.preempt_signal`` and drains
  inside the signal's handler, before the emergency save."""

import json
import os
import signal
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.models.factory import save_vae_checkpoint as j_save_vae
from dalle_pytorch_tpu.utils.telemetry import TELEMETRY as JTELEMETRY
from dalle_pytorch_tpu.utils.telemetry import validate_flight_file as j_validate
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.testing import reset_registries, write_caption_folder
from dalle_pytorch_tpu_torch.utils import telemetry_names
from dalle_pytorch_tpu_torch.utils.metrics import histograms
from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY, validate_flight_file
from test_torch_train_cli import MODEL_FLAGS, VAE_CONFIG, _run_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    work = tmp_path_factory.mktemp("tele")
    write_caption_folder(work / "data", 8, 32, seed=3)
    vae = JVAE(**VAE_CONFIG)
    params = vae.init({"params": jax.random.key(1), "gumbel": jax.random.key(2)},
                      jnp.zeros((1, 32, 32, 3)))["params"]
    j_save_vae(str(work / "vae.ckpt"), vae, jax.device_get(params))
    return work


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


def argv(data, name, *extra):
    return ["--image_text_folder", str(data / "data"), "--vae_path", str(data / "vae.ckpt"),
            *MODEL_FLAGS, "--epochs", "1", "--batch_size", "4",
            "--random_resize_crop_lower_ratio", "1.0", "--dalle_output_file_name",
            str(data / name), *extra]


def run_port(args, monkeypatch):
    losses = []
    verdict = train_dalle.DalleTrainer.verdict

    def recording(self, loss):
        losses.append(float(loss))
        return verdict(self, loss)

    monkeypatch.setattr(train_dalle.DalleTrainer, "verdict", recording)
    train_dalle.main(args, device="cpu")
    monkeypatch.undo()
    return losses


def test_spans_flight_file_and_metrics_equal_jax(data, monkeypatch):
    plain = run_port(argv(data, "plain"), monkeypatch)
    reset_registries()
    tele = run_port(argv(data, "tele", "--telemetry", "--telemetry_dir", str(data / "fl"),
                         "--metrics_port", "0"), monkeypatch)
    assert tele == plain and len(tele) == 2  # bitwise
    port = TELEMETRY._server.server_address[1]
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert 'train_step_s_bucket{le="+Inf"} 2' in body and "train_step_s_count 2" in body
    assert histograms.get("train.step_s").count == 2
    ours = validate_flight_file(TELEMETRY.drain("test"))
    assert ours["unclosed"] == [] and ours["by_name"]["train.step"] == 4
    steps = [r for r in flight_records(data / "fl") if r.get("name") == "train.step"]
    assert [r["step"] for r in steps if r["ph"] == "B"] == [0, 1]
    assert [(r["loss"], r["finite"]) for r in steps if r["ph"] == "E"] == [(x, True) for x in tele]

    _run_jax(pytest.MonkeyPatch(), argv(data, "jax", "--telemetry", "--telemetry_dir",
                                        str(data / "jfl")), [])
    theirs = j_validate(JTELEMETRY.drain("test"))
    assert ours["by_name"] == theirs["by_name"]
    assert {"train.step", "train.data_wait", "train.ckpt_save"} <= set(ours["by_name"])
    for name in set(ours["by_name"]) - {"telemetry.drain"}:
        assert telemetry_names.is_registered(name, "span"), name
    assert telemetry_names.is_registered("train.step_s", "histogram")


def flight_records(directory):
    for f in sorted(directory.glob("flight-*.jsonl")):
        yield from (json.loads(line) for line in f.read_text().splitlines())


def test_nan_abort_drains_before_the_save(data, monkeypatch):
    monkeypatch.setenv("DALLE_TPU_FAULTS", "nan_at_step=0")
    monkeypatch.chdir(data)
    with pytest.raises(SystemExit, match="consecutive non-finite"):
        train_dalle.main(argv(data, "nan", "--telemetry", "--telemetry_dir", str(data / "nfl"),
                              "--nan_abort_after", "1"), device="cpu")
    recs = list(flight_records(data / "nfl"))
    names = [r.get("name") for r in recs]
    assert "train.nan_skip" in names and "train.nan_abort" in names
    assert all(telemetry_names.is_registered(n, "event") for n in ("train.nan_skip",
                                                                     "train.nan_abort"))
    drain = next(r for r in recs if r.get("name") == "telemetry.drain")
    assert drain["reason"] == "nan_abort"
    # the emergency save's span comes after the drain, still in the ring
    assert any(r.get("name") == "train.ckpt_save" and r.get("emergency")
               for r in TELEMETRY.records())


def test_preemption_signal_drains_in_the_handler(data, monkeypatch):
    dispatch = train_dalle.DalleTrainer.dispatch

    def signalled(self, *a, **k):
        out = dispatch(self, *a, **k)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", signalled)
    with pytest.raises(SystemExit) as exc:
        train_dalle.main(argv(data, "pre", "--telemetry", "--telemetry_dir", str(data / "pfl")),
                         device="cpu")
    assert exc.value.code == 0
    recs = list(flight_records(data / "pfl"))
    sig = [r for r in recs if r.get("name") == "train.preempt_signal"]
    assert len(sig) == 1 and sig[0]["signum"] == signal.SIGTERM and sig[0]["step"] == 0
    assert telemetry_names.is_registered("train.preempt_signal", "event")
    assert recs[-1]["name"] == "telemetry.drain" and recs[-1]["reason"] == "preempt_signal"
    # the step in flight was open when the handler drained
    assert validate_flight_file(str(next((data / "pfl").glob("flight-*.jsonl"))))["unclosed"]
