"""The port's tar-shard input (``data/webdata.py``) and the trainer's tar
branch against the JAX package on the CPU.

Shards are written here (``testing.write_tar_shards``: PNG and JPEG
members, one JPEG cut short, whose header reads and whose pixels do
not). On the same shards, tokenizer and seed, the port's
``TarImageTextDataset`` and ``TarLoader`` give JAX's samples in JAX's
order, tokens and pixel arrays bitwise (JAX's dataset as its trainer
builds it for one process: no shuffle buffer, seed 0), with member names
picked and through ``pipe:cat`` specs. The port's ``SHARD_RETRY`` is
JAX's; both are cut to two attempts without backoff here. The counters of JAX's ``tests/test_resilience.py``
``TestShardResilience`` cases (an open retried, a dead shard quarantined
and skipped without new attempts, a sample that does not decode, a shard
aborted mid-read) equal JAX's, the faults armed alike on the port's
``FaultRegistry`` and JAX's process-wide ``FAULTS``; JAX's counters and
``FAULTS`` are reset around every test.

The trainer: ``--wds`` with other than two member names exits before any
file; a run on a ``.tar`` spec trains, logs the loader's counters, and a
run preempted mid-epoch is relaunched by replaying that epoch from its
start (the log says so), its dispatched captions those of the epoch's
batches in order.
"""

import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.data import webdata as j_webdata
from dalle_pytorch_tpu.data.tokenizers import SimpleTokenizer as JTokenizer
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu.utils.metrics import counters as j_counters
from dalle_pytorch_tpu.utils.resilience import RetryPolicy as JRetryPolicy
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.data import webdata
from dalle_pytorch_tpu_torch.data.tokenizers import SimpleTokenizer
from dalle_pytorch_tpu_torch.models.factory import save_vae_checkpoint
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.testing import write_tar_shards
from dalle_pytorch_tpu_torch.utils.faults import FaultRegistry
from dalle_pytorch_tpu_torch.utils.metrics import Counters
from dalle_pytorch_tpu_torch.utils.resilience import RetryPolicy

torch.set_num_threads(2)

SHARD_RETRY = webdata.SHARD_RETRY  # before the fixture below cuts it for each test
NAMES = ("webdata.shard_open_retries", "webdata.shards_opened", "webdata.shards_quarantined",
         "webdata.quarantined_skips", "webdata.decode_errors", "webdata.shard_aborts")


@pytest.fixture(autouse=True)
def clean_jax_registries(monkeypatch):
    monkeypatch.setattr(webdata, "SHARD_RETRY", RetryPolicy(attempts=2, base_delay=0.0))
    FAULTS.reset()
    j_counters.reset()
    yield
    FAULTS.reset()
    j_counters.reset()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    spec, captions = write_tar_shards(root, 3, 5, 24, seed=2, corrupt=(3,))
    return spec, captions


@pytest.fixture(scope="module")
def toks():
    return JTokenizer(), SimpleTokenizer()


def _pair(spec, toks, faults=None, **kw):
    jtok, tok = toks
    common = dict(text_len=16, image_size=16, truncate_captions=True, **kw)
    jds = j_webdata.TarImageTextDataset(
        spec, tokenizer=jtok, retry_policy=JRetryPolicy(attempts=2, base_delay=0.0), **common)
    ds = webdata.TarImageTextDataset(spec, tokenizer=tok, counters=Counters(), faults=faults,
                                     **common)
    return jds, ds


def _same_samples(a, b):
    assert len(a) == len(b)
    for (ta, ia), (tb, ib) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        assert ia.dtype == ib.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)


def _counts(ds):
    return ({n: j_counters.get(n) for n in NAMES}, {n: ds.counters.get(n) for n in NAMES})


def test_expand_urls_matches_jax():
    for spec in ("a.tar", "s-{0000..0003}.tar", "x{8..11}/y{01..02}.tar", "pipe:cat s-{0..2}"):
        assert webdata.expand_urls(spec) == j_webdata.expand_urls(spec)


def test_shard_retry_is_jax():
    jax_policy = j_webdata.SHARD_RETRY
    for name in ("attempts", "base_delay", "max_delay", "jitter", "retry_on"):
        assert getattr(SHARD_RETRY, name) == getattr(jax_policy, name), name


# (kwargs, samples an epoch, decode errors in two epochs): 15 samples, 8
# PNGs and 7 JPEGs of which one is cut short
@pytest.mark.parametrize("kw,n,errors", [
    ({}, 14, 2), ({"image_key": "jpg", "caption_key": "txt"}, 6, 2),
    ({"image_key": "png", "caption_key": "txt"}, 8, 0),
    ({"resize_ratio": 0.5}, 14, 2), ({"resize_ratio": 1.0}, 14, 2),
], ids=["plain", "jpg_only", "png_only", "ratio_half", "ratio_whole"])
def test_samples_bitwise_jax(shards, toks, kw, n, errors):
    spec, _ = shards
    jds, ds = _pair(spec, toks, **kw)
    a, b = list(jds), list(ds)
    _same_samples(a, b)
    assert len(b) == n
    _same_samples(list(jds), list(ds))  # a second epoch continues both streams alike
    c = _counts(ds)
    assert c[0] == c[1] and ds.counters.get("webdata.decode_errors") == errors


def test_loader_batches_bitwise_jax(shards, toks):
    spec, _ = shards
    jds, ds = _pair(spec, toks)
    a, b = list(j_webdata.TarLoader(jds, 4)), list(webdata.TarLoader(ds, 4))
    assert len(a) == len(b) == 3  # 14 samples, the last 2 dropped
    for x, y in zip(a, b):
        assert x["text"].dtype == y["text"].dtype == np.int32
        np.testing.assert_array_equal(x["text"], y["text"])
        np.testing.assert_array_equal(x["image"], y["image"])
    assert not hasattr(webdata.TarLoader(ds, 4), "epoch")


def test_pipe_cat_specs_bitwise_jax(shards, toks):
    spec, _ = shards
    pipe = f"pipe:cat {spec}"
    jds, ds = _pair(pipe, toks)
    _same_samples(list(jds), list(ds))
    _, plain = _pair(spec, toks)
    _same_samples(list(plain), list(webdata.TarImageTextDataset(
        pipe, text_len=16, image_size=16, truncate_captions=True, tokenizer=toks[1])))


def test_transient_open_retries_then_streams(shards, toks):
    spec = shards[0].replace("{0000..0002}", "0000")
    faults = FaultRegistry()
    jds, ds = _pair(spec, toks, faults=faults)
    FAULTS.arm("shard_open", 1)
    faults.arm("shard_open", 1)
    _same_samples(list(jds), list(ds))
    c = _counts(ds)
    assert c[0] == c[1] and c[1]["webdata.shard_open_retries"] == 1
    assert c[1]["webdata.shards_quarantined"] == 0 and faults.fired == {"shard_open": 1}


def test_dead_shard_quarantined_and_not_rehammered(shards, toks):
    spec = shards[0].replace("{0000..0002}", "{0000..0001}")
    faults = FaultRegistry()
    jds, ds = _pair(spec, toks, faults=faults)
    FAULTS.arm("shard_open", 2)  # every attempt at the first shard
    faults.arm("shard_open", 2)
    _same_samples(list(jds), list(ds))
    _same_samples(list(jds), list(ds))  # the quarantined shard skipped without an attempt
    c = _counts(ds)
    assert c[0] == c[1]
    assert (c[1]["webdata.shards_quarantined"], c[1]["webdata.quarantined_skips"],
            c[1]["webdata.shard_open_retries"]) == (1, 1, 1)


def test_decode_errors_are_counted(shards, toks):
    spec = shards[0].replace("{0000..0002}", "0000")  # holds the cut JPEG
    jds, ds = _pair(spec, toks)
    a, b = list(jds), list(ds)
    _same_samples(a, b)
    assert len(b) == 4
    c = _counts(ds)
    assert c[0] == c[1] and c[1]["webdata.decode_errors"] == 1


def test_midshard_fault_aborts_shard_but_keeps_stream(shards, toks):
    spec = shards[0].replace("{0000..0002}", "{0001..0002}")
    faults = FaultRegistry()
    jds, ds = _pair(spec, toks, faults=faults)
    FAULTS.arm("shard_read", 1)
    faults.arm("shard_read", 1)
    a, b = list(jds), list(ds)
    _same_samples(a, b)
    assert len(b) == 5  # the first shard aborted at its first sample, the second whole
    c = _counts(ds)
    assert c[0] == c[1] and c[1]["webdata.shard_aborts"] == 1


def test_registry_and_env_know_the_shard_sites():
    faults = FaultRegistry.from_env({"DALLE_TPU_FAULTS": "shard_open=2,shard_read=1"})
    with pytest.raises(OSError, match="x"):
        faults.maybe_raise("shard_open", OSError("x"))
    assert faults.take("shard_read") and not faults.take("shard_read")
    assert faults.fired == {"shard_open": 1, "shard_read": 1}


# ------------------------------------------------------------- the trainer


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """(shard spec of 3 shards x 5 samples, one cut short; VAE checkpoint)."""
    root = tmp_path_factory.mktemp("tar_cli")
    spec, _ = write_tar_shards(root / "data", 3, 5, 32, seed=9, corrupt=(7,))
    vae = DiscreteVAE(image_size=32, num_layers=2, hidden_dim=16, num_tokens=40,
                      codebook_dim=8, device="cpu").init_weights(torch.Generator().manual_seed(4))
    save_vae_checkpoint(root / "vae.ckpt", vae)
    return spec, root / "vae.ckpt"


def _argv(inputs, *extra):
    spec, vae = inputs
    return ["--image_text_folder", spec, "--vae_path", str(vae), "--dim", "64", "--depth", "2",
            "--heads", "2", "--dim_head", "32", "--text_seq_len", "16", "--truncate_captions",
            *extra]


def test_wds_wants_two_column_names(cli_inputs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="--wds wants 2 comma-separated column names"):
        train_dalle.main(_argv(cli_inputs, "--wds", "png,txt,json"), device="cpu")
    assert list(tmp_path.iterdir()) == []


DISPATCH = train_dalle.DalleTrainer.dispatch


def test_tar_run_and_its_resume_replays_the_partial_epoch(cli_inputs, tmp_path, monkeypatch,
                                                         capsys):
    """14 good samples, batch 4: three batches an epoch. Two epochs run
    clean; a run preempted at its second dispatch is relaunched and
    replays epoch 0 from its start: its batches are the clean run's epoch
    0 and then epoch 1 (a tar stream's epochs differ: the crop rng runs
    on)."""
    monkeypatch.chdir(tmp_path)
    argv = _argv(cli_inputs, "--wds", "--epochs", "2")
    record = []

    def recording(self, text, image_tokens):
        record.append(text.numpy().copy())
        return DISPATCH(self, text, image_tokens)

    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", recording)
    train_dalle.main([*argv, "--dalle_output_file_name", "clean"], device="cpu")
    out = capsys.readouterr().out
    assert len(record) == 6 and "step 0: webdata.shards_opened=" in out, out
    clean, record[:] = list(record), []

    def preempting(self, text, image_tokens):
        record.append(text.numpy().copy())
        if len(record) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return DISPATCH(self, text, image_tokens)

    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", preempting)
    with pytest.raises(SystemExit) as exit_:
        train_dalle.main([*argv, "--dalle_output_file_name", "pre"], device="cpu")
    assert exit_.value.code == 0
    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", recording)
    record[:] = []
    train_dalle.main([*argv, "--dalle_output_file_name", "pre"], device="cpu")
    out = capsys.readouterr().out
    assert "resuming from pre-cp step 2 (epoch 0, iter 1)" in out, out
    assert ("tar-stream loader has no reproducible epoch order: replaying epoch 0 from its "
            "start (up to 2 batches re-seen)") in out, out
    assert len(record) == 6
    for a, b in zip(record, clean):
        np.testing.assert_array_equal(a, b)
    assert Path("pre.ckpt").exists() and not Path("pre.ckpt.tmp").exists()
