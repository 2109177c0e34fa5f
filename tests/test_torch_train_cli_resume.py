"""Preemption, resume and refusals of the port's trainer command line, on
the CPU (the port alone).

- Preemption runs as ``tests/test_e2e.py``'s preemption test runs JAX's
  command line: a subprocess, SIGTERM once it prints ``step 0: loss``,
  exit 0 with an emergency step directory; a relaunch of the same command
  prints ``resuming from <dir> step N`` with ``DALLE_TPU_FAULTS=
  nan_at_step=N+1``, so the step after the resume point is rejected and
  its batch retried. The relaunch's final params and Adam moments are
  bitwise those of an uninterrupted run of the same command. The folder
  is built for that: the dataset draws captions and crops from one
  ``random.Random(seed)`` that a relaunch does not restore (JAX's too,
  ``data/loader.py:94``); only the batch order is reproducible across a
  resume. So this case's samples do not depend on that stream: one
  caption per image, square PNGs at ``image_size`` and
  ``--random_resize_crop_lower_ratio 1.0``.
- A second case keeps the default crops (ratio 0.75) and checks the same
  batches in the same order (the captions, one per image, name them), not
  the same bits: the preempted run's dispatches followed by the
  relaunch's are the uninterrupted run's.
- ``--nan_abort_after`` aborts with an emergency step directory.
- Every refused flag raises ``NotImplementedError`` naming its ROADMAP.md
  queue item, before any file is written. The pretrained VAEs' flags
  (``--taming``, the VQGAN and OpenAI dVAE paths) are taken: a weight
  file they leave out or name but do not hold is refused with
  ``MissingWeights`` naming its flag, before any file is written; so is
  training without a VAE (the OpenAI dVAE, JAX's default). Tar shards and the HugTokenizer / YttmTokenizer
  ``--bpe_path`` files are read (``tests/test_torch_webdata.py``,
  ``tests/test_torch_hug_tokenizer.py``).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.models.factory import restore_opt_state, save_vae_checkpoint
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.testing import write_caption_folder
from dalle_pytorch_tpu_torch.utils.checkpoint import (
    latest_verified_step,
    load_checkpoint,
    verify_step_dir,
)

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)
RUN = ("import sys, torch; torch.set_num_threads(2); "
       "from dalle_pytorch_tpu_torch.train_dalle import main; main(sys.argv[1:], device='cpu')")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """(data folder, VAE checkpoint): 8 square 32 px PNGs, one caption
    each, and a seeded port DiscreteVAE."""
    root = tmp_path_factory.mktemp("resume")
    write_caption_folder(root / "data", 8, 32, seed=5)
    vae = DiscreteVAE(image_size=32, num_layers=2, hidden_dim=16, num_tokens=40,
                      codebook_dim=8, device="cpu").init_weights(torch.Generator().manual_seed(4))
    save_vae_checkpoint(root / "vae.ckpt", vae)
    return root / "data", root / "vae.ckpt"


def _argv(folder, name="dalle", ratio="1.0", epochs="4"):
    data, vae = folder
    return ["--image_text_folder", str(data), "--vae_path", str(vae), "--dim", "64",
            "--depth", "2", "--heads", "2", "--dim_head", "32", "--text_seq_len", "16",
            "--truncate_captions", "--epochs", epochs, "--dalle_output_file_name", name,
            "--random_resize_crop_lower_ratio", ratio]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "DALLE_TPU_FAULTS"}
    return {**env, "PYTHONPATH": str(REPO), **extra}


def _final(path):
    """(params, mu, nu, count) of a plain DALLE checkpoint."""
    state, _ = load_checkpoint(path)
    adam = restore_opt_state(path, device="cpu", loaded=(state, {"has_opt_state": True}))
    return state["params"], adam


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def test_preempted_and_relaunched_run_ends_bitwise_an_uninterrupted_one(folder, tmp_path):
    argv = _argv(folder)
    clean_dir, pre_dir = tmp_path / "clean", tmp_path / "pre"
    clean_dir.mkdir()
    pre_dir.mkdir()
    clean = subprocess.run([sys.executable, "-c", RUN, *argv], cwd=clean_dir, env=_env(),
                           capture_output=True, text=True, timeout=240)
    assert clean.returncode == 0, clean.stdout + clean.stderr

    proc = subprocess.Popen([sys.executable, "-c", RUN, *argv], cwd=pre_dir, env=_env(),
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("step 0: loss"):
                proc.send_signal(signal.SIGTERM)
                break
        tail, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    transcript = "".join(seen) + tail
    assert proc.returncode == 0, transcript
    assert "emergency checkpoint" in tail, transcript
    step = latest_verified_step(pre_dir / "dalle-cp")
    assert step is not None and step >= 1, transcript
    assert verify_step_dir(pre_dir / "dalle-cp" / f"step_{step:08d}") == (True, "ok")

    relaunch = subprocess.run([sys.executable, "-c", RUN, *argv], cwd=pre_dir,
                              env=_env(DALLE_TPU_FAULTS=f"nan_at_step={step + 1}"),
                              capture_output=True, text=True, timeout=240)
    assert relaunch.returncode == 0, relaunch.stdout + relaunch.stderr
    assert f"resuming from dalle-cp step {step}" in relaunch.stdout, relaunch.stdout
    assert ("non-finite loss — update skipped on device, retrying batch (1/"
            in relaunch.stdout), relaunch.stdout

    params, adam = _final(clean_dir / "dalle.ckpt")
    params_r, adam_r = _final(pre_dir / "dalle.ckpt")
    assert _bitwise(params, params_r)
    assert _bitwise(adam.mu, adam_r.mu) and _bitwise(adam.nu, adam_r.nu)
    assert int(adam.count) == int(adam_r.count) == 8
    _, meta = load_checkpoint(pre_dir / "dalle.ckpt")
    assert meta["epoch"] == 3


DISPATCH = train_dalle.DalleTrainer.dispatch


def _record_batches(monkeypatch, record):
    def recording(self, text, image_tokens):
        record.append(text.numpy().copy())
        return DISPATCH(self, text, image_tokens)

    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", recording)


def test_resume_with_default_crops_replays_the_same_batches(folder, tmp_path, monkeypatch):
    """SIGTERM in the second step of epoch 1 (the in-process handler),
    then a relaunch: the dispatched captions, in order, are the
    uninterrupted run's."""
    argv = _argv(folder, ratio="0.75", epochs="3")
    monkeypatch.chdir(tmp_path)
    clean = []
    _record_batches(monkeypatch, clean)
    train_dalle.main([*argv, "--dalle_output_file_name", "clean"], device="cpu")
    assert len(clean) == 6

    interrupted = []

    def preempting(self, text, image_tokens):
        interrupted.append(text.numpy().copy())
        if len(interrupted) == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return DISPATCH(self, text, image_tokens)

    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", preempting)
    with pytest.raises(SystemExit) as exit_:
        train_dalle.main([*argv, "--dalle_output_file_name", "pre"], device="cpu")
    assert exit_.value.code == 0 and latest_verified_step("pre-cp") == 4
    resumed = []
    _record_batches(monkeypatch, resumed)
    train_dalle.main([*argv, "--dalle_output_file_name", "pre"], device="cpu")
    assert len(interrupted) + len(resumed) == len(clean)
    for a, b in zip(interrupted + resumed, clean):
        np.testing.assert_array_equal(a, b)


def test_nan_abort_writes_an_emergency_step_directory(folder, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DALLE_TPU_FAULTS", "nan_at_step=1")
    with pytest.raises(SystemExit, match="1 consecutive non-finite steps"):
        train_dalle.main([*_argv(folder), "--nan_abort_after", "1"], device="cpu")
    step = latest_verified_step("dalle-cp")
    assert step == 2  # the rejected dispatch counts
    manifest = json.loads((Path("dalle-cp") / f"step_{step:08d}" / "MANIFEST.json").read_text())
    assert manifest["meta"]["emergency"] is True and manifest["meta"]["iter"] == 0
    assert manifest["meta"]["epoch"] == 0


def _non_default(action: argparse.Action):
    opt = action.option_strings[-1]
    if isinstance(action, argparse._StoreTrueAction):
        return [opt]
    if action.nargs == "?":
        return [opt, "img,cap"]
    return [opt, {int: "3", float: "0.3"}.get(action.type, "x")]


REFUSED = {a.dest: _non_default(a) for a in train_dalle.build_parser()._actions
           if a.dest in train_dalle.NOT_PORTED}
# the pretrained VAEs' flags, taken since they were ported: each one's
# arguments (``THERE`` an existing file) and the flag the refusal names
THERE = __file__
PRETRAINED = {
    "taming": (["--taming"], "--vqgan_config_path"),
    "vqgan_config_path": (["--taming", "--vqgan_config_path", "x"], "--vqgan_config_path"),
    "vqgan_model_path": (["--taming", "--vqgan_model_path", "x", "--vqgan_config_path", THERE],
                         "--vqgan_model_path"),
    "openai_enc_path": (["--openai_enc_path", "x"], "--openai_enc_path"),
    "openai_dec_path": (["--openai_dec_path", "x", "--openai_enc_path", THERE],
                        "--openai_dec_path"),
}


@pytest.mark.parametrize("flag", sorted({**REFUSED, **PRETRAINED}))
def test_refused_flag_raises_before_any_file(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if flag in PRETRAINED:
        from dalle_pytorch_tpu_torch.models.pretrained import MissingWeights

        assert flag not in train_dalle.NOT_PORTED and flag in train_dalle.CLI_FLAGS
        extra, named = PRETRAINED[flag]
        with pytest.raises(MissingWeights, match=f"{named}.*never downloaded"):
            train_dalle.main(["--image_text_folder", "data", *extra], device="cpu")
    else:
        argv = ["--image_text_folder", "data", "--vae_path", "missing.ckpt", *REFUSED[flag]]
        with pytest.raises(NotImplementedError,
                           match=f"--{flag} .*ROADMAP.md (queue|not queued)"):
            train_dalle.main(argv, device="cpu")
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("argv,match", [
    (["--image_text_folder", "data"], "OpenAI dVAE"),
])
def test_refused_inputs_raise_before_any_file(argv, match, tmp_path, monkeypatch):
    """Without a VAE the trainer takes JAX's default, the OpenAI dVAE,
    whose files it must be given (JAX would download them)."""
    from dalle_pytorch_tpu_torch.models.pretrained import MissingWeights

    monkeypatch.chdir(tmp_path)
    with pytest.raises(MissingWeights, match=f"{match}.*--openai_enc_path"):
        train_dalle.main(argv, device="cpu")
    assert list(tmp_path.iterdir()) == []
