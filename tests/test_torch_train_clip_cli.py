"""The port's CLIP trainer command line against the repository's
``train_clip.py`` on the CPU, float32.

Both command lines train a small CLIP (dims 32, one text and one image
layer of 2 heads, text 16 with the CLIP BPE tokenizer, 16 px images in 4
px patches) on a folder of 8 seeded PNGs of 24 px with one caption each,
batch 4, 2 epochs (2 steps each), ``--truncate_captions``; JAX's on one
of the suite's virtual CPU devices. The port starts from JAX's initial
params (its ``init_weights`` loads them), so both runs are one
computation:

- every step's loss to rtol 1e-5;
- the final ``.ckpt`` read by JAX's ``clip_from_checkpoint`` /
  ``restore_opt_state`` and the port's: params per tensor within relative
  L2 1e-3 of the 4 steps' update and each Adam moment within 1e-5
  (test_torch_train.py's tolerances), the Adam counts and the metas
  (epoch, configuration) equal.

Within the port: a run of one epoch resumed with ``--clip_path`` for a
second (its optimizer state, ``epoch + 1`` and the dataset's caption and
crop stream) ends bitwise the uninterrupted two-epoch run, with the
second epoch's losses equal, on random images with three captions each,
so that the second epoch's captions and crops are drawn where the first
epoch's left the stream; ``--bf16`` trains in bfloat16
on float32 parameters and writes a checkpoint JAX reads as such; the
parser's flags and defaults equal ``train_clip.parse_args``'s, action by
action, and each refused flag raises before any file.
"""

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dalle_pytorch_tpu.parallel as j_parallel
import train_clip as j_train_clip
from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu.models.factory import clip_from_checkpoint as j_clip_from_checkpoint
from dalle_pytorch_tpu_torch import train_clip
from dalle_pytorch_tpu_torch.convert import clip_state_dict
from dalle_pytorch_tpu_torch.data.tokenizers import SimpleTokenizer
from dalle_pytorch_tpu_torch.models import clip as port_clip
from dalle_pytorch_tpu_torch.models import factory
from dalle_pytorch_tpu_torch.parallel import step as port_step
from dalle_pytorch_tpu_torch.testing import write_caption_folder
from dalle_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)

MODEL_FLAGS = ["--dim_text", "32", "--dim_image", "32", "--dim_latent", "16",
               "--text_enc_depth", "1", "--text_seq_len", "16", "--text_heads", "2",
               "--visual_enc_depth", "1", "--visual_heads", "2", "--visual_image_size", "16",
               "--visual_patch_size", "4"]
RUN_FLAGS = ["--batch_size", "4", "--epochs", "2", "--truncate_captions",
             "--learning_rate", "1e-3", "--seed", "5"]


def _jax_clip():
    return JCLIP(dim_text=32, dim_image=32, dim_latent=16,
                 num_text_tokens=SimpleTokenizer().vocab_size, text_enc_depth=1,
                 text_seq_len=16, text_heads=2, visual_enc_depth=1, visual_heads=2,
                 visual_image_size=16, visual_patch_size=4)


def _recording(make_step, losses):
    def recording(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            state, loss = step(*args)
            losses.append(float(loss))
            return state, loss
        return run
    return recording


def _run_jax(argv, losses):
    mp = pytest.MonkeyPatch()
    make_runtime = j_parallel.make_runtime
    mp.setattr(j_parallel, "make_runtime",
               lambda **kw: make_runtime(devices=jax.devices()[:1], **kw))
    mp.setattr(j_parallel, "make_train_step", _recording(j_parallel.make_train_step, losses))
    mp.setattr(sys, "argv", ["train_clip.py", *argv])
    try:
        j_train_clip.main()
    finally:
        mp.undo()


def _run_port(argv, losses, init=None):
    mp = pytest.MonkeyPatch()
    if init is not None:
        def load(self, generator):
            self.load_state_dict(clip_state_dict(init))
            return self
        mp.setattr(port_clip.CLIP, "init_weights", load)
    mp.setattr(port_step, "make_train_step", _recording(port_step.make_train_step, losses))
    try:
        train_clip.main(argv, device="cpu")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work dir, {"jax" | "port": (checkpoint, losses)}, JAX's initial
    params)."""
    work = tmp_path_factory.mktemp("clip_cli")
    write_caption_folder(work / "data", 8, 24, seed=8)
    common = ["--image_text_folder", str(work / "data"), *MODEL_FLAGS, *RUN_FLAGS]
    out = {side: (work / f"{side}.ckpt", []) for side in ("jax", "port")}
    _run_jax([*common, "--clip_output_file_name", str(work / "jax")], out["jax"][1])
    init = jax.device_get(jax.jit(_jax_clip().init)(
        jax.random.key(5), jnp.zeros((2, 16), jnp.int32), jnp.zeros((2, 16, 16, 3)))["params"])
    _run_port([*common, "--clip_output_file_name", str(work / "port")], out["port"][1], init)
    return work, out, init


def test_losses_agree(runs):
    _, out, _ = runs
    jl, pl = out["jax"][1], out["port"][1]
    assert len(jl) == len(pl) == 4 and all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


def test_final_checkpoints_agree_in_both_readers(runs):
    _, out, init = runs
    jclip, jparams, jmeta = j_clip_from_checkpoint(str(out["jax"][0]))
    _, pparams, pmeta = j_clip_from_checkpoint(str(out["port"][0]))
    start = clip_state_dict(init)
    ref, got = (clip_state_dict(jax.device_get(p)) for p in (jparams, pparams))
    port, meta = factory.clip_from_checkpoint(out["port"][0], device="cpu")
    assert meta == pmeta and pmeta["epoch"] == jmeta["epoch"] == 1
    assert pmeta["config"] == jmeta["config"]
    assert json.loads(json.dumps(pmeta)) == pmeta
    for name in ref:
        assert torch.equal(port.state_dict()[name], got[name])
        upd, want = got[name] - start[name], ref[name] - start[name]
        assert ((upd - want).norm() / want.norm()).item() <= 1e-3, name
    jadam = factory.restore_opt_state(out["jax"][0], device="cpu")
    padam = factory.restore_opt_state(out["port"][0], device="cpu")
    assert int(jadam.count) == int(padam.count) == 4
    for ours, theirs in ((padam.mu, jadam.mu), (padam.nu, jadam.nu)):
        for name, t in ours.items():
            assert ((t - theirs[name]).norm() / theirs[name].norm()).item() <= 1e-5, name


def test_resume_ends_bitwise_the_uninterrupted_run(tmp_path):
    write_caption_folder(tmp_path / "data", 8, 24, seed=3, lines=3)
    common = ["--image_text_folder", str(tmp_path / "data"), *MODEL_FLAGS, "--batch_size", "4",
              "--truncate_captions", "--seed", "2"]
    whole, first, second = [], [], []
    _run_port([*common, "--epochs", "2", "--clip_output_file_name", str(tmp_path / "whole")],
              whole)
    _run_port([*common, "--epochs", "1", "--clip_output_file_name", str(tmp_path / "part")],
              first)
    _run_port([*common, "--epochs", "2", "--clip_path", str(tmp_path / "part.ckpt"),
               "--clip_output_file_name", str(tmp_path / "resumed")], second)
    assert len(whole) == 4 and first == whole[:2] and second == whole[2:]
    (a, ameta), (b, bmeta) = (load_checkpoint(tmp_path / f"{name}.ckpt")
                              for name in ("whole", "resumed"))
    assert ameta == bmeta and ameta["epoch"] == 1

    def flat(tree, prefix=""):
        items = {}
        for k, v in tree.items():
            items.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return items

    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys() and all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k]))
                                          for k in fa)
    assert int(factory.restore_opt_state(tmp_path / "resumed.ckpt", device="cpu").count) == 4


def test_bf16_trains_on_float32_parameters(tmp_path):
    write_caption_folder(tmp_path / "data", 4, 16, seed=1)
    losses = []
    _run_port(["--image_text_folder", str(tmp_path / "data"), *MODEL_FLAGS, "--batch_size", "4",
               "--epochs", "1", "--bf16", "--truncate_captions",
               "--clip_output_file_name", str(tmp_path / "bf16")], losses)
    assert len(losses) == 1 and np.isfinite(losses[0])
    clip, meta = factory.clip_from_checkpoint(tmp_path / "bf16.ckpt", device="cpu")
    assert clip.dtype == torch.bfloat16 and clip.param_dtype == torch.float32
    assert (meta["config"]["dtype"], meta["config"]["param_dtype"]) == ("bfloat16", "float32")
    jclip, _, _ = j_clip_from_checkpoint(str(tmp_path / "bf16.ckpt"))
    assert jclip.dtype == jnp.bfloat16 and jclip.param_dtype == jnp.float32


def _jax_parser():
    made = []
    parse = argparse.ArgumentParser.parse_args

    def keep(self, *a, **kw):
        made.append(self)
        return parse(self, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", keep)
    mp.setattr(sys, "argv", ["train_clip.py", "--image_text_folder", "x"])
    try:
        defaults = j_train_clip.parse_args()
    finally:
        mp.undo()
    return made[0], defaults


def _actions(parser):
    return {tuple(a.option_strings): (a.dest, a.type, a.default, a.nargs, a.const,
                                      type(a).__name__, a.required)
            for a in parser._actions if a.dest != "help"}


def test_flag_surface_equals_train_clip():
    ref, defaults = _jax_parser()
    port = train_clip.build_parser()
    assert _actions(port) == _actions(ref)
    assert vars(port.parse_args(["--image_text_folder", "x"])) == vars(defaults)


@pytest.mark.parametrize("flag", [["--chinese"], ["--fsdp", "2"], ["--tp", "2"], ["--wandb"],
                                  ["--wandb_name", "x"]], ids=lambda f: f[0])
def test_refused_flag_raises_before_any_file(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=f"{flag[0]} .*ROADMAP.md (queue|not queued)"):
        train_clip.main(["--image_text_folder", "data", *flag], device="cpu")
    assert list(tmp_path.iterdir()) == []
