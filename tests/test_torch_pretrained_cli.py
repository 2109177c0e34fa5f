"""The trainer and generate command lines with a pretrained VQGAN, the
port's against the repository's ``train_dalle.py`` / ``generate.py`` on
the CPU, float32.

A small VQGAN (JAX's ``tests/test_vqgan.py`` configuration: 16 px, a
8 x 8 grid of 24 codes) is written as taming publishes it
(``model.yaml`` and a ``last.ckpt`` of ``{"state_dict": ...}``), and 8
PNGs of 16 px with one caption each:

- ``--taming`` with local paths: JAX's command line writes its
  pre-flight ``.ckpt`` (``--epochs 0``), then both command lines train
  one epoch at batch 4 (two steps) from the same initial weights (the
  port's ``DALLE.init_weights`` loads JAX's pre-flight params); the
  losses within rtol 1e-5 (``tests/test_torch_train_cli.py``'s);
- both final checkpoints carry ``vae_class`` ``VQGanVAE``, its config
  and no VAE weights, equal metas, and each reader reads the other's
  file with ``vae_weight_paths``;
- the port's trainer sample (``--sample_every_n_steps 1``) is saved as
  the decode's [0, 1] pixels, not denormalized with the DiscreteVAE's
  default;
- both generate command lines on the port's checkpoint with
  ``--vqgan_config_path`` / ``--vqgan_model_path``, a CLIP to rerank
  and ``--gentxt``, greedy: the completed prompt (its directory) and the
  tokens equal, the PNGs within one level of 255 (pixels held to 1e-4,
  the decode's [0, 1] scale: 1e-4 x 255 < 1) and in [0, 1], the rerank
  scores within ``SCORE_TOL`` of JAX's and the PNGs saved best first;
- a missing weight file is refused with ``MissingWeights`` naming its
  flag, before any file is written, by both command lines."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dalle_pytorch_tpu.parallel as j_parallel
import train_dalle as j_train_dalle
from dalle_pytorch_tpu.models import CLIP as JCLIP
from dalle_pytorch_tpu.models.factory import save_clip_checkpoint as j_save_clip
from dalle_pytorch_tpu.models.factory import dalle_from_checkpoint as j_dalle_from_checkpoint
from dalle_pytorch_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from dalle_pytorch_tpu_torch import generate, train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_params, dalle_state_dict
from dalle_pytorch_tpu_torch.data.image_io import read_png
from dalle_pytorch_tpu_torch.models import dalle as port_dalle
from dalle_pytorch_tpu_torch.models import sampling
from dalle_pytorch_tpu_torch.models.factory import dalle_from_checkpoint
from dalle_pytorch_tpu_torch.models.pretrained import MissingWeights
from dalle_pytorch_tpu_torch.models.vqgan import VQGanVAE
from dalle_pytorch_tpu_torch.testing import (
    reset_registries,
    write_caption_folder,
    write_pretrained_files,
)
from dalle_pytorch_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_generate_cli import CLIP_CONFIG, SCORE_TOL, perturbed, run_cli, saved

torch.set_num_threads(2)

VQGAN = dict(image_size=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             z_channels=64, n_embed=24, embed_dim=64)
MODEL_FLAGS = ["--dim", "64", "--depth", "2", "--heads", "2", "--dim_head", "32",
               "--text_seq_len", "16", "--truncate_captions"]
RUN_FLAGS = ["--epochs", "1", "--batch_size", "4", "--random_resize_crop_lower_ratio", "1.0"]


def _png(path):
    return np.asarray(read_png(path.read_bytes()))


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


def _vqgan():
    vae = VQGanVAE(**VQGAN, device="cpu").init_weights(torch.Generator().manual_seed(7))
    with torch.no_grad():
        vae.decoder.conv_out.weight.mul_(0.2)
    return vae


def _flags(paths):
    return ["--vqgan_config_path", paths["vqgan_config_path"],
            "--vqgan_model_path", paths["vqgan_model_path"]]


def _run_jax(argv, losses):
    make_runtime, make_step = j_parallel.make_runtime, j_parallel.make_train_step

    def recording(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            state, loss = step(*args)
            losses.append(float(loss))
            return state, loss
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(j_parallel, "make_runtime",
               lambda **kw: make_runtime(devices=jax.devices()[:1], **kw))
    mp.setattr(j_parallel, "make_train_step", recording)
    mp.setattr(sys, "argv", ["train_dalle.py", *argv])
    try:
        j_train_dalle.main()
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work, weight paths, {"jax" | "port": (final checkpoint, losses)},
    the port's sample pixels and PNG)."""
    work = tmp_path_factory.mktemp("taming")
    write_caption_folder(work / "data", 8, 16, seed=3)
    paths = write_pretrained_files(work / "vqgan", _vqgan())
    common = ["--image_text_folder", str(work / "data"), *MODEL_FLAGS, "--taming", *_flags(paths)]
    _run_jax([*common, "--epochs", "0", "--dalle_output_file_name", str(work / "pre")], [])
    _, pre, _, _, _ = j_dalle_from_checkpoint(str(work / "pre.ckpt"),
                                              vae_weight_paths=paths)
    pre_sd = dalle_state_dict(jax.device_get(pre))
    out = {"jax": (work / "jax_out.ckpt", [])}
    _run_jax([*common, *RUN_FLAGS, "--dalle_output_file_name", str(work / "jax_out")],
             out["jax"][1])

    losses, samples = [], []
    mp = pytest.MonkeyPatch()
    verdict, generate_images = train_dalle.DalleTrainer.verdict, sampling.generate_images

    def load_jax_init(self, generator):
        self.load_state_dict({k: v.to(self.text_emb.weight.dtype) for k, v in pre_sd.items()})
        return self

    def recording(self, loss):
        losses.append(float(loss))
        return verdict(self, loss)

    def sampled(*a, **k):
        samples.append(generate_images(*a, **k))
        return samples[-1]

    mp.setattr(port_dalle.DALLE, "init_weights", load_jax_init)
    mp.setattr(train_dalle.DalleTrainer, "verdict", recording)
    mp.setattr(sampling, "generate_images", sampled)
    mp.chdir(work)
    try:
        train_dalle.main([*common, *RUN_FLAGS, "--sample_every_n_steps", "1",
                          "--dalle_output_file_name", str(work / "port_out")], device="cpu")
    finally:
        mp.undo()
    out["port"] = (work / "port_out.ckpt", losses)
    return work, paths, out, samples, work / "dalle_samples" / "sample_0000001.png"


def test_taming_losses_agree_with_jax(runs):
    _, _, out, _, _ = runs
    jax_losses, port_losses = out["jax"][1], out["port"][1]
    assert len(jax_losses) == len(port_losses) == 2
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)


def test_checkpoints_store_the_vqgan_by_class_and_config(runs):
    work, paths, out, _, _ = runs
    (jstate, jmeta), (pstate, pmeta) = (j_load_checkpoint(str(out[s][0])) for s in ("jax", "port"))
    for state, meta in ((jstate, jmeta), (pstate, pmeta)):
        assert meta["vae_class"] == "VQGanVAE" and "vae_params" not in state
    assert pmeta["vae_config"] == jmeta["vae_config"] and pmeta["config"] == jmeta["config"]
    assert pmeta["vae_config"]["ch_mult"] == [1, 2] and pmeta["vae_config"]["dtype"] == "float32"
    # each reader reads the other's file, the VQGAN from the weight paths
    dalle, vae, meta = dalle_from_checkpoint(out["jax"][0], device="cpu", vae_weight_paths=paths)
    assert isinstance(vae, VQGanVAE) and meta == jmeta
    jdalle, jparams, jvae, jvparams, jm = j_dalle_from_checkpoint(str(out["port"][0]),
                                                                  vae_weight_paths=paths)
    assert type(jvae).__name__ == "VQGanVAE" and jm == load_checkpoint(out["port"][0])[1]
    port_model, _, _ = dalle_from_checkpoint(out["port"][0], device="cpu",
                                             vae_weight_paths=paths)
    ours = dalle_params(port_model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams))
    mine = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert all(np.array_equal(np.asarray(v), mine[k]) for k, v in flat)
    assert int(jvae.image_seq_len) == vae.image_seq_len == 64


def test_trainer_sample_is_saved_in_the_vqgan_pixel_space(runs):
    _, _, _, samples, png = runs
    assert len(samples) == 1
    pixels = samples[0][0].float().numpy()
    assert pixels.shape == (16, 16, 3) and pixels.min() >= 0 and pixels.max() <= 1
    np.testing.assert_array_equal(_png(png), (pixels * 255).astype(np.uint8))


def test_generate_cli_with_vqgan_paths_equals_jax(runs, tmp_path):
    work, paths, out, _, _ = runs
    clip = JCLIP(**CLIP_CONFIG)
    cparams = clip.init(jax.random.key(4), jnp.ones((1, 8), jnp.int32),
                        jnp.zeros((1, 8, 8, 3)))["params"]
    j_save_clip(str(tmp_path / "clip.ckpt"), clip, perturbed(cparams, 5))
    argv = ["--dalle_path", str(out["port"][0]), "--text", "a red circle", "--top_k", "1.0",
            "--num_images", "2", "--batch_size", "2", "--seed", "3", "--gentxt",
            "--clip_path", str(tmp_path / "clip.ckpt"), *_flags(paths)]
    served = {}
    for side in ("jax", "port"):
        served[side] = run_cli(side, [*argv, "--outputs_dir", str(tmp_path / side)])
    assert sorted(served["jax"]) == sorted(served["port"]) == ["p0-img0", "p0-img1"]
    for rid in served["jax"]:
        jtok, jimg, jscore = served["jax"][rid]
        ptok, pimg, pscore = served["port"][rid]
        assert jtok == ptok and len(ptok) == 64
        assert pimg.min() >= 0 and pimg.max() <= 1
        np.testing.assert_allclose(pimg, np.asarray(jimg), atol=1e-4)
        assert abs(pscore - float(jscore)) <= SCORE_TOL
    files = {side: saved(tmp_path / side) for side in ("jax", "port")}
    assert files["jax"].keys() == files["port"].keys() and len(files["port"]) == 1
    for name, (jpngs, caption) in files["jax"].items():
        ppngs, pcaption = files["port"][name]
        assert caption == pcaption and len(jpngs) == len(ppngs) == 2
        for a, b in zip(jpngs, ppngs):
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1, name
    # best first, as the decode's pixels: a DiscreteVAE's denormalization
    # would lift every value to at least half the range
    best = max(served["port"], key=lambda rid: served["port"][rid][2])
    png = _png(next((tmp_path / "port").rglob("0.png")))
    np.testing.assert_array_equal(png, (np.asarray(served["port"][best][1]) * 255).astype(np.uint8))


def test_missing_vqgan_files_are_refused_by_both_command_lines(runs, tmp_path, monkeypatch):
    work, paths, out, _, _ = runs
    monkeypatch.chdir(tmp_path)
    base = ["--image_text_folder", str(work / "data"), *MODEL_FLAGS, "--taming"]
    with pytest.raises(MissingWeights, match="--vqgan_config_path"):
        train_dalle.main(base, device="cpu")
    with pytest.raises(MissingWeights, match="--vqgan_model_path"):
        train_dalle.main([*base, "--vqgan_config_path", paths["vqgan_config_path"],
                          "--vqgan_model_path", "nowhere.ckpt"], device="cpu")
    with pytest.raises(MissingWeights, match="--vqgan_model_path"):
        generate.main(["--dalle_path", str(out["port"][0]), "--text", "x",
                       "--vqgan_config_path", paths["vqgan_config_path"]], device="cpu")
    assert list(tmp_path.iterdir()) == []
