"""The port's generate command line (``python -m
dalle_pytorch_tpu_torch.generate``) against the repository's
``generate.py`` on the CPU.

A tiny float32 DALLE (dim 32, depth 2, 2 heads of 16, text 8 over the
CLIP BPE vocabulary of 49,408, a 4 x 4 grid) with its DiscreteVAE
(16 px, 20 codes) and a tiny CLIP (text 8, 8 px images in 4 px
patches), every weight perturbed from JAX's init, are written by JAX's
``save_dalle_checkpoint`` / ``save_clip_checkpoint``. Both command lines
run on that file with ``--top_k 1.0`` (k 1: greedy, so neither
framework's random bits matter), two prompts, three images each, batch
2, ``--clip_path``:

- the tokens of every request are equal (read from each engine);
- the saved PNGs are equal within one level of 255: the images are
  held to atol 1e-4 in the VAE's space (``tests/test_torch_generate.py``'s
  ``generate_images`` tolerance), and 1e-4 x 0.5 (the normalization's
  std) x 255 < 1, so ``(x * 255).astype(uint8)`` can differ by one step
  where a value straddles a level;
- the rerank scores agree within ``SCORE_TOL`` and the saved order is
  JAX's wherever two of JAX's consecutive scores differ by more than
  that. Under greedy decoding every image of a prompt is the same image,
  so every one of those pairs is a tie: the test counts the ties and
  holds that the tied images are equal on both sides (the port's order
  against its engine's scores, sampled, is held in
  test_torch_generate_cli_flags.py);
- the ``--gentxt`` completion (greedy) is JAX's, to the character, and
  names the same output directory;
- a checkpoint the port's factory wrote from the converted model serves
  JAX's command line the same images as JAX's own file, and JAX's file
  serves the port's command line the same images as the port's file.

JAX's command line runs in this process (``sys.argv`` patched), on one
of the suite's 8 virtual CPU devices."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import generate as j_generate
from dalle_pytorch_tpu.models import CLIP as JCLIP
from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.models.factory import save_clip_checkpoint as j_save_clip
from dalle_pytorch_tpu.models.factory import save_dalle_checkpoint as j_save_dalle
from dalle_pytorch_tpu_torch import generate
from dalle_pytorch_tpu_torch.data.image_io import read_png
from dalle_pytorch_tpu_torch.models.factory import dalle_from_checkpoint, save_dalle_checkpoint
from dalle_pytorch_tpu_torch.testing import reset_registries

torch.set_num_threads(2)

DALLE_CONFIG = dict(dim=32, depth=2, num_text_tokens=49408, text_seq_len=8, num_image_tokens=20,
                    image_fmap_size=4, heads=2, dim_head=16)
VAE_CONFIG = dict(image_size=16, num_layers=2, num_resnet_blocks=0, hidden_dim=8, num_tokens=20,
                  codebook_dim=8)
CLIP_CONFIG = dict(dim_text=16, dim_image=16, dim_latent=16, num_text_tokens=49408,
                   text_enc_depth=1, text_seq_len=8, text_heads=2, text_dim_head=8,
                   num_visual_tokens=20, visual_enc_depth=1, visual_heads=2, visual_dim_head=8,
                   visual_image_size=8, visual_patch_size=4)
TEXT = "a red circle|two small blue squares"
RUN = ["--top_k", "1.0", "--num_images", "3", "--batch_size", "2", "--seed", "3"]
SCORE_TOL = 1e-4


def perturbed(params, seed):
    """Every leaf scaled and shifted by seeded noise (unit LayerNorms and
    small LayerScales would hide swapped weights)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape))
                   + 0.05 * rng.randn(*a.shape)).astype(np.float32), jax.device_get(params))


def write_jax_checkpoints(work, dalle_config=DALLE_CONFIG, clip_config=CLIP_CONFIG, seed=0):
    """JAX's DALLE + VAE and CLIP files under ``work``: (dalle, clip)
    paths."""
    vae = JVAE(**VAE_CONFIG)
    vparams = vae.init({"params": jax.random.key(seed), "gumbel": jax.random.key(seed + 1)},
                       jnp.zeros((1, 16, 16, 3)))["params"]
    dalle = JDALLE(**dalle_config)
    dparams = dalle.init(jax.random.key(seed + 2), jnp.ones((1, dalle_config["text_seq_len"]),
                                                            jnp.int32),
                         jnp.zeros((1, 16), jnp.int32))["params"]
    j_save_dalle(str(work / "dalle.ckpt"), dalle, perturbed(dparams, seed), vae,
                 perturbed(vparams, seed + 1))
    paths = [work / "dalle.ckpt"]
    if clip_config is not None:
        clip = JCLIP(**clip_config)
        cparams = clip.init(jax.random.key(seed + 3),
                            jnp.ones((1, clip_config["text_seq_len"]), jnp.int32),
                            jnp.zeros((1, 8, 8, 3)))["params"]
        j_save_clip(str(work / "clip.ckpt"), clip, perturbed(cparams, seed + 2))
        paths.append(work / "clip.ckpt")
    return paths


def run_cli(side, argv, monkeypatch=None):
    """Run ``side``'s command line; returns {request id: (tokens, image,
    score)} of every request its engine served."""
    served = {}
    if side == "jax":
        inner = j_generate._engine_images

        def spy(engine, dalle, prompt_row, num_images, tag, seed):
            out = inner(engine, dalle, prompt_row, num_images, tag, seed)
            served.update({rid: (np.asarray(r.tokens).tolist(), r.image, r.rerank_score)
                           for rid, r in engine.results.items()})
            return out

        mp = pytest.MonkeyPatch()
        mp.setattr(j_generate, "_engine_images", spy)
        mp.setattr(sys, "argv", ["generate.py", *argv])
        try:
            j_generate.main()
        finally:
            mp.undo()
    else:
        inner = generate.engine_images

        def spy(engine, prompt_row, num_images, tag, seed):
            out = inner(engine, prompt_row, num_images, tag, seed)
            served.update({rid: (np.asarray(r.tokens).tolist(), r.image, r.rerank_score)
                           for rid, r in engine.results.items()})
            return out

        mp = pytest.MonkeyPatch()
        mp.setattr(generate, "engine_images", spy)
        try:
            generate.main(argv, device="cpu")
        finally:
            mp.undo()
    return served


def saved(out_dir):
    """{prompt directory: ([pixels of 0.png, 1.png, ...], caption)}."""
    dirs = {}
    for sub in sorted(p for p in out_dir.iterdir() if p.is_dir()):
        pngs = sorted(sub.glob("*.png"), key=lambda p: int(p.stem))
        dirs[sub.name] = ([np.asarray(read_png(p.read_bytes())) for p in pngs],
                          (sub / "caption.txt").read_text())
    return dirs


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    work = tmp_path_factory.mktemp("gen")
    write_jax_checkpoints(work)
    return work


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


@pytest.fixture(scope="module")
def runs(work):
    """Both command lines on JAX's files: {side: (served, saved)}."""
    out = {}
    for side in ("jax", "port"):
        argv = ["--dalle_path", str(work / "dalle.ckpt"), "--clip_path", str(work / "clip.ckpt"),
                "--text", TEXT, "--outputs_dir", str(work / f"out_{side}"), *RUN]
        out[side] = (run_cli(side, argv), saved(work / f"out_{side}"))
    return out


def _close_pixels(a, b):
    return a.shape == b.shape and int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


def test_tokens_equal_jax(runs):
    theirs, ours = runs["jax"][0], runs["port"][0]
    assert sorted(ours) == sorted(theirs) == [f"p{p}-img{i}" for p in range(2) for i in range(3)]
    for rid in theirs:
        assert ours[rid][0] == theirs[rid][0], rid
        assert len(ours[rid][0]) == 16


def test_saved_images_and_captions_equal_jax(runs):
    theirs, ours = runs["jax"][1], runs["port"][1]
    assert list(ours) == list(theirs) == ["a_red_circle", "two_small_blue_squares"]
    for name in theirs:
        assert ours[name][1] == theirs[name][1]
        assert len(ours[name][0]) == len(theirs[name][0]) == 3
        for a, b in zip(ours[name][0], theirs[name][0]):
            assert a.shape == (16, 16, 3) and a.dtype == np.uint8
            assert _close_pixels(a, b)
    for rid, (_, image, _) in runs["port"][0].items():
        np.testing.assert_allclose(image, runs["jax"][0][rid][1], atol=1e-4, rtol=0)


def test_rerank_order_equal_jax_where_scores_differ(runs):
    ties = 0
    for p in range(2):
        rids = [f"p{p}-img{i}" for i in range(3)]
        jscores = np.array([runs["jax"][0][r][2] for r in rids])
        pscores = np.array([runs["port"][0][r][2] for r in rids])
        np.testing.assert_allclose(pscores, jscores, atol=SCORE_TOL, rtol=0)
        jorder, porder = np.argsort(-jscores), np.argsort(-pscores)
        for k in range(len(rids) - 1):
            a, b = jorder[k], jorder[k + 1]
            if jscores[a] - jscores[b] > SCORE_TOL:
                assert list(porder).index(a) < list(porder).index(b), (p, jscores, pscores)
            else:
                ties += 1
                # a tie is the same image on both sides (greedy: one image a prompt)
                assert runs["jax"][0][rids[a]][0] == runs["jax"][0][rids[b]][0]
                assert runs["port"][0][rids[a]][0] == runs["port"][0][rids[b]][0]
    assert ties == 4  # every consecutive pair: greedy serves one image a prompt


def test_gentxt_completion_equals_jax(work, capsys):
    dirs = {}
    for side in ("jax", "port"):
        out = work / f"gentxt_{side}"
        run_cli(side, ["--dalle_path", str(work / "dalle.ckpt"), "--text", "a red circle",
                       "--outputs_dir", str(out), "--gentxt", "--top_k", "1.0",
                       "--num_images", "1", "--batch_size", "1"])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("completed prompt: ")]
        dirs[side] = (lines, sorted(p.name for p in out.iterdir()))
    assert dirs["port"] == dirs["jax"]
    assert len(dirs["jax"][0]) == 1 and dirs["jax"][0][0].startswith("completed prompt: a red")


def test_checkpoints_read_both_ways(work):
    port_ckpt = work / "port_dalle.ckpt"
    dalle, vae, _ = dalle_from_checkpoint(work / "dalle.ckpt", "cpu")
    save_dalle_checkpoint(port_ckpt, dalle, vae)
    got = {}
    for side in ("jax", "port"):
        for ckpt in (work / "dalle.ckpt", port_ckpt):
            out = work / f"both_{side}_{ckpt.stem}"
            run_cli(side, ["--dalle_path", str(ckpt), "--text", "a red circle", "--outputs_dir",
                           str(out), "--num_images", "2", "--batch_size", "2", "--top_k", "1.0"])
            got[side, ckpt.stem] = saved(out)
    for side in ("jax", "port"):
        a, b = got[side, "dalle"], got[side, "port_dalle"]
        assert list(a) == list(b) == ["a_red_circle"]
        assert all(np.array_equal(x, y) for x, y in zip(a["a_red_circle"][0], b["a_red_circle"][0]))
    assert all(_close_pixels(x, y) for x, y in zip(got["jax", "port_dalle"]["a_red_circle"][0],
                                                   got["port", "dalle"]["a_red_circle"][0]))
