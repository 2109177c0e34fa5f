"""The port's VAE trainer command line against the repository's
``train_vae.py`` on the CPU, float32.

Both command lines train a small DiscreteVAE (image_size 32, 2 layers,
one ResBlock, hidden 16, 40 tokens of 8) on a folder of 10 seeded PNGs
of 32 px, batch 4, 2 epochs (2 steps each), ``--kl_loss_weight 0.1``;
JAX's on one of the suite's virtual CPU devices. The port starts from
JAX's initial params (its ``init_weights`` loads them) and takes each
step's Gumbel noise from the draw JAX's module makes with that step's
key (``jax.random.key(step)``), so both runs are one computation:

- every step's loss to rtol 1e-5;
- the final ``.ckpt``: read by JAX's ``vae_from_checkpoint`` and the
  port's, params per tensor within relative L2 1e-3 of the 4 steps'
  update (test_torch_train.py's tolerance), the metas (epoch, the
  ExponentialDecay scheduler state, the model configuration) equal;
- the reconstruction grids of step 0 within one 8-bit level;
- the port's checkpoint trains a DALLE: ``train_dalle --vae_path``.

Also: the parser's flags and defaults equal ``train_vae.parse_args``'s,
action by action, and each refused flag raises before any file.
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
import train_vae as j_train_vae
from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.models.factory import vae_from_checkpoint as j_vae_from_checkpoint
from dalle_pytorch_tpu_torch import train_dalle, train_vae
from dalle_pytorch_tpu_torch.convert import vae_state_dict
from dalle_pytorch_tpu_torch.data.image_io import read_png
from dalle_pytorch_tpu_torch.models import factory
from dalle_pytorch_tpu_torch.models import vae as port_vae
from dalle_pytorch_tpu_torch.parallel import step as port_step
from dalle_pytorch_tpu_torch.testing import write_caption_folder

torch.set_num_threads(2)

MODEL_FLAGS = ["--image_size", "32", "--num_layers", "2", "--num_resnet_blocks", "1",
               "--hidden_dim", "16", "--num_tokens", "40", "--emb_dim", "8"]
RUN_FLAGS = ["--batch_size", "4", "--epochs", "2", "--kl_loss_weight", "0.1",
             "--learning_rate", "2e-3", "--lr_decay_rate", "0.9", "--num_images_save", "2",
             "--seed", "3"]


def _jax_vae():
    return JVAE(image_size=32, num_tokens=40, codebook_dim=8, num_layers=2, num_resnet_blocks=1,
                hidden_dim=16, kl_div_loss_weight=0.1)


def _run_jax(argv, losses):
    mp = pytest.MonkeyPatch()
    make_runtime, make_step = j_parallel.make_runtime, j_parallel.make_train_step

    def recording(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            state, loss, recons = step(*args)
            losses.append(float(loss))
            return state, loss, recons
        return run

    mp.setattr(j_parallel, "make_runtime",
               lambda **kw: make_runtime(devices=jax.devices()[:1], **kw))
    mp.setattr(j_parallel, "make_train_step", recording)
    mp.setattr(sys, "argv", ["train_vae.py", *argv])
    try:
        j_train_vae.main()
    finally:
        mp.undo()


def _step_noise(params, image):
    """JAX's module's Gumbel draw with key(step), for each of 4 steps."""
    drawn = []
    draw = jax.random.gumbel
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "gumbel", lambda *a, **k: drawn.append(draw(*a, **k)) or drawn[-1])
    try:
        for step in range(4):
            _jax_vae().apply({"params": params}, image, rngs={"gumbel": jax.random.key(step)})
    finally:
        mp.undo()
    return [np.array(d) for d in drawn]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work dir, {"jax" | "port": (checkpoint, losses, samples dir)},
    JAX's initial params)."""
    work = tmp_path_factory.mktemp("vae_cli")
    write_caption_folder(work / "data", 10, 32, seed=6)
    common = ["--image_folder", str(work / "data"), *MODEL_FLAGS, *RUN_FLAGS]
    out = {}
    for side in ("jax", "port"):
        out[side] = (work / f"{side}.ckpt", [], work / f"{side}_samples")
    argv = lambda side: [*common, "--output_file_name", str(out[side][0]),  # noqa: E731
                         "--samples_dir", str(out[side][2])]
    _run_jax(argv("jax"), out["jax"][1])

    # the port from JAX's initial params, with JAX's noise of each step
    init = jax.jit(_jax_vae().init)({"params": jax.random.key(3), "gumbel": jax.random.key(0)},
                                    jnp.zeros((1, 32, 32, 3)))["params"]
    init = jax.device_get(init)
    noise = _step_noise(init, jnp.zeros((4, 32, 32, 3)))
    mp = pytest.MonkeyPatch()

    def load_jax_init(self, generator):
        self.load_state_dict(vae_state_dict(init))
        return self

    def jax_noise(shape, generator, device=None):
        return torch.from_numpy(noise[generator.initial_seed()]).to(device)

    make_step = port_step.make_train_step

    def recording(*a, **kw):
        inner = make_step(*a, **kw)

        def run(*args):
            state, loss, recons = inner(*args)
            out["port"][1].append(float(loss))
            return state, loss, recons
        return run

    mp.setattr(port_vae.DiscreteVAE, "init_weights", load_jax_init)
    mp.setattr(port_vae, "gumbel_noise", jax_noise)
    mp.setattr(port_step, "make_train_step", recording)
    try:
        train_vae.main(argv("port"), device="cpu")
    finally:
        mp.undo()
    return work, out, init


def test_losses_agree(runs):
    _, out, _ = runs
    jl, pl = out["jax"][1], out["port"][1]
    assert len(jl) == len(pl) == 4 and all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


def test_final_params_agree_in_both_readers(runs):
    _, out, init = runs
    jvae, jparams, jmeta = j_vae_from_checkpoint(str(out["jax"][0]))
    _, pparams, pmeta = j_vae_from_checkpoint(str(out["port"][0]))
    start = vae_state_dict(init)
    ref = vae_state_dict(jax.device_get(jparams))
    got = vae_state_dict(jax.device_get(pparams))
    port, _ = factory.vae_from_checkpoint(out["port"][0], device="cpu")
    assert sorted(got) == sorted(ref) == sorted(port.state_dict())
    for name in ref:
        assert torch.equal(port.state_dict()[name], got[name])
        upd, want = got[name] - start[name], ref[name] - start[name]
        err = ((upd - want).norm() / want.norm()).item()
        assert err <= 1e-3, (name, err)
    assert pmeta["epoch"] == jmeta["epoch"] == 1
    assert pmeta["scheduler_state"]["lr"] == pytest.approx(jmeta["scheduler_state"]["lr"],
                                                          rel=1e-12)
    assert pmeta["config"] == jmeta["config"]
    assert json.loads(json.dumps(pmeta)) == pmeta


def test_reconstruction_grids_agree(runs):
    _, out, _ = runs
    grids = [sorted(out[s][2].glob("*.png")) for s in ("jax", "port")]
    assert [p.name for p in grids[0]] == [p.name for p in grids[1]] == ["recon_0000000.png"]
    from PIL import Image

    ref = np.asarray(Image.open(grids[0][0]).convert("RGB")).astype(int)
    got = read_png(grids[1][0].read_bytes()).pixels.astype(int)
    assert got.shape == ref.shape == (64, 64, 3)
    assert np.abs(got - ref).max() <= 1


def test_port_checkpoint_trains_a_dalle(runs, tmp_path, monkeypatch):
    work, out, _ = runs
    monkeypatch.chdir(tmp_path)
    train_dalle.main(["--image_text_folder", str(work / "data"), "--vae_path",
                      str(out["port"][0]), "--dim", "32", "--depth", "1", "--heads", "2",
                      "--dim_head", "16", "--text_seq_len", "8", "--truncate_captions",
                      "--epochs", "1", "--batch_size", "2"], device="cpu")
    dalle, vae, meta = factory.dalle_from_checkpoint(tmp_path / "dalle.ckpt", device="cpu")
    assert vae.num_tokens == 40 and dalle.image_fmap_size == 8 and meta["epoch"] == 0
    trained, _ = factory.vae_from_checkpoint(out["port"][0], device="cpu")
    assert all(torch.equal(t, trained.state_dict()[k]) for k, t in vae.state_dict().items())


def _jax_parser():
    """The parser ``train_vae.parse_args`` builds."""
    made = []
    parse = argparse.ArgumentParser.parse_args

    def keep(self, *a, **kw):
        made.append(self)
        return parse(self, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", keep)
    mp.setattr(sys, "argv", ["train_vae.py", "--image_folder", "x"])
    try:
        defaults = j_train_vae.parse_args()
    finally:
        mp.undo()
    return made[0], defaults


def _actions(parser):
    return {tuple(a.option_strings): (a.dest, a.type, a.default, a.nargs, a.const,
                                      type(a).__name__, a.required)
            for a in parser._actions if a.dest != "help"}


def test_flag_surface_equals_train_vae():
    ref, defaults = _jax_parser()
    port = train_vae.build_parser()
    assert _actions(port) == _actions(ref)
    assert vars(port.parse_args(["--image_folder", "x"])) == vars(defaults)
    assert set(train_vae.NOT_PORTED) == {"fsdp", "tp", "wandb"}


@pytest.mark.parametrize("flag", [["--fsdp", "2"], ["--tp", "2"], ["--wandb"]],
                         ids=lambda f: f[0])
def test_refused_flag_raises_before_any_file(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=f"{flag[0]} .*ROADMAP.md (queue|not queued)"):
        train_vae.main(["--image_folder", "data", *flag], device="cpu")
    assert list(tmp_path.iterdir()) == []
