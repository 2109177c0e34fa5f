"""Checkpoints holding the pretrained VAEs, between the port's
``models/factory.py`` and JAX's, on the CPU (small wrappers: the VQGAN
of ``tests/test_vqgan.py``, the dVAE of ``tests/test_pretrained.py``):

- a VAE checkpoint (``save_vae_checkpoint``, the weights as JAX's flax
  tree) written by either side is read by the other to the same
  weights, and its meta (class and config, dtypes included) is JAX's;
- ``vae_classes()`` names JAX's three classes, ``build_vae`` builds each
  and refuses parameters in another type than float32;
- a DALLE checkpoint stores a frozen pretrained VAE by class and config
  only, computing type included: a bfloat16 VQGAN is read back from the
  weight files in bfloat16, as JAX's ``dalle_from_checkpoint`` hands the
  type to its loader, and JAX's reader gives the same meta;
- the trainer under ``--bf16 --taming`` loads the VQGAN in bfloat16
  (JAX ``train_dalle.py:281``) and its checkpoint says so."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models.factory import dalle_from_checkpoint as j_dalle_from_checkpoint
from dalle_pytorch_tpu.models.factory import save_dalle_checkpoint as j_save_dalle
from dalle_pytorch_tpu.models.factory import save_vae_checkpoint as j_save_vae
from dalle_pytorch_tpu.models.factory import vae_from_checkpoint as j_vae_from_checkpoint
from dalle_pytorch_tpu.models.vqgan import load_vqgan_vae as j_load_vqgan_vae
from dalle_pytorch_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from dalle_pytorch_tpu_torch import convert, train_dalle
from dalle_pytorch_tpu_torch.models import factory
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.pretrained import OpenAIDiscreteVAE
from dalle_pytorch_tpu_torch.models.vqgan import VQGanVAE
from dalle_pytorch_tpu_torch.testing import (
    reset_registries,
    write_caption_folder,
    write_pretrained_files,
)
from dalle_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)

VQGAN = dict(image_size=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             z_channels=64, n_embed=24, embed_dim=64)
DVAE = dict(image_size=16, num_layers=3, num_tokens=16, n_hid=8)


def _vaes():
    g = torch.Generator().manual_seed(0)
    return {"VQGanVAE": VQGanVAE(**VQGAN, device="cpu").init_weights(g),
            "OpenAIDiscreteVAE": OpenAIDiscreteVAE(**DVAE, device="cpu").init_weights(g)}


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


@pytest.mark.parametrize("name", ["VQGanVAE", "OpenAIDiscreteVAE"])
def test_vae_checkpoints_are_read_both_ways(name, tmp_path):
    vae = _vaes()[name]
    img = torch.from_numpy(np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32))
    factory.save_vae_checkpoint(tmp_path / "port.ckpt", vae)
    jvae, jparams, jmeta = j_vae_from_checkpoint(str(tmp_path / "port.ckpt"))
    assert type(jvae).__name__ == name and jmeta["model_class"] == name
    theirs = jvae.apply({"params": jparams}, jnp.asarray(img.numpy()),
                        method="get_codebook_indices")
    np.testing.assert_array_equal(np.asarray(theirs), vae.get_codebook_indices(img).numpy())
    j_save_vae(str(tmp_path / "jax.ckpt"), jvae, jparams)
    (_, pmeta), (_, jm) = load_checkpoint(tmp_path / "port.ckpt"), load_checkpoint(
        tmp_path / "jax.ckpt")
    assert pmeta == jm
    back, meta = factory.vae_from_checkpoint(tmp_path / "jax.ckpt", device="cpu")
    assert type(back) is type(vae) and meta == jm
    assert all(torch.equal(back.state_dict()[k], v) for k, v in vae.state_dict().items())


def test_vae_classes_and_build_vae():
    assert set(factory.vae_classes()) == {"DiscreteVAE", "OpenAIDiscreteVAE", "VQGanVAE"}
    for name, vae in _vaes().items():
        cfg = factory.vae_config(vae)
        built = factory.build_vae(name, cfg, device="meta")
        assert type(built) is type(vae) and factory.vae_config(built) == cfg
        with pytest.raises(NotImplementedError, match="dtype"):
            factory.build_vae(name, {**cfg, "param_dtype": "bfloat16"}, device="meta")
    with pytest.raises(ValueError, match="unknown VAE class"):
        factory.build_vae("GumbelVAE", {}, device="meta")


def test_dalle_checkpoint_keeps_the_vqgan_type_and_no_weights(tmp_path):
    vae = _vaes()["VQGanVAE"]
    paths = write_pretrained_files(tmp_path / "w", vae)
    bf16 = VQGanVAE(**VQGAN, device="meta", dtype=torch.bfloat16)
    dalle = DALLE(dim=32, depth=1, num_text_tokens=16, text_seq_len=4, num_image_tokens=24,
                  image_fmap_size=8, heads=2, dim_head=16, device="cpu").init_weights(
                      torch.Generator().manual_seed(1))
    factory.save_dalle_checkpoint(tmp_path / "d.ckpt", dalle, bf16)
    state, meta = load_checkpoint(tmp_path / "d.ckpt")
    assert "vae_params" not in state and meta["vae_class"] == "VQGanVAE"
    assert meta["vae_config"]["dtype"] == "bfloat16"
    _, back, _ = factory.dalle_from_checkpoint(tmp_path / "d.ckpt", device="cpu",
                                               vae_weight_paths=paths)
    assert back.dtype == torch.bfloat16
    assert all(torch.equal(back.state_dict()[k], v) for k, v in vae.state_dict().items())
    _, _, jvae, _, jmeta = j_dalle_from_checkpoint(str(tmp_path / "d.ckpt"),
                                                   vae_weight_paths=paths)
    assert jvae.dtype == jnp.bfloat16 and jmeta == meta
    # and JAX's file of the same models
    jv, jvp = j_load_vqgan_vae(paths["vqgan_config_path"], paths["vqgan_model_path"],
                               dtype=jnp.bfloat16)
    jdalle = JDALLE(dim=32, depth=1, num_text_tokens=16, text_seq_len=4, num_image_tokens=24,
                    image_fmap_size=8, heads=2, dim_head=16)
    j_save_dalle(str(tmp_path / "j.ckpt"), jdalle,
                 convert.dalle_params(dalle.state_dict()), jv, jvp)
    jstate, jm = j_load_checkpoint(str(tmp_path / "j.ckpt"))
    assert "vae_params" not in jstate and jm["vae_config"] == meta["vae_config"]
    model, jback, _ = factory.dalle_from_checkpoint(tmp_path / "j.ckpt", device="cpu",
                                                    vae_weight_paths=paths)
    assert jback.dtype == torch.bfloat16
    assert all(torch.equal(model.state_dict()[k], v) for k, v in dalle.state_dict().items())
    with pytest.raises(FileNotFoundError, match="--vqgan_config_path"):
        factory.dalle_from_checkpoint(tmp_path / "j.ckpt", device="cpu")


def test_bf16_trainer_loads_the_vqgan_in_bfloat16(tmp_path, monkeypatch):
    vae = _vaes()["VQGanVAE"]
    paths = write_pretrained_files(tmp_path / "w", vae)
    write_caption_folder(tmp_path / "data", 4, 16, seed=2)
    seen = {}
    dispatch = train_dalle.DalleTrainer.dispatch

    def spy(self, text, tokens, *a, **k):
        seen["vae_dtype"], seen["dalle_dtype"] = self.vae.dtype, self.dalle.dtype
        return dispatch(self, text, tokens, *a, **k)

    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", spy)
    monkeypatch.chdir(tmp_path)
    train_dalle.main(["--image_text_folder", "data", "--taming", "--vqgan_config_path",
                      paths["vqgan_config_path"], "--vqgan_model_path", paths["vqgan_model_path"],
                      "--bf16", "--dim", "32", "--depth", "1", "--heads", "2", "--dim_head", "16",
                      "--text_seq_len", "8", "--truncate_captions", "--epochs", "1",
                      "--batch_size", "4"], device="cpu")
    assert seen == {"vae_dtype": torch.bfloat16, "dalle_dtype": torch.bfloat16}
    _, meta = load_checkpoint(tmp_path / "dalle.ckpt")
    assert meta["vae_config"]["dtype"] == "bfloat16" and meta["config"]["dtype"] == "bfloat16"
