"""The port's taming VQGAN (``models/vqgan.py``) against JAX's on the same
weights, at the configuration of JAX's ``tests/test_vqgan.py`` (16-pixel
images, ch 32, ch_mult (1, 2), one ResNet block a level, attention at
8 x 8, z 64, 24 codebook entries of 64), on the CPU:

- encode indices equal to JAX's, for ``VQQuantizer`` and the Gumbel
  variant, and the latents ``quant_conv`` gives within 1e-5 relative;
- ``decode``'s pixels within 1e-5 relative (float32) and in [0, 1];
- the asymmetric (0, 1, 0, 1) pad before the stride-2 conv;
- the f=16 sequence cut (256 tokens at 256 px);
- ``read_model_yaml`` against JAX's reader and ``yaml.safe_load`` on
  taming's format, and ``load_vqgan_vae`` on a ``last.ckpt`` holding a
  loss head it must drop, then the typed refusal of a missing file;
- bfloat16 latents and pixels within ``testing.BF16_GAP_FACTOR`` of
  JAX's own bfloat16-to-float32 gap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from dalle_pytorch_tpu.models import vqgan as jq
from dalle_pytorch_tpu_torch import convert
from dalle_pytorch_tpu_torch.models.pretrained import MissingWeights
from dalle_pytorch_tpu_torch.models.vqgan import (
    VQGanVAE,
    checkpoint_state_dict,
    load_vqgan_vae,
    read_model_yaml,
)
from dalle_pytorch_tpu_torch.testing import (
    BF16_GAP_FACTOR,
    gap_ratio,
    rel_l2,
    write_model_yaml,
    write_pretrained_files,
)

CFG = dict(image_size=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           z_channels=64, n_embed=24, embed_dim=64)


def _port(seed=0, **kw):
    vae = VQGanVAE(**{**CFG, **kw}, device="cpu").init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # keep most pixels off the clamp at +-1
        vae.decoder.conv_out.weight.mul_(0.2)
    return vae


def _images(n, seed=1):
    return np.random.RandomState(seed).rand(n, 16, 16, 3).astype(np.float32)


def _latents(m, x):
    return m.quant_conv(m.encoder((2.0 * x - 1.0).astype(m.dtype)))


@pytest.fixture(scope="module", params=["vq", "gumbel"])
def models(request):
    kw = {"gumbel": True} if request.param == "gumbel" else {}
    port = _port(**kw)
    return port, jq.VQGanVAE(**CFG, **kw), convert.vqgan_params(port.state_dict())


def test_encode_indices_equal_jax(models):
    port, jvae, params = models
    img = _images(4)
    ours = port.get_codebook_indices(torch.from_numpy(img))
    theirs = jvae.apply({"params": params}, jnp.asarray(img), method="get_codebook_indices")
    assert ours.shape == (4, port.image_seq_len) == (4, 64)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    lat = port.encode_latents(torch.from_numpy(img)).permute(0, 2, 3, 1)
    jlat = jvae.apply({"params": params}, jnp.asarray(img), method=_latents)
    assert rel_l2(lat, torch.from_numpy(np.array(jlat))) < 1e-5


def test_decode_within_1e5_of_jax(models):
    port, jvae, params = models
    seq = np.random.RandomState(2).randint(0, CFG["n_embed"], (3, port.image_seq_len))
    ours = port.decode(torch.from_numpy(seq)).numpy()
    theirs = np.asarray(jvae.apply({"params": params}, jnp.asarray(seq), method="decode"))
    assert ours.shape == (3, 16, 16, 3) and ours.dtype == np.float32
    assert (ours >= 0).all() and (ours <= 1).all()
    live = (theirs > 0) & (theirs < 1)
    assert live.mean() > 0.5  # most pixels are off the clamp
    assert rel_l2(torch.from_numpy(ours), torch.from_numpy(theirs)) < 1e-5
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


def test_the_downsample_pads_right_and_bottom_only():
    port = _port()
    level = port.encoder.down[0]
    h = torch.randn(2, 32, 16, 16, generator=torch.Generator().manual_seed(5))
    conv = level.downsample.conv
    out = conv(F.pad(h, (0, 1, 0, 1)))
    assert out.shape == (2, 32, 8, 8)
    theirs = jax.lax.conv_general_dilated(
        jnp.asarray(h.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(conv.weight.permute(2, 3, 1, 0).detach().numpy()), (2, 2),
        [(0, 1), (0, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + conv.bias.detach().numpy()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(theirs),
                               atol=1e-5)
    symmetric = F.conv2d(h, conv.weight, conv.bias, stride=2, padding=1)
    assert not torch.allclose(out, symmetric, atol=1e-3)


def test_f16_cuts_the_sequence_to_256():
    vae = VQGanVAE(device="meta")
    assert (vae.num_layers, vae.fmap_size, vae.image_seq_len, vae.num_tokens) == (4, 16, 256, 1024)
    assert vae.normalization is None
    with pytest.raises(NotImplementedError, match="frozen"):
        vae(torch.zeros(1, 256, 256, 3, device="meta"))


TAMING_YAML = """
model:
  base_learning_rate: 4.5e-06
  target: taming.models.vqgan.{target}
  params:
    embed_dim: 256
    n_embed: 1024
    ddconfig:
      double_z: false
      z_channels: 256
      resolution: 256
      in_channels: 3
      out_ch: 3
      ch: 128
      ch_mult: [1, 1, 2, 2, 4]
      num_res_blocks: 2
      attn_resolutions: [16]
      dropout: 0.0
    lossconfig:
      target: taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator
      params: {{disc_start: 250001, disc_weight: 0.8, codebook_weight: 1.0}}
"""


@pytest.mark.parametrize("target", ["VQModel", "GumbelVQ"])
def test_config_reader_equals_jax_and_safe_load(target, tmp_path):
    path = tmp_path / "model.yaml"
    path.write_text(TAMING_YAML.format(target=target))
    ours = read_model_yaml(str(path))
    assert ours == jq._ddconfig_from_yaml(str(path))
    params = yaml.safe_load(path.read_text())["model"]["params"]
    assert ours == (params["ddconfig"], 1024, 256, target == "GumbelVQ")
    vae = VQGanVAE(device="meta", gumbel=target == "GumbelVQ")
    write_model_yaml(tmp_path / "ours.yaml", vae)
    dd, n_embed, embed_dim, gumbel = read_model_yaml(str(tmp_path / "ours.yaml"))
    assert (dd["ch_mult"], dd["attn_resolutions"], n_embed, embed_dim, gumbel) == (
        [1, 1, 2, 2, 4], [16], 1024, 256, target == "GumbelVQ")
    assert {k: dd[k] for k in params["ddconfig"]} == params["ddconfig"]


def test_loader_drops_the_loss_head_and_refuses_missing_files(tmp_path):
    port = _port(seed=3)
    paths = write_pretrained_files(tmp_path / "w", port)
    ckpt = torch.load(paths["vqgan_model_path"], weights_only=False)
    ckpt["state_dict"]["loss.discriminator.main.0.weight"] = torch.zeros(4, 3, 4, 4)
    ckpt["state_dict"]["loss.logvar"] = torch.zeros(())
    torch.save(ckpt, paths["vqgan_model_path"])
    assert set(checkpoint_state_dict(ckpt["state_dict"])) == set(port.state_dict())
    loaded = load_vqgan_vae(paths["vqgan_config_path"], paths["vqgan_model_path"], device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in port.state_dict().items())
    img = torch.from_numpy(_images(2, seed=4))
    assert torch.equal(loaded.get_codebook_indices(img), port.get_codebook_indices(img))
    # JAX's converter takes the same file to the same tree
    from dalle_pytorch_tpu.models.pretrained import load_torch_checkpoint

    theirs = jq.convert_vqgan_checkpoint(load_torch_checkpoint(paths["vqgan_model_path"]))
    jparams = jax.tree_util.tree_map(np.asarray, theirs)
    ours = convert.vqgan_params(port.state_dict())
    assert jax.tree_util.tree_structure(jparams) == jax.tree_util.tree_structure(ours)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(jparams),
                                                    jax.tree_util.tree_leaves(ours)))
    for which, flag in (("vqgan_config_path", "--vqgan_config_path"),
                        ("vqgan_model_path", "--vqgan_model_path")):
        for missing in (None, str(tmp_path / "nowhere")):
            args = {**paths, which: missing}
            with pytest.raises(MissingWeights, match=f"{flag}.*never downloaded"):
                load_vqgan_vae(args["vqgan_config_path"], args["vqgan_model_path"], device="cpu")


def test_bf16_within_the_gap_factor_of_jax():
    port32 = _port(seed=5)
    port16 = _port(seed=5)
    port16.dtype = torch.bfloat16
    params = convert.vqgan_params(port32.state_dict())
    j32, j16 = jq.VQGanVAE(**CFG), jq.VQGanVAE(**CFG, dtype=jnp.bfloat16)
    img = _images(4, seed=6)
    lat = port16.encode_latents(torch.from_numpy(img)).float().permute(0, 2, 3, 1)
    assert lat.dtype == torch.float32 and port16.encode_latents(
        torch.from_numpy(img)).dtype == torch.bfloat16
    jl16, jl32 = (torch.from_numpy(np.asarray(m.apply({"params": params}, jnp.asarray(img),
                                                      method=_latents), np.float32))
                  for m in (j16, j32))
    assert gap_ratio(lat, jl16, jl32) <= BF16_GAP_FACTOR
    seq = np.random.RandomState(7).randint(0, CFG["n_embed"], (3, 64))
    pix = port16.decode(torch.from_numpy(seq))
    jp16, jp32 = (torch.from_numpy(np.asarray(m.apply({"params": params}, jnp.asarray(seq),
                                                      method="decode")))
                  for m in (j16, j32))
    assert pix.dtype == torch.float32
    assert gap_ratio(pix, jp16, jp32) <= BF16_GAP_FACTOR
