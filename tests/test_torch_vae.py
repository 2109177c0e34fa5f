"""The port's DiscreteVAE against the JAX package on the CPU, on
converted weights: image_size 32, 2 layers, hidden 16, with and without a
ResBlock; NHWC, float32. Decode to atol 1e-4 (pins the flax
ConvTranspose ("SAME", unflipped kernel) -> nn.ConvTranspose2d(padding=1,
flipped kernel) conversion numerically); encoder logits to atol 1e-5 and
the codebook indices identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.models.vae import denormalize as j_denormalize
from dalle_pytorch_tpu_torch.convert import vae_state_dict
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE, denormalize

torch.set_num_threads(1)


@pytest.mark.parametrize("resblocks", [1, 0])
def test_decode_matches_reference(resblocks):
    cfg = dict(image_size=32, num_layers=2, num_resnet_blocks=resblocks,
               hidden_dim=16, num_tokens=20, codebook_dim=8)
    jvae = JVAE(**cfg)
    params = jvae.init(
        {"params": jax.random.key(0), "gumbel": jax.random.key(1)},
        jnp.zeros((1, 32, 32, 3)),
    )["params"]
    rng = np.random.RandomState(resblocks)
    tokens = rng.randint(0, 20, size=(2, 64)).astype(np.int32)
    ref = np.asarray(jvae.apply({"params": params}, jnp.asarray(tokens),
                                method=JVAE.decode))

    vae = DiscreteVAE(**cfg, device="cpu")
    vae.load_state_dict(vae_state_dict(jax.device_get(params)))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(denormalize(torch.from_numpy(got)).numpy(),
                               j_denormalize(ref), atol=1e-4)


@pytest.mark.parametrize("resblocks", [1, 0])
def test_encode_matches_reference(resblocks):
    cfg = dict(image_size=32, num_layers=2, num_resnet_blocks=resblocks,
               hidden_dim=16, num_tokens=20, codebook_dim=8)
    jvae = JVAE(**cfg)
    params = jvae.init(
        {"params": jax.random.key(2), "gumbel": jax.random.key(3)},
        jnp.zeros((1, 32, 32, 3)),
    )["params"]
    img = np.random.RandomState(resblocks).rand(2, 32, 32, 3).astype(np.float32)
    ref_logits = np.asarray(jvae.apply({"params": params}, jnp.asarray(img),
                                       method=JVAE.encode_logits))
    ref_ids = np.asarray(jvae.apply({"params": params}, jnp.asarray(img),
                                    method=JVAE.get_codebook_indices))

    vae = DiscreteVAE(**cfg, device="cpu")
    vae.load_state_dict(vae_state_dict(jax.device_get(params)))
    with torch.no_grad():
        logits = vae.encode_logits(torch.from_numpy(img)).numpy()
    ids = vae.get_codebook_indices(torch.from_numpy(img)).numpy()
    assert logits.shape == ref_logits.shape == (2, 8, 8, 20)
    np.testing.assert_allclose(logits, ref_logits, atol=1e-5, rtol=0)
    assert ids.shape == (2, 64)
    np.testing.assert_array_equal(ids, ref_ids)
