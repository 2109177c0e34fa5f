"""The port's CLIP similarity against the JAX package's CLIP on the CPU in
float32, on converted weights (every leaf perturbed), with prompts padded
by zeros so the key mask text != 0 matters: at a text length the JAX side
runs through its packed-qkv kernel in interpret mode (text_seq_len 128,
2 heads of 64; the port's plain version) and at the canonical tiny CLIP
(dense attention on both sides). Similarities agree to atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu_torch.convert import clip_state_dict
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# kernel-eligible text: _flash_block(128) == 128 and fused_qkv_supported
KERNEL_TEXT = dict(
    dim_text=64, dim_image=32, dim_latent=16, num_text_tokens=50,
    text_enc_depth=2, text_seq_len=128, text_heads=2, text_dim_head=64,
    visual_enc_depth=2, visual_heads=2, visual_dim_head=16,
    visual_image_size=16, visual_patch_size=4,
)
# tools/lint/trace/registry.py:CANON_CLIP
CANON = dict(
    dim_text=16, dim_image=16, dim_latent=16, num_text_tokens=16,
    text_enc_depth=1, text_seq_len=4, text_heads=2, text_dim_head=8,
    num_visual_tokens=12, visual_enc_depth=1, visual_heads=2,
    visual_dim_head=8, visual_image_size=4, visual_patch_size=2,
)


def converted(config, seed=0):
    """(JAX CLIP, its perturbed params, the converted port CLIP)."""
    jclip = JCLIP(**config)
    size = config["visual_image_size"]
    params = jclip.init(
        jax.random.key(seed), jnp.ones((1, config["text_seq_len"]), jnp.int32),
        jnp.zeros((1, size, size, 3), jnp.float32),
    )["params"]
    rng = np.random.RandomState(seed)
    noise = lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32)  # noqa: E731
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * noise(a)) + 0.02 * noise(a), params,
    )
    model = CLIP(**config, device="cpu")
    model.load_state_dict(clip_state_dict(params))
    return jclip, params, model


def inputs(config, b=3, seed=1):
    rng = np.random.RandomState(seed)
    L = config["text_seq_len"]
    text = rng.randint(1, config["num_text_tokens"], size=(b, L)).astype(np.int32)
    for i in range(b):
        text[i, L - (i * L) // (b + 1):] = 0  # ragged zero padding
    size = config["visual_image_size"]
    image = rng.randn(b, size, size, 3).astype(np.float32)
    return text, image


@pytest.mark.parametrize("config", [KERNEL_TEXT, CANON], ids=["kernel_text", "canon"])
def test_similarity_matches_jax(config):
    jclip, params, model = converted(config)
    text, image = inputs(config)
    ref = jclip.apply({"params": params}, jnp.asarray(text), jnp.asarray(image),
                      text_mask=jnp.asarray(text != 0))
    t = torch.from_numpy(text).long()
    before = fa.fused_qkv_attention.launches
    with torch.no_grad():
        got = model(t, torch.from_numpy(image), text_mask=t != 0)
    assert fa.fused_qkv_attention.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
