"""The port's engine serving a DALLE at a pretrained VQGAN's geometry, with
the VQGAN's decode and CLIP's rerank as its post-decode stages, against
the JAX package's staged engine on the CPU.

The VQGAN is JAX's ``tests/test_vqgan.py`` configuration (16 px, f=2:
an 8 x 8 grid of 24 codes, the f=16 model's ratio of grid to pixels
scaled down); the DALLE (dim 32, depth 2, 2 heads of 16, text 4) takes
its image vocabulary and grid from it, and CLIP reranks at 8 px. JAX's
models run on the port's weights, converted. Served greedy (top-k keeps
one logit) by the split path (``EngineConfig()``, JAX's default) and the
fused iteration, pages of 16 (``DALLE_TPU_KV_PAGE_SIZE`` for JAX):

- every outcome COMPLETED, the tokens equal JAX's, 64 of them;
- the images (16, 16, 3) in [0, 1] within 1e-5 of JAX's: the VQGAN's
  decode is already in display space, and the stage hands it to CLIP as
  JAX's does;
- the rerank scores within 1e-5 (``tests/test_torch_postdecode.py``'s);
- nothing in the engine, its pools or its stages assumes the dVAE's
  1,024 tokens or a 32 x 32 grid: the pages a request holds follow
  ``image_seq_len``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import CLIP as JCLIP
from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import vqgan as jq
from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Outcome as JOutcome
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.serving import StageSpec as JStageSpec
from dalle_pytorch_tpu_torch.convert import clip_state_dict, dalle_state_dict, vqgan_params
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vqgan import VQGanVAE
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.postdecode import StageSpec
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_generate_cli import perturbed

torch.set_num_threads(1)

VQGAN = dict(image_size=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             z_channels=64, n_embed=24, embed_dim=64)
MODEL = dict(dim=32, depth=2, num_text_tokens=16, text_seq_len=4, num_image_tokens=24,
             image_fmap_size=8, heads=2, dim_head=16)
CLIP_CONFIG = dict(dim_text=16, dim_image=16, dim_latent=16, num_text_tokens=16,
                   text_enc_depth=1, text_seq_len=4, text_heads=2, text_dim_head=8,
                   num_visual_tokens=24, visual_enc_depth=1, visual_heads=2, visual_dim_head=8,
                   visual_image_size=8, visual_patch_size=4)
GREEDY = 0.99  # k = max(int(0.01 * 40 logits), 1) = 1
PAGE = 16
PATHS = {"split": {}, "fused": {"fused_iteration": True, "prefill_chunk": 2}}


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


@pytest.fixture(scope="module")
def models():
    """(JAX dalle, params, JAX StageSpec, port DALLE, port StageSpec)."""
    vae = VQGanVAE(**VQGAN, device="cpu").init_weights(torch.Generator().manual_seed(11))
    with torch.no_grad():
        vae.decoder.conv_out.weight.mul_(0.2)
    jvae = jq.VQGanVAE(**VQGAN)
    jdalle = JDALLE(**MODEL)
    params = perturbed(jdalle.init(jax.random.key(0), jnp.ones((1, 4), jnp.int32),
                                   jnp.zeros((1, 64), jnp.int32))["params"], 1)
    dalle = DALLE(**MODEL, device="cpu")
    dalle.load_state_dict(dalle_state_dict(params))
    jclip = JCLIP(**CLIP_CONFIG)
    cparams = perturbed(jclip.init(jax.random.key(2), jnp.ones((1, 4), jnp.int32),
                                   jnp.zeros((1, 8, 8, 3)))["params"], 3)
    clip = CLIP(**CLIP_CONFIG, device="cpu")
    clip.load_state_dict(clip_state_dict(cparams))
    jstages = JStageSpec(jvae, vqgan_params(vae.state_dict()), jclip, cparams)
    return jdalle, params, jstages, dalle, StageSpec(vae, clip)


def prompt(i):
    p = np.random.RandomState(200 + i).randint(1, 16, size=(4,)).astype(np.int32)
    p[4 - i % 3:] = 0
    return p


@pytest.mark.parametrize("path", sorted(PATHS))
def test_vqgan_staged_engine_matches_jax(models, path, monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    jdalle, params, jstages, dalle, stages = models
    cfg = dict(max_batch=2, filter_thres=GREEDY, **PATHS[path])
    jeng = JEngine(jdalle, params, JEngineConfig(**cfg), clock=JFakeClock(step_dt=0.05),
                   stages=jstages)
    eng = Engine(dalle, EngineConfig(page_size=PAGE, **cfg), clock=FakeClock(step_dt=0.05),
                 device="cpu", stages=stages)
    n = dalle.image_seq_len
    for i in range(3):
        assert jeng.submit(JRequest(f"r{i}", prompt(i), n, seed=i)) is None
        assert eng.submit(Request(f"r{i}", prompt(i), n, seed=i)) is None
    ref, got = jeng.run(max_steps=2000), eng.run(max_steps=2000)
    for i in range(3):
        r, g = ref[f"r{i}"], got[f"r{i}"]
        assert r.outcome is JOutcome.COMPLETED and g.outcome is Outcome.COMPLETED
        assert len(g.tokens) == n == 64
        np.testing.assert_array_equal(g.tokens, r.tokens)
        assert g.image.shape == r.image.shape == (16, 16, 3)
        assert g.image.min() >= 0 and g.image.max() <= 1
        np.testing.assert_allclose(g.image, r.image, atol=1e-5, rtol=0)
        assert abs(g.rerank_score - r.rerank_score) <= 1e-5
    assert eng.counters.get("serve.stage.vae_images") == 3
    assert eng.counters.get("serve.stage.reranked") == 3
    # a request's pages cover its own sequence: text + 64 image tokens
    assert eng.n_pages_slot == -(-(dalle.text_len_internal + n) // PAGE) == 5
    assert not eng.postdecode and not any(eng.slots) and eng.pool.used == 0
