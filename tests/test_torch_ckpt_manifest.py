"""The published checkpoints' manifests against the port (the
``openai_dvae_encoder``, ``openai_dvae_decoder`` and ``vqgan_f16_1024``
inventories of ``tools/gen_ckpt_manifests.py``):

- the port's copies under ``dalle_pytorch_tpu_torch/models/
  ckpt_manifests/`` are byte-equal to JAX's, and the port reads its own;
- a seeded state dict in each manifest's shapes loads into the port's
  full-size wrapper with ``load_state_dict(strict=True)``: every key is
  used, none is missing;
- the flax trees JAX's converters make of that state dict convert into
  the port's modules to the same tensors, and back;
- one forward of each full-size wrapper at 32 px on those weights (the
  sizes JAX's own runs of them mark slow are not run here)."""

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import pretrained as jp
from dalle_pytorch_tpu.models import vqgan as jq
from dalle_pytorch_tpu_torch import convert
from dalle_pytorch_tpu_torch.models.pretrained import OpenAIDiscreteVAE
from dalle_pytorch_tpu_torch.models.vqgan import VQGanVAE
from dalle_pytorch_tpu_torch.testing import MANIFESTS, manifest, manifest_state_dict

from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PARTS = {"openai_dvae_encoder": "enc", "openai_dvae_decoder": "dec"}


@pytest.mark.parametrize("name", MANIFESTS)
def test_the_port_copy_is_byte_equal_to_jax(name):
    ours = REPO / "dalle_pytorch_tpu_torch/models/ckpt_manifests" / f"{name}.json"
    theirs = REPO / "dalle_pytorch_tpu/models/ckpt_manifests" / f"{name}.json"
    assert ours.read_bytes() == theirs.read_bytes()
    assert manifest(name) == __import__("json").loads(ours.read_text())


def _inventory(name):
    m = manifest(name)
    return m["state_dict"] if "state_dict" in m else m


@pytest.fixture(scope="module")
def openai():
    vae = OpenAIDiscreteVAE(device="cpu")
    sds = {}
    for name, part in PARTS.items():
        sds[part] = manifest_state_dict(_inventory(name), seed=len(part))
        getattr(vae, part).load_state_dict(sds[part], strict=True)
    return vae, sds


@pytest.fixture(scope="module")
def vqgan():
    sd = manifest_state_dict(_inventory("vqgan_f16_1024"), seed=5)
    vae = VQGanVAE(device="cpu")
    vae.load_state_dict(sd, strict=True)
    return vae, sd


@pytest.mark.parametrize("name", list(PARTS))
def test_openai_manifest_loads_strict_and_converts_like_jax(openai, name):
    vae, sds = openai
    part = PARTS[name]
    sd = sds[part]
    own = getattr(vae, part).state_dict()
    assert set(own) == set(_inventory(name)) == set(sd)
    assert all(torch.equal(own[k], sd[k]) for k in sd)
    convert_jax = jp.convert_openai_encoder if part == "enc" else jp.convert_openai_decoder
    tree = convert_jax({k: v.numpy() for k, v in sd.items()})
    ours = convert.openai_vae_state_dict({part: jax.tree_util.tree_map(np.asarray, tree)})
    assert set(ours) == {f"{part}.{k}" for k in sd}
    assert all(torch.equal(ours[f"{part}.{k}"], v) for k, v in sd.items())
    back = convert.openai_vae_params({f"{part}.{k}": v for k, v in sd.items()})[part]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)))


def test_vqgan_manifest_loads_strict_and_converts_like_jax(vqgan):
    vae, sd = vqgan
    m = manifest("vqgan_f16_1024")
    assert set(vae.state_dict()) == set(m["state_dict"]) == set(sd)
    dd = m["config"]["ddconfig"]
    assert (vae.ch, list(vae.ch_mult), vae.num_res_blocks, list(vae.attn_resolutions),
            vae.z_channels, vae.n_embed, vae.embed_dim) == (
        dd["ch"], dd["ch_mult"], dd["num_res_blocks"], dd["attn_resolutions"],
        dd["z_channels"], m["config"]["n_embed"], m["config"]["embed_dim"])
    tree = jq.convert_vqgan_checkpoint({k: v.numpy() for k, v in sd.items()})
    ours = convert.vqgan_state_dict(jax.tree_util.tree_map(np.asarray, tree))
    assert set(ours) == set(sd)
    assert all(torch.equal(ours[k], v) for k, v in sd.items())
    back = convert.vqgan_params(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)))


@pytest.mark.parametrize("kind", ["openai", "vqgan"])
def test_full_size_wrapper_runs_at_32_px(kind, openai, vqgan):
    vae = (openai if kind == "openai" else vqgan)[0]
    img = torch.from_numpy(np.random.RandomState(6).rand(1, 32, 32, 3).astype(np.float32))
    ids = vae.get_codebook_indices(img)
    f = 32 // 2**vae.num_layers
    assert ids.shape == (1, f * f)
    assert int(ids.min()) >= 0 and int(ids.max()) < vae.num_tokens
    pix = vae.decode(ids)
    assert pix.shape == (1, 32, 32, 3) and torch.isfinite(pix).all()
    assert float(pix.min()) >= 0 and float(pix.max()) <= 1
