"""The port's OpenAI dVAE (``models/pretrained.py``) against JAX's on the
same weights, at JAX's small test sizes (``tests/test_pretrained.py``:
n_hid 8, a vocabulary of 16, 2 blocks a group, 16-pixel images), on the
CPU in float32:

- the encoder's logits and the decoder's statistics within JAX's own
  2e-5 (``tests/test_pretrained.py:181-183``);
- the wrapper's ``get_codebook_indices`` equal to JAX's and ``decode``'s
  pixels within 1e-5, in [0, 1];
- the decoder's one-hot input conv bitwise its gather (``from_tokens``);
- ``load_torch_checkpoint`` on a whole-module pickle whose classes were
  then removed, and on a ``{"state_dict": ...}`` pickle;
- ``map_pixels`` / ``unmap_pixels``, the frozen ``__call__``, and the
  typed refusal of a missing weight path (``MissingWeights``, never a
  download)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import pretrained as jp
from dalle_pytorch_tpu_torch import convert
from dalle_pytorch_tpu_torch.models import pretrained
from dalle_pytorch_tpu_torch.models.pretrained import (
    MissingWeights,
    OpenAIDecoder,
    OpenAIDiscreteVAE,
    OpenAIEncoder,
    load_openai_vae,
    load_torch_checkpoint,
)
from dalle_pytorch_tpu_torch.testing import write_module_pickle, write_pretrained_files

N_HID, VOCAB, BLKS = 8, 16, 2
WRAPPER = dict(image_size=16, num_layers=3, num_tokens=VOCAB, n_hid=N_HID)


def _seeded(module, seed):
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for m in module.modules():
            if isinstance(m, pretrained.OAIConv):
                m.w.normal_(generator=g).mul_((m.w.shape[1] * m.kw**2) ** -0.5)
                m.b.normal_(generator=g).mul_(0.1)
    return module


def _images(n, size=16, seed=1):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


@pytest.fixture(scope="module")
def vae():
    """(port wrapper, JAX wrapper, JAX params of the same weights)."""
    port = _seeded(OpenAIDiscreteVAE(**WRAPPER, device="cpu"), 0)
    return port, jp.OpenAIDiscreteVAE(**WRAPPER), convert.openai_vae_params(port.state_dict())


def test_encoder_logits_equal_jax():
    enc = _seeded(OpenAIEncoder(n_hid=N_HID, vocab_size=VOCAB, n_blk_per_group=BLKS,
                                device="cpu"), 3)
    params = convert.openai_vae_params({f"enc.{k}": v for k, v in enc.state_dict().items()})
    x = _images(2, seed=4)
    with torch.no_grad():
        ours = enc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    theirs = jp.OpenAIEncoder(n_hid=N_HID, vocab_size=VOCAB, n_blk_per_group=BLKS).apply(
        {"params": params["enc"]}, jnp.asarray(x))
    assert ours.shape == (2, 2, 2, VOCAB)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=2e-5, rtol=2e-5)


def test_decoder_stats_equal_jax():
    dec = _seeded(OpenAIDecoder(n_init=8, n_hid=N_HID, vocab_size=VOCAB, n_blk_per_group=BLKS,
                                device="cpu"), 5)
    params = convert.openai_vae_params({f"dec.{k}": v for k, v in dec.state_dict().items()})
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, VOCAB, (2, 2, 2)))
    z = torch.nn.functional.one_hot(ids, VOCAB).float()  # (b, f, f, vocab)
    with torch.no_grad():
        ours = dec(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    theirs = jp.OpenAIDecoder(n_init=8, n_hid=N_HID, vocab_size=VOCAB,
                              n_blk_per_group=BLKS).apply({"params": params["dec"]},
                                                          jnp.asarray(z.numpy()))
    assert ours.shape == (2, 16, 16, 6)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=2e-5, rtol=2e-5)


def test_codebook_indices_equal_jax(vae):
    port, jvae, params = vae
    img = _images(4, seed=7)
    ours = port.get_codebook_indices(torch.from_numpy(img))
    theirs = jvae.apply({"params": params}, jnp.asarray(img), method="get_codebook_indices")
    assert ours.shape == (4, port.image_seq_len) == (4, 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_decode_pixels_within_1e5_of_jax(vae):
    port, jvae, params = vae
    seq = np.random.RandomState(8).randint(0, VOCAB, (3, 4))
    ours = port.decode(torch.from_numpy(seq)).numpy()
    theirs = np.asarray(jvae.apply({"params": params}, jnp.asarray(seq), method="decode"))
    assert ours.shape == (3, 16, 16, 3) and ours.dtype == np.float32
    assert (ours >= 0).all() and (ours <= 1).all()
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_one_hot_input_conv_is_bitwise_its_gather(vae):
    port = vae[0]
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, VOCAB, (3, 2, 2)))
    one_hot = torch.nn.functional.one_hot(ids, VOCAB).float().permute(0, 3, 1, 2)
    with torch.no_grad():
        conv = port.dec.blocks.input(one_hot)
        gather = port.dec.embed_tokens(ids, torch.float32)
        assert torch.equal(conv, gather)
        assert torch.equal(port.dec(one_hot), port.dec.from_tokens(ids, torch.float32))


def test_whole_module_pickle_without_its_classes_loads(vae, tmp_path):
    port = vae[0]
    write_module_pickle(port.enc, tmp_path / "encoder.pkl")
    raw = (tmp_path / "encoder.pkl").read_bytes()
    assert b"dall_e" in raw  # the classes it names are not importable
    with pytest.raises(ModuleNotFoundError):
        torch.load(tmp_path / "encoder.pkl", weights_only=False)
    sd = load_torch_checkpoint(str(tmp_path / "encoder.pkl"))
    assert set(sd) == set(port.enc.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in port.enc.state_dict().items())
    # JAX's reader takes the same file to the same weights
    theirs = jp.load_torch_checkpoint(str(tmp_path / "encoder.pkl"))
    assert all(np.array_equal(theirs[k], v.numpy()) for k, v in sd.items())


def test_state_dict_pickle_loads(vae, tmp_path):
    port = vae[0]
    torch.save({"state_dict": port.dec.state_dict()}, tmp_path / "decoder.pkl")
    sd = load_torch_checkpoint(str(tmp_path / "decoder.pkl"))
    fresh = OpenAIDiscreteVAE(**WRAPPER, device="cpu")
    fresh.dec.load_state_dict(sd, strict=True)
    assert all(torch.equal(fresh.dec.state_dict()[k], v) for k, v in port.dec.state_dict().items())


def test_loader_reads_the_published_kinds_of_file(vae, tmp_path):
    """``load_openai_vae`` on whole-module pickles of the full-width
    wrapper's parts; the small wrapper's files load into it the same way
    through ``load_state_dict(strict=True)``."""
    port = vae[0]
    paths = write_pretrained_files(tmp_path, port)
    enc = load_torch_checkpoint(paths["openai_enc_path"])
    fresh = OpenAIDiscreteVAE(**WRAPPER, device="cpu")
    fresh.enc.load_state_dict(enc, strict=True)
    fresh.dec.load_state_dict(load_torch_checkpoint(paths["openai_dec_path"]), strict=True)
    img = torch.from_numpy(_images(2, seed=10))
    assert torch.equal(fresh.get_codebook_indices(img), port.get_codebook_indices(img))
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_openai_vae(paths["openai_enc_path"], paths["openai_dec_path"], device="meta")


def test_pixel_maps_equal_jax():
    x = np.random.RandomState(11).rand(2, 8, 8, 3).astype(np.float32)
    ours = pretrained.map_pixels(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jp.map_pixels(jnp.asarray(x))))
    y = np.random.RandomState(12).randn(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(pretrained.unmap_pixels(torch.from_numpy(y)).numpy(),
                                  np.asarray(jp.unmap_pixels(jnp.asarray(y))))
    np.testing.assert_allclose(pretrained.unmap_pixels(ours).numpy(), x, atol=1e-6)
    assert pretrained.unmap_pixels(torch.tensor([-5.0, 5.0])).tolist() == [0.0, 1.0]


def test_surface_and_frozen_call(vae):
    port = vae[0]
    assert (port.fmap_size, port.image_seq_len, port.num_tokens, port.image_size) == (2, 4, 16, 16)
    assert port.normalization is None and OpenAIDiscreteVAE.normalization is None
    assert not any(p.requires_grad for p in port.parameters())
    full = OpenAIDiscreteVAE(device="meta")
    assert (full.fmap_size, full.image_seq_len, full.num_tokens) == (32, 1024, 8192)
    with pytest.raises(NotImplementedError, match="frozen"):
        port(torch.zeros(1, 16, 16, 3))


@pytest.mark.parametrize("which", ["enc", "dec"])
def test_missing_weight_path_is_refused_typed(which, tmp_path):
    there = tmp_path / "there.pkl"
    there.write_bytes(b"")
    flag = {"enc": "--openai_enc_path", "dec": "--openai_dec_path"}[which]
    for missing in (None, str(tmp_path / "nowhere.pkl")):
        paths = {"enc": str(there), "dec": str(there), which: missing}
        with pytest.raises(MissingWeights, match=f"{flag}.*never downloaded"):
            load_openai_vae(paths["enc"], paths["dec"], device="cpu")
    assert issubclass(MissingWeights, FileNotFoundError)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["there.pkl"]
