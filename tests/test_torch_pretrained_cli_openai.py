"""The trainer command line with the OpenAI dVAE (the default when neither
``--vae_path`` nor ``--taming`` is given), the port's against the
repository's ``train_dalle.py`` on the CPU, float32.

Both loaders build the published geometry (256 px, n_hid 256, 8,192
codes, a 32 x 32 grid), so the files are full size: OpenAI's
``encoder.pkl`` / ``decoder.pkl`` kinds (whole-module pickles whose
classes are gone) of seeded weights. 4 PNGs of 256 px, batch 4, one
epoch (one step) of a tiny DALLE from JAX's pre-flight params:

- the loss within rtol 1e-5 (``tests/test_torch_train_cli.py``'s), on
  the 1,024 tokens a 256 px image gives;
- the checkpoint stores ``OpenAIDiscreteVAE`` by class and config (JAX's
  meta) and no VAE weights, and each reader reads the other's file, the
  dVAE from the weight paths;
- without ``--openai_enc_path`` the port refuses with ``MissingWeights``
  naming the flag (JAX would download), before any file is written."""

import jax
import numpy as np
import pytest
import torch

import dalle_pytorch_tpu.parallel as j_parallel
from dalle_pytorch_tpu.models.factory import dalle_from_checkpoint as j_dalle_from_checkpoint
from dalle_pytorch_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict, openai_vae_params
from dalle_pytorch_tpu_torch.models.factory import dalle_from_checkpoint
from dalle_pytorch_tpu_torch.models import dalle as port_dalle
from dalle_pytorch_tpu_torch.models.pretrained import MissingWeights, OpenAIDiscreteVAE
from dalle_pytorch_tpu_torch.testing import (
    reset_registries,
    write_caption_folder,
    write_pretrained_files,
)
from test_torch_pretrained_cli import MODEL_FLAGS, _run_jax

torch.set_num_threads(2)

RUN_FLAGS = ["--epochs", "1", "--batch_size", "4", "--random_resize_crop_lower_ratio", "1.0"]


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("openai")
    write_caption_folder(work / "data", 4, 256, seed=5)
    vae = OpenAIDiscreteVAE(device="cpu").init_weights(torch.Generator().manual_seed(9))
    paths = write_pretrained_files(work / "dvae", vae)
    del vae
    common = ["--image_text_folder", str(work / "data"), *MODEL_FLAGS,
              "--openai_enc_path", paths["openai_enc_path"],
              "--openai_dec_path", paths["openai_dec_path"]]
    _run_jax([*common, "--epochs", "0", "--dalle_output_file_name", str(work / "pre")], [])
    _, pre, _, _, _ = j_dalle_from_checkpoint(str(work / "pre.ckpt"), vae_weight_paths=paths)
    pre_sd = dalle_state_dict(jax.device_get(pre))
    jax_losses, port_losses, tokens = [], [], {}

    mp = pytest.MonkeyPatch()
    _run_jax([*common, *RUN_FLAGS, "--dalle_output_file_name", str(work / "jax_out")],
             jax_losses)
    verdict, dispatch = train_dalle.DalleTrainer.verdict, train_dalle.DalleTrainer.dispatch

    def load_jax_init(self, generator):
        self.load_state_dict({k: v.to(self.text_emb.weight.dtype) for k, v in pre_sd.items()})
        return self

    def recording(self, loss):
        port_losses.append(float(loss))
        return verdict(self, loss)

    def spy(self, text, image_tokens, *a, **k):
        tokens["port"] = image_tokens.clone()
        return dispatch(self, text, image_tokens, *a, **k)

    mp.setattr(port_dalle.DALLE, "init_weights", load_jax_init)
    mp.setattr(train_dalle.DalleTrainer, "verdict", recording)
    mp.setattr(train_dalle.DalleTrainer, "dispatch", spy)
    try:
        train_dalle.main([*common, *RUN_FLAGS, "--dalle_output_file_name",
                          str(work / "port_out")], device="cpu")
    finally:
        mp.undo()
    return work, paths, jax_losses, port_losses, tokens


def test_openai_dvae_loss_agrees_with_jax(runs):
    _, _, jax_losses, port_losses, tokens = runs
    assert len(jax_losses) == len(port_losses) == 1
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    assert tokens["port"].shape == (4, 1024)


def test_checkpoint_stores_the_dvae_by_class_and_config(runs):
    work, _, _, _, _ = runs
    (jstate, jmeta), (pstate, pmeta) = (j_load_checkpoint(str(work / f"{s}_out.ckpt"))
                                        for s in ("jax", "port"))
    for state, meta in ((jstate, jmeta), (pstate, pmeta)):
        assert meta["vae_class"] == "OpenAIDiscreteVAE" and "vae_params" not in state
    assert pmeta["vae_config"] == jmeta["vae_config"] == dict(
        image_size=256, num_layers=3, num_tokens=8192, n_hid=256, dtype="float32",
        param_dtype="float32")
    assert pmeta["config"] == jmeta["config"]


def test_each_reader_reads_the_others_checkpoint(runs):
    work, paths, _, _, _ = runs
    _, vae, meta = dalle_from_checkpoint(work / "jax_out.ckpt", device="cpu",
                                         vae_weight_paths=paths)
    assert isinstance(vae, OpenAIDiscreteVAE) and vae.image_seq_len == 1024
    assert meta == j_load_checkpoint(str(work / "jax_out.ckpt"))[1]
    _, _, jvae, jvparams, jmeta = j_dalle_from_checkpoint(str(work / "port_out.ckpt"),
                                                          vae_weight_paths=paths)
    assert type(jvae).__name__ == "OpenAIDiscreteVAE"
    assert jmeta == j_load_checkpoint(str(work / "port_out.ckpt"))[1]
    ours = openai_vae_params(vae.state_dict())
    for part, name in (("enc", "input"), ("dec", "output_conv")):
        np.testing.assert_array_equal(np.asarray(jvparams[part][name]["w"]), ours[part][name]["w"])


def test_without_the_encoder_path_the_port_refuses(runs, tmp_path, monkeypatch):
    work, paths, _, _, _ = runs
    monkeypatch.chdir(tmp_path)
    with pytest.raises(MissingWeights, match="--openai_enc_path.*never downloaded"):
        train_dalle.main(["--image_text_folder", str(work / "data"), *MODEL_FLAGS,
                          "--openai_dec_path", paths["openai_dec_path"]], device="cpu")
    with pytest.raises(MissingWeights, match="--openai_dec_path"):
        train_dalle.main(["--image_text_folder", str(work / "data"), *MODEL_FLAGS,
                          "--openai_enc_path", paths["openai_enc_path"]], device="cpu")
    assert list(tmp_path.iterdir()) == []
