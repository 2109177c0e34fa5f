"""The port's generate command line, its surface and its refusals, on
the checkpoints of test_torch_generate_cli.py (JAX's files, a tiny DALLE,
VAE and CLIP):

- the flag surface equals ``generate.py``'s action by action (option
  strings, dest, type, default, nargs, const, action kind, required);
- ``--int8``, ``--chinese`` and the VQGAN and OpenAI dVAE paths raise
  ``NotImplementedError`` naming their ROADMAP.md item before any file
  is read (the checkpoint named does not exist) or any directory made;
- a checkpoint that does not verify against its manifest exits 2 with
  JAX's two lines, and a gMLP checkpoint fails with the factory's typed
  error, neither making ``--outputs_dir``;
- ``--hug`` with a ``.json`` tokenizer trained in the test: the tokens
  and images equal JAX's command line's (greedy);
- the command line is the engine: sampled (top-k 0.5), its PNGs are the
  images an ``Engine`` built directly serves the same requests, in
  descending score order;
- ``--bf16``: the served model (``utils.quantize.prepare_for_serving``)
  holds every parameter rounded through bfloat16, and its first image
  token's logits lie within ``testing.BF16_GAP_FACTOR`` times JAX's
  ``prepare_for_serving`` model's own bfloat16-to-float32 gap of that
  model's; ``int8`` serving is refused;
- the VAE stage decodes under cuDNN's deterministic algorithms (the
  card's PNGs are then the same every run) and restores the setting."""

import numpy as np
import pytest
import torch

import generate as j_generate
from dalle_pytorch_tpu.models.factory import dalle_from_checkpoint as j_dalle_from_checkpoint
from dalle_pytorch_tpu.utils.quantize import prepare_for_serving as j_prepare_for_serving
from dalle_pytorch_tpu_torch import generate
from dalle_pytorch_tpu_torch.data.tokenizers import SimpleTokenizer
from dalle_pytorch_tpu_torch.models.factory import clip_from_checkpoint, dalle_from_checkpoint
from dalle_pytorch_tpu_torch.models.vae import denormalize
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.postdecode import StageConfig, StageSpec
from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio, train_tokenizer_json
from dalle_pytorch_tpu_torch.utils.quantize import prepare_for_serving
from test_torch_generate_cli import (DALLE_CONFIG, _registries, run_cli,  # noqa: F401
                                     saved, write_jax_checkpoints)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    work = tmp_path_factory.mktemp("gen_flags")
    write_jax_checkpoints(work)
    return work


def _actions(parser):
    return {tuple(a.option_strings): (a.dest, a.type, a.default, a.nargs, a.const,
                                      type(a).__name__, a.required)
            for a in parser._actions if a.dest != "help"}


def test_flag_surface_equals_generate(monkeypatch):
    captured = {}

    def grab(self, *a, **k):
        captured["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr("argparse.ArgumentParser.parse_args", grab)
    with pytest.raises(SystemExit):
        j_generate.parse_args()
    monkeypatch.undo()
    assert _actions(generate.build_parser()) == _actions(captured["parser"])
    assert set(generate.NOT_PORTED) <= {a.dest for a in captured["parser"]._actions}


REFUSED = {"int8": ["--int8"], "chinese": ["--chinese"],
           "vqgan_model_path": ["--vqgan_model_path", "m.ckpt"],
           "vqgan_config_path": ["--vqgan_config_path", "c.yaml"],
           "openai_enc_path": ["--openai_enc_path", "enc.pkl"],
           "openai_dec_path": ["--openai_dec_path", "dec.pkl"]}


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_refused_flag_raises_before_any_file(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=f"--{flag} .*ROADMAP.md (queue|not queued)"):
        generate.main(["--dalle_path", "missing.ckpt", "--text", "x", "--outputs_dir", "out",
                       *REFUSED[flag]], device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_corrupt_checkpoint_exits_2(work, tmp_path, capsys):
    bad = tmp_path / "bad.ckpt"
    data = bytearray((work / "dalle.ckpt").read_bytes())
    data[len(data) // 2] ^= 0xFF
    bad.write_bytes(bytes(data))
    (tmp_path / "bad.ckpt.manifest.json").write_bytes(
        (work / "dalle.ckpt.manifest.json").read_bytes())
    with pytest.raises(SystemExit) as exc:
        generate.main(["--dalle_path", str(bad), "--text", "x", "--outputs_dir",
                       str(tmp_path / "out")], device="cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err.splitlines()
    assert err[-2].startswith("ERROR: checkpoint ") and "checksum mismatch" in err[-2]
    assert err[-1] == ("refusing to load an unverifiable checkpoint; regenerate it or "
                       "restore from a verified save")
    assert not (tmp_path / "out").exists()


def test_gmlp_checkpoint_fails_typed(tmp_path):
    write_jax_checkpoints(tmp_path, dict(DALLE_CONFIG, attn_types=("full", "mlp"),
                                         rotary_emb=False), clip_config=None)
    with pytest.raises(NotImplementedError, match="gMLP"):
        generate.main(["--dalle_path", str(tmp_path / "dalle.ckpt"), "--text", "x",
                       "--outputs_dir", str(tmp_path / "out")], device="cpu")
    assert not (tmp_path / "out").exists()


def test_hug_json_tokenizer_equals_jax(tmp_path):
    captions = ["a red circle on a square", "two small blue squares", "a large green circle"] * 4
    train_tokenizer_json(tmp_path / "tok.json", captions, vocab_size=300)
    write_jax_checkpoints(tmp_path, dict(DALLE_CONFIG, num_text_tokens=300), clip_config=None)
    served = {}
    for side in ("jax", "port"):
        served[side] = run_cli(side, ["--dalle_path", str(tmp_path / "dalle.ckpt"), "--hug",
                                      "--bpe_path", str(tmp_path / "tok.json"), "--text",
                                      "a red circle|blue squares", "--outputs_dir",
                                      str(tmp_path / side), "--top_k", "1.0",
                                      "--num_images", "2", "--batch_size", "2"])
    assert sorted(served["port"]) == sorted(served["jax"]) and len(served["jax"]) == 4
    for rid, (tokens, image, _) in served["jax"].items():
        assert served["port"][rid][0] == tokens, rid
        np.testing.assert_allclose(served["port"][rid][1], image, atol=1e-4, rtol=0)
    assert list(saved(tmp_path / "port")) == list(saved(tmp_path / "jax"))


def test_cli_is_the_engine_best_first(work, tmp_path):
    argv = ["--dalle_path", str(work / "dalle.ckpt"), "--clip_path", str(work / "clip.ckpt"),
            "--text", "a red circle", "--outputs_dir", str(tmp_path / "out"), "--top_k", "0.5",
            "--num_images", "4", "--batch_size", "2", "--seed", "5"]
    generate.main(argv, device="cpu")
    pngs = saved(tmp_path / "out")["a_red_circle"][0]
    dalle, vae, _ = dalle_from_checkpoint(work / "dalle.ckpt", "cpu")
    clip, _ = clip_from_checkpoint(work / "clip.ckpt", "cpu")
    eng = Engine(dalle, EngineConfig(max_batch=2, queue_limit=4, filter_thres=0.5),
                 device="cpu", stages=StageSpec(vae, clip, config=StageConfig(batch=2,
                                                                              queue_limit=4)))
    row = SimpleTokenizer().tokenize(["a red circle"], dalle.text_seq_len, truncate_text=True)[0]
    images, scores = generate.engine_images(eng, row, 4, "p0",
                                            generate.request_seed(5, 0, 0))
    assert len({tuple(np.asarray(r.tokens)) for r in eng.results.values()}) > 1  # sampled
    order = np.argsort(-scores)
    assert (np.diff(scores[order]) <= 0).all()
    want = [(denormalize(torch.from_numpy(images[k])).numpy() * 255).astype(np.uint8)
            for k in order]
    assert len(pngs) == 4 and all(np.array_equal(a, b) for a, b in zip(pngs, want))


def test_bf16_serving_model_within_the_gap(work):
    jdalle, params, *_ = j_dalle_from_checkpoint(str(work / "dalle.ckpt"))
    jb, jbp = j_prepare_for_serving(jdalle, params)
    dalle, _, _ = dalle_from_checkpoint(work / "dalle.ckpt", "cpu")
    served = prepare_for_serving(dalle)
    assert served.dtype == torch.bfloat16
    for (name, p), q in zip(dalle.state_dict().items(), served.state_dict().values()):
        assert torch.equal(p.to(torch.bfloat16).float(), q.float()), name
    rng = np.random.RandomState(0)
    text = rng.randint(1, 49408, size=(2, DALLE_CONFIG["text_seq_len"])).astype(np.int32)
    image = rng.randint(0, 20, size=(2, 16)).astype(np.int32)
    # the image logits the first image token is drawn from
    T, ext = dalle.text_len_internal, dalle.num_text_tokens_ext
    ref32 = np.asarray(jdalle.apply({"params": params}, text, image), np.float32)[:, T - 1, ext:]
    ref16 = np.asarray(jb.apply({"params": jbp}, text, image), np.float32)[:, T - 1, ext:]
    with torch.no_grad():
        got = served(torch.from_numpy(text).long(), torch.from_numpy(image).long())
    got = got.float().numpy()[:, T - 1, ext:]
    assert gap_ratio(got, ref16, ref32) <= BF16_GAP_FACTOR
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        prepare_for_serving(dalle, int8=True)


def test_vae_decode_runs_cudnn_deterministic(work, monkeypatch):
    """``DiscreteVAE.decode`` runs under cuDNN's deterministic algorithms
    (on the card some transposed-convolution algorithms reduce with
    atomics, so the CLI's PNGs would change between runs) and restores
    the setting after, for the stage and for a direct caller alike."""
    from dalle_pytorch_tpu_torch.serving.postdecode import PostDecodePipeline
    from dalle_pytorch_tpu_torch.serving.types import FakeClock

    _, vae, _ = dalle_from_checkpoint(work / "dalle.ckpt", "cpu")
    seen = []
    decode_embeds = vae._decode_embeds

    def spy(embeds):
        seen.append(torch.backends.cudnn.deterministic)
        return decode_embeds(embeds)

    monkeypatch.setattr(vae, "_decode_embeds", spy)
    pipe = PostDecodePipeline(StageSpec(vae), FakeClock(), finish=lambda *a, **k: None)
    before = torch.backends.cudnn.deterministic
    out = pipe.decode_images(np.zeros((2, 16), np.int32))
    with torch.no_grad():
        direct = vae.decode(torch.zeros((1, 16), dtype=torch.long))
    assert seen == [True, True] and torch.backends.cudnn.deterministic == before
    assert out.shape == (2, 16, 16, 3) and direct.shape == (1, 16, 16, 3)
