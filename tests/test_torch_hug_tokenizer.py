"""The port's HugTokenizer and YttmTokenizer (``data/tokenizers.py``) and
the trainer's ``pick_tokenizer`` against the JAX package's, on the CPU.

The tokenizer JSON is trained here by HuggingFace ``tokenizers`` on a few
seeded captions (no download). Ids, ``tokenize`` (0-padded to the context
length, truncated or raising) and ``decode`` (pads and 0s dropped,
special tokens skipped) equal JAX's exactly. ``youtokentome`` is not
installed: both YttmTokenizers raise the same ``ImportError``. Every
branch of ``pick_tokenizer`` gives the class JAX's gives.
"""

import argparse
import sys

import numpy as np
import pytest

import train_dalle as j_train_dalle
from dalle_pytorch_tpu.data import tokenizers as j_tokenizers
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.data import tokenizers
from dalle_pytorch_tpu_torch.testing import CAPTION_WORDS, train_tokenizer_json

TEXTS = ["a red square", "A Cat's café — on the LEFT", "two striped circles 3 3 3",
         "", "   ", "emoji 🎨 and 中文", "<eos> literal special", "x" * 80]


@pytest.fixture(scope="module")
def tok_json(tmp_path_factory):
    rng = np.random.RandomState(0)
    captions = [" ".join(rng.choice(CAPTION_WORDS, size=rng.randint(2, 9))) for _ in range(60)]
    path = tmp_path_factory.mktemp("hug") / "tokenizer.json"
    train_tokenizer_json(path, captions + TEXTS)
    return path


@pytest.fixture(scope="module")
def pair(tok_json):
    return j_tokenizers.HugTokenizer(str(tok_json)), tokenizers.HugTokenizer(str(tok_json))


def test_vocab_and_ids_match_jax(pair):
    jtok, tok = pair
    assert tok.vocab_size == jtok.vocab_size == 300
    for text in TEXTS:
        assert tok.encode(text) == jtok.encode(text), text


@pytest.mark.parametrize("truncate", [False, True])
def test_tokenize_matches_jax(pair, truncate):
    jtok, tok = pair
    short = TEXTS[:3]
    np.testing.assert_array_equal(tok.tokenize(short, 24, truncate_text=truncate),
                                  jtok.tokenize(short, 24, truncate_text=truncate))
    out = tok.tokenize(TEXTS, 8, truncate_text=True)
    assert out.dtype == np.int32 and out.shape == (len(TEXTS), 8)
    np.testing.assert_array_equal(out, jtok.tokenize(TEXTS, 8, truncate_text=True))
    if not truncate:
        with pytest.raises(RuntimeError, match="too long for context length 4"):
            tok.tokenize(TEXTS[-1], 4)
        with pytest.raises(RuntimeError):
            jtok.tokenize(TEXTS[-1], 4)


def test_decode_with_pads_matches_jax(pair):
    jtok, tok = pair
    for text in TEXTS:
        ids = tok.encode(text)
        padded = [0, *ids[:2], 299, *ids[2:], 1, 0, 0]  # 1 is "<eos>", a special token
        for pads in (frozenset(), {299}, {299, ids[0]} if ids else {299}):
            assert tok.decode(padded, pad_tokens=pads) == jtok.decode(padded, pad_tokens=pads)
    assert tok.decode(tok.encode("a red square")) == "a red square"


def test_missing_json_asserts_as_jax(tmp_path):
    missing = str(tmp_path / "none.json")
    for cls in (tokenizers.HugTokenizer, j_tokenizers.HugTokenizer):
        with pytest.raises(AssertionError, match="BPE json path .* does not exist"):
            cls(missing)


def test_yttm_raises_jax_exception_without_youtokentome(tmp_path):
    model = tmp_path / "bpe.model"
    model.write_bytes(b"not read")
    assert "youtokentome" not in sys.modules
    errors = []
    for cls in (tokenizers.YttmTokenizer, j_tokenizers.YttmTokenizer):
        with pytest.raises(ImportError) as e:
            cls(str(model))
        errors.append((type(e.value), str(e.value), type(e.value.__cause__)))
    assert errors[0] == errors[1]
    assert errors[0][1] == "YttmTokenizer requires the youtokentome package"
    with pytest.raises(AssertionError, match="BPE model path"):
        tokenizers.YttmTokenizer(str(tmp_path / "none.model"))


def _args(**kw):
    ns = train_dalle.build_parser().parse_args(["--image_text_folder", "x"])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("kw,expected", [
    ({}, "SimpleTokenizer"),
    ({"bpe_path": "JSON"}, "HugTokenizer"),
    ({"bpe_path": "JSON", "hug": True}, "HugTokenizer"),
    ({"bpe_path": "MODEL"}, "YttmTokenizer"),
    ({"bpe_path": "MERGES"}, "SimpleTokenizer"),
    ({"bpe_path": "MERGES_JSON_NAMED", "hug": True}, "HugTokenizer"),
])
def test_pick_tokenizer_follows_jax(kw, expected, tok_json, tmp_path):
    model = tmp_path / "bpe.model"
    model.write_bytes(b"x")
    merges = tmp_path / "merges.txt"
    merges.write_bytes(tokenizers.read_bpe_text(tokenizers.PACKAGED_BPE).encode("utf8"))
    named = tmp_path / "tokenizer.bpe"  # --hug reads any name as JSON
    named.write_bytes(tok_json.read_bytes())
    paths = {"JSON": str(tok_json), "MODEL": str(model), "MERGES": str(merges),
             "MERGES_JSON_NAMED": str(named)}
    kw = {k: paths.get(v, v) if k == "bpe_path" else v for k, v in kw.items()}
    got = []
    for pick in (train_dalle.pick_tokenizer, j_train_dalle.pick_tokenizer):
        try:
            got.append(type(pick(_args(**kw))).__name__)
        except ImportError as e:  # YttmTokenizer without youtokentome
            got.append(f"ImportError: {e}")
    if expected == "YttmTokenizer":
        assert got[0] == got[1] == "ImportError: YttmTokenizer requires the youtokentome package"
    else:
        assert got[0] == got[1] == expected


def test_hug_without_bpe_path_fails_jax_assert():
    for pick in (train_dalle.pick_tokenizer, j_train_dalle.pick_tokenizer):
        with pytest.raises(AssertionError, match="--hug requires --bpe_path"):
            pick(_args(hug=True))


def test_hug_json_and_wds_are_no_longer_refused():
    assert not {"hug", "wds", "attn_dropout", "ff_dropout", "ga_steps"} & set(
        train_dalle.NOT_PORTED)
    args = train_dalle.build_parser().parse_args(
        ["--image_text_folder", "shards.tar", "--vae_path", "v.ckpt", "--hug", "--bpe_path",
         "t.json", "--wds", "img,cap", "--attn_dropout", "0.1", "--ff_dropout", "0.1",
         "--ga_steps", "2"])
    train_dalle.refuse_unported(args)  # raises nothing
    assert isinstance(args, argparse.Namespace)
