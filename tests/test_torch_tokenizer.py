"""The port's CLIP BPE tokenizer (``data/tokenizers.py``, no ``regex``,
no ftfy) against the JAX package's ``SimpleTokenizer``, byte for byte.

Text is drawn by hypothesis from code points that Python's own Unicode
tables assign (category not "Cn" and not a surrogate): the installed
``regex`` carries newer tables than ``unicodedata``, and on code points
Python calls unassigned the two may disagree. The draws mix scripts,
digits, punctuation, whitespace, contractions (also the long s, which
``regex`` folds to s), HTML entities and the special tokens.
"""

import gzip
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dalle_pytorch_tpu.data.tokenizers import SimpleTokenizer as JTokenizer
from dalle_pytorch_tpu.data.tokenizers import default_bpe_path as j_default_bpe_path
from dalle_pytorch_tpu_torch.data import tokenizers
from dalle_pytorch_tpu_torch.data.tokenizers import SimpleTokenizer
from dalle_pytorch_tpu_torch.testing import CAPTION_WORDS

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pair():
    return JTokenizer(), SimpleTokenizer()


def _assigned(c: str) -> bool:
    return unicodedata.category(c) not in ("Cn", "Cs")


PIECES = st.one_of(
    st.text(st.characters(blacklist_categories=("Cn", "Cs")), max_size=12),
    st.text(st.characters(min_codepoint=0, max_codepoint=0x2FF), max_size=12),
    st.sampled_from(["'s", "'S", "'ſ", "'t", "'re", "'VE", "'m", "'ll", "'d", "it's", "''s",
                     "&amp;", "&amp;amp;", "&lt;b&gt;", "&#39;", "&eacute;", "<|startoftext|>",
                     "<|endoftext|>", "一二三", "١٢٣", "Ⅻ", "½", "x²", "ǅ", "İ", "ß", "\x1c",
                     "　", " ", " ", "\t\n", "  ", "é", "👍🏽", "🇫🇷"]),
    st.integers(0, 10**9).map(str),
    st.sampled_from(CAPTION_WORDS),
)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.lists(PIECES, max_size=8).map("".join))
def test_encode_decode_tokenize_match_jax(pair, text):
    jtok, tok = pair
    assert all(_assigned(c) for c in text)
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(ids, pad_tokens={ids[0]} if ids else set()) == jtok.decode(
        ids, pad_tokens={ids[0]} if ids else set())
    np.testing.assert_array_equal(tok.tokenize([text, "a b"], 24, truncate_text=True),
                                  jtok.tokenize([text, "a b"], 24, truncate_text=True))


def test_dataset_captions_match_jax(pair):
    jtok, tok = pair
    rng = np.random.RandomState(0)
    captions = [" ".join(rng.choice(CAPTION_WORDS, size=rng.randint(1, 12))) for _ in range(50)]
    captions += [f"a {c} {s}" for c in ("red", "green", "blue", "yellow")
                 for s in ("square", "circle")]  # tests/test_e2e.py's rainbow captions
    for caption in captions:
        assert tok.encode(caption) == jtok.encode(caption)
    np.testing.assert_array_equal(tok.tokenize(captions, 16, truncate_text=True),
                                  jtok.tokenize(captions, 16, truncate_text=True))


def test_tokenize_contract(pair):
    jtok, tok = pair
    out = tok.tokenize("a red square", 8)
    assert out.dtype == np.int32 and out.shape == (1, 8)
    n = len(tok.encode("a red square"))
    assert (out[0, :n] > 0).all() and (out[0, n:] == 0).all()
    long = " ".join(["word"] * 40)
    with pytest.raises(RuntimeError, match="too long for context length 8"):
        tok.tokenize(long, 8)
    with pytest.raises(RuntimeError):
        jtok.tokenize(long, 8)
    np.testing.assert_array_equal(tok.tokenize(long, 8, truncate_text=True),
                                  jtok.tokenize(long, 8, truncate_text=True))


def test_vocab_size_and_packaged_merges_equal_jax(pair):
    jtok, tok = pair
    assert tok.vocab_size == jtok.vocab_size == 49408
    assert tok.encoder == jtok.encoder and tok.bpe_ranks == jtok.bpe_ranks
    packaged = gzip.decompress(tokenizers.PACKAGED_BPE.read_bytes())
    assert packaged == Path(j_default_bpe_path()).read_bytes()
    assert packaged == (REPO / "dalle_pytorch_tpu/data/bpe_simple_vocab_16e6.txt").read_bytes()


def test_bpe_path_plain_file_and_env(tmp_path, monkeypatch):
    plain = tmp_path / "merges.txt"
    plain.write_bytes(gzip.decompress(tokenizers.PACKAGED_BPE.read_bytes()))
    assert SimpleTokenizer(str(plain)).encode("a cat's hat") == SimpleTokenizer().encode(
        "a cat's hat")
    monkeypatch.setenv("DALLE_TPU_BPE_PATH", str(plain))
    assert tokenizers.default_bpe_path() == str(plain)
    monkeypatch.setenv("DALLE_TPU_BPE_PATH", str(tmp_path / "none.txt"))
    assert tokenizers.default_bpe_path() == str(tokenizers.PACKAGED_BPE)


def test_whitespace_and_split_match_regex():
    import regex

    # White_Space code points are separators or controls (or isspace)
    candidates = [chr(c) for c in range(0x110000)
                  if unicodedata.category(chr(c)) in ("Zs", "Zl", "Zp", "Cc") or chr(c).isspace()]
    assert frozenset(c for c in candidates if regex.match(r"\s", c)) == tokenizers.WHITESPACE
    pat = regex.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                        r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)
    for text in ("ab'sc 'ſ ''s 12x <|endoftext|>y", "一二 x² ½!!?", "é ǅa"):
        assert tokenizers.split_words(text) == regex.findall(pat, text)
