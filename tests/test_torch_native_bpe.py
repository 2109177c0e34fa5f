"""The port's native BPE engine (``native/bpe_tokenizer.cc``, bound by
``data/native_bpe.py``) on the CPU: built by ``g++`` from the port's own
sources into ``build/native/``, and byte-exact with the port's
``SimpleTokenizer`` and with the JAX package's ``NativeSimpleTokenizer``.

- ``tests/test_native_bpe.py``'s cases: its corpus (with the case-closure
  traps ``'ſ`` and U+0345), decode, pads, 200 seeded fuzz strings, the
  ``tokenize`` contract and four threads encoding at once; plus hypothesis
  text drawn as ``tests/test_torch_tokenizer.py`` draws it (code points
  Python's tables assign) and U+0345 among them;
- the engine's classification tables (``native/unicode_tables.h``, the
  JAX package's, generated from ``regex``) against the Python scanner's
  ``_kind`` on every assigned code point;
- the merges read from the packaged gzip and from a plain file alike;
- ``get_tokenizer`` prefers the engine, ``DALLE_TPU_NO_NATIVE=1`` turns it
  off, and a failed build warns and falls back;
- a process that builds and loads the engine opens nothing of the JAX
  package's ``native/`` (its sources, its committed ``.so``) nor
  ``~/.cache/dalle_tpu`` (an audit hook records every open, ``dlopen``
  and compiler command), and an edited source names another library.
"""

import gzip
import os
import re
import subprocess
import sys
import threading
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dalle_pytorch_tpu.data.native_bpe import NativeSimpleTokenizer as JNative
from dalle_pytorch_tpu_torch.data import native_bpe, tokenizers
from dalle_pytorch_tpu_torch.data.native_bpe import NativeSimpleTokenizer
from dalle_pytorch_tpu_torch.data.tokenizers import SimpleTokenizer
from dalle_pytorch_tpu_torch.native import build
from dalle_pytorch_tpu_torch.testing import CAPTION_WORDS

REPO = Path(__file__).resolve().parent.parent

CORPUS = [
    "a red square",
    "A man riding a horse on the beach at sunset.",
    "Hello, World! It's a test... isn't it?",
    "naïve café — résumé über straße",
    "numbers 0 1 23 456 7890 and ² ³ ½ Ⅳ",
    "emoji 🎨🌈🦄 and CJK 中文字符串 and kana テスト ひらがな",
    "<|startoftext|>prompt<|endoftext|>",
    "mixed<|endoftext|>inline special",
    "don't can't we'll I'm you've they're he'd 'quoted'",
    "  collapse   whitespace\tand\nnewlines\r\nplease ",
    "punctuation!!! ??? ... ---- ###$$$%%%",
    "!!<|startoftext|>not-special-mid-punct-run",
    "price: $12.50 (50% off!) e.g. i.e. etc.",
    "html &amp; entities &lt;tag&gt;",
    "Ωμέγα ελληνικά кириллица العربية עברית हिन्दी",
    "snake_case camelCase SCREAMING dots.and.dots",
    "a" * 300,
    "ab " * 100,
    "",
    "   ",
    "'", "''", "'s", "x's", "'sx", "'ll", "o'clock",
    "'ſ", "ͅ", "aͅb", "it'ſ done", "!ͅ!", "1ͅ2",
]


@pytest.fixture(scope="module")
def trio():
    return NativeSimpleTokenizer(), SimpleTokenizer(), JNative()


def test_engine_is_built_from_the_ports_sources(trio):
    so = build.library_path()
    assert so.exists() and so.parent == REPO / "build" / "native"
    assert build.SOURCE == REPO / "dalle_pytorch_tpu_torch" / "native" / "bpe_tokenizer.cc"
    assert native_bpe._lib._name == str(so)
    nt, pt, jt = trio
    assert nt.vocab_size == pt.vocab_size == jt.vocab_size == 49408


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_encode_matches_python_and_jax(trio, text):
    nt, pt, jt = trio
    assert nt.encode(text) == pt.encode(text) == jt.encode(text)


def test_decode_and_pads_match(trio):
    nt, pt, jt = trio
    for text in CORPUS:
        ids = pt.encode(text)
        assert nt.decode(ids) == pt.decode(ids) == jt.decode(ids)
    ids = pt.encode("a blue circle")
    padded = [0] + ids[:2] + [49152, 49200] + ids[2:] + [0, 0]
    pads = {49152, 49200}
    assert (nt.decode(padded, pad_tokens=pads) == pt.decode(padded, pad_tokens=pads)
            == jt.decode(padded, pad_tokens=pads))
    assert nt.decode([0xFF, 0x100, 49407]) == pt.decode([0xFF, 0x100, 49407])


def test_randomized_fuzz_matches(trio):
    nt, pt, jt = trio
    rng = np.random.RandomState(0)
    pools = [
        list(range(0x20, 0x7F)), list(range(0xA0, 0x250)), list(range(0x370, 0x400)),
        list(range(0x4E00, 0x4E80)), [0x1F600 + i for i in range(40)],
        [0x20, 0x27, 0x2E, 0x31, 0x32], [0x27, 0x73, 0x17F, 0x345, 0x6C, 0x74],
        list(range(0x00, 0x20)), list(range(0x2000, 0x2030)),
    ]
    for _ in range(200):
        n = rng.randint(1, 60)
        text = "".join(chr(int(rng.choice(pools[rng.randint(len(pools))]))) for _ in range(n))
        assert nt.encode(text) == pt.encode(text) == jt.encode(text), repr(text)


PIECES = st.one_of(
    st.text(st.characters(blacklist_categories=("Cn", "Cs")), max_size=12),
    st.text(st.characters(min_codepoint=0, max_codepoint=0x3FF), max_size=12),
    st.sampled_from(["'s", "'S", "'ſ", "'re", "'VE", "&amp;", "<|endoftext|>", "一二三", "½",
                     "ͅ", "aͅb", "\x1c", "　", "👍🏽"]),
    st.integers(0, 10**9).map(str),
    st.sampled_from(CAPTION_WORDS),
)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.lists(PIECES, max_size=8).map("".join))
def test_hypothesis_text_matches(trio, text):
    nt, pt, jt = trio
    ids = nt.encode(text)
    assert ids == pt.encode(text) == jt.encode(text)
    assert nt.decode(ids) == pt.decode(ids)
    np.testing.assert_array_equal(nt.tokenize([text, "a b"], 24, truncate_text=True),
                                  pt.tokenize([text, "a b"], 24, truncate_text=True))


def test_tables_agree_with_the_python_scanner():
    header = (REPO / "dalle_pytorch_tpu_torch/native/unicode_tables.h").read_text()
    assert header == (REPO / "dalle_pytorch_tpu/native/unicode_tables.h").read_text()
    tables = {}
    for name, body in re.findall(r"static const CpRange (k\w+)\[\] = \{(.*?)\};", header, re.S):
        tables[name] = [(int(a, 16), int(b, 16))
                        for a, b in re.findall(r"\{0x([0-9A-F]+), 0x([0-9A-F]+)\}", body)]
    member = {k: np.zeros(0x110000, bool) for k in ("L", "N", "O")}
    for kind, name in (("L", "kLetterRanges"), ("N", "kNumberRanges"), ("O", "kOtherRanges")):
        for lo, hi in tables[name]:
            member[kind][lo:hi + 1] = True
    bad = []
    for cp in range(0x110000):
        c = chr(cp)
        if 0xD800 <= cp <= 0xDFFF or unicodedata.category(c) == "Cn":
            continue
        want = next((k for k in "LNO" if member[k][cp]), "S")
        if tokenizers._kind(c) != want:
            bad.append(hex(cp))
    assert not bad, bad[:10]


def test_plain_and_gzipped_merges_agree(tmp_path):
    plain = tmp_path / "merges.txt"
    plain.write_bytes(gzip.decompress(tokenizers.PACKAGED_BPE.read_bytes()))
    a = NativeSimpleTokenizer(str(plain))
    b = NativeSimpleTokenizer(str(tokenizers.PACKAGED_BPE))
    for text in CORPUS:
        assert a.encode(text) == b.encode(text)
    bad = tmp_path / "bad.txt"
    bad.write_text("#version\nnospace\n")
    with pytest.raises(RuntimeError, match="failed to load"):
        NativeSimpleTokenizer(str(bad))


def test_tokenize_contract(trio):
    nt, _, jt = trio
    out = nt.tokenize(["a red square", "tiny"], context_length=16)
    assert out.shape == (2, 16) and out.dtype == np.int32 and out[1, -1] == 0
    np.testing.assert_array_equal(out, jt.tokenize(["a red square", "tiny"], context_length=16))
    with pytest.raises(RuntimeError, match="too long"):
        nt.tokenize(["word " * 200], context_length=8)
    assert nt.tokenize(["word " * 200], context_length=8, truncate_text=True).shape == (1, 8)


def test_concurrent_encode_is_thread_safe(trio):
    nt, pt, _ = trio
    texts = [f"caption number {i} with a {w} object" for i in range(50)
             for w in ("red", "blue", "shiny")]
    expected = [pt.encode(t) for t in texts]
    results = {}

    def worker(tid):
        results[tid] = [nt.encode(t) for t in texts]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 4
    assert all(out == expected for out in results.values())


def test_get_tokenizer_prefers_the_engine(monkeypatch):
    monkeypatch.setattr(tokenizers, "_default", None)
    assert isinstance(tokenizers.get_tokenizer(), NativeSimpleTokenizer)
    assert tokenizers.get_tokenizer() is tokenizers.get_tokenizer()
    monkeypatch.setattr(tokenizers, "_default", None)
    monkeypatch.setenv("DALLE_TPU_NO_NATIVE", "1")
    assert type(tokenizers.get_tokenizer()) is SimpleTokenizer
    monkeypatch.setattr(tokenizers, "_default", None)


def test_failed_build_warns_and_falls_back(monkeypatch):
    monkeypatch.setattr(native_bpe, "_lib", None)
    monkeypatch.setattr(native_bpe, "_lib_failed", False)
    monkeypatch.setattr(tokenizers, "_default", None)
    monkeypatch.setattr(build, "library_path", lambda: Path("/nonexistent/libdalle_bpe.so"))
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.warns(UserWarning, match="native BPE engine unavailable"):
        tok = tokenizers.get_tokenizer()
    assert type(tok) is SimpleTokenizer and not native_bpe.native_available()
    monkeypatch.setattr(tokenizers, "_default", None)


def test_an_edited_source_names_another_library(tmp_path, monkeypatch):
    src = tmp_path / "bpe_tokenizer.cc"
    src.write_text(build.SOURCE.read_text() + "\n// edited\n")
    before = build.library_path()
    monkeypatch.setattr(build, "SOURCE", src)
    assert build.library_path() != before and build.library_path().parent == before.parent


def test_build_and_load_open_nothing_of_the_jax_package(tmp_path):
    code = f"""
import sys
events = []
sys.addaudithook(lambda ev, args: events.append((ev, args))
                 if ev in ("open", "ctypes.dlopen", "subprocess.Popen") else None)
from pathlib import Path
from dalle_pytorch_tpu_torch.native import build
build.BUILD_DIR = Path({str(tmp_path)!r})
from dalle_pytorch_tpu_torch.data.native_bpe import NativeSimpleTokenizer
tok = NativeSimpleTokenizer()
assert tok.encode("a red square") == [320, 736, 3999]
opened = [str(a[0]) for ev, a in events if ev == "open"]
loaded = [str(a[0]) for ev, a in events if ev == "ctypes.dlopen"]
commands = [" ".join(map(str, a[1])) for ev, a in events if ev == "subprocess.Popen"]
bad = [p for p in opened + loaded + commands
       if "dalle_pytorch_tpu/native" in p or ".cache/dalle_tpu" in p]
assert not bad, bad
assert any(p.startswith({str(tmp_path)!r}) and "libdalle_bpe-" in p for p in loaded), loaded
assert len(commands) == 1 and "dalle_pytorch_tpu_torch/native/bpe_tokenizer.cc" in commands[0]
assert "dalle_pytorch_tpu." not in " ".join(sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=180,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr
    assert list(tmp_path.glob("libdalle_bpe-*.so"))
