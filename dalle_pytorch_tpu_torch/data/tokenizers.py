"""The tokenizers (counterpart of ``dalle_pytorch_tpu/data/tokenizers.py``):
the CLIP byte-level BPE ``SimpleTokenizer`` on the standard library alone,
with its ``tokenize`` contract; ``HugTokenizer`` (a HuggingFace
``tokenizers`` JSON file) and ``YttmTokenizer`` (a youtokentome model),
each importing its package when built; and ``get_tokenizer``, the module
default, which prefers the native engine (``data/native_bpe.py``).

JAX splits text with the ``regex`` package's pattern
``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
(case-insensitive). Here a scanner takes its place: ``\\p{L}`` is a code
point whose ``unicodedata`` category starts with "L", ``\\p{N}`` one whose
category starts with "N" (not ``str.isalnum`` / ``isnumeric``, which hold
for CJK ideographs such as 一, category "Lo"), ``\\s`` Unicode's
White_Space set (``WHITESPACE``, which leaves out U+001C-U+001F where
``str.isspace`` takes them), U+0345 (``UNMATCHED``) matches no
alternative (under IGNORECASE ``regex`` closes the classes over case,
and the combining ypogegrammeni falls out of all three: ``findall``
skips it), and the literals match case-insensitively as ``regex`` folds
them (``'s`` also as ``'ſ``). The categories are Python's
own tables; ``regex`` may carry a newer Unicode, so the two agree on the
code points Python's tables assign (category not "Cn").

``basic_clean`` is JAX's branch without ftfy: NFC, then ``html.unescape``
twice. The merges file ships gzipped beside this module
(``bpe_simple_vocab_16e6.txt.gz``, the JAX package's file).
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Iterable, List, Optional, Union

import numpy as np

_BPE_FILENAME = "bpe_simple_vocab_16e6.txt"
PACKAGED_BPE = Path(__file__).parent / (_BPE_FILENAME + ".gz")

# Unicode's White_Space property: what the regex package's \s matches
WHITESPACE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
# code points that match none of the pattern's classes (see above)
UNMATCHED = frozenset("\u0345")
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def default_bpe_path() -> Optional[str]:
    """The merges file: ``DALLE_TPU_BPE_PATH``, else the packaged copy,
    else ``~/.cache/dalle_tpu/bpe_simple_vocab_16e6.txt``."""
    candidates = [os.environ.get("DALLE_TPU_BPE_PATH"), str(PACKAGED_BPE),
                  str(Path.home() / ".cache" / "dalle_tpu" / _BPE_FILENAME)]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def read_bpe_text(path) -> str:
    """The merges file's text, gunzipped when it is gzip."""
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw.decode("utf8")


@lru_cache()
def bytes_to_unicode():
    """The reversible byte -> printable code point map of GPT-2 / CLIP."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    text = unicodedata.normalize("NFC", text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    """Runs of ``WHITESPACE`` to one space, then ``strip``."""
    out, run = [], False
    for ch in text:
        if ch in WHITESPACE:
            run = True
            continue
        if run:
            out.append(" ")
            run = False
        out.append(ch)
    if run:
        out.append(" ")
    return "".join(out).strip()


def _kind(ch: str) -> str:
    """"L" (letter), "N" (number), "S" (White_Space or ``UNMATCHED``:
    skipped) or "O" (other)."""
    if ch in WHITESPACE or ch in UNMATCHED:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _folds_to(ch: str, lit: str) -> bool:
    """``ch`` matches the literal ``lit`` as ``regex``'s IGNORECASE does."""
    return ch == lit or ch == lit.upper() or (lit == "s" and ch == "ſ")


def _literal_at(text: str, i: int, lit: str) -> bool:
    return len(text) - i >= len(lit) and all(
        _folds_to(text[i + j], c) for j, c in enumerate(lit))


def split_words(text: str) -> List[str]:
    """``regex.findall`` of the CLIP pattern, as a scanner."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((t for t in _SPECIALS + _CONTRACTIONS if _literal_at(text, i, t)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters, or others, run on
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _pairs(word):
    return set(zip(word[:-1], word[1:]))


class _TokenizeMixin:
    def tokenize(self, texts: Union[str, Iterable[str]], context_length: int = 256,
                 truncate_text: bool = False) -> np.ndarray:
        """(b, context_length) int32 token ids, 0-padded; a text longer
        than ``context_length`` raises ``RuntimeError`` unless
        ``truncate_text``."""
        if isinstance(texts, str):
            texts = [texts]
        texts = list(texts)
        all_tokens = [self.encode(t) for t in texts]
        out = np.zeros((len(all_tokens), context_length), dtype=np.int32)
        for i, tokens in enumerate(all_tokens):
            if len(tokens) > context_length:
                if truncate_text:
                    tokens = tokens[:context_length]
                else:
                    raise RuntimeError(
                        f"Input {texts[i]} is too long for context length {context_length}")
            out[i, :len(tokens)] = tokens
        return out


class SimpleTokenizer(_TokenizeMixin):
    """Byte-level BPE over the 16e6 merges (49,408 tokens). ``bpe_path``:
    a merges file, plain text or gzip; default ``default_bpe_path()``."""

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or default_bpe_path()
        if bpe_path is None:
            raise FileNotFoundError(f"{_BPE_FILENAME} not found; set DALLE_TPU_BPE_PATH")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = read_bpe_text(bpe_path).split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(_SPECIALS)
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {t: t for t in _SPECIALS}
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        for word in split_words(whitespace_clean(basic_clean(text)).lower()):
            word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(word).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int], pad_tokens: set = frozenset()) -> str:
        """ids -> text, dropping ``pad_tokens`` and 0s."""
        text = "".join(self.decoder[int(t)] for t in tokens
                       if int(t) not in pad_tokens and int(t) != 0)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))


class HugTokenizer(_TokenizeMixin):
    """A byte-level BPE from a HuggingFace ``tokenizers`` JSON file; the
    package is imported when one is built."""

    def __init__(self, bpe_path: str):
        from tokenizers import Tokenizer

        assert Path(bpe_path).exists(), f"BPE json path {bpe_path} does not exist"
        self.tokenizer = Tokenizer.from_file(str(bpe_path))
        self.vocab_size = self.tokenizer.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text).ids

    def decode(self, tokens: Iterable[int], pad_tokens: set = frozenset()) -> str:
        """ids -> text, dropping ``pad_tokens``, 0s and special tokens."""
        ids = [int(t) for t in tokens if int(t) not in pad_tokens and int(t) != 0]
        return self.tokenizer.decode(ids, skip_special_tokens=True)


class YttmTokenizer(_TokenizeMixin):
    """A youtokentome BPE model; the package is imported when one is built
    (``ImportError`` without it)."""

    def __init__(self, bpe_path: str):
        assert Path(bpe_path).exists(), f"BPE model path {bpe_path} does not exist"
        try:
            import youtokentome as yttm
        except ImportError as e:
            raise ImportError("YttmTokenizer requires the youtokentome package") from e
        self.tokenizer = yttm.BPE(model=str(bpe_path))
        self.vocab_size = self.tokenizer.vocab_size()

    def encode(self, text: str) -> List[int]:
        import youtokentome as yttm

        return self.tokenizer.encode([text], output_type=yttm.OutputType.ID)[0]

    def decode(self, tokens: Iterable[int], pad_tokens: set = frozenset()) -> str:
        return self.tokenizer.decode([[int(t) for t in tokens]],
                                     ignore_ids=list(pad_tokens) + [0])[0]


_default: Optional[_TokenizeMixin] = None


def get_tokenizer() -> _TokenizeMixin:
    """The module default, built at first call: the native engine
    (``native_bpe.NativeSimpleTokenizer``, byte-exact with
    ``SimpleTokenizer``), or, with ``DALLE_TPU_NO_NATIVE=1`` or when the
    engine cannot be built (a warning says why), ``SimpleTokenizer``."""
    global _default
    if _default is None:
        if os.environ.get("DALLE_TPU_NO_NATIVE", "") in ("", "0"):
            try:
                from .native_bpe import NativeSimpleTokenizer

                _default = NativeSimpleTokenizer()
            except Exception as e:
                import warnings

                warnings.warn(f"native BPE engine unavailable ({e!r}); falling back to the "
                              "pure-Python tokenizer (slower). Set DALLE_TPU_NO_NATIVE=1 to "
                              "silence this.")
        if _default is None:
            _default = SimpleTokenizer()
    return _default
