"""Generate unicode_tables.h for the native BPE scanner.

JAX's tokenizer splits text with ``regex``'s Unicode property classes
(\\p{L}, \\p{N}, \\s, under IGNORECASE). For byte-exact parity the C++
scanner uses membership tables generated from that ``regex`` module:
every code point is classified by the oracle itself and compressed into
[start, end] ranges emitted as a C header. The port's Python scanner
(``data/tokenizers.py``) classifies the same way on every code point
Python's own tables assign; ``tests/test_torch_native_bpe.py`` holds the
two against each other.

Run by hand when the regex or Unicode version changes (it needs ``regex``):
    python -m dalle_pytorch_tpu_torch.native.gen_unicode_tables
The generated header is committed, so a build never needs this step.
"""

from __future__ import annotations

import sys
from pathlib import Path

MAX_CP = 0x110000


def ranges_for(pattern: str):
    import regex as re

    # IGNORECASE to match the tokenizer pattern's flag exactly: under it the
    # regex module case-closes property classes, with real consequences —
    # e.g. U+0345 (combining ypogegrammeni, folds to iota) matches NEITHER
    # [\p{L}] NOR [^\s\p{L}\p{N}] and is silently skipped by findall
    pat = re.compile(pattern, re.IGNORECASE)
    ranges = []
    start = None
    for cp in range(MAX_CP):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates: unencodable, never match
            member = False
        else:
            member = pat.fullmatch(chr(cp)) is not None
        if member and start is None:
            start = cp
        elif not member and start is not None:
            ranges.append((start, cp - 1))
            start = None
    if start is not None:
        ranges.append((start, MAX_CP - 1))
    return ranges


def emit(name: str, ranges) -> str:
    rows = ",\n  ".join(
        ", ".join(f"{{0x{a:X}, 0x{b:X}}}" for a, b in ranges[i : i + 4])
        for i in range(0, len(ranges), 4)
    )
    return (
        f"static const CpRange {name}[] = {{\n  {rows}\n}};\n"
        f"static const int {name}_len = {len(ranges)};\n"
    )


def main() -> None:
    import regex as re

    out = Path(__file__).parent / "unicode_tables.h"
    letters = ranges_for(r"[\p{L}]")
    numbers = ranges_for(r"[\p{N}]")
    others = ranges_for(r"[^\s\p{L}\p{N}]")
    header = (
        "// Generated by gen_unicode_tables.py — do not edit.\n"
        "// Classifies codepoints exactly as the Python `regex` module does\n"
        "// under IGNORECASE (the tokenizer pattern's flag)\n"
        f"// (regex {re.__version__}, python {sys.version.split()[0]}).\n"
        "#pragma once\n"
        "#include <cstdint>\n\n"
        "struct CpRange { uint32_t lo, hi; };\n\n"
        + emit("kLetterRanges", letters)
        + "\n"
        + emit("kNumberRanges", numbers)
        + "\n"
        + emit("kOtherRanges", others)
    )
    out.write_text(header)
    print(
        f"wrote {out}: {len(letters)} letter, {len(numbers)} number, "
        f"{len(others)} other ranges"
    )


if __name__ == "__main__":
    main()
