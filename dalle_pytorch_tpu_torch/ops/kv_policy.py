"""KV-cache format, page size and storage quantization (counterpart of
``dalle_pytorch_tpu/ops/kv_policy.py``).

Three policies:

- the decode cache's format (``FORMATS``): "paged" (block-paged pools
  behind a per-row page table and per-row write index, the only format
  with ragged per-row positions, hence the serving engine's), "flat"
  (one contiguous (b, L, h*d) K and V buffer per layer with one scalar
  write index) and "4d" (the same buffer tagged as its (b, L, h, d)
  view). ``choose_cache_format`` is JAX's default policy without its
  environment overrides: "4d" at batch 1, "flat" at batch 8, "paged"
  otherwise; ``resolve_format`` lets an explicit ``cache_format``
  argument win;
- the page row count;
- the storage quantization (``QUANTS``: "none" stores K/V in the compute
  dtype, "int8" stores int8 pools with parallel per-(token, head)
  float32 scale pools, ``paged_kv.quantize_rows``), paged pools only.

All are explicit arguments here (``EngineConfig.page_size`` /
``kv_quant``, ``init_decode_cache(cache_format=..., page_size=...,
kv_quant=...)``, ``sampling.decode_tokens(cache_format=...)``) rather
than environment overrides: tests shrink the page to exercise
page-boundary arithmetic on tiny models.

Parity tiers under int8: quantized against quantized is bitwise (a
replayed request re-quantizes the same rows to the same bytes and
scales); quantized against unquantized is the token-agreement floor
``KV_QUANT_TOKEN_AGREEMENT_MIN``, never a bitwise claim.
"""

from __future__ import annotations

from typing import Optional

FORMATS = ("paged", "flat", "4d")

DEFAULT_PAGE_SIZE = 128

QUANTS = ("none", "int8")

# fraction of generated positions whose token matches the unquantized
# run's (same seeds): a guard against a broken quantizer, far below the
# ~1.0 a tiny float32 model shows (position-wise agreement is chance
# level after the first near-tie flip)
KV_QUANT_TOKEN_AGREEMENT_MIN = 0.5


class InvalidKVFormatError(ValueError):
    """An unknown KV cache format or storage quantization, raised where the
    policy is resolved (``EngineConfig``/``Engine``, ``init_decode_cache``,
    ``decode_tokens``), naming the valid values, not as a shape or dtype
    error deep inside cache init."""

    def __init__(self, source: str, got: object, valid: tuple = QUANTS):
        super().__init__(f"{source} must be one of {valid}, got {got!r}")
        self.source = source
        self.got = got
        self.valid = valid


def page_size(override: Optional[int] = None) -> int:
    """Page row count: ``override`` when given, else the default."""
    if override is None:
        return DEFAULT_PAGE_SIZE
    if int(override) <= 0:
        raise ValueError(f"page_size must be > 0, got {override!r}")
    return int(override)


def resolve_quant(kv_quant: Optional[str]) -> str:
    """The storage quantization: ``None`` means "none"; a value outside
    ``QUANTS`` raises ``InvalidKVFormatError``."""
    if kv_quant is None:
        return "none"
    if kv_quant not in QUANTS:
        raise InvalidKVFormatError("kv_quant", kv_quant)
    return kv_quant


def choose_cache_format(batch: int) -> str:
    """The default decode cache format for a batch: "4d" at batch 1,
    "flat" at batch 8, "paged" otherwise (JAX's policy)."""
    if batch == 1:
        return "4d"
    if batch == 8:
        return "flat"
    return "paged"


def resolve_format(cache_format: Optional[str], batch: int) -> str:
    """An explicit ``cache_format`` wins; ``None`` defers to
    ``choose_cache_format``. A value outside ``FORMATS`` raises
    ``InvalidKVFormatError``."""
    if cache_format is None:
        return choose_cache_format(batch)
    if cache_format not in FORMATS:
        raise InvalidKVFormatError("cache_format", cache_format, valid=FORMATS)
    return cache_format
