"""KV-cache page size (counterpart of ``dalle_pytorch_tpu/ops/kv_policy.py``).

Only the paged format with unquantized pools is ported, so the one policy
left is the page row count. It is an explicit argument here (the engine's
``EngineConfig.page_size``, ``init_decode_cache(page_size=...)``) rather
than an environment override: tests shrink it to exercise page-boundary
arithmetic on tiny models.
"""

from __future__ import annotations

from typing import Optional

DEFAULT_PAGE_SIZE = 128


def page_size(override: Optional[int] = None) -> int:
    """Page row count: ``override`` when given, else the default."""
    if override is None:
        return DEFAULT_PAGE_SIZE
    if int(override) <= 0:
        raise ValueError(f"page_size must be > 0, got {override!r}")
    return int(override)
