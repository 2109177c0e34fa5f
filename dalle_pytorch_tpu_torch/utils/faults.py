"""Deterministic fault injection for the serving engine (counterpart of
``dalle_pytorch_tpu/utils/faults.py``'s registry, serving sites only).

A fault site is a named counter: the engine asks the registry at the
site whether to fail, the registry counts one down, and once the armed
count is spent the site behaves normally, the shape of a transient
production fault. There is no process-wide registry and no environment
variable: a caller builds a ``FaultRegistry``, arms it, and hands it to
``Engine(..., faults=registry)``.

Sites:

================== ======================================================
``prefill_fail``   a prefill attempt fails (monolithic: the whole pass;
                   chunked: one chunk, retried from the last completed
                   chunk); the request is retried until it has failed
                   ``EngineConfig.prefill_attempts`` times
``page_exhaust``   a decode-time page allocation fails although the pool
                   has free pages, forcing the preempt-and-requeue path
``decode_stall``   one iteration stalls: the engine clock advances by
                   ``EngineConfig.stall_penalty_s``
``request_cancel`` the youngest running request is cancelled (a client
                   disconnecting)
================== ======================================================
"""

from __future__ import annotations

from typing import Dict, Optional

SITES = ("prefill_fail", "page_exhaust", "decode_stall", "request_cancel")


class FaultRegistry:
    """Named, counted injection points; ``fired`` tallies the failures
    each site has delivered."""

    def __init__(self):
        self._armed: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    def arm(self, site: str, count: int = 1) -> None:
        """Fail the next ``count`` visits to ``site``."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (known: {SITES})")
        self._armed[site] = count

    def reset(self) -> None:
        self._armed.clear()
        self.fired.clear()

    def value(self, site: str) -> Optional[int]:
        """The failures still armed at ``site`` (None when unarmed);
        does not consume."""
        return self._armed.get(site)

    def take(self, site: str) -> bool:
        """Consume one armed failure at ``site``: True exactly ``count``
        times after ``arm(site, count)``, then False."""
        remaining = self._armed.get(site, 0)
        if remaining <= 0:
            return False
        self._armed[site] = remaining - 1
        self.fired[site] = self.fired.get(site, 0) + 1
        return True
