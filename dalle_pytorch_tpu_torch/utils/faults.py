"""Deterministic fault injection (counterpart of
``dalle_pytorch_tpu/utils/faults.py``'s registry: the serving engine's
sites, the trainer's, the tar-shard loader's and the telemetry sink's).

A fault site is a named counter: the code asks the registry at the site
whether to fail, the registry counts one down, and once the armed count
is spent the site behaves normally, the shape of a transient production
fault. There is no process-wide registry. The engine's caller builds a
``FaultRegistry``, arms it, and hands it to ``Engine(..., faults=registry)``;
the trainer's command line reads its sites from ``DALLE_TPU_FAULTS``
(``FaultRegistry.from_env()``, the JAX package's format, e.g.
``DALLE_TPU_FAULTS="nan_at_step=5,ckpt_corrupt=1"``), so that a relaunched
process is armed without any plumbing.

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
``prefix_hash_collide`` a prefix-index lookup returns a forged chain node
                   (a hash collision); token verification rejects it and
                   the request prefills cold from there
``prefix_publish_fail`` publishing a completed request's prompt pages
                   into the prefix index fails; the request completes and
                   its pages stay private (fail-open)
``spec_verify_abort`` the speculative drafter fails for one iteration,
                   which runs plain decode (verify width 1) instead
``nan_at_step``    the train step forces the loss to NaN at step K (a
                   value site: the armed number is K, ``take`` never
                   consumes it)
``ckpt_corrupt``   after a step directory commits, 64 bytes of its largest
                   payload file are flipped (bit rot that only the
                   checksums catch)
``shard_open``     opening a tar shard raises ``OSError`` (retried, and
                   the shard quarantined once the retries are spent)
``shard_read``     reading the next sample of a tar shard raises
                   ``tarfile.TarError`` (the rest of the shard is dropped)
``telemetry_sink_fail`` the flight recorder's drain raises ``OSError``
                   (counted under ``telemetry.sink_errors``, never raised
                   into the loop; armed on ``Telemetry.faults``)
================== ======================================================
"""

from __future__ import annotations

import os
from typing import Dict, Optional

ENV_VAR = "DALLE_TPU_FAULTS"
SITES = ("prefill_fail", "page_exhaust", "decode_stall", "request_cancel",
         "prefix_hash_collide", "prefix_publish_fail", "spec_verify_abort",
         "nan_at_step", "ckpt_corrupt", "shard_open", "shard_read", "telemetry_sink_fail")
# sites whose armed number is a parameter (a step index), not a count
VALUE_SITES = frozenset({"nan_at_step"})


class FaultRegistry:
    """Named, counted injection points; ``fired`` tallies the failures
    each site has delivered."""

    def __init__(self):
        self._armed: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    @classmethod
    def from_env(cls, environ=None) -> "FaultRegistry":
        """A registry armed from ``DALLE_TPU_FAULTS`` (``site=count,...``);
        an unknown site or an entry without ``=`` raises ``ValueError``."""
        registry = cls()
        spec = (os.environ if environ is None else environ).get(ENV_VAR, "")
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"bad {ENV_VAR} entry {part!r}: want site=count")
            site, _, count = part.partition("=")
            registry.arm(site.strip(), int(count))
        return registry

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
        if site in VALUE_SITES or remaining <= 0:
            return False
        self._armed[site] = remaining - 1
        self.fired[site] = self.fired.get(site, 0) + 1
        return True

    def maybe_raise(self, site: str, exc: BaseException) -> None:
        """Raise ``exc`` when a failure is armed at ``site`` (consuming it)."""
        if self.take(site):
            raise exc
