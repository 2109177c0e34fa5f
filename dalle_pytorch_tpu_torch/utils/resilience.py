"""Retry policies, preemption handling and file and directory manifests
(counterpart of ``dalle_pytorch_tpu/utils/resilience.py``).

The manifests are written byte for byte as the JAX package writes them
(the same JSON, indent 1, sorted keys, the same temporary names), so a
manifest written by either side verifies on the other.
"""

from __future__ import annotations

import hashlib
import json
import random
import signal
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple, Type

MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMITTED"
FILE_MANIFEST_SUFFIX = ".manifest.json"


# --------------------------------------------------------------- retry


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter: attempt i (0-based) sleeps
    ``min(max_delay, base_delay * 2**i) * uniform(1-jitter, 1)``."""

    attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    jitter: float = 0.5
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Backoff before retry number ``attempt`` (0-based); without
        ``rng`` the jitter factor is left out (the upper envelope)."""
        d = min(self.max_delay, self.base_delay * (2 ** attempt))
        if rng is not None and self.jitter > 0.0:
            d *= 1.0 - self.jitter * rng.random()
        return d


def retry(fn: Callable, policy: RetryPolicy = RetryPolicy(), describe: str = "",
          on_retry: Optional[Callable[[int, BaseException], None]] = None,
          sleep: Callable[[float], None] = time.sleep,
          rng: Optional[random.Random] = None):
    """Call ``fn()`` up to ``policy.attempts`` times and re-raise the last
    error once they are spent. ``on_retry(attempt, exc)`` runs before each
    backoff, that is only when another attempt follows; ``sleep`` and
    ``rng`` are injectable so a test can read the schedule."""
    rng = rng or random.Random()
    attempts = max(1, policy.attempts)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except policy.retry_on as e:
            last = e
            if attempt == attempts - 1:
                break
            if on_retry is not None:
                on_retry(attempt, e)
            delay = policy.delay(attempt, rng)
            print(f"retry {attempt + 1}/{attempts} "
                  f"{describe or getattr(fn, '__name__', 'call')}: "
                  f"{type(e).__name__}: {e} (backoff {delay:.2f}s)", file=sys.stderr)
            if delay > 0:
                sleep(delay)
    assert last is not None
    raise last


# ---------------------------------------------------------- preemption


class PreemptionHandler:
    """SIGTERM / SIGINT become a flag the training loop polls: the first
    signal sets ``triggered`` (the loop finishes its step, writes an
    emergency checkpoint and exits), a second raises ``KeyboardInterrupt``
    (a stuck save can still be stopped by hand). A context manager: the
    previous handlers come back on exit.

    ``on_signal(signum)`` runs inside the first signal's handler (the
    trainer drains the flight recorder there, so its records reach disk
    even if the step or the save then hangs); a hook that raises is
    printed and ignored."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 on_signal: Optional[Callable[[int], None]] = None):
        self.signals = signals
        self.on_signal = on_signal
        self.triggered = False
        self.signum: Optional[int] = None
        self._old = {}

    def _handle(self, signum, frame):
        if self.triggered:
            raise KeyboardInterrupt(f"second signal {signum} during shutdown")
        self.triggered = True
        self.signum = signum
        print(f"signal {signum} received: finishing step, saving emergency "
              "checkpoint, exiting", file=sys.stderr)
        if self.on_signal is not None:
            try:
                self.on_signal(signum)
            except Exception as e:
                print(f"on_signal hook failed (ignored): {type(e).__name__}: {e}",
                      file=sys.stderr)

    def __enter__(self) -> "PreemptionHandler":
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
        return False


# --------------------------------------------------- directory manifests


def _sha256(path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _write_json_atomic(path: Path, obj) -> None:
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(obj, indent=1, sort_keys=True))
    tmp.replace(path)


def write_dir_manifest(dirpath, extra: Optional[dict] = None) -> None:
    """Checksum every file under ``dirpath`` into MANIFEST.json, then
    write the COMMITTED marker, atomically and last: a crash at any point
    leaves no marker (a torn save, which readers skip) or a directory that
    verifies."""
    root = Path(dirpath)
    files = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file() or p.name in (MANIFEST_NAME, COMMIT_NAME):
            continue
        files[p.relative_to(root).as_posix()] = {
            "sha256": _sha256(p), "bytes": p.stat().st_size}
    _write_json_atomic(root / MANIFEST_NAME, {"files": files, **(extra or {})})
    ctmp = root / (COMMIT_NAME + ".tmp")
    ctmp.write_text("ok\n")
    ctmp.replace(root / COMMIT_NAME)


def write_file_manifest(path) -> None:
    """``<path>.manifest.json`` with the file's sha256 and byte size,
    written atomically after the file itself."""
    p = Path(path)
    _write_json_atomic(Path(str(p) + FILE_MANIFEST_SUFFIX),
                       {"sha256": _sha256(p), "bytes": p.stat().st_size})


def verify_file_manifest(path) -> Tuple[bool, str]:
    """-> (ok, reason); reason "no manifest" when the sidecar is absent,
    otherwise the failure: size drift (a torn write) or a checksum
    mismatch (bit corruption)."""
    p = Path(path)
    if not p.exists():
        return False, "file missing"
    mpath = Path(str(p) + FILE_MANIFEST_SUFFIX)
    if not mpath.exists():
        return False, "no manifest"
    try:
        manifest = json.loads(mpath.read_text())
        want_sha, want_bytes = manifest["sha256"], manifest["bytes"]
    except (ValueError, KeyError) as e:
        return False, f"unreadable manifest: {e}"
    if p.stat().st_size != want_bytes:
        return False, f"size mismatch: {p.stat().st_size} != {want_bytes} (torn write)"
    if _sha256(p) != want_sha:
        return False, "checksum mismatch (bit corruption)"
    return True, "ok"


def verify_dir_manifest(dirpath) -> Tuple[bool, str]:
    """-> (ok, reason): the commit marker, a readable manifest, and every
    file it names present with its size and sha256. Files it does not name
    are allowed."""
    root = Path(dirpath)
    if not (root / COMMIT_NAME).exists():
        return False, "no commit marker (torn or in-progress save)"
    mpath = root / MANIFEST_NAME
    if not mpath.exists():
        return False, "commit marker without manifest"
    try:
        files = json.loads(mpath.read_text())["files"]
    except (ValueError, KeyError) as e:
        return False, f"unreadable manifest: {e}"
    for rel, spec in files.items():
        p = root / rel
        if not p.exists():
            return False, f"missing file {rel}"
        if p.stat().st_size != spec["bytes"]:
            return False, f"size mismatch {rel}"
        if _sha256(p) != spec["sha256"]:
            return False, f"checksum mismatch {rel}"
    return True, "ok"
