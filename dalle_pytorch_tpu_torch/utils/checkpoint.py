"""Checkpoint store (counterpart of ``dalle_pytorch_tpu/utils/checkpoint.py``).

Plain format: one msgpack file (``utils/msgpack.py``, flax's encoding)
holding ``{"__dalle_tpu_meta__": <meta as JSON>, "state": <tree>}``,
written to ``<path>.tmp``, swapped in with ``os.replace``, then given its
sha256 sidecar (``<path>.manifest.json``). A file either side writes, the
other reads: JAX's ``load_checkpoint`` gets numpy arrays where this one
gets tensors.

Step directories, with JAX's commit protocol: ``<dir>/step_%08d/`` holds
the payload, then ``MANIFEST.json`` (every file's sha256 and size, the
step and the meta) and the ``COMMITTED`` marker, last; ``<dir>/aux.json``
is rewritten atomically; ``keep_n`` rotation deletes torn directories
(no marker) first and then all but the newest ``keep_n`` committed ones;
``latest_verified_step`` and ``load_sharded_checkpoint`` skip torn or
corrupt directories. On one card the payload is the port's own: the whole
train state as one plain-format file, ``train_state.msgpack``. JAX's
directories hold orbax's layout instead, which this module does not read.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from typing import Any, Optional, Tuple

from . import msgpack
from .resilience import (
    COMMIT_NAME,
    FILE_MANIFEST_SUFFIX,
    MANIFEST_NAME,
    verify_dir_manifest,
    verify_file_manifest,
    write_dir_manifest,
    write_file_manifest,
)

HEADER_KEY = "__dalle_tpu_meta__"
STATE_FILE = "train_state.msgpack"


class CheckpointError(RuntimeError):
    """A checkpoint that is missing, torn or corrupt."""


def _write_payload(path: Path, state: Any, meta: Optional[dict]) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb", buffering=1 << 24) as f:
        msgpack.dump({HEADER_KEY: json.dumps(meta or {}), "state": state}, f)
    tmp.replace(path)


def save_checkpoint(path, state: Any, meta: Optional[dict] = None) -> None:
    """Plain single-file save of ``state`` (a tree of dicts with str keys,
    tensors, numpy arrays and Python scalars) and ``meta``. The previous
    save's sidecar goes first, so a crash before the new one leaves "no
    manifest", never a stale one."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    Path(str(p) + FILE_MANIFEST_SUFFIX).unlink(missing_ok=True)
    _write_payload(p, state, meta)
    write_file_manifest(p)


def load_checkpoint(path) -> Tuple[Any, dict]:
    """-> (state, meta) of a plain checkpoint, arrays as CPU tensors."""
    p = Path(path)
    data = bytearray(p.stat().st_size)
    with open(p, "rb") as f:
        if f.readinto(data) != len(data):
            raise CheckpointError(f"checkpoint {path}: short read")
    raw = msgpack.loads(data)
    meta = json.loads(raw.pop(HEADER_KEY, "{}"))
    return raw["state"], meta


def check_checkpoint_file(path, require_manifest: bool = False) -> None:
    """Raise ``CheckpointError`` with the manifest verifier's reason for a
    missing, torn or corrupt plain checkpoint, before reading it. A file
    without a sidecar passes with a warning unless ``require_manifest``."""
    ok, reason = verify_file_manifest(path)
    if ok:
        return
    if reason == "no manifest" and not require_manifest:
        print(f"WARNING: {path} has no manifest sidecar (pre-manifest save); "
              "loading unverified", file=sys.stderr)
        return
    raise CheckpointError(f"checkpoint {path}: {reason}")


# ------------------------------------------------------- step directories


def save_sharded_checkpoint(ckpt_dir, step: int, state: Any, meta: Optional[dict] = None,
                            keep_n: Optional[int] = None, faults=None) -> str:
    """Write ``<ckpt_dir>/step_<step>/`` (replacing one of that step),
    commit it, rewrite ``aux.json`` and rotate. ``faults`` (a
    ``utils.faults.FaultRegistry``) may fire ``ckpt_corrupt`` after the
    commit. Returns the directory."""
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    target = (root / f"step_{step:08d}").resolve()
    if target.exists():
        shutil.rmtree(target)
    target.mkdir()
    _write_payload(target / STATE_FILE, state, None)
    # the meta rides in the manifest: a fallback to an older step must
    # restore that step's meta, not the newest aux.json
    write_dir_manifest(target, extra={"step": step, "meta": meta or {}})
    if faults is not None and faults.take("ckpt_corrupt"):
        corrupt_one_file(target)
    aux = root / "aux.json"
    tmp = aux.with_suffix(".json.tmp")
    tmp.write_text(json.dumps({"meta": meta or {}, "latest": step}))
    tmp.replace(aux)
    if keep_n is not None:
        committed, torn = [], []
        for d in sorted(root.glob("step_*")):
            (committed if (d / COMMIT_NAME).exists() else torn).append(d)
        for old in torn + committed[:-keep_n]:
            shutil.rmtree(old, ignore_errors=True)
    return str(target)


def corrupt_one_file(step_dir) -> None:
    """The ``ckpt_corrupt`` fault: flip the first 64 bytes of the largest
    payload file after the manifest committed."""
    payload = [p for p in Path(step_dir).rglob("*")
               if p.is_file() and p.name not in (MANIFEST_NAME, COMMIT_NAME)]
    victim = max(payload, key=lambda p: p.stat().st_size)
    with open(victim, "r+b") as f:
        head = bytearray(f.read(64))
        f.seek(0)
        f.write(bytes(b ^ 0xFF for b in head))
    print(f"fault ckpt_corrupt: flipped bytes in {victim}", file=sys.stderr)


def verify_step_dir(step_dir) -> Tuple[bool, str]:
    """-> (ok, reason): the commit marker, and every file of the manifest
    with its size and sha256."""
    return verify_dir_manifest(step_dir)


def latest_verified_step(ckpt_dir) -> Optional[int]:
    """The newest step whose directory verifies; None when none does or
    ``ckpt_dir`` does not exist."""
    root = Path(ckpt_dir)
    if not root.is_dir():
        return None
    for path in sorted(root.glob("step_*"), reverse=True):
        if verify_dir_manifest(path)[0]:
            return int(path.name.split("_")[1])
    return None


def load_sharded_checkpoint(ckpt_dir, step: Optional[int] = None,
                            verify: bool = True) -> Tuple[Any, dict, int]:
    """-> (state, meta, step) of the newest verified step directory (torn
    and corrupt ones are skipped with a warning), or of ``step``, which
    must verify unless ``verify`` is False (for a step the caller has just
    verified). Raises ``CheckpointError`` when nothing verifies."""
    root = Path(ckpt_dir)
    if step is None:
        steps = sorted(root.glob("step_*"), reverse=True)
        path = None
        for cand in steps:
            ok, reason = verify_dir_manifest(cand)
            if ok:
                path = cand
                break
            print(f"checkpoint {cand.name} skipped: {reason}", file=sys.stderr)
        if path is None:
            raise CheckpointError(f"no verified step_* checkpoint under {ckpt_dir} "
                                  f"({len(steps)} directories present)")
        step = int(path.name.split("_")[1])
    else:
        path = root / f"step_{step:08d}"
        if verify:
            ok, reason = verify_dir_manifest(path)
            if not ok:
                raise CheckpointError(f"checkpoint {path} failed verification: {reason}")
    state, _ = load_checkpoint(path / STATE_FILE)
    meta = json.loads((path / MANIFEST_NAME).read_text()).get("meta", {})
    return state, meta, step
