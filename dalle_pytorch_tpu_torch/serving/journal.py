"""Durable request journal (counterpart of
``dalle_pytorch_tpu/serving/journal.py``): an append-only JSONL
write-ahead log of admitted requests, their completed post-decode stages
and their terminal outcomes, so that a restarted process replays the
unfinished ones bit-identically.

A request's tokens depend only on its seed and positions (the sampling
contract of ``serving/engine.py``), so its admission record carries
exactly the fields that make a replay reproduce them: request id,
prompt, max_new_tokens, priority, seed and deadline. An outcome record
closes a request, which makes replay idempotent: ``unfinished()`` is the
admissions without an outcome. A stage record (``stage="tokens"`` with
the finished image tokens, ``stage="vae_decode"`` with the decoded
image) lets a request resume at the stage after its last completed one
(``replay_unfinished(submit_staged=...)``). The records are the JAX
package's, field for field and byte for byte (``json.dumps(...,
sort_keys=True)``), so a journal written by either package loads and
replays on the other.

Failure model:

* **Torn tail.** A crash mid-append leaves a last record without its
  newline or cut short. It is the only damage an append-only log can
  legally hold: the loader drops it and counts it once
  (``serve.journal.torn``; the ``journal_torn`` fault tears the tail as
  it is read). The dropped request was never acknowledged durable.
* **Mid-file corruption.** An unparseable record before the tail is bit
  rot, not a crash: the loader raises ``JournalCorrupt``.
* **Graceful shutdown.** ``seal()`` flushes, closes and writes the
  sidecar file manifest (``utils/resilience.py:write_file_manifest``);
  ``verify()`` checks it. A crashed journal has no manifest and still
  loads through the torn-tail scan.

Host-side only: numpy and the standard library.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.faults import FaultRegistry
from ..utils.metrics import counters
from ..utils.resilience import FILE_MANIFEST_SUFFIX, verify_file_manifest, write_file_manifest
from .types import Request

_ADMITTED = "admitted"
_OUTCOME = "outcome"
# one per completed post-decode stage boundary; duplicates are legal (a
# failover re-announces) and the loader keeps the last per (request, stage)
_STAGE = "stage"
_KINDS = (_ADMITTED, _OUTCOME, _STAGE)


class JournalCorrupt(RuntimeError):
    """A record before the journal's tail failed to parse: bit rot, not a
    torn append. Loaders do not guess past it."""


def image_to_payload(image: np.ndarray) -> dict:
    """A decoded image as JSON: its raw bytes in base64, shape, dtype and
    a sha256 of the bytes (checked on load)."""
    arr = np.ascontiguousarray(image)
    raw = arr.tobytes()
    return {
        "b64": base64.b64encode(raw).decode("ascii"),
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "sha256": hashlib.sha256(raw).hexdigest(),
    }


def image_from_payload(payload: dict) -> np.ndarray:
    """Inverse of ``image_to_payload``; ``JournalCorrupt`` when the bytes
    do not match their digest."""
    raw = base64.b64decode(payload["b64"])
    if hashlib.sha256(raw).hexdigest() != payload["sha256"]:
        raise JournalCorrupt("stage image payload digest mismatch")
    return np.frombuffer(raw, dtype=np.dtype(payload["dtype"])).reshape(payload["shape"]).copy()


def request_to_record(request: Request, now: float) -> dict:
    """The admission record of one request. The deadline is kept absolute
    and as the budget remaining at admission: an instant on one process's
    monotonic clock means nothing to the next process, so a replay rebases
    the remaining budget (``request_from_record(now=...)``)."""
    return {
        "kind": _ADMITTED,
        "request_id": request.request_id,
        "prompt": [int(t) for t in np.asarray(request.prompt).reshape(-1)],
        "max_new_tokens": int(request.max_new_tokens),
        "deadline": None if request.deadline is None else float(request.deadline),
        "deadline_remaining": (
            None if request.deadline is None
            else max(0.0, float(request.deadline) - float(now))
        ),
        "priority": int(request.priority),
        "seed": int(request.seed),
        "t": float(now),
    }


def request_from_record(rec: dict, now: Optional[float] = None) -> Request:
    """The request of an admission record. With ``now`` (the restarted
    process's clock) a deadline is the remaining budget from ``now``;
    without it, the absolute value as recorded."""
    deadline = rec.get("deadline")
    if now is not None and deadline is not None:
        remaining = rec.get("deadline_remaining")
        deadline = None if remaining is None else float(now) + remaining
    return Request(
        request_id=rec["request_id"],
        prompt=np.asarray(rec["prompt"], np.int32),
        max_new_tokens=int(rec["max_new_tokens"]),
        deadline=deadline,
        priority=int(rec.get("priority", 0)),
        seed=int(rec.get("seed", 0)),
    )


class RequestJournal:
    """One file, one writer (the router appends under its lock), any
    number of readers after a crash. ``fsync``: sync each record to the
    disk (surviving the host, not only the process)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = str(path)
        self._fsync = fsync
        self._fh = None

    # ------------------------------------------------------------ writes

    def _append(self, rec: dict) -> None:
        if self._fh is None:
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            # reopening a sealed journal makes its manifest stale
            stale = Path(self.path + FILE_MANIFEST_SUFFIX)
            if stale.exists():
                stale.unlink()
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def append_admitted(self, request: Request, now: float) -> None:
        """Record one admission, after every typed-reject gate passed: the
        journal holds exactly the requests owed a terminal outcome."""
        self._append(request_to_record(request, now))
        counters.inc("serve.journal.appended")

    def append_outcome(self, request_id: str, outcome: str, now: float) -> None:
        """Record one terminal outcome."""
        self._append({"kind": _OUTCOME, "request_id": request_id,
                      "outcome": outcome, "t": float(now)})

    def append_stage(self, request_id: str, stage: str, payload: dict, now: float) -> None:
        """Record one completed stage boundary. ``payload`` may hold the
        pipeline's in-memory values (``{"tokens": ids}``,
        ``{"image": ndarray}``); an image is encoded here
        (``image_to_payload``)."""
        enc: dict = {}
        for k, v in payload.items():
            if k == "image":
                enc[k] = image_to_payload(np.asarray(v, np.float32))
            elif isinstance(v, np.ndarray):
                enc[k] = [int(t) for t in v.reshape(-1)]
            else:
                enc[k] = v
        self._append({"kind": _STAGE, "request_id": request_id, "stage": stage,
                      "payload": enc, "t": float(now)})
        counters.inc("serve.stage.journal_records")

    def seal(self) -> None:
        """Graceful shutdown: flush, close, then write the sidecar manifest
        (the file is complete before the manifest names it)."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        if Path(self.path).exists():
            write_file_manifest(self.path)

    def close(self) -> None:
        """Drop the handle without sealing: the file is what a dead
        process leaves (the crash seam of tests and drills)."""
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------------- reads

    @classmethod
    def load(cls, path: str, count: bool = True,
             faults: Optional[FaultRegistry] = None) -> Tuple[List[dict], int]:
        """(records, torn tail records). A last segment that does not parse
        or lacks its newline is the torn tail: dropped and, with
        ``count``, counted under ``serve.journal.torn``; an unparseable
        record earlier raises ``JournalCorrupt``. ``faults``: the registry
        whose ``journal_torn`` site tears the tail as it is read (consulted
        only by a counting read). ``count=False`` is for secondary reads
        (verification, outcomes, stages), so one torn tail moves the
        counter, and spends the drill, once a recovery."""
        p = Path(path)
        if not p.exists():
            return [], 0
        data = p.read_text(encoding="utf-8")
        if data and count and faults is not None and faults.take("journal_torn"):
            counters.inc("serve.fault_journal_torn")
            data = data[: max(0, len(data) - 5)]  # the newline and a few bytes
        segments = data.split("\n")
        complete, tail = segments[:-1], segments[-1]
        records: List[dict] = []
        torn = 0
        for i, line in enumerate(complete):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or rec.get("kind") not in _KINDS:
                    raise ValueError(f"not a known journal record: {line[:60]!r}")
            except ValueError as e:
                if i == len(complete) - 1 and not tail:
                    torn += 1  # the last line, complete-looking but torn
                    break
                raise JournalCorrupt(
                    f"{path}: unparseable non-tail record at line {i + 1}: {e}"
                ) from e
            records.append(rec)
        if tail.strip():
            torn += 1  # bytes past the last newline: a torn append
        if torn and count:
            counters.inc("serve.journal.torn", torn)
        return records, torn

    @classmethod
    def unfinished(cls, path: str, now: Optional[float] = None, count: bool = True,
                   faults: Optional[FaultRegistry] = None) -> List[Request]:
        """The replay set: admitted requests without an outcome record, in
        admission order (a re-admitted request counts once). ``now``
        rebases deadlines onto the restarted clock. The recovery read: it
        counts a torn tail unless ``count=False``."""
        records, _ = cls.load(path, count=count, faults=faults)
        admitted: Dict[str, dict] = {}
        done: set = set()
        for rec in records:
            if rec["kind"] == _ADMITTED:
                admitted.setdefault(rec["request_id"], rec)
            elif rec["kind"] == _OUTCOME:
                done.add(rec["request_id"])
        return [request_from_record(rec, now=now)
                for rid, rec in admitted.items() if rid not in done]

    @classmethod
    def stages(cls, path: str) -> Dict[str, Dict[str, dict]]:
        """request_id -> {stage -> payload}, the last record of each
        (request, stage) winning."""
        records, _ = cls.load(path, count=False)
        out: Dict[str, Dict[str, dict]] = {}
        for rec in records:
            if rec["kind"] == _STAGE:
                out.setdefault(rec["request_id"], {})[rec["stage"]] = rec["payload"]
        return out

    @classmethod
    def outcomes(cls, path: str) -> Dict[str, str]:
        """request_id -> outcome of every terminal record."""
        records, _ = cls.load(path, count=False)
        return {rec["request_id"]: rec["outcome"] for rec in records if rec["kind"] == _OUTCOME}

    @classmethod
    def verify(cls, path: str) -> Tuple[bool, str]:
        """The sidecar manifest (sealed journals) and a full parse. An
        unsealed journal (a crash leaves no manifest) verifies when its
        parse is clean."""
        ok, reason = verify_file_manifest(path)
        if not ok and reason != "no manifest":
            return False, reason
        try:
            _, torn = cls.load(path, count=False)
        except JournalCorrupt as e:
            return False, str(e)
        if torn:
            return True, f"ok ({torn} torn tail record dropped)"
        if not ok:
            return True, "ok (unsealed: no manifest — crash recovery)"
        return True, "ok"


def replay_unfinished(path: str, submit: Callable[[Request], object],
                      reconcile: Optional[Callable[[str, str], None]] = None,
                      now: Optional[float] = None,
                      submit_staged: Optional[Callable] = None,
                      faults: Optional[FaultRegistry] = None) -> List[str]:
    """Resubmit every unfinished journaled request through ``submit``
    (``Router.submit`` of the restarted process) and return the ids
    re-admitted, each counted under ``serve.journal.replayed``. A
    resubmission that ``submit`` rejects typed (a non-None return) is not
    counted: its result is already the router's. ``reconcile(request_id,
    outcome)`` receives every journaled outcome first (the finished
    requests, handed back without a rerun). ``submit_staged(request,
    tokens, image=None)`` (``Router.submit_staged``) receives every
    unfinished request whose journal holds its tokens: it resumes at VAE
    decode, or with its decoded image at the rerank, instead of decoding
    again; without it such a request replays from the top, the same
    tokens by the sampling contract. ``now`` rebases deadlines;
    ``faults`` arms ``journal_torn`` on the replay read."""
    if reconcile is not None:
        for rid, outcome in RequestJournal.outcomes(path).items():
            reconcile(rid, outcome)
    staged = RequestJournal.stages(path) if submit_staged is not None else {}
    replayed: List[str] = []
    for request in RequestJournal.unfinished(path, now=now, faults=faults):
        st = staged.get(request.request_id)
        if st is not None and "tokens" in st:
            tokens = np.asarray(st["tokens"]["tokens"], np.int32)
            img = st.get("vae_decode")
            image = None if img is None else image_from_payload(img["image"])
            res = submit_staged(request, tokens, image=image)
        else:
            res = submit(request)
        if res is not None:
            continue  # a typed reject: delivered through the results
        counters.inc("serve.journal.replayed")
        replayed.append(request.request_id)
    return replayed
