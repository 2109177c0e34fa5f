"""The port's request journal (``serving/journal.py``) against the JAX
package's on the CPU: JAX's journal cases (``tests/test_recovery.py``,
``TestJournal``) on the port, each journal also read by the other
package, and journals crossing between the packages in both directions.

The records are JAX's field for field: the same calls on both journals
write byte-identical files, a journal either package writes loads on the
other to the same records, unfinished set, outcomes and stage records,
and an image payload encodes to the same bytes. The torn-tail and
corruption model is JAX's: a torn tail is dropped and counted once
(``serve.journal.torn``; the ``journal_torn`` fault on the registry given
to the replay read), a record corrupt mid-file raises the typed
``JournalCorrupt``, and a sealed journal verifies through its manifest.
"""

import numpy as np
import pytest

from dalle_pytorch_tpu.serving import journal as jjournal
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu.utils.metrics import counters as jcounters
from dalle_pytorch_tpu_torch.serving.journal import (
    JournalCorrupt,
    RequestJournal,
    image_from_payload,
    image_to_payload,
    replay_unfinished,
    request_from_record,
    request_to_record,
)
from dalle_pytorch_tpu_torch.serving.types import Request
from dalle_pytorch_tpu_torch.utils.faults import FaultRegistry
from dalle_pytorch_tpu_torch.utils.metrics import counters
from dalle_pytorch_tpu_torch.utils.resilience import verify_file_manifest
from dalle_pytorch_tpu_torch.testing import reset_registries


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    FAULTS.reset()
    yield
    reset_registries()
    FAULTS.reset()


def prompt(i=0):
    return np.random.RandomState(100 + i).randint(1, 16, size=(4,)).astype(np.int32)


def req(i, cls=Request, max_new=4, **kw):
    kw.setdefault("seed", i)
    return cls(request_id=f"r{i}", prompt=prompt(i), max_new_tokens=max_new, **kw)


def image(i=0):
    return np.random.RandomState(7 + i).rand(4, 4, 3).astype(np.float32)


def write_both(tmp_path, script):
    """Run ``script(journal, request_cls)`` on a port and a JAX journal;
    returns their paths."""
    paths = {}
    for name, journal_cls, cls in (("port", RequestJournal, Request),
                                   ("jax", jjournal.RequestJournal, JRequest)):
        p = str(tmp_path / f"{name}.jsonl")
        j = journal_cls(p)
        script(j, cls)
        j.close()
        paths[name] = p
    return paths["port"], paths["jax"]


def mixed(j, cls):
    """Admissions, stage records (tokens, then an image), outcomes."""
    j.append_admitted(req(0, cls, deadline=30.0, priority=2), now=10.0)
    j.append_admitted(req(1, cls), now=10.5)
    j.append_admitted(req(2, cls, deadline=99.0), now=11.0)
    j.append_stage("r1", "tokens", {"tokens": np.arange(4, dtype=np.int32)}, now=12.0)
    j.append_stage("r1", "vae_decode", {"image": image(1)}, now=12.5)
    j.append_stage("r2", "tokens", {"tokens": [3, 1, 4, 1]}, now=13.0)
    j.append_outcome("r0", "completed", now=14.0)


# --------------------------------------------------- JAX's journal cases


def test_record_roundtrip():
    r = req(7, deadline=12.5, priority=2)
    rec = request_to_record(r, now=1.0)
    assert rec == jjournal.request_to_record(req(7, JRequest, deadline=12.5, priority=2), 1.0)
    back = request_from_record(rec)
    assert (back.request_id, back.max_new_tokens, back.deadline, back.priority, back.seed) == (
        r.request_id, r.max_new_tokens, r.deadline, r.priority, r.seed)
    assert np.array_equal(back.prompt, r.prompt)


def test_deadline_rebased_onto_restarted_clock():
    rec = request_to_record(req(0, deadline=30.0), now=10.0)
    assert rec["deadline_remaining"] == 20.0
    assert request_from_record(rec, now=1000.0).deadline == 1020.0
    assert request_from_record(rec).deadline == 30.0
    rec2 = request_to_record(req(1), now=10.0)
    assert request_from_record(rec2, now=1000.0).deadline is None
    # JAX's reader rebases the port's record the same way
    assert jjournal.request_from_record(rec, now=1000.0).deadline == 1020.0


def test_unfinished_is_idempotent(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    j.append_admitted(req(0), now=0.0)
    j.append_admitted(req(1), now=0.1)
    j.append_outcome("r0", "completed", now=1.0)
    j.close()
    assert [r.request_id for r in RequestJournal.unfinished(p)] == ["r1"]
    j2 = RequestJournal(p)
    assert replay_unfinished(p, lambda r: j2.append_admitted(r, 2.0)) == ["r1"]
    assert counters.get("serve.journal.replayed") == 1
    j2.append_outcome("r1", "completed", now=3.0)
    j2.close()
    assert RequestJournal.unfinished(p) == []
    assert RequestJournal.outcomes(p) == {"r0": "completed", "r1": "completed"}
    assert jjournal.RequestJournal.unfinished(p) == []
    assert jjournal.RequestJournal.outcomes(p) == RequestJournal.outcomes(p)


def test_torn_tail_dropped_and_counted(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    j.append_admitted(req(0), now=0.0)
    j.append_admitted(req(1), now=0.1)
    j.close()
    data = open(p, "rb").read()
    open(p, "wb").write(data[:-7])
    records, torn = RequestJournal.load(p)
    assert torn == 1 and counters.get("serve.journal.torn") == 1
    assert [r["request_id"] for r in records] == ["r0"]
    assert [r.request_id for r in RequestJournal.unfinished(p)] == ["r0"]
    assert jjournal.RequestJournal.load(p, count=False) == (records, 1)


def test_journal_torn_fault_drill(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    j.append_admitted(req(0), now=0.0)
    j.append_admitted(req(1), now=0.1)
    j.close()
    faults = FaultRegistry()
    faults.arm("journal_torn", 1)
    FAULTS.arm("journal_torn", 1)
    ours = RequestJournal.load(p, faults=faults)
    theirs = jjournal.RequestJournal.load(p)
    assert ours == theirs and ours[1] == 1
    assert [r["request_id"] for r in ours[0]] == ["r0"]
    assert counters.get("serve.fault_journal_torn") == 1 == jcounters.get("serve.fault_journal_torn")
    # the drill is spent: the next load sees the intact file
    records, torn = RequestJournal.load(p, faults=faults)
    assert torn == 0 and len(records) == 2


def test_torn_tail_counted_once_across_recovery_reads(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    j.append_admitted(req(0), now=0.0)
    j.append_outcome("r0", "completed", now=0.5)
    j.append_admitted(req(1), now=1.0)
    j.close()
    data = open(p, "rb").read()
    open(p, "wb").write(data[:-7])
    seen = {}
    assert replay_unfinished(p, lambda r: None, reconcile=seen.__setitem__) == []
    assert seen == {"r0": "completed"}
    assert counters.get("serve.journal.torn") == 1
    RequestJournal.verify(p)
    RequestJournal.outcomes(p)
    RequestJournal.unfinished(p, count=False)
    assert counters.get("serve.journal.torn") == 1
    # JAX's replay of the same file reconciles and counts the same
    jseen = {}
    assert jjournal.replay_unfinished(p, lambda r: None, reconcile=jseen.__setitem__) == []
    assert jseen == seen and jcounters.get("serve.journal.torn") == 1


def test_midfile_corruption_raises_typed(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    for i in range(3):
        j.append_admitted(req(i), now=0.1 * i)
    j.close()
    lines = open(p).read().splitlines()
    lines[0] = lines[0][:10]
    open(p, "w").write("\n".join(lines) + "\n")
    with pytest.raises(JournalCorrupt):
        RequestJournal.load(p)
    ok, reason = RequestJournal.verify(p)
    assert not ok and "unparseable" in reason
    assert jjournal.RequestJournal.verify(p) == (ok, reason)


def test_seal_writes_manifest_and_verify(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    j.append_admitted(req(0), now=0.0)
    j.seal()
    assert verify_file_manifest(p)[0]
    assert RequestJournal.verify(p) == (True, "ok") == jjournal.RequestJournal.verify(p)
    j2 = RequestJournal(p)
    j2.append_admitted(req(1), now=1.0)
    j2.close()
    ok, reason = RequestJournal.verify(p)
    assert ok and "unsealed" in reason
    assert jjournal.RequestJournal.verify(p) == (ok, reason)


# ------------------------------------------- across the two packages


def test_same_calls_write_the_same_bytes(tmp_path):
    port_path, jax_path = write_both(tmp_path, mixed)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_crosses_packages(tmp_path, writer):
    """A journal written by one package reads and replays on the other:
    the same records, unfinished set (with deadlines rebased), outcomes
    and stages, and the staged replay resumes the same requests with the
    same tokens and image."""
    port_path, jax_path = write_both(tmp_path, mixed)
    p = jax_path if writer == "jax" else port_path
    assert RequestJournal.load(p, count=False) == jjournal.RequestJournal.load(p, count=False)
    ours = RequestJournal.unfinished(p, now=500.0, count=False)
    theirs = jjournal.RequestJournal.unfinished(p, now=500.0, count=False)
    assert [(r.request_id, r.deadline, r.priority, r.seed, r.max_new_tokens) for r in ours] == [
        (r.request_id, r.deadline, r.priority, r.seed, r.max_new_tokens) for r in theirs]
    assert [r.request_id for r in ours] == ["r1", "r2"]
    assert ours[1].deadline == 500.0 + 88.0
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.prompt, b.prompt)
    assert RequestJournal.outcomes(p) == jjournal.RequestJournal.outcomes(p) == {"r0": "completed"}
    assert RequestJournal.stages(p) == jjournal.RequestJournal.stages(p)

    def replay(mod):
        staged, plain = [], []
        replayed = mod.replay_unfinished(
            p, submit=lambda r: plain.append(r.request_id),
            submit_staged=lambda r, tokens, image=None: staged.append(
                (r.request_id, [int(t) for t in tokens],
                 None if image is None else image.tobytes())))
        return replayed, staged, plain

    assert replay(jjournal) == replay(__import__(
        "dalle_pytorch_tpu_torch.serving.journal", fromlist=["replay_unfinished"]))
    _, staged, plain = replay(jjournal)
    assert [s[0] for s in staged] == ["r1", "r2"] and plain == []
    assert staged[0][1] == [0, 1, 2, 3] and staged[0][2] == image(1).tobytes()
    assert staged[1][2] is None


def test_image_payload_bytes_equal():
    img = image(3)
    ours, theirs = image_to_payload(img), jjournal.image_to_payload(img)
    assert ours == theirs
    assert image_from_payload(theirs).tobytes() == img.tobytes()
    bad = dict(ours, sha256="0" * 64)
    with pytest.raises(JournalCorrupt):
        image_from_payload(bad)
