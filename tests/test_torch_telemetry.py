"""The port's telemetry layer (``dalle_pytorch_tpu_torch/utils/
telemetry.py``), the counterparts of ``tests/test_telemetry.py``'s span
and flight-recorder tests: nesting and parents on a ``FakeClock``,
non-lexical spans, drain and validate, an unclosed span as the
postmortem, ring overflow (dropped and counted without a flight
directory, drained with one), rotation under a byte cap with a span
straddling it, an end past two rotations counted as an orphan, disabled
as a no-op (no thread, no file, no record); the ``telemetry_sink_fail``
fault counted and contained; the ``on_signal`` hook of
``PreemptionHandler`` (a failing hook ignored); ``dump()`` text-equal to
JAX's for the same registry contents; ``/metrics`` served on 127.0.0.1
only; the environment switches; the module importing neither torch nor
jax; and a real SIGTERM to a subprocess draining a valid flight file."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from dalle_pytorch_tpu.utils import metrics as jm
from dalle_pytorch_tpu.utils.telemetry import Telemetry as JTelemetry
from dalle_pytorch_tpu_torch.serving.types import FakeClock
from dalle_pytorch_tpu_torch.testing import reset_registries
from dalle_pytorch_tpu_torch.utils.metrics import counters, gauges, histograms
from dalle_pytorch_tpu_torch.utils.resilience import PreemptionHandler
from dalle_pytorch_tpu_torch.utils.telemetry import (
    TELEMETRY,
    Telemetry,
    configure_from_env,
    validate_flight_file,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_registries():
    reset_registries()
    yield
    reset_registries()


@pytest.fixture
def tel(tmp_path):
    """A private telemetry on a FakeClock with a ring of 64."""
    t = Telemetry(clock=FakeClock(), ring_size=64)
    t.configure(enabled=True, flight_dir=str(tmp_path / "flight"))
    yield t
    t.reset()


def test_nesting_parents_and_fake_clock_durations(tel):
    with tel.span("train.outer", step=7) as outer:
        tel.clock.advance(1.0)
        with tel.span("train.inner") as inner:
            tel.clock.advance(0.25)
        tel.event("train.mark", note="x")
    by = {(r.get("name"), r["ph"]): r for r in tel.records()}
    assert by[("train.outer", "B")]["parent"] is None
    assert by[("train.inner", "B")]["parent"] == outer
    assert by[("train.inner", "E")]["id"] == inner
    assert by[("train.mark", "I")]["parent"] == outer
    assert by[("train.inner", "E")]["dur_s"] == 0.25
    assert by[("train.outer", "E")]["dur_s"] == 1.25
    assert by[("train.outer", "B")]["step"] == 7
    assert histograms.get("train.outer_s").count == 1
    assert histograms.get("train.inner_s").sum == 0.25


def test_begin_end_non_lexical(tel):
    a = tel.begin("serve.request", request_id="r1")
    b = tel.begin("serve.request", request_id="r2")
    tel.clock.advance(2.0)
    tel.end(b, outcome="completed")
    tel.end(a, outcome="cancelled")
    ends = [r for r in tel.records() if r["ph"] == "E"]
    assert [e["outcome"] for e in ends] == ["completed", "cancelled"]
    assert all(e["dur_s"] == 2.0 for e in ends)
    assert histograms.get("serve.request_s").count == 2


def test_records_equal_jax_for_the_same_calls(tmp_path):
    """The same calls on both layers give the same records (ids, parents,
    times and attributes) and the same duration histograms."""
    out = []
    for cls, hists in ((Telemetry, histograms), (JTelemetry, jm.histograms)):
        t = cls(clock=FakeClock(), ring_size=64)
        t.configure(enabled=True)
        with t.span("serve.iteration", n_decode=2):
            r = t.begin("serve.request", request_id="a", priority=0)
            t.clock.advance(0.5)
            t.event("serve.admit", request_id="a", parent=r, slot=0)
        t.end(r, outcome="completed", n_tokens=4)
        t.end(None)
        out.append((t.records(), hists.snapshot()) if cls is Telemetry
                   else (list(t._buf), hists.snapshot()))
        t.reset()
    assert out[0] == out[1]


def test_drain_and_validate(tel):
    with tel.span("a"):
        tel.event("e")
    s = validate_flight_file(tel.drain("test"))
    assert s["spans"] == 1 and s["unclosed"] == []
    assert s["by_name"] == {"a": 2, "e": 1, "telemetry.drain": 1}


def test_unclosed_span_is_the_postmortem(tel):
    tel.begin("train.step", step=3)
    s = validate_flight_file(tel.drain("crash"))
    assert s["unclosed_records"][0]["name"] == "train.step"
    assert s["unclosed_records"][0]["step"] == 3


def test_bad_flight_file_raises(tmp_path):
    bad = tmp_path / "f.jsonl"
    bad.write_text(json.dumps({"ts": 0, "ph": "E", "id": 9}) + "\n")
    with pytest.raises(ValueError, match="E without B"):
        validate_flight_file(str(bad))
    bad.write_text("{not json\n")
    with pytest.raises(ValueError, match="bad JSON"):
        validate_flight_file(str(bad))


def test_ring_overflow_without_dir_drops_oldest_counted():
    t = Telemetry(ring_size=8)
    t.configure(enabled=True)
    for i in range(20):
        t.event("spam", i=i)
    assert [r["i"] for r in t.records()] == list(range(12, 20))
    assert t.dropped == 12 and counters.get("telemetry.dropped") == 12
    t.reset()


def test_ring_full_drains_to_flight_file(tel):
    for i in range(200):
        tel.event("spam", i=i)
    tel.drain("tail")
    assert tel.dropped == 0
    assert validate_flight_file(tel._flight_path)["by_name"]["spam"] == 200


def test_rotation_caps_bytes_and_keeps_a_straddling_span(tel):
    tel.configure(flight_max_bytes=12_000)
    sid = tel.begin("serve.request", request_id="straddle")
    for i in range(300):
        tel.event("spam", i=i)
        if i % 50 == 0:
            tel.drain("tick")
    tel.end(sid, outcome="completed")
    tel.drain("tail")
    assert os.path.exists(tel._flight_path + ".1")
    s = validate_flight_file(tel._flight_path)
    assert s["unclosed"] == [] and s["orphan_ends"] == 0, s
    assert s["by_name"]["spam"] == 300 and s["spans"] >= 1


def test_end_past_two_rotations_is_an_orphan(tel):
    tel.configure(flight_max_bytes=1_500)
    sid = tel.begin("serve.request", request_id="long")
    for i in range(400):
        tel.event("spam", i=i)
        if i % 40 == 0:
            tel.drain("tick")
    tel.end(sid, outcome="completed")
    tel.drain("tail")
    s = validate_flight_file(tel._flight_path)
    assert s["orphan_ends"] == 1 and s["unclosed"] == [], s


def test_disabled_is_a_noop(tmp_path):
    threads = threading.active_count()
    t = Telemetry()
    with t.span("x", a=1) as sid:
        assert sid is None
    t.event("y")
    assert t.begin("z") is None
    t.end(None)
    assert t.drain("nope") is None and t.serve_metrics(0) is None
    assert t.records() == [] and not t._open
    assert threading.active_count() == threads
    assert histograms.get("x_s") is None
    assert not TELEMETRY.enabled  # off unless configured


def test_sink_fault_is_counted_and_contained(tel, capsys):
    tel.faults.arm("telemetry_sink_fail", 1)
    tel.event("x")
    assert tel.drain("faulted") is None
    assert tel.sink_errors == 1 and counters.get("telemetry.sink_errors") == 1
    assert tel.faults.fired["telemetry_sink_fail"] == 1
    assert "telemetry drain failed (open)" in capsys.readouterr().err
    tel.event("y")
    assert validate_flight_file(tel.drain("ok"))["by_name"].get("y") == 1


def test_on_signal_hook_runs_in_the_handler_and_a_failing_one_is_ignored(capsys):
    seen = []
    with PreemptionHandler(signals=(signal.SIGTERM,), on_signal=seen.append) as p:
        os.kill(os.getpid(), signal.SIGTERM)
        assert p.triggered and seen == [signal.SIGTERM]

    def bad_hook(signum):
        raise OSError("observability broke")

    with PreemptionHandler(signals=(signal.SIGTERM,), on_signal=bad_hook) as p:
        os.kill(os.getpid(), signal.SIGTERM)
        assert p.triggered
    assert "on_signal hook failed (ignored): OSError" in capsys.readouterr().err


def test_dump_is_text_equal_to_jax():
    """The same counter, gauge and histogram writes (labelled too) render
    to the same Prometheus text."""
    outs = []
    for (c, g, h), cls in (((counters, gauges, histograms), Telemetry),
                           ((jm.counters, jm.gauges, jm.histograms), JTelemetry)):
        c.inc("serve.submitted", 2)
        c.inc("serve.completed", labels={"replica": "1"})
        g.set("serve.running", 1.5)
        g.set("serve.pool_occupancy", 0.125, labels={"replica": "1"})
        for v in (0.003, 0.02, 0.02, 1.7, 4000.0):
            h.observe("serve.ttft_s", v)
        h.observe("serve.queue_wait_s", 0.5, labels={"replica": "1"})
        t = cls()
        t.configure(enabled=True)
        outs.append(t.dump())
        t.reset()
        for reg in (c, g, h):
            reg.reset()
    assert outs[0] == outs[1]
    assert "serve_submitted 2" in outs[0] and 'serve_ttft_s_bucket{le="+Inf"} 5' in outs[0]
    for line in outs[0].splitlines():
        if not line.startswith("#"):
            float(line.rpartition(" ")[2])


def test_metrics_served_on_localhost_only(tel):
    counters.inc("serve.completed", 5)
    port = tel.serve_metrics(0)
    assert port and tel.serve_metrics(0) == port
    assert tel._server.server_address[0] == "127.0.0.1"
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert "serve_completed 5" in body
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
    before = threading.active_count()
    tel.configure(enabled=False)
    assert threading.active_count() < before and tel._server is None


def test_environment_switches(tmp_path, capsys):
    t = Telemetry()
    configure_from_env(t, {})
    assert not t.enabled
    configure_from_env(t, {"DALLE_TPU_TELEMETRY": "0"})
    assert not t.enabled
    configure_from_env(t, {"DALLE_TPU_TELEMETRY": "1", "DALLE_TPU_TELEMETRY_DIR": str(tmp_path),
                           "DALLE_TPU_TELEMETRY_PORT": "not-a-port"})
    assert t.enabled and t.flight_dir == str(tmp_path) and t._server is None
    assert "ignoring non-integer DALLE_TPU_TELEMETRY_PORT" in capsys.readouterr().err
    assert t._atexit_registered
    t.reset()
    assert not t._atexit_registered and not t.enabled


def test_module_imports_neither_torch_nor_jax():
    code = """
import sys
for name in ("torch", "jax", "jaxlib", "numpy", "dalle_pytorch_tpu"):
    sys.modules[name] = None
from dalle_pytorch_tpu_torch.utils import telemetry, telemetry_names
telemetry.TELEMETRY.configure(enabled=True)
with telemetry.TELEMETRY.span("serve.iteration"):
    pass
assert telemetry_names.is_registered("serve.iteration_s", "histogram")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


_SIGTERM_SCRIPT = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, {repo!r})
    from dalle_pytorch_tpu_torch.utils.resilience import PreemptionHandler
    from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY

    TELEMETRY.configure(enabled=True, flight_dir=sys.argv[1])

    def on_signal(signum):
        TELEMETRY.event("train.preempt_signal", signum=signum)
        TELEMETRY.drain("preempt_signal")

    with PreemptionHandler(on_signal=on_signal) as p:
        step = 0
        print("READY", flush=True)
        while not p.triggered:
            with TELEMETRY.span("train.step", step=step):
                time.sleep(0.01)
            step += 1
    sys.exit(0)
""")


def test_real_sigterm_drains_a_valid_flight_file(tmp_path):
    flight = tmp_path / "flight"
    script = tmp_path / "loop.py"
    script.write_text(_SIGTERM_SCRIPT.format(repo=str(REPO)))
    proc = subprocess.Popen([sys.executable, str(script), str(flight)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        time.sleep(0.15)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    files = sorted(flight.glob("flight-*.jsonl"))
    assert files, out
    summary = validate_flight_file(str(files[0]))
    assert summary["by_name"].get("train.step", 0) >= 2, summary
    assert summary["by_name"].get("train.preempt_signal") == 1, summary
    # the interrupted step's end lands through the atexit drain
    assert summary["unclosed"] == [], summary["unclosed_records"]
