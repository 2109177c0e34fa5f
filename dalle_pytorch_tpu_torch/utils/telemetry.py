"""Spans, events, the flight recorder and ``/metrics`` (counterpart of
``dalle_pytorch_tpu/utils/telemetry.py``).

**Spans and events.** ``span("serve.prefill", request_id=...)`` times one
host-side phase as a context manager; ``begin`` / ``end`` are the
non-lexical form for spans that outlive a loop iteration (a request's
lifecycle, a train step from dispatch to verdict); ``event(...)`` is a
point in time. A record is a flat dict, ``{"ts", "ph" ("B" | "E" | "I"),
"name", "id", "parent", **attrs}``, on a monotonic clock that can be
injected: anything with ``now()``, such as ``serving.types.FakeClock``.
A span's parent is the calling thread's innermost open ``span()`` unless
given. Closing a span observes its duration into the ``<name>_s``
histogram of ``utils.metrics.histograms``.

**Flight recorder.** Records go to a bounded ring. With a flight
directory, a full ring drains to ``flight-<pid>.jsonl`` there (rotated
once, to ``.1``, past ``flight_max_bytes``), and so do ``drain()``, the
trainer's preemption hook and an atexit hook; a run that is stopped
leaves its last records on disk, open ``"B"`` records showing what was
in flight. Without a directory the ring drops its oldest record
(counted under ``telemetry.dropped``). Telemetry never fails the loop it
observes: a sink error is counted under ``telemetry.sink_errors`` and
printed (the ``telemetry_sink_fail`` fault site, armed on
``Telemetry.faults``, injects one).

**Exposition.** ``dump()`` renders the counters, gauges and histograms as
Prometheus text; ``serve_metrics(port)`` serves it at ``GET /metrics``
from a ``http.server`` daemon thread bound to 127.0.0.1 only.

Disabled, the default, is a no-op: no thread, no file, no record, and
``span()`` yields at once. Enable it with ``TELEMETRY.configure(enabled=
True, ...)`` or, for a command line, the environment (read once, at
import)::

    DALLE_TPU_TELEMETRY=1
    DALLE_TPU_TELEMETRY_DIR=/tmp/flight     # optional: flight recorder
    DALLE_TPU_TELEMETRY_PORT=9100           # optional: /metrics server

The module imports neither torch nor jax and reads no device value:
callers pass plain Python numbers, so a span adds no device sync.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .faults import FaultRegistry
from .metrics import counters, gauges, histograms

ENV_ENABLE = "DALLE_TPU_TELEMETRY"
ENV_DIR = "DALLE_TPU_TELEMETRY_DIR"
ENV_PORT = "DALLE_TPU_TELEMETRY_PORT"


class _MonotonicClock:
    """The default time source (``serving.types.Clock``'s ``now``)."""

    def now(self) -> float:
        return time.monotonic()


class Telemetry:
    """See the module docstring. ``TELEMETRY`` is the process's instance;
    tests build their own. An ``RLock`` guards the ring: the preemption
    hook drains from a signal handler that may interrupt a thread holding
    it."""

    def __init__(self, clock=None, ring_size: int = 4096):
        self._lock = threading.RLock()
        self.clock = clock or _MonotonicClock()
        self.enabled = False
        self.ring_size = self._initial_ring_size = int(ring_size)
        self.faults = FaultRegistry()
        self._buf: deque = deque()
        self._open: Dict[int, Tuple[str, float]] = {}  # id -> (name, t0)
        self._tls = threading.local()  # the per-thread span stack
        self._next_id = 1
        self.dropped = 0
        self.sink_errors = 0
        self.flight_dir: Optional[str] = None
        self.flight_max_bytes = 16 << 20
        self._flight_path: Optional[str] = None
        self._server = None
        self._server_thread = None
        self._atexit_registered = False

    # ------------------------------------------------------------ config

    def configure(self, enabled: Optional[bool] = None, ring_size: Optional[int] = None,
                  flight_dir: Optional[str] = None, flight_max_bytes: Optional[int] = None,
                  metrics_port: Optional[int] = None, clock=None,
                  faults: Optional[FaultRegistry] = None) -> "Telemetry":
        """Reconfigure in place; returns self. ``enabled=False`` stops the
        server thread and unregisters the atexit drain."""
        with self._lock:
            if clock is not None:
                self.clock = clock
            if faults is not None:
                self.faults = faults
            if ring_size is not None:
                assert ring_size > 0
                self.ring_size = int(ring_size)
            if flight_dir is not None:
                self.flight_dir = flight_dir or None
                self._flight_path = None
            if flight_max_bytes is not None:
                self.flight_max_bytes = int(flight_max_bytes)
            if enabled is not None:
                self.enabled = bool(enabled)
            if not self.enabled:
                self._stop_server()
                self._unregister_atexit()
                return self
            if self.flight_dir and not self._atexit_registered:
                atexit.register(self._atexit_drain)
                self._atexit_registered = True
            if metrics_port is not None:
                self.serve_metrics(metrics_port)
        return self

    def reset(self) -> None:
        """Back to the disabled state of a new instance."""
        with self._lock:
            self.configure(enabled=False)
            self._buf.clear()
            self._open.clear()
            self.dropped = 0
            self.sink_errors = 0
            self.ring_size = self._initial_ring_size
            self.flight_dir = None
            self.flight_max_bytes = 16 << 20
            self._flight_path = None
            self.clock = _MonotonicClock()
            self.faults = FaultRegistry()
            self._tls = threading.local()

    # ------------------------------------------------------------- spans

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def begin(self, name: str, parent: Optional[int] = None, **attrs: Any) -> Optional[int]:
        """Open a non-lexical span and return its id (None when disabled;
        ``end(None)`` does nothing, so call sites need no guard)."""
        if not self.enabled:
            return None
        t = self.clock.now()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._open[sid] = (name, t)
        if parent is None:
            st = self._stack()
            parent = st[-1] if st else None
        self._record({"ts": t, "ph": "B", "name": name, "id": sid, "parent": parent, **attrs})
        return sid

    def end(self, span_id: Optional[int], **attrs: Any) -> None:
        """Close a ``begin`` span; its duration goes to ``<name>_s``."""
        if span_id is None or not self.enabled:
            return
        with self._lock:
            name, t0 = self._open.pop(span_id, (None, None))
        t = self.clock.now()
        rec = {"ts": t, "ph": "E", "id": span_id, **attrs}
        if name is not None:
            rec["name"] = name
            rec["dur_s"] = t - t0
            histograms.observe(f"{name}_s", t - t0)
        self._record(rec)

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Optional[int]]:
        """A lexical span: times the block; spans and events opened inside
        it on this thread name it as their parent."""
        if not self.enabled:
            yield None
            return
        sid = self.begin(name, **attrs)
        st = self._stack()
        st.append(sid)
        try:
            yield sid
        finally:
            if st and st[-1] == sid:
                st.pop()
            self.end(sid)

    def event(self, name: str, **attrs: Any) -> None:
        """A point in time (``ph: "I"``)."""
        if not self.enabled:
            return
        st = self._stack()
        parent = attrs.pop("parent", st[-1] if st else None)
        self._record({"ts": self.clock.now(), "ph": "I", "name": name, "parent": parent,
                      **attrs})

    # ------------------------------------------------------ ring, drain

    def _record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buf) >= self.ring_size:
                if self.flight_dir:
                    self._drain_locked("ring_full")
                else:
                    self._buf.popleft()
                    self.dropped += 1
                    counters.inc("telemetry.dropped")
            self._buf.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """A copy of the records in the ring (not yet drained)."""
        with self._lock:
            return list(self._buf)

    def drain(self, reason: str = "explicit") -> Optional[str]:
        """Flush the ring to the flight file; returns its path (None with
        nothing to write, no directory, or a failed write). Never
        raises."""
        if not self.enabled:
            return None
        with self._lock:
            return self._drain_locked(reason)

    def _drain_locked(self, reason: str) -> Optional[str]:
        if not self.flight_dir or not self._buf:
            return None
        records = list(self._buf)
        self._buf.clear()  # a failed write drops them: it never blocks
        try:
            self.faults.maybe_raise("telemetry_sink_fail",
                                    OSError("injected telemetry_sink_fail"))
            path = self._flight_file_locked()
            lines = [json.dumps(rec, default=str) for rec in records]
            lines.append(json.dumps({"ts": self.clock.now(), "ph": "I",
                                     "name": "telemetry.drain", "n": len(records),
                                     "reason": reason, "dropped": self.dropped}))
            data = ("\n".join(lines) + "\n").encode()
            # one unbuffered append: a drain re-entering from a signal
            # handler lands whole before or after this block, never inside
            # a line
            fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                while data:
                    data = data[os.write(fd, data):]
            finally:
                os.close(fd)
            return path
        except Exception as e:
            self.sink_errors += 1
            counters.inc("telemetry.sink_errors")
            try:
                print(f"telemetry drain failed (open): {type(e).__name__}: {e}",
                      file=sys.stderr)
            except Exception:
                pass
            return None

    def _flight_file_locked(self) -> str:
        """``flight-<pid>.jsonl`` in the flight directory, moved to
        ``.1`` once past ``flight_max_bytes``."""
        if self._flight_path is None:
            os.makedirs(self.flight_dir, exist_ok=True)
            self._flight_path = os.path.join(self.flight_dir, f"flight-{os.getpid()}.jsonl")
        p = self._flight_path
        try:
            if os.path.getsize(p) > self.flight_max_bytes:
                os.replace(p, p + ".1")
        except OSError:
            pass  # no file yet
        return p

    def _atexit_drain(self) -> None:
        try:
            self.drain("atexit")
        except Exception:
            pass

    # -------------------------------------------------------- exposition

    @staticmethod
    def _prom_name(name: str) -> str:
        s = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
        return ("_" + s) if s and s[0].isdigit() else (s or "_")

    @staticmethod
    def _prom_labels(labelset, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in labelset]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def dump(self) -> str:
        """Every counter, gauge and histogram of ``utils.metrics`` and the
        layer's own tallies as Prometheus text, one ``# TYPE`` line a
        name; labelled series as labelled samples."""
        lines: List[str] = []
        typed: set = set()

        def type_line(n: str, kind: str) -> None:
            if n not in typed:
                typed.add(n)
                lines.append(f"# TYPE {n} {kind}")

        for name, labelset, v in counters.series():
            n = self._prom_name(name)
            type_line(n, "counter")
            lines.append(f"{n}{self._prom_labels(labelset)} {v}")
        for name, labelset, v in gauges.series():
            n = self._prom_name(name)
            type_line(n, "gauge")
            lines.append(f"{n}{self._prom_labels(labelset)} {v:g}")
        for name, labelset, hist in histograms.series():
            n = self._prom_name(name)
            type_line(n, "histogram")
            exp = hist.exposition()
            for ub, cum in exp["buckets"]:
                le = "+Inf" if ub == float("inf") else f"{ub:.6g}"
                suffix = self._prom_labels(labelset, f'le="{le}"')
                lines.append(f"{n}_bucket{suffix} {cum}")
            lines.append(f"{n}_sum{self._prom_labels(labelset)} {exp['sum']:.9g}")
            lines.append(f"{n}_count{self._prom_labels(labelset)} {exp['count']}")
            for q, label in ((50, "0.5"), (95, "0.95"), (99, "0.99")):
                suffix = self._prom_labels(labelset, f'quantile="{label}"')
                lines.append(f"{n}{suffix} {exp['quantiles'][q]:.9g}")
        lines.append("# TYPE telemetry_ring_dropped counter")
        lines.append(f"telemetry_ring_dropped {self.dropped}")
        lines.append("# TYPE telemetry_sink_errors counter")
        lines.append(f"telemetry_sink_errors {self.sink_errors}")
        return "\n".join(lines) + "\n"

    def serve_metrics(self, port: int) -> Optional[int]:
        """Serve ``dump()`` at ``GET /metrics`` on 127.0.0.1:``port`` (0: a
        free port) from a daemon thread; returns the bound port (None when
        disabled or the bind failed, which is counted). Idempotent."""
        if not self.enabled:
            return None
        with self._lock:
            if self._server is not None:
                return self._server.server_address[1]
            from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

            telemetry = self

            class Handler(BaseHTTPRequestHandler):
                def do_GET(self):  # noqa: N802 (the stdlib's name)
                    if self.path.rstrip("/") not in ("", "/metrics"):
                        self.send_error(404)
                        return
                    body = telemetry.dump().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def log_message(self, *a):
                    pass

            try:
                self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
            except OSError as e:
                self.sink_errors += 1
                counters.inc("telemetry.sink_errors")
                print(f"telemetry /metrics bind failed (open): {e}", file=sys.stderr)
                return None
            self._server_thread = threading.Thread(target=self._server.serve_forever,
                                                   name="telemetry-metrics", daemon=True)
            self._server_thread.start()
            return self._server.server_address[1]

    def _stop_server(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._server_thread is not None:
                self._server_thread.join(timeout=5)
            self._server = None
            self._server_thread = None

    def _unregister_atexit(self) -> None:
        if self._atexit_registered:
            atexit.unregister(self._atexit_drain)
            self._atexit_registered = False


def configure_from_env(telemetry: "Telemetry", environ=None) -> None:
    """Enable ``telemetry`` when ``DALLE_TPU_TELEMETRY`` is set (not "",
    "0" or "false"), with the flight directory and /metrics port of the
    other two switches; a port that is not an integer is ignored (and
    said so)."""
    env = os.environ if environ is None else environ
    if env.get(ENV_ENABLE, "") in ("", "0", "false"):
        return
    port: Optional[int] = None
    if env.get(ENV_PORT):
        try:
            port = int(env[ENV_PORT])
        except ValueError:
            print(f"ignoring non-integer {ENV_PORT}={env[ENV_PORT]!r} (telemetry fails open)",
                  file=sys.stderr)
    telemetry.configure(enabled=True, flight_dir=env.get(ENV_DIR), metrics_port=port)


TELEMETRY = Telemetry()
configure_from_env(TELEMETRY)


def validate_flight_file(path: str) -> Dict[str, Any]:
    """Parse and check a flight file: every line is JSON, every ``E``
    follows its ``B`` (same id). A rotated ``<path>.1`` is read first; an
    ``E`` whose ``B`` was rotated away is counted under ``orphan_ends``.
    Returns ``records``, ``spans`` (closed), ``unclosed`` (ids still open:
    what was in flight at a stop), ``unclosed_records``, ``orphan_ends``
    and ``by_name`` (records a name). Raises ``ValueError`` on a broken
    file."""
    prev = path + ".1"
    streams = [prev, path] if os.path.exists(prev) else [path]
    rotated = len(streams) > 1
    open_spans: Dict[int, Dict[str, Any]] = {}
    closed = records = orphan_ends = 0
    by_name: Dict[str, int] = {}
    for fpath in streams:
        with open(fpath) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    raise ValueError(f"{fpath}:{lineno}: bad JSON: {e}")
                records += 1
                ph, ts = rec.get("ph"), rec.get("ts")
                if ph not in ("B", "E", "I") or not isinstance(ts, (int, float)):
                    raise ValueError(f"{fpath}:{lineno}: malformed record {rec}")
                if "name" in rec:
                    by_name[rec["name"]] = by_name.get(rec["name"], 0) + 1
                if ph == "B":
                    open_spans[rec["id"]] = rec
                elif ph == "E":
                    if rec["id"] in open_spans:
                        open_spans.pop(rec["id"])
                        closed += 1
                    elif rotated:
                        orphan_ends += 1
                    else:
                        raise ValueError(f"{fpath}:{lineno}: E without B for id {rec['id']}")
    return {"records": records, "spans": closed, "unclosed": sorted(open_spans),
            "unclosed_records": list(open_spans.values()), "orphan_ends": orphan_ends,
            "by_name": by_name}
