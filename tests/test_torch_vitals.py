"""The port's engine vitals (``utils/vitals.py``) and the windowed
readers under them (``utils/metrics.py``: ``GaugeRing``,
``Histogram.snapshot_delta``) against the JAX package's on the CPU: JAX's
22 cases (``tests/test_vitals.py``) on the port, each fed to both
packages and the outputs compared exactly (the same floats, the same
keys). The device peaks are the port's own: the H100's bf16 tensor-core
rate and HBM rate under its ``torch.cuda.get_device_name()``; JAX's TPU
names have none here.
"""

import math

import pytest

from dalle_pytorch_tpu.utils import metrics as jmetrics
from dalle_pytorch_tpu.utils import vitals as jvitals
from dalle_pytorch_tpu_torch.utils import metrics as pmetrics
from dalle_pytorch_tpu_torch.utils import vitals as pvitals
from dalle_pytorch_tpu_torch.testing import reset_registries

PACKAGES = {"port": (pmetrics, pvitals), "jax": (jmetrics, jvitals)}


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


def both(fn):
    """``fn(metrics, vitals)`` on each package; asserts the outputs equal
    and returns the port's."""
    out = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# ------------------------------------------------------------ GaugeRing


def ring_run(values, capacity):
    def fn(m, _):
        r = m.GaugeRing(capacity)
        for v in values:
            r.push(v)
        return r.values(), r.window()
    return both(fn)


def test_gauge_ring_empty_window_is_zero():
    assert ring_run([], 4) == ([], {"count": 0.0, "last": 0.0, "mean": 0.0, "min": 0.0,
                                    "max": 0.0})


def test_gauge_ring_partial_fill():
    vals, w = ring_run([1.0, 3.0], 4)
    assert vals == [1.0, 3.0] and (w["count"], w["last"], w["mean"]) == (2.0, 3.0, 2.0)


def test_gauge_ring_wraparound_drops_oldest():
    vals, w = ring_run([1.0, 2.0, 3.0, 4.0, 5.0], 3)
    assert vals == [3.0, 4.0, 5.0] and (w["min"], w["max"], w["last"]) == (3.0, 5.0, 5.0)


def test_gauge_ring_capacity_one():
    vals, w = ring_run([7.0, 9.0], 1)
    assert vals == [9.0] and w["mean"] == 9.0


# -------------------------------------------- Histogram.snapshot_delta


def test_delta_window_excludes_pre_checkpoint():
    def fn(m, _):
        h = m.Histogram()
        for v in (0.001, 0.002, 0.003):
            h.observe(v)
        ck = h.checkpoint()
        h.observe(10.0)
        h.observe(20.0)
        return h.snapshot_delta(ck), h.count
    d, count = both(fn)
    assert d["count"] == 2.0 and d["sum"] == pytest.approx(30.0) and d["p50"] > 1.0
    assert count == 5


def test_delta_none_checkpoint_is_lifetime():
    def fn(m, _):
        h = m.Histogram()
        h.observe(1.0)
        h.observe(2.0)
        return h.snapshot_delta(None)
    d = both(fn)
    assert d["count"] == 2.0 and d["sum"] == pytest.approx(3.0)


def test_delta_empty_window():
    def fn(m, _):
        h = m.Histogram()
        h.observe(1.0)
        return h.snapshot_delta(h.checkpoint())
    d = both(fn)
    assert d["count"] == 0.0 and d["p50"] == 0.0 and d["p99"] == 0.0


def test_delta_geometry_mismatch_degrades_to_lifetime():
    def fn(m, _):
        h = m.Histogram()
        h.observe(1.0)
        return h.snapshot_delta(m.HistogramCheckpoint(counts=(0, 0), count=0, sum=0.0,
                                                      max=-math.inf))
    assert both(fn)["count"] == 1.0


def test_delta_stale_checkpoint_after_reset_degrades():
    def fn(m, _):
        h = m.Histogram()
        for _ in range(5):
            h.observe(1.0)
        ck = h.checkpoint()
        h2 = m.Histogram()
        h2.observe(2.0)
        return h2.snapshot_delta(ck)
    d = both(fn)
    assert d["count"] == 1.0 and d["sum"] == pytest.approx(2.0)


def test_delta_window_percentiles_track_window_not_lifetime():
    def fn(m, _):
        h = m.Histogram()
        for _ in range(100):
            h.observe(0.001)
        ck = h.checkpoint()
        for _ in range(10):
            h.observe(100.0)
        return h.percentile(50), h.snapshot_delta(ck)["p50"]
    lifetime, window = both(fn)
    assert lifetime < 0.01 and window > 50.0


def test_delta_checkpoint_charges_nothing_to_cumulative():
    def fn(m, _):
        h = m.Histogram()
        h.observe(1.0)
        before = h.snapshot()
        h.checkpoint()
        h.snapshot_delta(h.checkpoint())
        return before == h.snapshot()
    assert both(fn) is True


# ----------------------------------------------------------- CostLedger


def test_ledger_charge_once_per_signature():
    def fn(_, v):
        led = v.CostLedger()
        first, again = led.charge("iteration", 100.0, 200.0), led.charge("iteration", 9.0, 9.0)
        return first, again, led.entry("iteration"), led.has("decode"), led.entry("decode")
    assert both(fn) == (True, False, {"flops": 100.0, "bytes_accessed": 200.0}, False, None)


def test_ledger_roofline_frac_binding_roof():
    def fn(_, v):
        led = v.CostLedger()
        led.charge("it", 1e12, 1e12)
        peaks = {"flops": 2e12, "bytes_ps": 1e12}
        return led.roofline_frac("it", 1.0, peaks), led.roofline_frac("it", 2.0, peaks)
    assert both(fn) == (pytest.approx(1.0), pytest.approx(0.5))


def test_ledger_roofline_degenerate_inputs():
    def fn(_, v):
        led = v.CostLedger()
        led.charge("it", 1e12, 1e12)
        peaks = {"flops": 1e12, "bytes_ps": 1e12}
        return (led.roofline_frac("it", 0.0, peaks), led.roofline_frac("it", 1.0, None),
                led.roofline_frac("other", 1.0, peaks))
    assert both(fn) == (0.0, 0.0, 0.0)


def test_peaks_table():
    assert pvitals.peaks_for("NVIDIA H100 80GB HBM3") == {"flops": 989e12, "bytes_ps": 3.35e12}
    for name in ("TPU v5 lite", "cpu", None):
        assert pvitals.peaks_for(name) is None
    assert jvitals.peaks_for("TPU v5 lite")["flops"] > 0  # JAX's own table stays JAX's


# --------------------------------------------------------------- Vitals


def feed(v, n, *, dt=1.0, drafted=0, accepted=0, hits=0, misses=0, dl=0, terms=0,
         occ=0.5, stage=0.0, jit=None, t0=0.0):
    for i in range(1, n + 1):
        v.observe_iteration(now=t0 + i * dt, occupancy=occ, stage_queued=stage,
                            spec_drafted=drafted * i, spec_accepted=accepted * i,
                            prefix_hits=hits * i, prefix_misses=misses * i,
                            deadline_misses=dl * i, terminations=terms * i, jit_name=jit)


def vitals_run(window, peaks=None, charge=None, **kw):
    def fn(_, v):
        vit = v.Vitals(window=window, peaks=peaks)
        if charge:
            vit.ledger.charge(*charge)
        feed(vit, **kw)
        return vit.snapshot()
    return both(fn)


def test_vitals_windowed_accept_rate():
    snap = vitals_run(8, n=20, drafted=4, accepted=3)
    assert snap["spec_accept_rate"] == pytest.approx(0.75)
    assert snap["spec_drafted"] == pytest.approx(28) and snap["iterations"] == 20.0


def test_vitals_rate_is_windowed_not_lifetime():
    def fn(_, v):
        vit = v.Vitals(window=4)
        for i in range(1, 21):
            vit.observe_iteration(now=float(i), occupancy=0.5, stage_queued=0,
                                  spec_drafted=4 * i, spec_accepted=4 * i if i <= 10 else 40,
                                  prefix_hits=0, prefix_misses=0, deadline_misses=0,
                                  terminations=0)
        return vit.snapshot()
    assert both(fn)["spec_accept_rate"] == pytest.approx(0.0)


def test_vitals_gap_and_miss_rate():
    snap = vitals_run(8, n=10, dt=0.25, dl=1, terms=4)
    assert snap["decode_gap_s"] == pytest.approx(0.25)
    assert snap["deadline_miss_rate"] == pytest.approx(0.25)
    assert snap["occupancy"] == pytest.approx(0.5)


def test_vitals_zero_denominators():
    snap = vitals_run(4, n=2)
    assert snap["spec_accept_rate"] == snap["prefix_hit_frac"] == 0.0
    assert snap["deadline_miss_rate"] == snap["roofline_frac"] == 0.0


def test_vitals_roofline_live_gauge():
    snap = vitals_run(4, peaks={"flops": 1e9, "bytes_ps": 1e9}, charge=("iteration", 5e8, 1e8),
                      n=4, dt=1.0, jit="iteration")
    assert snap["roofline_frac"] == pytest.approx(0.5)


def test_vitals_publish_sets_registered_gauges():
    def fn(m, v):
        vit = v.Vitals(window=4)
        feed(vit, 6, drafted=4, accepted=2, hits=1, misses=1)
        snap = vit.publish(m.gauges)
        return snap, m.gauges.snapshot("serve.vitals.")
    snap, published = both(fn)
    assert published["serve.vitals.spec_accept_rate"] == pytest.approx(snap["spec_accept_rate"])
    assert published["serve.vitals.prefix_hit_frac"] == pytest.approx(0.5)
    assert published["serve.vitals.decode_gap_s"] == pytest.approx(1.0)
    assert published["serve.vitals.occupancy"] == pytest.approx(0.5)
    assert published["serve.vitals.stage_lag"] == published["serve.vitals.roofline_frac"] == 0.0


def test_vitals_snapshot_keys_are_stable():
    def fn(_, v):
        vit = v.Vitals(window=4)
        keys0 = set(vit.snapshot())
        feed(vit, 10, drafted=4, accepted=4)
        return keys0 == set(vit.snapshot()), sorted(keys0)
    same, keys = both(fn)
    assert same and "roofline_frac" in keys
