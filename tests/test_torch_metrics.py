"""The port's metrics registries (``dalle_pytorch_tpu_torch/utils/
metrics.py``) against the JAX package's on the same observation
sequences, made from a seed with numpy: histograms (count, sum, min, max,
percentiles, buckets, exposition, ``snapshot_delta`` over checkpoints,
custom geometries, the overflow bucket), counters and gauges with labels
and child views, ``GaugeRing`` windows, and the trainers' part the port
already had (``Counters.inc`` / ``get`` / ``snapshot(prefix)``,
``Throughput``). Equal means equal: every value is a float computed by
the same arithmetic in the same order."""

import math

import numpy as np
import pytest

from dalle_pytorch_tpu.utils import metrics as jm
from dalle_pytorch_tpu_torch.utils import metrics as pm

SEQUENCES = {
    "latency": lambda r: np.exp(r.uniform(np.log(1e-5), np.log(50.0), size=400)),
    "tiny_and_huge": lambda r: np.concatenate([r.uniform(0, 1e-7, 20), r.uniform(1e3, 1e5, 20),
                                               r.uniform(0.01, 1.0, 60)]),
    "ties": lambda r: np.repeat(r.uniform(0.001, 0.1, size=7), 9),
    "one": lambda r: np.array([0.25]),
}
GEOMETRIES = [{}, dict(lo=1e-3, hi=10.0, per_decade=4), dict(lo=0.5, hi=2.0, per_decade=20)]


def _values(name, seed=0):
    return [float(v) for v in SEQUENCES[name](np.random.RandomState(seed))]


@pytest.mark.parametrize("geometry", range(len(GEOMETRIES)))
@pytest.mark.parametrize("name", SEQUENCES)
def test_histogram_equals_jax(name, geometry):
    kw = GEOMETRIES[geometry]
    ours, theirs = pm.Histogram(**kw), jm.Histogram(**kw)
    assert ours.bounds == theirs.bounds
    for v in _values(name):
        ours.observe(v)
        theirs.observe(v)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.buckets() == theirs.buckets()
    assert ours.exposition() == theirs.exposition()
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert ours.percentile(q) == theirs.percentile(q), q


@pytest.mark.parametrize("name", SEQUENCES)
def test_snapshot_delta_equals_jax(name):
    values = _values(name, seed=1)
    ours, theirs = pm.Histogram(), jm.Histogram()
    cuts = sorted({0, len(values) // 3, len(values) // 2, len(values)})
    ckpts = []
    for a, b in zip(cuts, cuts[1:]):
        ckpts.append((ours.checkpoint(), theirs.checkpoint()))
        for v in values[a:b]:
            ours.observe(v)
            theirs.observe(v)
    assert ours.snapshot_delta() == theirs.snapshot_delta()
    for po, jo in ckpts:
        assert po.counts == jo.counts and (po.count, po.sum, po.max) == (jo.count, jo.sum, jo.max)
        assert ours.snapshot_delta(po) == theirs.snapshot_delta(jo)


def test_snapshot_delta_degrades_to_lifetime_as_jax():
    """A checkpoint of another geometry or newer than the state (a reset)
    gives the lifetime window, on both sides."""
    values = _values("latency", seed=2)
    pairs = [(pm.Histogram(), jm.Histogram()), (pm.Histogram(), jm.Histogram())]
    for v in values:
        for o, t in pairs:
            o.observe(v)
            t.observe(v)
    other = (pm.Histogram(lo=1e-3).checkpoint(), jm.Histogram(lo=1e-3).checkpoint())
    newer = (pairs[1][0].checkpoint(), pairs[1][1].checkpoint())
    fresh = (pm.Histogram(), jm.Histogram())
    for v in values[:10]:
        fresh[0].observe(v)
        fresh[1].observe(v)
    assert fresh[0].snapshot_delta(other[0]) == fresh[1].snapshot_delta(other[1])
    assert fresh[0].snapshot_delta(newer[0]) == fresh[1].snapshot_delta(newer[1])
    assert fresh[0].snapshot_delta(newer[0])["count"] == 10.0


def test_empty_histogram_equals_jax():
    ours, theirs = pm.Histogram(), jm.Histogram()
    assert ours.snapshot() == theirs.snapshot()
    assert ours.buckets() == theirs.buckets() == [(math.inf, 0)]
    assert ours.snapshot_delta() == theirs.snapshot_delta()


@pytest.mark.parametrize("capacity", [1, 5, 64])
def test_gauge_ring_equals_jax(capacity):
    ours, theirs = pm.GaugeRing(capacity), jm.GaugeRing(capacity)
    assert ours.window() == theirs.window()
    for v in _values("latency", seed=3)[:150]:
        ours.push(v)
        theirs.push(v)
        assert ours.values() == theirs.values()
        assert ours.window() == theirs.window()


def _drive(mod):
    """One sequence of counter, gauge and histogram writes, with labels and
    child views, on fresh registries of ``mod``."""
    c, g, h = mod.Counters(), mod.Gauges(), mod.Histograms()
    rng = np.random.RandomState(4)
    for i in range(60):
        rep = {"replica": str(i % 3)} if i % 2 else None
        c.inc("serve.submitted", labels=rep)
        c.child({"replica": "x"}).child({"zone": i % 2}).inc("serve.completed", int(rng.randint(1, 4)))
        g.set("serve.pool_occupancy", float(rng.uniform()), labels=rep)
        g.child({"replica": "7"}).set("serve.queued", i)
        h.observe("serve.ttft_s", float(rng.exponential(0.05)), labels=rep)
        h.child({"replica": "x"}).observe("serve.request_latency_s", float(rng.uniform(0, 2)),
                                          lo=1e-3, hi=10.0)
    return c, g, h


def test_labelled_registries_equal_jax():
    (pc, pg, ph), (jc, jg, jh) = _drive(pm), _drive(jm)
    assert pc.series() == jc.series()
    assert pc.snapshot() == jc.snapshot() and pc.snapshot("serve.c") == jc.snapshot("serve.c")
    assert pc.total("serve.submitted") == jc.total("serve.submitted") == 60
    assert pc.get("serve.submitted", labels={"replica": 1}) == jc.get(
        "serve.submitted", labels={"replica": 1})
    assert pg.snapshot() == jg.snapshot()
    assert pg.get("serve.queued", labels={"replica": 7}) == 59.0
    assert pg.get("nothing", 3.5) == jg.get("nothing", 3.5) == 3.5
    assert ph.snapshot() == jh.snapshot()
    assert [(n, h.exposition()) for n, h in ph.items()] == [
        (n, h.exposition()) for n, h in jh.items()]
    assert pm.render_series("a", (("k", "v"),)) == jm.render_series("a", (("k", "v"),)) == 'a{k="v"}'
    for reg in (pc, pg, ph):
        assert reg.child(None) is reg
        reg.reset()
        assert reg.snapshot() == {}


def test_trainer_counters_keep_their_interface():
    """``inc`` returns the new value, ``get`` defaults to 0, ``snapshot``
    filters by prefix (the trainer, the tar loader and the engine's
    tallies call exactly these)."""
    c = pm.Counters()
    assert c.inc("webdata.shards_opened") == 1 and c.inc("webdata.shards_opened", 2) == 3
    c.inc("train.nan_skips")
    assert c.get("webdata.decode_errors") == 0
    assert c.snapshot("webdata.") == {"webdata.shards_opened": 3}
    assert list(c.snapshot()) == ["train.nan_skips", "webdata.shards_opened"]


def test_process_wide_registries_exist_once():
    from dalle_pytorch_tpu_torch.serving import engine, postdecode  # noqa: F401
    from dalle_pytorch_tpu_torch.utils import telemetry

    assert isinstance(pm.counters, pm.Counters) and isinstance(pm.gauges, pm.Gauges)
    assert isinstance(pm.histograms, pm.Histograms)
    assert telemetry.counters is pm.counters and telemetry.histograms is pm.histograms
    assert engine.counters is pm.counters


def test_throughput_reports_once_a_window():
    t = pm.Throughput(window=3)
    got = [t.update(4) for _ in range(7)]
    assert [g is None for g in got] == [True, True, False, True, True, False, True]
    assert got[2] > 0
