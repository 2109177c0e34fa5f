"""The port's adaptive controller (``serving/control.py``) and the
engine's hooks against the JAX package's on the CPU: JAX's 21 cases
(``tests/test_control.py``).

The ladder: each case's snapshot sequence goes into a port and a JAX
controller, and the decision logs (iteration, vitals, knobs, reasons,
changed, stalled) are equal.

The engine: JAX's depth-4 model whose depth-1 drafter misdrafts,
converted, pages of 2, the fused speculative engine (spec_k 3, chunks of
2), greedy, a ``FakeClock`` of 1 s a step, with the controller. The
port's controller log (the vitals it read included), the effective knobs
it ends at, its counters and every token equal JAX's; the verify width
steps down under the low accept rate while the tokens stay bitwise the
controller-off engine's; ``control_stall`` resets the knobs to the
defaults, typed and counted, and decode goes on. (JAX's check that no jit
signature was added has no counterpart: the port traces nothing.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.serving import ControlConfig as JControlConfig
from dalle_pytorch_tpu.serving import Controller as JController
from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.serving.control import ControlStall as JControlStall
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu.utils.metrics import counters as jcounters
from dalle_pytorch_tpu.utils.metrics import gauges as jgauges
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.serving.control import ControlConfig, Controller, ControlStall
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.utils.faults import FaultRegistry
from dalle_pytorch_tpu_torch.utils.metrics import counters, gauges
from dalle_pytorch_tpu_torch.testing import reset_registries

torch.set_num_threads(1)

PAGE = 2
GREEDY = 0.99  # k = max(int(0.01 * 102 total tokens), 1) = 1
DEEP = dict(dim=32, depth=4, num_text_tokens=32, text_seq_len=6, num_image_tokens=64,
            image_fmap_size=4, heads=2, dim_head=8, attn_types=("full",), shift_tokens=True,
            rotary_emb=True)
SPEC = dict(max_batch=2, prefill_chunk=2, fused_iteration=True, spec_decode=True, spec_k=3,
            spec_draft_depth=1, filter_thres=GREEDY)
CONTROL_COUNTERS = ("decisions", "adjustments", "stalls")


@pytest.fixture(scope="module")
def deep_models():
    jdalle = JDALLE(**DEEP)
    rng = np.random.RandomState(0)
    text = jnp.asarray(rng.randint(1, 32, size=(1, 6)), jnp.int32)
    image = jnp.asarray(rng.randint(0, 64, size=(1, 16)), jnp.int32)
    params = jdalle.init(jax.random.key(0), text, image)["params"]
    model = DALLE(**DEEP, device="cpu", dtype=torch.float32)
    model.load_state_dict(dalle_state_dict(jax.device_get(params)))
    return jdalle, params, model


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    reset_registries()
    FAULTS.reset()
    yield
    reset_registries()
    FAULTS.reset()


# ---------------------------------------------------------------- ladder


def vit(**kw):
    base = {"iterations": 0.0, "spec_accept_rate": 0.0, "spec_drafted": 0.0,
            "prefix_hit_frac": 0.0, "decode_gap_s": 0.0, "stage_lag": 0.0,
            "deadline_miss_rate": 0.0, "occupancy": 0.0, "roofline_frac": 0.0}
    base.update(kw)
    return base


def controllers(config=None, **kw):
    """(port, JAX) controllers of the same thresholds and defaults."""
    defaults = dict(spec_k_ceiling=3, budget_default=6, chunk=2, watermark_default=0.85,
                    prefix_enabled=True)
    defaults.update(kw)
    cfg = config or {}
    return (Controller(ControlConfig(**cfg), **defaults),
            JController(JControlConfig(**cfg), **defaults))


def log_of(c):
    return [(d.iteration, d.vitals, d.knobs, d.reasons, d.changed, d.stalled) for d in c.log]


def ladder(snaps, config=None, **kw):
    """Feed ``snaps`` to both controllers; the port's decisions (equal to
    JAX's)."""
    ours, theirs = controllers(config, **kw)
    for i, s in enumerate(snaps):
        ours.evaluate(i, s)
        theirs.evaluate(i, s)
    assert log_of(ours) == log_of(theirs)
    assert ours.knobs == theirs.knobs
    return ours.log


def test_spec_steps_down_and_floors_at_one():
    log = ladder([vit(spec_drafted=10.0, spec_accept_rate=0.1)] * 4)
    assert [d.knobs["spec_k"] for d in log] == [2.0, 1.0, 1.0, 1.0]
    assert "spec_down" not in log[-1].reasons


def test_spec_steps_back_up_to_ceiling():
    log = ladder([vit(spec_drafted=10.0, spec_accept_rate=0.1)]
                 + [vit(spec_drafted=10.0, spec_accept_rate=0.95)] * 2)
    assert [d.knobs["spec_k"] for d in log] == [2.0, 3.0, 3.0]


def test_spec_noise_gate():
    log = ladder([vit(spec_drafted=4.0, spec_accept_rate=0.0)], config=dict(spec_min_drafts=8))
    assert log[0].knobs["spec_k"] == 3.0 and not log[0].changed


def test_spec_hysteresis_band_holds():
    log = ladder([vit(spec_drafted=10.0, spec_accept_rate=0.6)])
    assert log[0].knobs["spec_k"] == 3.0 and not log[0].changed


def test_budget_tightens_under_gap_and_floors():
    log = ladder([vit(decode_gap_s=1.0)] * 3)
    assert [d.knobs["budget"] for d in log] == [4.0, 3.0, 3.0]


def test_budget_relaxes_back_to_default():
    log = ladder([vit(decode_gap_s=1.0)] + [vit(decode_gap_s=0.0)] * 2)
    assert [d.knobs["budget"] for d in log] == [4.0, 6.0, 6.0]


def test_budget_hysteresis_band_holds():
    log = ladder([vit(decode_gap_s=2.0), vit(decode_gap_s=0.8)],
                 config=dict(gap_high_s=1.0, gap_low_frac=0.5))
    assert log[1].knobs["budget"] == 4.0 and not log[1].changed


def test_watermark_clamp_and_restore():
    log = ladder([vit(deadline_miss_rate=r) for r in (0.5, 0.2, 0.0)])
    assert [d.knobs["watermark"] for d in log] == [0.5, 0.5, 0.85]
    assert "watermark_clamp" in log[0].reasons and "watermark_restore" in log[2].reasons
    assert not log[1].changed


def test_prefix_shed_and_restore():
    log = ladder([vit(occupancy=o) for o in (0.95, 0.6, 0.1)])
    assert [d.knobs["prefix_pages_target"] for d in log] == [0.0, 0.0, None]
    assert "prefix_shed" in log[0].reasons and "prefix_restore" in log[2].reasons


def test_disabled_knobs_never_move():
    log = ladder([vit(spec_drafted=10.0, spec_accept_rate=0.0, decode_gap_s=5.0, occupancy=1.0)],
                 spec_k_ceiling=None, budget_default=None, prefix_enabled=False)
    assert log[0].knobs["spec_k"] is None and log[0].knobs["budget"] is None
    assert log[0].knobs["prefix_pages_target"] is None


def test_stall_fault_raises_typed():
    faults = FaultRegistry()
    ours = Controller(ControlConfig(), spec_k_ceiling=3, budget_default=6, chunk=2,
                      prefix_enabled=True, faults=faults)
    theirs = controllers()[1]
    faults.arm("control_stall", 1)
    FAULTS.arm("control_stall", 1)
    with pytest.raises(ControlStall):
        ours.evaluate(0, vit())
    with pytest.raises(JControlStall):
        theirs.evaluate(0, vit())
    assert faults.fired == dict(FAULTS.fired) == {"control_stall": 1}
    ours.evaluate(1, vit())
    theirs.evaluate(1, vit())
    assert log_of(ours) == log_of(theirs)


def test_reset_restores_defaults():
    ours, theirs = controllers()
    for c in (ours, theirs):
        c.evaluate(0, vit(spec_drafted=10.0, spec_accept_rate=0.0, decode_gap_s=5.0,
                          deadline_miss_rate=1.0))
        assert c.knobs != c.defaults()
        c.reset()
        assert c.knobs == c.defaults()
    assert ours.defaults() == theirs.defaults()


def test_log_is_bounded():
    log = ladder([vit()] * 20, config=dict(max_log=8))
    assert len(log) == 8 and log[-1].iteration == 19


def test_deterministic_decision_sequence():
    snaps = [vit(spec_drafted=10.0, spec_accept_rate=r, decode_gap_s=g, deadline_miss_rate=m,
                 occupancy=o)
             for r, g, m, o in [(0.1, 1.0, 0.0, 0.5), (0.2, 0.0, 0.5, 0.95),
                                (0.9, 0.1, 0.0, 0.1), (0.95, 2.0, 0.3, 0.99)]]
    assert log_of_records(ladder(snaps)) == log_of_records(ladder(snaps))


def log_of_records(log):
    return [(d.iteration, d.knobs, d.reasons, d.changed) for d in log]


# ------------------------------------------------------------- the engine


def prompt(i):
    return np.random.RandomState(100 + i).randint(1, 32, size=(6,)).astype(np.int32)


def run_port(models, *, n=4, max_new=10, faults=None, **cfg_kw):
    eng = Engine(models[2], EngineConfig(page_size=PAGE, **{**SPEC, **cfg_kw}),
                 clock=FakeClock(step_dt=1.0), device="cpu", faults=faults)
    for i in range(n):
        eng.submit(Request(f"r{i}", prompt(i), max_new, seed=i))
    return eng, eng.run(max_steps=800)


def run_jax(models, *, n=4, max_new=10, **cfg_kw):
    eng = JEngine(models[0], models[1], JEngineConfig(**{**SPEC, **cfg_kw}),
                  clock=JFakeClock(step_dt=1.0))
    for i in range(n):
        eng.submit(JRequest(f"r{i}", prompt(i), max_new, seed=i))
    return eng, eng.run(max_steps=800)


def tokens_of(results):
    return {rid: [int(t) for t in r.tokens] for rid, r in results.items()}


def both_engines(models, control=None, port_faults=None, **cfg_kw):
    """The port's and JAX's engine runs of one configuration; asserts
    their tokens, controller logs, effective knobs and control counters
    equal, and returns the port's."""
    if control is not None:
        cfg_kw["control"] = ControlConfig(**control)
    eng, res = run_port(models, faults=port_faults, **cfg_kw)
    if control is not None:
        cfg_kw["control"] = JControlConfig(**control)
    jeng, jres = run_jax(models, **cfg_kw)
    assert tokens_of(res) == tokens_of(jres)
    assert (eng.controller is None) == (jeng.controller is None)
    if eng.controller is not None:
        assert log_of(eng.controller) == log_of(jeng.controller)
    assert (eng._eff_spec_k, eng._eff_watermark) == (jeng._eff_spec_k, jeng._eff_watermark)
    assert {k: counters.get(f"serve.control.{k}") for k in CONTROL_COUNTERS} == {
        k: jcounters.get(f"serve.control.{k}") for k in CONTROL_COUNTERS}
    assert eng._spec_drafted == jeng._spec_drafted
    assert eng._spec_accepted == jeng._spec_accepted
    return eng, res


def test_spec_k_steps_down_under_forced_low_accept(deep_models):
    eng, results = both_engines(deep_models, controller=True, control=dict(interval=4))
    assert all(r.outcome is Outcome.COMPLETED for r in results.values())
    assert eng._eff_spec_k < eng.config.spec_k
    assert "spec_down" in [r for d in eng.controller.log for r in d.reasons]
    assert counters.get("serve.control.decisions") == len(eng.controller.log)
    assert counters.get("serve.control.adjustments") >= 1
    assert gauges.get("serve.control.spec_k") == float(eng._eff_spec_k)
    eng.verify_invariants(idle=True)


def test_controller_on_tokens_bit_identical_to_off(deep_models):
    _, off = run_port(deep_models)
    eng, on = both_engines(deep_models, controller=True, control=dict(interval=2))
    assert eng._eff_spec_k < eng.config.spec_k
    assert tokens_of(on) == tokens_of(off)


def test_decision_sequence_replays_bit_deterministically(deep_models):
    a, _ = run_port(deep_models, controller=True, control=ControlConfig(interval=2))
    b, _ = run_port(deep_models, controller=True, control=ControlConfig(interval=2))
    assert len(a.controller.log) >= 2 and log_of(a.controller) == log_of(b.controller)


def test_control_stall_drill_typed_accounting(deep_models):
    faults = FaultRegistry()
    faults.arm("control_stall", 1)
    FAULTS.arm("control_stall", 1)
    eng, results = both_engines(deep_models, control=dict(interval=2), port_faults=faults,
                                controller=True)
    assert faults.fired.get("control_stall") == FAULTS.fired.get("control_stall") == 1
    assert counters.get("serve.fault_control_stall") == 1
    assert counters.get("serve.control.stalls") == 1
    stalled = [d for d in eng.controller.log if d.stalled]
    assert len(stalled) == 1 and stalled[0].knobs == eng.controller.defaults()
    assert len(results) == 4
    assert all(r.outcome is Outcome.COMPLETED for r in results.values())
    _, plain = run_port(deep_models)
    assert tokens_of(results) == tokens_of(plain)
    eng.verify_invariants(idle=True)


def test_vitals_gauges_published_during_run(deep_models):
    both_engines(deep_models, controller=True, vitals=True)
    published = set(gauges.snapshot("serve.vitals."))
    assert published == set(jgauges.snapshot("serve.vitals."))
    for name in ("spec_accept_rate", "decode_gap_s", "occupancy", "deadline_miss_rate",
                 "stage_lag", "prefix_hit_frac", "roofline_frac"):
        assert f"serve.vitals.{name}" in published
        assert gauges.get(f"serve.vitals.{name}") == jgauges.get(f"serve.vitals.{name}")
    assert gauges.get("serve.vitals.decode_gap_s") == pytest.approx(1.0)


def test_vitals_off_publishes_nothing(deep_models):
    both_engines(deep_models)
    assert gauges.snapshot("serve.vitals.") == {} == jgauges.snapshot("serve.vitals.")


def test_controller_off_knobs_never_move(deep_models):
    eng, _ = both_engines(deep_models)
    assert eng.controller is None and eng.vitals is None
    assert eng._eff_spec_k == eng.config.spec_k
    assert eng._eff_watermark == eng.config.high_watermark
