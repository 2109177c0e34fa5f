"""The port's speculative engine against plain decode and against the
JAX package's engine on the CPU, on the tiny float32 DALLE of
test_torch_dalle.py and a depth-4 one of the same widths (the truncated
drafter's), fused block width 4, max_batch 2, unquantized and int8 pages:

- tokens are BITWISE plain decode's (fused, split chunked, monolithic;
  top-k 0.5 with the seeded noise), at spec_k 2 and 3: a token is
  committed only where it equals the target's own draw at its position;
- the exact drafter (every layer) accepts every draft here, so a verify
  step commits more than one token; on torch's CPU its width-1 draft
  steps run (b, dim) products where the verify block runs (b * W, dim)
  ones, so a rejection would be the last bits parting (none seen on this
  model: accept rate 1.0);
- the depth-1 drafter of the depth-4 model misdrafts, the rejected
  positions are rewound, and the tokens stay bitwise;
- a ``page_exhaust`` preemption mid-decode replays bitwise; a warm prefix
  hit under speculation is bitwise the cold run and leaves the shared
  arena pages untouched (the drafts write only the slot's own pages);
The comparison with JAX's speculative engine: test_torch_spec_decode_
jax.py (the exact drafter) and test_torch_spec_decode.py (the truncated
one).
"""

import pytest
import torch

from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.utils.metrics import counters as jcounters
from dalle_pytorch_tpu_torch.serving.types import Outcome
from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_dalle import tiny_models
from test_torch_engine import GREEDY
from test_torch_prefix_engine import (QUANTS, arena_bytes, jax_engine, jax_pages,  # noqa: F401
                                      models, port_engine, req, run_all, summary)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_registries():
    """Each test's engines count from zero in the port's registries."""
    reset_registries()
    yield
    reset_registries()

SPEC = dict(prefill_chunk=4, fused_iteration=True, spec_decode=True)
DEEP = dict(depth=4)


@pytest.fixture(scope="module")
def deep_models():
    return tiny_models(**DEEP)


def _reqs(n=3, cls=None):
    kw = {} if cls is None else {"cls": cls}
    return [req(i, **kw) for i in range(n)]


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
def test_exact_drafter_bitwise_plain_decode(models, kv_quant):
    _, _, model = models
    plain = {}
    for name, cfg in {"mono": {}, "split": dict(prefill_chunk=4),
                      "fused": dict(prefill_chunk=4, fused_iteration=True)}.items():
        plain[name] = run_all(port_engine(model, kv_quant=kv_quant, **cfg), _reqs())
    assert plain["mono"] == plain["split"] == plain["fused"]
    for spec_k in (2, 3):
        eng = port_engine(model, kv_quant=kv_quant, **SPEC, spec_k=spec_k)
        assert run_all(eng, _reqs()) == plain["fused"], f"spec_k {spec_k} diverged"
        assert eng._spec_drafted > 0
        assert eng._spec_accepted == eng._spec_drafted  # accept rate 1.0
        assert eng.draft_steps > 0
        eng.verify_invariants(idle=True)


def test_exact_drafter_commits_more_than_one_token_a_step(models):
    """The same requests take fewer dispatches than plain fused decode:
    verify steps commit several tokens each."""
    _, _, model = models
    plain = port_engine(model, prefill_chunk=4, fused_iteration=True)
    run_all(plain, _reqs())
    eng = port_engine(model, **SPEC, spec_k=3)
    run_all(eng, _reqs())
    assert eng.dispatches < plain.dispatches, (eng.dispatches, plain.dispatches)


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
def test_truncated_drafter_rejects_and_stays_bitwise(deep_models, kv_quant):
    _, _, model = deep_models
    plain = run_all(port_engine(model, kv_quant=kv_quant, prefill_chunk=4), _reqs(2))
    eng = port_engine(model, kv_quant=kv_quant, **SPEC, spec_k=3, spec_draft_depth=1)
    got = run_all(eng, _reqs(2))
    assert eng._spec_drafted > 0
    assert eng._spec_accepted < eng._spec_drafted, "the drafter never missed"
    assert got == plain
    eng.verify_invariants(idle=True)


def test_spec_preempt_replay_bitwise(models):
    _, _, model = models
    clean = run_all(port_engine(model, **SPEC, spec_k=2), _reqs())
    eng = port_engine(model, **SPEC, spec_k=2)
    eng.faults.arm("page_exhaust", 1)
    got = run_all(eng, _reqs())
    assert any(r.preempt_count > 0 for r in eng.results.values())
    assert got == clean
    assert eng.pool.used == 0


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
@pytest.mark.parametrize("draft_depth", [None, 1], ids=["exact", "depth1"])
def test_spec_prefix_warm_hit_bitwise(models, draft_depth, kv_quant):
    _, _, model = models
    plain = run_all(port_engine(model, kv_quant=kv_quant, prefill_chunk=4), _reqs())
    eng = port_engine(model, kv_quant=kv_quant, prefix_cache=True, **SPEC, spec_k=2,
                      spec_draft_depth=draft_depth)
    cold = run_all(eng, _reqs())
    arena = arena_bytes(eng)
    hits0 = eng.prefix.stats.hits
    warm = run_all(eng, [req(i, rid=f"r{i}w") for i in range(3)])
    assert eng.prefix.stats.hits > hits0
    for i in range(3):
        assert warm[f"r{i}w"] == cold[f"r{i}"] == plain[f"r{i}"]
    assert all(torch.equal(a, b) for a, b in zip(arena, arena_bytes(eng))), (
        "a draft or verify write landed in a shared page"
    )
    eng.verify_invariants(idle=True)


def check_jax(models, **cfg):
    """Greedy tokens and the spec counters of the port's speculative engine
    equal JAX's over three requests."""
    jmodel, params, model = models
    ours = port_engine(model, filter_thres=GREEDY, **SPEC, **cfg)
    run_all(ours, _reqs())
    jcounters.reset()
    theirs = jax_engine(jmodel, params, **SPEC, **cfg)
    run_all(theirs, _reqs(cls=JRequest))
    assert summary(ours.results) == summary(theirs.results)
    for name in ("drafted", "accepted", "rejected", "fallbacks"):
        assert ours.counters.get(f"serve.spec.{name}") == jcounters.get(f"serve.spec.{name}"), name
    assert all(r.outcome is Outcome.COMPLETED for r in ours.results.values())
    return ours
