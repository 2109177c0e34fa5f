"""The port's speculative decode (``EngineConfig(spec_decode=True)``,
``serving/engine.py``), its substrate and its gates, on the CPU:

- the paged rewind (JAX's ``TestPagedRewind``): a verify block written
  through the masked ``paged_kv.append_`` equals sequential one-position
  appends when all is accepted; a rejected suffix is overwritten by the
  next block anchored at the accepted frontier; mixed acceptance per row
  with an idle row untouched; a block across a page boundary; each
  bitwise against JAX's ``paged_kv.append`` on the same steps;
- the ring rewind: a shift layer given a block, then the next block
  anchored behind the stored index (``delta``), reads the rows the
  sequential run reads, within the pad;
- ``spec_model`` shares the parameters and widens only the cache's rings;
  ``fused_width``; the config gates (fused iteration, spec_k,
  spec_draft_depth) raise as JAX's; the token budget charges a verify
  row its whole width;
- the ``spec_verify_abort`` drill runs one iteration at width 1 with
  tokens bitwise unchanged, is taken only when a row decodes, and is
  counted; the drafted / accepted / rejected counters add up; a deadline
  mid-decode ends typed with the pages returned.

- the truncated drafter (depth 1 of the depth-4 model of
  test_torch_spec_decode_engine.py) misdrafts, and with greedy sampling
  the tokens and the spec counters equal JAX's speculative engine's.

Engine parity (the exact and the truncated drafter, preemption, the
prefix cache): test_torch_spec_decode_engine.py; the exact drafter
against JAX: test_torch_spec_decode_jax.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import paged_kv as jpaged
from dalle_pytorch_tpu.serving.scheduler import TokenBudget as JTokenBudget
from dalle_pytorch_tpu_torch.ops import paged_kv
from dalle_pytorch_tpu_torch.ops.layers import PreShiftToken, ShiftRing
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, fused_width, spec_model
from dalle_pytorch_tpu_torch.serving.scheduler import TokenBudget
from dalle_pytorch_tpu_torch.serving.types import Outcome
from test_torch_prefix_engine import jax_pages, models, port_engine, req, run_all  # noqa: F401
from test_torch_spec_decode_engine import check_jax, deep_models  # noqa: F401

torch.set_num_threads(1)

SPEC = dict(prefill_chunk=4, fused_iteration=True, spec_decode=True)


class TestPagedRewind:
    PAGE, N_P, FEAT = 2, 4, 3

    def _pools(self, b, marker=None):
        jpool = np.zeros((b, self.N_P, self.PAGE, self.FEAT), np.float32)
        if marker is not None:
            jpool[marker] = 7.0
        flat = torch.from_numpy(np.concatenate(
            [jpool.reshape(-1, self.PAGE, self.FEAT), np.zeros((1, self.PAGE, self.FEAT),
                                                               np.float32)]))
        table = paged_kv.identity_table(b, self.N_P, "cpu")
        return jnp.asarray(jpool), flat, table

    @staticmethod
    def _rows(b, n, seed):
        return np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)

    def _append(self, pools, table, idx, rows, limit):
        jpool, flat = pools
        jpool = jpaged.append(jpool, jnp.asarray(table.numpy()), jnp.asarray(idx, jnp.int32),
                              jnp.asarray(rows), limit=jnp.asarray(limit, jnp.int32))
        paged_kv.append_([flat], table, torch.tensor(idx, dtype=torch.int32),
                         [torch.from_numpy(rows)], limit=torch.tensor(limit, dtype=torch.int32))
        return jpool, flat

    def _sequential(self, pools, table, idx, rows):
        for j in range(rows.shape[1]):
            pools = self._append(pools, table, [i + j for i in idx], rows[:, j:j + 1],
                                 [1] * len(idx))
        return pools

    def _same(self, got, want):
        b = want[0].shape[0]
        np.testing.assert_array_equal(paged_kv.pool_view(got[1], b).numpy(), np.asarray(got[0]))
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())

    def test_accept_all_block_equals_sequential(self):
        jpool, flat, table = self._pools(2)
        rows = self._rows(2, 3, 0)
        blk = self._append((jpool, flat.clone()), table, [1, 3], rows, [3, 3])
        seq = self._sequential((jpool, flat.clone()), table, [1, 3], rows)
        self._same(blk, seq)

    def test_reject_all_rewind_overwrites_suffix(self):
        jpool, flat, table = self._pools(2)
        A, B = self._rows(2, 3, 1), self._rows(2, 3, 2)
        spec = self._append((jpool, flat.clone()), table, [0, 2], A, [3, 3])
        spec = self._append(spec, table, [1, 3], B, [3, 3])
        seq = self._sequential((jpool, flat.clone()), table, [0, 2], A[:, :1])
        seq = self._sequential(seq, table, [1, 3], B)
        self._same(spec, seq)

    def test_mixed_acceptance_per_row_and_idle_rows(self):
        jpool, flat, table = self._pools(3, marker=2)
        A, B = self._rows(3, 3, 3), self._rows(3, 3, 4)
        spec = self._append((jpool, flat.clone()), table, [0, 1, 0], A, [3, 3, 0])
        spec = self._append(spec, table, [2, 4, 0], B, [3, 3, 0])
        seq = self._sequential((jpool, flat.clone()), table, [0, 1, 0], A)
        seq = self._sequential(seq, table, [2, 4, 0], B)
        np.testing.assert_array_equal(paged_kv.pool_view(spec[1], 3).numpy(), np.asarray(spec[0]))
        assert (paged_kv.pool_view(spec[1], 3)[2] == 7.0).all()
        np.testing.assert_array_equal(paged_kv.pool_view(spec[1], 3)[:2].numpy(),
                                      np.asarray(seq[0])[:2])

    def test_block_crosses_page_boundary(self):
        jpool, flat, table = self._pools(1)
        rows = self._rows(1, 3, 5)
        blk = self._append((jpool, flat.clone()), table, [1], rows, [3])
        seq = self._sequential((jpool, flat.clone()), table, [1], rows)
        self._same(blk, seq)


def test_ring_rewind_reads_the_sequential_rows():
    """Row 0 verifies a block of 3 and keeps 1; its next block, anchored
    one position past the kept token (2 behind the stored index), shifts
    exactly as a ring that only ever saw the kept tokens."""
    f, d, pad = 4, 8, 3
    layer = PreShiftToken(torch.nn.Identity(), f, seq_len=6 + f * f)
    g = np.random.RandomState(0)
    prompt = torch.from_numpy(g.randn(1, 7, d).astype(np.float32))
    a = torch.from_numpy(g.randn(1, 3, d).astype(np.float32))
    b = torch.from_numpy(g.randn(1, 3, d).astype(np.float32))

    def ring():
        r = ShiftRing(hist=torch.zeros(1, f + 1 + pad, d), index=torch.zeros(1, dtype=torch.int32))
        layer(prompt, ring=r, block_len=torch.tensor([7], dtype=torch.int32),
              block_start=torch.tensor([0], dtype=torch.int32))
        return r

    def step(r, x, start):
        n = x.shape[1]
        return layer(x, ring=r, block_len=torch.tensor([n], dtype=torch.int32),
                     block_start=torch.tensor([start], dtype=torch.int32))

    spec = ring()
    step(spec, a, 7)          # verify 3 at 7..9, accept 1
    got = step(spec, b, 8)    # the next block at the frontier
    seq = ring()
    step(seq, a[:, :1], 7)
    want = step(seq, b, 8)
    assert torch.equal(got, want)
    assert torch.equal(spec.hist[:, -(f + 1):], seq.hist[:, -(f + 1):])
    assert torch.equal(spec.index, seq.index)


def test_spec_model_and_width(models):
    _, _, model = models
    clone = spec_model(model, 3)
    assert clone.shift_pad == 3 and model.shift_pad == 0
    assert clone.transformer is model.transformer
    assert all(a is b for a, b in zip(clone.parameters(), model.parameters()))
    eng = port_engine(model, **SPEC, spec_k=3)
    assert eng.cache.attn_rings[0].hist.shape[1] == model.image_fmap_size + 1 + 3
    assert fused_width(EngineConfig(**SPEC, spec_k=3)) == 4
    assert fused_width(EngineConfig(**{**SPEC, "prefill_chunk": 2}, spec_k=3)) == 4
    assert fused_width(EngineConfig(prefill_chunk=2, fused_iteration=True)) == 2


@pytest.mark.parametrize("cfg,match", [
    (dict(prefill_chunk=4, spec_decode=True), "fused_iteration"),
    (dict(SPEC, spec_k=0), "spec_k"),
    (dict(SPEC, spec_draft_depth=99), "spec_draft_depth"),
], ids=["needs_fused", "spec_k", "draft_depth"])
def test_config_gates(models, cfg, match):
    _, _, model = models
    with pytest.raises(ValueError, match=match):
        port_engine(model, **cfg)


def test_budget_charges_verify_width():
    for budget in (TokenBudget(budget=8, chunk=3), JTokenBudget(budget=8, chunk=3)):
        assert budget.plan_iteration(2, [3, 3]) == [True, True]
        assert budget.plan_iteration(6, [3, 3]) == [True, False]
        assert budget.plan_iteration(8, [3, 3]) == [True, False]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["none", "int8"])
def test_abort_degrades_one_iteration_bitwise(models, kv_quant):
    _, _, model = models
    reqs = lambda: [req(i) for i in range(3)]  # noqa: E731
    clean = run_all(port_engine(model, kv_quant=kv_quant, **SPEC, spec_k=2), reqs())
    eng = port_engine(model, kv_quant=kv_quant, **SPEC, spec_k=2)
    eng.faults.arm("spec_verify_abort", 1)
    got = run_all(eng, reqs())
    assert eng.faults.fired["spec_verify_abort"] == 1
    assert eng.counters.get("serve.spec.fallbacks") == 1
    assert eng.counters.get("serve.fault_spec_verify_abort") == 1
    assert got == clean
    assert all(r.outcome is Outcome.COMPLETED for r in eng.results.values())
    eng.verify_invariants(idle=True)


def test_abort_untaken_when_nothing_decodes(models):
    _, _, model = models
    eng = port_engine(model, **SPEC, spec_k=2, token_budget=1)
    eng.faults.arm("spec_verify_abort", 1)
    assert eng.submit(req(0)) is None
    eng.step()  # the first chunk only: nothing decodes yet
    assert eng.faults.fired.get("spec_verify_abort") is None
    eng.run(max_steps=500)
    assert eng.faults.fired["spec_verify_abort"] == 1
    assert eng.results["r0"].outcome is Outcome.COMPLETED
    eng.verify_invariants(idle=True)


def test_spec_counters_add_up(models):
    _, _, model = models
    eng = port_engine(model, **SPEC, spec_k=2, spec_draft_depth=1)
    run_all(eng, [req(i) for i in range(3)])
    c = eng.counters
    drafted, accepted = c.get("serve.spec.drafted"), c.get("serve.spec.accepted")
    assert drafted == eng._spec_drafted > 0 and accepted == eng._spec_accepted
    assert drafted == accepted + c.get("serve.spec.rejected")
    assert eng.draft_steps > 0
    eng.verify_invariants(idle=True)


def test_spec_deadline_mid_decode_typed(models):
    _, _, model = models
    eng = port_engine(model, **SPEC, spec_k=2)
    assert eng.submit(req(0, deadline=4.5)) is None
    eng.run(max_steps=100)
    res = eng.results["r0"]
    assert res.outcome is Outcome.DEADLINE_EXCEEDED and 0 < len(res.tokens) < 16
    assert eng.pool.used == 0
    eng.verify_invariants(idle=True)


def test_truncated_drafter_matches_jax_engine(deep_models):
    ours = check_jax(deep_models, spec_k=3, spec_draft_depth=1)
    assert ours._spec_accepted < ours._spec_drafted
