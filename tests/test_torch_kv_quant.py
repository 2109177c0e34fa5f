"""Int8 KV pages of the port (``ops/paged_kv.py``, ``ops/ragged_attention.py``,
``models/sampling.py``, ``serving/engine.py``) against the JAX package on
the CPU, float32:

- policy: ``kv_quant`` resolves to "none" or "int8"; anything else is an
  ``InvalidKVFormatError`` (a ValueError) at ``resolve_quant``,
  ``init_decode_cache`` and ``Engine`` construction;
- ``quantize_rows`` and ``dequant`` BITWISE equal to JAX's on the same
  float32 rows (float32 and bfloat16 output), zero rows with scale 1,
  ties rounded half to even;
- append -> gather -> dequant through page boundaries equals the direct
  formula, and a rewind overwrite restores bytes and scales exactly;
- ``reference_attend`` with scale pools against JAX's Pallas kernel in
  interpret mode and its jnp reference (identity and permuted tables) on
  valid columns, atol/rtol 1e-5 (the kernel's online softmax
  reassociates the sum);
- the int8 engine's greedy tokens IDENTICAL to JAX's int8 fused engine
  (top-k keeps one logit, so no random bits enter); int8 against
  unquantized token agreement at least ``KV_QUANT_TOKEN_AGREEMENT_MIN``;
- ``kv_bytes_per_slot`` equal to JAX's for both formats, int8 holding at
  least 1.8x the slots in the same bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import paged_kv as jpaged
from dalle_pytorch_tpu.ops import ragged_attention as jra
from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache
from dalle_pytorch_tpu_torch.ops import kv_policy, paged_kv
from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import BUDGETS, GREEDY, _prompt

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- policy


def test_policy_resolves_and_types_its_errors():
    assert kv_policy.resolve_quant(None) == "none"
    assert [kv_policy.resolve_quant(q) for q in kv_policy.QUANTS] == ["none", "int8"]
    with pytest.raises(kv_policy.InvalidKVFormatError, match="int8"):
        kv_policy.resolve_quant("int4")
    assert issubclass(kv_policy.InvalidKVFormatError, ValueError)


@pytest.mark.parametrize("where", ["init_decode_cache", "engine"])
def test_invalid_kv_quant_is_a_typed_error(where):
    _, _, model = tiny_models()
    with pytest.raises(kv_policy.InvalidKVFormatError) as err:
        if where == "engine":
            Engine(model, EngineConfig(fused_iteration=True, prefill_chunk=2, page_size=PAGE,
                                            kv_quant="fp8"),
                   device="cpu")
        else:
            init_decode_cache(model, 2, page_size=PAGE, kv_quant="fp8")
    assert err.value.got == "fp8" and err.value.valid == kv_policy.QUANTS


def test_int8_cache_layout():
    """Int8 content pools and float32 (rows * n_pages + 1, page, heads)
    scale pools per layer; unquantized caches carry no scale pools."""
    _, _, model = tiny_models()
    cache = init_decode_cache(model, 3, page_size=PAGE, kv_quant="int8")
    plain = init_decode_cache(model, 3, page_size=PAGE)
    for kv, ref in zip(cache.kv, plain.kv):
        assert kv.k.dtype == kv.v.dtype == torch.int8 and kv.k.shape == ref.k.shape
        assert kv.k_scale.dtype == kv.v_scale.dtype == torch.float32
        assert kv.k_scale.shape == (*ref.k.shape[:2], model.heads)
        assert ref.k_scale is None and ref.v_scale is None


# -------------------------------------------------------------- quantizer


def _rows(seed, shape=(2, 7, 16)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_dequant_bitwise_equal_jax(seed):
    rows = _rows(seed)
    rows[0, 3] = 0.0  # an all-zero row: scale 1
    q, s = paged_kv.quantize_rows(torch.from_numpy(rows), heads=2)
    jq, js = jpaged.quantize_rows(jnp.asarray(rows), 2)
    assert q.dtype == torch.int8 and s.dtype == paged_kv.SCALE_DTYPE
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(s[0, 3].numpy(), 1.0)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = paged_kv.dequant(q, s, dtype)
        ref = jpaged.dequant(jq, js, jdtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_ties_round_half_to_even():
    """amax 127 gives scale 1, so x.5 values sit exactly on ties."""
    rows = np.array([[[127.0, 2.5, 3.5, -2.5, -3.5, 0.5, 1.5, -127.0]]], np.float32)
    q, s = paged_kv.quantize_rows(torch.from_numpy(rows), heads=1)
    assert s.item() == 1.0
    assert q[0, 0].tolist() == [127, 2, 4, -2, -4, 0, 2, -127]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jpaged.quantize_rows(jnp.asarray(rows), 1)[0]))


def _put(pools, table, rows, at, h):
    """Quantize ``rows`` and append bytes and scales at position ``at``."""
    pool, spool = pools
    q, s = paged_kv.quantize_rows(torch.from_numpy(rows), h)
    idx = torch.full((rows.shape[0],), at, dtype=torch.int32)
    paged_kv.append_([pool, spool], table, idx, [q, s])


def _fresh(b, n_p, page, h, d):
    return (paged_kv.alloc(b, n_p, page, h * d, torch.int8, "cpu"),
            paged_kv.alloc(b, n_p, page, h, paged_kv.SCALE_DTYPE, "cpu"))


def test_append_gather_dequant_through_pages():
    """Quantized rows appended across page boundaries at ragged offsets
    gather and dequantize back to exactly the direct formula's values."""
    b, n, h, d, page, n_p = 2, 5, 2, 4, 2, 4
    rows = _rows(2, (b, n, h * d))
    pool, spool = _fresh(b, n_p, page, h, d)
    table = paged_kv.identity_table(b, n_p, "cpu")
    q, s = paged_kv.quantize_rows(torch.from_numpy(rows), h)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    paged_kv.append_([pool, spool], table, idx, [q, s])
    view = paged_kv.dequant(paged_kv.gather(pool, table), paged_kv.gather(spool, table),
                            torch.float32)
    direct = paged_kv.dequant(q, s, torch.float32)
    for r in range(b):
        lo = int(idx[r])
        torch.testing.assert_close(view[r, lo:lo + n], direct[r], atol=0, rtol=0)


def test_rewind_overwrite_restores_bytes_and_scales():
    """Garbage written past a frontier and then overwritten by the real
    rows at the same positions leaves bytes AND scales equal to a run that
    never wrote it: the seam a replay or a rewind relies on."""
    b, h, d, page, n_p = 1, 2, 4, 2, 4
    real = _rows(3, (b, 4, h * d))
    garbage = _rows(4, (b, 3, h * d)) * 9
    table = paged_kv.identity_table(b, n_p, "cpu")
    clean = _fresh(b, n_p, page, h, d)
    _put(clean, table, real, 0, h)
    dirty = _fresh(b, n_p, page, h, d)
    _put(dirty, table, real[:, :1], 0, h)
    _put(dirty, table, garbage, 1, h)
    _put(dirty, table, real[:, 1:], 1, h)
    for a, c in zip(clean, dirty):
        assert torch.equal(a, c)


# ------------------------------------------------------- attention parity


B, N, H, D, PG, NP = 4, 4, 2, 8, 4, 5
CASES = [
    ("decode", [7, 3, 12, 19], [1, 1, 1, 1]),
    ("prefill_chunk", [0, 4, 8, 2], [4, 4, 4, 4]),
    ("page_boundary", [3, 4, 7, 8], [2, 1, 4, 3]),
    ("mixed_idle", [9, 0, 5, 16], [1, 4, 0, 2]),
]


def _quant_inputs(seed=0):
    """q (B, N, H, D) and int8 pools with their scale pools as the JAX
    package's (B, NP, PG, feat) arrays."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, N, H, D).astype(np.float32) * 0.3
    kq, ks = jpaged.quantize_rows(jnp.asarray(rng.randn(B, NP * PG, H * D) * 0.3, jnp.float32), H)
    vq, vs = jpaged.quantize_rows(jnp.asarray(rng.randn(B, NP * PG, H * D) * 0.3, jnp.float32), H)
    pools = [np.array(a).reshape(B, NP, PG, -1) for a in (kq, vq, ks, vs)]
    return q, pools


def _flat(pool: np.ndarray) -> torch.Tensor:
    b, n_p, page, feat = pool.shape
    t = torch.from_numpy(pool)
    flat = paged_kv.alloc(b, n_p, page, feat, t.dtype, "cpu")
    paged_kv.pool_view(flat, b).copy_(t)
    return flat


def _valid(length):
    return (np.arange(N)[None] < np.asarray(length)[:, None])[..., None, None]


def _port_attend(q, pools, table, start, length):
    k, v, ks, vs = (_flat(p) for p in pools)
    i32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.int32)  # noqa: E731
    before = ra.kernel_attend_int8.launches
    out = ra.kernel_attend(torch.from_numpy(q), k, v, i32(table), i32(start), i32(length),
                           k_scales=ks, v_scales=vs).numpy()
    assert ra.kernel_attend_int8.launches == before  # CPU tensors: the plain version
    return out


def _jax_attend(q, pools, table, start, length):
    k, v, ks, vs = (jnp.asarray(p) for p in pools)
    s, ln = jnp.asarray(start, jnp.int32), jnp.asarray(length, jnp.int32)
    ker = jra.kernel_attend(jnp.asarray(q), k, v, jnp.asarray(table), s, ln, interpret=True,
                            k_scales=ks, v_scales=vs)
    pos = s[:, None] + jnp.arange(N)[None]
    allowed = (jnp.arange(NP * PG)[None, None] <= pos[..., None])[:, None]
    ref = jra.reference_attend(jnp.asarray(q), k, v, jnp.asarray(table), allowed,
                               k_scales=ks, v_scales=vs)
    return np.asarray(ker), np.asarray(ref)


@pytest.mark.parametrize("label,start,length", CASES, ids=[c[0] for c in CASES])
def test_int8_attention_matches_jax_kernel_and_reference(label, start, length):
    q, pools = _quant_inputs()
    table = np.asarray(jpaged.identity_table(B, NP))
    out = _port_attend(q, pools, table, start, length)
    ker, ref = _jax_attend(q, pools, table, start, length)
    valid = _valid(length)
    assert np.isfinite(out).all()
    for other in (ker, ref):
        np.testing.assert_allclose(np.where(valid, out, 0), np.where(valid, other, 0),
                                   err_msg=label, **TOL)


def test_int8_permuted_table_streams_scales_too():
    """Pages AND their scale pages scattered across rows' storage, the
    table permuted with them: the output is unchanged, and equals JAX's
    kernel on the same permuted pools."""
    q, pools = _quant_inputs(seed=1)
    start, length = [5, 0, 13, 2], [1, 4, 3, 0]
    ident = np.asarray(jpaged.identity_table(B, NP))
    base = _port_attend(q, pools, ident, start, length)
    perm = np.random.RandomState(7).permutation(B * NP)
    moved = []
    for p in pools:
        flat = p.reshape(B * NP, PG, -1)
        out = np.empty_like(flat)
        out[perm] = flat
        moved.append(out.reshape(p.shape))
    table = perm[ident].astype(np.int32)
    out = _port_attend(q, moved, table, start, length)
    ker, _ = _jax_attend(q, moved, table, start, length)
    valid = _valid(length)
    np.testing.assert_allclose(np.where(valid, out, 0), np.where(valid, base, 0), **TOL)
    np.testing.assert_allclose(np.where(valid, out, 0), np.where(valid, ker, 0), **TOL)


# ----------------------------------------------------------------- engine


def _port_tokens(model, kv_quant, filter_thres=GREEDY):
    eng = Engine(model, EngineConfig(max_batch=2, fused_iteration=True, prefill_chunk=2,
                                     page_size=PAGE, filter_thres=filter_thres,
                                     kv_quant=kv_quant),
                 clock=FakeClock(step_dt=1.0), device="cpu")
    for i, n in enumerate(BUDGETS):
        assert eng.submit(Request(f"r{i}", _prompt(i), n, seed=i)) is None
    res = eng.run(max_steps=500)
    assert all(r.outcome is Outcome.COMPLETED for r in res.values())
    assert eng.pool.used == 0
    return eng, {r: res[r].tokens for r in res}


def _jax_engine(jmodel, params, kv_quant):
    return JEngine(jmodel, params, JEngineConfig(
        max_batch=2, fused_iteration=True, prefill_chunk=2, filter_thres=GREEDY,
        kv_quant=kv_quant,
    ), clock=JFakeClock(step_dt=1.0))


def test_int8_engine_greedy_tokens_identical_to_jax(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    jmodel, params, model = tiny_models()
    jeng = _jax_engine(jmodel, params, "int8")
    for i, n in enumerate(BUDGETS):
        assert jeng.submit(JRequest(f"r{i}", _prompt(i), n, seed=i)) is None
    ref = jeng.run(max_steps=500)
    _, got = _port_tokens(model, "int8")
    for i, n in enumerate(BUDGETS):
        assert len(got[f"r{i}"]) == n
        np.testing.assert_array_equal(got[f"r{i}"], ref[f"r{i}"].tokens, err_msg=f"r{i}")


def test_int8_vs_unquantized_token_agreement():
    _, _, model = tiny_models()
    _, plain = _port_tokens(model, None)
    _, int8 = _port_tokens(model, "int8")
    agree = float(np.mean([np.mean(plain[r] == int8[r]) for r in plain]))
    assert agree >= kv_policy.KV_QUANT_TOKEN_AGREEMENT_MIN, agree


def test_kv_bytes_per_slot_equal_jax(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    jmodel, params, model = tiny_models()
    got = {}
    for quant in ("none", "int8"):
        eng = Engine(model, EngineConfig(max_batch=2, fused_iteration=True, prefill_chunk=2,
                                         page_size=PAGE, kv_quant=quant), device="cpu")
        got[quant] = eng.kv_bytes_per_slot
        assert got[quant] == _jax_engine(jmodel, params, quant).kv_bytes_per_slot, quant
    # per slot: pages x page x (h*d content + 4-byte scale per head) x 2 x depth
    n_p, hd, h = 6, model.heads * model.dim_head, model.heads
    assert got["int8"] == n_p * PAGE * (hd + 4 * h) * 2 * model.depth
    assert got["none"] / got["int8"] >= 1.8
