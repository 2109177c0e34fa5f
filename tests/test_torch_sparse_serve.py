"""Serving the sparse-attention configuration (layers cycling "full",
"axial_row", "axial_col", "conv_like") with the port's engine, on the
CPU, float32, at the tiny size of test_torch_dalle.py (depth 4, dim 64,
2 heads of 32, text 6 + a 4 x 4 grid, page 4):

- the port's fused engine gives greedy tokens IDENTICAL to the JAX
  package's fused engine on converted weights, with unquantized and with
  int8 pages (the non-"full" layers decode through the gathered cache
  view with the pattern's mask rows, as JAX's do);
- ``DALLE.fused_step`` driven teacher-forced (the prompt in chunks, then
  one image token per step) gives the port's own full-sequence forward's
  image logits at every position, atol 1e-4, for a model of each type
  and for the cycle (as JAX's decode parity in tests/test_models.py);
- int8 pages against unquantized ones, teacher-forced: relative L2 error
  of the logits within ``testing.INT8_LOGITS_REL``;
- the decode form with a key mask (the gathered branch) equals the
  full-sequence form with the same mask, atol/rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache
from dalle_pytorch_tpu_torch.ops import paged_kv
from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
from dalle_pytorch_tpu_torch.ops.attention import Attention, PagedKV
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.testing import INT8_LOGITS_REL, rel_l2, teacher_forced_logits
from test_torch_dalle import CONFIG, PAGE, tiny_models
from test_torch_engine import BUDGETS, GREEDY, _prompt

torch.set_num_threads(1)

TYPES = ("full", "axial_row", "axial_col", "conv_like")


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["none", "int8"])
def test_sparse_engine_greedy_tokens_identical_to_jax(monkeypatch, kv_quant):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    jmodel, params, model = tiny_models(depth=4, attn_types=TYPES)
    assert model.transformer.attn_types == TYPES
    jeng = JEngine(jmodel, params, JEngineConfig(
        max_batch=2, fused_iteration=True, prefill_chunk=2, filter_thres=GREEDY,
        kv_quant=kv_quant,
    ), clock=JFakeClock(step_dt=1.0))
    eng = Engine(model, EngineConfig(max_batch=2, fused_iteration=True, prefill_chunk=2,
                                     page_size=PAGE, filter_thres=GREEDY, kv_quant=kv_quant),
                 clock=FakeClock(step_dt=1.0), device="cpu")
    for i, n in enumerate(BUDGETS):
        assert jeng.submit(JRequest(f"r{i}", _prompt(i), n, seed=i)) is None
        assert eng.submit(Request(f"r{i}", _prompt(i), n, seed=i)) is None
    ref = jeng.run(max_steps=500)
    got = eng.run(max_steps=500)
    for i, n in enumerate(BUDGETS):
        r = f"r{i}"
        assert got[r].outcome is Outcome.COMPLETED and len(got[r].tokens) == n
        np.testing.assert_array_equal(got[r].tokens, ref[r].tokens, err_msg=r)
    assert eng.pool.used == 0


def _model(attn_types, dtype=torch.float32):
    cfg = {**CONFIG, "depth": 4, "attn_types": attn_types}
    return DALLE(**cfg, device="cpu", dtype=dtype).init_weights(torch.Generator().manual_seed(3))


def _batch(model, seed=4):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, model.num_text_tokens, size=(2, model.text_seq_len))
    text[1, 3:] = 0  # padded tail: per-position pad ids
    image = rng.randint(0, model.num_image_tokens, size=(2, model.image_seq_len))
    return torch.from_numpy(text), torch.from_numpy(image)


@pytest.mark.parametrize("attn_types", [(t,) for t in TYPES] + [TYPES],
                         ids=list(TYPES) + ["cycle"])
def test_fused_step_teacher_forced_matches_forward(attn_types):
    """Logits after the prompt and after each image token equal the
    full-sequence forward's image logits at the same positions."""
    model = _model(attn_types)
    text, image = _batch(model)
    m = model.image_seq_len - 1  # the forward never feeds the last token
    cache = init_decode_cache(model, 2, page_size=PAGE)
    with torch.no_grad():
        ref = model(text, image)[:, model.text_seq_len:, model.num_text_tokens_ext:]
    got = teacher_forced_logits(model, cache, text, image[:, :m], chunk=4)
    assert got.shape == ref.shape == (2, m + 1, model.num_image_tokens)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("attn_types", [("full",), TYPES], ids=["full", "cycle"])
def test_int8_teacher_forced_logits_within_tolerance(attn_types):
    """Int8 pages against unquantized ones at the tiny size, float32 and
    bfloat16 (the stated tolerance is the flagship's; the error here is
    far smaller). On the CPU no kernel launches."""
    for dtype in (torch.float32, torch.bfloat16):
        model = _model(attn_types, dtype)
        text, image = _batch(model)
        before = ra.kernel_attend_int8.launches
        out = {q: teacher_forced_logits(model, init_decode_cache(model, 2, page_size=PAGE,
                                                                 kv_quant=q), text, image, 4)
               for q in ("none", "int8")}
        assert ra.kernel_attend_int8.launches == before
        assert torch.isfinite(out["int8"]).all()
        assert rel_l2(out["int8"], out["none"]) <= INT8_LOGITS_REL, dtype


@pytest.mark.parametrize("attn_type", ["full", "axial_row"])
def test_decode_form_with_key_mask_matches_full_sequence(attn_type):
    """The decode form's gathered branch ANDs a key mask into the
    pattern's rows, as JAX's does: one block over the whole sequence
    equals the full-sequence form with the same key mask."""
    torch.manual_seed(5)
    L, fmap, n = 23, 4, 22
    attn = Attention(32, L, heads=2, dim_head=16, attn_type=attn_type, image_fmap_size=fmap)
    x = torch.randn(2, n, 32)
    mask = torch.rand(2, n) > 0.3
    mask[:, 0] = True
    kv = PagedKV(k=paged_kv.alloc(2, 6, PAGE, 32, torch.float32, "cpu"),
                 v=paged_kv.alloc(2, 6, PAGE, 32, torch.float32, "cpu"),
                 table=paged_kv.identity_table(2, 6, "cpu"),
                 index=torch.zeros(2, dtype=torch.int32))
    zeros = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        got = attn(x, kv=kv, block_len=zeros + n, block_start=zeros, mask=mask)
        ref = attn(x, mask=mask)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
