"""Where the port's split serving path and its fused path part, on the
tiny float32 DALLE of test_torch_dalle.py on the CPU, and why their
logits cannot be bitwise equal there (test_torch_split_engine.py's
``test_split_logits_near_fused_logits`` holds them within 1e-5; the
tokens of the two paths are equal).

The two sides are those of that test: the split path runs each prompt
as batch-1 chunks 2-2-3, then a 2-row vector ``decode_step``; the fused
path runs 2 x 2 ragged blocks. Hooked layer by layer (embedding,
``to_qkv``, the attention core, ``to_out``, the feed-forward, the head),
the first tensor where they part is layer 0's ``to_qkv`` output over
the prompt's first chunk: its inputs are bitwise equal, its output is
not. torch's CPU GEMM takes another kernel, and another order of
accumulation, for another row count M: row i of ``F.linear(x, W)``
differs between M = 1, M = 2 and M >= 3 (and between larger M at other
widths), by up to ~1e-5 on unit-normal data, where XLA's CPU dot, which
JAX's bitwise contract rests on, gives every row the same bits at any
M. The split path's projections run at M = c (a batch-1 chunk) and
M = b (the vector decode step), the fused path's at M = b * W. These
tests show that this is the whole difference: recomputing the split
path's rows at the fused path's M gives the fused bits exactly, and the
fused rows at the split path's M the split bits. That the two outputs
part at all is a property of the torch build and the host's CPU, not of
the port: where they turn out bitwise equal, the tests skip and say that
the 1e-5 of ``test_split_logits_near_fused_logits`` can be tightened.

So bitwise split = fused is out of reach on torch's CPU GEMM without
running the serving path's products at shapes it does not need; the
port does not pad them (wider products would cost card time for a
property of the CPU). The attention core is not where they part first:
a row of ``attention.cache_block_attend`` has the same bits at every
block width n >= 2 and batch, which the last test holds. A width-1 block
differs from them (JAX computes one as a duplicated width-2 block, the
port does not): the split decode step's core runs at width 1, the fused
one's at width 2, a second parting after the projections', which a pad
of the core alone would not close.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache, insert_decode_cache
from dalle_pytorch_tpu_torch.ops import attention
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import _prompt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    return tiny_models()[2]


def _prompts(model):
    return torch.stack([model.remap_text(torch.from_numpy(_prompt(i))[None])[0]
                        for i in range(2)])


class QKVSpy:
    """Records layer 0's ``to_qkv`` input and output at every call."""

    def __init__(self, model):
        self.linear = model.transformer.attn_blocks[0].fn.fn.fn.to_qkv
        self.calls = []
        self.handle = self.linear.register_forward_hook(
            lambda mod, inp, out: self.calls.append((inp[0].detach(), out.detach())))

    def product(self, x):
        return F.linear(x, self.linear.weight)


def _split_and_fused(model, step):
    """Layer 0's ``to_qkv`` calls at the first parting: ("prefill") each
    row's first batch-1 chunk and the fused path's first 2 x 2 block;
    ("decode") the split path's 2-row vector decode step and the fused
    decode block. Returns (split inputs, split outputs, fused input,
    fused output), the split ones one per call, and the M of each."""
    prompts = _prompts(model)
    T = model.text_len_internal
    spy = QKVSpy(model)
    rows = []
    split_calls = []
    for r in range(2):
        c1 = init_decode_cache(model, 1, "paged", page_size=PAGE)
        for s, c in ((0, 2), (2, 2), (4, 3)):
            spy.calls.clear()
            model.prefill_chunk(prompts[r:r + 1, s:s + c], s, c1, image_only=s + c == T)
            if s == 0:
                split_calls.append(spy.calls[0])
        rows.append(c1)
    cache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    for r, c1 in enumerate(rows):
        insert_decode_cache(cache, c1, r)
    tok = torch.tensor([3, 11], dtype=torch.int32)
    spy.calls.clear()
    model.decode_step(tok, torch.full((2,), T, dtype=torch.int32), cache, image_only=True)
    split_decode = spy.calls[0]
    fcache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    i32 = lambda v: torch.full((2,), v, dtype=torch.int32)  # noqa: E731
    fused_calls = []
    for s in range(0, T, 2):
        c = min(2, T - s)
        block = F.pad(prompts[:, s:s + c], (0, 2 - c))
        spy.calls.clear()
        model.fused_step(block, i32(s), i32(c), torch.full((2,), s + c >= T), fcache)
        fused_calls.append(spy.calls[0])
    spy.calls.clear()
    model.fused_step(F.pad(tok[:, None], (0, 1)), i32(T), i32(1),
                     torch.zeros(2, dtype=torch.bool), fcache)
    fused_decode = spy.calls[0]
    spy.handle.remove()
    if step == "prefill":
        return spy, split_calls, fused_calls[0]
    return spy, [split_decode], fused_decode


def _rows(t):
    """(b, n, features) -> (b * n, features)."""
    return t.reshape(-1, t.shape[-1])


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_first_parting_is_a_product_whose_row_count_differs(model, step):
    spy, split_calls, (f_in, f_out) = _split_and_fused(model, step)
    b, W, _ = f_in.shape
    if step == "prefill":  # each row's first chunk, batch 1, width 2: M = 2
        s_in = torch.cat([x for x, _ in split_calls])
        s_out = torch.cat([y for _, y in split_calls])
        valid = slice(None)
        split_m = split_calls[0][0].shape[0] * split_calls[0][0].shape[1]
    else:  # the vector decode step, 2 rows of one token: M = 2
        (s_in, s_out), = split_calls
        valid = slice(0, 1)
        split_m = s_in.shape[0] * s_in.shape[1]
    fused_m = b * W
    assert (split_m, fused_m) == (2, 4)
    # the inputs are bitwise equal
    assert torch.equal(s_in, f_in[:, valid])
    # the split rows at the fused path's M (the fused block's other
    # columns beside them) give the fused bits
    at_fused_m = f_in.clone()
    at_fused_m[:, valid] = s_in
    assert torch.equal(spy.product(_rows(at_fused_m)).reshape(f_out.shape)[:, valid],
                       f_out[:, valid])
    # and the fused rows at the split path's M give the split bits
    if step == "prefill":
        again = torch.cat([spy.product(_rows(f_in[r:r + 1])).reshape(1, W, -1)
                           for r in range(b)])
    else:
        again = spy.product(_rows(f_in[:, valid])).reshape(s_out.shape)
    assert torch.equal(again, s_out)
    # the outputs part, and stay close: a property of this build's CPU GEMM
    if torch.equal(s_out, f_out[:, valid]):
        pytest.skip("split and fused to_qkv outputs are bitwise equal on this torch/CPU: "
                    "test_split_logits_near_fused_logits can be tightened to torch.equal")
    assert (s_out - f_out[:, valid]).abs().max().item() < 1e-5


def test_attention_core_rows_do_not_depend_on_block_width_or_batch():
    """A query row of ``cache_block_attend`` at block widths n = 2, 3, 5
    and batches 1, 2, 3 has the same bits. At n = 1 it has others on the
    torch CPU builds this was measured on; the test skips where it does
    not, since that is a property of the build."""
    rng = np.random.RandomState(0)
    h, d, W = 2, 32, 24
    q = torch.from_numpy(rng.randn(h, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(W, h * d).astype(np.float32)) for _ in range(2))
    allowed = torch.arange(W) < 7

    def row(b, n):
        out = attention.cache_block_attend(
            q.expand(b, n, h, d).contiguous(), k.expand(b, W, h * d).contiguous(),
            v.expand(b, W, h * d).contiguous(), allowed.expand(b, n, W))
        return out[0, 0]

    ref = row(1, 2)
    for b in (1, 2, 3):
        for n in (2, 3, 5):
            assert torch.equal(row(b, n), ref), (b, n)
    one = row(1, 1)
    if torch.equal(one, ref):
        pytest.skip("a width-1 attention row is bitwise the width-2 one on this torch/CPU")
    assert (one - ref).abs().max().item() < 1e-6
