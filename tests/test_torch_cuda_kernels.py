"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card only (marker ``gpu``; each test skips without a
card, since a CUDA kernel has no CPU mode). This file imports no JAX, so
it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
from dalle_pytorch_tpu_torch.ops import decode_attention as da
from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops import masks
from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables
from dalle_pytorch_tpu_torch.testing import (
    BS_BF16_ROW_REL,
    BS_F32_ATOL,
    BWD_BF16_ROW_REL,
    BWD_F32_REL,
    F32_ATOL,
    FLASH_BF16_ROW_REL,
    FLASH_F32_ATOL,
    bs_bwd_errors,
    bs_fwd_errors,
    bs_inputs,
    bwd_errors,
    bwd_inputs,
    decode_errors,
    decode_inputs,
    decode_ok,
    flash_bwd_errors,
    flash_fwd_errors,
    flash_inputs,
    ragged_block,
    ragged_errors,
    ragged_inputs,
    ragged_ok,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
def test_ragged_kernel_matches_plain(cuda, dtype, dim_head):
    """``testing.ragged_inputs("small")``: decode rows on and past page
    boundaries, a full-width chunk across one and a short chunk, an idle
    row, through a permuted global-id table; valid columns agree at
    ``RAGGED_F32_ATOL`` / ``RAGGED_BF16_RTOL``, every output is finite,
    and each call counts one launch."""
    q, k, v, _, _, table, start, length = ragged_inputs("small", dtype, "cpu", dim_head=dim_head)
    plain = ra.reference_attend(q, k, v, table, start)
    before = ra.kernel_attend.launches
    got = ra.kernel_attend(*(t.to(cuda) for t in (q, k, v, table, start, length)))
    torch.cuda.synchronize()
    assert ra.kernel_attend.launches == before + 1
    assert torch.isfinite(got).all()
    err, rel = ragged_errors(got.cpu(), plain, length)
    assert ragged_ok(dtype, err, rel), (err, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
@pytest.mark.parametrize("case", ["prefill", "prompt"])
def test_ragged_kernel_wide_block_matches_plain(cuda, dtype, dim_head, case):
    """``testing.ragged_inputs("prefill")`` and ``("prompt")`` (generation's
    paged shape): 257 query columns in one call (five query tiles), rows
    from later positions, short rows and an idle row; valid columns agree
    at the ragged tolerances, one launch."""
    q, k, v, _, _, table, start, length = ragged_inputs(case, dtype, "cpu",
                                                        dim_head=dim_head)
    plain = ra.reference_attend(q, k, v, table, start)
    before = ra.kernel_attend.launches
    got = ra.kernel_attend(*(t.to(cuda) for t in (q, k, v, table, start, length)))
    torch.cuda.synchronize()
    assert ra.kernel_attend.launches == before + 1
    assert torch.isfinite(got).all()
    err, rel = ragged_errors(got.cpu(), plain, length)
    assert ragged_ok(dtype, err, rel), (err, rel)


@pytest.mark.gpu
def test_ragged_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 1, 48, device=cuda)  # dim_head 48: no instance
    flat = torch.zeros(2, 4, 48, device=cuda)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=cuda)  # noqa: E731
    with pytest.raises(ValueError):
        ra.kernel_attend(q, flat, flat, i32([0]), i32(0), i32(1))
    with pytest.raises(TypeError):
        ra.kernel_attend(q.half(), flat.half(), flat.half(), i32([0]), i32(0), i32(1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
def test_ragged_int8_kernel_matches_plain(cuda, dtype, dim_head):
    """The int8 instance on int8 pools and their scale pools, permuted
    together: valid columns agree with ``reference_attend`` (the same
    dequant formula) at the unquantized kernel's tolerances; the call
    counts one int8 launch and no unquantized one; two runs are
    bit-identical."""
    args = ragged_inputs("small", dtype, cuda, int8=True, dim_head=dim_head)
    q, k, v, ks, vs, table, start, length = args
    plain = ra.reference_attend(q, k, v, table, start, ks, vs)
    before = (ra.kernel_attend.launches, ra.kernel_attend_int8.launches)
    got = ra.kernel_attend(q, k, v, table, start, length, ks, vs)
    again = ra.kernel_attend(q, k, v, table, start, length, ks, vs)
    torch.cuda.synchronize()
    assert (ra.kernel_attend.launches, ra.kernel_attend_int8.launches) == (before[0], before[1] + 2)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    err, rel = ragged_errors(got, plain, length)
    assert ragged_ok(dtype, err, rel), (err, rel)


@pytest.mark.gpu
def test_ragged_int8_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, ks, vs, table, start, length = ragged_inputs("small", torch.float32, cuda, int8=True)
    with pytest.raises(TypeError):  # scale pools beside float pools
        ra.kernel_attend(q, k.float(), v.float(), table, start, length, ks, vs)
    with pytest.raises(TypeError):  # scales of another dtype
        ra.kernel_attend(q, k, v, table, start, length, ks.half(), vs.half())
    with pytest.raises(ValueError):  # a scale pool of the wrong width
        ra.kernel_attend(q, k, v, table, start, length, ks[..., :1].contiguous(), vs)
    with pytest.raises(TypeError):  # q of a type the kernel has no instance for
        ra.kernel_attend(q.half(), k, v, table, start, length, ks, vs)
    q, k, v, ks, vs, table, start, length = ragged_inputs(
        "small", torch.float32, cuda, int8=True, dim_head=48)
    with pytest.raises(ValueError):  # dim_head 48: no instance
        ra.kernel_attend(q, k, v, table, start, length, ks, vs)



@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
@pytest.mark.parametrize("case", ["prefill", "prompt"])
def test_ragged_int8_kernel_wide_block_matches_plain(cuda, dtype, dim_head, case):
    """The int8 instance on the 257-column blocks of
    ``test_ragged_kernel_wide_block_matches_plain`` (five query tiles),
    pools and scales through a permuted table: valid columns agree with
    ``reference_attend`` at the ragged tolerances, one int8 launch."""
    q, k, v, ks, vs, table, start, length = ragged_inputs(case, dtype, cuda, int8=True,
                                                          dim_head=dim_head)
    plain = ra.reference_attend(q, k, v, table, start, ks, vs)
    before = ra.kernel_attend_int8.launches
    got = ra.kernel_attend(q, k, v, table, start, length, ks, vs)
    torch.cuda.synchronize()
    assert ra.kernel_attend_int8.launches == before + 1
    assert torch.isfinite(got).all()
    err, rel = ragged_errors(got, plain, length)
    assert ragged_ok(dtype, err, rel), (err, rel)


def _i32(values, device):
    return torch.tensor(values, dtype=torch.int32, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["unquantized", "int8"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
@pytest.mark.parametrize("page", [4, 16, 128])
def test_ragged_kernel_frontiers_on_boundaries(cuda, dtype, int8, dim_head, page):
    """Frontiers that end exactly on boundaries, through a permuted table
    (a 64-key tile then spans sixteen pages of 4 from scattered storage,
    and a page of 128 two tiles): decode rows whose last key is the last
    and the first of a page, of a 64-key tile and of a round of the
    cluster split (4 tiles, 256 keys: 511 and 512), a 16-column chunk
    ending on a round, an idle row. Valid columns agree with ``reference_attend`` at
    the ragged tolerances; the columns past them are exactly 0."""
    starts = (3 * page - 1, 3 * page, 63, 64, 511, 512, 1008, 0)
    lengths = (1, 1, 1, 1, 1, 1, 16, 0)
    q, k, v, ks, vs, table, start, length = ragged_block(
        8, 16, 2, dim_head, page, -(-1040 // page), starts, lengths, dtype, cuda, int8=int8)
    got = ra.kernel_attend(q, k, v, table, start, length, ks, vs)
    plain = ra.reference_attend(q, k, v, table, start, ks, vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err, rel = ragged_errors(got, plain, length)
    assert ragged_ok(dtype, err, rel), (err, rel)
    past = torch.arange(16, device=cuda)[None] >= length.clamp(min=1)[:, None]
    assert (got[past] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["unquantized", "int8"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
@pytest.mark.parametrize("width", [16, 80])
def test_ragged_kernel_rows_are_bitwise_independent(cuda, dtype, int8, dim_head, width):
    """Row 0's output (a prefill of ``width`` columns from position 300;
    16 columns is the narrow query tile, 80 two wide ones) is bitwise the
    same run after run, with the other rows' starts, lengths and tables
    changed, and with the batch cut to row 0 alone; and each of its
    columns is bitwise the one-column row at the same position (a
    preempted request re-prefills its positions at other columns beside
    other rows, and must replay the same tokens)."""
    q, k, v, ks, vs, table, start, length = ragged_block(
        4, width, 2, dim_head, 16, 40, (300, 17, 0, 590), (width, 5, 0, 1), dtype, cuda,
        int8=int8)

    def run(q, table, start, length):
        return ra.kernel_attend(q, k, v, table, start, length, ks, vs)

    base = run(q, table, start, length)
    assert torch.equal(base, run(q, table, start, length))
    others = table.clone()
    others[1:] = table[1:].roll(1, dims=1)
    moved = run(q, others, _i32((300, 600, 33, 0), cuda), _i32((width, 16, 1, 0), cuda))
    assert torch.equal(moved[0], base[0])
    alone = run(q[:1].contiguous(), table[:1].contiguous(), start[:1], length[:1])
    assert torch.equal(alone[0], base[0])
    one = _i32((1,), cuda)
    for c in (0, 5, 15, width - 1):
        q_c = torch.zeros_like(q[:1])
        q_c[0, 0] = q[0, c]
        col = run(q_c, table[:1].contiguous(), start[:1] + c, one)
        assert torch.equal(col[0, 0], base[0, c]), c

def _column_rel_err(got, plain):
    """Max over query rows of |got - plain| / |plain| in L2 over h*d."""
    diff = (got - plain).flatten(2).norm(dim=-1)
    return (diff / plain.flatten(2).norm(dim=-1).clamp(min=1e-30)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
@pytest.mark.parametrize("mode", ["causal_rotary", "key_mask"])
def test_fused_qkv_kernel_matches_plain(cuda, dtype, dim_head, mode):
    """n = 200 (a ragged last tile of 64), 2 batch rows of 4 heads.
    causal_rotary: causal with the DALL-E angle table; key_mask:
    non-causal with a ragged key mask whose second row masks everything
    (o exactly 0, lse -1e30 there). Against the plain version on the same
    inputs: o and lse within abs 1e-5 in float32; in bfloat16 each query
    row's o error norm over h*d within 1% of the plain row's norm and lse
    within 1e-2; one launch per call."""
    b, n, h = 2, 200, 4
    rng = np.random.RandomState(dim_head)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * dim_head).astype(np.float32)).to(dtype)
    kw = dict(causal=mode == "causal_rotary")
    if mode == "causal_rotary":
        kw["rot"] = rot_tables(torch.from_numpy(dalle_rotary_table(dim_head, n - 15, 4)),
                               n, dim_head, dtype)
    else:
        km = torch.from_numpy(rng.rand(b, n) > 0.3)
        km[1] = False
        kw["key_mask"] = km
    plain_o, plain_lse = fa.reference_fused_qkv(qkv, h, dim_head, **kw)
    before = fa.fused_qkv_attention.launches
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in kw.items()}
    if "rot" in kw:
        on_card["rot"] = tuple(t.to(cuda) for t in kw["rot"])
    got_o, got_lse = fa.fused_qkv_attention(qkv.to(cuda), h, dim_head, **on_card)
    torch.cuda.synchronize()
    assert fa.fused_qkv_attention.launches == before + 1
    got_o, got_lse = got_o.float().cpu(), got_lse.cpu()
    plain_o = plain_o.float()
    assert torch.isfinite(got_o).all() and torch.isfinite(got_lse).all()
    if mode == "key_mask":
        assert (got_o[1] == 0).all() and (got_lse[1] == fa.NEG_INF).all()
        got_o, plain_o, got_lse, plain_lse = got_o[:1], plain_o[:1], got_lse[:1], plain_lse[:1]
    if dtype == torch.float32:
        torch.testing.assert_close(got_o, plain_o, atol=1e-5, rtol=0)
        torch.testing.assert_close(got_lse, plain_lse, atol=1e-5, rtol=0)
    else:
        got_o = got_o.reshape(got_o.shape[0], n, h, dim_head)
        plain_o = plain_o.reshape(got_o.shape)
        assert _column_rel_err(got_o, plain_o) <= 1e-2
        torch.testing.assert_close(got_lse, plain_lse, atol=1e-2, rtol=0)


@pytest.mark.gpu
def test_fused_qkv_kernel_rejects_what_it_cannot_take(cuda):
    qkv = torch.zeros(1, 128, 3 * 2 * 64, device=cuda)
    with pytest.raises(ValueError):  # width is not 3 * h * d
        fa.fused_qkv_attention(qkv[..., :-64].contiguous(), 2, 64)
    with pytest.raises(ValueError):  # not contiguous
        wide = torch.zeros(1, 128, 2 * 3 * 2 * 64, device=cuda)
        fa.fused_qkv_attention(wide[..., :3 * 2 * 64], 2, 64)
    with pytest.raises(ValueError):  # key mask of the wrong shape
        fa.fused_qkv_attention(qkv, 2, 64, key_mask=torch.ones(1, 64, device=cuda))
    with pytest.raises(ValueError):  # pattern mask of the wrong shape
        fa.fused_qkv_attention(qkv, 2, 64, pattern_mask=torch.ones(64, 64, device=cuda))
    with pytest.raises(ValueError):  # rotary tables of another dtype than qkv's
        bf16_table = torch.ones(128, 64, dtype=torch.bfloat16, device=cuda)
        fa.fused_qkv_attention(qkv, 2, 64, rot=(bf16_table, bf16_table))
    with pytest.raises(ValueError):  # no instance for dim_head 48
        fa.fused_qkv_attention(torch.zeros(1, 128, 3 * 2 * 48, device=cuda), 2, 48)
    with pytest.raises(TypeError):
        fa.fused_qkv_attention(qkv.half(), 2, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["train", "clip", "pattern", "pattern_col", "d32", "d64",
                                  "d128"])
def test_fused_qkv_bwd_kernel_matches_plain(cuda, dtype, case):
    """dqkv of the kernel against the plain backward on the same inputs, on
    the card, by ``dalle_pytorch_tpu_torch.testing``'s metric: float32
    relative L2 error of dq, dk and dv each within 1e-5; bfloat16 each row's (h*d) error norm within
    2% of the plain row's norm, floored at 1e-3 of the median row (ds and p
    are rounded to bf16 before two products, so one bf16 ulp of a lone
    term is 0.4-0.8% of a row; a row whose exact gradient is 0 holds only
    rounding noise); rows the masks force to 0 exactly 0 (the fully
    masked CLIP row whole); one launch per call."""
    qkv, o, lse, do, h, d, opts = bwd_inputs(case, dtype, cuda)
    plain = fa.reference_fused_qkv_bwd(qkv, o, lse, do, h, d, **opts)
    before = fa.fused_qkv_attention_bwd.launches
    got = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts)
    torch.cuda.synchronize()
    assert fa.fused_qkv_attention_bwd.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    rel, row_rel, zeros_exact = bwd_errors(got, plain, h, d, opts)
    assert zeros_exact
    if case == "clip":
        assert (got[6] == 0).all()
    if dtype == torch.float32:
        assert rel <= BWD_F32_REL, rel
    else:
        assert row_rel <= BWD_BF16_ROW_REL, row_rel


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["train", "clip"])
def test_fused_qkv_bwd_kernel_is_deterministic(cuda, case):
    """No float atomics: two runs give bit-identical gradients."""
    qkv, o, lse, do, h, d, opts = bwd_inputs(case, torch.float32, cuda)
    first = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts)
    second = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_fused_qkv_function_gradients_on_card(cuda):
    """FusedQKVAttention on the card (both kernels) against torch autograd
    of the plain forward on the same float32 inputs: relative L2 error of
    dqkv within 1e-5."""
    qkv, _, _, do, h, d, opts = bwd_inputs("d64", torch.float32, cuda)
    x = qkv.clone().requires_grad_()
    o, _ = fa.FusedQKVAttention.apply(x, None, h, d, True, None, opts["rot"], None)
    (got,) = torch.autograd.grad(o, x, do)
    y = qkv.clone().requires_grad_()
    (ref,) = torch.autograd.grad(fa.reference_fused_qkv(y, h, d, **opts)[0], y, do)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-5


@pytest.mark.gpu
def test_fused_qkv_bwd_kernel_rejects_what_it_cannot_take(cuda):
    qkv = torch.zeros(1, 128, 3 * 2 * 64, device=cuda)
    o, lse = fa.fused_qkv_attention(qkv, 2, 64)
    with pytest.raises(ValueError):  # do of the wrong width
        fa.fused_qkv_attention_bwd(qkv, o, lse, torch.zeros(1, 128, 64, device=cuda), 2, 64)
    with pytest.raises(ValueError):  # lse of the wrong dtype
        fa.fused_qkv_attention_bwd(qkv, o, lse.double(), o, 2, 64)
    with pytest.raises(TypeError):
        fa.fused_qkv_attention_bwd(qkv.half(), o.half(), lse, o.half(), 2, 64)


PACKED_BF16_MODES = ["causal_rotary", "key_mask", "pattern_row", "pattern_col"]


def _packed_inputs(n, d, mode, device, dtype=torch.bfloat16, seed=0):
    """(qkv, do, heads, options) at n and dim_head d, 2 batch rows of 2
    heads, in ``dtype``: causal with the DALL-E rotary table; non-causal
    with a key mask whose second row masks every key and whose first row
    masks the whole key tile 64-127 (where n reaches it); or causal with
    the rotary table and the axial-row / axial-column pattern mask."""
    b, h = 2, 2
    rng = np.random.RandomState(seed)
    text_len, fmap = (257, 32) if n == 1280 else (n - 15, 4)
    opts = dict(causal=mode != "key_mask")
    if mode == "key_mask":
        km = torch.from_numpy(rng.rand(b, n) > 0.3)
        km[1] = False
        km[0, 64:128] = False
        opts["key_mask"] = km.to(device)
    else:
        table = torch.from_numpy(dalle_rotary_table(d, max(text_len, 2), fmap)).to(device)
        opts["rot"] = rot_tables(table, n, d, dtype)
    if mode.startswith("pattern"):
        pattern = masks.axial_mask(max(text_len, 2), fmap, int(mode == "pattern_col"))[:n, :n]
        opts["pattern_mask"] = torch.from_numpy(pattern).to(device)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32)).to(device, dtype)
    do = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32)).to(device, dtype)
    return qkv, do, h, opts


@pytest.mark.gpu
@pytest.mark.parametrize("mode", PACKED_BF16_MODES)
@pytest.mark.parametrize("dim_head", [32, 64, 128])
@pytest.mark.parametrize("n", [17, 64, 200, 1280])
def test_fused_qkv_bf16_tensor_core_kernels_match_plain(cuda, n, dim_head, mode):
    """The bf16 instances (tensor-core tiles) of the packed forward and
    backward against their plain versions on the same inputs, at n 17
    (one ragged tile), 64, 200 (a ragged last tile) and 1280: each query
    row's o error norm over h*d within 1% of the plain row's and lse
    within 1e-2; dqkv by the floored row metric within
    ``BWD_BF16_ROW_REL``; rows the masks leave without a key exactly 0
    (o, dq) with lse -1e30, keys no query attends exactly 0 (dk, dv), the
    fully masked batch row's gradient exactly 0; one launch each."""
    qkv, do, h, opts = _packed_inputs(n, dim_head, mode, cuda)
    plain_o, plain_lse = fa.reference_fused_qkv(qkv, h, dim_head, **opts)
    before = (fa.fused_qkv_attention.launches, fa.fused_qkv_attention_bwd.launches)
    o, lse = fa.fused_qkv_attention(qkv, h, dim_head, **opts)
    got = fa.fused_qkv_attention_bwd(qkv, plain_o, plain_lse, do, h, dim_head, **opts)
    plain = fa.reference_fused_qkv_bwd(qkv, plain_o, plain_lse, do, h, dim_head, **opts)
    torch.cuda.synchronize()
    assert (fa.fused_qkv_attention.launches, fa.fused_qkv_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all() and torch.isfinite(got).all()
    allowed = fa.may_attend(n, cuda, opts.get("key_mask"), opts["causal"],
                            opts.get("pattern_mask"))[:, 0].expand(2, n, n)
    live = allowed.any(dim=2)
    assert (o[~live] == 0).all() and (lse[:, :, 0].transpose(1, 2)[~live] == fa.NEG_INF).all()
    o4, p4 = (t.float().reshape(2, n, h, dim_head) for t in (o, plain_o))
    assert _column_rel_err(o4[live][:, None], p4[live][:, None]) <= 1e-2
    lse_diff = (lse - plain_lse)[:, :, 0].transpose(1, 2)[live]
    assert lse_diff.abs().max().item() <= 1e-2
    _, row_rel, zeros_exact = bwd_errors(got, plain, h, dim_head, opts)
    assert zeros_exact and row_rel <= BWD_BF16_ROW_REL, row_rel
    if mode == "key_mask":
        assert (got[1] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", PACKED_BF16_MODES)
@pytest.mark.parametrize("dim_head", [32, 64, 128])
@pytest.mark.parametrize("n", [17, 64, 200, 1280])
def test_fused_qkv_f32_tensor_core_kernels_match_plain(cuda, n, dim_head, mode):
    """The float32 instances (split-3xTF32 tensor-core tiles) of the packed
    forward and backward against their plain versions on the same inputs
    as the bf16 test, in float32: o and lse within abs ``F32_ATOL`` on
    rows with an allowed key, dq, dk and dv each within relative L2
    ``BWD_F32_REL``; rows the masks leave without a key exactly 0 (o, dq)
    with lse -1e30, keys no query attends exactly 0 (dk, dv), the fully
    masked batch row's gradient exactly 0; one launch each."""
    qkv, do, h, opts = _packed_inputs(n, dim_head, mode, cuda, torch.float32)
    plain_o, plain_lse = fa.reference_fused_qkv(qkv, h, dim_head, **opts)
    before = (fa.fused_qkv_attention.launches, fa.fused_qkv_attention_bwd.launches)
    o, lse = fa.fused_qkv_attention(qkv, h, dim_head, **opts)
    got = fa.fused_qkv_attention_bwd(qkv, plain_o, plain_lse, do, h, dim_head, **opts)
    plain = fa.reference_fused_qkv_bwd(qkv, plain_o, plain_lse, do, h, dim_head, **opts)
    torch.cuda.synchronize()
    assert (fa.fused_qkv_attention.launches, fa.fused_qkv_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all() and torch.isfinite(got).all()
    allowed = fa.may_attend(n, cuda, opts.get("key_mask"), opts["causal"],
                            opts.get("pattern_mask"))[:, 0].expand(2, n, n)
    live = allowed.any(dim=2)
    assert (o[~live] == 0).all() and (lse[:, :, 0].transpose(1, 2)[~live] == fa.NEG_INF).all()
    err = max((o - plain_o)[live].abs().max().item(),
              (lse - plain_lse)[:, :, 0].transpose(1, 2)[live].abs().max().item())
    assert err <= F32_ATOL, err
    rel, _, zeros_exact = bwd_errors(got, plain, h, dim_head, opts)
    assert zeros_exact and rel <= BWD_F32_REL, rel
    if mode == "key_mask":
        assert (got[1] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", PACKED_BF16_MODES)
def test_fused_qkv_f32_tensor_core_kernels_are_deterministic(cuda, mode):
    """No float atomics in the split-3xTF32 instances: at a ragged n (200)
    two runs of the forward and of the backward are bit-identical."""
    qkv, do, h, opts = _packed_inputs(200, 64, mode, cuda, torch.float32)
    o, lse = fa.fused_qkv_attention(qkv, h, 64, **opts)
    o2, lse2 = fa.fused_qkv_attention(qkv, h, 64, **opts)
    first = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, 64, **opts)
    second = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, 64, **opts)
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["train", "clip", "pattern"])
def test_fused_qkv_bwd_bf16_kernel_is_deterministic(cuda, case):
    """No float atomics in the bf16 instance either: two runs give
    bit-identical gradients."""
    qkv, o, lse, do, h, d, opts = bwd_inputs(case, torch.bfloat16, cuda)
    first = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts)
    second = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_fused_qkv_function_bf16_gradients_on_card(cuda):
    """FusedQKVAttention in bf16 on the card (both tensor-core kernels)
    against torch autograd of the plain forward on the same inputs: dqkv
    by the floored row metric within ``BWD_BF16_ROW_REL``, masked rows
    exactly 0."""
    qkv, _, _, do, h, d, opts = bwd_inputs("d64", torch.bfloat16, cuda)
    x = qkv.clone().requires_grad_()
    o, _ = fa.FusedQKVAttention.apply(x, None, h, d, True, None, opts["rot"], None)
    (got,) = torch.autograd.grad(o, x, do)
    y = qkv.clone().requires_grad_()
    (ref,) = torch.autograd.grad(fa.reference_fused_qkv(y, h, d, **opts)[0], y, do)
    _, row_rel, zeros_exact = bwd_errors(got, ref, h, d, opts)
    assert zeros_exact and row_rel <= BWD_BF16_ROW_REL, row_rel


BS_CASES = ["axial_row", "conv_like", "d32", "d64", "d128", "synthetic"]


def _bs_run(q, k, v, do, layout, km):
    """The three kernels, dk/dv on the kernel's own delta: (o, lse, dq,
    dk, dv)."""
    o, lse = bs.block_sparse_attention(q, k, v, layout, km)
    dq, delta = bs.block_sparse_dq(q, k, v, o, lse, do, layout, km)
    dk, dv = bs.block_sparse_dkdv(q, k, v, do, lse, delta, layout, km)
    return o, lse, dq, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BS_CASES)
def test_block_sparse_kernels_match_plain(cuda, dtype, case):
    """``dalle_pytorch_tpu_torch.testing.bs_inputs``: the flagship training
    shape with the axial_row and conv_like layouts, a ragged n 300 at
    dim_head 32/64/128 with a key mask that kills whole rows, and a layout
    with synthetic pairs in both tables. Forward: float32 o and lse within
    abs 1e-5; bfloat16 each row's o error within 1% of the plain row and
    lse within 1e-2. Backward (dq on the plain o and lse, dk/dv on the
    plain delta): float32 each part within relative L2 1e-5; bfloat16 the
    floored row metric within 2%. Rows with no allowed key (and keys no
    query may attend) exactly 0, lse -1e30 there; one launch per kernel
    and call."""
    q, k, v, do, layout, km = bs_inputs(case, dtype, cuda)
    counts = [f.launches for f in (bs.block_sparse_attention, bs.block_sparse_dq,
                                   bs.block_sparse_dkdv)]
    o, lse = bs.block_sparse_attention(q, k, v, layout, km)
    plain_o, plain_lse = bs.reference_block_sparse(q, k, v, layout, km)
    dq, delta = bs.block_sparse_dq(q, k, v, plain_o, plain_lse, do, layout, km)
    plain_dq, plain_delta = bs.reference_block_sparse_dq(q, k, v, plain_o, plain_lse, do,
                                                         layout, km)
    dk, dv = bs.block_sparse_dkdv(q, k, v, do, plain_lse, plain_delta, layout, km)
    plain_dk, plain_dv = bs.reference_block_sparse_dkdv(q, k, v, do, plain_lse, plain_delta,
                                                        layout, km)
    torch.cuda.synchronize()
    assert [f.launches for f in (bs.block_sparse_attention, bs.block_sparse_dq,
                                 bs.block_sparse_dkdv)] == [c + 1 for c in counts]
    for t in (o, lse, dq, delta, dk, dv):
        assert torch.isfinite(t).all()
    err, row_rel, lse_err, dead_exact = bs_fwd_errors(o, lse, plain_o, plain_lse, layout, km)
    rel, grad_row_rel, zeros_exact = bs_bwd_errors((dq, dk, dv), (plain_dq, plain_dk, plain_dv),
                                                   layout, km)
    assert dead_exact and zeros_exact
    assert (delta - plain_delta).abs().max().item() <= 1e-4 * plain_delta.abs().max().item()
    if dtype == torch.float32:
        assert err <= BS_F32_ATOL, err
        assert rel <= BWD_F32_REL, rel
    else:
        assert row_rel <= BS_BF16_ROW_REL and lse_err <= BS_BF16_ROW_REL, (row_rel, lse_err)
        assert grad_row_rel <= BWD_BF16_ROW_REL, grad_row_rel


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["axial_row", "d64"])
def test_block_sparse_kernels_are_deterministic(cuda, case):
    """No float atomics: two runs give bit-identical outputs and gradients."""
    inputs = bs_inputs(case, torch.float32, cuda)
    first, second = _bs_run(*inputs), _bs_run(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_block_sparse_function_gradients_on_card(cuda):
    """BlockSparseAttention on the card (three kernels) against torch
    autograd of the plain forward on the same float32 inputs: each of dq,
    dk, dv within relative L2 1e-5."""
    q, k, v, do, layout, km = bs_inputs("d64", torch.float32, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = bs.BlockSparseAttention.apply(*leaves, km, layout, None)
    got = torch.autograd.grad(o, leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(bs.reference_block_sparse(*leaves, layout, km)[0], leaves, do)
    for g, r in zip(got, ref):
        assert ((g - r).norm() / r.norm()).item() <= 1e-5


@pytest.mark.gpu
def test_block_sparse_kernels_reject_what_they_cannot_take(cuda):
    from dalle_pytorch_tpu_torch.ops import masks

    layout = bs.compile_block_layout(masks.causal_mask(256))
    q = torch.zeros(1, 2, 256, 64, device=cuda)
    with pytest.raises(ValueError):  # a block other than 128
        bs.block_sparse_attention(q, q, q, bs.compile_block_layout(masks.causal_mask(256), 64, 64))
    with pytest.raises(ValueError):  # the layout is for another n
        bs.block_sparse_attention(q[:, :, :200], q[:, :, :200], q[:, :, :200], layout)
    with pytest.raises(ValueError):  # no instance for dim_head 48
        z = torch.zeros(1, 2, 256, 48, device=cuda)
        bs.block_sparse_attention(z, z, z, layout)
    with pytest.raises(ValueError):  # k on another device
        bs.block_sparse_attention(q, q.cpu(), q, layout)
    with pytest.raises(ValueError):  # key mask on another device
        bs.block_sparse_attention(q, q, q, layout, torch.ones(1, 256, dtype=torch.bool))
    with pytest.raises(ValueError):  # operands of two dtypes
        bs.block_sparse_attention(q, q.bfloat16(), q, layout)
    with pytest.raises(TypeError):
        bs.block_sparse_attention(q.half(), q.half(), q.half(), layout)
    o, lse = bs.block_sparse_attention(q, q, q, layout)
    with pytest.raises(ValueError):  # lse of the wrong dtype
        bs.block_sparse_dq(q, q, q, o, lse.double(), o, layout)
    with pytest.raises(ValueError):  # delta of the wrong shape
        bs.block_sparse_dkdv(q, q, q, o, lse, lse[:, :1], layout)


FLASH_CASES = ["pattern", "noncausal", "d32", "d64", "d96", "d128", "tiled", "one_block"]
FLASH_KERNELS = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkdv,
                 fa.flash_attention_bwd_fused)


def _flash_run(q, k, v, do, opts):
    """The four tiled kernels, dk/dv on the kernel's own delta: (o, lse,
    dq, delta, dk, dv, and the single-block kernel's dq, dk, dv)."""
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    dq, delta = fa.flash_attention_dq(q, k, v, o, lse, do, **opts)
    dk, dv = fa.flash_attention_dkdv(q, k, v, do, lse, delta, **opts)
    return (o, lse, dq, delta, dk, dv, *fa.flash_attention_bwd_fused(q, k, v, o, lse, do, **opts))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, case):
    """``dalle_pytorch_tpu_torch.testing.flash_inputs``: the axial_row
    pattern, non-causal, dim_head 32/64/96/128 with a key mask that kills
    whole rows (n 384, six 64-tiles), the same at n 1152, and one flash
    block of 1280 at 3 heads. Forward: float32 o and lse within abs 1e-5; bfloat16 each row's
    o error within 1% of the plain row and lse within 1e-2. Backward, each
    kernel on the plain forward's o and lse (dk/dv on the plain delta):
    float32 each of dq, dk, dv within relative L2 1e-5; bfloat16 the
    floored row metric within 2%. Rows with no allowed key (and keys no
    query may attend) exactly 0, lse -1e30 there; one launch per kernel
    and call."""
    q, k, v, do, opts = flash_inputs(case, dtype, cuda)
    counts = [f.launches for f in FLASH_KERNELS]
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    po, plse = fa.reference_flash_attention(q, k, v, **opts)
    pdelta = (do.float() * po.float()).sum(-1)
    dq, delta = fa.flash_attention_dq(q, k, v, po, plse, do, **opts)
    dk, dv = fa.flash_attention_dkdv(q, k, v, do, plse, pdelta, **opts)
    fused = fa.flash_attention_bwd_fused(q, k, v, po, plse, do, **opts)
    plain = fa.reference_flash_attention_bwd(q, k, v, po, plse, do, **opts)
    torch.cuda.synchronize()
    assert [f.launches for f in FLASH_KERNELS] == [c + 1 for c in counts]
    for t in (o, lse, dq, delta, dk, dv, *fused):
        assert torch.isfinite(t).all()
    err, row_rel, lse_err, dead_exact = flash_fwd_errors(o, lse, po, plse, **opts)
    assert dead_exact
    assert (delta - pdelta).abs().max().item() <= 1e-4 * pdelta.abs().max().item()
    for got in ((dq, dk, dv), fused):
        rel, grad_row_rel, zeros_exact = flash_bwd_errors(got, plain, **opts)
        assert zeros_exact
        if dtype == torch.float32:
            assert rel <= BWD_F32_REL, rel
        else:
            assert grad_row_rel <= BWD_BF16_ROW_REL, grad_row_rel
    if dtype == torch.float32:
        assert err <= FLASH_F32_ATOL, err
    else:
        assert row_rel <= FLASH_BF16_ROW_REL and lse_err <= FLASH_BF16_ROW_REL, (row_rel, lse_err)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pattern", "d64", "one_block"])
def test_flash_kernels_are_deterministic(cuda, case):
    """No float atomics: two runs give bit-identical outputs and gradients."""
    q, k, v, do, opts = flash_inputs(case, torch.float32, cuda)
    first, second = _flash_run(q, k, v, do, opts), _flash_run(q, k, v, do, opts)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("case,kernels", [("tiled", (0, 1, 1, 0)), ("d64", (0, 0, 0, 1)),
                                          ("one_block", (0, 0, 0, 1))])
def test_flash_function_gradients_on_card(cuda, case, kernels):
    """FlashAttention on the card against torch autograd of the plain
    forward on the same float32 inputs: each of dq, dk, dv within relative
    L2 1e-5. n 1152 (three flash blocks) runs dq then dk/dv, n 384 and
    n 1280 (one flash block each) the single-block kernel."""
    q, k, v, do, opts = flash_inputs(case, torch.float32, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = fa.FlashAttention.apply(*leaves, opts["key_mask"], opts["causal"], opts["pattern"],
                                   None)
    counts = [f.launches for f in FLASH_KERNELS]
    got = torch.autograd.grad(o, leaves, do)
    assert [f.launches - c for f, c in zip(FLASH_KERNELS, counts)] == list(kernels)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fa.reference_flash_attention(*leaves, **opts)[0], leaves, do)
    for g, r in zip(got, ref):
        assert ((g - r).norm() / r.norm()).item() <= 1e-5


@pytest.mark.gpu
def test_flash_kernels_reject_what_they_cannot_take(cuda):
    q = torch.zeros(1, 2, 256, 64, device=cuda)
    with pytest.raises(ValueError):  # n not a multiple of the tile
        fa.flash_attention_fwd(q[:, :, :200], q[:, :, :200], q[:, :, :200])
    with pytest.raises(ValueError):  # no instance for dim_head 48
        z = torch.zeros(1, 2, 256, 48, device=cuda)
        fa.flash_attention_fwd(z, z, z)
    with pytest.raises(ValueError):  # k on another device
        fa.flash_attention_fwd(q, q.cpu(), q)
    with pytest.raises(ValueError):  # key mask on another device
        fa.flash_attention_fwd(q, q, q, torch.ones(1, 256, dtype=torch.bool))
    with pytest.raises(ValueError):  # a pattern of another n
        fa.flash_attention_fwd(q, q, q, pattern=torch.ones(128, 128, dtype=torch.bool,
                                                            device=cuda))
    with pytest.raises(ValueError):  # operands of two dtypes
        fa.flash_attention_fwd(q, q.bfloat16(), q)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    o, lse = fa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError):  # lse of the wrong dtype
        fa.flash_attention_dq(q, q, q, o, lse.double(), o)
    with pytest.raises(ValueError):  # delta of the wrong shape
        fa.flash_attention_dkdv(q, q, q, o, lse, lse[:, :1])
    with pytest.raises(ValueError):  # o of the wrong shape
        fa.flash_attention_bwd_fused(q, q, q, o[:, :1], lse, o)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim_head", [2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("mode", ["rotary", "masked", "plain", "own_masked"])
@pytest.mark.parametrize("idx", [0, 5, 46])
def test_decode_kernel_matches_plain(cuda, dtype, dim_head, mode, idx):
    """``testing.decode_inputs`` at b 3, L 48, 4 heads: rotary without a
    key mask, rotary with one (the last row's keys all masked: output 0),
    neither, and the masked own key with an extreme score; out within
    ``testing``'s tolerances, k/v rows bitwise, one launch a call."""
    rot = mode in ("rotary", "masked")
    x = decode_inputs(3, 48, 4, dim_head, idx, dtype, "cpu", rotary=rot,
                      masked=mode == "masked", own_masked=mode == "own_masked")
    plain = da.reference_fused_decode(x[0], x[1], x[2], idx, x[3], x[4], x[5], 4)
    before = da.fused_decode_attention.launches
    on_card = [None if t is None else t.to(cuda) for t in x]
    got = da.fused_decode_attention(on_card[0], on_card[1], on_card[2], idx, *on_card[3:],
                                    heads=4)
    torch.cuda.synchronize()
    assert da.fused_decode_attention.launches == before + 1
    assert all(torch.isfinite(t).all() for t in got)
    assert decode_ok(dtype, *decode_errors(got, plain, x[5], idx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["plain", "own_masked"])
def test_decode_kernel_one_channel_heads(cuda, dtype, mode):
    """dim_head 1, which JAX's predicate admits (at heads a multiple of
    128) and rotary cannot take: the kernel's one-lane, 2- or 4-byte rows
    against the plain version."""
    x = decode_inputs(2, 48, 128, 1, 30, dtype, "cpu", rotary=False,
                      own_masked=mode == "own_masked")
    plain = da.reference_fused_decode(x[0], x[1], x[2], 30, None, None, x[5], 128)
    on_card = [None if t is None else t.to(cuda) for t in x]
    got = da.fused_decode_attention(on_card[0], on_card[1], on_card[2], 30, *on_card[3:],
                                    heads=128)
    assert decode_ok(dtype, *decode_errors(got, plain, x[5], 30))


@pytest.mark.gpu
def test_dalle_with_eight_channel_heads_decodes_on_the_kernel(cuda):
    """A DALLE of 16 heads of 8 (inside ``fused_decode_supported``):
    ``decode_step`` with ``fused_decode`` on the "4d" cache takes the
    kernel in every layer and step, and its logits match the same model's
    on the CPU (plain versions) to 1e-4."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache

    cfg = dict(dim=64, depth=2, heads=16, dim_head=8, num_text_tokens=50, text_seq_len=8,
               num_image_tokens=40, image_fmap_size=4)
    card = DALLE(**cfg, device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(3))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    rng = np.random.RandomState(4)
    ids = np.concatenate((card.remap_text(torch.from_numpy(rng.randint(1, 50, (2, 8)))).numpy(),
                          rng.randint(0, 40, (2, 16))), 1)[:, :card.total_seq_len]
    n = ids.shape[1]
    logits = {}
    for m in (card, cpu):
        cache = init_decode_cache(m, 2, "4d")
        before = da.fused_decode_attention.launches
        logits[m] = torch.stack([
            m.decode_step(torch.from_numpy(ids[:, i]).to(m.device), i, cache, fused_decode=True)
            for i in range(n)], 1).cpu()
        if m is card:
            assert da.fused_decode_attention.launches - before == cfg["depth"] * n
    assert (logits[card] - logits[cpu]).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_decode_kernel_rejects_what_it_cannot_take(cuda):
    x = decode_inputs(2, 48, 4, 64, 5, torch.float32, cuda)
    qkv, kc, vc, cos, sin, _ = x
    with pytest.raises(ValueError):  # idx past the cache
        da.fused_decode_attention(qkv, kc, vc, 48, cos, sin, heads=4)
    with pytest.raises(ValueError):  # rotary tables that end before idx
        da.fused_decode_attention(qkv, kc, vc, 5, cos[:5], sin[:5], heads=4)
    with pytest.raises(TypeError):  # caches of another dtype
        da.fused_decode_attention(qkv, kc.bfloat16(), vc.bfloat16(), 5, heads=4)
    with pytest.raises(TypeError):  # a bool key mask
        da.fused_decode_attention(qkv, kc, vc, 5, key_mask=torch.ones(2, 48, dtype=torch.bool,
                                                                       device=cuda), heads=4)
    with pytest.raises(ValueError):  # a cache on the CPU
        da.fused_decode_attention(qkv, kc.cpu(), vc, 5, heads=4)
    z = torch.zeros(2, 1, 3 * 4 * 48, device=cuda)
    with pytest.raises(ValueError):  # dim_head 48: no instance
        da.fused_decode_attention(z, torch.zeros(2, 48, 4 * 48, device=cuda),
                                  torch.zeros(2, 48, 4 * 48, device=cuda), 5, heads=4)
