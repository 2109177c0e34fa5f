"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card only (marker ``gpu``; each test skips without a
card, since a CUDA kernel has no CPU mode). This file imports no JAX, so
it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops import paged_kv
from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim_head", [32, 64, 128])
def test_ragged_kernel_matches_plain(cuda, dtype, dim_head):
    """Decode rows on and past page boundaries, a full-width and a short
    chunk, an idle row, through a permuted global-id table; valid columns
    agree (float32: abs 1e-5; bfloat16: each query column's error norm
    over h*d within 1% of the plain column's norm, where two bf16
    roundings of the output give ~0.4%), every output is finite, and each
    call counts one launch."""
    b, n, h, page, n_p = 6, 8, 2, 128, 4
    rng = np.random.RandomState(dim_head)
    q = torch.from_numpy(rng.randn(b, n, h, dim_head).astype(np.float32) * 0.3)
    k = paged_kv.alloc(b, n_p, page, h * dim_head, torch.float32, "cpu")
    v = paged_kv.alloc(b, n_p, page, h * dim_head, torch.float32, "cpu")
    k[:-1] = torch.from_numpy(rng.randn(*k[:-1].shape).astype(np.float32) * 0.3)
    v[:-1] = torch.from_numpy(rng.randn(*v[:-1].shape).astype(np.float32) * 0.3)
    perm = torch.from_numpy(rng.permutation(b * n_p))
    k[perm], v[perm] = k[:-1].clone(), v[:-1].clone()
    table = perm[paged_kv.identity_table(b, n_p, "cpu").long()].to(torch.int32)
    start = torch.tensor([127, 128, 0, 250, 509, 3], dtype=torch.int32)
    length = torch.tensor([1, 1, 8, 3, 1, 0], dtype=torch.int32)
    args = [q.to(dtype), k.to(dtype), v.to(dtype), table, start, length]
    plain = ra.reference_attend(*args[:5]).float()
    before = ra.kernel_attend.launches
    got = ra.kernel_attend(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert ra.kernel_attend.launches == before + 1
    got = got.float().cpu()
    assert torch.isfinite(got).all()
    valid = torch.arange(n)[None] < length[:, None]
    if dtype == torch.float32:
        torch.testing.assert_close(got[valid], plain[valid], atol=1e-5, rtol=0)
    else:
        diff = (got[valid] - plain[valid]).flatten(1).norm(dim=1)
        assert (diff <= 1e-2 * plain[valid].flatten(1).norm(dim=1)).all(), diff


@pytest.mark.gpu
def test_ragged_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 1, 48, device=cuda)  # dim_head 48: no instance
    flat = torch.zeros(2, 4, 48, device=cuda)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=cuda)  # noqa: E731
    with pytest.raises(ValueError):
        ra.kernel_attend(q, flat, flat, i32([0]), i32(0), i32(1))
    with pytest.raises(TypeError):
        ra.kernel_attend(q.half(), flat.half(), flat.half(), i32([0]), i32(0), i32(1))


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
