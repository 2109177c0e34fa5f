"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card only (marker ``gpu``; each test skips without a
card, since a CUDA kernel has no CPU mode). This file imports no JAX, so
it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import paged_kv
from dalle_pytorch_tpu_torch.ops import ragged_attention as ra


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
