"""The numerics of the tiled flash kernels' float32 dq and dk/dv on the
CPU: they run every product as split 3xTF32 on the tensor cores, and
their sums over keys (dq) and queries (dk, dv) run over up to 4,352
positions at the 512 px training length. The tensor cores truncate as
they accumulate, which ``matmul_3xtf32`` (rounding to nearest) does not
show; ``matmul_3xtf32_card`` emulates it, and pins the design's choice:
every such sum in fresh partials folded in by rounded adds
(``tf32::fold_product``), since one running sum already misses the
float32 tolerance at n 1,280, as measured on the card for the packed
kernels. Each emulation is held against float64, one batch row with one
head of 64, causal.

The float32 forward (``flash_fwd_tf32_kernel``) runs the same way: its
online softmax over 32-key halves with both products as split 3xTF32 and
the value product folded per half (``testing.emulated_flash_fwd``); o
and lse hold ``FLASH_F32_ATOL`` against float64 at n 4,352, causal and
with the axial_col pattern, and one running value sum is shown beside
it."""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops import masks
from dalle_pytorch_tpu_torch.testing import (
    BWD_F32_REL,
    FLASH_F32_ATOL,
    emulated_flash_bwd,
    emulated_flash_fwd,
    matmul_3xtf32,
    matmul_3xtf32_card,
    matmul_tf32,
    truncate_f32,
)


def _float64_flash(q, k, v, do):
    """(o, lse, (dq, dk, dv)) of causal attention in float64: the plain
    forward's arithmetic, then ``emulated_flash_bwd`` with exact
    products."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    n, d = q.shape[-2:]
    s = (q @ k.transpose(-1, -2) * d**-0.5).masked_fill(~fa.may_attend(n, q.device),
                                                         fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True)
    o, lse = (p @ v) / l_safe, (m + torch.log(l_safe))[..., 0]
    return o, lse, emulated_flash_bwd(q, k, v, o, lse, do, torch.matmul)


def _case(n: int, seed: int = 0):
    """((q, k, v float32, o and lse from the float64 forward rounded to
    float32, do float32), the float64 dq, dk, dv) of 1 x 1 head of 64 at
    length n."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 1, n, 64).astype(np.float32))
                   for _ in range(4))
    o, lse, exact = _float64_flash(q, k, v, do)
    return (q, k, v, o.float(), lse.float(), do), exact


@pytest.fixture(scope="module")
def case_1280():
    return _case(1280)


@pytest.fixture(scope="module")
def case_4352():
    return _case(4352)


def _rel(case, matmul, long_matmul=None) -> float:
    """Worst relative L2 error over dq, dk, dv of the emulated backward on
    ``case`` (``_case``) against float64."""
    args, exact = case
    got = emulated_flash_bwd(*args, matmul, long_matmul)
    return max(((g.double() - e).norm() / e.norm()).item() for g, e in zip(got, exact))


def _card(fold):
    return lambda a, b: matmul_3xtf32_card(a, b, fold)


@pytest.mark.parametrize("x, truncated", [
    (1.0, 1.0),  # float32 values stay
    (1.0 + 3 * 2.0**-25, 1.0),  # nearest would give 1 + 2^-23
    (1.0 - 2.0**-40, 1.0 - 2.0**-24),  # below 1: the next float32 down
    (2.0**-140 + 3 * 2.0**-151, 2.0**-140),  # a subnormal: on its grid
])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_truncate_f32_rounds_toward_zero(x, truncated, sign):
    got = truncate_f32(torch.tensor([sign * x], dtype=torch.float64))
    assert got.dtype == torch.float32
    assert got.item() == sign * truncated


def test_card_accumulation_loses_toward_zero_where_rounding_does_not():
    """Positive terms: every mma truncates down, so one running sum ends
    at or below the exact product, several times farther from it than the
    folded sum, which is as close as the rounding emulation."""
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.rand(64, 1024).astype(np.float32))
    b = torch.from_numpy(rng.rand(1024, 32).astype(np.float32))
    exact = a.double() @ b.double()
    straight, folded = matmul_3xtf32_card(a, b), matmul_3xtf32_card(a, b, 32)
    assert (straight.double() <= exact).all()
    err = lambda got: ((got.double() - exact).norm() / exact.norm()).item()  # noqa: E731
    assert err(straight) > 4 * err(folded)
    assert err(folded) <= 2 * err(matmul_3xtf32(a, b)) + 1e-7


def test_tiled_backward_as_3xtf32_holds_float32_tolerance_at_4352(case_4352):
    """Every product as split 3xTF32 (rounded sums): dq, dk, dv within
    ``BWD_F32_REL`` of float64 at the 512 px length."""
    rel = _rel(case_4352, matmul_3xtf32)
    assert rel <= BWD_F32_REL, rel


def test_tiled_backward_as_single_pass_tf32_misses_at_4352(case_4352):
    """One TF32 pass a product misses by far: why the kernels split."""
    rel = _rel(case_4352, matmul_tf32)
    assert rel > 10 * BWD_F32_REL, rel


def test_one_running_sum_misses_float32_tolerance_at_1280(case_1280):
    """The card's finding for the packed kernels (PERF.md: dqkv 1.0-1.5e-5
    at n 1280 with every mma into the running sum), reproduced
    by the truncating emulation: the long sums straight into one
    accumulator miss ``BWD_F32_REL``."""
    rel = _rel(case_1280, matmul_3xtf32, _card(None))
    assert rel > BWD_F32_REL, rel


@pytest.mark.parametrize("fold", [8, 32], ids=["per_k_step", "per_streamed_tile"])
@pytest.mark.parametrize("n", [1280, 4352])
def test_folded_sums_hold_float32_tolerance(request, n, fold):
    """Fresh partials per mma k-step (8) or per streamed tile (32, the
    kernels' ``fold_product``), folded in by rounded adds: within
    ``BWD_F32_REL`` of float64 at n 1,280 and at the 512 px length, with
    room to spare (the straight sum's error at 1,280 is ~40x this)."""
    rel = _rel(request.getfixturevalue(f"case_{n}"), matmul_3xtf32, _card(fold))
    assert rel <= BWD_F32_REL / 4, rel


def _fwd_case(n: int, pattern_name=None, seed: int = 0):
    """((q, k, v) float32 (1, 1, n, 64), the pattern or None, (o, lse) of
    the float64 forward)."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, n, 64).astype(np.float32)) for _ in range(3))
    pattern = None if pattern_name is None else torch.from_numpy(
        masks.pattern_mask(pattern_name, 257, 64)[:n, :n])
    q64, k64, v64 = (t.double() for t in (q, k, v))
    s = (q64 @ k64.transpose(-1, -2) * 64**-0.5).masked_fill(
        ~fa.may_attend(n, q.device, None, True, pattern), fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True)
    return (q, k, v), pattern, ((p @ v64) / l_safe, (m + torch.log(l_safe))[..., 0])


@pytest.fixture(scope="module", params=[None, "axial_col"], ids=["causal", "axial_col"])
def fwd_4352(request):
    return _fwd_case(4352, request.param)


def _fwd_err(case, long_fold: bool):
    """Max abs error of o and of lse of the emulated forward against
    float64."""
    (q, k, v), pattern, (o, lse) = case
    got_o, got_lse = emulated_flash_fwd(q, k, v, matmul_3xtf32, long_fold, pattern=pattern)
    return (got_o.double() - o).abs().max().item(), (got_lse.double() - lse).abs().max().item()


def test_tiled_forward_folded_holds_float32_tolerance_at_4352(fwd_4352):
    """The forward as the kernel runs it (the value sum folded per 32-key
    half): o and lse within ``FLASH_F32_ATOL`` of float64 at the 512 px
    length, with room to spare."""
    o_err, lse_err = _fwd_err(fwd_4352, True)
    assert max(o_err, lse_err) <= FLASH_F32_ATOL / 4, (o_err, lse_err)


def test_tiled_forward_one_running_value_sum_at_4352(fwd_4352):
    """One running value sum (each half's mmas added straight into the
    rescaled o): the truncation costs o several times the folded error
    (5.1-5.4x here, ~5e-6, half the tolerance on one head; the card's
    512 px shape holds 64 heads' rows), so the kernel folds; lse, summed
    on the CUDA cores, does not move."""
    folded, _ = _fwd_err(fwd_4352, True)
    straight, lse_err = _fwd_err(fwd_4352, False)
    assert straight >= 4 * folded and straight > FLASH_F32_ATOL / 4, (straight, folded)
    assert lse_err <= FLASH_F32_ATOL / 4
