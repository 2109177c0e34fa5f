"""The numerics of the packed-qkv kernels' float32 instances, on the CPU:
they run every float32 product on the tensor cores as split 3xTF32
(x = big + small, x*y ~ small*big' + big*small' + big*big'). The TF32
rounding (``cvt.rna.tf32.f32``: nearest, ties away from zero), the split,
and the packed attention forward and backward with its products so
emulated, held at float32's tolerances against the plain versions; and
single-pass TF32, which misses them, as the record of why it was not
taken."""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables
from dalle_pytorch_tpu_torch.testing import (
    BWD_F32_REL,
    F32_ATOL,
    bwd_errors,
    emulated_fused_qkv,
    matmul_3xtf32,
    matmul_tf32,
    split_tf32,
    tf32_round,
)

ULP = 2.0**-10  # a TF32 ulp at 1.0


def _f32(values):
    return torch.tensor(values, dtype=torch.float64).float()


@pytest.mark.parametrize("x, rounded", [
    (1.0, 1.0),
    (1.0 + ULP, 1.0 + ULP),  # representable: unchanged
    (1.0 + ULP / 2 - 2.0**-23, 1.0),  # just below the tie: down
    (1.0 + ULP / 2, 1.0 + ULP),  # a tie: away from zero (ties-even gives 1.0)
    (1.0 + 3 * ULP / 2, 1.0 + 2 * ULP),  # a tie above an odd value: away
    (2.0 - ULP / 2, 2.0),  # a tie that carries into the exponent
    (3.0 * 2.0**-100, 3.0 * 2.0**-100),  # far from 1: the exponent is kept
    ((1.0 + ULP / 2) * 2.0**100, (1.0 + ULP) * 2.0**100),  # a tie at another exponent
    (0.0, 0.0),
])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_round_values_ties_and_sign(x, rounded, sign):
    got = tf32_round(_f32([sign * x]))
    assert got.item() == sign * rounded
    assert torch.signbit(got).item() == (sign < 0)


def test_tf32_round_clears_the_low_bits_and_passes_specials():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4096) * 10.0**rng.uniform(-30, 30, 4096)).astype(np.float32))
    bits = tf32_round(x).view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()
    # within half a TF32 ulp: 2^-11 relative
    assert ((tf32_round(x).double() - x.double()).abs() <= 2.0**-11 * x.double().abs()).all()
    specials = _f32([float("inf"), -float("inf"), float("nan")])
    got = tf32_round(specials)
    assert got[0].item() == float("inf") and got[1].item() == -float("inf")
    assert torch.isnan(got[2]).item()


def test_split_reconstructs_float32():
    """big and small are TF32, and big + small is x within 2^-21 relative
    (2^-22 in theory: each rounding keeps 11 significant bits)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(65536) * 10.0**rng.uniform(-20, 20, 65536)).astype(np.float32))
    big, small = split_tf32(x)
    for part in (big, small):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0**-21 * x.double().abs()).all()
    assert (small.abs() <= 2.0**-11 * x.abs()).all()


def test_matmul_3xtf32_is_as_close_to_float64_as_float32():
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.randn(64, 256).astype(np.float32))
    b = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    exact = a.double() @ b.double()
    err = lambda got: ((got.double() - exact).norm() / exact.norm()).item()  # noqa: E731
    assert err(matmul_3xtf32(a, b)) <= 4 * err(a @ b) + 1e-7
    assert err(matmul_tf32(a, b)) > 1e-4


def _train_row_inputs():
    """One batch row of the training shape with its 16 heads cut to 2: n
    1280, dim_head 64, causal, the DALL-E rotary table (257 text + 32 x 32
    image positions), float32 standard normal qkv and do."""
    b, n, h, d = 1, 1280, 2, 64
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32))
    do = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32))
    table = torch.from_numpy(dalle_rotary_table(d, 257, 32))
    opts = dict(causal=True, rot=rot_tables(table, n, d, torch.float32))
    return qkv, do, h, d, opts


def _errors(matmul):
    """(max abs error over o and lse, worst relative L2 error of dq, dk,
    dv, masked gradient rows exactly 0) of the emulated packed attention
    against the plain versions; the backward on the plain forward's o and
    lse, as the card's checks run the kernel."""
    qkv, do, h, d, opts = _train_row_inputs()
    plain_o, plain_lse = fa.reference_fused_qkv(qkv, h, d, **opts)
    plain = fa.reference_fused_qkv_bwd(qkv, plain_o, plain_lse, do, h, d, **opts)
    o, lse, dqkv = emulated_fused_qkv(qkv, plain_o, plain_lse, do, h, d, matmul, **opts)
    fwd = max((o - plain_o).abs().max().item(), (lse - plain_lse).abs().max().item())
    rel, _, zeros_exact = bwd_errors(dqkv, plain, h, d, opts)
    return fwd, rel, zeros_exact


def test_packed_attention_as_3xtf32_holds_float32_tolerances():
    """The decision the float32 kernels rest on: with every product as
    split 3xTF32, the packed forward stays within ``F32_ATOL`` of the
    plain version and each gradient part within ``BWD_F32_REL``."""
    fwd, rel, zeros_exact = _errors(matmul_3xtf32)
    assert fwd <= F32_ATOL, fwd
    assert rel <= BWD_F32_REL, rel
    assert zeros_exact


def test_packed_attention_as_single_pass_tf32_misses_them():
    """One TF32 pass (about three decimal digits a product) misses both
    tolerances by far: why the float32 kernels split."""
    fwd, rel, _ = _errors(matmul_tf32)
    assert fwd > 10 * F32_ATOL, fwd
    assert rel > 10 * BWD_F32_REL, rel
