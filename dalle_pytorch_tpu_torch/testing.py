"""How the attention kernels are held against their plain versions: the
tolerances, the error metrics and the test inputs, shared by
``chip_smoke.py`` and the tests.

dqkv is compared per part (dq, dk, dv). float32: the relative L2 error of
the whole part within ``BWD_F32_REL``. bfloat16: each row's (h*d) error
norm within ``BWD_BF16_ROW_REL`` of the plain row's norm, floored at 1e-3
of the part's median row (ds and p are rounded to bf16 before two
products, so one bf16 ulp of a lone term is 0.4-0.8% of a row; a row whose
exact gradient is 0 holds only rounding noise). Rows the masks force to 0
must be exactly 0.

The ragged kernel's two instances (unquantized and int8 pages) are held
on valid columns at ``RAGGED_F32_ATOL`` / ``RAGGED_BF16_RTOL`` over the
inputs of ``ragged_inputs``. Int8 pages against unquantized ones are a
different function: their teacher-forced logits are held within
``INT8_LOGITS_REL`` (``teacher_forced_logits``, ``rel_l2``).

The block-sparse kernels (forward, dq, dk/dv) are held the same way:
float32 o and lse within abs ``BS_F32_ATOL`` and each gradient part within
``BWD_F32_REL``; bfloat16 each query row's o error within
``BS_BF16_ROW_REL`` of the plain row and lse within ``BS_BF16_ROW_REL``
absolute, the gradients by the floored row metric above. A row is one
position's h*d values; rows that the layout and the key mask leave with
no allowed key (query rows for o and dq, key rows for dk and dv) must be
exactly 0, with lse -1e30.

The tiled flash kernels (forward, dq, dk/dv and the single-block
backward) compute the pair grid's arithmetic over a visit map instead of
a layout, and are held the same way (``FLASH_F32_ATOL``,
``FLASH_BF16_ROW_REL``, ``BWD_F32_REL``, ``BWD_BF16_ROW_REL``;
``flash_fwd_errors``, ``flash_bwd_errors``) on ``flash_inputs``.

The packed-qkv kernels' float32 instances run every product as split
3xTF32 on the tensor cores. ``tf32_round``, ``split_tf32`` and
``matmul_3xtf32`` emulate that arithmetic in plain PyTorch, and
``emulated_fused_qkv`` runs the packed attention, forward and backward,
with its products so emulated (or as single-pass TF32, ``matmul_tf32``),
so that the CPU tests can show that the split holds float32's
tolerances and that one TF32 pass does not. ``emulated_flash_bwd`` and
``emulated_flash_fwd`` do the same for the tiled flash backward and
forward, and ``matmul_3xtf32_card`` accumulates as the tensor cores do
(each mma's result truncated toward zero to float32), with the long
sums straight or folded in fresh partials as the kernels fold them.
``emulated_single_block_bwd`` runs the float32 single-block backward's
role split (its query blocks' and key blocks' delta by
``emulated_row_delta``, the card's warp order) and
``emulated_pair_dkdv`` the pair grid's float32 dk/dv over the halves its
k-major walk visits (``pair_dkdv_halves``); ``emulated_pair_fwd`` and
``emulated_pair_dq`` its float32 forward and dq over the halves its row
walk visits (``pair_row_halves``, the rows of
``block_sparse_attention.half_classes``). The tiled bf16 dq and dk/dv
run on bf16 tensor-core tiles: ``emulated_bf16_tiled_dq`` and
``emulated_bf16_tiled_dkdv`` run their arithmetic (float32 sums of bf16
products per 32-row half, p and ds rounded to bf16 where the sweeps pack
them, delta from the bf16 o and do); so, with delta derived per half,
does the bf16 single-block backward, and ``emulated_bf16_tiled_fwd``
runs the bf16 forward's (the online softmax per 32-key half, p rounded
to bf16 against the running max). The pair grid's bf16 forward, dq and
dk/dv run the same sweeps over its class maps: ``emulated_bf16_pair_fwd``
and ``emulated_bf16_pair_dq`` over the halves of its row walk
(``pair_row_halves``) and
``emulated_bf16_pair_dkdv`` over those of its column walk
(``pair_column_halves``, the rows of
``block_sparse_attention.half_columns``).

The fused decode kernel is held on ``decode_inputs`` by ``decode_errors``:
float32 out within abs ``DECODE_F32_ATOL``, bfloat16 each batch row's out
within ``DECODE_BF16_ROW_REL`` of the plain row, the returned k/v rows
bitwise, and a row with no live key exactly 0. ``emulated_split_decode``
runs the kernel's split in plain PyTorch: the rows [0, idx) cut into the
slices of ``decode_attention.decode_slices``, a partial softmax each,
merged in rank order with the fresh token. Generation through the
kernel against the unfused chain is a different rounding of the same
function: teacher-forced logits within ``DECODE_LOGITS_REL``.

The trainer's inputs: ``write_caption_folder`` (a PNG folder),
``write_tar_shards`` (tar shards of PNG and JPEG members, some cut
short), ``train_tokenizer_json`` (a HuggingFace tokenizer JSON trained on
captions), and ``dropout_masks``, which records the dropout masks the
port draws or feeds it given ones (JAX's, in the tests).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .ops import block_sparse_attention as bs
from .ops import decode_attention as da
from .ops import flash_attention as fa
from .ops import masks, paged_kv
from .ops.rotary import dalle_rotary_table, rot_tables, rotate_half

BWD_F32_REL, BWD_BF16_ROW_REL = 1e-5, 2e-2
# the packed-qkv forward in float32 against its plain version: max abs
# error over o and lse
F32_ATOL = 1e-5
BS_F32_ATOL, BS_BF16_ROW_REL = 1e-5, 1e-2
FLASH_F32_ATOL, FLASH_BF16_ROW_REL = BS_F32_ATOL, BS_BF16_ROW_REL
# the ragged kernel (both instances) against its plain version on valid
# columns: float32 max abs error; bfloat16 the error's L2 norm over a
# query column's h*d outputs relative to the plain column's norm (two
# bf16 roundings of the output are ~0.4%; a page missed or attended twice
# moves a column by 10% or more). The int8 instance's plain version
# applies the same dequant formula, so quantization error does not enter.
RAGGED_F32_ATOL, RAGGED_BF16_RTOL = 1e-5, 1e-2
# float32 logits of a small DALLE (chip_smoke.py's split checks): the
# card's kernels against the CPU's plain versions, or chunkings of one
# prompt against one prefill_step; max abs error
LOGITS_F32_ATOL = 1e-4
# teacher-forced image logits through int8 pages against the same model's
# unquantized pages, relative L2 error over every logit (``rel_l2``).
# Measured on the CPU (``teacher_forced_logits``, 16-token chunks, seeded
# ``init_weights``): float32 dim 64-256, depth 4: 2.5e-4 to 8.1e-4; bf16
# dim 256, depth 4 (dense or the four-type cycle): 5.6e-3 to 5.7e-3; bf16
# at the flagship width (dim 1024, depth 12, 16 x 64) with text 64 + an
# 8 x 8 grid: 2.35e-2. A wrong scale or page moves logits by far more.
INT8_LOGITS_REL = 5e-2
# the fused decode kernel against its plain version: float32 max abs error
# of out; bfloat16 the error norm of each batch row's h*d outputs relative
# to the plain row's norm (one bf16 rounding of the output is ~0.4%; a row
# of the cache missed or read twice moves the output by far more).
DECODE_F32_ATOL, DECODE_BF16_ROW_REL = 1e-5, 1e-2
# teacher-forced logits of a generation through the fused decode kernel
# against the same model's unfused decode chain (relative L2 over every
# logit, ``rel_l2``): in bf16 the chain rounds the rotated q and the
# probabilities to bf16 where the kernel keeps float32.
DECODE_LOGITS_REL = 5e-2
# mixed-precision training (bfloat16 compute, float32 parameters) against
# a reference's runs of the same weights and batch (``gap_ratio``): the
# loss and each tensor (gradients, updates, moments) within
# BF16_GAP_FACTOR times the reference's own bfloat16 error. bfloat16
# rounds at every operation, so no fixed bound holds across tensors; the
# reference's bf16-to-float32 gap sets each one's scale.
BF16_GAP_FACTOR = 2.0


def _part_errors(got_parts, plain_parts, dead):
    """(worst relative L2 error, worst floored row-relative error, dead rows
    exactly 0) over parts of (b, n, width) rows; ``dead`` (b, n) per part."""
    rel, row_rel, zeros_exact = [], [], True
    for g, p, z in zip(got_parts, plain_parts, dead):
        g, p = g.float(), p.float()
        rel.append(((g - p).norm() / p.norm()).item())
        rn = p.norm(dim=-1)
        floor = 1e-3 * rn[~z].median()
        row_rel.append(((g - p).norm(dim=-1)[~z] / rn[~z].clamp(min=floor)).max().item())
        zeros_exact &= bool((g[z] == 0).all())
    return max(rel), max(row_rel), zeros_exact


def bwd_errors(got, plain, h, d, opts):
    """(relative L2 error of the worst part, worst floored row-relative
    error, masked rows exactly 0) of dqkv ``got`` against ``plain``."""
    b, n, _ = got.shape
    allowed = fa.may_attend(n, got.device, opts.get("key_mask"), opts.get("causal", True),
                            opts.get("pattern_mask"))[:, 0].expand(b, n, n)
    dead = (~allowed.any(dim=2), ~allowed.any(dim=1), ~allowed.any(dim=1))
    return _part_errors(got.split(h * d, -1), plain.split(h * d, -1), dead)


def _rows(t):
    """(b, h, n, d) -> (b, n, h*d): one row per position."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _fwd_errors(o, lse, plain_o, plain_lse, allowed):
    """(max abs error over live rows of o and lse, worst row-relative L2
    error of o over live rows, lse abs error, dead rows exactly 0 with
    lse -1e30) of a forward against its plain version; ``allowed``
    (b or 1, 1, n, n) the pairs that may attend."""
    b, h, n, _ = o.shape
    live = allowed[:, 0].any(dim=2).expand(b, n)
    g, p = _rows(o.float()), _rows(plain_o.float())
    diff = (g - p)[live]
    lse_err = (lse - plain_lse).transpose(1, 2)[live].abs().max().item()
    rel = (diff.norm(dim=-1) / p[live].norm(dim=-1)).max().item()
    dead_exact = bool((g[~live] == 0).all()) and bool(
        (lse.transpose(1, 2)[~live] == bs.NEG_INF).all())
    return max(diff.abs().max().item(), lse_err), rel, lse_err, dead_exact


def _bwd_errors(got, plain, allowed):
    """``_part_errors`` of gradients (dq, dk, dv), each (b, h, n, d),
    against the plain ones; ``allowed`` as in ``_fwd_errors``."""
    b, h, n, _ = got[0].shape
    allowed = allowed[:, 0].expand(b, n, n)
    dead = (~allowed.any(dim=2), ~allowed.any(dim=1), ~allowed.any(dim=1))
    return _part_errors([_rows(t) for t in got], [_rows(t) for t in plain], dead)


def bs_fwd_errors(o, lse, plain_o, plain_lse, layout, key_mask=None):
    """``_fwd_errors`` of the block-sparse forward."""
    allowed = bs.may_attend(layout, o.shape[2], o.device, key_mask)
    return _fwd_errors(o, lse, plain_o, plain_lse, allowed)


def bs_bwd_errors(got, plain, layout, key_mask=None):
    """``_bwd_errors`` of the block-sparse gradients (dq, dk, dv)."""
    allowed = bs.may_attend(layout, got[0].shape[2], got[0].device, key_mask)
    return _bwd_errors(got, plain, allowed)


def flash_fwd_errors(o, lse, plain_o, plain_lse, key_mask=None, causal=True,
                     pattern=None):
    """``_fwd_errors`` of the tiled flash forward."""
    allowed = fa.may_attend(o.shape[2], o.device, key_mask, causal, pattern)
    return _fwd_errors(o, lse, plain_o, plain_lse, allowed)


def flash_bwd_errors(got, plain, key_mask=None, causal=True, pattern=None):
    """``_bwd_errors`` of the tiled flash gradients (dq, dk, dv)."""
    allowed = fa.may_attend(got[0].shape[2], got[0].device, key_mask, causal, pattern)
    return _bwd_errors(got, plain, allowed)


def flash_inputs(case: str, dtype, device, seed: int = 0):
    """(q, k, v, do, options) of the tiled flash kernels, q, k, v and do
    (b, h, n, d) standard normal; options the keyword arguments key_mask,
    causal and pattern. "train": the 512 px training shape (b 4, 16 heads
    of 64, n 4352 = 256 text + 64 x 64 image positions), causal.
    "axial_col": b 2 of the same with the axial-column pattern of DALL-E's
    257 + 64 x 64 sequence. "one_block": b 2, 3 heads of 64, n 1280
    (one flash block the packed kernel refuses), causal; "one_block_d32":
    the flagship's b 4, 16 heads and n 1280 at dim_head 32, which the
    packed kernel refuses too, causal. Small shapes, b 2
    and 2 heads at n 384 (one flash block): "pattern" (the axial-row
    pattern of 129 + 16 x 16), "noncausal", and "d32" / "d64" / "d96" /
    "d128", causal with a key mask that drops a fifth of row 0's keys and
    key 0 (text row 0 then attends nothing) and every key of row 1 (all
    its rows dead); "tiled" is "d64" at n 1152 (3 x 3 flash blocks). At
    the 512 px length n 4352 with a small batch: "long" (b 1, 2 heads of
    64, causal), "long_axial_col" (the same with the axial_col pattern)
    and "long_d96" / "long_d128" (b 2, 2 heads, causal, the key mask of
    the "d" cases)."""
    rng = np.random.RandomState(seed)
    opts = dict(key_mask=None, causal=True, pattern=None)
    if case in ("train", "axial_col", "long", "long_axial_col"):
        b, h, n, d = {"train": 4, "axial_col": 2}.get(case, 1), 16, 4352, 64
        if case.startswith("long"):
            h = 2
        if case.endswith("axial_col"):
            opts["pattern"] = torch.from_numpy(
                masks.pattern_mask("axial_col", 257, 64)[:n, :n]).to(device)
    elif case in ("long_d96", "long_d128"):
        b, h, n, d = 2, 2, 4352, int(case[6:])
        km = rng.rand(b, n) > 0.2
        km[0, 0], km[1] = False, False
        opts["key_mask"] = torch.from_numpy(km).to(device)
    elif case == "one_block":
        b, h, n, d = 2, 3, 1280, 64
    elif case == "one_block_d32":
        b, h, n, d = 4, 16, 1280, 32
    else:
        b, h, n = 2, 2, 1152 if case == "tiled" else 384
        d = int(case[1:]) if case.startswith("d") else 64
        if case == "pattern":
            opts["pattern"] = torch.from_numpy(
                masks.pattern_mask("axial_row", 129, 16)[:n, :n]).to(device)
        elif case == "noncausal":
            opts["causal"] = False
        else:
            km = rng.rand(b, n) > 0.2
            km[0, 0], km[1] = False, False
            opts["key_mask"] = torch.from_numpy(km).to(device)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32)).to(device, dtype)
                   for _ in range(4))
    return q, k, v, do, opts


def bs_inputs(case: str, dtype, device, seed: int = 0):
    """(q, k, v, do, layout, key_mask) of the block-sparse kernels, q, k,
    v and do (b, h, n, d) standard normal. "axial_row" / "conv_like": the
    flagship training shape (b 4, 16 heads of 64, n 1280) with that
    pattern of DALL-E's 257 + 32 x 32 sequence, no key mask. "d32" / "d64"
    / "d128": n 300 (n_pad 384, a ragged last block), 2 batch rows of 2
    heads, the conv_like pattern of a 13 + 17 x 17 sequence, and a key
    mask that drops a fifth of row 0's keys and key 0 (text row 0 then
    attends nothing) and every key of row 1 (all its rows dead).
    "synthetic": n 300, 1 x 2 heads of 64, a causal mask whose query
    block 1 attends nothing and whose keys 256-299 no query attends, so
    both tables hold synthetic pairs."""
    rng = np.random.RandomState(seed)
    key_mask = None
    if case in ("axial_row", "conv_like"):
        b, h, n, d = 4, 16, 1280, 64
        mask = masks.pattern_mask(case, 257, 32)[:n, :n]
    elif case == "synthetic":
        b, h, n, d = 1, 2, 300, 64
        mask = masks.causal_mask(n)
        mask[128:256] = False
        mask[:, 256:] = False
    else:
        b, h, n, d = 2, 2, 300, int(case[1:])
        mask = masks.pattern_mask("conv_like", 13, 17)[:n, :n]
        km = rng.rand(b, n) > 0.2
        km[0, 0], km[1] = False, False
        key_mask = torch.from_numpy(km).to(device)
    layout = bs.compile_block_layout(mask)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32)).to(device, dtype)
                   for _ in range(4))
    return q, k, v, do, layout, key_mask


def bwd_inputs(case: str, dtype, device, seed: int = 0):
    """(qkv, o, lse, do, heads, dim_head, options) of the packed-qkv
    backward, o and lse from the plain forward. "train": the flagship
    training shape (b 4, n 1280, 16 heads of 64, causal, DALL-E rotary);
    "clip": CLIP's text shape (b 8, n 256, 8 heads of 64, non-causal, a key
    mask whose row 6 masks every key); "pattern" / "pattern_col": DALL-E's
    shape at b 2 with the axial-row / axial-column pattern mask;
    "d32"/"d64"/"d128": n 200 (a ragged last tile), 2 batch rows of 4
    heads, causal with the rotary table."""
    rng = np.random.RandomState(seed)
    if case == "clip":
        b, n, h, d = 8, 256, 8, 64
        lengths = torch.tensor((256, 200, 131, 64, 17, 1, 0, 240))
        opts = dict(key_mask=(torch.arange(n)[None] < lengths[:, None]).to(device),
                    causal=False)
    else:
        b, n, h, d = {"train": (4, 1280, 16, 64), "pattern": (2, 1280, 16, 64),
                      "pattern_col": (2, 1280, 16, 64),
                      "d32": (2, 200, 4, 32), "d64": (2, 200, 4, 64),
                      "d128": (2, 200, 4, 128)}[case]
        text_len = 257 if n == 1280 else n - 15
        fmap = 32 if n == 1280 else 4
        table = torch.from_numpy(dalle_rotary_table(d, text_len, fmap)).to(device)
        opts = dict(causal=True, rot=rot_tables(table, n, d, dtype))
        if case in ("pattern", "pattern_col"):
            pattern = masks.axial_mask(text_len, fmap, int(case == "pattern_col"))[:n, :n]
            opts["pattern_mask"] = torch.from_numpy(pattern).to(device)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32)).to(device, dtype)
    do = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32)).to(device, dtype)
    o, lse = fa.reference_fused_qkv(qkv, h, d, **opts)
    return qkv, o, lse, do, h, d, opts


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to
    the nearest value with 10 explicit mantissa bits, ties away from
    zero, the low 13 bits zero. Infinities and NaNs pass unchanged."""
    x = x.float().contiguous()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # unsigned
    r = (bits + 0x1000) & 0xFFFFE000  # the magnitude rounds, the sign stays
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x: torch.Tensor):
    """(big, small), both TF32: big = ``tf32_round(x)``, small =
    ``tf32_round(x - big)``; big + small is x within 2^-22 relative."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the float32 kernels compute it on the tensor cores: each
    operand split into TF32 parts, small . big + big . small + big . big,
    accumulated in float32 (each TF32 product is exact in float32)."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass: both operands rounded to TF32."""
    return tf32_round(a) @ tf32_round(b)


def emulated_fused_qkv(qkv, o, lse, do, heads: int, dim_head: int, matmul, key_mask=None,
                       causal: bool = True, pattern_mask=None, rot=None):
    """The packed attention on float32 ``qkv`` (b, n, 3*h*d) with every
    (n, n, d) product computed by ``matmul`` (``matmul_3xtf32`` or
    ``matmul_tf32``), otherwise the arithmetic of
    ``reference_fused_qkv`` and ``reference_fused_qkv_bwd`` step by step.
    Returns (o (b, n, h*d), lse (b, h, 1, n), dqkv (b, n, 3*h*d)); the
    backward runs on the ``o`` and ``lse`` given (the plain forward's, as
    the kernels' checks give them)."""
    b, n, _ = qkv.shape
    h, d = heads, dim_head
    scale = d**-0.5
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.float().split(h * d, dim=-1))
    if rot is not None:
        cos, sin = (t[:n, None].float() for t in rot)
        q, k, v = (t * cos + rotate_half(t) * sin for t in (q, k, v))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, h, n, d)
    allowed = fa.may_attend(n, qkv.device, key_mask, causal, pattern_mask)
    s = (matmul(q, k.transpose(-1, -2)) * scale).masked_fill(~allowed, fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_safe == 0, 1.0, l_safe)
    own_o = (matmul(p, v) / l_safe).transpose(1, 2).reshape(b, n, h * d)
    own_lse = (m + torch.log(l_safe)).transpose(-1, -2)
    p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - lse.transpose(-1, -2)), 0.0)
    do4 = do.float().reshape(b, n, h, d).transpose(1, 2)
    dv = matmul(p.transpose(-1, -2), do4)
    dp = matmul(do4, v.transpose(-1, -2))
    delta = (do4 * o.float().reshape(b, n, h, d).transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = matmul(ds, k)
    dk = matmul(ds.transpose(-1, -2), q)
    grads = [t.transpose(1, 2) for t in (dq, dk, dv)]  # (b, n, h, d)
    if rot is not None:
        grads = [t * cos - rotate_half(t) * sin for t in grads]
    dqkv = torch.cat([t.reshape(b, n, h * d) for t in grads], dim=-1)
    return own_o, own_lse, dqkv


def truncate_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded toward zero to float32."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _mma_steps(c, a_parts, b_parts):
    """float32 ``c`` after the mma k-steps of 8 over the split operands
    ((big, small) of a (..., M, K) and of b (..., K, N)): per k-step the
    three TF32 products (small.big, big.small, big.big), each added to c
    exactly and the result truncated toward zero to float32."""
    (a_big, a_small), (b_big, b_small) = a_parts, b_parts
    for k0 in range(0, a_big.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            c = truncate_f32(c.double() + x[..., ks].double() @ y[..., ks, :].double())
    return c


def matmul_3xtf32_card(a: torch.Tensor, b: torch.Tensor, fold=None) -> torch.Tensor:
    """a @ b (K a multiple of 8) in split 3xTF32 with the accumulation of
    the card's tensor cores: an mma adds its products to the accumulator
    and truncates the sum toward zero to float32 (``_mma_steps``; the
    truncation measured on the card for the packed kernels, PERF.md, which
    ``matmul_3xtf32``, rounding to nearest, does not show). ``fold`` None:
    every mma into one running sum. ``fold`` F (a multiple of 8 dividing
    K): a fresh partial per F rows of k, added to the running sum by a
    float32 add rounded to nearest, as ``tf32::fold_product`` folds (F =
    32, the kernels' streamed tiles)."""
    a_parts, b_parts = split_tf32(a), split_tf32(b)
    zero = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if fold is None:
        return _mma_steps(zero, a_parts, b_parts)
    acc = zero
    for k0 in range(0, a.shape[-1], fold):
        ks = slice(k0, k0 + fold)
        acc = acc + _mma_steps(zero, [t[..., ks] for t in a_parts],
                               [t[..., ks, :] for t in b_parts])
    return acc


def emulated_flash_bwd(q, k, v, o, lse, do, matmul, long_matmul=None, key_mask=None,
                       causal: bool = True, pattern=None, delta=None):
    """The tiled flash backward (the dq and dk/dv passes) on q, k, v, o,
    do (b, h, n, d) and lse (b, h, n), the arithmetic of
    ``reference_flash_attention_bwd`` step by step in the inputs' dtype,
    with the products over channels (s = q.k^T, dp = do.v^T) computed by
    ``matmul`` and the sums over keys and queries (dq = ds.k, dk =
    ds^T.q, dv = p^T.do) by ``long_matmul`` (default ``matmul``); delta
    (b, h, n) given, or rowsum(do * o). Returns (dq, dk, dv)."""
    long_matmul = long_matmul or matmul
    n, d = q.shape[-2:]
    scale = d**-0.5
    allowed = fa.may_attend(n, q.device, key_mask, causal, pattern)
    s = (matmul(q, k.transpose(-1, -2)) * scale).masked_fill(~allowed, fa.NEG_INF)
    p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - lse[..., None]), 0.0)
    del s
    dp = matmul(do, v.transpose(-1, -2))
    delta = (do * o).sum(-1) if delta is None else delta
    ds = p * (dp - delta[..., None]) * scale
    del dp
    return (long_matmul(ds, k), long_matmul(ds.transpose(-1, -2), q),
            long_matmul(p.transpose(-1, -2), do))


def emulated_flash_fwd(q, k, v, matmul, long_fold: bool = True, key_mask=None,
                       causal: bool = True, pattern=None):
    """The tiled flash forward as ``flash_fwd_tf32_kernel`` runs it, on
    float32 q, k, v (b, h, n, d): the online softmax over the kernel's
    32-key halves (running max, denominator rescaled by corr = exp(m -
    m_new)), s = q.k^T by ``matmul`` (e.g. ``matmul_3xtf32``), and the
    value product on the tensor cores' truncating accumulation
    (``_mma_steps``): with ``long_fold`` a fresh partial per half folded
    in as o * corr + partial, one rounding (``tf32::fold_product``'s FMA);
    without, o rescaled by corr and the half's mmas added straight into
    it. Returns (o, lse (b, h, n)) as the plain forward's."""
    n, d = q.shape[-2:]
    scale = d**-0.5
    allowed = fa.may_attend(n, q.device, key_mask, causal, pattern)
    m = torch.full(q.shape[:-1] + (1,), fa.NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, n, 32):
        ks = slice(k0, k0 + 32)
        s = (matmul(q, k[..., ks, :].transpose(-1, -2)) * scale).masked_fill(
            ~allowed[..., ks], fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        parts = split_tf32(p), split_tf32(v[..., ks, :])
        if long_fold:
            partial = _mma_steps(torch.zeros_like(o), *parts)
            o = (o.double() * corr.double() + partial.double()).float()
        else:
            o = _mma_steps(o * corr, *parts)
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    return o / l_safe, (m + torch.log(l_safe))[..., 0]


def emulated_row_delta(o, do) -> torch.Tensor:
    """delta = rowsum(o * do) of float32 (..., n, d) rows, d a multiple of
    32, as ``tf32::row_delta`` sums a row on the card: lane l's partial
    over channels l, l + 32, .. by FMAs (each product exact in float64,
    added and rounded to float32), then a butterfly over the 32 lanes
    (partial[l] + partial[l ^ s] for s = 16, 8, 4, 2, 1, float32 adds).
    Returns (..., n) float32."""
    o, do = o.float(), do.float()
    part = torch.zeros(o.shape[:-1] + (32,), dtype=torch.float32)
    for c in range(0, o.shape[-1], 32):
        part = (o[..., c:c + 32].double() * do[..., c:c + 32].double() + part.double()).float()
    lane = torch.arange(32)
    for s in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ s]
    return part[..., 0]


def emulated_single_block_bwd(q, k, v, o, lse, do, key_mask=None, causal: bool = True,
                              pattern=None):
    """The single-block backward as ``flash_bwd_fused_tf32_kernel`` runs it
    on float32 q, k, v, o, do (b, h, n, d) and lse (b, h, n): its query
    blocks' delta of each 64-row tile's rows and its key blocks' delta of
    each streamed 32-row half (``emulated_row_delta`` both), then
    ``emulated_flash_bwd`` with the products over channels as split 3xTF32
    (``matmul_3xtf32``) and the long sums folded per 32-row half on the
    card's truncating accumulation (``matmul_3xtf32_card``, fold 32), on
    the key blocks' delta (which the query blocks' equals bit for bit, as
    the tests check). Halves the kernel passes over add exact zeros, so
    every half is folded here. Returns (dq, dk, dv, the query blocks'
    delta, the key blocks' delta)."""
    n = q.shape[-2]
    delta_q, delta_k = (torch.cat([emulated_row_delta(o[..., r:r + rows, :], do[..., r:r + rows, :])
                                   for r in range(0, n, rows)], -1) for rows in (64, 32))
    grads = emulated_flash_bwd(q, k, v, o, lse, do, matmul_3xtf32,
                               lambda a, b: matmul_3xtf32_card(a, b, 32), key_mask, causal,
                               pattern, delta=delta_k)
    return (*grads, delta_q, delta_k)


def emulated_bf16_tiled_fwd(q, k, v, key_mask=None, causal: bool = True, pattern=None):
    """The tiled bf16 forward as ``flash_fwd_tc_kernel`` runs it (csrc/
    bf16_sweeps.cuh), on bf16 q, k, v (b, h, n, d): over the 32-key
    halves in key order (a half the walk passes over adds p = 0 and leaves
    every sum as it is, so every half is taken here), s = q.k^T in float32
    from the bf16 inputs, scaled and masked; the running max m_new =
    max(m, rowmax(s)), corr = exp(m - m_new) rescaling the float32 l and
    o; p = exp(s - m_new) where s > 0.5 * NEG_INF, else 0, summed
    unrounded into l and rounded to bf16 (where the sweep packs it into
    the A fragments of P.V) for o += p.v. o = o / l (l = 1 where l == 0)
    rounded to bf16, lse = m + log(l) in float32. Returns (o, lse) as the
    plain forward's."""
    n, d = q.shape[-2:]
    scale = d**-0.5
    allowed = fa.may_attend(n, q.device, key_mask, causal, pattern)
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full(q.shape[:-1] + (1,), fa.NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, n, 32):
        ks = slice(k0, k0 + 32)
        s = (qf @ kf[..., ks, :].transpose(-1, -2) * scale).masked_fill(~allowed[..., ks],
                                                                         fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.bfloat16().float() @ vf[..., ks, :]
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    return (o / l_safe).bfloat16(), (m + torch.log(l_safe))[..., 0]


def emulated_bf16_tiled_dq(q, k, v, o, lse, do, key_mask=None, causal: bool = True,
                           pattern=None):
    """The tiled bf16 dq as ``flash_dq_tc_kernel`` runs it (csrc/
    bf16_sweeps.cuh), on bf16 q, k, v, o, do (b, h, n, d) and the
    forward's lse (b, h, n): delta = rowsum(o * do) in float32 from the
    bf16 o and do (``emulated_row_delta``, the warp's order); then over
    the 32-key halves in the walk's order (key order; a half the walk
    passes over adds exact zeros, so every half is taken here), s = q.k^T
    and dp = do.v^T in float32 from the bf16 inputs, s scaled and masked,
    p = exp(s - lse) where s > 0.5 * NEG_INF, ds = p * (dp - delta) *
    scale rounded to bf16 (where the sweep packs it into the A fragments
    of dS.K), and the half's ds.k added to the running float32 sum.
    Returns (dq in bf16, delta float32)."""
    n, d = q.shape[-2:]
    scale = d**-0.5
    allowed = fa.may_attend(n, q.device, key_mask, causal, pattern)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = emulated_row_delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, n, 32):
        ks = slice(k0, k0 + 32)
        s = (qf @ kf[..., ks, :].transpose(-1, -2) * scale).masked_fill(~allowed[..., ks],
                                                                         fa.NEG_INF)
        p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - lse[..., None]), 0.0)
        dp = dof @ vf[..., ks, :].transpose(-1, -2)
        ds = (p * (dp - delta[..., None]) * scale).bfloat16().float()
        dq = dq + ds @ kf[..., ks, :]
    return dq.bfloat16(), delta


def emulated_bf16_tiled_dkdv(q, k, v, do, lse, delta, key_mask=None, causal: bool = True,
                             pattern=None):
    """The tiled bf16 dk/dv as ``flash_dkdv_tc_kernel`` runs it (key-major,
    csrc/bf16_sweeps.cuh), on bf16 q, k, v, do (b, h, n, d), the forward's
    lse and the dq pass's delta (b, h, n): over the 32-query halves in the
    walk's order (query order; a half the walk passes over adds exact
    zeros), s^T = k.q^T and dp^T = v.do^T in float32 from the bf16 inputs,
    s scaled and masked, p = exp(s - lse) where s > 0.5 * NEG_INF; p
    rounded to bf16 for dv += p^T.do and ds = p * (dp - delta) * scale (on
    the unrounded p) rounded to bf16 for dk += ds^T.q, each half's partial
    added to the running float32 sums. Returns (dk, dv) in bf16."""
    n, d = q.shape[-2:]
    scale = d**-0.5
    allowed = fa.may_attend(n, q.device, key_mask, causal, pattern)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dk = torch.zeros(q.shape, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for q0 in range(0, n, 32):
        rows = slice(q0, q0 + 32)
        s = (kf @ qf[..., rows, :].transpose(-1, -2) * scale).masked_fill(
            ~allowed[..., rows, :].transpose(-1, -2), fa.NEG_INF)  # (b, h, key, query)
        p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - lse[..., None, rows]), 0.0)
        dp = vf @ dof[..., rows, :].transpose(-1, -2)
        ds = p * (dp - delta[..., None, rows]) * scale
        dv = dv + p.bfloat16().float() @ dof[..., rows, :]
        dk = dk + ds.bfloat16().float() @ qf[..., rows, :]
    return dk.bfloat16(), dv.bfloat16()


def pair_dkdv_halves(layout, k0: int):
    """The 32-row query halves that the pair grid's float32 dk/dv
    (``bs_dkdv_tf32_kernel``) walks for its 64-key tile at ``k0``, in its
    order, as ``tf32::PairRun`` finds them: the k-major pair run of the
    tile's 128-block, each pair's four halves, less class 0 pairs, halves
    at or past n and class 1 halves whose (32, 64) tile of ``layout.mask``
    is empty. Returns [(q0, class)]."""
    kv = layout.kv_table
    offsets = bs._run_offsets(kv[1], layout.nk)
    kb = k0 // bs.DEFAULT_BLOCK
    halves = []
    for h in range(4 * offsets[kb], 4 * offsets[kb + 1]):
        cls, q0 = int(kv[2, h // 4]), int(kv[0, h // 4]) * bs.DEFAULT_BLOCK + 32 * (h % 4)
        if cls == 0 or q0 >= layout.n:
            continue
        if cls == 1 and not layout.mask[q0:q0 + 32, k0:k0 + 64].any():
            continue
        halves.append((q0, cls))
    return halves


def emulated_pair_dkdv(q, k, v, do, lse, delta, layout, key_mask=None):
    """The pair grid's float32 dk/dv as ``bs_dkdv_tf32_kernel`` runs it on
    float32 q, k, v, do (b, h, n, d), the dq pass's lse and delta (b, h, n)
    and a 128-block layout: per 64-key tile (K and V resident, keys past n
    zero), over the halves of ``pair_dkdv_halves`` (query rows past n zero,
    their lse and delta 0), s^T = K.Q^T and dp^T = V.dO^T as split 3xTF32
    (``matmul_3xtf32``), p and ds masked by the half's class (2: the key
    mask; 1: the layout's mask tile and the key mask), dV += P^T.dO and dK
    += dS^T.Q each a fresh partial per half on the card's truncating
    accumulation (``_mma_steps``) folded in by a rounded add. Returns
    (dk, dv) (b, h, n, d)."""
    b, h, n, d = q.shape
    scale = d**-0.5
    pad = layout.n_pad - n
    qp, kp, vp, dop = (F.pad(t.float(), (0, 0, 0, pad)) for t in (q, k, v, do))
    lse_p, delta_p = (F.pad(t.float(), (0, pad)) for t in (lse, delta))
    keys = torch.zeros(b, layout.n_pad, dtype=torch.bool)
    keys[:, :n] = True if key_mask is None else key_mask.cpu() != 0
    mask = torch.from_numpy(layout.mask)
    dk = torch.zeros(b, h, layout.n_pad, d)
    dv = torch.zeros_like(dk)
    for k0 in range(0, n, 64):
        kt = slice(k0, k0 + 64)
        for q0, cls in pair_dkdv_halves(layout, k0):
            rows = slice(q0, q0 + 32)
            ok = keys[:, None, kt, None].expand(b, 1, 64, 32)  # (b, 1, key, query)
            if cls == 1:
                ok = ok & mask[rows, kt].T
            s = (matmul_3xtf32(kp[..., kt, :], qp[..., rows, :].transpose(-1, -2)) * scale
                 ).masked_fill(~ok, fa.NEG_INF)
            p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - lse_p[..., None, rows]), 0.0)
            dp = matmul_3xtf32(vp[..., kt, :], dop[..., rows, :].transpose(-1, -2))
            ds = p * (dp - delta_p[..., None, rows]) * scale
            zero = torch.zeros(b, h, 64, d)
            dv[..., kt, :] += _mma_steps(zero, split_tf32(p), split_tf32(dop[..., rows, :]))
            dk[..., kt, :] += _mma_steps(zero, split_tf32(ds), split_tf32(qp[..., rows, :]))
    return dk[..., :n, :], dv[..., :n, :]


def pair_row_halves(layout, q0: int):
    """The 32-key halves that the pair grid's forward and dq (both types:
    ``bs_fwd_tf32_kernel``, ``bs_dq_tf32_kernel``, ``bs_fwd_tc_kernel``,
    ``bs_dq_tc_kernel``) walk for the 64-row
    query tile at ``q0``, in key order, as ``tf32::HalfRow`` finds them:
    the nonzero entries of the tile's row of ``half_classes``. Returns
    [(k0, class)]."""
    row = bs.half_classes(layout)[q0 // bs.TILE]
    return [(bs.HALF * h, int(c)) for h, c in enumerate(row) if c != 0]


def _pair_rows(layout, key_mask, b: int, q0: int, k0: int, cls: int, rows: int = bs.TILE,
               cols: int = bs.HALF):
    """(b, 1, rows, cols) bool: the (query, key) pairs of the tile of
    query rows q0 .. and keys k0 .. that the kernels let through: the key
    mask (keys below n), and for a class 1 half the layout's mask tile."""
    n = layout.n
    keys = torch.zeros(b, cols, dtype=torch.bool)
    live = slice(0, max(0, min(cols, n - k0)))
    keys[:, live] = (True if key_mask is None
                     else key_mask.cpu()[:, k0:k0 + cols][:, live] != 0)
    ok = keys[:, None, None, :].expand(b, 1, rows, cols)
    if cls == 1:
        ok = ok & torch.from_numpy(layout.mask[q0:q0 + rows, k0:k0 + cols])
    return ok


def _padded(layout, *tensors):
    """(b, h, n, d) float32 tensors padded with zero rows to n_pad."""
    pad = layout.n_pad - layout.n
    return [F.pad(t.float(), (0, 0, 0, pad)) for t in tensors]


def emulated_pair_fwd(q, k, v, layout, key_mask=None):
    """The pair grid's float32 forward as ``bs_fwd_tf32_kernel`` runs it
    on float32 q, k, v (b, h, n, d) and a 128-block layout: per 64-row
    query tile (rows past n zero), the online softmax over the halves of
    ``pair_row_halves`` (keys past n zero) with s = q.k^T as split 3xTF32
    (``matmul_3xtf32``), masked by the half's class (2: the key mask; 1:
    the layout's mask tile and the key mask), and the value product on
    the card's truncating accumulation (``_mma_steps``), a fresh partial
    per half folded in as o * corr + partial with one rounding. o = acc /
    l with l = 1 where l == 0, lse = m + log(l). Returns (o, lse (b, h,
    n))."""
    b, h, n, d = q.shape
    scale = d**-0.5
    qp, kp, vp = _padded(layout, q, k, v)
    o = torch.zeros(b, h, layout.n_pad, d)
    lse = torch.zeros(b, h, layout.n_pad)
    for q0 in range(0, n, bs.TILE):
        rows = slice(q0, q0 + bs.TILE)
        m = torch.full((b, h, bs.TILE, 1), bs.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, bs.TILE, d)
        for k0, cls in pair_row_halves(layout, q0):
            keys = slice(k0, k0 + bs.HALF)
            s = (matmul_3xtf32(qp[..., rows, :], kp[..., keys, :].transpose(-1, -2)) * scale
                 ).masked_fill(~_pair_rows(layout, key_mask, b, q0, k0, cls), bs.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - m_new), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            part = _mma_steps(torch.zeros_like(acc), split_tf32(p), split_tf32(vp[..., keys, :]))
            acc = (acc.double() * corr.double() + part.double()).float()
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        o[..., rows, :] = acc / l_safe
        lse[..., rows] = (m + torch.log(l_safe))[..., 0]
    return o[..., :n, :], lse[..., :n]


def emulated_pair_dq(q, k, v, o, lse, do, layout, key_mask=None):
    """The pair grid's float32 dq as ``bs_dq_tf32_kernel`` runs it on
    float32 q, k, v, o, do (b, h, n, d), lse (b, h, n) and a 128-block
    layout: per 64-row query tile, delta of its rows by
    ``emulated_row_delta`` (0 at rows past n, which are zero here and which
    the kernel does not read), then over the halves of ``pair_row_halves`` s = Q.K^T and dp
    = dO.V^T as split 3xTF32 (``matmul_3xtf32``), p = exp(s - lse) masked
    by the half's class, ds = p * (dp - delta) * scale, and dQ += dS.K a
    fresh partial per half on the card's truncating accumulation
    (``_mma_steps``) folded in by a rounded add. Returns (dq (b, h, n, d),
    delta (b, h, n))."""
    b, h, n, d = q.shape
    scale = d**-0.5
    qp, kp, vp, op, dop = _padded(layout, q, k, v, o, do)
    lse_p = F.pad(lse.float(), (0, layout.n_pad - n))
    dq = torch.zeros(b, h, layout.n_pad, d)
    delta = torch.zeros(b, h, layout.n_pad)
    for q0 in range(0, n, bs.TILE):
        rows = slice(q0, q0 + bs.TILE)
        delta[..., rows] = emulated_row_delta(op[..., rows, :], dop[..., rows, :])
        for k0, cls in pair_row_halves(layout, q0):
            keys = slice(k0, k0 + bs.HALF)
            s = (matmul_3xtf32(qp[..., rows, :], kp[..., keys, :].transpose(-1, -2)) * scale
                 ).masked_fill(~_pair_rows(layout, key_mask, b, q0, k0, cls), bs.NEG_INF)
            p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - lse_p[..., rows, None]), 0.0)
            dp = matmul_3xtf32(dop[..., rows, :], vp[..., keys, :].transpose(-1, -2))
            ds = p * (dp - delta[..., rows, None]) * scale
            part = _mma_steps(torch.zeros(b, h, bs.TILE, d), split_tf32(ds),
                              split_tf32(kp[..., keys, :]))
            dq[..., rows, :] += part
    return dq[..., :n, :], delta[..., :n]


def pair_column_halves(layout, k0: int):
    """The 32-row query halves that the pair grid's bf16 dk/dv
    (``bs_dkdv_tc_kernel``) walks for the 64-key tile at ``k0``, in query
    order, as ``tf32::HalfColumn`` finds them: the nonzero entries of the
    tile's row of ``block_sparse_attention.half_columns``. Returns
    [(q0, class)]."""
    row = bs.half_columns(layout)[k0 // bs.TILE]
    return [(bs.HALF * h, int(c)) for h, c in enumerate(row) if c != 0]


def emulated_bf16_pair_fwd(q, k, v, layout, key_mask=None):
    """The pair grid's bf16 forward as ``bs_fwd_tc_kernel`` runs it (the
    ``fwd_sweep`` of csrc/bf16_sweeps.cuh over ``tf32::HalfRow``) on bf16
    q, k, v (b, h, n, d) and a 128-block layout: per 64-row query tile
    (rows past n zero), the online softmax over the halves of
    ``pair_row_halves`` (keys past n zero): s = q.k^T in float32 from the
    bf16 inputs, scaled and masked by the half's class (2: the key mask;
    1: the layout's mask tile and the key mask); the running max m_new =
    max(m, rowmax(s)), corr = exp(m - m_new) rescaling the float32 l and
    o; p = exp(s - m_new) where s > 0.5 * NEG_INF, else 0, summed
    unrounded into l and rounded to bf16 (where the sweep packs it into
    the A fragments of P.V) for o += p.v. o = o / l (l = 1 where l == 0)
    rounded to bf16 once, lse = m + log(l) in float32. Returns (o, lse)
    as the plain forward's."""
    b, h, n, d = q.shape
    scale = d**-0.5
    qp, kp, vp = _padded(layout, q, k, v)
    o = torch.zeros(b, h, layout.n_pad, d)
    lse = torch.zeros(b, h, layout.n_pad)
    for q0 in range(0, n, bs.TILE):
        rows = slice(q0, q0 + bs.TILE)
        m = torch.full((b, h, bs.TILE, 1), bs.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, bs.TILE, d)
        for k0, cls in pair_row_halves(layout, q0):
            keys = slice(k0, k0 + bs.HALF)
            s = (qp[..., rows, :] @ kp[..., keys, :].transpose(-1, -2) * scale).masked_fill(
                ~_pair_rows(layout, key_mask, b, q0, k0, cls), bs.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - m_new), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.bfloat16().float() @ vp[..., keys, :]
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        o[..., rows, :] = acc / l_safe
        lse[..., rows] = (m + torch.log(l_safe))[..., 0]
    return o[..., :n, :].bfloat16(), lse[..., :n]


def emulated_bf16_pair_dq(q, k, v, o, lse, do, layout, key_mask=None):
    """The pair grid's bf16 dq as ``bs_dq_tc_kernel`` runs it (csrc/
    bf16_sweeps.cuh over ``tf32::HalfRow``) on bf16 q, k, v, o, do (b, h,
    n, d), the forward's lse (b, h, n) and a 128-block layout: per 64-row
    query tile, delta of its rows by ``emulated_row_delta`` from the bf16
    o and do (0 at rows past n, which the kernel does not read), then over
    the halves of ``pair_row_halves`` s = q.k^T and dp = do.v^T in float32
    from the bf16 inputs, s scaled and masked by the half's class (2: the
    key mask; 1: the layout's mask tile and the key mask), p = exp(s -
    lse) where s > 0.5 * NEG_INF, ds = p * (dp - delta) * scale rounded to
    bf16 (where the sweep packs it into the A fragments of dS.K), and the
    half's ds.k added to the running float32 sum. Returns (dq in bf16,
    delta (b, h, n) float32)."""
    b, h, n, d = q.shape
    scale = d**-0.5
    qp, kp, vp, op, dop = _padded(layout, q, k, v, o, do)
    lse_p = F.pad(lse.float(), (0, layout.n_pad - n))
    dq = torch.zeros(b, h, layout.n_pad, d)
    delta = torch.zeros(b, h, layout.n_pad)
    for q0 in range(0, n, bs.TILE):
        rows = slice(q0, q0 + bs.TILE)
        delta[..., rows] = emulated_row_delta(op[..., rows, :], dop[..., rows, :])
        for k0, cls in pair_row_halves(layout, q0):
            keys = slice(k0, k0 + bs.HALF)
            s = (qp[..., rows, :] @ kp[..., keys, :].transpose(-1, -2) * scale).masked_fill(
                ~_pair_rows(layout, key_mask, b, q0, k0, cls), bs.NEG_INF)
            p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - lse_p[..., rows, None]), 0.0)
            dp = dop[..., rows, :] @ vp[..., keys, :].transpose(-1, -2)
            ds = (p * (dp - delta[..., rows, None]) * scale).bfloat16().float()
            dq[..., rows, :] += ds @ kp[..., keys, :]
    return dq[..., :n, :].bfloat16(), delta[..., :n]


def emulated_bf16_pair_dkdv(q, k, v, do, lse, delta, layout, key_mask=None):
    """The pair grid's bf16 dk/dv as ``bs_dkdv_tc_kernel`` runs it (the
    key-major sweep of csrc/bf16_sweeps.cuh over ``tf32::HalfColumn``) on
    bf16 q, k, v, do (b, h, n, d), the forward's lse and the dq pass's
    delta (b, h, n) and a 128-block layout: per 64-key tile, over the
    halves of ``pair_column_halves`` (query rows past n zero, their lse
    and delta 0), s^T = k.q^T and dp^T = v.do^T in float32 from the bf16
    inputs, s scaled and masked by the half's class, p = exp(s - lse)
    where s > 0.5 * NEG_INF; p rounded to bf16 for dv += p^T.do and ds = p
    * (dp - delta) * scale (on the unrounded p) rounded to bf16 for dk +=
    ds^T.q, each half's partial added to the running float32 sums.
    Returns (dk, dv) in bf16."""
    b, h, n, d = q.shape
    scale = d**-0.5
    qp, kp, vp, dop = _padded(layout, q, k, v, do)
    lse_p, delta_p = (F.pad(t.float(), (0, layout.n_pad - n)) for t in (lse, delta))
    dk = torch.zeros(b, h, layout.n_pad, d)
    dv = torch.zeros_like(dk)
    for k0 in range(0, n, bs.TILE):
        kt = slice(k0, k0 + bs.TILE)
        for q0, cls in pair_column_halves(layout, k0):
            rows = slice(q0, q0 + bs.HALF)
            s = (kp[..., kt, :] @ qp[..., rows, :].transpose(-1, -2) * scale).masked_fill(
                ~_pair_rows(layout, key_mask, b, q0, k0, cls, bs.HALF, bs.TILE).transpose(-1, -2),
                bs.NEG_INF)
            p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - lse_p[..., None, rows]), 0.0)
            dp = vp[..., kt, :] @ dop[..., rows, :].transpose(-1, -2)
            ds = p * (dp - delta_p[..., None, rows]) * scale
            dv[..., kt, :] += p.bfloat16().float() @ dop[..., rows, :]
            dk[..., kt, :] += ds.bfloat16().float() @ qp[..., rows, :]
    return dk[..., :n, :].bfloat16(), dv[..., :n, :].bfloat16()


def emulated_split_decode(qkv, k_cache, v_cache, idx: int, cos, sin, key_mask, heads: int,
                          splits: int):
    """The fused decode kernel's split in plain PyTorch, float32, same
    arguments and results as ``reference_fused_decode``: the cache rows
    [0, idx) cut into ``decode_attention.decode_slices(idx, splits)``,
    each slice's partial softmax (m, l, acc) over its live keys (an empty
    or wholly masked slice: l = 0, weight 0), then the partials merged in
    rank order with the fresh token: M = the max of the live fresh score
    and every m with l > 0, out = (p_new v + sum_r w_r acc_r) / (p_new +
    sum_r w_r l_r), w_r = exp(m_r - M) (0 where l_r = 0), a denominator
    of 0 taken as 1."""
    b, _, width = qkv.shape
    h = heads
    d = width // (3 * h)
    L = k_cache.shape[1]
    q, k, v = qkv.float().reshape(b, 3, h, d).unbind(1)
    if cos is not None:
        c, sn = cos[idx].float(), sin[idx].float()
        q, k, v = (t * c + rotate_half(t) * sn for t in (q, k, v))
    k_row, v_row = k.to(k_cache.dtype), v.to(v_cache.dtype)
    qs = q * d**-0.5
    keys = k_cache.reshape(b, L, h, d).float()
    values = v_cache.reshape(b, L, h, d).float()
    live = (torch.ones((b, L), dtype=torch.bool) if key_mask is None
            else key_mask.cpu() > 0).to(qkv.device)
    minus_inf = torch.tensor(float("-inf"))
    parts = []
    for lo, hi in da.decode_slices(idx, splits):
        s = torch.einsum("bhd,blhd->bhl", qs, keys[:, lo:hi])
        ok = live[:, None, lo:hi].expand_as(s)
        s = s.masked_fill(~ok, float("-inf"))
        m = s.amax(-1, keepdim=True) if hi > lo else torch.full((b, h, 1), float("-inf"))
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(ok, torch.exp(s - m_safe), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhl,blhd->bhd", p, values[:, lo:hi])))
    s_new = (k_row.float() * qs).sum(-1, keepdim=True)
    new_live = live[:, idx, None, None].expand_as(s_new)
    M = torch.where(new_live, s_new, minus_inf)
    for m, l, _ in parts:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    p_new = torch.where(new_live, torch.exp(s_new - torch.where(new_live, M, 0.0)), 0.0)
    num, den = p_new * v_row.float(), p_new
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - torch.where(l > 0, M, 0.0)), 0.0)
        num, den = num + w * acc, den + w * l
    out = (num / torch.where(den == 0, 1.0, den)).to(qkv.dtype)
    return tuple(t.reshape(b, 1, h * d) for t in (out, k_row, v_row))


def teacher_forced_logits(dalle, cache, text, image, chunk: int) -> torch.Tensor:
    """``DALLE.fused_step`` driven teacher-forced through ``cache``: the
    remapped prompt of ``text`` (b, text_seq_len) in chunks of ``chunk``
    columns, then one decode step per column of ``image`` (b, m) at the
    positions after it. Returns (b, 1 + m, num_image_tokens) float32: the
    image logits after the prompt, then after each image token."""
    dev = dalle.device
    prompt = dalle.remap_text(text.to(dev)).to(torch.int32)
    image = image.to(dev, torch.int32)
    b, T = prompt.shape
    final = torch.zeros(b, dtype=torch.bool, device=dev)

    def step(tokens, start, length):
        full = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)  # noqa: E731
        return dalle.fused_step(F.pad(tokens, (0, chunk - tokens.shape[1])), full(start),
                                full(length), final, cache)

    for s in range(0, T, chunk):
        logits = step(prompt[:, s:s + chunk], s, min(chunk, T - s))
    out = [logits]
    for j in range(image.shape[1]):
        out.append(step(image[:, j:j + 1], T + j, 1))
    return torch.stack(out, 1)


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over every entry, in float32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).norm() / ref.norm()).item()


def gap_ratio(got, bf16, f32) -> float:
    """How far a bfloat16 run's ``got`` lies from the reference's bfloat16
    run ``bf16``, in units of that run's gap to the reference's float32
    run ``f32``: ``rel_l2(got, bf16) / rel_l2(bf16, f32)`` (tensors or
    Python floats)."""
    got, bf16, f32 = (torch.as_tensor(t) for t in (got, bf16, f32))
    return rel_l2(got, bf16) / rel_l2(bf16, f32)


# (batch, width, heads, dim_head, page, pages per row, start, length) of
# ``ragged_inputs``' cases
_RAGGED_CASES = {
    # the flagship serving iteration: decode rows at scattered positions
    # and on both sides of a page boundary, a row at the sequence's end,
    # full-width prefill chunks (one crossing a page boundary) and an idle
    # row at start 0, as the engine issues it
    "serve": (8, 16, 16, None, 128, 11,
              (300, 639, 640, 1279, 0, 120, 256, 0), (1, 1, 1, 1, 16, 16, 1, 0)),
    # decode rows on and past a page boundary, a full-width chunk across
    # one, a short chunk, a row near the end, an idle row
    "small": (6, 8, 2, None, 128, 4, (127, 128, 124, 250, 509, 3), (1, 1, 8, 3, 1, 0)),
    # a whole prompt in one block (generation's prefill on the paged
    # format): 257 columns, five query tiles of the kernel, one row from
    # position 20 and an idle row
    "prefill": (3, 257, 4, None, 128, 3, (0, 20, 0), (257, 200, 0)),
    # the same at generation's paged shape (batch 4, 16 heads, the
    # flagship's 11 pages): a whole prompt, a short one (tiles past its
    # valid columns write zeros), one from position 1000 (its tiles'
    # frontiers deep in the row's pages) and an idle row
    "prompt": (4, 257, 16, None, 128, 11, (0, 0, 1000, 0), (257, 100, 257, 0)),
}


def ragged_inputs(case: str, dtype, device, int8: bool = False, dim_head: int = 64,
                  permuted: bool = True, seed: int = 0):
    """(q, k, v, k_scales, v_scales, table, start, length) of the ragged
    kernel, made with numpy from ``seed``: q and the K/V rows standard
    normal x 0.3, q in ``dtype``; pools flat (rows * n_pages + 1, page,
    h*d) in ``dtype``, or with ``int8`` quantized by
    ``paged_kv.quantize_rows`` beside their float32 scale pools (else the
    scales are None). ``permuted``: every page moved to a random slot of
    the storage and the table permuted with it, so rows stream pages (and
    scales) from other rows' storage; else the identity table. ``case``:
    "serve" (the flagship: 8 rows of 16 columns, 16 heads of ``dim_head``,
    pages of 128, 11 per row), "small" (6 rows of 8, 2 heads of
    ``dim_head``, 4 pages), "prefill" (3 rows of 257, 4 heads, 3
    pages) or "prompt" (4 rows of 257, 16 heads, 11 pages)."""
    b, n, h, d, page, n_p, start, length = _RAGGED_CASES[case]
    return ragged_block(b, n, h, d or dim_head, page, n_p, start, length, dtype, device,
                        int8=int8, permuted=permuted, seed=seed)


def ragged_block(b: int, n: int, h: int, d: int, page: int, n_p: int, start, length, dtype,
                 device, int8: bool = False, permuted: bool = True, seed: int = 0):
    """``ragged_inputs`` of any shape: ``b`` rows of ``n`` columns, ``h``
    heads of ``d``, ``n_p`` pages of ``page`` positions a row, the
    descriptors ``start`` and ``length`` (sequences of ``b`` ints)."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32) * 0.3).to(device, dtype)
    perm = rng.permutation(b * n_p) if permuted else np.arange(b * n_p)

    def flat(t):
        out = paged_kv.alloc(b, n_p, page, t.shape[-1], t.dtype, "cpu")
        out[perm] = t.reshape(b * n_p, page, -1)
        return out.to(device)

    kv, scales = [], []
    for _ in range(2):
        rows = torch.from_numpy(rng.randn(1, b * n_p * page, h * d).astype(np.float32) * 0.3)
        if int8:
            rows, sc = paged_kv.quantize_rows(rows, h)
            scales.append(flat(sc))
        else:
            scales.append(None)
        kv.append(flat(rows.to(torch.int8 if int8 else dtype)))
    ident = paged_kv.identity_table(b, n_p, "cpu")
    table = torch.from_numpy(perm).to(torch.int32)[ident.long()].to(device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=device)  # noqa: E731
    return (q, *kv, *scales, table, i32(start), i32(length))


def ragged_errors(got, plain, length):
    """(max abs error, max column-relative L2 error over h*d) of the
    ragged kernel against its plain version on valid columns."""
    valid = torch.arange(got.shape[1], device=got.device)[None] < length[:, None]
    diff = (got.float() - plain.float())[valid].flatten(1)
    ref = plain.float()[valid].flatten(1).norm(dim=1)
    return diff.abs().max().item(), (diff.norm(dim=1) / ref).max().item()


def ragged_ok(dtype, err: float, rel: float) -> bool:
    return err <= RAGGED_F32_ATOL if dtype == torch.float32 else rel <= RAGGED_BF16_RTOL


def decode_inputs(b: int, L: int, h: int, d: int, idx: int, dtype, device,
                  rotary: bool = True, masked: bool = False, own_masked: bool = False,
                  seed: int = 0):
    """(qkv, k_cache, v_cache, cos, sin, key_mask) of the fused decode
    kernel, made with numpy from ``seed``: qkv (b, 1, 3*h*d) standard
    normal, the caches (b, L, h*d) standard normal x 0.5, all in
    ``dtype``; with ``rotary`` cos/sin from ``rot_tables`` of the DALL-E
    angle table of an L-position sequence (a 32 x 32 grid when L > 1024,
    else 4 x 4), else None. ``masked``: an int32 (b, L) key mask dropping
    a third of the keys (key 0 kept), and at b > 1 every key of the last
    row (its output must be 0). ``own_masked``: q and k of the fresh
    token aligned and large (a self-score far above every other), and the
    fresh key masked out."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, 1, 3 * h * d).astype(np.float32)
    if own_masked:
        qkv[..., :2 * h * d] = 30.0
    kc, vc = (rng.randn(b, L, h * d).astype(np.float32) * 0.5 for _ in range(2))
    qkv, kc, vc = (torch.from_numpy(a).to(device, dtype) for a in (qkv, kc, vc))
    cos = sin = key_mask = None
    if rotary:
        f = 32 if L > 1024 else 4
        table = torch.from_numpy(dalle_rotary_table(d, L - f * f, f)).to(device)
        cos, sin = rot_tables(table, L - 1, d, dtype)
    if masked or own_masked:
        km = np.ones((b, L), np.int32)
        if masked:
            km = (rng.rand(b, L) > 1 / 3).astype(np.int32)
            km[:, 0] = 1
            if b > 1:
                km[-1] = 0
        if own_masked:
            km[:, idx] = 0
        key_mask = torch.from_numpy(km).to(device)
    return qkv, kc, vc, cos, sin, key_mask


def decode_errors(got, plain, key_mask=None, idx: int = 0):
    """(max abs error of out, worst row-relative error of out over rows
    with a live key, k/v rows bitwise equal, rows with no live key exactly
    0) of the fused decode kernel's (out, k_row, v_row) against its plain
    version's."""
    out, k_row, v_row = (t.float().cpu() for t in got)
    p_out, p_k, p_v = (t.float().cpu() for t in plain)
    b = out.shape[0]
    live = torch.ones(b, dtype=torch.bool)
    if key_mask is not None:
        live = (key_mask[:, :idx + 1] > 0).any(dim=1).cpu()
    diff = (out - p_out).flatten(1)
    rel = max((diff[live].norm(dim=1) / p_out.flatten(1)[live].norm(dim=1)).tolist(),
              default=0.0)
    rows_equal = torch.equal(k_row, p_k) and torch.equal(v_row, p_v)
    return diff.abs().max().item(), rel, rows_equal, bool((out[~live] == 0).all())


def decode_ok(dtype, err: float, rel: float, rows_equal: bool, dead_zero: bool) -> bool:
    tol_ok = err <= DECODE_F32_ATOL if dtype == torch.float32 else rel <= DECODE_BF16_ROW_REL
    return tol_ok and rows_equal and dead_zero


# the trainer command line's folders: seeded square PNGs, one caption each
CAPTION_WORDS = ("a", "red", "green", "blue", "small", "large", "square", "circle", "on",
                 "the", "left", "right", "of", "two", "striped", "cat's", "café", "3")


def write_caption_folder(root, n: int, size: int, seed: int = 0, prefix: str = "sample",
                         lines: int = 1):
    """``n`` seeded RGB PNGs of ``size`` x ``size`` (the port's PNG
    writer: no Pillow) under ``root``, each with a same-stem ``.txt`` of
    ``lines`` seeded captions, one a line; returns the first caption of
    each."""
    from pathlib import Path

    from .data.image_io import write_png

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    captions = []
    for i in range(n):
        write_png(root / f"{prefix}_{i:03d}.png",
                  rng.randint(0, 256, size=(size, size, 3)).astype(np.uint8))
        text = [" ".join(rng.choice(CAPTION_WORDS, size=rng.randint(3, 9)))
                for _ in range(lines)]
        captions.append(text[0])
        (root / f"{prefix}_{i:03d}.txt").write_text("\n".join(text) + "\n", encoding="utf8")
    return captions


def write_tar_shards(root, shards: int, per_shard: int, size: int, seed: int = 0,
                     corrupt=(), prefix: str = "shard", image_ext=None, caption_ext="txt"):
    """``shards`` tar files ``<prefix>-0000.tar``... under ``root``, each
    of ``per_shard`` samples: a seeded RGB image of ``size`` x ``size``
    (even samples PNG by the port's writer, odd ones JPEG by Pillow;
    members ``.png`` / ``.jpg``, or all ``.<image_ext>``) and a
    ``.<caption_ext>`` of one seeded caption. The image of each global
    sample index in ``corrupt`` is a JPEG cut after its first quarter (its
    header reads, its pixels do not). Returns (shard spec
    ``<prefix>-{0000..N}.tar``, captions)."""
    import io
    import tarfile
    from pathlib import Path

    from PIL import Image

    from .data.image_io import png_bytes

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    captions = []
    for s in range(shards):
        with tarfile.open(root / f"{prefix}-{s:04d}.tar", "w") as tf:
            for j in range(per_shard):
                k = s * per_shard + j
                pixels = rng.randint(0, 256, size=(size, size, 3)).astype(np.uint8)
                if k % 2 == 0 and k not in corrupt:
                    name, data = "png", png_bytes(pixels)
                else:
                    buf = io.BytesIO()
                    Image.fromarray(pixels).save(buf, format="JPEG", quality=90)
                    name, data = "jpg", buf.getvalue()
                    if k in corrupt:
                        data = data[:len(data) // 4]
                captions.append(" ".join(rng.choice(CAPTION_WORDS, size=rng.randint(3, 9))))
                for ext, body in ((image_ext or name, data),
                                  (caption_ext, captions[-1].encode("utf8"))):
                    info = tarfile.TarInfo(f"sample{k:05d}.{ext}")
                    info.size = len(body)
                    tf.addfile(info, io.BytesIO(body))
    return str(root / f"{prefix}-{{0000..{shards - 1:04d}}}.tar"), captions


def train_tokenizer_json(path, captions, vocab_size: int = 300) -> None:
    """A byte-level BPE tokenizer JSON trained by HuggingFace
    ``tokenizers`` on ``captions``, written to ``path``."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=["<pad>", "<eos>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(list(captions), trainer)
    tok.save(str(path))


@contextlib.contextmanager
def dropout_masks(replay=None):
    """Every dropout keep mask the port draws inside the block, appended in
    draw order to the list the block gets (attention, then feed-forward,
    layer by layer: JAX's module order). With ``replay`` (masks in that
    order, bool arrays or tensors) each draw takes the next of them
    instead (the seam that feeds JAX's masks to the port)."""
    from .ops import layers

    drawn = []
    pending = None if replay is None else list(replay)
    draw = layers.keep_mask

    def keep(generator, shape, keep_prob, device):
        if pending is None:
            mask = draw(generator, shape, keep_prob, device)
        else:
            mask = torch.as_tensor(np.asarray(pending.pop(0)), dtype=torch.bool).to(device)
            if tuple(mask.shape) != tuple(shape):
                raise ValueError(f"replayed mask {tuple(mask.shape)} for a draw of {shape}")
        drawn.append(mask)
        return mask

    layers.keep_mask = keep
    try:
        yield drawn
    finally:
        layers.keep_mask = draw


def reset_registries() -> None:
    """The port's process-wide counters, gauges and histograms emptied
    and ``TELEMETRY`` back to disabled (a test's engines then start from
    zero; JAX's registries are reset by ``tests/conftest.py``)."""
    from .utils.metrics import counters, gauges, histograms
    from .utils.telemetry import TELEMETRY

    counters.reset()
    gauges.reset()
    histograms.reset()
    TELEMETRY.reset()
