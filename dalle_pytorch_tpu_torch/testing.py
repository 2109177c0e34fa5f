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
tolerances and that one TF32 pass does not.

The fused decode kernel is held on ``decode_inputs`` by ``decode_errors``:
float32 out within abs ``DECODE_F32_ATOL``, bfloat16 each batch row's out
within ``DECODE_BF16_ROW_REL`` of the plain row, the returned k/v rows
bitwise, and a row with no live key exactly 0. Generation through it
against the unfused chain is a different rounding of the same function:
teacher-forced logits within ``DECODE_LOGITS_REL``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops import block_sparse_attention as bs
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
    (one flash block the packed kernel refuses), causal. Small shapes, b 2
    and 2 heads at n 384 (one flash block): "pattern" (the axial-row
    pattern of 129 + 16 x 16), "noncausal", and "d32" / "d64" / "d96" /
    "d128", causal with a key mask that drops a fifth of row 0's keys and
    key 0 (text row 0 then attends nothing) and every key of row 1 (all
    its rows dead); "tiled" is "d64" at n 1152 (3 x 3 flash blocks)."""
    rng = np.random.RandomState(seed)
    opts = dict(key_mask=None, causal=True, pattern=None)
    if case in ("train", "axial_col"):
        b, h, n, d = (4 if case == "train" else 2), 16, 4352, 64
        if case == "axial_col":
            opts["pattern"] = torch.from_numpy(
                masks.pattern_mask("axial_col", 257, 64)[:n, :n]).to(device)
    elif case == "one_block":
        b, h, n, d = 2, 3, 1280, 64
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
