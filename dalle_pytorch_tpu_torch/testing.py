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

The block-sparse kernels (forward, dq, dk/dv) are held the same way:
float32 o and lse within abs ``BS_F32_ATOL`` and each gradient part within
``BWD_F32_REL``; bfloat16 each query row's o error within
``BS_BF16_ROW_REL`` of the plain row and lse within ``BS_BF16_ROW_REL``
absolute, the gradients by the floored row metric above. A row is one
position's h*d values; rows that the layout and the key mask leave with
no allowed key (query rows for o and dq, key rows for dk and dv) must be
exactly 0, with lse -1e30.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import block_sparse_attention as bs
from .ops import flash_attention as fa
from .ops import masks
from .ops.rotary import dalle_rotary_table, rot_tables

BWD_F32_REL, BWD_BF16_ROW_REL = 1e-5, 2e-2
BS_F32_ATOL, BS_BF16_ROW_REL = 1e-5, 1e-2


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


def bs_fwd_errors(o, lse, plain_o, plain_lse, layout, key_mask=None):
    """(max abs error over live rows of o and lse, worst row-relative L2
    error of o over live rows, lse abs error, dead rows exactly 0 with
    lse -1e30) of the block-sparse forward against its plain version."""
    b, h, n, _ = o.shape
    live = bs.may_attend(layout, n, o.device, key_mask)[:, 0].any(dim=2).expand(b, n)
    g, p = _rows(o.float()), _rows(plain_o.float())
    diff = (g - p)[live]
    lse_err = (lse - plain_lse).transpose(1, 2)[live].abs().max().item()
    rel = (diff.norm(dim=-1) / p[live].norm(dim=-1)).max().item()
    dead_exact = bool((g[~live] == 0).all()) and bool(
        (lse.transpose(1, 2)[~live] == bs.NEG_INF).all())
    return max(diff.abs().max().item(), lse_err), rel, lse_err, dead_exact


def bs_bwd_errors(got, plain, layout, key_mask=None):
    """``_part_errors`` of the block-sparse gradients (dq, dk, dv), each
    (b, h, n, d), against the plain ones."""
    b, h, n, _ = got[0].shape
    allowed = bs.may_attend(layout, n, got[0].device, key_mask)[:, 0].expand(b, n, n)
    dead = (~allowed.any(dim=2), ~allowed.any(dim=1), ~allowed.any(dim=1))
    return _part_errors([_rows(t) for t in got], [_rows(t) for t in plain], dead)


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
