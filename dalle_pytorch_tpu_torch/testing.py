"""How the packed-qkv backward kernel is held against its plain version:
the tolerances, the error metric and the test inputs, shared by
``chip_smoke.py`` and the tests.

dqkv is compared per part (dq, dk, dv). float32: the relative L2 error of
the whole part within ``BWD_F32_REL``. bfloat16: each row's (h*d) error
norm within ``BWD_BF16_ROW_REL`` of the plain row's norm, floored at 1e-3
of the part's median row (ds and p are rounded to bf16 before two
products, so one bf16 ulp of a lone term is 0.4-0.8% of a row; a row whose
exact gradient is 0 holds only rounding noise). Rows the masks force to 0
must be exactly 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import flash_attention as fa
from .ops import masks
from .ops.rotary import dalle_rotary_table, rot_tables

BWD_F32_REL, BWD_BF16_ROW_REL = 1e-5, 2e-2


def bwd_errors(got, plain, h, d, opts):
    """(relative L2 error of the worst part, worst floored row-relative
    error, masked rows exactly 0) of dqkv ``got`` against ``plain``."""
    b, n, _ = got.shape
    allowed = fa.may_attend(n, got.device, opts.get("key_mask"), opts.get("causal", True),
                            opts.get("pattern_mask"))[:, 0].expand(b, n, n)
    dead = (~allowed.any(dim=2), ~allowed.any(dim=1), ~allowed.any(dim=1))
    rel, row_rel, zeros_exact = [], [], True
    for g, p, z in zip(got.float().split(h * d, -1), plain.float().split(h * d, -1), dead):
        rel.append(((g - p).norm() / p.norm()).item())
        rn = p.norm(dim=-1)
        floor = 1e-3 * rn[~z].median()
        row_rel.append(((g - p).norm(dim=-1)[~z] / rn[~z].clamp(min=floor)).max().item())
        zeros_exact &= bool((g[z] == 0).all())
    return max(rel), max(row_rel), zeros_exact


def bwd_inputs(case: str, dtype, device, seed: int = 0):
    """(qkv, o, lse, do, heads, dim_head, options) of the packed-qkv
    backward, o and lse from the plain forward. "train": the flagship
    training shape (b 4, n 1280, 16 heads of 64, causal, DALL-E rotary);
    "clip": CLIP's text shape (b 8, n 256, 8 heads of 64, non-causal, a key
    mask whose row 6 masks every key); "pattern": DALL-E's shape at b 2
    with the axial-row pattern mask; "d32"/"d64"/"d128": n 200 (a ragged
    last tile), 2 batch rows of 4 heads, causal with the rotary table."""
    rng = np.random.RandomState(seed)
    if case == "clip":
        b, n, h, d = 8, 256, 8, 64
        lengths = torch.tensor((256, 200, 131, 64, 17, 1, 0, 240))
        opts = dict(key_mask=(torch.arange(n)[None] < lengths[:, None]).to(device),
                    causal=False)
    else:
        b, n, h, d = {"train": (4, 1280, 16, 64), "pattern": (2, 1280, 16, 64),
                      "d32": (2, 200, 4, 32), "d64": (2, 200, 4, 64),
                      "d128": (2, 200, 4, 128)}[case]
        text_len = 257 if n == 1280 else n - 15
        fmap = 32 if n == 1280 else 4
        table = torch.from_numpy(dalle_rotary_table(d, text_len, fmap)).to(device)
        opts = dict(causal=True, rot=rot_tables(table, n, d, dtype))
        if case == "pattern":
            pattern = masks.axial_mask(text_len, fmap, 0)[:n, :n]
            opts["pattern_mask"] = torch.from_numpy(pattern).to(device)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32)).to(device, dtype)
    do = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32)).to(device, dtype)
    o, lse = fa.reference_fused_qkv(qkv, h, d, **opts)
    return qkv, o, lse, do, h, d, opts
