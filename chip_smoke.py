#!/usr/bin/env python3
"""Drive the PyTorch port (dalle_pytorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises on failure (exit code non-zero, no result
line):

1. device: a CUDA card is required; its name and power limit are printed.
   Float32 matrix products and convolutions run without TF32.
2. build: every CUDA kernel of the port is compiled with nvcc (sm_90a),
   one nvcc per source, all started together.
3. kernels: each kernel's wrapper at the serving path's shapes against its
   plain PyTorch version (float32 and bfloat16, stated tolerances), all
   outputs finite; times with CUDA events (L2 flushed before each call)
   beside the plain version, one library call as a yardstick, and the
   bound from bytes and operations. The packed-qkv kernel is held at
   CLIP's text shape (the rerank stage's), at DALL-E's causal rotary
   shape, with and without a pattern mask, and at the training shape
   (batch 4).
4. path check: a small float32 DALLE, and a small float32 CLIP whose text
   length takes the packed-qkv kernel, each with the same weights on the
   card (kernels) and on the CPU (plain versions); logits and
   similarities agree.
5. engine: the flagship DALLE (depth 12, dim 1024, 16 heads of 64, 256
   text + 32x32 image tokens, bf16, seeded random weights) served by the
   fused engine (max_batch 8, prefill chunk 16) with post-decode stages:
   the flagship DiscreteVAE, then CLIP at the reference's widths (text
   and visual depth 6, dim 512, 8 heads of 64, 256 text tokens, 256-pixel
   images in 32-pixel patches), stage batch 8. 10 requests of 1024 image
   tokens each. Every outcome COMPLETED with 1024 tokens in range, a
   finite (256, 256, 3) image and a finite rerank score; the ragged kernel
   launched depth x dispatched iterations times and the packed-qkv kernel
   text depth x rerank dispatches times.
6. pixels: the results' images, denormalized, lie in [0, 1]; their order
   by rerank score is printed.
7. profile: torch.profiler over 30 iterations of a fresh mixed batch:
   wall and device-busy time per iteration, launches per iteration, the
   largest device-time kernels (after the counted run).
8. train: the flagship DALLE in float32 (train_dalle.py's defaults: batch
   4, lr 3e-4, clip_grad_norm 0.5, loss_img_weight 7) trained by
   ``DalleTrainer`` for 10 steps on one batch: 4 seeded 256x256 images
   encoded to 32x32 tokens by the flagship VAE, seeded captions with zero
   tails. Every loss finite, the last below the first, the packed-qkv
   forward and backward kernels launched depth x (steps + retries) times
   each. Then one step with the NaN injected: every parameter and Adam
   moment bit-identical, skipped 1. Step wall time, training tokens/s and
   peak memory are printed.
9. train profile: torch.profiler over 3 more steps: device-busy share,
   launches per step, the largest device-time kernels.

Phase 3 also holds the packed-qkv backward kernel against its plain
version (float32 and bfloat16) at the flagship training shape, CLIP's
text shape and DALL-E's shape with a pattern mask, and phase 4 a small
float32 DALLE's loss and every parameter gradient, card against CPU.

The second-to-last line is the card's ``nvidia-smi`` name and power
limit; the line before it the kernels' JSON; the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# and float32 (non-tensor) operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_FLUSH_BYTES = 256 << 20  # well past the 50 MB L2

FLAGSHIP = dict(dim=1024, depth=12, heads=16, dim_head=64,
                num_text_tokens=10000, text_seq_len=256,
                num_image_tokens=8192, image_fmap_size=32)
FLAGSHIP_VAE = dict(image_size=256, num_tokens=8192, codebook_dim=512,
                    num_layers=3, num_resnet_blocks=2, hidden_dim=256)
# train_clip.py's defaults; the SimpleTokenizer vocabulary
FLAGSHIP_CLIP = dict(dim_text=512, dim_image=512, dim_latent=512,
                     num_text_tokens=49408, text_enc_depth=6, text_seq_len=256,
                     text_heads=8, text_dim_head=64, visual_enc_depth=6,
                     visual_heads=8, visual_dim_head=64, visual_image_size=256,
                     visual_patch_size=32)
MAX_BATCH, CHUNK, PAGE = 8, 16, 128
N_REQUESTS, MAX_NEW = 10, 1024
STAGE_BATCH = 8
# kernel vs plain on valid columns: float32 max abs error; bfloat16 the
# error's L2 norm over a query column's h*d outputs relative to the plain
# column's norm (two bf16 roundings of the output are ~0.4%; a page missed
# or attended twice moves a column by 10% or more)
F32_ATOL, BF16_RTOL = 1e-5, 1e-2
# the packed-qkv backward's tolerances and metric are
# dalle_pytorch_tpu_torch.testing's (BWD_F32_REL, BWD_BF16_ROW_REL)
RAGGED_TPU_KERNEL = "dalle_pytorch_tpu/ops/ragged_attention.py:116"
FUSED_TPU_KERNEL = "dalle_pytorch_tpu/ops/flash_attention.py:784"
FUSED_BWD_TPU_KERNEL = "dalle_pytorch_tpu/ops/flash_attention.py:813"
TRAIN_BATCH, TRAIN_STEPS = 4, 10
# the rerank stage's text key mask: valid prompt lengths of the 8 rows
# (one fully masked row: its output must be exactly 0, its lse -1e30)
CLIP_TEXT_LENGTHS = (256, 200, 131, 64, 17, 1, 0, 240)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup: int = 3, iters: int = 50, cold: bool = True) -> float:
    """Mean device ms of ``fn`` after warm-up. ``cold``: a buffer larger
    than the card's 50 MB L2 is overwritten before each call and each call
    is timed alone, so its inputs come from HBM, as in the engine, where
    every layer has K/V pools of its own. Otherwise one event pair spans
    back-to-back calls."""
    for _ in range(warmup):
        fn()
    event = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    if not cold:
        begin, end = event(), event()
        begin.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return begin.elapsed_time(end) / iters
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(iters):
        flush.zero_()
        begin, end = event(), event()
        begin.record()
        fn()
        end.record()
        pairs.append((begin, end))
    torch.cuda.synchronize()
    return sum(b.elapsed_time(e) for b, e in pairs) / iters


# ------------------------------------------------------------- kernels


def ragged_inputs(dtype, permuted: bool, seed: int = 0):
    """Ragged attention inputs at the flagship serving shapes: B=8 rows of
    W=16 query columns, 16 heads of 64, pages of 128, 11 pages per row
    (1281 positions). Descriptors: decode rows at scattered positions and
    on both sides of a page boundary, full-width prefill chunks (one
    crossing a page boundary), a prompt's final 1-token chunk, and an idle
    row at start 0, as the engine issues it. ``permuted`` scatters every
    page across all rows' storage."""
    from dalle_pytorch_tpu_torch.ops import paged_kv

    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    n_p = paged_kv.num_pages(FLAGSHIP["text_seq_len"] + 1 + 1024, PAGE)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = (torch.randn(MAX_BATCH, CHUNK, h, d, generator=g, device=dev) * 0.3).to(dtype)
    k = paged_kv.alloc(MAX_BATCH, n_p, PAGE, h * d, dtype, dev)
    v = paged_kv.alloc(MAX_BATCH, n_p, PAGE, h * d, dtype, dev)
    k[:-1] = (torch.randn(k[:-1].shape, generator=g, device=dev) * 0.3).to(dtype)
    v[:-1] = (torch.randn(v[:-1].shape, generator=g, device=dev) * 0.3).to(dtype)
    table = paged_kv.identity_table(MAX_BATCH, n_p, dev)
    if permuted:
        perm = torch.randperm(MAX_BATCH * n_p, generator=g, device=dev)
        k[perm], v[perm] = k[:-1].clone(), v[:-1].clone()
        table = perm[table.long()].to(torch.int32)
    start = torch.tensor([300, 639, 640, 1279, 0, 112, 256, 0],
                         dtype=torch.int32, device=dev)
    length = torch.tensor([1, 1, 1, 1, 16, 16, 1, 0],
                          dtype=torch.int32, device=dev)
    return q, k, v, table, start, length


def ragged_bound(q, start, length, dtype):
    """(bound_ms, bound_by) of the work the caller keeps: bytes = K and V
    at positions 0 .. start + length - 1 of each active row once, q and
    the output of valid columns once, the table entries of those pages and
    the descriptors (an idle row's output is discarded, so it needs
    nothing); operations = 2 * 2 * h*d per (valid query, visible key)
    pair."""
    b, n, h, d = q.shape
    item = q.element_size()
    s, ln = start.cpu().numpy(), length.cpu().numpy()
    active = ln > 0
    frontier = (s + ln)[active]  # positions 0 .. start + length - 1
    nbytes = int(frontier.sum()) * h * d * 2 * item + 2 * int(ln.sum()) * h * d * item
    nbytes += 4 * (int((-(-frontier // PAGE)).sum()) + 2 * b)
    keys = sum(int(s[r]) + i + 1 for r in range(b) for i in range(int(ln[r])))
    ops = 4 * keys * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_ragged_attention() -> dict:
    from dalle_pytorch_tpu_torch.ops import paged_kv
    from dalle_pytorch_tpu_torch.ops import ragged_attention as ra

    errs, rel_errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for permuted in (False, True):
            q, k, v, table, start, length = ragged_inputs(dtype, permuted)
            got = ra.kernel_attend(q, k, v, table, start, length)
            plain = ra.reference_attend(q, k, v, table, start)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"ragged kernel: non-finite output ({dtype})")
            valid = (torch.arange(CHUNK, device="cuda")[None] < length[:, None])
            diff = (got.float() - plain.float())[valid].flatten(1)
            err = diff.abs().max().item()
            rel = (diff.norm(dim=1) / plain.float()[valid].flatten(1).norm(dim=1)).max().item()
            ok = err <= F32_ATOL if dtype == torch.float32 else rel <= BF16_RTOL
            log(f"ragged_attention {dtype} permuted={permuted}: on valid columns "
                f"max |kernel - plain| = {err:.3e}, max column-relative L2 error "
                f"= {rel:.3e} (tolerance: " + (f"abs {F32_ATOL:.0e})" if dtype == torch.float32
                                               else f"column-relative {BF16_RTOL:.0e})"))
            if not ok:
                raise AssertionError(f"ragged kernel disagrees with plain: {err}, {rel}")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            rel_errs[dtype] = max(rel_errs.get(dtype, 0.0), rel)

    dtype = torch.bfloat16  # the serving path's type
    q, k, v, table, start, length = ragged_inputs(dtype, permuted=False)
    kernel_ms = cuda_time_ms(lambda: ra.kernel_attend(q, k, v, table, start, length))
    warm_ms = cuda_time_ms(lambda: ra.kernel_attend(q, k, v, table, start, length),
                           cold=False)
    plain_ms = cuda_time_ms(lambda: ra.reference_attend(q, k, v, table, start))
    # yardstick: one library call over the already gathered view, same mask
    b, n, h, d = q.shape
    kc = paged_kv.gather(k, table).view(b, -1, h, d).transpose(1, 2)
    vc = paged_kv.gather(v, table).view(b, -1, h, d).transpose(1, 2)
    qt = q.transpose(1, 2)
    pos = start.long()[:, None] + torch.arange(n, device="cuda")
    mask = (torch.arange(kc.shape[2], device="cuda")[None, None] <= pos[..., None])[:, None]
    library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=mask, scale=1.0))
    bound_ms, bound_by = ragged_bound(q, start, length, dtype)
    log(f"ragged_attention bf16 timing, cold L2: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); kernel back to back (warm L2) {warm_ms:.4f} ms")
    return {
        "name": "ragged_attention", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/ragged_attention.cu",
        "replaces": RAGGED_TPU_KERNEL, "max_abs_err": errs[torch.bfloat16],
        "max_rel_err": rel_errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32],
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def fused_inputs(case: str, dtype, seed: int = 0):
    """(qkv, heads, dim_head, options) of the packed-qkv kernel. "clip":
    the rerank stage's text encoder, b = 8, n = 256, 8 heads of 64,
    non-causal, the key mask of CLIP_TEXT_LENGTHS. "dalle": b = 2,
    n = 1280, 16 heads of 64, causal with the DALL-E rotary table;
    "dalle_pattern" adds the static axial-row pattern mask; "train" is
    "dalle" at the training batch of 4."""
    from dalle_pytorch_tpu_torch.ops import masks
    from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables

    g = torch.Generator(device="cuda").manual_seed(seed)
    if case == "clip":
        b, n, h, d = STAGE_BATCH, FLAGSHIP_CLIP["text_seq_len"], 8, 64
        lengths = torch.tensor(CLIP_TEXT_LENGTHS, device="cuda")
        opts = dict(key_mask=torch.arange(n, device="cuda")[None] < lengths[:, None],
                    causal=False)
    else:
        b = TRAIN_BATCH if case == "train" else 2
        n, h, d = 1280, FLAGSHIP["heads"], FLAGSHIP["dim_head"]
        text_len = FLAGSHIP["text_seq_len"] + 1
        table = dalle_rotary_table(d, text_len, FLAGSHIP["image_fmap_size"])
        opts = dict(causal=True, rot=rot_tables(torch.from_numpy(table).cuda(), n, d, dtype))
        if case == "dalle_pattern":
            pattern = masks.axial_mask(text_len, FLAGSHIP["image_fmap_size"], 0)[:n, :n]
            opts["pattern_mask"] = torch.from_numpy(pattern).cuda()
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device="cuda").to(dtype)
    return qkv, h, d, opts


def fused_bound(qkv, h, d, opts):
    """(bound_ms, bound_by) of the work these inputs need. A query row with
    no allowed key outputs 0 whatever q is, and a key no query may attend
    is never read, so bytes = q of the query rows that attend at least one
    key and K and V of the keys some query attends (per batch row), o
    written in full, the (b, h, 1, n) float32 lse, and the key mask and
    pattern mask as passed and the rotary cos/sin tables (n, d) each;
    operations = 2 * 2 * d per allowed (query, key) pair and head."""
    from dalle_pytorch_tpu_torch.ops.flash_attention import may_attend

    b, n, _ = qkv.shape
    item = qkv.element_size()
    key_mask, pattern = opts.get("key_mask"), opts.get("pattern_mask")
    allowed = may_attend(n, qkv.device, key_mask, opts.get("causal", True),
                         pattern)[:, 0].expand(b, n, n)
    q_rows = int(allowed.any(dim=2).sum())
    kv_keys = int(allowed.any(dim=1).sum())
    pairs = int(allowed.sum())
    nbytes = (q_rows + 2 * kv_keys) * h * d * item + b * n * h * d * item + 4 * b * h * n
    for t in (key_mask, pattern, *(opts.get("rot") or ())):
        if t is not None:
            nbytes += t.numel() * t.element_size()
    ops = 4 * pairs * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[qkv.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_args(qkv, h, d, opts):
    """q, k, v (b, h, n, d) split and rotated, and the same mask, for one
    ``scaled_dot_product_attention`` call (the yardstick)."""
    from dalle_pytorch_tpu_torch.ops.rotary import rotate_half

    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    if opts.get("rot") is not None:
        cos, sin = (t[:, None] for t in opts["rot"])
        q, k, v = (t * cos + rotate_half(t) * sin for t in (q, k, v))
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(scale=d**-0.5)
    if opts.get("key_mask") is not None:
        kw["attn_mask"] = opts["key_mask"][:, None, None, :]
    else:
        kw["is_causal"] = True
    return (q, k, v), kw


def check_fused_qkv() -> dict:
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    errs, rel_errs, train_errs = {}, {}, {}
    for case in ("clip", "dalle", "dalle_pattern", "train"):
        for dtype in (torch.float32, torch.bfloat16):
            qkv, h, d, opts = fused_inputs(case, dtype)
            o, lse = fa.fused_qkv_attention(qkv, h, d, **opts)
            plain_o, plain_lse = fa.reference_fused_qkv(qkv, h, d, **opts)
            torch.cuda.synchronize()
            if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"fused_qkv kernel: non-finite output ({case}, {dtype})")
            rows = torch.ones(qkv.shape[0], dtype=torch.bool, device="cuda")
            if case == "clip":
                empty = CLIP_TEXT_LENGTHS.index(0)
                if not ((o[empty] == 0).all() and (lse[empty] == fa.NEG_INF).all()):
                    raise AssertionError("fused_qkv kernel: a fully masked row is not 0 / -1e30")
                rows[empty] = False
            b, n, _ = qkv.shape
            diff = (o.float() - plain_o.float())[rows]
            err = max(diff.abs().max().item(),
                      (lse - plain_lse)[rows].abs().max().item())
            per_row = diff.reshape(-1, n, h * d).norm(dim=-1)
            ref_norm = plain_o.float()[rows].reshape(-1, n, h * d).norm(dim=-1)
            rel = (per_row / ref_norm).max().item()
            lse_err = (lse - plain_lse)[rows].abs().max().item()
            ok = (err <= F32_ATOL if dtype == torch.float32
                  else rel <= BF16_RTOL and lse_err <= BF16_RTOL)
            log(f"fused_qkv {case} {dtype}: max |kernel - plain| over o and lse "
                f"= {err:.3e}, max row-relative L2 error of o = {rel:.3e}, "
                f"lse {lse_err:.3e} (tolerance: " + (
                    f"abs {F32_ATOL:.0e})" if dtype == torch.float32 else
                    f"row-relative {BF16_RTOL:.0e} on o, abs {BF16_RTOL:.0e} on lse)"))
            if not ok:
                raise AssertionError(f"fused_qkv kernel disagrees with plain: {err}, {rel}")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            rel_errs[dtype] = max(rel_errs.get(dtype, 0.0), rel)
            if case == "train":
                train_errs[dtype] = (err, rel)

    timings = {}
    # bf16 at the serving shapes; float32 at the training shape
    for case, dtype in (("clip", torch.bfloat16), ("dalle", torch.bfloat16),
                        ("train", torch.float32)):
        qkv, h, d, opts = fused_inputs(case, dtype)
        (q, k, v), sdpa_kw = sdpa_args(qkv, h, d, opts)
        timings[case] = dict(
            ms=cuda_time_ms(lambda: fa.fused_qkv_attention(qkv, h, d, **opts)),
            plain_ms=cuda_time_ms(lambda: fa.reference_fused_qkv(qkv, h, d, **opts)),
            library_ms=cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, **sdpa_kw)),
        )
        timings[case]["bound_ms"], timings[case]["bound_by"] = fused_bound(qkv, h, d, opts)
        t = timings[case]
        log(f"fused_qkv {case} {dtype} timing, cold L2: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return {
        "name": "fused_qkv_attention", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": FUSED_TPU_KERNEL, "max_abs_err": errs[torch.bfloat16],
        "max_rel_err": rel_errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32], **timings["clip"],
        **{f"train_{k}": v for k, v in timings["train"].items()},
        "train_max_abs_err_f32": train_errs[torch.float32][0],
        "train_max_rel_err_bf16": train_errs[torch.bfloat16][1],
    }


def fused_bwd_bound(qkv, h, d, opts):
    """(bound_ms, bound_by) of the backward on these inputs: bytes = q, o
    and do of the query rows that attend a key, K and V of the keys some
    query attends, the lse, dqkv written in full, the masks and tables;
    operations = five (query, key, d) products, 2 * 5 * d per allowed
    pair and head (s, dp, dv, dq, dk)."""
    from dalle_pytorch_tpu_torch.ops.flash_attention import may_attend

    b, n, _ = qkv.shape
    item = qkv.element_size()
    key_mask, pattern = opts.get("key_mask"), opts.get("pattern_mask")
    allowed = may_attend(n, qkv.device, key_mask, opts.get("causal", True),
                         pattern)[:, 0].expand(b, n, n)
    q_rows = int(allowed.any(dim=2).sum())
    kv_keys = int(allowed.any(dim=1).sum())
    pairs = int(allowed.sum())
    nbytes = (3 * q_rows + 2 * kv_keys + 3 * b * n) * h * d * item + 4 * b * h * n
    for t in (key_mask, pattern, *(opts.get("rot") or ())):
        if t is not None:
            nbytes += t.numel() * t.element_size()
    ops = 10 * pairs * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[qkv.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_backward(qkv, h, d, opts, do):
    """A function that runs the backward of one
    ``scaled_dot_product_attention`` on split, rotated heads (the
    yardstick), from a graph built once."""
    (q, k, v), kw = sdpa_args(qkv, h, d, opts)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)
    grad = do.reshape(out.shape[0], out.shape[2], h, d).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)


def check_fused_qkv_bwd() -> dict:
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.testing import BWD_BF16_ROW_REL, BWD_F32_REL, bwd_errors

    worst_rel = worst_row = 0.0
    for case in ("train", "clip", "dalle_pattern"):
        for dtype in (torch.float32, torch.bfloat16):
            qkv, h, d, opts = fused_inputs(case, dtype, seed=1)
            g = torch.Generator(device="cuda").manual_seed(2)
            do = torch.randn(qkv.shape[0], qkv.shape[1], h * d, generator=g,
                             device="cuda").to(dtype)
            o, lse = fa.reference_fused_qkv(qkv, h, d, **opts)
            got = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts)
            again = fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts)
            plain = fa.reference_fused_qkv_bwd(qkv, o, lse, do, h, d, **opts)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"fused_qkv_bwd kernel: non-finite output ({case}, {dtype})")
            rel, row_rel, zeros_exact = bwd_errors(got, plain, h, d, opts)
            abs_err = (got.float() - plain.float()).abs().max().item()
            differ = int((got != plain).sum())
            same = torch.equal(got, again)
            if case == "clip":
                zeros_exact &= bool((got[CLIP_TEXT_LENGTHS.index(0)] == 0).all())
            ok = (rel <= BWD_F32_REL if dtype == torch.float32
                  else row_rel <= BWD_BF16_ROW_REL)
            log(f"fused_qkv_bwd {case} {dtype}: relative L2 error {rel:.3e}, floored "
                f"row-relative {row_rel:.3e}, max abs {abs_err:.3e}, {differ} of "
                f"{got.numel()} elements differ, masked rows exactly 0 "
                f"{zeros_exact}, two runs identical {same} (tolerance: "
                + (f"relative {BWD_F32_REL:.0e})" if dtype == torch.float32
                   else f"row-relative {BWD_BF16_ROW_REL:.0e})"))
            if not (ok and zeros_exact and same):
                raise AssertionError(f"fused_qkv_bwd kernel disagrees with plain: {case} {dtype}")
            if dtype == torch.float32:
                worst_rel = max(worst_rel, rel)
                if case == "train":
                    train_abs = abs_err
            else:
                worst_row = max(worst_row, row_rel)

    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv, h, d, opts = fused_inputs("train", dtype, seed=1)
        do = torch.randn(qkv.shape[0], qkv.shape[1], h * d, device="cuda").to(dtype)
        o, lse = fa.fused_qkv_attention(qkv, h, d, **opts)
        t = dict(
            ms=cuda_time_ms(lambda: fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts),
                            iters=20),
            plain_ms=cuda_time_ms(lambda: fa.reference_fused_qkv_bwd(qkv, o, lse, do, h, d,
                                                                     **opts), iters=10),
            library_ms=cuda_time_ms(sdpa_backward(qkv, h, d, opts, do), iters=20),
        )
        t["bound_ms"], t["bound_by"] = fused_bwd_bound(qkv, h, d, opts)
        timings[dtype] = t
        log(f"fused_qkv_bwd train {dtype} timing, cold L2: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa backward {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    t = timings[torch.float32]  # the training path's type
    return {
        "name": "fused_qkv_attention_bwd", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
        "replaces": FUSED_BWD_TPU_KERNEL, "max_abs_err": train_abs,
        "max_rel_err_f32": worst_rel, "max_row_rel_err_bf16": worst_row,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "ms_bf16": timings[torch.bfloat16]["ms"],
    }


# ------------------------------------------------------------ path check


def check_path_against_plain() -> None:
    """Small float32 DALLE with identical weights on the card and the CPU
    through mixed ragged iterations: the card runs the kernel, the CPU the
    plain version; logits of active rows agree to 1e-3."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache

    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, num_text_tokens=50,
               text_seq_len=8, num_image_tokens=40, image_fmap_size=4)
    gpu = DALLE(**cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(3))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    caches = {m: init_decode_cache(m, 3, page_size=4) for m in (gpu, cpu)}
    rng = np.random.RandomState(4)
    # (start, length) per row, width 4, prompt of 9 positions
    steps = [([0, 0, 2], [4, 4, 0]), ([4, 4, 0], [4, 4, 4]), ([8, 8, 4], [1, 1, 4]),
             ([9, 9, 8], [1, 1, 1]), ([10, 7, 9], [1, 0, 1]), ([11, 10, 10], [1, 1, 1])]
    worst = 0.0
    for start, length in steps:
        tokens = rng.randint(0, 40, size=(3, 4))
        args = [np.asarray(a, np.int32) for a in (tokens, start, length)]
        out = {}
        for m in (gpu, cpu):
            t = [torch.from_numpy(a).to(m.device) for a in args]
            final = torch.zeros(3, dtype=torch.bool, device=m.device)
            out[m] = m.fused_step(*t, final, caches[m]).cpu()
        active = torch.from_numpy(args[2] > 0)
        worst = max(worst, (out[gpu] - out[cpu]).abs()[active].max().item())
    log(f"path check: card (kernel) vs CPU (plain) fused_step logits, max abs diff {worst:.3e}")
    if not worst <= 1e-3:
        raise AssertionError(f"card path disagrees with the plain path: {worst}")


def check_clip_against_plain() -> None:
    """Small float32 CLIP whose text length takes the packed-qkv kernel
    (128 tokens, 2 heads of 64), identical weights on the card and the
    CPU, zero-padded prompts: similarities agree to 1e-4, and the card's
    text encoder launched the kernel once per layer."""
    from dalle_pytorch_tpu_torch.models.clip import CLIP
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    cfg = dict(dim_text=128, dim_image=64, dim_latent=32, num_text_tokens=100,
               text_enc_depth=2, text_seq_len=128, text_heads=2, text_dim_head=64,
               visual_enc_depth=1, visual_heads=2, visual_dim_head=32,
               visual_image_size=32, visual_patch_size=8)
    gpu = CLIP(**cfg, device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(5))
    cpu = CLIP(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.RandomState(6)
    text = rng.randint(1, 100, size=(4, 128))
    for i, n in enumerate((128, 90, 33, 1)):
        text[i, n:] = 0
    image = rng.rand(4, 32, 32, 3).astype(np.float32)
    sims = {}
    before = fa.fused_qkv_attention.launches
    for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
        t = torch.from_numpy(text).to(dev)
        with torch.no_grad():
            sims[dev] = m(t, torch.from_numpy(image).to(dev), text_mask=t != 0).cpu()
    launched = fa.fused_qkv_attention.launches - before
    worst = (sims["cuda"] - sims["cpu"]).abs().max().item()
    log(f"path check: card (kernel) vs CPU (plain) CLIP similarity, max abs diff "
        f"{worst:.3e}, packed-qkv launches {launched}")
    if not worst <= 1e-4 or launched != cfg["text_enc_depth"]:
        raise AssertionError(f"CLIP card path disagrees with the plain path: {worst}, {launched}")


def check_train_against_plain() -> None:
    """Small float32 DALLE whose n takes the packed-qkv path (depth 2, 2
    heads of 64, text 64 + an 8 x 8 grid: n 128; token shift, rotary),
    identical weights on the card (both kernels) and the CPU (plain
    versions): the loss to relative 1e-5 and every parameter's gradient to
    1e-4 of its largest entry, each kernel launched once per layer."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, num_text_tokens=50,
               text_seq_len=64, num_image_tokens=40, image_fmap_size=8)
    gpu = DALLE(**cfg, device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(7))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.RandomState(8)
    text = rng.randint(1, 50, size=(2, 64))
    text[0, 40:], text[1, 9:] = 0, 0
    image = rng.randint(0, 40, size=(2, 64))
    losses, grads = {}, {}
    before = fa.fused_qkv_attention.launches, fa.fused_qkv_attention_bwd.launches
    for m in (gpu, cpu):
        t, i = (torch.from_numpy(a).to(m.device) for a in (text, image))
        loss = m(t, i, return_loss=True)
        loss.backward()
        losses[m] = loss.item()
        grads[m] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    launched = (fa.fused_qkv_attention.launches - before[0],
                fa.fused_qkv_attention_bwd.launches - before[1])
    loss_rel = abs(losses[gpu] - losses[cpu]) / abs(losses[cpu])
    worst = max((grads[gpu][k] - g).abs().max().item() / g.abs().max().item()
                for k, g in grads[cpu].items())
    log(f"path check: card (kernels) vs CPU (plain) DALLE training loss, relative "
        f"{loss_rel:.3e}; worst gradient error {worst:.3e} of its largest entry; "
        f"packed-qkv launches forward/backward {launched}")
    if not (loss_rel <= 1e-5 and worst <= 1e-4 and launched == (cfg["depth"],) * 2):
        raise AssertionError(f"training path disagrees: {loss_rel}, {worst}, {launched}")


# --------------------------------------------------------------- engine


def serve_flagship():
    from dalle_pytorch_tpu_torch.models.clip import CLIP
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.postdecode import STAGE_RERANK, StageConfig, StageSpec
    from dalle_pytorch_tpu_torch.serving.types import Outcome, Request

    t0 = time.perf_counter()
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    model = DALLE(**FLAGSHIP, **bf16).init_weights(gen(0))
    vae = DiscreteVAE(**FLAGSHIP_VAE, **bf16).init_weights(gen(1))
    clip = CLIP(**FLAGSHIP_CLIP, **bf16).init_weights(gen(2))
    engine = Engine(model, EngineConfig(
        max_batch=MAX_BATCH, prefill_chunk=CHUNK,
    ), device="cuda", stages=StageSpec(vae, clip, config=StageConfig(
        batch=STAGE_BATCH, queue_limit=N_REQUESTS)))
    prompts = np.random.RandomState(0).randint(
        1, FLAGSHIP["num_text_tokens"], size=(N_REQUESTS, FLAGSHIP["text_seq_len"]))
    for i in range(N_REQUESTS):
        prompts[i, FLAGSHIP["text_seq_len"] - 23 * i:] = 0  # ragged prompt lengths
        assert engine.submit(Request(f"r{i}", prompts[i], MAX_NEW, seed=i)) is None
    torch.cuda.synchronize()
    log(f"engine: flagship DALLE, VAE and CLIP built in {time.perf_counter() - t0:.1f} s")

    ra.kernel_attend.launches = 0
    fa.fused_qkv_attention.launches = 0
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ragged_attention": ra.kernel_attend.launches,
                "fused_qkv_attention": fa.fused_qkv_attention.launches}

    for i in range(N_REQUESTS):
        r = results[f"r{i}"]
        if r.outcome is not Outcome.COMPLETED or len(r.tokens) != MAX_NEW:
            raise AssertionError(f"request r{i}: {r.outcome} {r.detail!r}, "
                                 f"{None if r.tokens is None else len(r.tokens)} tokens")
        if not ((r.tokens >= 0) & (r.tokens < FLAGSHIP["num_image_tokens"])).all():
            raise AssertionError(f"request r{i}: token out of the image vocab")
        if r.image is None or r.image.shape != (256, 256, 3) or not np.isfinite(r.image).all():
            raise AssertionError(f"request r{i}: no finite (256, 256, 3) image")
        if r.rerank_score is None or not np.isfinite(r.rerank_score):
            raise AssertionError(f"request r{i}: rerank score {r.rerank_score}")
    pipe = engine.postdecode
    rerank_dispatches = pipe.counters[f"serve.stage.dispatches.{STAGE_RERANK}"]
    expected = {"ragged_attention": FLAGSHIP["depth"] * engine.dispatches,
                "fused_qkv_attention": FLAGSHIP_CLIP["text_enc_depth"] * rerank_dispatches}
    stage_s = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(pipe.seconds.items()))
    log(f"engine: {N_REQUESTS} requests, {engine.iterations} iterations, "
        f"{engine.dispatches} dispatches, {wall:.2f} s wall (stages included), "
        f"{N_REQUESTS * MAX_NEW / wall:.1f} generated tokens/s; stage seconds: "
        f"{stage_s}; counters {dict(sorted(pipe.counters.items()))}")
    log(f"engine: launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    return results, launches, model


def profile_iterations(model, warmup: int = 10, window: int = 30) -> None:
    """Where an engine iteration's time goes: torch.profiler over a window
    of a fresh mixed prefill/decode batch (8 requests at once, so one row
    decodes while the others prefill chunk by chunk). Prints wall time and
    device-busy time per iteration, launches per iteration, and the
    largest device-time kernels. Runs after the counted main path."""
    from torch.profiler import ProfilerActivity, profile

    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Request

    engine = Engine(model, EngineConfig(
        max_batch=MAX_BATCH, prefill_chunk=CHUNK,
    ), device="cuda")
    prompts = np.random.RandomState(1).randint(
        1, FLAGSHIP["num_text_tokens"], size=(MAX_BATCH, FLAGSHIP["text_seq_len"]))
    for i in range(MAX_BATCH):
        engine.submit(Request(f"p{i}", prompts[i], MAX_NEW, seed=100 + i))
    for _ in range(warmup):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / window
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / window
    launches = sum(e.count for e in device) / window
    log(f"profile: {window} mixed iterations, {wall_ms:.3f} ms/iteration wall, "
        f"device busy {busy_ms:.3f} ms/iteration "
        f"({100 * busy_ms / wall_ms:.1f}% busy), {launches:.0f} device "
        "launches/iteration")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"profile:   {e.self_device_time_total / 1e3 / window:.4f} ms/iteration "
            f"x{e.count // window} {e.key[:90]}")


def check_pixels(results) -> None:
    """The engine's images, denormalized for display, in [0, 1]; printed
    best-first by rerank score, the order the generate CLI saves them in."""
    from dalle_pytorch_tpu_torch.models.vae import denormalize

    ids = [f"r{i}" for i in range(N_REQUESTS)]
    images = denormalize(torch.from_numpy(np.stack([results[r].image for r in ids])))
    if not (images.min() >= 0 and images.max() <= 1):
        raise AssertionError("denormalized pixels outside [0, 1]")
    scores = np.array([results[r].rerank_score for r in ids])
    order = [ids[i] for i in np.argsort(-scores)]
    log(f"pixels: {tuple(images.shape)} in [0, 1]; best-first by rerank score: "
        + ", ".join(f"{r} {results[r].rerank_score:.4f}" for r in order))


# ---------------------------------------------------------------- train


def train_flagship():
    """The flagship DALLE trained in float32 by ``DalleTrainer``: the
    counted run, then the NaN-injected step. Returns (trainer, (text,
    images), launches of the counted run)."""
    from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.parallel.step import make_train_step
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer, dalle_loss

    t0 = time.perf_counter()
    vae = DiscreteVAE(**FLAGSHIP_VAE, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(11))
    images = torch.rand(TRAIN_BATCH, 256, 256, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(12))
    text = np.random.RandomState(13).randint(
        1, FLAGSHIP["num_text_tokens"], size=(TRAIN_BATCH, FLAGSHIP["text_seq_len"]))
    for i in range(TRAIN_BATCH):
        text[i, FLAGSHIP["text_seq_len"] - 40 * (i + 1):] = 0  # zero tails
    text = torch.from_numpy(text).cuda()
    tokens = vae.get_codebook_indices(images)
    if tokens.shape != (TRAIN_BATCH, 1024) or not ((tokens >= 0) & (tokens < 8192)).all():
        raise AssertionError(f"VAE encode: tokens {tuple(tokens.shape)} out of range")
    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True)
    n_params = sum(p.numel() for p in trainer.dalle.parameters())
    torch.cuda.synchronize()
    log(f"train: flagship DALLE ({n_params:,} parameters, float32) and VAE built, "
        f"images encoded to {tuple(tokens.shape)} tokens in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    fa.fused_qkv_attention.launches = 0
    fa.fused_qkv_attention_bwd.launches = 0
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(text, images))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {"fused_qkv_attention": fa.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fa.fused_qkv_attention_bwd.launches}
    expected = FLAGSHIP["depth"] * (trainer.steps + trainer.retries)
    steady = float(np.median(walls[1:]))
    tokens_per_step = TRAIN_BATCH * (FLAGSHIP["text_seq_len"] + 1024)
    log(f"train: {trainer.steps} steps, {trainer.retries} retries, losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"train: step wall first {walls[0]:.3f} s, median of the rest {steady:.4f} s "
        f"(all: {', '.join(f'{w:.4f}' for w in walls)}); {tokens_per_step / steady:.1f} "
        f"training tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"train: launches {launches} (expected {expected} each)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}")
    if set(launches.values()) != {expected}:
        raise AssertionError(f"train: kernel launches {launches}, expected {expected}")

    state = trainer.state
    snapshot = [t.clone() for part in (state.params, state.opt_state.mu, state.opt_state.nu)
                for t in part.values()]
    inject = make_train_step(dalle_loss, 0.5, nan_inject_step=int(state.step))
    new, loss = inject(state, trainer.dalle, {"text": text, "image": tokens}, trainer.lr)
    after = [t for part in (new.params, new.opt_state.mu, new.opt_state.nu) for t in part.values()]
    identical = all(torch.equal(a, b) for a, b in zip(snapshot, after))
    log(f"train: NaN injected at step {int(state.step)}: loss {loss.item()}, skipped "
        f"{int(new.skipped)}, every parameter and Adam moment bit-identical {identical}")
    if not (torch.isnan(loss) and int(new.skipped) == 1 and identical
            and int(new.opt_state.count) == int(state.opt_state.count)):
        raise AssertionError("train: the NaN guard changed the state")
    trainer.state = new
    return trainer, (text, images), launches


def profile_train(trainer, batch, steps: int = 3) -> None:
    """Where a flagship train step's time goes: torch.profiler over a few
    steps after the counted run: wall and device-busy time per step,
    launches per step, the largest device-time kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / steps
    launches = sum(e.count for e in device) / steps
    log(f"train profile: {steps} steps, {wall_ms:.2f} ms/step wall, device busy "
        f"{busy_ms:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}% busy), {launches:.0f} "
        "device launches/step")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"train profile:   {e.self_device_time_total / 1e3 / steps:.3f} ms/step "
            f"x{e.count // steps} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dalle_pytorch_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"TF32 cuDNN {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    cuda_build.build()
    log(f"build: {sorted(cuda_build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s")

    kernels = [check_ragged_attention(), check_fused_qkv(), check_fused_qkv_bwd()]
    check_path_against_plain()
    check_clip_against_plain()
    check_train_against_plain()
    results, serve_launches, model = serve_flagship()
    check_pixels(results)
    profile_iterations(model)
    del model, results
    torch.cuda.empty_cache()
    trainer, batch, train_launches = train_flagship()
    profile_train(trainer, batch)
    for k in kernels:
        by_path = {path: counts[k["name"]] for path, counts in
                   (("serve", serve_launches), ("train", train_launches))
                   if k["name"] in counts}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
