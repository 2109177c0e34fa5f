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
   bound from bytes and operations. The ragged kernel's two instances
   (unquantized pages; int8 pages with their scale pages, at dim_head
   32/64/128) at the serving shape (8 rows of 16 columns, 11 pages of
   128), identity and permuted tables, timed in bf16 side by side; the
   unquantized instance also held and timed at generation's paged prompt
   block (4 rows of 257 columns, five query tiles, short, late and idle
   rows). The packed-qkv kernel is held at CLIP's text shape (the rerank
   stage's), at DALL-E's causal rotary shape, with and without a pattern
   mask, and at the training shape (batch 4), and timed in bf16 at
   CLIP's and DALL-E's shapes and in float32 at the training shape (both
   instances on the tensor cores; float32's bound at the split-3xTF32
   rate, its CUDA-core bound beside). The fused decode kernel is held at
   the flagship's decode shapes (b 1 and 8, 16 heads of 64, L 1281,
   positions 0 to 1279, rotary and key mask on and off, a masked own
   key, dim_head 32 and 128; its k/v rows bitwise) and timed at b 1 and
   8.
4. path check: a small float32 DALLE (dense and the four-type sparse
   cycle, each with unquantized and with int8 pages), and a small float32
   CLIP whose text length takes the packed-qkv kernel, each with the same
   weights on the card (kernels) and on the CPU (plain versions); logits
   and similarities agree. A small float32 DALLE (2 heads of 64)
   generating with ``fused_decode``: ``decode_step`` logits on the "4d"
   and "flat" caches and greedy tokens agree, card against CPU, with the
   decode kernel launched once per layer and step; on the "paged" cache
   an 81-column prompt block (two query tiles of the ragged kernel) and
   the decode steps after it agree, card against CPU; a 4 x 16-head
   model never launches the decode kernel. Preemption on the card: a small DALLE under a
   page budget below its batch's demand (unquantized and int8) preempts,
   completes every request and replays tokens bit-identical to the
   unpressured run.
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
7. profile: torch.profiler over 15 iterations of a fresh mixed batch:
   wall and device-busy time per iteration, launches per iteration, the
   largest device-time kernels (after the counted run).
5b. serve int8: the flagship of phase 5 with int8 KV pages, 8 of its
   requests, no stages: every outcome COMPLETED with 1024 tokens in
   range, the int8 ragged instance launched depth x dispatched iterations
   times and the unquantized one never, KV bytes per slot exactly 68/128
   of the bf16 engine's; token agreement with phase 5 printed. Then the
   teacher-forced flagship logits through int8 against bf16 pages within
   ``testing.INT8_LOGITS_REL``, and profiles of 15 iterations as in
   phase 7, int8, int8, then bf16 again (phase 7's came first), each with
   the host's time by operator.
5c. serve sparse: the sparse configuration (phase 10's layers) at the
   flagship width, bf16, int8 pages, 4 requests of 256 tokens: every
   outcome COMPLETED, the int8 ragged instance launched depth / 4 x
   dispatched iterations times (the full layers).
5d. generate: the flagship of phase 5 generating outside the engine
   (``models/sampling.py``), each run counted: (a) batch 1 on the "4d"
   cache with ``fused_decode=True`` and ``window_seg=0``, 1024 tokens in
   range, the decode kernel launched exactly 12 x 1023 times; (b) the
   same caption on the unfused chain with the default window, token
   agreement printed, and (a)'s tokens teacher-forced through both paths
   (the prompt and 256 decode steps), image logits within
   ``testing.DECODE_LOGITS_REL``; (c) batch 8 on the
   "flat" cache, ``generate_images`` with phase 5's VAE and CLIP, 8
   finite images and scores, the decode kernel 12 x 1023 times; (d)
   batch 4 on pages with default arguments, the ragged kernel 12 x 1024
   times (its prompt block of 257 columns included), the decode kernel
   never. Each prints wall seconds, ms per token and tokens/s; then
   torch.profiler over 20 decode steps of (a).
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
10. train sparse: the flagship DALLE with its layers cycling "full",
   "axial_row", "axial_col", "conv_like" (BASELINE.json configs[2] at
   the flagship width), otherwise as phase 8: 10 steps on one batch,
   every loss finite and the last below the first, the block-sparse
   forward, dq and dk/dv kernels (axial_row and conv_like layers) and the
   packed-qkv forward and backward (full and axial_col layers) launched
   depth / 2 x (steps + retries) times each; then profiled as phase 9.
11. train 512: the flagship DALLE at 512 px (a 64 x 64 image grid, n
   4,352 positions; the flagship VAE with image_size 512 encodes 4 seeded
   512 px images to (4, 4096) tokens), float32, otherwise as phase 8: 10
   steps on one batch, every loss finite and the last below the first,
   the tiled flash forward, dq and dk/dv kernels launched depth x (steps
   + retries) times each and no other attention kernel; then profiled as
   phase 9.

Phase 3 also holds the packed-qkv backward kernel against its plain
version (float32 and bfloat16) at the flagship training shape, CLIP's
text shape and DALL-E's shape with the axial-row and axial-column
pattern masks (timed at the training shape in both types), and the
three block-sparse kernels (forward, dq, dk/dv) at the flagship training
shape with the axial_row and conv_like layouts
and at a ragged n with a key mask that kills whole rows (dim_head 32,
64, 128), each timed beside its plain version, the packed kernel with
the same pattern, and ``scaled_dot_product_attention``; and the four
tiled flash kernels (forward, dq, dk/dv, single-block backward) on
``testing.flash_inputs``: the 512 px training shape (b 4, 16 heads of
64, n 4352, causal), its axial_col pattern, a key mask with fully masked
rows at dim_head 32/64/96/128, non-causal, a pattern at a small n, and
one flash block of 1280 at 3 heads, float32 and bfloat16, each timed at
its main path's shape beside its plain version and
``scaled_dot_product_attention``. Phase 4 also checks a small float32
DALLE's loss and every parameter gradient, card against CPU, for the
full model, for the four-type sparse cycle, at n 1152 (the tiled
kernels, dq then dk/dv) and at n 384 with 3 heads (one flash block: the
single-block backward), with exact launch counts.

The second-to-last line is the card's ``nvidia-smi`` name and power
limit; the line before it the kernels' JSON; the last line
``{"ok": true, "device": {...}}``.

Phase 2 also prints what ``ptxas -v`` reports (registers, shared memory,
spills) for the packed-qkv kernels' tensor-core instances (bf16, and
float32 as split 3xTF32) and for every instance of the ragged kernel,
and counts the HMMA instructions of each packed instance in the built
libraries (``cuobjdump -sass``), failing unless every float32 instance
holds TF32 HMMA.

Paired comparisons, one card, none of the phases above:

    python3 chip_smoke.py --ragged-source OTHER/ragged_attention.cu
    python3 chip_smoke.py --packed-source OTHER/csrc
    python3 chip_smoke.py --generate-pairs 3

the first times this checkout's ragged kernel against the same file of
another commit (or of each of several, the flag repeated), alternating
in one process, with the cold timer's spin and without it (both bf16
instances at the serving shape, the unquantized one at generate (d)'s
prompt block); the second builds another commit's packed-qkv forward
and backward under other library names, holds each tree's float32
outputs against the plain versions (printing max |this - other|),
checks that the two trees' bf16 outputs are bitwise equal, and times
both trees alternating (bf16 forward at DALL-E's b 2 and CLIP's shape,
bf16 backward and both float32 kernels at the training shape); the third
times generation (a) against (b) in alternating pairs.
"""

from __future__ import annotations

import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# and float32 (non-tensor) operations/s, dense TF32 tensor-core
# operations/s (the packed kernels run float32 products as split 3xTF32:
# three TF32 products each)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_PEAK_OPS = 495e12
L2_FLUSH_BYTES = 256 << 20  # well past the 50 MB L2
# ~0.5 ms of a spinning card (at ~2 GHz) before each cold timed call:
# longer than the host takes to issue one wrapper's launches
HOST_COVER_CYCLES = 1_000_000

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
# packed-qkv forward vs plain in bfloat16: each row's o error norm over
# h*d relative to the plain row's (two bf16 roundings of the output are
# ~0.4%), lse absolute. Its float32 tolerance (testing.F32_ATOL) and the
# ragged kernel's, the packed-qkv backward's and the block-sparse
# kernels' tolerances and metrics are dalle_pytorch_tpu_torch.testing's.
BF16_RTOL = 1e-2
RAGGED_TPU_KERNEL = "dalle_pytorch_tpu/ops/ragged_attention.py:116"
RAGGED_INT8_TPU_KERNEL = "dalle_pytorch_tpu/ops/ragged_attention.py:140"  # quant=True
FUSED_TPU_KERNEL = "dalle_pytorch_tpu/ops/flash_attention.py:784"
FUSED_BWD_TPU_KERNEL = "dalle_pytorch_tpu/ops/flash_attention.py:813"
BS_TPU_KERNELS = {  # block_sparse_attention's kernel bodies
    "block_sparse_attention": "dalle_pytorch_tpu/ops/block_sparse_attention.py:252",
    "block_sparse_dq": "dalle_pytorch_tpu/ops/block_sparse_attention.py:287",
    "block_sparse_dkdv": "dalle_pytorch_tpu/ops/block_sparse_attention.py:315",
}
FLASH_TPU_KERNELS = {  # flash_attention's kernel bodies
    "flash_attention_fwd": "dalle_pytorch_tpu/ops/flash_attention.py:145",
    "flash_attention_dq": "dalle_pytorch_tpu/ops/flash_attention.py:186",
    "flash_attention_dkdv": "dalle_pytorch_tpu/ops/flash_attention.py:277",
    "flash_attention_bwd_fused": "dalle_pytorch_tpu/ops/flash_attention.py:229",
}
DECODE_TPU_KERNEL = "dalle_pytorch_tpu/ops/decode_attention.py:73"  # _kernel
SPARSE_TYPES = "full,axial_row,axial_col,conv_like"
# 512 px: three downsamples of the flagship VAE give a 64 x 64 grid
VAE_512 = dict(FLAGSHIP_VAE, image_size=512)
TRAIN_BATCH, TRAIN_STEPS = 4, 10
# generation's teacher-forced check, kernel against the unfused chain:
# decode steps after the prompt (a quarter of the image, for the script's
# time; the kernel phase holds the kernel at every sweep length)
TEACHER_FORCED_STEPS = 256
# the rerank stage's text key mask: valid prompt lengths of the 8 rows
# (one fully masked row: its output must be exactly 0, its lse -1e30)
CLIP_TEXT_LENGTHS = (256, 200, 131, 64, 17, 1, 0, 240)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup: int = 3, iters: int = 50, cold: bool = True) -> float:
    """Mean device ms of ``fn`` after warm-up. ``cold``: a buffer larger
    than the card's 50 MB L2 is overwritten before each call and each call
    is timed alone, so its inputs come from HBM, as in the engine, where
    every layer has K/V pools of its own; the card then spins for
    ``HOST_COVER_CYCLES`` so that it is still busy while the host issues
    the begin event and ``fn``'s launches, and the events time the device
    work, not the host's launch latency. Otherwise one event pair spans
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
        if HOST_COVER_CYCLES:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        begin, end = event(), event()
        begin.record()
        fn()
        end.record()
        pairs.append((begin, end))
    torch.cuda.synchronize()
    return sum(b.elapsed_time(e) for b, e in pairs) / iters


# ------------------------------------------------------------- kernels


def ragged_bound(q, start, length, kv_bytes_per_pos):
    """(bound_ms, bound_by) of the work the caller keeps: bytes = the K and
    V pages (``kv_bytes_per_pos`` per position: content, plus the scales
    of int8 pages) at positions 0 .. start + length - 1 of each active row
    once, q and the output of valid columns once, the table entries of
    those pages and the descriptors (an idle row's output is discarded, so
    it needs nothing); operations = 2 * 2 * h*d per (valid query, visible
    key) pair."""
    b, n, h, d = q.shape
    item = q.element_size()
    s, ln = start.cpu().numpy(), length.cpu().numpy()
    active = ln > 0
    frontier = (s + ln)[active]  # positions 0 .. start + length - 1
    nbytes = int(frontier.sum()) * kv_bytes_per_pos + 2 * int(ln.sum()) * h * d * item
    nbytes += 4 * (int((-(-frontier // PAGE)).sum()) + 2 * b)
    keys = sum(int(s[r]) + i + 1 for r in range(b) for i in range(int(ln[r])))
    ops = 4 * keys * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def hold_ragged(label: str, int8: bool, dims=(64,), case: str = "serve") -> dict:
    """One instance of the ragged kernel against its plain version on
    ``testing.ragged_inputs(case)`` (identity and permuted tables,
    float32 and bfloat16, each dim_head of ``dims``; the permuted table
    only at dim_head 32 and 128), at ``testing``'s tolerances; two runs
    bit-identical. Returns the worst errors."""
    from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
    from dalle_pytorch_tpu_torch.testing import (
        RAGGED_BF16_RTOL, RAGGED_F32_ATOL, ragged_errors, ragged_inputs, ragged_ok)

    errs, rel_errs = {}, {}
    for d in dims:
        for dtype in (torch.float32, torch.bfloat16):
            for permuted in (False, True) if d == 64 else (True,):
                q, k, v, ks, vs, table, start, length = ragged_inputs(
                    case, dtype, "cuda", int8=int8, dim_head=d, permuted=permuted)
                got = ra.kernel_attend(q, k, v, table, start, length, ks, vs)
                again = ra.kernel_attend(q, k, v, table, start, length, ks, vs)
                plain = ra.reference_attend(q, k, v, table, start, ks, vs)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{label}: non-finite output ({dtype}, d {d})")
                err, rel = ragged_errors(got, plain, length)
                same = torch.equal(got, again)
                log(f"{label} {dtype} d {d} permuted={permuted}: on valid columns max "
                    f"|kernel - plain| = {err:.3e}, max column-relative L2 error = {rel:.3e}, "
                    f"two runs identical {same} (tolerance: " + (
                        f"abs {RAGGED_F32_ATOL:.0e})" if dtype == torch.float32
                        else f"column-relative {RAGGED_BF16_RTOL:.0e})"))
                if not (ragged_ok(dtype, err, rel) and same):
                    raise AssertionError(f"{label} disagrees with plain: {err}, {rel}, {same}")
                errs[dtype] = max(errs.get(dtype, 0.0), err)
                rel_errs[dtype] = max(rel_errs.get(dtype, 0.0), rel)
    return {"max_abs_err": errs[torch.bfloat16], "max_rel_err": rel_errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32]}


def time_ragged(int8: bool, case: str = "serve") -> dict:
    """Times (cold L2) of one instance on ``testing.ragged_inputs(case)``
    ("serve": the serving iteration; "prompt": generate (d)'s 257-column
    prompt block) in bf16, the main paths' type: the kernel, its plain
    version, and one library call (``scaled_dot_product_attention`` over
    the already gathered and, for int8, dequantized view, same mask) as a
    yardstick; the bound."""
    from dalle_pytorch_tpu_torch.ops import paged_kv
    from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
    from dalle_pytorch_tpu_torch.testing import ragged_inputs

    q, k, v, ks, vs, table, start, length = ragged_inputs(
        case, torch.bfloat16, "cuda", int8=int8, permuted=False)
    kernel_ms = cuda_time_ms(lambda: ra.kernel_attend(q, k, v, table, start, length, ks, vs))
    warm_ms = cuda_time_ms(lambda: ra.kernel_attend(q, k, v, table, start, length, ks, vs),
                           cold=False)
    plain_ms = cuda_time_ms(lambda: ra.reference_attend(q, k, v, table, start, ks, vs))
    b, n, h, d = q.shape
    kc, vc = (paged_kv.read(t, table, sc, q.dtype).view(b, -1, h, d).transpose(1, 2)
              for t, sc in ((k, ks), (v, vs)))
    qt = q.transpose(1, 2)
    pos = start.long()[:, None] + torch.arange(n, device="cuda")
    mask = (torch.arange(kc.shape[2], device="cuda")[None, None] <= pos[..., None])[:, None]
    library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=mask, scale=1.0))
    per_pos = 2 * (h * d * k.element_size() + (h * 4 if int8 else 0))
    bound_ms, bound_by = ragged_bound(q, start, length, per_pos)
    return {"ms": kernel_ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def check_ragged_attention() -> list:
    """The ragged kernel's two instances: unquantized pages at dim_head 64,
    at the serving shape and at generate (d)'s prompt block
    (``ragged_inputs("prompt")``: 4 rows of 257 columns, five query
    tiles), and int8 pages (with their scale pages, through the same permuted
    table) at dim_head 32, 64 and 128, each held against its plain
    version; then both timed in bf16 at the serving shape in one pass,
    unquantized, int8, int8, unquantized, and the unquantized instance
    twice at the prompt block (its row's "prompt" entry)."""
    serve = hold_ragged("ragged_attention", int8=False)
    prompt = hold_ragged("ragged_attention prompt block", int8=False, case="prompt")
    rows = {
        "ragged_attention": {"name": "ragged_attention", "replaces": RAGGED_TPU_KERNEL,
                             **{k: max(serve[k], prompt[k]) for k in serve}},
        "ragged_attention_int8": {"name": "ragged_attention_int8",
                                  "replaces": RAGGED_INT8_TPU_KERNEL,
                                  **hold_ragged("ragged_attention_int8", int8=True,
                                                dims=(32, 64, 128))},
    }
    runs = {name: [] for name in rows}
    for name in ("ragged_attention", "ragged_attention_int8", "ragged_attention_int8",
                 "ragged_attention"):
        runs[name].append(time_ragged(int8=name.endswith("int8")))
    runs["prompt"] = [time_ragged(int8=False, case="prompt") for _ in range(2)]

    def mean_of(run: str, name: str, shape: str) -> dict:
        t = {key: float(np.mean([r[key] for r in runs[run]])) for key in
             ("ms", "warm_ms", "plain_ms", "library_ms", "bound_ms")}
        t["bound_by"] = runs[run][0]["bound_by"]
        log(f"{name} bf16 timing, {shape}, cold L2 (mean of 2 passes: " + ", ".join(
            f"{r['ms']:.4f}" for r in runs[run]) + f"): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']}); kernel back to back (warm L2) {t['warm_ms']:.4f} ms")
        return t

    for name, row in rows.items():
        row.update(route="cuda", source="dalle_pytorch_tpu_torch/csrc/ragged_attention.cu",
                   **mean_of(name, name, "serving shape"))
    rows["ragged_attention"]["prompt"] = mean_of("prompt", "ragged_attention", "prompt block")
    return list(rows.values())


def fused_inputs(case: str, dtype, seed: int = 0):
    """(qkv, heads, dim_head, options) of the packed-qkv kernel. "clip":
    the rerank stage's text encoder, b = 8, n = 256, 8 heads of 64,
    non-causal, the key mask of CLIP_TEXT_LENGTHS. "dalle": b = 2,
    n = 1280, 16 heads of 64, causal with the DALL-E rotary table;
    "dalle_pattern" adds the static axial-row pattern mask and
    "dalle_axial_col" the axial-column one (the mask the sparse
    configuration's axial_col layers give this kernel); "train" is "dalle"
    at the training batch of 4."""
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
        if case in ("dalle_pattern", "dalle_axial_col"):
            axis = int(case == "dalle_axial_col")
            pattern = masks.axial_mask(text_len, FLAGSHIP["image_fmap_size"], axis)[:n, :n]
            opts["pattern_mask"] = torch.from_numpy(pattern).cuda()
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device="cuda").to(dtype)
    return qkv, h, d, opts


def fused_bound(qkv, h, d, opts):
    """``packed_bounds`` of the work these inputs need. A query row with
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
    return packed_bounds(nbytes, 4 * pairs * h * d, qkv.dtype)


def packed_bounds(nbytes: int, ops: int, dtype) -> dict:
    """``bound_ms`` and ``bound_by`` of the packed kernels' work of
    ``nbytes`` and ``ops`` in ``dtype``. float32 products run as split
    3xTF32 on the tensor cores, three TF32 products each, so their
    operations count at TF32_PEAK_OPS / 3; ``bound_cuda_core_ms`` beside
    is the bound at the CUDA cores' float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    rate = TF32_PEAK_OPS / 3 if dtype == torch.float32 else PEAK_OPS[dtype]
    t_ops = ops / rate
    out = dict(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if dtype == torch.float32:
        out["bound_cuda_core_ms"] = 1e3 * max(t_bytes, ops / PEAK_OPS[dtype])
    return out


def bound_text(t: dict) -> str:
    """A bounds dict (``packed_bounds``) as a log phrase."""
    text = f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
    if "bound_cuda_core_ms" in t:
        text += f", CUDA-core float32 bound {t['bound_cuda_core_ms']:.4f} ms"
    return text


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
    from dalle_pytorch_tpu_torch.testing import F32_ATOL

    errs, rel_errs, train_errs = {}, {}, {}
    for case in ("clip", "dalle", "dalle_pattern", "dalle_axial_col", "train"):
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
        timings[case].update(fused_bound(qkv, h, d, opts))
        t = timings[case]
        log(f"fused_qkv {case} {dtype} timing, cold L2: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, {bound_text(t)}")
    return {
        "name": "fused_qkv_attention", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": FUSED_TPU_KERNEL, "max_abs_err": errs[torch.bfloat16],
        "max_rel_err": rel_errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32], **timings["clip"],
        **{f"dalle_{k}": v for k, v in timings["dalle"].items()},
        **{f"train_{k}": v for k, v in timings["train"].items()},
        "train_max_abs_err_f32": train_errs[torch.float32][0],
        "train_max_rel_err_bf16": train_errs[torch.bfloat16][1],
    }


def fused_bwd_bound(qkv, h, d, opts):
    """``packed_bounds`` of the backward on these inputs: bytes = q, o
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
    return packed_bounds(nbytes, 10 * pairs * h * d, qkv.dtype)


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
    for case in ("train", "clip", "dalle_pattern", "dalle_axial_col"):
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
        t.update(fused_bwd_bound(qkv, h, d, opts))
        timings[dtype] = t
        log(f"fused_qkv_bwd train {dtype} timing, cold L2: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa backward {t['library_ms']:.4f} ms, {bound_text(t)}")
    return {
        "name": "fused_qkv_attention_bwd", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
        "replaces": FUSED_BWD_TPU_KERNEL, "max_abs_err": train_abs,
        "max_rel_err_f32": worst_rel, "max_row_rel_err_bf16": worst_row,
        **timings[torch.float32],  # the training path's type
        **{f"bf16_{k}": v for k, v in timings[torch.bfloat16].items()},
    }


def pair_bounds(q, allowed, extra_bytes: int) -> dict:
    """{pass: (bound_ms, bound_by)} of the attention passes over q, k, v
    (b, h, n, d) where ``allowed`` (b or 1, 1, n, n) may attend, plus
    ``extra_bytes`` of masks and tables read once. Bytes: each input once,
    counting only what the work needs (q, o, do, lse and delta at query
    rows that attend a key, K and V at keys some query attends), each
    output written in full. Operations: 2 * d per allowed (query, key) pair
    and head for each product: "fwd" 2 (s, p.v), "dq" 3 (s, dp, ds.k),
    "dkdv" 4 (s, dp, p^T.do, ds^T.q), "fused" 5 (s, dp, ds.k, p^T.do,
    ds^T.q)."""
    b, h, n, d = q.shape
    item = q.element_size()
    allowed = allowed[:, 0].expand(b, n, n)
    rows = int(allowed.any(dim=2).sum()) * h   # query rows that attend a key
    keys = int(allowed.any(dim=1).sum()) * h   # keys some query attends
    pairs = int(allowed.sum()) * h
    full = b * h * n
    row_d, key_d, full_d = rows * d * item, keys * d * item, full * d * item
    work = {  # pass: (bytes, products)
        "fwd": (row_d + 2 * key_d + full_d + 4 * full, 2),
        "dq": (3 * row_d + 4 * rows + 2 * key_d + full_d + 4 * full, 3),
        "dkdv": (2 * row_d + 8 * rows + 2 * key_d + 2 * full_d, 4),
        "fused": (3 * row_d + 4 * rows + 2 * key_d + 3 * full_d, 5),
    }
    out = {}
    for name, (nbytes, products) in work.items():
        t_bytes = (nbytes + extra_bytes) / HBM_BYTES_PER_S
        t_ops = 2 * products * d * pairs / PEAK_OPS[q.dtype]
        out[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def bs_bounds(q, layout, key_mask):
    """``pair_bounds`` of the three block-sparse kernels on these inputs,
    the layout's mask, table and offsets and the key mask as passed."""
    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs

    b, _, n, _ = q.shape
    dl = bs.device_layout(layout, q.device)
    extra = sum(t.numel() * t.element_size() for t in dl) + (0 if key_mask is None else b * n)
    bounds = pair_bounds(q, bs.may_attend(layout, n, q.device, key_mask), extra)
    return {"block_sparse_attention": bounds["fwd"], "block_sparse_dq": bounds["dq"],
            "block_sparse_dkdv": bounds["dkdv"]}


def check_block_sparse() -> list:
    """The three block-sparse kernels against their plain versions on
    ``testing.bs_inputs`` (flagship training shape with the axial_row and
    conv_like layouts; ragged n 300 with a key mask that kills whole rows
    at dim_head 32/64/128; a layout with synthetic pairs), float32 and
    bfloat16, at ``testing``'s tolerances; dead rows exactly 0; two runs
    bit-identical. Then timings (cold L2) at the training shape in
    float32: each kernel, its plain version, the bound, the packed-qkv
    kernels with the same pattern operand on the packed projection (the
    alternative path), and ``scaled_dot_product_attention`` forward and
    backward with the boolean pattern mask on the same split heads."""
    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables
    from dalle_pytorch_tpu_torch.testing import (
        BS_BF16_ROW_REL, BS_F32_ATOL, BWD_BF16_ROW_REL, BWD_F32_REL, bs_bwd_errors,
        bs_fwd_errors, bs_inputs)

    def run(q, k, v, do, layout, km):
        o, lse = bs.block_sparse_attention(q, k, v, layout, km)
        dq, delta = bs.block_sparse_dq(q, k, v, o, lse, do, layout, km)
        dk, dv = bs.block_sparse_dkdv(q, k, v, do, lse, delta, layout, km)
        return o, lse, dq, delta, dk, dv

    worst = {}  # name -> max abs error at the training shape, float32
    for case in ("axial_row", "conv_like", "d32", "d64", "d128", "synthetic"):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, layout, km = bs_inputs(case, dtype, "cuda")
            got = run(q, k, v, do, layout, km)
            again = run(q, k, v, do, layout, km)
            po, plse = bs.reference_block_sparse(q, k, v, layout, km)
            pdq, pdelta = bs.reference_block_sparse_dq(q, k, v, po, plse, do, layout, km)
            pdk, pdv = bs.reference_block_sparse_dkdv(q, k, v, do, plse, pdelta, layout, km)
            torch.cuda.synchronize()
            o, lse, dq, delta, dk, dv = got
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"block-sparse kernels: non-finite output ({case}, {dtype})")
            err, row_rel, lse_err, dead_exact = bs_fwd_errors(o, lse, po, plse, layout, km)
            rel, grad_row_rel, zeros_exact = bs_bwd_errors((dq, dk, dv), (pdq, pdk, pdv),
                                                           layout, km)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if dtype == torch.float32:
                ok = err <= BS_F32_ATOL and rel <= BWD_F32_REL
                tol = f"abs {BS_F32_ATOL:.0e} forward, relative {BWD_F32_REL:.0e} backward"
            else:
                ok = (row_rel <= BS_BF16_ROW_REL and lse_err <= BS_BF16_ROW_REL
                      and grad_row_rel <= BWD_BF16_ROW_REL)
                tol = (f"row-relative {BS_BF16_ROW_REL:.0e} and lse abs {BS_BF16_ROW_REL:.0e} "
                       f"forward, floored row-relative {BWD_BF16_ROW_REL:.0e} backward")
            log(f"block_sparse {case} {dtype} (n {layout.n}, {layout.n_pairs} of "
                f"{layout.dense_pairs} causal block pairs): forward max abs {err:.3e}, row "
                f"{row_rel:.3e}; gradients relative L2 {rel:.3e}, floored row {grad_row_rel:.3e}; "
                f"dead rows exactly 0 {dead_exact and zeros_exact}; two runs identical {same} "
                f"(tolerance: {tol})")
            if not (ok and dead_exact and zeros_exact and same):
                raise AssertionError(f"block-sparse kernels disagree with plain: {case} {dtype}")
            if case in ("axial_row", "conv_like") and dtype == torch.float32:
                for name, g, p in (("block_sparse_attention", o, po),
                                   ("block_sparse_dq", dq, pdq),
                                   ("block_sparse_dkdv", torch.cat((dk, dv)), torch.cat((pdk, pdv)))):
                    e = (g - p).abs().max().item()
                    if name == "block_sparse_attention":
                        e = max(e, (lse - plse).abs().max().item())
                    worst[name] = max(worst.get(name, 0.0), e)

    rows = {name: {"name": name, "route": "cuda",
                   "source": "dalle_pytorch_tpu_torch/csrc/block_sparse_attention.cu",
                   "replaces": BS_TPU_KERNELS[name], "max_abs_err": worst[name]}
            for name in BS_TPU_KERNELS}
    for case in ("axial_row", "conv_like"):  # the training path's type
        q, k, v, do, layout, km = bs_inputs(case, torch.float32, "cuda", seed=1)
        o, lse = bs.block_sparse_attention(q, k, v, layout)
        dq, delta = bs.block_sparse_dq(q, k, v, o, lse, do, layout)
        t = {
            "block_sparse_attention": (
                lambda: bs.block_sparse_attention(q, k, v, layout),
                lambda: bs.reference_block_sparse(q, k, v, layout)),
            "block_sparse_dq": (
                lambda: bs.block_sparse_dq(q, k, v, o, lse, do, layout),
                lambda: bs.reference_block_sparse_dq(q, k, v, o, lse, do, layout)),
            "block_sparse_dkdv": (
                lambda: bs.block_sparse_dkdv(q, k, v, do, lse, delta, layout),
                lambda: bs.reference_block_sparse_dkdv(q, k, v, do, lse, delta, layout)),
        }
        bounds = bs_bounds(q, layout, None)
        times = {name: (cuda_time_ms(kernel, iters=20), cuda_time_ms(plain, iters=5))
                 for name, (kernel, plain) in t.items()}
        # yardsticks: sdpa with the boolean pattern mask on the same heads
        allowed = bs.may_attend(layout, layout.n, q.device)  # (1, 1, n, n)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=allowed)
        sdpa_ms = cuda_time_ms(sdpa, iters=20)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=allowed)
        sdpa_bwd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=20)
        # the alternative path: the packed kernels with the same pattern
        # operand, rotary in-kernel, on the packed projection
        b, h, n, d = q.shape
        qkv = torch.cat([x.transpose(1, 2).reshape(b, n, h * d) for x in (q, k, v)], -1)
        table = dalle_rotary_table(d, FLAGSHIP["text_seq_len"] + 1, FLAGSHIP["image_fmap_size"])
        popts = dict(pattern_mask=allowed[0, 0], rot=rot_tables(torch.from_numpy(table).cuda(),
                                                                n, d, torch.float32))
        po, plse = fa.fused_qkv_attention(qkv, h, d, **popts)
        pdo = do.transpose(1, 2).reshape(b, n, h * d).contiguous()
        packed_ms = cuda_time_ms(lambda: fa.fused_qkv_attention(qkv, h, d, **popts), iters=20)
        packed_bwd_ms = cuda_time_ms(
            lambda: fa.fused_qkv_attention_bwd(qkv, po, plse, pdo, h, d, **popts), iters=20)
        fwd = times["block_sparse_attention"][0]
        bwd = times["block_sparse_dq"][0] + times["block_sparse_dkdv"][0]
        log(f"block_sparse {case} float32 timing, cold L2 (b {b}, {h} x {d}, n {n}, "
            f"{layout.n_pairs} block pairs): " + "; ".join(
                f"{name} {times[name][0]:.4f} ms (plain {times[name][1]:.4f}, bound "
                f"{bounds[name][0]:.4f} {bounds[name][1]})" for name in t)
            + f"; sdpa with the mask forward {sdpa_ms:.4f} / backward {sdpa_bwd_ms:.4f} ms; "
            f"packed-qkv with the pattern forward {packed_ms:.4f} / backward "
            f"{packed_bwd_ms:.4f} ms against the pair grid's {fwd:.4f} / {bwd:.4f} ms")
        for name in t:
            row = rows[name]
            prefix = "" if case == "axial_row" else "conv_like_"
            row.update({f"{prefix}ms": times[name][0], f"{prefix}plain_ms": times[name][1],
                        f"{prefix}bound_ms": bounds[name][0],
                        f"{prefix}bound_by": bounds[name][1]})
            if case == "axial_row":
                row["library_ms"] = sdpa_ms if name == "block_sparse_attention" else None
                row["sdpa_backward_ms"] = sdpa_bwd_ms
                row["packed_pattern_ms"] = (packed_ms if name == "block_sparse_attention"
                                            else packed_bwd_ms)
    return [rows[name] for name in BS_TPU_KERNELS]


def flash_bounds(q, opts) -> dict:
    """{kernel: (bound_ms, bound_by)} of the four tiled flash kernels on
    these inputs (``pair_bounds``), the key mask, pattern and visit map as
    passed."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    b, _, n, _ = q.shape
    km, pattern = opts["key_mask"], opts["pattern"]
    extra = (n // fa.TILE) ** 2 + (0 if km is None else b * n) + (0 if pattern is None else n * n)
    bounds = pair_bounds(q, fa.may_attend(n, q.device, km, opts["causal"], pattern), extra)
    return {name: bounds[role] for name, role in zip(FLASH_TPU_KERNELS,
                                                     ("fwd", "dq", "dkdv", "fused"))}


def run_flash(q, k, v, do, opts):
    """The four tiled kernels, dk/dv on dq's delta: (o, lse, dq, delta,
    dk, dv, and the single-block kernel's dq, dk, dv)."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    dq, delta = fa.flash_attention_dq(q, k, v, o, lse, do, **opts)
    dk, dv = fa.flash_attention_dkdv(q, k, v, do, lse, delta, **opts)
    return (o, lse, dq, delta, dk, dv, *fa.flash_attention_bwd_fused(q, k, v, o, lse, do, **opts))


def sdpa_flash_backward(q, k, v, do, opts):
    """A function that runs the backward of one
    ``scaled_dot_product_attention`` on the same heads and mask (the
    yardstick: dq, dk and dv together), from a graph built once."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, **sdpa_flash_kw(q, opts))
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def sdpa_flash_kw(q, opts) -> dict:
    """The keyword arguments that give ``scaled_dot_product_attention``
    the tiled kernels' mask and scale."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    kw = dict(scale=q.shape[-1] ** -0.5)
    if opts["key_mask"] is None and opts["pattern"] is None:
        kw["is_causal"] = opts["causal"]
    else:
        kw["attn_mask"] = fa.may_attend(q.shape[2], q.device, opts["key_mask"], opts["causal"],
                                        opts["pattern"])
    return kw


def check_flash_attention() -> list:
    """The four tiled flash kernels against their plain versions on
    ``testing.flash_inputs`` (the 512 px training shape, its axial_col
    pattern, a pattern, non-causal and dim_head 32/64/96/128 at small n
    with a key mask that kills whole rows, n 1152, one flash block of
    1280), float32 and bfloat16, each kernel chain against the plain one,
    at ``testing``'s tolerances; dead rows exactly 0 and lse -1e30; two
    runs bit-identical. Then timings (cold L2) at each kernel's main-path
    shape in float32 (the forward, dq and dk/dv at the 512 px training
    shape, the single-block backward at one block of 1280): the kernel,
    its plain version, the bound, and ``scaled_dot_product_attention``
    forward (the forward's yardstick) and backward (dq, dk and dv
    together: the backward kernels' yardstick) on the same heads."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.testing import (
        BWD_BF16_ROW_REL, BWD_F32_REL, FLASH_BF16_ROW_REL, FLASH_F32_ATOL, flash_bwd_errors,
        flash_fwd_errors, flash_inputs)

    worst = {}  # name -> max abs error at its main path's shape, float32
    for case in ("train", "axial_col", "pattern", "noncausal", "d32", "d64", "d96", "d128",
                 "tiled", "one_block"):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, opts = flash_inputs(case, dtype, "cuda")
            got = run_flash(q, k, v, do, opts)
            again = run_flash(q, k, v, do, opts)
            po, plse = fa.reference_flash_attention(q, k, v, **opts)
            plain = fa.reference_flash_attention_bwd(q, k, v, po, plse, do, **opts)
            torch.cuda.synchronize()
            o, lse, dq, delta, dk, dv, fdq, fdk, fdv = got
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"tiled flash kernels: non-finite output ({case}, {dtype})")
            err, row_rel, lse_err, dead_exact = flash_fwd_errors(o, lse, po, plse, **opts)
            rel, grad_row_rel, zeros_exact = flash_bwd_errors((dq, dk, dv), plain, **opts)
            frel, fgrad_row_rel, fzeros_exact = flash_bwd_errors((fdq, fdk, fdv), plain, **opts)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if dtype == torch.float32:
                ok = err <= FLASH_F32_ATOL and max(rel, frel) <= BWD_F32_REL
                tol = f"abs {FLASH_F32_ATOL:.0e} forward, relative {BWD_F32_REL:.0e} backward"
            else:
                ok = (row_rel <= FLASH_BF16_ROW_REL and lse_err <= FLASH_BF16_ROW_REL
                      and max(grad_row_rel, fgrad_row_rel) <= BWD_BF16_ROW_REL)
                tol = (f"row-relative {FLASH_BF16_ROW_REL:.0e} and lse abs "
                       f"{FLASH_BF16_ROW_REL:.0e} forward, floored row-relative "
                       f"{BWD_BF16_ROW_REL:.0e} backward")
            log(f"flash {case} {dtype} {tuple(q.shape)}: forward max abs {err:.3e}, row "
                f"{row_rel:.3e}; dq + dk/dv relative L2 {rel:.3e}, floored row "
                f"{grad_row_rel:.3e}; single-block relative L2 {frel:.3e}, floored row "
                f"{fgrad_row_rel:.3e}; dead rows exactly 0 "
                f"{dead_exact and zeros_exact and fzeros_exact}; two runs identical {same} "
                f"(tolerance: {tol})")
            if not (ok and dead_exact and zeros_exact and fzeros_exact and same):
                raise AssertionError(f"tiled flash kernels disagree with plain: {case} {dtype}")
            if dtype == torch.float32 and case in ("train", "one_block"):
                pdq, pdk, pdv = plain
                errors = {
                    "flash_attention_fwd": max((o - po).abs().max().item(),
                                               (lse - plse).abs().max().item()),
                    "flash_attention_dq": (dq - pdq).abs().max().item(),
                    "flash_attention_dkdv": max((dk - pdk).abs().max().item(),
                                                (dv - pdv).abs().max().item()),
                    "flash_attention_bwd_fused": max((a - b).abs().max().item() for a, b in
                                                     ((fdq, pdq), (fdk, pdk), (fdv, pdv))),
                }
                keep = ("flash_attention_bwd_fused",) if case == "one_block" else tuple(
                    FLASH_TPU_KERNELS)[:3]
                worst.update({name: errors[name] for name in keep})
            del got, again, plain, po, plse

    rows = {name: {"name": name, "route": "cuda",
                   "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
                   "replaces": FLASH_TPU_KERNELS[name], "max_abs_err": worst[name]}
            for name in FLASH_TPU_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, opts = flash_inputs("train", dtype, "cuda", seed=1)
        o, lse = fa.flash_attention_fwd(q, k, v, **opts)
        dq, delta = fa.flash_attention_dq(q, k, v, o, lse, do, **opts)
        t = {
            "flash_attention_fwd": (
                lambda: fa.flash_attention_fwd(q, k, v, **opts),
                lambda: fa.reference_flash_attention(q, k, v, **opts)),
            "flash_attention_dq": (
                lambda: fa.flash_attention_dq(q, k, v, o, lse, do, **opts),
                lambda: fa.reference_flash_attention_dq(q, k, v, o, lse, do, **opts)),
            "flash_attention_dkdv": (
                lambda: fa.flash_attention_dkdv(q, k, v, do, lse, delta, **opts),
                lambda: fa.reference_flash_attention_dkdv(q, k, v, do, lse, delta, **opts)),
        }
        if dtype == torch.bfloat16:  # the kernels alone, beside the float32 path
            for name, (kernel, _) in t.items():
                rows[name]["ms_bf16"] = cuda_time_ms(kernel, iters=10)
            continue
        bounds = flash_bounds(q, opts)
        sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, **sdpa_flash_kw(q, opts)), iters=10)
        sdpa_bwd_ms = cuda_time_ms(sdpa_flash_backward(q, k, v, do, opts), iters=10)
        for name, (kernel, plain) in t.items():
            rows[name].update(ms=cuda_time_ms(kernel, iters=10),
                              plain_ms=cuda_time_ms(plain, warmup=1, iters=3),
                              bound_ms=bounds[name][0], bound_by=bounds[name][1],
                              library_ms=sdpa_ms if name == "flash_attention_fwd"
                              else sdpa_bwd_ms)
    q, k, v, do, opts = flash_inputs("one_block", torch.float32, "cuda", seed=1)
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    name = "flash_attention_bwd_fused"
    bound_ms, bound_by = flash_bounds(q, opts)[name]
    rows[name].update(
        ms=cuda_time_ms(lambda: fa.flash_attention_bwd_fused(q, k, v, o, lse, do, **opts),
                        iters=20),
        plain_ms=cuda_time_ms(lambda: fa.reference_flash_attention_bwd(q, k, v, o, lse, do,
                                                                       **opts), iters=5),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=cuda_time_ms(sdpa_flash_backward(q, k, v, do, opts), iters=20))
    for name, row in rows.items():
        shape = "b 2, 3 x 64, n 1280" if name == "flash_attention_bwd_fused" else \
            "b 4, 16 x 64, n 4352"
        sdpa = "forward" if name == "flash_attention_fwd" else "backward"
        log(f"{name} float32 timing, cold L2 ({shape}, causal): kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, sdpa {sdpa} {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
            + (f"; bf16 kernel {row['ms_bf16']:.4f} ms" if "ms_bf16" in row else ""))
    return [rows[name] for name in FLASH_TPU_KERNELS]


def decode_bound(b: int, L: int, h: int, d: int, idx: int, dtype, masked: bool = False):
    """(bound_ms, bound_by) of one fused decode step: bytes = the K and V
    rows [0, idx) of every head, the qkv row, one cos and one sin row, the
    key mask's rows [0, idx] when given, and out, k_row and v_row, each
    once; operations = 2 * 2 * d per (head, live key) of the idx + 1 keys
    (scores and value products)."""
    item = torch.tensor([], dtype=dtype).element_size()
    hd = h * d
    nbytes = (2 * idx * hd + 3 * hd + 3 * hd) * b * item + 2 * d * item
    nbytes += 4 * b * (idx + 1) if masked else 0
    ops = 4 * b * h * (idx + 1) * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_decode_attention() -> dict:
    """The fused decode kernel against its plain version on
    ``testing.decode_inputs`` at the flagship's shapes (16 heads of 64, L
    1281, b 1 and b 8, idx 0, 1, 256, 700 and 1279, rotary on and off,
    key mask on and off), the masked own key with an extreme score, and
    dim_head 32 / 128 (b 8, idx 700, rotary, key mask), float32 and
    bfloat16, at ``testing``'s tolerances: k_row and v_row bitwise, rows
    with no live key exactly 0, two runs identical. Then times (cold L2)
    at b 1 and b 8, idx 768, bf16, rotary, no key mask (the generate
    path's): the kernel, its plain version, the bound, and
    ``scaled_dot_product_attention`` over the written cache view (b, h,
    idx + 1, d) as a yardstick (attention alone, no rotary)."""
    from dalle_pytorch_tpu_torch.ops import decode_attention as da
    from dalle_pytorch_tpu_torch.testing import (
        DECODE_BF16_ROW_REL, DECODE_F32_ATOL, decode_errors, decode_inputs, decode_ok)

    L, h = 1281, 16
    cases = [(b, 64, idx, rot, masked, False) for b in (1, 8) for idx in (0, 1, 256, 700, 1279)
             for rot in (True, False) for masked in (False, True)]
    cases += [(8, 64, 700, True, False, True), (1, 64, 256, False, False, True)]
    cases += [(8, d, 700, True, True, False) for d in (32, 128)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    groups = {}  # (b, d, own) -> [f32 max abs, bf16 row-relative, cases]
    made = {}  # inputs with rotary and a key mask, one set per (b, d, dtype)
    for b, d, idx, rot, masked, own in cases:
        for dtype in (torch.float32, torch.bfloat16):
            if own:
                x = decode_inputs(b, L, h, d, idx, dtype, "cuda", rotary=rot, own_masked=True)
            else:
                if (b, d, dtype) not in made:
                    made[b, d, dtype] = decode_inputs(b, L, h, d, 0, dtype, "cuda",
                                                      masked=True)
                x = made[b, d, dtype]
                x = (*x[:3], *(x[3:5] if rot else (None, None)), x[5] if masked else None)
            args = (x[0], x[1], x[2], idx, x[3], x[4], x[5])
            got = da.fused_decode_attention(*args, heads=h)
            again = da.fused_decode_attention(*args, heads=h)
            plain = da.reference_fused_decode(*args, h)
            torch.cuda.synchronize()
            err, rel, rows_equal, dead_zero = decode_errors(got, plain, x[5], idx)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            finite = all(torch.isfinite(t).all() for t in got)
            if not (decode_ok(dtype, err, rel, rows_equal, dead_zero) and same and finite):
                raise AssertionError(
                    f"decode kernel disagrees with plain: b {b} d {d} idx {idx} rotary {rot} "
                    f"mask {masked} own key masked {own} {dtype}: max abs {err:.3e}, "
                    f"row-relative {rel:.3e}, k/v rows bitwise {rows_equal}, dead rows 0 "
                    f"{dead_zero}, two runs identical {same}, finite {finite}")
            g = groups.setdefault((b, d, own), [0.0, 0.0, 0])
            g[0 if dtype == torch.float32 else 1] = max(
                g[0 if dtype == torch.float32 else 1], err if dtype == torch.float32 else rel)
            g[2] += 1
            if d == 64:
                worst[dtype] = max(worst[dtype], err if dtype == torch.float32 else rel)
    for (b, d, own), (f32, bf16, n) in groups.items():
        log(f"decode kernel vs plain, b {b}, 16 x {d}, L {L}{', own key masked' if own else ''}"
            f" ({n} cases: idx, rotary, key mask, float32 and bf16): float32 max abs {f32:.3e} "
            f"(tolerance {DECODE_F32_ATOL:.0e}), bf16 row-relative {bf16:.3e} (tolerance "
            f"{DECODE_BF16_ROW_REL:.0e}); k/v rows bitwise, rows with no live key 0, two runs "
            "identical")
    row = {"name": "fused_decode_attention", "route": "cuda",
           "source": "dalle_pytorch_tpu_torch/csrc/decode_attention.cu",
           "replaces": DECODE_TPU_KERNEL, "max_abs_err": worst[torch.float32],
           "max_rel_err_bf16": worst[torch.bfloat16]}
    idx = 768
    for b in (1, 8):
        qkv, kc, vc, cos, sin, _ = decode_inputs(b, L, h, 64, idx, torch.bfloat16, "cuda",
                                                 seed=1)
        args = (qkv, kc, vc, idx, cos, sin, None)
        kernel_ms = cuda_time_ms(lambda: da.fused_decode_attention(*args, heads=h))
        plain_ms = cuda_time_ms(lambda: da.reference_fused_decode(*args, h))
        q = qkv[..., :h * 64].view(b, 1, h, 64).transpose(1, 2)
        kv = [t.view(b, L, h, 64)[:, :idx + 1].transpose(1, 2) for t in (kc, vc)]
        library_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, *kv))
        bound_ms, bound_by = decode_bound(b, L, h, 64, idx, torch.bfloat16)
        log(f"fused_decode_attention bf16 timing, cold L2 (b {b}, 16 x 64, idx {idx}, L {L}, "
            f"rotary): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        timing = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
        row.update(timing if b == 1 else {f"{k}_b8": v for k, v in timing.items()})
    return row


# ------------------------------------------------------------ path check


def check_path_against_plain(kv_quant=None, attn_types=None) -> None:
    """Small float32 DALLE with identical weights on the card and the CPU
    through mixed ragged iterations (prefill chunks, a prompt's final
    chunk, decode rows across page boundaries, idle rows): the card runs
    the kernels, the CPU the plain versions; logits of active rows agree
    to 1e-3 (int8 pages: 5e-3, since a K/V entry that the card and the CPU
    compute a rounding apart can land one int8 level apart). ``kv_quant``
    "int8": int8 pages, every full layer's ragged attention through the
    int8 instance; ``attn_types``: the layers' type cycle (non-"full"
    layers attend over the gathered view, no kernel). The ragged instance
    of the pages' format launches once per full layer and step, the
    other never."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache

    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, num_text_tokens=50,
               text_seq_len=8, num_image_tokens=40, image_fmap_size=4)
    if attn_types:
        cfg.update(depth=4, attn_types=attn_types)
    gpu = DALLE(**cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(3))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    caches = {m: init_decode_cache(m, 3, page_size=4, kv_quant=kv_quant) for m in (gpu, cpu)}
    rng = np.random.RandomState(4)
    # (start, length) per row, width 4, prompt of 9 positions
    steps = [([0, 0, 2], [4, 4, 0]), ([4, 4, 0], [4, 4, 4]), ([8, 8, 4], [1, 1, 4]),
             ([9, 9, 8], [1, 1, 1]), ([10, 7, 9], [1, 0, 1]), ([11, 10, 10], [1, 1, 1])]
    worst = 0.0
    zero_counts()
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
    launched = read_counts(RAGGED)
    full = sum(t == "full" for t in gpu.transformer.attn_types) * len(steps)
    expected = {n: full if n.endswith("int8") == (kv_quant == "int8") else 0 for n in RAGGED}
    tol = 5e-3 if kv_quant == "int8" else 1e-3
    log(f"path check: card (kernel) vs CPU (plain) fused_step logits, pages "
        f"{kv_quant or 'none'}, layers {gpu.transformer.attn_types}: max abs diff "
        f"{worst:.3e} (tolerance {tol:.0e}); launches {launched}")
    if not (worst <= tol and launched == expected):
        raise AssertionError(f"card path disagrees with the plain path: {worst}, {launched}")


def check_preemption_on_card() -> None:
    """Page pressure on the card: a small float32 DALLE (prompt 9, 16
    image tokens, page 4: 6 pages of worst-case demand) serving 4
    requests at max_batch 3 under a budget of 12 pages, whose growth
    wants 18; unquantized and int8. At least one preemption, every
    outcome COMPLETED, every page back in the pool, and tokens
    bit-identical to the same requests served without pressure on the
    card (top-k sampling with the seeded noise)."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Outcome, Request

    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, num_text_tokens=50,
               text_seq_len=8, num_image_tokens=40, image_fmap_size=4)
    model = DALLE(**cfg, device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(9))
    prompts = np.random.RandomState(10).randint(1, 50, size=(4, 8))
    for kv_quant in (None, "int8"):
        runs = {}
        for budget in (None, 12):
            engine = Engine(model, EngineConfig(max_batch=3, prefill_chunk=4, page_size=4,
                                                page_budget=budget, kv_quant=kv_quant,
                                                filter_thres=0.5), device="cuda")
            for i in range(4):
                assert engine.submit(Request(f"q{i}", prompts[i], 16, seed=20 + i)) is None
            runs[budget] = engine.run(max_steps=2000)
            if engine.pool.used != 0 or any(engine.slots):
                raise AssertionError(f"preemption ({kv_quant}): pages left in use")
        pressured = runs[12]
        preempted = {r: x.preempt_count for r, x in pressured.items()}
        same = all(np.array_equal(x.tokens, runs[None][r].tokens) for r, x in pressured.items())
        done = all(x.outcome is Outcome.COMPLETED and len(x.tokens) == 16
                   for run in runs.values() for x in run.values())
        log(f"preemption on the card, pages {kv_quant or 'none'}: preempt counts {preempted}, "
            f"every outcome COMPLETED {done}, tokens bit-identical to the unpressured run "
            f"{same}")
        if not (done and same and sum(preempted.values()) >= 1):
            raise AssertionError(f"preemption on the card ({kv_quant}) failed")


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


def check_decode_against_plain() -> None:
    """Small float32 DALLEs, identical weights on the card (kernels) and
    the CPU (plain versions), generation outside the engine with
    ``fused_decode``: depth 2, 2 heads of 64, text 8 + a 4 x 4 grid (L
    25), batch 2. ``decode_step`` logits at every position (teacher-forced,
    a text key mask) agree to 1e-4 on the "4d" and "flat" caches, the
    decode kernel launched exactly depth x positions times; on the
    "paged" cache, with text 80 and no key mask (an 81-column prompt
    block, two query tiles of the ragged kernel), ``prefill_step`` then ``decode_step``
    logits agree to 1e-4, the ragged kernel launched depth x (1 + decode
    steps) times and the decode kernel never; greedy
    ``generate_image_tokens`` ("4d", ``window_seg=0``) tokens equal on the card
    and the CPU, the kernel launched depth x decode steps times; a model
    with 4 heads of 16 (outside ``fused_decode_supported``) never launches
    it."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import generate_image_tokens, init_decode_cache

    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, num_text_tokens=50, text_seq_len=8,
               num_image_tokens=40, image_fmap_size=4)
    gpu = DALLE(**cfg, device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(11))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.RandomState(12)
    text = rng.randint(1, 50, size=(2, 8))
    text[1, 5:] = 0
    ids = np.concatenate((gpu.remap_text(torch.from_numpy(text)).numpy(),
                          rng.randint(0, 40, size=(2, 16))), 1)[:, :gpu.total_seq_len]
    n = ids.shape[1]
    for fmt in ("4d", "flat"):
        logits = {}
        for m in (gpu, cpu):
            zero_counts()
            cache = init_decode_cache(m, 2, fmt)
            mask = torch.from_numpy(text != 0).to(m.device)
            logits[m] = torch.stack([
                m.decode_step(torch.from_numpy(ids[:, i]).to(m.device), i, cache, mask,
                              fused_decode=True) for i in range(n)], 1).cpu()
            if m is gpu:
                launched = read_counts(DECODE)["fused_decode_attention"]
        worst = (logits[gpu] - logits[cpu]).abs().max().item()
        log(f"path check: card (kernel) vs CPU (plain) decode_step logits, cache {fmt}, every "
            f"position with a text key mask: max abs diff {worst:.3e} (tolerance 1e-4); decode "
            f"kernel launches {launched} (expected {cfg['depth'] * n})")
        if not (worst <= 1e-4 and launched == cfg["depth"] * n):
            raise AssertionError(f"decode path disagrees: {fmt} {worst} {launched}")
    check_paged_prompt_against_plain(cfg)
    tokens = {}
    for m in (gpu, cpu):
        zero_counts()
        tokens[m] = generate_image_tokens(m, torch.from_numpy(text).to(m.device), 0,
                                          filter_thres=1.0, cache_format="4d",
                                          fused_decode=True, window_seg=0).cpu()
        if m is gpu:
            launched = read_counts(DECODE)["fused_decode_attention"]
    steps = gpu.image_seq_len - 1
    same = torch.equal(tokens[gpu], tokens[cpu])
    small = DALLE(**dict(cfg, dim=64, heads=4, dim_head=16), device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(13))
    zero_counts()
    generate_image_tokens(small, torch.from_numpy(text).cuda(), 0, cache_format="4d",
                          fused_decode=True, window_seg=0)
    small_launched = read_counts(DECODE)["fused_decode_attention"]
    log(f"path check: greedy generate_image_tokens card vs CPU, batch 2, cache 4d, "
        f"fused_decode, window 0: tokens equal {same}; "
        f"decode kernel launches {launched} (expected {cfg['depth'] * steps}); 4 heads of 16: "
        f"{small_launched} launches (expected 0)")
    if not (same and launched == cfg["depth"] * steps and small_launched == 0):
        raise AssertionError(f"generation path disagrees: {same}, {launched}, {small_launched}")


def check_paged_prompt_against_plain(cfg: dict) -> None:
    """``check_decode_against_plain``'s paged case: ``cfg`` with 80 text
    positions, so ``prefill_step`` sends the ragged kernel one block of 81
    columns (two query tiles), then a ``decode_step`` for each image
    position, with no key mask (a masked layer decodes through the gathered
    view, not the kernel); card (kernels) against CPU (plain versions),
    logits to 1e-4, exact launch counts."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache

    cfg = dict(cfg, text_seq_len=80)
    gpu = DALLE(**cfg, device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(14))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.RandomState(15)
    text = rng.randint(1, 50, size=(2, 80))
    text[1, 30:] = 0
    ids = torch.from_numpy(np.concatenate((gpu.remap_text(torch.from_numpy(text)).numpy(),
                                           rng.randint(0, 40, size=(2, 16))), 1))
    T, n = gpu.text_len_internal, gpu.total_seq_len
    logits = {}
    for m in (gpu, cpu):
        zero_counts()
        cache = init_decode_cache(m, 2, "paged")
        x = ids.to(m.device)
        out = [m.prefill_step(x[:, :T], cache)]
        out += [m.decode_step(x[:, i], i, cache, fused_decode=True) for i in range(T, n)]
        logits[m] = torch.stack(out, 1).cpu()
        if m is gpu:
            launched = read_counts(RAGGED + DECODE)
    want = {"ragged_attention": cfg["depth"] * (1 + n - T), "ragged_attention_int8": 0,
            "fused_decode_attention": 0}
    worst = (logits[gpu] - logits[cpu]).abs().max().item()
    log(f"path check: card vs CPU, cache paged, prompt block of {T} columns then {n - T} "
        f"decode steps: max abs logit diff {worst:.3e} (tolerance 1e-4); "
        f"launches {launched} (expected {want})")
    if not (worst <= 1e-4 and launched == want):
        raise AssertionError(f"paged prompt path disagrees: {worst} {launched}")


def start_ptxas_report(names) -> dict:
    """One ``nvcc -Xptxas -v`` compile (object only) per kernel source of
    ``names``, started now; ``log_ptxas_report`` reads them."""
    from dalle_pytorch_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return {name: subprocess.Popen(
        [cuda_build.nvcc(), *flags, "-c", "-Xptxas", "-v", "-o", str(out_dir / f"{name}.o"),
         str(cuda_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in names}


def log_ptxas_report(procs: dict, markers) -> None:
    """Registers, shared memory and spills that ptxas reports for each
    entry function whose mangled name holds one of ``markers``; raises if
    a compile failed."""
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(m in line for m in markers):
                fn = line.split("'")[1]
                about = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                         if "spill" in x or "registers" in x]
                log(f"ptxas {name}.cu {fn}: " + "; ".join(about))


def log_sass_report(names) -> None:
    """Tensor-core instructions in the built libraries of ``names``, from
    ``cuobjdump -sass``: per entry function whose name holds
    "_tc_kernel" or "_tf32_kernel", the count of HMMA instructions by
    mnemonic. Raises unless every "_tf32_kernel" function (the packed
    kernels' float32 instances) holds TF32 HMMA."""
    from dalle_pytorch_tpu_torch.ops import cuda_build

    cuobjdump = Path(cuda_build.nvcc()).parent / "cuobjdump"
    missing = []
    for name in names:
        out = subprocess.run([str(cuobjdump), "-sass", str(cuda_build.library_path(name))],
                             check=True, capture_output=True, text=True, timeout=300).stdout
        counts, fn = {}, None
        for line in out.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = {}
            elif fn is not None and "HMMA" in line:
                op = next(w for w in line.split() if w.startswith("HMMA"))
                counts[fn][op] = counts[fn].get(op, 0) + 1
        for fn, ops in counts.items():
            if "_tc_kernel" not in fn and "_tf32_kernel" not in fn:
                continue
            log(f"sass {name} {fn}: " + (", ".join(f"{op} x{c}" for op, c in sorted(ops.items()))
                                         or "no HMMA"))
            if "_tf32_kernel" in fn and not any("TF32" in op for op in ops):
                missing.append(fn)
    if missing:
        raise AssertionError(f"float32 instances without TF32 HMMA: {missing}")


def kernel_counters():
    """{name: wrapper} of every kernel wrapper that counts its launches."""
    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
    from dalle_pytorch_tpu_torch.ops import decode_attention as da
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import ragged_attention as ra

    return {"ragged_attention": ra.kernel_attend,
            "ragged_attention_int8": ra.kernel_attend_int8,
            "fused_qkv_attention": fa.fused_qkv_attention,
            "fused_qkv_attention_bwd": fa.fused_qkv_attention_bwd,
            "block_sparse_attention": bs.block_sparse_attention,
            "block_sparse_dq": bs.block_sparse_dq,
            "block_sparse_dkdv": bs.block_sparse_dkdv,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkdv": fa.flash_attention_dkdv,
            "flash_attention_bwd_fused": fa.flash_attention_bwd_fused,
            "fused_decode_attention": da.fused_decode_attention}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts(names) -> dict:
    counters = kernel_counters()
    return {name: counters[name].launches for name in names}


RAGGED = ("ragged_attention", "ragged_attention_int8")
PACKED = ("fused_qkv_attention", "fused_qkv_attention_bwd")
PAIR_GRID = ("block_sparse_attention", "block_sparse_dq", "block_sparse_dkdv")
TILED = tuple(FLASH_TPU_KERNELS)  # forward, dq, dk/dv, single-block backward
TILED_SPLIT = TILED[:3]
DECODE = ("fused_decode_attention",)


def check_train_against_plain(variant: str = "dense") -> dict:
    """Small float32 DALLE, identical weights on the card (kernels) and the
    CPU (plain versions): the loss to relative 1e-5 and every parameter's
    gradient to 1e-4 of its largest entry, and each kernel launched
    exactly as the variant's attention path says (every other kernel
    never). "dense": depth 2, 2 heads of 64, text 64 + an 8 x 8 grid (n
    128; token shift, rotary), each packed kernel once per layer.
    "sparse": depth 4 cycling the four types, text 64 + a 24 x 24 grid (n
    640, where the axial_row and conv_like layouts visit 12 of 15 block
    pairs and engage): the three block-sparse kernels once per axial_row
    and conv_like layer, the packed ones once per full and axial_col
    layer. "tiled": text 128 + a 32 x 32 grid (n 1152, 3 x 3 flash blocks
    of 384): the tiled forward, dq and dk/dv once per layer. "one_block":
    3 heads, text 128 + a 16 x 16 grid (n 384, one flash block the packed
    kernel refuses): the tiled forward and the single-block backward once
    per layer. Returns the card run's launches."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, num_text_tokens=50,
               text_seq_len=64, num_image_tokens=40, image_fmap_size=8)
    per_layer = {name: 1 for name in PACKED}
    if variant == "sparse":
        cfg.update(depth=4, image_fmap_size=24, attn_types=tuple(SPARSE_TYPES.split(",")))
        per_layer = {name: 0.5 for name in PACKED + PAIR_GRID}
    elif variant == "tiled":
        cfg.update(text_seq_len=128, image_fmap_size=32)
        per_layer = {name: 1 for name in TILED_SPLIT}
    elif variant == "one_block":
        cfg.update(heads=3, text_seq_len=128, image_fmap_size=16)
        per_layer = {"flash_attention_fwd": 1, "flash_attention_bwd_fused": 1}
    gpu = DALLE(**cfg, device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(7))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.RandomState(8)
    text = rng.randint(1, 50, size=(2, cfg["text_seq_len"]))
    text[0, 40:], text[1, 9:] = 0, 0
    image = rng.randint(0, 40, size=(2, cfg["image_fmap_size"] ** 2))
    losses, grads = {}, {}
    names = tuple(kernel_counters())
    for m in (gpu, cpu):
        zero_counts()
        t, i = (torch.from_numpy(a).to(m.device) for a in (text, image))
        loss = m(t, i, return_loss=True)
        loss.backward()
        losses[m] = loss.item()
        grads[m] = {k: p.grad.cpu() for k, p in m.named_parameters()}
        if m is gpu:
            launched = read_counts(names)
    loss_rel = abs(losses[gpu] - losses[cpu]) / abs(losses[cpu])
    worst = max((grads[gpu][k] - g).abs().max().item() / g.abs().max().item()
                for k, g in grads[cpu].items())
    expected = {n: int(per_layer.get(n, 0) * cfg["depth"]) for n in names}
    log(f"path check: card (kernels) vs CPU (plain) DALLE training loss ({variant}, n "
        f"{gpu.total_seq_len}, {cfg['heads']} heads), relative {loss_rel:.3e}; worst gradient "
        f"error {worst:.3e} of its largest entry; launches "
        f"{ {n: c for n, c in launched.items() if c or expected[n]} }")
    if not (loss_rel <= 1e-5 and worst <= 1e-4 and launched == expected):
        raise AssertionError(f"training path disagrees: {loss_rel}, {worst}, {launched}, "
                             f"expected {expected}")
    return {name: n for name, n in launched.items() if n}


# --------------------------------------------------------------- engine


def serve_flagship():
    from dalle_pytorch_tpu_torch.models.clip import CLIP
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.postdecode import STAGE_RERANK, StageConfig, StageSpec
    from dalle_pytorch_tpu_torch.serving.types import Outcome

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
    for request in serve_requests(N_REQUESTS, MAX_NEW):
        assert engine.submit(request) is None
    torch.cuda.synchronize()
    log(f"engine: flagship DALLE, VAE and CLIP built in {time.perf_counter() - t0:.1f} s")

    zero_counts()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts((*RAGGED, "fused_qkv_attention"))

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
                "ragged_attention_int8": 0,
                "fused_qkv_attention": FLAGSHIP_CLIP["text_enc_depth"] * rerank_dispatches}
    stage_s = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(pipe.seconds.items()))
    log(f"engine: {N_REQUESTS} requests, {engine.iterations} iterations, "
        f"{engine.dispatches} dispatches, {wall:.2f} s wall (stages included), "
        f"{N_REQUESTS * MAX_NEW / wall:.1f} generated tokens/s; stage seconds: "
        f"{stage_s}; counters {dict(sorted(pipe.counters.items()))}")
    log(f"engine: launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    return results, launches, model, engine


def serve_requests(n: int, max_new: int, seed: int = 0):
    """The serve phases' requests: seeded prompts with ragged lengths
    (request i keeps 256 - 23 i tokens), request i drawing with seed i;
    the first n of one fixed set, so phases with fewer requests serve the
    same ones."""
    from dalle_pytorch_tpu_torch.serving.types import Request

    prompts = np.random.RandomState(seed).randint(
        1, FLAGSHIP["num_text_tokens"], size=(N_REQUESTS, FLAGSHIP["text_seq_len"]))
    for i in range(N_REQUESTS):
        prompts[i, FLAGSHIP["text_seq_len"] - 23 * i:] = 0  # ragged prompt lengths
    return [Request(f"r{i}", prompts[i], max_new, seed=i) for i in range(n)]


def pool_bytes(engine) -> int:
    """Bytes of every K/V pool of the engine's cache, sink pages and scale
    pools included."""
    return sum(pool.numel() * pool.element_size()
               for kv in engine.cache.kv for pool in kv.pools())


def serve_counted(model, label: str, n: int, max_new: int, expected_per_dispatch: dict,
                  **config):
    """A counted serve run without stages: ``n`` of ``serve_requests``
    through a fresh engine (max_batch 8, chunk 16, ``config``), counts set
    to 0 just before and read just after. Every outcome COMPLETED with
    ``max_new`` tokens in the image vocab; each ragged instance launched
    ``expected_per_dispatch`` x dispatched iterations times. Prints
    tokens/s and peak memory; returns (engine, results, launches)."""
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Outcome

    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, EngineConfig(max_batch=MAX_BATCH, prefill_chunk=CHUNK, **config),
                    device="cuda")
    for request in serve_requests(n, max_new):
        assert engine.submit(request) is None
    zero_counts()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(RAGGED)
    for rid, r in results.items():
        if r.outcome is not Outcome.COMPLETED or len(r.tokens) != max_new:
            raise AssertionError(f"{label}: request {rid}: {r.outcome} {r.detail!r}")
        if not ((r.tokens >= 0) & (r.tokens < FLAGSHIP["num_image_tokens"])).all():
            raise AssertionError(f"{label}: request {rid}: token out of the image vocab")
    expected = {k: expected_per_dispatch.get(k, 0) * engine.dispatches for k in RAGGED}
    log(f"{label}: {n} requests of {max_new} tokens, {engine.iterations} iterations, "
        f"{engine.dispatches} dispatches, {wall:.2f} s wall, {n * max_new / wall:.1f} "
        f"generated tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    return engine, results, launches


def serve_int8(model, bf16_results, bf16_engine) -> dict:
    """Phase 5b: the flagship served with int8 pages, 8 of phase 5's
    requests without stages; every layer's ragged attention through the
    int8 instance, the unquantized one never. KV bytes per slot exactly
    (1024 + 16 x 4) / 2048 = 68/128 of the bf16 engine's; position-wise
    token agreement with the bf16 engine printed, not asserted (random
    weights diverge after the first near-tie). Returns the launches."""
    depth = FLAGSHIP["depth"]
    engine, results, launches = serve_counted(
        model, "serve int8", MAX_BATCH, MAX_NEW, {"ragged_attention_int8": depth},
        kv_quant="int8")
    int8_b, bf16_b = engine.kv_bytes_per_slot, bf16_engine.kv_bytes_per_slot
    agree = [float(np.mean(results[r].tokens == bf16_results[r].tokens)) for r in results]
    log(f"serve int8: KV bytes per slot {int8_b:,} against bf16's {bf16_b:,} (ratio "
        f"{int8_b / bf16_b:.5f}); KV pools {pool_bytes(engine) / 1e6:.1f} MB against "
        f"{pool_bytes(bf16_engine) / 1e6:.1f} MB; position-wise token agreement with the "
        f"bf16 engine per request " + ", ".join(f"{a:.4f}" for a in agree))
    if int8_b * 128 != bf16_b * 68:
        raise AssertionError(f"serve int8: KV bytes per slot {int8_b} is not 68/128 of {bf16_b}")
    return launches


def check_int8_logits(model) -> None:
    """Teacher-forced image logits of the flagship through int8 pages
    against bf16 pages, same model: a 256-token prompt in 16-token chunks,
    then 64 decode steps on the same image tokens, 2 rows; relative L2
    error within ``testing.INT8_LOGITS_REL``."""
    from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache
    from dalle_pytorch_tpu_torch.testing import INT8_LOGITS_REL, rel_l2, teacher_forced_logits

    rng = np.random.RandomState(5)
    text = torch.from_numpy(rng.randint(1, FLAGSHIP["num_text_tokens"],
                                        size=(2, FLAGSHIP["text_seq_len"])))
    image = torch.from_numpy(rng.randint(0, FLAGSHIP["num_image_tokens"], size=(2, 64)))
    out = {q: teacher_forced_logits(model, init_decode_cache(model, 2, kv_quant=q), text,
                                    image, CHUNK) for q in ("none", "int8")}
    rel = rel_l2(out["int8"], out["none"])
    top1 = (out["int8"].argmax(-1) == out["none"].argmax(-1)).float().mean().item()
    log(f"int8 logits: teacher-forced flagship (prompt 256, 64 decode steps, 2 rows), int8 "
        f"against bf16 pages: relative L2 error {rel:.4e} (tolerance {INT8_LOGITS_REL:.0e}), "
        f"argmax agreement {top1:.4f}")
    if not (torch.isfinite(out["int8"]).all() and rel <= INT8_LOGITS_REL):
        raise AssertionError(f"int8 logits: relative error {rel}")


def serve_sparse_int8() -> dict:
    """Phase 5c: the sparse configuration (layers cycling full, axial_row,
    axial_col, conv_like) at the flagship width, bf16, int8 pages, 4
    requests of 256 tokens: the 3 full layers through the int8 ragged
    instance, the others over the gathered view. Returns the launches."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    types = tuple(SPARSE_TYPES.split(","))
    model = DALLE(**FLAGSHIP, attn_types=types, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device="cuda").manual_seed(4))
    full = sum(t == "full" for t in model.transformer.attn_types)
    _, _, launches = serve_counted(model, "serve sparse int8", 4, 256,
                                   {"ragged_attention_int8": full}, kv_quant="int8")
    return launches


def log_device_profile(averages, label: str, what: str, unit: str, count: int,
                       wall_ms: float, top: int, watch=()) -> None:
    """Print a profiled window of ``count`` ``unit``s from its
    ``key_averages()``: wall and device-busy ms per ``unit``, device
    launches per ``unit``, and the ``top`` kernels by device time, then
    any other kernel whose name holds a string of ``watch``, with its
    rank."""
    device = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / count
    launches = sum(e.count for e in device) / count
    log(f"{label}: {count} {what}, {wall_ms:.3f} ms/{unit} wall, device busy {busy_ms:.3f} "
        f"ms/{unit} ({100 * busy_ms / wall_ms:.1f}% busy), {launches:.0f} device "
        f"launches/{unit}")
    ranked = sorted(device, key=lambda e: -e.self_device_time_total)
    for rank, e in enumerate(ranked, 1):
        if rank <= top or any(w in e.key for w in watch):
            log(f"{label}:   {e.self_device_time_total / 1e3 / count:.4f} ms/{unit} "
                f"x{e.count // count} (#{rank}) {e.key[:90]}")


def profile_iterations(model, warmup: int = 10, window: int = 15, kv_quant=None) -> None:
    """Where an engine iteration's time goes: torch.profiler over a window
    of a fresh mixed prefill/decode batch (8 requests at once, so one row
    decodes while the others prefill chunk by chunk), with ``kv_quant``
    pages. Prints wall time and device-busy time per iteration, launches
    per iteration, the largest device-time kernels and the ragged
    kernel's. Runs after the counted main path."""
    from torch.profiler import ProfilerActivity, profile

    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Request

    engine = Engine(model, EngineConfig(
        max_batch=MAX_BATCH, prefill_chunk=CHUNK, kv_quant=kv_quant,
    ), device="cuda")
    label = "profile" if kv_quant is None else f"profile {kv_quant}"
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
    averages = prof.key_averages()  # the slow part of a profile: aggregate once
    log_device_profile(averages, label, "mixed iterations", "iteration", window, wall_ms, 6,
                       watch=("ragged",))
    host = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU]
    log(f"{label}: host time by operator (self, ms/iteration, calls/iteration): " + "; ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3 / window:.3f} x{e.count // window}"
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]))


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


# ------------------------------------------------------------- generate


def generate_counted(label: str, fn, expected: dict, tokens: int):
    """``fn()`` with every kernel count set to 0 just before and read just
    after: each kernel of ``expected`` launched its count, every other
    never. Prints wall seconds, ms per generated token and tokens/s;
    returns (result, launches)."""
    names = tuple(kernel_counters())
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = read_counts(names)
    want = {n: expected.get(n, 0) for n in names}
    log(f"{label}: {wall:.2f} s wall, {1e3 * wall / tokens:.3f} ms per generated token, "
        f"{tokens / wall:.1f} generated tokens/s; launches "
        f"{ {n: c for n, c in launched.items() if c or want[n]} } (expected "
        f"{ {n: c for n, c in want.items() if c} })")
    if launched != want:
        raise AssertionError(f"{label}: kernel launches {launched}, expected {want}")
    return out, {n: c for n, c in launched.items() if c}


def check_image_tokens(label: str, tokens, b: int) -> None:
    if tokens.shape != (b, MAX_NEW) or not (
            (tokens >= 0) & (tokens < FLAGSHIP["num_image_tokens"])).all():
        raise AssertionError(f"{label}: {tuple(tokens.shape)} tokens, or one out of range")


def generate_flagship() -> dict:
    """Generation outside the engine at the flagship (bf16, seeded random
    weights; ``models/sampling.py``), each run counted:
    (a) batch 1 (the policy's "4d" cache), ``fused_decode=True``,
        ``window_seg=0``: ``generate_image_tokens`` of one seeded caption,
        1024 tokens in range, the decode kernel launched exactly 12 x 1023
        times (the 257-position prompt is one prefill block, then 1023
        decode steps) and no other kernel;
    (b) the same caption with ``fused_decode=False`` and the default
        window (the unfused chain, no kernel); token agreement with (a)
        printed; then (a)'s tokens teacher-forced through both (the
        prompt, then ``TEACHER_FORCED_STEPS`` decode steps: the sweep
        reaches position 512), the image logits of the kernel path within
        ``testing.DECODE_LOGITS_REL`` (relative L2) of the unfused chain's;
    (c) batch 8 (the policy's "flat" cache), ``fused_decode=True``,
        ``window_seg=0``: ``generate_images`` with the serve phase's VAE
        and CLIP, 8 finite (256, 256, 3) images and 8 finite scores, the
        decode kernel launched 12 x 1023 times and CLIP's text encoder the
        packed-qkv kernel once a layer;
    (d) batch 4 (the policy's "paged" cache), default arguments: the ragged
        kernel launched 12 x 1024 times (the prompt block, then every
        decode step), the decode kernel never.
    Then torch.profiler over 20 decode steps of (a). Returns the launches
    of each run."""
    from dalle_pytorch_tpu_torch.models.clip import CLIP
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import (
        generate_image_tokens, generate_images, init_decode_cache)
    from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
    from dalle_pytorch_tpu_torch.testing import DECODE_LOGITS_REL, rel_l2

    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    model = DALLE(**FLAGSHIP, **bf16).init_weights(gen(0))
    depth, T = FLAGSHIP["depth"], model.text_len_internal
    steps = MAX_NEW - 1
    captions = torch.from_numpy(np.random.RandomState(13).randint(
        1, FLAGSHIP["num_text_tokens"], size=(8, FLAGSHIP["text_seq_len"]))).cuda()
    captions[1::2, 200:] = 0  # every other caption with a zero tail
    text = captions[:1]
    launches = {}

    tokens_a, launches["generate_b1"] = generate_counted(
        "generate (a) batch 1, cache 4d, fused decode kernel, window 0",
        lambda: generate_image_tokens(model, text, 0, fused_decode=True, window_seg=0),
        {"fused_decode_attention": depth * steps}, MAX_NEW)
    check_image_tokens("generate (a)", tokens_a, 1)
    tokens_b, _ = generate_counted(
        "generate (b) batch 1, cache 4d, unfused chain, default window",
        lambda: generate_image_tokens(model, text, 0), {}, MAX_NEW)
    check_image_tokens("generate (b)", tokens_b, 1)
    agree = (tokens_a == tokens_b).float().mean().item()

    caches = {fused: init_decode_cache(model, 1, "4d") for fused in (True, False)}
    ids = torch.cat((model.remap_text(text), tokens_a), 1).to(torch.int32)
    logits = {}
    for fused, cache in caches.items():
        out = [model.prefill_step(ids[:, :T], cache, image_only=True)]
        out += [model.decode_step(ids[:, i], i, cache, image_only=True, fused_decode=fused)
                for i in range(T, T + TEACHER_FORCED_STEPS)]
        logits[fused] = torch.stack(out, 1)
    rel = rel_l2(logits[True], logits[False])
    top1 = (logits[True].argmax(-1) == logits[False].argmax(-1)).float().mean().item()
    log(f"generate (b): token agreement with (a) {agree:.4f} (printed, not asserted: random "
        f"weights diverge after the first near-tie); (a)'s tokens teacher-forced (prompt, then "
        f"{TEACHER_FORCED_STEPS} decode steps), image logits through the decode kernel against "
        f"the unfused chain: relative L2 {rel:.4e} (tolerance {DECODE_LOGITS_REL:.0e}), argmax "
        f"agreement {top1:.4f}")
    if not (torch.isfinite(logits[True]).all() and rel <= DECODE_LOGITS_REL):
        raise AssertionError(f"generate (b): kernel logits off the unfused chain by {rel}")
    del caches, logits

    vae = DiscreteVAE(**FLAGSHIP_VAE, **bf16).init_weights(gen(1))
    clip = CLIP(**FLAGSHIP_CLIP, **bf16).init_weights(gen(2))
    (images, scores), launches["generate_b8"] = generate_counted(
        "generate (c) batch 8, cache flat, fused decode kernel, window 0, VAE and CLIP",
        lambda: generate_images(model, vae, captions, 0, clip=clip, fused_decode=True,
                                window_seg=0),
        {"fused_decode_attention": depth * steps,
         "fused_qkv_attention": FLAGSHIP_CLIP["text_enc_depth"]}, 8 * MAX_NEW)
    size = FLAGSHIP_VAE["image_size"]
    if images.shape != (8, size, size, 3) or not torch.isfinite(images).all() or (
            scores.shape != (8,) or not torch.isfinite(scores).all()):
        raise AssertionError(f"generate (c): images {tuple(images.shape)}, scores {scores}")
    log(f"generate (c): 8 finite {tuple(images.shape[1:])} images, CLIP scores "
        + ", ".join(f"{x:.4f}" for x in scores.float().tolist()))
    tokens_d, launches["generate_b4_paged"] = generate_counted(
        "generate (d) batch 4, cache paged, default arguments",
        lambda: generate_image_tokens(model, captions[:4], 0),
        {"ragged_attention": depth * MAX_NEW}, 4 * MAX_NEW)
    check_image_tokens("generate (d)", tokens_d, 4)
    profile_decode(model, text)
    return launches


def profile_decode(model, text, window: int = 20) -> None:
    """Where a decode step of generation (a) goes: torch.profiler over 20
    ``decode_step`` calls at batch 1 on the "4d" cache with the decode
    kernel, after the prompt's prefill and 10 warm-up steps: wall and
    device-busy time per step, launches per step, the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache

    cache = init_decode_cache(model, 1, "4d")
    ids = model.remap_text(text).to(torch.int32)
    model.prefill_step(ids, cache, image_only=True)
    T = model.text_len_internal
    tok = torch.zeros(1, dtype=torch.int32, device="cuda")
    for i in range(T, T + 10):
        model.decode_step(tok, i, cache, image_only=True, fused_decode=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(T + 10, T + 10 + window):
            model.decode_step(tok, i, cache, image_only=True, fused_decode=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / window
    log_device_profile(prof.key_averages(), "generate profile", "decode steps at batch 1",
                       "step", window, wall_ms, 8)


# ---------------------------------------------------------------- train


def release_memory() -> None:
    """Free what earlier phases left: collect reference cycles, then
    return the allocator's cached blocks; prints what stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated after release")


def train_run(trainer, text, images, label: str, expected: dict) -> dict:
    """The counted run: ``TRAIN_STEPS`` steps of ``trainer`` on one batch,
    kernel counts set to 0 just before and read just after. Every loss
    finite, the last below the first, each kernel of ``expected``
    launched its count x (steps + retries) times and every other kernel
    never. Prints the step wall median over steps 2-10, training tokens/s
    (batch x the model's positions a step) and peak memory; returns the
    launches."""
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(text, images))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = read_counts(tuple(kernel_counters()))
    dispatched = trainer.steps + trainer.retries
    want = {name: n * dispatched for name, n in expected.items()}
    launches = {name: n for name, n in counts.items() if n or name in want}
    steady = float(np.median(walls[1:]))
    tokens_per_step = TRAIN_BATCH * trainer.dalle.total_seq_len
    log(f"{label}: {trainer.steps} steps, {trainer.retries} retries, losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"{label}: step wall first {walls[0]:.3f} s, median of the rest {steady:.4f} s "
        f"(all: {', '.join(f'{w:.4f}' for w in walls)}); {tokens_per_step / steady:.1f} "
        f"training tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{label}: launches {launches} (expected {want}; every other kernel 0)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {want}")
    return launches


def train_flagship():
    """The flagship DALLE trained in float32 by ``DalleTrainer``: the
    counted run, then the NaN-injected step. Returns (trainer, (text,
    images), launches of the counted run)."""
    from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
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
    launches = train_run(trainer, text, images, "train",
                         {name: FLAGSHIP["depth"] for name in PACKED})

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


def train_sparse(vae, batch):
    """The sparse configuration (BASELINE.json configs[2] at the flagship
    width: layers cycling full, axial_row, axial_col, conv_like) trained
    in float32 by ``DalleTrainer`` on the flagship batch: the counted run.
    Returns (trainer, launches of the counted run)."""
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    t0 = time.perf_counter()
    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True, attn_types=SPARSE_TYPES)
    types = trainer.dalle.transformer.attn_types
    torch.cuda.synchronize()
    log(f"train sparse: layers {types}, built in {time.perf_counter() - t0:.1f} s")
    per_kind = FLAGSHIP["depth"] // 2  # full + axial_col / axial_row + conv_like
    launches = train_run(trainer, *batch, "train sparse",
                         {name: per_kind for name in PACKED + PAIR_GRID})
    return trainer, launches


def train_512(text):
    """The flagship DALLE at 512 px trained in float32 by ``DalleTrainer``:
    the flagship VAE at image_size 512 encodes 4 seeded 512 px images to a
    64 x 64 grid (n = 256 + 4096 = 4352 positions, 17 x 17 flash blocks of
    256), the flagship captions ``text``; the counted run, every layer
    through the tiled forward, dq and dk/dv kernels. Returns (trainer,
    (text, images), launches of the counted run)."""
    from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    t0 = time.perf_counter()
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    size, grid = VAE_512["image_size"], VAE_512["image_size"] >> VAE_512["num_layers"]
    vae = DiscreteVAE(**VAE_512, device="cuda").init_weights(gen(14))
    images = torch.rand(TRAIN_BATCH, size, size, 3, device="cuda", generator=gen(15))
    tokens = vae.get_codebook_indices(images)
    if (tokens.shape != (TRAIN_BATCH, grid**2)
            or not ((tokens >= 0) & (tokens < VAE_512["num_tokens"])).all()):
        raise AssertionError(f"VAE encode at {size} px: tokens {tuple(tokens.shape)} out of range")
    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True)
    n = trainer.dalle.total_seq_len
    torch.cuda.synchronize()
    log(f"train 512: flagship DALLE at a {vae.fmap_size} x {vae.fmap_size} grid (n {n}) and "
        f"the 512 px VAE built, images encoded to {tuple(tokens.shape)} tokens in "
        f"{time.perf_counter() - t0:.1f} s")
    if n != FLAGSHIP["text_seq_len"] + grid**2:
        raise AssertionError(f"train 512: {n} positions, expected "
                             f"{FLAGSHIP['text_seq_len']} + {grid}**2")
    launches = train_run(trainer, text, images, "train 512",
                         {name: FLAGSHIP["depth"] for name in TILED_SPLIT})
    return trainer, (text, images), launches


def profile_train(trainer, batch, steps: int = 3, label: str = "train profile") -> None:
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
    log_device_profile(prof.key_averages(), label, "steps", "step", steps, wall_ms, 16)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from dalle_pytorch_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"TF32 cuDNN {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    ptxas = start_ptxas_report(PACKED + ("ragged_attention",))
    cuda_build.build()
    log(f"build: {sorted(cuda_build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s")
    log_ptxas_report(ptxas, ("_tc_kernel", "_tf32_kernel", "ragged_f32_kernel"))
    log_sass_report(PACKED)

    kernels = [*check_ragged_attention(), check_fused_qkv(), check_fused_qkv_bwd(),
               *check_block_sparse(), *check_flash_attention(), check_decode_attention()]
    release_memory()
    sparse_types = tuple(SPARSE_TYPES.split(","))
    for kv_quant, attn_types in ((None, None), ("int8", None), (None, sparse_types),
                                 ("int8", sparse_types)):
        check_path_against_plain(kv_quant, attn_types)
    check_preemption_on_card()
    check_clip_against_plain()
    check_decode_against_plain()
    for variant in ("dense", "sparse", "tiled"):
        check_train_against_plain(variant)
    # the one-block path: the only one that runs the single-block backward
    one_block_launches = check_train_against_plain("one_block")
    results, serve_launches, model, engine = serve_flagship()
    check_pixels(results)
    profile_iterations(model)
    int8_launches = serve_int8(model, results, engine)
    check_int8_logits(model)
    for kv_quant in ("int8", "int8", None):  # phase 7's bf16 profile came first
        profile_iterations(model, kv_quant=kv_quant)
    # the staged engine and its pipeline refer to each other: only the
    # cyclic collector frees their pools before the next phase's peak
    del model, results, engine
    release_memory()
    sparse_serve_launches = serve_sparse_int8()
    release_memory()
    generate_launches = generate_flagship()
    release_memory()
    trainer, batch, train_launches = train_flagship()
    profile_train(trainer, batch)
    vae = trainer.vae
    del trainer
    release_memory()
    trainer, sparse_launches = train_sparse(vae, batch)
    profile_train(trainer, batch, label="train sparse profile")
    del trainer, vae
    release_memory()
    trainer, batch, launches_512 = train_512(batch[0])
    profile_train(trainer, batch, label="train 512 profile")
    paths = (("serve", serve_launches), ("serve_int8", int8_launches),
             ("serve_sparse_int8", sparse_serve_launches), ("train", train_launches),
             ("train_sparse", sparse_launches), ("train_512", launches_512),
             ("train_one_block", one_block_launches), *generate_launches.items())
    for k in kernels:
        by_path = {path: counts[k["name"]] for path, counts in paths if k["name"] in counts}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path

    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# ------------------------------------------------- paired comparisons


RAGGED_COMPARE_CASES = (("serve", False), ("serve", True), ("prompt", False))


def compare_ragged_sources(other: str, rounds: int = 2) -> None:
    """The ragged kernel of this checkout against the one built from
    ``other`` (the same file of another commit; this checkout's csrc on
    the include path after the file's own directory, for its headers),
    in one process: both bf16 instances at the serving shape and the
    unquantized one at generate (d)'s prompt block, timed by
    ``time_ragged`` in the order other, this, this, other, ``rounds``
    times, with the cold timer as it is (``HOST_COVER_CYCLES``) and
    without its spin (0: the begin event may then run while the host
    still issues the launch); and whether this checkout's is faster in
    every adjacent pair."""
    global HOST_COVER_CYCLES
    from dalle_pytorch_tpu_torch.ops import cuda_build

    lib_path = cuda_build.BUILD_DIR / "compare" / f"libragged_attention-{Path(other).stem}.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                             "-o", str(lib_path), other],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    this = cuda_build.load_library("ragged_attention")
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {other}:\n{out}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in cuda_build.SIGNATURES["ragged_attention"].items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    libs = {"other": lib, "this": this}
    cover = HOST_COVER_CYCLES
    for cycles in (cover, 0):
        HOST_COVER_CYCLES = cycles
        ms = {(src, key): [] for src in libs for key in RAGGED_COMPARE_CASES}
        for _ in range(rounds):
            for src in ("other", "this", "this", "other"):
                # the wrappers load their library through this cache
                cuda_build._LOADED["ragged_attention"] = libs[src]
                for case, int8 in RAGGED_COMPARE_CASES:
                    ms[src, (case, int8)].append(time_ragged(int8, case)["ms"])
        for key in RAGGED_COMPARE_CASES:
            case, int8 = key
            mine, theirs = ms["this", key], ms["other", key]
            faster = all(t < o for t, o in zip(mine, theirs))
            log(f"compare ragged_attention{'_int8' if int8 else ''} bf16, {case} shape, cold L2, "
                f"spin {cycles} cycles: other ({other}) " + ", ".join(f"{t:.4f}" for t in theirs)
                + f" (mean {np.mean(theirs):.4f} ms); this " + ", ".join(
                    f"{t:.4f}" for t in mine) + f" (mean {np.mean(mine):.4f} ms); this / other "
                f"{np.mean(mine) / np.mean(theirs):.4f}; this faster in every pair {faster}")
    HOST_COVER_CYCLES = cover
    cuda_build._LOADED["ragged_attention"] = this


PACKED_COMPARE_CASES = (("dalle", torch.bfloat16, "fwd"), ("clip", torch.bfloat16, "fwd"),
                         ("train", torch.bfloat16, "bwd"), ("train", torch.float32, "fwd"),
                         ("train", torch.float32, "bwd"))


def packed_case(case: str, dtype, direction: str):
    """(kernel call, sdpa call, bounds) of one packed-qkv instance: the
    forward on ``fused_inputs(case)``, or the backward on them (seed 1)
    with a seeded do and the plain forward's o and lse; bounds as
    ``packed_bounds`` gives them."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    if direction == "fwd":
        qkv, h, d, opts = fused_inputs(case, dtype)
        (q, k, v), kw = sdpa_args(qkv, h, d, opts)
        return (lambda: fa.fused_qkv_attention(qkv, h, d, **opts),
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw),
                fused_bound(qkv, h, d, opts))
    qkv, h, d, opts, do, o, lse = packed_bwd_case(case, dtype)
    return (lambda: fa.fused_qkv_attention_bwd(qkv, o, lse, do, h, d, **opts),
            sdpa_backward(qkv, h, d, opts, do), fused_bwd_bound(qkv, h, d, opts))


def packed_bwd_case(case: str, dtype):
    """(qkv, h, d, opts, do, o, lse) of the packed backward's paired
    cases: ``fused_inputs(case)`` at seed 1, do seeded, o and lse from the
    plain forward."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    qkv, h, d, opts = fused_inputs(case, dtype, seed=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    do = torch.randn(qkv.shape[0], qkv.shape[1], h * d, generator=g, device="cuda").to(dtype)
    o, lse = fa.reference_fused_qkv(qkv, h, d, **opts)
    return qkv, h, d, opts, do, o, lse


def compare_packed_sources(other_dir: str, rounds: int = 2) -> None:
    """The packed-qkv forward and backward of this checkout against
    ``fused_qkv_attention.cu`` and ``fused_qkv_attention_bwd.cu`` of
    ``other_dir`` (another commit's csrc), built under other library
    names, in one process with one timer (cold L2): bf16 forward at
    DALL-E's b 2 and at CLIP's text shape, the bf16 backward at the
    training shape, and both float32 training-shape kernels, in the order
    other, this, this, other, ``rounds`` times; each case's sdpa time and
    bounds beside. First, at the training and CLIP shapes, forward and
    backward: each tree's float32 outputs are held against the plain
    versions (o and lse within abs ``testing.F32_ATOL``, each part of dqkv
    within ``testing.BWD_F32_REL``) and max |this - other| is printed, and the
    two trees' bf16 outputs must be bitwise equal; raises otherwise."""
    from dalle_pytorch_tpu_torch.ops import cuda_build
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.testing import BWD_F32_REL, F32_ATOL, bwd_errors

    out_dir = cuda_build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}-other.so"),
         str(Path(other_dir) / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in PACKED}
    libs = {"this": {name: cuda_build.load_library(name) for name in PACKED}, "other": {}}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {other_dir}/{name}.cu:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}-other.so"))
        for fn, (argtypes, restype) in cuda_build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs["other"][name] = lib

    def use(src: str) -> None:  # the wrappers load their library through this cache
        cuda_build._LOADED.update(libs[src])

    for case in ("train", "clip"):
        for dtype in (torch.float32, torch.bfloat16):
            qkv, h, d, opts, do, plain_o, plain_lse = packed_bwd_case(case, dtype)
            outs = {}
            for src in libs:
                use(src)
                outs[src] = (*fa.fused_qkv_attention(qkv, h, d, **opts),
                             fa.fused_qkv_attention_bwd(qkv, plain_o, plain_lse, do, h, d, **opts))
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                same = [torch.equal(a, b) for a, b in zip(outs["this"], outs["other"])]
                log(f"compare packed bf16 {case}: o, lse, dqkv bitwise equal to the other "
                    f"tree's: {same}")
                if not all(same):
                    raise AssertionError(f"packed bf16 {case} outputs differ from the other tree's")
                continue
            plain = fa.reference_fused_qkv_bwd(qkv, plain_o, plain_lse, do, h, d, **opts)
            ok = True
            for src, (o, lse, dqkv) in outs.items():
                err = max((o - plain_o).abs().max().item(), (lse - plain_lse).abs().max().item())
                rel = bwd_errors(dqkv, plain, h, d, opts)[0]
                ok &= err <= F32_ATOL and rel <= BWD_F32_REL
                log(f"compare packed float32 {case}, {src}: max |kernel - plain| over o and lse "
                    f"{err:.3e} (tolerance {F32_ATOL:.0e}), dqkv relative L2 {rel:.3e} "
                    f"(tolerance {BWD_F32_REL:.0e})")
            diffs = [(a - b).abs().max().item() for a, b in zip(outs["this"], outs["other"])]
            log(f"compare packed float32 {case}: max |this - other| o {diffs[0]:.3e}, lse "
                f"{diffs[1]:.3e}, dqkv {diffs[2]:.3e}")
            if not ok:
                raise AssertionError(f"packed float32 {case}: a tree misses the plain version's "
                                     "tolerances")

    calls = {}
    for case, dtype, direction in PACKED_COMPARE_CASES:
        calls[case, dtype, direction] = packed_case(case, dtype, direction)
    ms = {(key, src): [] for key in calls for src in libs}
    for _ in range(rounds):
        for src in ("other", "this", "this", "other"):
            use(src)
            for key, (fn, *_) in calls.items():
                ms[key, src].append(cuda_time_ms(fn, iters=20))
    use("this")
    for key, (_, sdpa, bounds) in calls.items():
        case, dtype, direction = key
        this, other = ms[key, "this"], ms[key, "other"]
        # adjacent pairs of the order other, this, this, other
        faster = all(t < o for t, o in zip(this, other))
        log(f"compare packed {direction} {case} {dtype}, cold L2: other " + ", ".join(
            f"{t:.4f}" for t in other) + f" (mean {np.mean(other):.4f} ms); this " + ", ".join(
            f"{t:.4f}" for t in this) + f" (mean {np.mean(this):.4f} ms); this / other "
            f"{np.mean(this) / np.mean(other):.4f}; this faster in every pair {faster}; sdpa "
            f"{cuda_time_ms(sdpa, iters=20):.4f} ms; {bound_text(bounds)}")


def compare_generate(pairs: int = 3) -> None:
    """Generation (a) against (b) of ``generate_flagship`` (batch 1, the
    same caption: the decode kernel with ``window_seg=0``, then the
    unfused chain with the default window) in ``pairs`` pairs, alternating
    a b, b a, ...; after one 64-step warm-up of each. Prints every run's
    wall ms per token and each pair's ratio b / a."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import decode_tokens, generate_image_tokens

    model = DALLE(**FLAGSHIP, device="cuda", dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    text = torch.from_numpy(np.random.RandomState(13).randint(
        1, FLAGSHIP["num_text_tokens"], size=(8, FLAGSHIP["text_seq_len"])))[:1].cuda()
    runs = {"a": dict(fused_decode=True, window_seg=0), "b": {}}
    T = model.text_len_internal
    for kw in runs.values():
        tokens = torch.zeros((1, T + model.image_seq_len), dtype=torch.int32, device="cuda")
        tokens[:, :T] = model.remap_text(text)
        decode_tokens(model, tokens, T, 0, prefill_len=T, num_steps=T - 1 + 64, **kw)
    ms = {"a": [], "b": []}
    for p in range(pairs):
        for label in ("ab" if p % 2 == 0 else "ba"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_image_tokens(model, text, 0, **runs[label])
            torch.cuda.synchronize()
            ms[label].append(1e3 * (time.perf_counter() - t0) / MAX_NEW)
    ratios = [b / a for a, b in zip(ms["a"], ms["b"])]
    log("compare generate batch 1, ms per token: (a) kernel " + ", ".join(
        f"{t:.3f}" for t in ms["a"]) + "; (b) unfused chain " + ", ".join(
        f"{t:.3f}" for t in ms["b"]) + "; pair ratios b / a " + ", ".join(
        f"{r:.4f}" for r in ratios) + f" (min {min(ratios):.4f}, max {max(ratios):.4f})")


def compare(argv) -> int:
    """``chip_smoke.py --ragged-source PATH``, ``--packed-source DIR`` and/or
    ``--generate-pairs N``: only the paired comparisons, on one card."""
    import argparse

    parser = argparse.ArgumentParser(description=compare.__doc__)
    parser.add_argument("--ragged-source", action="append", default=[],
                        help="ragged_attention.cu of another commit or a variant (repeatable: "
                             "each is compared with this checkout's in turn)")
    parser.add_argument("--packed-source",
                        help="csrc directory of another commit (its fused_qkv_attention*.cu)")
    parser.add_argument("--generate-pairs", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for other in args.ragged_source:
        compare_ragged_sources(other)
    if args.packed_source:
        compare_packed_sources(args.packed_source)
    if args.generate_pairs:
        compare_generate(args.generate_pairs)
    return 0


if __name__ == "__main__":
    sys.exit(compare(sys.argv[1:]) if len(sys.argv) > 1 else main())
