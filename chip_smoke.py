#!/usr/bin/env python3
"""Drive the PyTorch port (dalle_pytorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises on failure (exit code non-zero, no result
line):

1. device: a CUDA card is required; its name and power limit are printed.
   Float32 matrix products and convolutions run without TF32, and bf16
   matrix products accumulate in float32 to the end (cuBLAS's bf16
   reduced-precision reduction off, as the TPU accumulates).
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
   mask, and at the training shape (batch 4) with the rotary table and
   without it (learned positions), and timed in bf16 at CLIP's and
   DALL-E's shapes and in both types at the training shape, with and
   without the rotary table (both instances on the tensor cores;
   float32's bound at the split-3xTF32 rate, its CUDA-core bound beside).
   The fused decode kernel is held at the flagship's decode shapes (b 1
   and 8, 16 heads of 64, L 1281, positions 0 to 1279, rotary and key
   mask on and off, a masked own key, dim_head 32 and 128; its k/v rows
   bitwise) and timed at b 1 and 8, with the rotary tables and without
   them.
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
   unpressured run. The split engine on the card (``fused_iteration``
   off): a small float32 DALLE, greedy, unquantized and int8 pages,
   chunks of 4 (a 1-token tail merged) and monolithic prefill,
   lookahead on and off: tokens identical to the CPU's, the ragged
   kernel launched depth x dispatches times; ``prefill_chunk``
   chunkings against ``prefill_step`` and the vector ``decode_step`` at
   mixed per-row positions against the CPU within
   ``testing.LOGITS_F32_ATOL``; ``prefill_fail`` once (retried, tokens
   unchanged), twice (PREFILL_FAILED, the pool empty) and
   ``page_exhaust`` (a preemption, the replay bit-identical). Learned
   positions on the card (``LEARNED_POS``, train_dalle.py's defaults):
   the split check's model with learned positions, then with
   ``stable``: greedy tokens card = CPU on the split path (chunks of 4,
   monolithic) and the fused path, the ragged kernel launched depth x
   dispatches times; ``generate_image_tokens`` on "4d" with the decode
   kernel's no-rotary instance, tokens card = CPU, depth x 15 launches.
5. engine: the flagship DALLE at full width and depth cut to 2 of 12
   (``SERVE_MODEL``: dim 1024, 16 heads of 64, 256 text + 32x32 image
   tokens, bf16, seeded random weights) served by the
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
5e. serve split: the flagship of phase 5 served by the split engine
   (batch-1 chunks of 16, then the vector decode step of 8 rows), with
   phase 5's VAE and CLIP, its first 8 requests: every outcome COMPLETED
   with 1024 tokens in range, a finite image and a finite score, the
   ragged kernel launched depth x (decode steps + chunks) times, the
   int8 instance never, the packed-qkv kernel as in phase 5; token
   agreement with phase 5 printed, wall and tokens/s. Then 2 requests
   of 64 tokens with monolithic prefill (one 257-column prompt block a
   layer each), counted the same way, and a profile of 15 split
   iterations as in phase 7.
5f. serve learned_pos: phase 5's model with learned positions and no
   token shift (train_dalle.py's defaults), bf16, served by
   ``EngineConfig()`` (the split path, monolithic prefill, max_batch 4)
   with phase 5's VAE and CLIP, 4 requests of 1024 tokens: every outcome
   COMPLETED with a finite image and score, the ragged kernel depth x
   dispatches times, CLIP's packed-qkv kernel as in phase 5; tokens/s
   and launches per dispatch printed.
5g. generate learned_pos: the same model, batch 1 on the "4d" cache,
   256 tokens with the decode kernel's no-rotary instance, window 0,
   the kernel launched depth x 255 times; ms per token printed.
5h. serve reversible: ``SERVE_MODEL`` with ``reversible=True`` (the
   decode form's direct reversible wiring), float32, seeded weights on
   the card and the same on the CPU, greedy: 2 requests of 16 tokens
   through the split path (monolithic prefill) and the fused iteration
   (chunks of 16), tokens card = CPU, the ragged kernel depth x
   dispatches times; then ``decode_tokens`` of 2 captions on the "flat"
   cache with the decode kernel, 16 tokens card = CPU, the decode kernel
   depth x 15 times.
5i. serve prefix and spec (``serve_prefix_spec``): ``SERVE_MODEL``
   (bf16, phase 5's seed), max_batch 8, chunks of 16, pages of 128 (T =
   257: a prompt's last page holds one row). The prefix cache on the
   fused path and the split path with chunks, bf16 and int8 pages: a
   publisher, three partial hits on its first page, then the four
   prompts again as full hits (8 requests of 64 tokens): every outcome
   COMPLETED, warm tokens bitwise the cold engine's, the prefix
   counters equal a CPU engine's on the same rounds (a small model of the
   same sequence geometry), the ragged kernel depth x model dispatches
   times, the engine's invariants at the drain; the ``prefix_hash_
   collide`` and ``prefix_publish_fail`` drills once each; TTFT cold,
   partial and full printed. Speculative decode (fused, spec_k 3, 4
   requests of 64 tokens): the exact drafter, the exact drafter with one
   ``spec_verify_abort``, the 2-layer drafter and the exact drafter with
   a warm prefix hit, tokens bitwise a plain fused engine's, the ragged
   kernel depth x dispatches + draft depth x draft steps times; accept
   rates, wall and tokens/s against plain printed.
5c. serve sparse: the sparse configuration (phase 10's layers) at the
   flagship width and depth 4 (each type once), bf16, int8 pages, 4 requests of
   256 tokens: every outcome COMPLETED, the int8 ragged instance launched
   (full layers) x dispatched iterations times.
5d. generate: the flagship of phase 5 generating outside the engine
   (``models/sampling.py``), each run counted: (a) batch 1 on the "4d"
   cache with ``fused_decode=True`` and ``window_seg=0``, 1024 tokens in
   range, the decode kernel launched exactly depth x 1023 times; (b) the
   same caption with ``fused_decode=False`` (the unfused chain) and the
   default window, token
   agreement printed, and (a)'s tokens teacher-forced through both paths
   (the prompt and 256 decode steps), image logits within
   ``testing.DECODE_LOGITS_REL``; (c) batch 8 on the
   "flat" cache, ``generate_images`` with phase 5's VAE and CLIP, 8
   finite images and scores, the decode kernel depth x 1023 times; (d)
   batch 4 on pages with default arguments, the ragged kernel depth x 1024
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
8c. train learned_pos: ``DalleTrainer(vae)`` at the flagship's widths
   with every other flag train_dalle.py's default (learned positions,
   no token shift, "full", float32, batch 4) on phase 8's VAE and batch:
   10 steps as phase 8 (the packed kernels' no-rotary instances depth x
   (steps + retries) times each), then profiled as phase 9.
8d. train reversible: phase 8's model, seed, VAE and batch with
   ``reversible=True``, float32 then bf16: one forward and backward with
   the packed kernels against their plain versions on the card (phase
   4's tolerances: the loss and every gradient), then ``REV_STEPS`` steps
   each of the sequential, reversible (kernels), reversible (plain
   versions, nothing launched) and remat trainers of the same seed,
   counted: the packed forward 2 x depth and its backward depth x
   dispatches (sequential depth and depth); reversible's losses within
   phase 4's tolerances of its plain run's, and its peak memory below
   sequential's. Each run's step walls and peak memory are printed.
8e. train remat (in the same phase): ``remat=True``, the same counts
   as reversible, its loss sequence bitwise sequential's, its peak
   memory below sequential's.
8b. train bf16: the same model, seed and batch trained in mixed
   precision (``DalleTrainer(bf16=True)``: bfloat16 compute on float32
   parameters and Adam moments, checked), as phase 8 (the packed
   kernels' bf16 instances depth x (steps + retries) times each, the
   NaN-injected step), then profiled as phase 9.
10. train sparse: the flagship DALLE with its layers cycling "full",
   "axial_row", "axial_col", "conv_like" (BASELINE.json configs[2] at
   the flagship width), otherwise as phase 8: 10 steps on one batch,
   every loss finite and the last below the first, the block-sparse
   forward, dq and dk/dv kernels (axial_row and conv_like layers) and the
   packed-qkv forward and backward (full and axial_col layers) launched
   depth / 2 x (steps + retries) times each; then profiled as phase 9.
   Then the same in mixed precision (train sparse bf16: the bf16
   instances of the same kernels, the same counts).
11. train 512: the flagship DALLE at 512 px (a 64 x 64 image grid, n
   4,352 positions; the flagship VAE with image_size 512 encodes 4 seeded
   512 px images to (4, 4096) tokens), float32, otherwise as phase 8: 10
   steps on one batch, every loss finite and the last below the first,
   the tiled flash forward, dq and dk/dv kernels launched depth x (steps
   + retries) times each and no other attention kernel; then profiled as
   phase 9, each tiled kernel's profiled ms a step beside the kernel
   phase's ms a launch times its launches a step (a gap over 25% is
   flagged in the log, not failed). Then the same model and batch in
   mixed precision (train 512 bf16: the tiled kernels' bf16 instances,
   the same counts, the same profile). Between the two, train 512 plain:
   the float32 model of the same seed takes the same 10 steps on the same
   batch with the tiled flash kernels' plain versions in their place (no
   kernel launched, checked); both loss sequences are printed side by
   side with the first step where they part by more than phase 4's
   float32 loss tolerance (relative 1e-5), if any; the plain run's wall
   is printed and kept out of every timing.
12. train CLI: the trainer's command line (``train_dalle.main``, called
   in this process on a temporary directory under ``build/``, removed at
   the end) at the flagship widths with train_dalle.py's other defaults
   (batch 4, learned positions, "full", float32): 16 seeded 256 px PNGs
   with one caption each (``testing.write_caption_folder``), phase 8's
   VAE saved by ``models.factory.save_vae_checkpoint``; ``--epochs 1
   --sharded_ckpt --keep_n_checkpoints 1 --sample_every_n_steps 3
   --truncate_captions``: four steps, a sample at step 3, the pre-flight
   ``.ckpt``, then the epoch's ``.ckpt`` and step directory. Then the
   same command with ``--epochs 2`` (and no sample): it resumes from the
   verified step directory and takes four more steps. Every loss finite;
   the packed kernels' no-rotary instances depth x dispatches times each
   and the sample's decode kernel depth x 1023 times, counted exactly; one
   finite sample PNG; the step directory verifies; the relaunch prints
   ``resuming from ... step 4`` and its Adam count goes on from 4 to 8;
   one ``.ckpt`` and one step directory on disk after the rotation. The
   CLI's step as users run it (the wall between consecutive loss
   verdicts of one epoch, no sample between them, nothing synchronised
   beyond what the CLI does) and tokens/s beside phase 8c's
   ``train_step``, the loader's seconds a batch, each save's bytes and
   seconds, the phase's wall.
12b. train CLI ga: the command line with the rest of train_dalle.py's
   single-card flags at the same widths on phase 8's VAE
   (``train_cli_ga``): four tar shards of 4 samples written by the
   script (PNG and JPEG members named ``.img``, captions ``.cap``, one
   JPEG cut short), ``--wds img,cap``, ``--bpe_path`` a tokenizer JSON
   trained on the captions (the HugTokenizer), ``--attn_dropout 0.1
   --ff_dropout 0.1 --ga_steps 2 --epochs 1``: run 1 is SIGTERM'd at its
   third micro-step (an emergency step directory mid-accumulation), the
   relaunch resumes, replays epoch 0 from its start (logged) and ends
   it. Checked: the packed kernels depth x 6 micro-steps each way, Adam's
   count 3, ``mini_step`` 1 and the accumulator restored bitwise, one
   decode error a run; on the card the same micro-batch and generator
   key give a bitwise equal loss and another key another, layer 0's
   attention mask keeps within 4 binomial standard deviations of 0.9,
   and the dropout is bitwise ``where(mask, x / 0.9, 0)`` on the CPU;
   ``get_tokenizer()`` is the native BPE engine (built by ``g++`` from
   the port's sources into ``build/native/``), byte-equal to
   ``SimpleTokenizer`` on the captions and 10,000 seeded strings.
   Printed: both tokenizers' encode rates, the tar loader's seconds a
   batch, the micro-step as the CLI runs it and its tokens/s.
12c. train CLI telemetry (``train_cli_telemetry``): phase 12's command
   line at depth 2 on 12 seeded PNGs (three steps), then again with
   ``--telemetry --telemetry_dir DIR --metrics_port PORT``: the losses
   bitwise equal, one scrape of ``/metrics`` on 127.0.0.1 returning
   ``train.step_s`` over three steps, the flight file valid with three
   closed ``train.step`` spans, the packed kernels depth x 3 each way.
   Printed: the walls between verdicts of both runs.
13. train VAE CLI: ``python -m dalle_pytorch_tpu_torch.train_vae``
   (``train_vae.main`` in this process on a directory under ``build/``,
   removed at the end) at BASELINE.json configs[0] (256 px, 8192 tokens,
   3 layers, emb 512, hidden 256, 2 ResBlocks, batch 8), float32, on 128
   seeded 256 px PNGs for 7 epochs (112 steps): every loss finite, the
   step-100 log (codebook usage, a reconstruction grid) and every
   epoch's checkpoint written, the last read back by
   ``models.factory.vae_from_checkpoint`` bitwise equal to the trained
   state; no attention kernel launched. Step wall, images/s and peak
   memory printed.
14. train CLIP CLI: first one forward and backward of the trainer's
   loss (``train_clip.clip_loss``) at train_clip.py's defaults (dims
   512, 6 + 6 layers of 8 heads of 64, text 256 with a key mask of
   seeded lengths, 256 px in 32 px patches, batch 32), the packed kernels
   against their plain versions on the card: float32 the loss within
   relative 1e-5, the similarity logits and every gradient within 1e-4
   of its largest entry; bf16 the logits and every gradient of more
   than one entry within ``BF16_GAP_FACTOR`` times the plain
   bf16-to-float32 gap, the loss and the temperature's gradient within
   it times the gap of what each sums (as tests/test_torch_clip_train.py
   holds them). Then
   ``python -m dalle_pytorch_tpu_torch.train_clip`` in the same way as
   phase 13 at those defaults on 64 seeded 256 px PNGs with three
   captions each (2 steps an epoch): float32 and ``--bf16`` with the
   packed kernels and with their plain versions (the text encoder's
   packed forward and backward, non-causal with the key mask, text depth
   x steps each), the losses within phase 4's tolerances; a one-epoch
   run resumed from ``--clip_path`` for a second, its losses and final
   checkpoint bitwise the uninterrupted two-epoch run's (the checkpoint
   carries the dataset's caption and crop stream). Samples/s and peak
   memory printed.
15. generate CLI (``generate_cli``, after phase 5i): ``python -m
   dalle_pytorch_tpu_torch.generate`` (``generate.main`` in this
   process) on a float32 checkpoint of ``SERVE_MODEL`` at depth 1
   (``GEN_CLI_DEPTH``) over the CLIP BPE vocabulary (``GEN_CLI_MODEL``)
   with the flagship VAE, and
   a flagship CLIP checkpoint: ``--bf16 --clip_path``, two prompts of 4
   images, batch 4 (the split engine with monolithic prefill and the
   stages), telemetry off, then on (``DALLE_TPU_TELEMETRY=1`` and a
   flight directory). Checked: 8 PNGs of 256 x 256 x 3 and two
   captions, byte-identical in both runs; the ragged kernel depth x
   dispatches times and the packed-qkv kernel CLIP's text depth x rerank
   dispatches times, equal in both runs; an engine built directly from
   the checkpoints serves the first prompt's images bitwise, best first;
   the flight file valid, every request's span closed COMPLETED, one
   span a stage dispatch, one decode span a decode step. Printed: both
   walls, the telemetry percentiles from ``dump()`` and a ``--gentxt``
   image's completion.

Phase 3 also holds the packed-qkv backward kernel against its plain
version (float32 and bfloat16) at the flagship training shape, CLIP's
text shape and DALL-E's shape with the axial-row and axial-column
pattern masks (timed at the training shape in both types), and the
three block-sparse kernels (forward, dq, dk/dv; every float32 one on
split-3xTF32 tensor-core tiles, every bf16 one on bf16 ones) at
the flagship training shape with the axial_row and conv_like layouts and
at a ragged n with a key mask that kills whole rows (dim_head 32, 64,
128), each timed beside its plain version, its bound (float32 at the
3xTF32 rate, the CUDA-core bound beside), the packed kernel with the
same pattern, and ``scaled_dot_product_attention`` with the mask under
each backend that takes one (the fastest is the library's time);
and the four
tiled flash kernels (forward, dq, dk/dv, single-block backward) on
``testing.flash_inputs``: the 512 px training shape (b 4, 16 heads of
64, n 4352, causal), its axial_col pattern, a key mask with fully masked
rows at dim_head 32/64/96/128, non-causal, a pattern at a small n, and
one flash block of 1280 at 3 heads of 64 and at 16 heads of 32, float32
and bfloat16 (the single-block backward, in both types, bitwise the dq +
dk/dv chain's), each timed at its main path's shape beside its plain version
and ``scaled_dot_product_attention`` (float32 forward, dq, dk/dv and
single-block backward on split-3xTF32 tensor-core tiles, their bounds,
like every float32 tiled bound, at the 3xTF32 rate with the CUDA-core
bound beside; the single-block backward at both one-block shapes with
the split chain's time beside, in both types; the bf16 forward, dq,
dk/dv and single-block backward on bf16 tensor-core tiles beside bf16
sdpa and their bf16 bounds). The
bf16 instances of the packed forward (batch 4) and of the three
block-sparse kernels are timed at the training shape too, beside bf16
sdpa and their bf16 bounds. Phase 4 also checks a small DALLE's loss and
every parameter gradient, card against CPU, for the full model, for the
four-type sparse cycle, at n 1152 (the tiled kernels, dq then dk/dv) and
at n 384 with 3 heads (one flash block: the single-block backward), and
with learned positions and with ``stable`` (3 clipped-Adam steps, each
checked, the card's parameters copied to the CPU after each step), with
exact launch counts, in float32 and in mixed precision (bf16 compute on
float32 parameters: the card's loss and gradients within
``testing.BF16_GAP_FACTOR`` times the CPU's bf16-to-float32 gap of the
CPU's bf16 run).

The second-to-last line is the card's ``nvidia-smi`` name and power
limit; the line before it the kernels' JSON; the last line
``{"ok": true, "device": {...}}``.

Phase 2 also prints what ``ptxas -v`` reports (registers, shared memory,
spills) for the packed-qkv kernels' tensor-core instances (bf16, and
float32 as split 3xTF32), for the tiled flash forward, dq, dk/dv and
single-block backward in both types (float32 as split 3xTF32, bf16 on
bf16 ``mma.sync``), the pair grid's forward, dq and dk/dv in both types,
for every instance of the ragged kernel and of the decode kernel, and
counts the HMMA instructions of each packed, tiled and pair-grid
tensor-core instance in the built libraries (``cuobjdump -sass``),
failing unless every float32 instance (3 + 6 + 16 + 9) holds
``HMMA.1688.F32.TF32`` and every tiled and pair-grid bf16 one (16 + 9)
``HMMA.16816.F32.BF16``.

Paired comparisons, one card, none of the phases above:

    python3 chip_smoke.py --ragged-source OTHER/ragged_attention.cu
    python3 chip_smoke.py --packed-source OTHER/csrc
    python3 chip_smoke.py --tiled-source OTHER/csrc
    python3 chip_smoke.py --sparse-source OTHER/csrc
    python3 chip_smoke.py --decode-source OTHER/csrc
    python3 chip_smoke.py --generate-pairs 3
    python3 chip_smoke.py --serve-pairs 2
    python3 chip_smoke.py --generate-cli 4 --serve-source OTHER

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
builds another commit's ``flash_attention.cu`` with the headers beside
it, holds each tree's forward and single-block backward in both types
against the plain versions at the 512 px training shape, its axial_col
pattern and one flash block of 1280 (printing max |this - other|; this
tree's bf16 single-block backward bitwise its own dq + dk/dv chain),
checks that dq, delta, dk and dv in both types are bitwise equal across
the trees, and times both trees' forward, dq and dk/dv in both types at
the 512 px shape and the single-block backward at one block of 1280
(and, in bf16, at 16 heads of 32) alternating, sdpa and the bounds
beside; the fourth does the same for
another commit's ``block_sparse_attention.cu`` (bound with its shorter
signatures where it takes no class map): each tree's o and lse, dq and
delta and, in bf16, dk and dv held against the plain versions with max
|this - other| printed, every float32 output and the bf16 dq, delta, dk
and dv bitwise equal across the trees, then the forward, dq and dk/dv
of both types timed alternating at the axial_row and conv_like layouts
beside sdpa with the mask under each backend that takes one, and this
tree's tile order against launch order; the fifth
builds another commit's
``decode_attention.cu``, holds each tree's out against the plain version
at the generate shape (b 1 and 8), checks the k/v rows bitwise equal
across the trees, and times both alternating; the sixth times generation
(a) against (b) in alternating pairs; the seventh times the split engine
against the fused one at steady decode (8 rows of phase 5's flagship,
decode-only iterations) in alternating pairs, then profiles each; the
eighth runs phase 15 at depth 4, telemetry off, on, on, off, and phase
5's and phase 5e's engines of this checkout against another checkout's
(``OTHER``: its root), each tree's own port package on the same seeded
weights, alternating.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
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
# the serve and generate phases' model: the flagship at full width, depth
# cut to 4 of its 12 layers (the sparse cycle's four types once each);
# those phases are bound by the host's launches, which scale with depth:
# at 12 they took ~470 s of the script's 1,200 s limit on a slow host,
# and at 6 ~410 s once the train CLI phase was added (PERF.md, section 6)
SERVE_MODEL = dict(FLAGSHIP, depth=4)
# the sparse serving phase keeps the four types of the cycle once each
SPARSE_SERVE_MODEL = dict(FLAGSHIP, depth=4)
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
# phase 5e's requests: the first of phase 5's
SPLIT_REQUESTS = 8
# the learned-position phases: requests served (5f) and tokens generated (5g)
LEARNED_POS_REQUESTS, LEARNED_POS_TOKENS = 4, 256
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


# train_run's (losses, median step wall s, training tokens/s) by label
TRAIN_RECORDS = {}
# phase 12's command line: the flagship widths, train_dalle.py's other defaults
CLI_DIR = ROOT / "build" / "train_cli"
CLI_IMAGES, CLI_IMAGE_SIZE = 16, 256
# phase 12b's command line: tar shards, the HugTokenizer, dropout, accumulation
CLI_GA_DIR = ROOT / "build" / "train_cli_ga"
# phases 8d and 8e: steps of each sequential, reversible and remat run
REV_STEPS = 3
# phase 5h: tokens each request and generation makes
REV_SERVE_TOKENS = 16
# phase 13: train_vae.py at configs[0], 16 steps an epoch, 112 steps in all
VAE_CLI_DIR = ROOT / "build" / "train_vae_cli"
VAE_CLI_IMAGES, VAE_CLI_EPOCHS = 128, 7
# phase 14: train_clip.py's defaults, batch 32: 2 steps an epoch
CLIP_CLI_DIR = ROOT / "build" / "train_clip_cli"
CLIP_CLI_IMAGES = 64

_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


class Tee(io.StringIO):
    """Keeps what a command line prints and logs each line as it comes
    under ``label`` (its config line left out)."""

    def __init__(self, label):
        super().__init__()
        self.label, self.line, self.real = label, "", sys.stdout

    def write(self, text):
        self.line += text
        *done, self.line = self.line.split("\n")
        with contextlib.redirect_stdout(self.real):
            for line in done:
                if not line.startswith("config:"):
                    log(f"{self.label} | {line}")
        return super().write(text)


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
    at the training batch of 4, and "train_norot" is "train" without the
    rotary table (learned positions, train_dalle.py's default)."""
    from dalle_pytorch_tpu_torch.ops import masks
    from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables

    g = torch.Generator(device="cuda").manual_seed(seed)
    if case == "clip":
        b, n, h, d = STAGE_BATCH, FLAGSHIP_CLIP["text_seq_len"], 8, 64
        lengths = torch.tensor(CLIP_TEXT_LENGTHS, device="cuda")
        opts = dict(key_mask=torch.arange(n, device="cuda")[None] < lengths[:, None],
                    causal=False)
    else:
        b = TRAIN_BATCH if case.startswith("train") else 2
        n, h, d = 1280, FLAGSHIP["heads"], FLAGSHIP["dim_head"]
        text_len = FLAGSHIP["text_seq_len"] + 1
        table = dalle_rotary_table(d, text_len, FLAGSHIP["image_fmap_size"])
        opts = dict(causal=True, rot=rot_tables(torch.from_numpy(table).cuda(), n, d, dtype))
        if case == "train_norot":
            opts["rot"] = None
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
    """``bound_ms`` and ``bound_by`` of attention work of ``nbytes`` and
    ``ops`` in ``dtype`` (the packed and tiled kernels). float32 products
    run as split 3xTF32 on the tensor cores, three TF32 products each, so
    their operations count at TF32_PEAK_OPS / 3; ``bound_cuda_core_ms``
    beside is the bound at the CUDA cores' float32 rate."""
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
    for case in ("clip", "dalle", "dalle_pattern", "dalle_axial_col", "train", "train_norot"):
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
            if case.startswith("train"):
                train_errs[case, dtype] = (err, rel)

    timings = {}
    # bf16 at the serving shapes; both types at the training shape, with
    # the rotary table and without it (learned positions)
    for key, case, dtype in (("clip", "clip", torch.bfloat16), ("dalle", "dalle", torch.bfloat16),
                             ("train", "train", torch.float32),
                             ("train_bf16", "train", torch.bfloat16),
                             ("train_norot", "train_norot", torch.float32),
                             ("train_norot_bf16", "train_norot", torch.bfloat16)):
        qkv, h, d, opts = fused_inputs(case, dtype)
        (q, k, v), sdpa_kw = sdpa_args(qkv, h, d, opts)
        timings[key] = dict(
            ms=cuda_time_ms(lambda: fa.fused_qkv_attention(qkv, h, d, **opts)),
            plain_ms=cuda_time_ms(lambda: fa.reference_fused_qkv(qkv, h, d, **opts)),
            library_ms=cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, **sdpa_kw)),
        )
        timings[key].update(fused_bound(qkv, h, d, opts))
        t = timings[key]
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
        **{f"train_bf16_{k}": v for k, v in timings["train_bf16"].items()},
        **{f"train_norot_{k}": v for k, v in timings["train_norot"].items()},
        **{f"train_norot_bf16_{k}": v for k, v in timings["train_norot_bf16"].items()},
        "train_max_abs_err_f32": train_errs["train", torch.float32][0],
        "train_max_rel_err_bf16": train_errs["train", torch.bfloat16][1],
        "train_norot_max_abs_err_f32": train_errs["train_norot", torch.float32][0],
        "train_norot_max_rel_err_bf16": train_errs["train_norot", torch.bfloat16][1],
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
    train_abs = {}
    for case in ("train", "train_norot", "clip", "dalle_pattern", "dalle_axial_col"):
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
                train_abs[case] = abs_err
            else:
                worst_row = max(worst_row, row_rel)

    timings = {}
    for case, dtype in (("train", torch.float32), ("train", torch.bfloat16),
                        ("train_norot", torch.float32), ("train_norot", torch.bfloat16)):
        qkv, h, d, opts = fused_inputs(case, dtype, seed=1)
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
        timings[case, dtype] = t
        log(f"fused_qkv_bwd {case} {dtype} timing, cold L2: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa backward {t['library_ms']:.4f} ms, {bound_text(t)}")
    return {
        "name": "fused_qkv_attention_bwd", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
        "replaces": FUSED_BWD_TPU_KERNEL, "max_abs_err": train_abs["train"],
        "norot_max_abs_err": train_abs["train_norot"],
        "max_rel_err_f32": worst_rel, "max_row_rel_err_bf16": worst_row,
        **timings["train", torch.float32],  # the training path's type
        **{f"bf16_{k}": v for k, v in timings["train", torch.bfloat16].items()},
        **{f"norot_{k}": v for k, v in timings["train_norot", torch.float32].items()},
        **{f"norot_bf16_{k}": v for k, v in timings["train_norot", torch.bfloat16].items()},
    }


def pair_work(q, allowed, extra_bytes: int) -> dict:
    """{pass: (bytes, operations)} of the attention passes over q, k, v
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
    return {name: (nbytes + extra_bytes, 2 * products * d * pairs)
            for name, (nbytes, products) in work.items()}


def bs_layout_bytes(q, layout) -> dict:
    """{pass: bytes} of a 128-block layout's device operands that each
    pair-grid kernel reads at q's type, each byte once. The forward and
    dq: the q-major class map ``halves``, the tile order and the (64, 32)
    mask tile of each class 1 half. The bf16 dk/dv: the k-major map
    ``columns`` and the (32, 64) mask tile of each class 1 entry. The
    float32 dk/dv: the k-major table's q-block and class rows, its offsets
    and, for each class 1 pair of it, the (32, 64) mask tiles that
    ``tf32::PairRun`` loads to test, the pair's query halves below n
    against its key tiles below n."""
    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs

    n = q.shape[2]
    dl = bs.device_layout(layout, q.device)
    tile = bs.TILE * bs.HALF  # bytes of one int8 mask tile
    fwd = (dl.halves.numel() + 4 * dl.order.numel()
           + tile * int((dl.halves == 1).sum()))
    if q.dtype == torch.float32:
        kv = layout.kv_table
        qb, kb = kv[0, kv[2] == 1], kv[1, kv[2] == 1]
        halves = np.clip(-(-(n - qb * bs.DEFAULT_BLOCK) // bs.HALF), 0, 4)
        key_tiles = np.clip(-(-(n - kb * bs.DEFAULT_BLOCK) // bs.TILE), 0, 2)
        dkdv = (4 * 2 * kv.shape[1] + 4 * dl.kv_offsets.numel()
                + tile * int((halves * key_tiles).sum()))
    else:
        dkdv = dl.columns.numel() + tile * int((dl.columns == 1).sum())
    return {"fwd": fwd, "dq": fwd, "dkdv": dkdv}


def bs_bounds(q, layout, key_mask):
    """{kernel: ``packed_bounds``} of the three block-sparse kernels on
    these inputs (``pair_work``), each with the layout bytes it reads
    (``bs_layout_bytes``) and the key mask as passed: float32 at the
    split-3xTF32 rate with the CUDA-core bound beside."""
    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs

    b, _, n, _ = q.shape
    work = pair_work(q, bs.may_attend(layout, n, q.device, key_mask),
                     0 if key_mask is None else b * n)
    extra = bs_layout_bytes(q, layout)
    return {name: packed_bounds(work[role][0] + extra[role], work[role][1], q.dtype)
            for name, role in zip(BS_TPU_KERNELS, ("fwd", "dq", "dkdv"))}


# the backends of scaled_dot_product_attention that may take a boolean
# mask (the flash backend takes none), by their SDPBackend names
SDPA_MASK_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_mask_times(q, k, v, allowed, do, iters: int = 20) -> dict:
    """{"forward" | "backward": {backend: ms or None}} of
    ``scaled_dot_product_attention`` with the boolean mask ``allowed``,
    pinned to each backend of ``SDPA_MASK_BACKENDS`` in turn by
    ``torch.nn.attention.sdpa_kernel`` (None where the backend refuses
    these inputs), cold L2; the backward is ``torch.autograd.grad`` of q,
    k and v with ``do``. ``sdpa_fastest`` reads the fastest."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {"forward": {}, "backward": {}}
    for name in SDPA_MASK_BACKENDS:
        fwd = bwd = None
        backend = getattr(SDPBackend, name, None)
        if backend is not None:
            try:
                with sdpa_kernel(backend):
                    fwd = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=allowed), iters=iters)
                    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                    out = sdpa(*leaves, attn_mask=allowed)
                    bwd = cuda_time_ms(
                        lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                        iters=iters)
                    del out, leaves
            except RuntimeError:  # this backend takes no such inputs
                pass
        times["forward"][name.lower()], times["backward"][name.lower()] = fwd, bwd
    return times


def sdpa_fastest(by_backend: dict) -> float:
    """The least time of ``sdpa_mask_times``' backends that ran."""
    return min(t for t in by_backend.values() if t is not None)


def sdpa_text(by_backend: dict) -> str:
    """Each backend's time by name, "refused" where it took no such inputs."""
    return ", ".join(f"{name} " + ("refused" if t is None else f"{t:.4f}")
                     for name, t in by_backend.items())


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
    backward with the boolean pattern mask on the same split heads under
    each backend that takes one (``sdpa_mask_times``; the fastest is the
    row's library time); the bf16 instances the same way
    (``bs_bf16_timings``)."""
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
    for case in ("axial_row", "conv_like"):  # the training paths' shapes, both types
        bs_bf16_timings(case, rows)
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
        # yardsticks: sdpa with the boolean pattern mask on the same heads,
        # under each backend that takes one; the fastest is the library's
        allowed = bs.may_attend(layout, layout.n, q.device)  # (1, 1, n, n)
        sdpa_times = sdpa_mask_times(q, k, v, allowed, do)
        sdpa_ms, sdpa_bwd_ms = (sdpa_fastest(sdpa_times[way]) for way in ("forward", "backward"))
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
                f"{name} {times[name][0]:.4f} ms (plain {times[name][1]:.4f}, "
                f"{bound_text(bounds[name])})" for name in t)
            + f"; sdpa with the mask forward {sdpa_ms:.4f} / backward {sdpa_bwd_ms:.4f} ms, the "
            f"fastest of forward {sdpa_text(sdpa_times['forward'])}, backward "
            f"{sdpa_text(sdpa_times['backward'])}; "
            f"packed-qkv with the pattern forward {packed_ms:.4f} / backward "
            f"{packed_bwd_ms:.4f} ms against the pair grid's {fwd:.4f} / {bwd:.4f} ms")
        for name in t:
            row = rows[name]
            prefix = "" if case == "axial_row" else "conv_like_"
            row.update({f"{prefix}ms": times[name][0], f"{prefix}plain_ms": times[name][1],
                        **{prefix + key: value for key, value in bounds[name].items()}})
            if case == "axial_row":
                row["library_ms"] = sdpa_ms if name == "block_sparse_attention" else None
                row["sdpa_backward_ms"] = sdpa_bwd_ms
                row["packed_pattern_ms"] = (packed_ms if name == "block_sparse_attention"
                                            else packed_bwd_ms)
    return [rows[name] for name in BS_TPU_KERNELS]


def bs_bf16_timings(case: str, rows: dict) -> None:
    """The three block-sparse kernels' bf16 instances timed (cold L2) at
    the training shape with ``case``'s layout beside their plain versions,
    their bf16 bounds and bf16 ``scaled_dot_product_attention`` forward
    and backward with the boolean pattern mask (each backend that takes
    one logged by name, the fastest the library's); written into ``rows``
    under ``ms_bf16``, ``plain_ms_bf16``, ``bound_ms_bf16``,
    ``bound_by_bf16``, ``library_ms_bf16`` (conv_like prefixed)."""
    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
    from dalle_pytorch_tpu_torch.testing import bs_inputs

    q, k, v, do, layout, _ = bs_inputs(case, torch.bfloat16, "cuda", seed=1)
    o, lse = bs.block_sparse_attention(q, k, v, layout)
    dq, delta = bs.block_sparse_dq(q, k, v, o, lse, do, layout)
    kernels = {
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
    allowed = bs.may_attend(layout, layout.n, q.device)
    sdpa_times = sdpa_mask_times(q, k, v, allowed, do)
    sdpa_ms, sdpa_bwd_ms = (sdpa_fastest(sdpa_times[way]) for way in ("forward", "backward"))
    prefix = "" if case == "axial_row" else "conv_like_"
    parts = []
    for name, (kernel, plain) in kernels.items():
        ms, plain_ms = cuda_time_ms(kernel, iters=20), cuda_time_ms(plain, iters=5)
        rows[name].update({
            f"{prefix}ms_bf16": ms, f"{prefix}plain_ms_bf16": plain_ms,
            f"{prefix}bound_ms_bf16": bounds[name]["bound_ms"],
            f"{prefix}bound_by_bf16": bounds[name]["bound_by"],
            f"{prefix}library_ms_bf16": (sdpa_ms if name == "block_sparse_attention"
                                         else sdpa_bwd_ms)})
        parts.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f}, {bound_text(bounds[name])})")
    b, h, n, d = q.shape
    log(f"block_sparse {case} bf16 timing, cold L2 (b {b}, {h} x {d}, n {n}): "
        + "; ".join(parts) + f"; bf16 sdpa with the mask forward {sdpa_ms:.4f} / backward "
        f"{sdpa_bwd_ms:.4f} ms, the fastest of forward {sdpa_text(sdpa_times['forward'])}, "
        f"backward {sdpa_text(sdpa_times['backward'])}")


def flash_bounds(q, opts) -> dict:
    """{kernel: ``packed_bounds``} of the four tiled flash kernels on these
    inputs (``pair_work``), the key mask, pattern and visit map as passed:
    float32 at the split-3xTF32 rate with the CUDA-core bound beside."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    b, _, n, _ = q.shape
    km, pattern = opts["key_mask"], opts["pattern"]
    extra = (n // fa.TILE) ** 2 + (0 if km is None else b * n) + (0 if pattern is None else n * n)
    work = pair_work(q, fa.may_attend(n, q.device, km, opts["causal"], pattern), extra)
    return {name: packed_bounds(*work[role], q.dtype)
            for name, role in zip(FLASH_TPU_KERNELS, ("fwd", "dq", "dkdv", "fused"))}


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
    together: the backward kernels' yardstick) on the same heads; and in
    bf16 the forward, dq and dk/dv at the 512 px shape beside bf16 sdpa
    forward and backward and the bf16 bounds."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.testing import (
        BWD_BF16_ROW_REL, BWD_F32_REL, FLASH_BF16_ROW_REL, FLASH_F32_ATOL, flash_bwd_errors,
        flash_fwd_errors, flash_inputs)

    worst = {}  # name -> max abs error at its main path's shape, float32
    for case in ("train", "axial_col", "pattern", "noncausal", "d32", "d64", "d96", "d128",
                 "tiled", "one_block", "one_block_d32"):
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
            # the single-block kernel runs the dq and dk/dv sweeps with
            # delta summed in the dq pass's order: the chain's bits
            same_bits = all(torch.equal(a, b) for a, b in zip(got[6:], (dq, dk, dv)))
            chain = f", bitwise the dq + dk/dv chain's {same_bits}"
            if dtype == torch.float32:
                ok = err <= FLASH_F32_ATOL and max(rel, frel) <= BWD_F32_REL and same_bits
                tol = f"abs {FLASH_F32_ATOL:.0e} forward, relative {BWD_F32_REL:.0e} backward"
            else:
                ok = (row_rel <= FLASH_BF16_ROW_REL and lse_err <= FLASH_BF16_ROW_REL
                      and max(grad_row_rel, fgrad_row_rel) <= BWD_BF16_ROW_REL and same_bits)
                tol = (f"row-relative {FLASH_BF16_ROW_REL:.0e} and lse abs "
                       f"{FLASH_BF16_ROW_REL:.0e} forward, floored row-relative "
                       f"{BWD_BF16_ROW_REL:.0e} backward")
            log(f"flash {case} {dtype} {tuple(q.shape)}: forward max abs {err:.3e}, row "
                f"{row_rel:.3e}; dq + dk/dv relative L2 {rel:.3e}, floored row "
                f"{grad_row_rel:.3e}; single-block relative L2 {frel:.3e}, floored row "
                f"{fgrad_row_rel:.3e}{chain}; dead rows exactly 0 "
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
        bounds = flash_bounds(q, opts)
        sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, **sdpa_flash_kw(q, opts)), iters=10)
        sdpa_bwd_ms = cuda_time_ms(sdpa_flash_backward(q, k, v, do, opts), iters=10)
        if dtype == torch.bfloat16:  # beside the float32 path
            for name, (kernel, plain) in t.items():
                rows[name].update(
                    ms_bf16=cuda_time_ms(kernel, iters=10),
                    plain_ms_bf16=cuda_time_ms(plain, warmup=1, iters=3),
                    bound_ms_bf16=bounds[name]["bound_ms"],
                    bound_by_bf16=bounds[name]["bound_by"],
                    library_ms_bf16=sdpa_ms if name == "flash_attention_fwd" else sdpa_bwd_ms)
            continue
        for name, (kernel, plain) in t.items():
            rows[name].update(ms=cuda_time_ms(kernel, iters=10),
                              plain_ms=cuda_time_ms(plain, warmup=1, iters=3), **bounds[name],
                              library_ms=sdpa_ms if name == "flash_attention_fwd"
                              else sdpa_bwd_ms)
    name = "flash_attention_bwd_fused"
    for case, prefix in (("one_block", ""), ("one_block_d32", "d32_")):
        q, k, v, do, opts = flash_inputs(case, torch.bfloat16, "cuda", seed=1)
        o, lse = fa.flash_attention_fwd(q, k, v, **opts)
        bound = flash_bounds(q, opts)[name]
        rows[name].update({
            f"{prefix}ms_bf16": cuda_time_ms(
                lambda: fa.flash_attention_bwd_fused(q, k, v, o, lse, do, **opts), iters=20),
            f"{prefix}plain_ms_bf16": cuda_time_ms(lambda: fa.reference_flash_attention_bwd(
                q, k, v, o, lse, do, **opts), iters=5),
            f"{prefix}bound_ms_bf16": bound["bound_ms"],
            f"{prefix}bound_by_bf16": bound["bound_by"],
            f"{prefix}library_ms_bf16": cuda_time_ms(sdpa_flash_backward(q, k, v, do, opts),
                                                     iters=20),
            f"{prefix}split_chain_ms_bf16": cuda_time_ms(lambda: fa.flash_attention_dkdv(
                q, k, v, do, lse, fa.flash_attention_dq(q, k, v, o, lse, do, **opts)[1],
                **opts), iters=20)})
        q, k, v, do, opts = flash_inputs(case, torch.float32, "cuda", seed=1)
        o, lse = fa.flash_attention_fwd(q, k, v, **opts)
        _, delta = fa.flash_attention_dq(q, k, v, o, lse, do, **opts)
        t = dict(ms=cuda_time_ms(lambda: fa.flash_attention_bwd_fused(q, k, v, o, lse, do, **opts),
                                 iters=20),
                 plain_ms=cuda_time_ms(lambda: fa.reference_flash_attention_bwd(
                     q, k, v, o, lse, do, **opts), iters=5),
                 **flash_bounds(q, opts)[name],
                 library_ms=cuda_time_ms(sdpa_flash_backward(q, k, v, do, opts), iters=20),
                 # the yardstick of the same tiles: the split chain's two launches
                 split_chain_ms=cuda_time_ms(lambda: fa.flash_attention_dkdv(
                     q, k, v, do, lse, fa.flash_attention_dq(q, k, v, o, lse, do, **opts)[1],
                     **opts), iters=20))
        rows[name].update({prefix + key: value for key, value in t.items()})
    for name, row in rows.items():
        sdpa = "forward" if name == "flash_attention_fwd" else "backward"
        shapes = (("b 4, 16 x 64, n 4352", ""),)
        if name == "flash_attention_bwd_fused":
            shapes = (("b 2, 3 x 64, n 1280", ""), ("b 4, 16 x 32, n 1280", "d32_"))
        for shape, p in shapes:
            log(f"{name} float32 timing, cold L2 ({shape}, causal): kernel {row[p + 'ms']:.4f} "
                f"ms, plain {row[p + 'plain_ms']:.4f} ms, sdpa {sdpa} "
                f"{row[p + 'library_ms']:.4f} ms, "
                + bound_text({k: row[p + k] for k in ("bound_ms", "bound_by", "bound_cuda_core_ms")})
                + (f"; the split chain (dq then dk/dv) {row[p + 'split_chain_ms']:.4f} ms"
                   if p + "split_chain_ms" in row else "")
                + (f"; bf16 kernel {row[p + 'ms_bf16']:.4f} ms, plain "
                   f"{row[p + 'plain_ms_bf16']:.4f} ms, sdpa {sdpa} "
                   f"{row[p + 'library_ms_bf16']:.4f} ms, bound {row[p + 'bound_ms_bf16']:.4f} "
                   f"ms ({row[p + 'bound_by_bf16']})" if p + "ms_bf16" in row else "")
                + (f", the bf16 split chain {row[p + 'split_chain_ms_bf16']:.4f} ms"
                   if p + "split_chain_ms_bf16" in row else ""))
    return [rows[name] for name in FLASH_TPU_KERNELS]


def decode_bound(b: int, L: int, h: int, d: int, idx: int, dtype, masked: bool = False,
                 rotary: bool = True):
    """(bound_ms, bound_by) of one fused decode step: bytes = the K and V
    rows [0, idx) of every head, the qkv row, one cos and one sin row (with
    ``rotary``), the key mask's rows [0, idx] when given, and out, k_row
    and v_row, each once; operations = 2 * 2 * d per (head, live key) of
    the idx + 1 keys (scores and value products)."""
    item = torch.tensor([], dtype=dtype).element_size()
    hd = h * d
    nbytes = (2 * idx * hd + 3 * hd + 3 * hd) * b * item + (2 * d * item if rotary else 0)
    nbytes += 4 * b * (idx + 1) if masked else 0
    ops = 4 * b * h * (idx + 1) * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_decode_attention() -> dict:
    """The fused decode kernel against its plain version on
    ``testing.decode_inputs`` at the flagship's shapes (16 heads of 64, L
    1281, b 1 and b 8, idx 0, 1, 256, 700 and 1279, rotary and key mask
    on and off; 127 / 128 and 255 / 256, where the split S changes at b
    1, and 511 / 512, rotary with and without a key mask), a key
    mask that kills one whole slice of the split (``decode_slices``) at
    idx 767, the masked own key with an extreme score, and dim_head 32 /
    128 (b 8, idx 700, rotary, key mask), float32 and bfloat16, at
    ``testing``'s tolerances: k_row and v_row bitwise, rows with no live
    key exactly 0, two runs identical. Then times (cold L2) at b 1 and b
    8, idx 768, bf16, rotary, no key mask (the generate path's): the
    kernel at ``decode_splits``' S, its plain version, the bound, and
    ``scaled_dot_product_attention`` over the written cache view (b, h,
    idx + 1, d) as a yardstick (attention alone, no rotary); and the
    kernel at every S beside it."""
    from dalle_pytorch_tpu_torch.ops import decode_attention as da
    from dalle_pytorch_tpu_torch.testing import (
        DECODE_BF16_ROW_REL, DECODE_F32_ATOL, decode_errors, decode_inputs, decode_ok)

    L, h = 1281, 16
    cases = [(b, 64, idx, rot, masked, False) for b in (1, 8) for idx in (0, 1, 256, 700, 1279)
             for rot in (True, False) for masked in (False, True)]
    cases += [(b, 64, idx, True, masked, False) for b in (1, 8)
              for idx in (127, 128, 255, 511, 512) for masked in (False, True)]
    cases += [(b, 64, 767, True, "slice", False) for b in (1, 8)]
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
                km = x[5] if masked is True else None
                if masked == "slice":  # every key of the middle slice masked
                    splits = da.decode_splits(b * h, idx)
                    lo, hi = da.decode_slices(idx, splits)[splits // 2]
                    km = torch.ones(b, L, dtype=torch.int32, device="cuda")
                    km[:, lo:hi] = 0
                x = (*x[:3], *(x[3:5] if rot else (None, None)), km)
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
            f" ({n} cases: idx, rotary, key mask, a dead slice, float32 and bf16): float32 max "
            f"abs {f32:.3e} (tolerance {DECODE_F32_ATOL:.0e}), bf16 row-relative {bf16:.3e} "
            f"(tolerance {DECODE_BF16_ROW_REL:.0e}); k/v rows bitwise, rows with no live key "
            "0, two runs identical")
    row = {"name": "fused_decode_attention", "route": "cuda",
           "source": "dalle_pytorch_tpu_torch/csrc/decode_attention.cu",
           "replaces": DECODE_TPU_KERNEL, "max_abs_err": worst[torch.float32],
           "max_rel_err_bf16": worst[torch.bfloat16]}
    idx = 768
    for b in (1, 8):
        qkv, kc, vc, cos, sin, _ = decode_inputs(b, L, h, 64, idx, torch.bfloat16, "cuda",
                                                 seed=1)
        q = qkv[..., :h * 64].view(b, 1, h, 64).transpose(1, 2)
        kv = [t.view(b, L, h, 64)[:, :idx + 1].transpose(1, 2) for t in (kc, vc)]
        splits = da.decode_splits(b * h, idx)
        # with the rotary tables (generate's rotary flagship) and without
        # them (learned positions: the tables null, nothing rotated)
        for rot in (True, False):
            args = (qkv, kc, vc, idx, *((cos, sin) if rot else (None, None)), None)
            kernel_ms = cuda_time_ms(lambda: da.fused_decode_attention(*args, heads=h))
            plain_ms = cuda_time_ms(lambda: da.reference_fused_decode(*args, h))
            library_ms = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, *kv))
            bound_ms, bound_by = decode_bound(b, L, h, 64, idx, torch.bfloat16, rotary=rot)
            by_split = {s: cuda_time_ms(
                lambda: da.fused_decode_attention(*args, heads=h, splits=s))
                for s in da.DECODE_SPLITS} if rot else {}
            log(f"fused_decode_attention bf16 timing, cold L2 (b {b}, 16 x 64, idx {idx}, L {L}, "
                f"{'rotary' if rot else 'no rotary'}): kernel {kernel_ms:.4f} ms at S {splits}, "
                f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})" + ("; kernel by S " if by_split else "")
                + ", ".join(f"{s}: {t:.4f}" for s, t in by_split.items()))
            timing = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "splits": splits}
            suffix = ("" if b == 1 else "_b8") + ("" if rot else "_norot")
            row.update({f"{k}{suffix}": v for k, v in timing.items()})
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
            engine = Engine(model, EngineConfig(max_batch=3, fused_iteration=True, prefill_chunk=4,
                                                page_size=4,
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


SPLIT_CFG = dict(dim=128, depth=2, heads=2, dim_head=64, num_text_tokens=50, text_seq_len=8,
                 num_image_tokens=40, image_fmap_size=4)
# train_dalle.py's default positions: learned, without token shift
LEARNED_POS = dict(rotary_emb=False, shift_tokens=False)


def card_and_cpu(cfg: dict, seed: int):
    """A small float32 DALLE with seeded weights on the card and the same
    weights on the CPU."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    gpu = DALLE(**cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(seed))
    cpu = DALLE(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    return gpu, cpu


def serve_small(model, prompts, faults=None, **config):
    """``prompts`` (one request each, 16 tokens, seed 20 + i) through a
    fresh engine (max_batch 3, page 4, ``config``) on the model's device;
    returns (engine, results)."""
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Request

    engine = Engine(model, EngineConfig(max_batch=3, page_size=4, **config),
                    device=model.device.type, faults=faults)
    for i, prompt in enumerate(prompts):
        assert engine.submit(Request(f"q{i}", prompt, 16, seed=20 + i)) is None
    return engine, engine.run(max_steps=2000)


def split_prompts() -> np.ndarray:
    """The split checks' 4 prompts (text 8, ragged zero tails)."""
    prompts = np.random.RandomState(10).randint(1, 50, size=(4, 8))
    for i in range(4):
        prompts[i, 8 - 2 * i:] = 0
    return prompts


def check_split_engine_on_card() -> None:
    """The split engine on the card (``fused_iteration=False``): a small
    float32 DALLE (``SPLIT_CFG``: prompt 9 positions, 16 image tokens,
    page 4), identical weights on the card (kernels) and the CPU (plain
    versions), 4 requests at max_batch 3, greedy. For unquantized and
    int8 pages, chunks of 4 (4-5: the 1-token tail merged) and monolithic
    prefill, lookahead on and off: every outcome COMPLETED, the tokens
    identical on the card and the CPU, the ragged instance of the pages'
    format launched depth x dispatches (prefills, chunks and decode
    steps) times and the other never. Then ``check_split_model_on_card``
    and ``check_split_faults_on_card``."""
    from dalle_pytorch_tpu_torch.serving.types import Outcome

    gpu, cpu = card_and_cpu(SPLIT_CFG, 9)
    prompts = split_prompts()
    depth = SPLIT_CFG["depth"]
    for kv_quant in (None, "int8"):
        for chunk in (4, None):
            for lookahead in (True, False):
                config = dict(prefill_chunk=chunk, decode_lookahead=lookahead,
                              kv_quant=kv_quant, filter_thres=0.99)
                zero_counts()
                engine, on_card = serve_small(gpu, prompts, **config)
                launched = read_counts(RAGGED)
                _, on_cpu = serve_small(cpu, prompts, **config)
                done = all(r.outcome is Outcome.COMPLETED and len(r.tokens) == 16
                           for run in (on_card, on_cpu) for r in run.values())
                same = all(np.array_equal(on_card[r].tokens, on_cpu[r].tokens)
                           for r in on_card)
                want = {n: depth * engine.dispatches
                        if n.endswith("int8") == (kv_quant == "int8") else 0 for n in RAGGED}
                log(f"split engine on the card, pages {kv_quant or 'none'}, "
                    f"{'chunk 4' if chunk else 'monolithic'}, lookahead {lookahead}: every "
                    f"outcome COMPLETED {done}, tokens card = CPU {same}; "
                    f"{engine.dispatches} dispatches ({engine.prefill_dispatches} prefill), "
                    f"launches {launched} (expected {want})")
                if not (done and same and launched == want):
                    raise AssertionError(f"split engine on the card failed: {config}")
    check_split_model_on_card(gpu, cpu)
    check_split_faults_on_card(gpu, prompts)


def check_learned_pos_on_card() -> None:
    """Serving and generating with learned positions on the card:
    ``SPLIT_CFG`` with ``LEARNED_POS`` (train_dalle.py's defaults), then
    the same with ``stable``, identical float32 weights on the card
    (kernels) and the CPU (plain versions), greedy. The split engine with
    chunks of 4 and with monolithic prefill, and the fused iteration
    (chunk 4), 4 requests at max_batch 3: every outcome COMPLETED, tokens
    card = CPU, the ragged kernel launched depth x dispatches times and
    its int8 instance never. Then ``generate_image_tokens`` of 2 captions
    on the "4d" cache with the decode kernel (no rotary tables), window
    0: tokens card = CPU (the CPU's ``fused_decode=True`` runs the
    kernel's plain version), the decode kernel launched depth x (image
    positions - 1) times and no other kernel."""
    from dalle_pytorch_tpu_torch.models.sampling import generate_image_tokens
    from dalle_pytorch_tpu_torch.serving.types import Outcome

    prompts = split_prompts()
    depth = SPLIT_CFG["depth"]
    names = tuple(kernel_counters())
    for label, extra in (("learned positions", {}), ("learned positions, stable",
                                                     dict(stable=True))):
        gpu, cpu = card_and_cpu({**SPLIT_CFG, **LEARNED_POS, **extra}, 9)
        report = []
        for path, config in (("split chunk 4", dict(prefill_chunk=4)),
                             ("split monolithic", dict(prefill_chunk=None)),
                             ("fused chunk 4", dict(fused_iteration=True, prefill_chunk=4))):
            zero_counts()
            engine, on_card = serve_small(gpu, prompts, filter_thres=0.99, **config)
            launched = read_counts(names)
            _, on_cpu = serve_small(cpu, prompts, filter_thres=0.99, **config)
            done = all(r.outcome is Outcome.COMPLETED and len(r.tokens) == 16
                       for run in (on_card, on_cpu) for r in run.values())
            same = all(np.array_equal(on_card[r].tokens, on_cpu[r].tokens) for r in on_card)
            want = {n: depth * engine.dispatches if n == "ragged_attention" else 0
                    for n in names}
            report.append(f"{path}: COMPLETED {done}, tokens card = CPU {same}, "
                          f"{engine.dispatches} dispatches, ragged launches "
                          f"{launched['ragged_attention']} (expected "
                          f"{want['ragged_attention']})")
            if not (done and same and launched == want):
                raise AssertionError(f"{label} on the card, {path}: {report[-1]}; {launched}")
        text = torch.from_numpy(prompts[:2])
        tokens = {}
        for m in (gpu, cpu):
            zero_counts()
            tokens[m] = generate_image_tokens(m, text.to(m.device), 0, filter_thres=0.99,
                                              cache_format="4d", fused_decode=True,
                                              window_seg=0).cpu()
            if m is gpu:
                launched = read_counts(names)
        want = {n: depth * (gpu.image_seq_len - 1) if n == "fused_decode_attention" else 0
                for n in names}
        same = torch.equal(tokens[gpu], tokens[cpu])
        report.append(f"generate 4d with the decode kernel: tokens card = CPU {same}, decode "
                      f"launches {launched['fused_decode_attention']} (expected "
                      f"{want['fused_decode_attention']})")
        log(f"{label} on the card (SPLIT_CFG, float32, greedy): " + "; ".join(report))
        if not (same and launched == want):
            raise AssertionError(f"{label} on the card: {report[-1]}; {launched}")


def check_split_model_on_card(gpu, cpu) -> None:
    """The split path's model calls, card (kernels) against CPU (plain),
    ``testing.LOGITS_F32_ATOL``: each chunking the engine makes of the
    9-position prompt (2-2-2-3, 3-3-3, 4-5) against one ``prefill_step``
    on the same device, both devices; then 3 rows prefilled alone to 5, 9
    and 7 positions, landed in one batched cache, and 8 vector
    ``decode_step`` calls at the rows' own positions (text and image
    positions mixed, teacher-forced), logits card against CPU; the
    ragged kernel launched depth x calls times."""
    from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache, insert_decode_cache
    from dalle_pytorch_tpu_torch.testing import LOGITS_F32_ATOL

    rng = np.random.RandomState(16)
    text = torch.from_numpy(rng.randint(1, 50, size=(3, 8)))
    text[2, 6:] = 0
    ids = torch.cat((gpu.remap_text(text), torch.from_numpy(rng.randint(0, 40, size=(3, 16)))), 1)
    T = gpu.text_len_internal
    chunkings = ((2, 2, 2, 3), (3, 3, 3), (4, 5))
    worst_chunk, logits = 0.0, {}
    zero_counts()
    for m in (gpu, cpu):
        x = ids.to(m.device)
        ref = m.prefill_step(x[:2, :T], init_decode_cache(m, 2, "paged", page_size=4))
        for widths in chunkings:
            cache, start = init_decode_cache(m, 2, "paged", page_size=4), 0
            for c in widths:
                got = m.prefill_chunk(x[:2, start:start + c], start, cache)
                start += c
            worst_chunk = max(worst_chunk, (got - ref).abs().max().item())
        cache = init_decode_cache(m, 3, "paged", page_size=4)
        starts = torch.tensor([5, T, 7], dtype=torch.int32)
        for r, n in enumerate(starts.tolist()):
            row = init_decode_cache(m, 1, "paged", page_size=4)
            m.prefill_chunk(x[r:r + 1, :n], 0, row, return_logits=False)
            insert_decode_cache(cache, row, r)
        steps = []
        for k in range(8):
            pos = starts + k
            steps.append(m.decode_step(x[torch.arange(3), pos.long()], pos.to(m.device), cache))
        logits[m] = torch.stack(steps, 1).cpu()
        if m is gpu:
            launched = read_counts(RAGGED)["ragged_attention"]
    calls = 1 + sum(len(w) for w in chunkings) + 3 + 8
    worst = (logits[gpu] - logits[cpu]).abs().max().item()
    log(f"split model on the card: prefill_chunk chunkings against prefill_step, max abs "
        f"logit diff {worst_chunk:.3e} (card and CPU); vector decode_step at rows 5/9/7 + k, "
        f"card vs CPU, max abs diff {worst:.3e} (tolerance {LOGITS_F32_ATOL:.0e}); ragged "
        f"launches {launched} (expected {SPLIT_CFG['depth'] * calls})")
    if not (worst_chunk <= LOGITS_F32_ATOL and worst <= LOGITS_F32_ATOL
            and launched == SPLIT_CFG["depth"] * calls):
        raise AssertionError(f"split model calls disagree: {worst_chunk} {worst} {launched}")


def check_split_faults_on_card(gpu, prompts) -> None:
    """Faults on the card's split engine (chunks of 4, top-k sampling
    with the seeded noise): ``prefill_fail`` once retries its request,
    whose tokens are the unfaulted run's; armed ``prefill_attempts`` (2)
    times it ends q0 PREFILL_FAILED with the pool empty and the other
    requests unchanged; ``page_exhaust`` preempts, and the replay is
    bit-identical to the unfaulted run."""
    from dalle_pytorch_tpu_torch.serving.types import Outcome
    from dalle_pytorch_tpu_torch.utils.faults import FaultRegistry

    config = dict(prefill_chunk=4, filter_thres=0.5)
    _, clean = serve_small(gpu, prompts, **config)
    tokens = lambda run, r: None if run[r].tokens is None else run[r].tokens.tolist()  # noqa: E731
    report = []
    for site, count in (("prefill_fail", 1), ("prefill_fail", 2), ("page_exhaust", 1)):
        faults = FaultRegistry()
        faults.arm(site, count)
        engine, run = serve_small(gpu, prompts, faults=faults, **config)
        failed = [r for r, x in run.items() if x.outcome is Outcome.PREFILL_FAILED]
        ok = all(tokens(run, r) == tokens(clean, r) for r in run if r not in failed)
        ok = ok and engine.pool.used == 0 and not any(engine.slots)
        ok = ok and faults.fired == {site: count}
        if site == "page_exhaust":
            ok = ok and sum(x.preempt_count for x in run.values()) == 1 and not failed
        elif count == 1:
            ok = ok and not failed and run["q0"].prefill_attempts == 1
        else:
            ok = ok and failed == ["q0"] and run["q0"].tokens is None
        report.append(f"{site} x{count}: outcomes "
                      f"{sorted({x.outcome.value for x in run.values()})}, attempts "
                      f"{[x.prefill_attempts for x in run.values()]}, preempts "
                      f"{[x.preempt_count for x in run.values()]}, passed {ok}")
        if not ok:
            raise AssertionError(f"split faults on the card: {report[-1]}")
    log("split faults on the card: " + "; ".join(report))


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


# entry functions of the split-3xTF32 float32 instances in each library
# (``log_sass_report``): packed forward at dim_head 32/64/128, packed dq
# and dk/dv at the same, tiled forward, dq, dk/dv and single-block
# backward at 32/64/96/128, the pair grid's forward, dq and dk/dv at
# 32/64/128
TF32_INSTANCES = {"fused_qkv_attention": 3, "fused_qkv_attention_bwd": 6, "flash_attention": 16,
                  "block_sparse_attention": 9}
TF32_HMMA = "HMMA.1688.F32.TF32"
# entry functions of the bf16 tensor-core instances checked the same way:
# the tiled forward, dq, dk/dv and single-block backward at 32/64/96/128,
# the pair grid's forward, dq and dk/dv at 32/64/128
BF16_INSTANCES = {"flash_attention": 16, "block_sparse_attention": 9}
BF16_HMMA = "HMMA.16816.F32.BF16"


def log_sass_report(names) -> None:
    """Tensor-core instructions in the built libraries of ``names``, from
    ``cuobjdump -sass``: per entry function whose name holds
    "_tc_kernel" or "_tf32_kernel", the count of HMMA instructions by
    mnemonic. Raises unless each library has its ``TF32_INSTANCES``
    "_tf32_kernel" functions (the float32 instances) and every one holds
    ``TF32_HMMA``, and, for the libraries of ``BF16_INSTANCES``, that
    many "_tc_kernel" functions (16 tiled + 9 pair-grid), every one
    holding ``BF16_HMMA``."""
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
        tf32_fns = bf16_fns = 0
        for fn, ops in counts.items():
            if "_tc_kernel" not in fn and "_tf32_kernel" not in fn:
                continue
            log(f"sass {name} {fn}: " + (", ".join(f"{op} x{c}" for op, c in sorted(ops.items()))
                                         or "no HMMA"))
            if "_tf32_kernel" in fn:
                tf32_fns += 1
                if TF32_HMMA not in ops:
                    missing.append(fn)
            elif name in BF16_INSTANCES:
                bf16_fns += 1
                if BF16_HMMA not in ops:
                    missing.append(fn)
        if tf32_fns != TF32_INSTANCES.get(name, 0):
            missing.append(f"{name}: {tf32_fns} float32 instances, expected "
                           f"{TF32_INSTANCES.get(name, 0)}")
        if name in BF16_INSTANCES and bf16_fns != BF16_INSTANCES[name]:
            missing.append(f"{name}: {bf16_fns} bf16 tensor-core instances, expected "
                           f"{BF16_INSTANCES[name]}")
    if missing:
        raise AssertionError(f"instances without {TF32_HMMA} / {BF16_HMMA}: {missing}")


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


def check_train_against_plain(variant: str = "dense", dtype=torch.float32,
                              seed: int = 7, steps: int = 1) -> tuple:
    """Small DALLE, identical float32 weights on the card (kernels) and
    the CPU (plain versions), each kernel launched exactly as the
    variant's attention path says (every other kernel never). float32:
    the loss to relative 1e-5 and every parameter's gradient to 1e-4 of
    its largest entry. bfloat16 (computing in bf16 on float32 parameters,
    as ``DalleTrainer(bf16=True)`` trains, so the kernels' bf16 instances
    run): the card's loss and every gradient within
    ``testing.BF16_GAP_FACTOR`` times the CPU's bf16-to-float32 gap of
    the CPU's bf16 run (``testing.gap_ratio``). "dense": depth 2, 2 heads
    of 64, text 64 + an 8 x 8 grid (n 128; token shift, rotary), each
    packed kernel once per layer. "sparse": depth 4 cycling the four
    types, text 64 + a 24 x 24 grid (n 640, where the axial_row and
    conv_like layouts visit 12 of 15 block pairs and engage): the three
    block-sparse kernels once per axial_row and conv_like layer, the
    packed ones once per full and axial_col layer. "tiled": text 128 + a
    32 x 32 grid (n 1152, 3 x 3 flash blocks of 384): the tiled forward,
    dq and dk/dv once per layer. "one_block": 3 heads, text 128 + a 16 x
    16 grid (n 384, one flash block the packed kernel refuses): the tiled
    forward and the single-block backward once per layer. "learned_pos":
    "dense" with learned positions (``rotary_emb=False``, no token shift:
    train_dalle.py's defaults), each packed kernel's no-rotary instance
    once per layer; "stable": the same with ``stable``. The weights come
    from ``seed``, the tokens from ``seed + 1``. With ``steps`` > 1 the
    card's model then takes a clipped-Adam step (``make_train_step``, lr
    3e-4), its parameters are copied to the CPU's models, and the check
    repeats, ``steps`` checks in all. Returns the card run's launches (of
    one check) and the worst (loss error, gradient error) checked."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step
    from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio
    from dalle_pytorch_tpu_torch.train_dalle import dalle_loss

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
    elif variant in ("learned_pos", "stable"):
        cfg.update(LEARNED_POS, stable=variant == "stable")
    mixed = dict(dtype=dtype, param_dtype=torch.float32)
    gpu = DALLE(**cfg, device="cuda", **mixed).init_weights(
        torch.Generator(device="cuda").manual_seed(seed))
    cpu = DALLE(**cfg, device="cpu", **mixed)
    models = [gpu, cpu]
    if dtype != torch.float32:  # the CPU's float32 run: the bf16 error's scale
        models.append(DALLE(**cfg, device="cpu"))
    for m in models[1:]:
        m.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.RandomState(seed + 1)
    text = rng.randint(1, 50, size=(2, cfg["text_seq_len"]))
    text[0, 40:], text[1, 9:] = 0, 0
    image = rng.randint(0, 40, size=(2, cfg["image_fmap_size"] ** 2))
    names = tuple(kernel_counters())
    expected = {n: int(per_layer.get(n, 0) * cfg["depth"]) for n in names}
    batch = {"text": torch.from_numpy(text).cuda(), "image": torch.from_numpy(image).cuda()}
    state, step_fn = create_train_state(gpu), make_train_step(dalle_loss, 0.5)
    worst_loss = worst_grad = 0.0
    for step in range(steps):
        losses, grads = [], []
        for m in models:
            m.zero_grad(set_to_none=True)
            zero_counts()
            t, i = (torch.from_numpy(a).to(m.device) for a in (text, image))
            loss = m(t, i, return_loss=True)
            loss.backward()
            losses.append(loss.item())
            grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
            if m is gpu:
                launched = read_counts(names)
        if dtype == torch.float32:
            loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
            worst = max((grads[0][k] - g).abs().max().item() / g.abs().max().item()
                        for k, g in grads[1].items())
            ok = loss_err <= 1e-5 and worst <= 1e-4
            what = (f"relative {loss_err:.3e}; worst gradient error {worst:.3e} of its largest "
                    f"entry")
        else:
            loss_err = gap_ratio(*losses)
            worst, worst_name = max((gap_ratio(grads[0][k], g, grads[2][k]), k)
                                    for k, g in grads[1].items())
            ok = loss_err <= BF16_GAP_FACTOR and worst <= BF16_GAP_FACTOR
            what = (f"{loss_err:.3f} of the CPU's bf16-to-float32 gap (CPU bf16 "
                    f"{losses[1]:.6f}, float32 {losses[2]:.6f}, card {losses[0]:.6f}); worst "
                    f"gradient {worst:.3f} of its gap ({worst_name}; tolerance "
                    f"{BF16_GAP_FACTOR} of the gap)")
        at = f", step {step}" if steps > 1 else ""
        log(f"path check: card (kernels) vs CPU (plain) DALLE training loss ({variant}, "
            f"{dtype}, n {gpu.total_seq_len}, {cfg['heads']} heads{at}), {what}; launches "
            f"{ {n: c for n, c in launched.items() if c or expected[n]} }")
        if not (ok and launched == expected):
            raise AssertionError(f"training path disagrees ({variant}, {dtype}{at}): "
                                 f"{loss_err}, {worst}, {launched}, expected {expected}")
        worst_loss, worst_grad = max(worst_loss, loss_err), max(worst_grad, worst)
        if step + 1 < steps:
            state, _ = step_fn(state, gpu, batch, 3e-4)
            for m in models[1:]:
                m.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    return {name: n for name, n in launched.items() if n}, (worst_loss, worst_grad)


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
    model = DALLE(**SERVE_MODEL, **bf16).init_weights(gen(0))
    vae = DiscreteVAE(**FLAGSHIP_VAE, **bf16).init_weights(gen(1))
    clip = CLIP(**FLAGSHIP_CLIP, **bf16).init_weights(gen(2))
    engine = Engine(model, EngineConfig(
        max_batch=MAX_BATCH, fused_iteration=True, prefill_chunk=CHUNK,
    ), device="cuda", stages=StageSpec(vae, clip, config=StageConfig(
        batch=STAGE_BATCH, queue_limit=N_REQUESTS)))
    for request in serve_requests(N_REQUESTS, MAX_NEW):
        assert engine.submit(request) is None
    torch.cuda.synchronize()
    log(f"engine: flagship DALLE (depth {SERVE_MODEL['depth']}), VAE and CLIP built in "
        f"{time.perf_counter() - t0:.1f} s")

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
    rerank_dispatches = pipe.dispatches[STAGE_RERANK]
    expected = {"ragged_attention": SERVE_MODEL["depth"] * engine.dispatches,
                "ragged_attention_int8": 0,
                "fused_qkv_attention": FLAGSHIP_CLIP["text_enc_depth"] * rerank_dispatches}
    stage_s = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(pipe.seconds.items()))
    log(f"engine: {N_REQUESTS} requests, {engine.iterations} iterations, "
        f"{engine.dispatches} dispatches, {wall:.2f} s wall (stages included), "
        f"{N_REQUESTS * MAX_NEW / wall:.1f} generated tokens/s; stage seconds: "
        f"{stage_s}; stage dispatches {pipe.dispatches}")
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
    engine = Engine(model, EngineConfig(max_batch=MAX_BATCH, fused_iteration=True,
                                        prefill_chunk=CHUNK, **config),
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
    depth = SERVE_MODEL["depth"]
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
    axial_col, conv_like) at the flagship width, depth 4 (each type once,
    ``SPARSE_SERVE_MODEL``), bf16, int8 pages, 4 requests of 256 tokens:
    the full layers
    through the int8 ragged instance, the others over the gathered view.
    Returns the launches."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    types = tuple(SPARSE_TYPES.split(","))
    model = DALLE(**SPARSE_SERVE_MODEL, attn_types=types, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device="cuda").manual_seed(4))
    full = sum(t == "full" for t in model.transformer.attn_types)
    _, _, launches = serve_counted(model, "serve sparse int8", 4, 256,
                                   {"ragged_attention_int8": full}, kv_quant="int8")
    return launches


def serve_split(model, stages, fused_results) -> tuple:
    """Phase 5e: the flagship of phase 5 served by the split engine
    (``fused_iteration=False``, max_batch 8, chunks of 16: batch-1 chunks,
    then the vector decode step) with phase 5's VAE and CLIP stages, its
    first ``SPLIT_REQUESTS`` requests: every outcome COMPLETED with 1024
    tokens in range, a finite image and a finite score; the ragged kernel
    launched depth x dispatches (decode steps and chunks) times, the int8
    instance never, the packed-qkv kernel text depth x rerank dispatches
    times; token agreement with phase 5's fused results printed, not
    asserted (bf16, products of other shapes). Then 2 requests of 64
    tokens with monolithic prefill, no stages: 2 prefill dispatches (one
    prompt block of 257 columns a layer each) and the decode steps, the
    ragged kernel depth x dispatches times. Returns the two runs'
    launches."""
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.postdecode import STAGE_RERANK, StageConfig, StageSpec
    from dalle_pytorch_tpu_torch.serving.types import Outcome

    depth = SERVE_MODEL["depth"]
    engine = Engine(model, EngineConfig(max_batch=MAX_BATCH, prefill_chunk=CHUNK), device="cuda",
                    stages=StageSpec(stages.vae, stages.clip, config=StageConfig(
                        batch=STAGE_BATCH, queue_limit=SPLIT_REQUESTS)))
    for request in serve_requests(SPLIT_REQUESTS, MAX_NEW):
        assert engine.submit(request) is None
    zero_counts()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts((*RAGGED, "fused_qkv_attention"))
    for rid, r in results.items():
        if r.outcome is not Outcome.COMPLETED or len(r.tokens) != MAX_NEW:
            raise AssertionError(f"serve split: request {rid}: {r.outcome} {r.detail!r}")
        if not ((r.tokens >= 0) & (r.tokens < FLAGSHIP["num_image_tokens"])).all():
            raise AssertionError(f"serve split: request {rid}: token out of the image vocab")
        if r.image is None or r.image.shape != (256, 256, 3) or not np.isfinite(r.image).all():
            raise AssertionError(f"serve split: request {rid}: no finite (256, 256, 3) image")
        if r.rerank_score is None or not np.isfinite(r.rerank_score):
            raise AssertionError(f"serve split: request {rid}: rerank score {r.rerank_score}")
    rerank_dispatches = engine.postdecode.dispatches[STAGE_RERANK]
    expected = {"ragged_attention": depth * engine.dispatches, "ragged_attention_int8": 0,
                "fused_qkv_attention": FLAGSHIP_CLIP["text_enc_depth"] * rerank_dispatches}
    agree = [float(np.mean(results[r].tokens == fused_results[r].tokens)) for r in results]
    log(f"serve split: {SPLIT_REQUESTS} requests of {MAX_NEW} tokens (VAE and CLIP stages), "
        f"{engine.iterations} iterations, {engine.dispatches} dispatches "
        f"({engine.dispatches - engine.prefill_dispatches} decode steps, "
        f"{engine.prefill_dispatches} chunks), {wall:.2f} s wall, "
        f"{SPLIT_REQUESTS * MAX_NEW / wall:.1f} generated tokens/s; launches {launches} "
        f"(expected {expected}); position-wise token agreement with the fused engine per "
        f"request " + ", ".join(f"{a:.4f}" for a in agree))
    if launches != expected:
        raise AssertionError(f"serve split: kernel launches {launches}, expected {expected}")

    mono = Engine(model, EngineConfig(max_batch=MAX_BATCH), device="cuda")
    for request in serve_requests(2, 64):
        assert mono.submit(request) is None
    zero_counts()
    t0 = time.perf_counter()
    mono_results = mono.run()
    torch.cuda.synchronize()
    mono_wall = time.perf_counter() - t0
    mono_launches = read_counts(RAGGED)
    mono_expected = {"ragged_attention": depth * mono.dispatches, "ragged_attention_int8": 0}
    done = all(r.outcome is Outcome.COMPLETED and len(r.tokens) == 64
               for r in mono_results.values())
    log(f"serve split monolithic: 2 requests of 64 tokens, {mono.prefill_dispatches} prompt "
        f"blocks of {model.text_len_internal} columns, {mono.dispatches} dispatches, "
        f"{mono_wall:.2f} s wall; every outcome COMPLETED {done}; launches {mono_launches} "
        f"(expected {mono_expected})")
    if not (done and mono.prefill_dispatches == 2 and mono_launches == mono_expected):
        raise AssertionError(f"serve split monolithic: {done} {mono.prefill_dispatches} "
                             f"{mono_launches}")
    return launches, mono_launches


def learned_pos_model():
    """``SERVE_MODEL`` with train_dalle.py's default positions
    (``LEARNED_POS``), bf16, seeded random weights (the axial grid's
    tables N(0, 1), as flax draws them)."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    return DALLE(**SERVE_MODEL, **LEARNED_POS, device="cuda", dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(0))


def serve_learned_pos(stages) -> tuple:
    """Phase 5f: ``learned_pos_model()`` served by ``EngineConfig()`` (the
    split path with monolithic prefill, max_batch 4, the reference's
    defaults) with phase 5's VAE and CLIP stages, ``LEARNED_POS_REQUESTS``
    requests of 1024 tokens: every outcome COMPLETED with 1024 tokens in
    range, a finite image and a finite score; the ragged kernel launched
    depth x dispatches (prompt blocks and decode steps) times, its int8
    instance never, the packed-qkv kernel CLIP's text depth x rerank
    dispatches times. Prints wall, tokens/s and launches per dispatch.
    Returns (the model, the launches)."""
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.postdecode import STAGE_RERANK, StageConfig, StageSpec
    from dalle_pytorch_tpu_torch.serving.types import Outcome

    depth = SERVE_MODEL["depth"]
    model = learned_pos_model()
    engine = Engine(model, EngineConfig(), device="cuda",
                    stages=StageSpec(stages.vae, stages.clip, config=StageConfig(
                        batch=STAGE_BATCH, queue_limit=LEARNED_POS_REQUESTS)))
    for request in serve_requests(LEARNED_POS_REQUESTS, MAX_NEW):
        assert engine.submit(request) is None
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts((*RAGGED, "fused_qkv_attention"))
    for rid, r in results.items():
        if r.outcome is not Outcome.COMPLETED or len(r.tokens) != MAX_NEW:
            raise AssertionError(f"serve learned_pos: request {rid}: {r.outcome} {r.detail!r}")
        if not ((r.tokens >= 0) & (r.tokens < FLAGSHIP["num_image_tokens"])).all():
            raise AssertionError(f"serve learned_pos: request {rid}: token out of the image vocab")
        if r.image is None or r.image.shape != (256, 256, 3) or not np.isfinite(r.image).all():
            raise AssertionError(f"serve learned_pos: request {rid}: no finite (256, 256, 3) "
                                 "image")
        if r.rerank_score is None or not np.isfinite(r.rerank_score):
            raise AssertionError(f"serve learned_pos: request {rid}: rerank score "
                                 f"{r.rerank_score}")
    rerank_dispatches = engine.postdecode.dispatches[STAGE_RERANK]
    expected = {"ragged_attention": depth * engine.dispatches, "ragged_attention_int8": 0,
                "fused_qkv_attention": FLAGSHIP_CLIP["text_enc_depth"] * rerank_dispatches}
    log(f"serve learned_pos: {LEARNED_POS_REQUESTS} requests of {MAX_NEW} tokens, "
        f"EngineConfig() (split, monolithic prefill, max_batch {engine.config.max_batch}; VAE "
        f"and CLIP stages), {engine.iterations} iterations, {engine.dispatches} dispatches "
        f"({engine.prefill_dispatches} prompt blocks of {model.text_len_internal} columns, "
        f"{engine.dispatches - engine.prefill_dispatches} decode steps), {wall:.2f} s wall, "
        f"{LEARNED_POS_REQUESTS * MAX_NEW / wall:.1f} generated tokens/s; launches {launches} "
        f"(expected {expected}), ragged launches per dispatch "
        f"{launches['ragged_attention'] / engine.dispatches:.1f}; rerank scores "
        + ", ".join(f"{results[r].rerank_score:.4f}" for r in sorted(results)))
    if launches != expected:
        raise AssertionError(f"serve learned_pos: kernel launches {launches}, expected "
                             f"{expected}")
    return model, launches


def generate_learned_pos(model) -> dict:
    """Phase 5g: ``learned_pos_model()`` generating outside the engine,
    batch 1 on the "4d" cache with the decode kernel (no rotary tables),
    window 0: the prompt's prefill, then ``LEARNED_POS_TOKENS`` - 1 decode
    steps (``decode_tokens(num_steps=...)``): ``LEARNED_POS_TOKENS`` image
    tokens in range, the decode kernel launched depth x (tokens - 1)
    times and no other kernel; ms per token printed. Returns the
    launches."""
    from dalle_pytorch_tpu_torch.models.sampling import decode_tokens

    T = model.text_len_internal
    caption = torch.from_numpy(np.random.RandomState(13).randint(
        1, FLAGSHIP["num_text_tokens"], size=(1, FLAGSHIP["text_seq_len"]))).cuda()
    buf = torch.zeros((1, T + model.image_seq_len), dtype=torch.int32, device="cuda")
    buf[:, :T] = model.remap_text(caption)
    steps = LEARNED_POS_TOKENS - 1
    out, launches = generate_counted(
        f"generate learned_pos, batch 1, cache 4d, decode kernel without rotary, window 0, "
        f"{LEARNED_POS_TOKENS} tokens",
        lambda: decode_tokens(model, buf, T, 0, num_steps=T + steps, prefill_len=T,
                              cache_format="4d", fused_decode=True, window_seg=0),
        {"fused_decode_attention": SERVE_MODEL["depth"] * steps}, LEARNED_POS_TOKENS)
    tokens = out[:, T:T + LEARNED_POS_TOKENS]
    if not ((tokens >= 0) & (tokens < FLAGSHIP["num_image_tokens"])).all():
        raise AssertionError("generate learned_pos: a token out of the image vocab")
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


def profile_iterations(model, warmup: int = 10, window: int = 15, kv_quant=None,
                       split: bool = False) -> None:
    """Where an engine iteration's time goes: torch.profiler over a window
    of a fresh mixed prefill/decode batch (8 requests at once, so one row
    decodes while the others prefill chunk by chunk), with ``kv_quant``
    pages, on the fused path or with ``split`` the split one. Prints wall
    time and device-busy time per iteration, launches per iteration, the
    largest device-time kernels and the ragged kernel's. Runs after the
    counted main path."""
    from torch.profiler import ProfilerActivity, profile

    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Request

    engine = Engine(model, EngineConfig(
        max_batch=MAX_BATCH, fused_iteration=not split, prefill_chunk=CHUNK, kv_quant=kv_quant,
    ), device="cuda")
    label = ("profile split" if split else "profile") + (f" {kv_quant}" if kv_quant else "")
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


GEN_CLI_DIR = ROOT / "build" / "generate_cli"
# phase 15's checkpoint: the serve model over the CLIP BPE vocabulary the
# command line's default tokenizer encodes with, float32 on disk; depth 1
# in the main run: at the serve phases' 4 the phase took 198 s and the
# script 1,311 s of its 1,200 s limit on a slow host (PERF.md, section 6);
# ``--generate-cli 4`` runs it at 4
GEN_CLI_MODEL = dict(SERVE_MODEL, num_text_tokens=49408)
GEN_CLI_DEPTH = 1
GEN_CLI_PROMPTS = ("a red double-decker bus on a rainy street",
                   "an armchair in the shape of an avocado")
GEN_CLI_IMAGES = 4


def saved_files(out_dir: Path) -> dict:
    """{relative path: bytes} of every file the command line wrote."""
    return {str(p.relative_to(out_dir)): p.read_bytes()
            for p in sorted(out_dir.rglob("*")) if p.is_file()}


def generate_cli(depth: int = GEN_CLI_DEPTH, order=("off", "on")) -> dict:
    """Phase 15: the generate command line (``generate.main``) in this
    process on the card. A float32 checkpoint of ``GEN_CLI_MODEL`` (full
    width, ``depth`` layers, seeded) with the flagship VAE, and a flagship
    CLIP checkpoint, written by the port's factory under ``GEN_CLI_DIR``
    (removed at the end); then ``--bf16 --clip_path`` on two prompts,
    ``GEN_CLI_IMAGES`` images each, batch 4, once for each entry of
    ``order``, telemetry off or on (on: ``DALLE_TPU_TELEMETRY=1`` and a
    flight directory, read through ``configure_from_env``), counts set to
    0 just before each run and read just after. Checked: 8 PNGs of 256 x
    256 x 3 uint8 and the two captions; the ragged kernel launched depth x
    the engine's dispatches times, the packed-qkv kernel CLIP's text depth
    x rerank dispatches times, the same in every run; every run's files
    byte-identical to the first's; an ``Engine`` built directly from the
    same checkpoints serving the first prompt's requests gives bitwise its
    PNGs' pixels in descending score order; with telemetry on the flight
    file validates, every request's ``serve.request`` span closes
    COMPLETED, each stage dispatch is one stage span, and the decode spans
    count the decode steps (one a dispatched step, not a token). Printed:
    the walls in order, ``serve.ttft_s``, ``serve.request_latency_s`` and
    the spans' percentiles from ``dump()``, and a ``--gentxt`` run of one
    image. Returns the first run's launches."""
    import os
    import shutil

    from dalle_pytorch_tpu_torch import generate
    from dalle_pytorch_tpu_torch.data.image_io import read_png
    from dalle_pytorch_tpu_torch.data.tokenizers import SimpleTokenizer
    from dalle_pytorch_tpu_torch.models.clip import CLIP
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.factory import (clip_from_checkpoint,
                                                        dalle_from_checkpoint,
                                                        save_clip_checkpoint,
                                                        save_dalle_checkpoint)
    from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE, denormalize
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.postdecode import (STAGE_RERANK, STAGE_VAE, StageConfig,
                                                            StageSpec)
    from dalle_pytorch_tpu_torch.testing import reset_registries
    from dalle_pytorch_tpu_torch.utils import telemetry
    from dalle_pytorch_tpu_torch.utils.metrics import counters
    from dalle_pytorch_tpu_torch.utils.quantize import prepare_for_serving

    t_phase = time.perf_counter()
    shutil.rmtree(GEN_CLI_DIR, ignore_errors=True)
    GEN_CLI_DIR.mkdir(parents=True)
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    dalle = DALLE(**dict(GEN_CLI_MODEL, depth=depth), device="cuda").init_weights(gen(30))
    vae = DiscreteVAE(**FLAGSHIP_VAE, device="cuda").init_weights(gen(31))
    clip = CLIP(**FLAGSHIP_CLIP, device="cuda").init_weights(gen(32))
    save_dalle_checkpoint(GEN_CLI_DIR / "dalle.ckpt", dalle, vae)
    save_clip_checkpoint(GEN_CLI_DIR / "clip.ckpt", clip)
    del dalle, vae, clip
    release_memory()
    n = len(GEN_CLI_PROMPTS) * GEN_CLI_IMAGES
    text = "|".join(GEN_CLI_PROMPTS)
    argv = ["--dalle_path", str(GEN_CLI_DIR / "dalle.ckpt"), "--clip_path",
            str(GEN_CLI_DIR / "clip.ckpt"), "--bf16", "--text", text, "--num_images",
            str(GEN_CLI_IMAGES), "--batch_size", "4"]
    engines = []
    engine_images = generate.engine_images

    def spied(engine, *a, **k):
        engines.append(engine)
        return engine_images(engine, *a, **k)

    def run(label: str, tele: bool) -> dict:
        out = GEN_CLI_DIR / label
        flight = GEN_CLI_DIR / f"{label}-flight"
        reset_registries()
        if tele:
            os.environ.update({telemetry.ENV_ENABLE: "1", telemetry.ENV_DIR: str(flight)})
            telemetry.configure_from_env(telemetry.TELEMETRY)
        engines.clear()
        generate.engine_images = spied
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(Tee(f"generate CLI {label}")):
                generate.main([*argv, "--outputs_dir", str(out)])
            torch.cuda.synchronize()
        finally:
            generate.engine_images = engine_images
            for key in (telemetry.ENV_ENABLE, telemetry.ENV_DIR):
                os.environ.pop(key, None)
        wall = time.perf_counter() - t0
        launched = read_counts((*RAGGED, "fused_qkv_attention"))
        engine = engines[0]
        assert all(e is engine for e in engines), "the command line built more than one engine"
        pipe = engine.postdecode
        stage_dispatches = {s: pipe.dispatches[s] for s in (STAGE_VAE, STAGE_RERANK)}
        want = {"ragged_attention": depth * engine.dispatches, "ragged_attention_int8": 0,
                "fused_qkv_attention": FLAGSHIP_CLIP["text_enc_depth"]
                * stage_dispatches[STAGE_RERANK]}
        record = dict(wall=wall, launched=launched, want=want, files=saved_files(out),
                      tokens={rid: r.tokens.tolist() for rid, r in engine.results.items()},
                      dispatches=engine.dispatches, decode_steps=counters.get("serve.decode_steps"),
                      stage_dispatches=stage_dispatches)
        if tele:
            record["dump"] = telemetry.TELEMETRY.dump()
            path = telemetry.TELEMETRY.drain("phase 15")
            record["flight"] = (telemetry.validate_flight_file(path),
                                [json.loads(line) for line in Path(path).read_text().splitlines()])
        reset_registries()
        return record

    labels = [f"{tele}{k}" for k, tele in enumerate(order)]
    runs = [run(label, tele == "on") for label, tele in zip(labels, order)]
    first = runs[0]
    problems = []
    pngs = sorted(k for k in first["files"] if k.endswith(".png"))
    captions = sorted(k for k in first["files"] if k.endswith("caption.txt"))
    arrays = {k: np.asarray(read_png(first["files"][k])) for k in pngs}
    if len(pngs) != n or len(captions) != len(GEN_CLI_PROMPTS) or any(
            a.shape != (256, 256, 3) or a.dtype != np.uint8 for a in arrays.values()):
        problems.append(f"files {sorted(first['files'])}")
    for label, r in zip(labels, runs):
        if r["files"] != first["files"]:
            problems.append(f"{label}: files differ from the first run's (tokens equal "
                            f"{r['tokens'] == first['tokens']})")
        if r["launched"] != r["want"] or r["launched"] != first["launched"]:
            problems.append(f"{label}: launches {r['launched']}, expected {r['want']}")
    for r in (r for r in runs if "flight" in r):
        summary, recs = r["flight"]
        ends = [x for x in recs if x.get("name") == "serve.request" and x["ph"] == "E"]
        spans = {s: sum(1 for x in recs if x.get("name") == f"serve.stage.{s}" and x["ph"] == "B")
                 for s in (STAGE_VAE, STAGE_RERANK)}
        decode = summary["by_name"].get("serve.decode_step", 0) // 2
        if (summary["unclosed"] or len(ends) != n
                or {x["outcome"] for x in ends} != {"completed"} or spans != r["stage_dispatches"]
                or decode != r["decode_steps"] or decode >= n * MAX_NEW):
            problems.append(f"flight file: unclosed {summary['unclosed']}, {len(ends)} request "
                            f"ends, stage spans {spans} of {r['stage_dispatches']} dispatches, "
                            f"{decode} decode spans of {r['decode_steps']} steps")

    # the command line is the engine: the same requests through an engine
    # built here, images best first
    dalle, vae, _ = dalle_from_checkpoint(GEN_CLI_DIR / "dalle.ckpt", "cuda")
    clip, _ = clip_from_checkpoint(GEN_CLI_DIR / "clip.ckpt", "cuda")
    engine = Engine(prepare_for_serving(dalle), EngineConfig(max_batch=4, queue_limit=GEN_CLI_IMAGES,
                                                             filter_thres=0.9),
                    device="cuda", stages=StageSpec(vae, clip, config=StageConfig(
                        batch=4, queue_limit=GEN_CLI_IMAGES)))
    del dalle
    tokenizer = SimpleTokenizer()
    scores_by_prompt = []
    for pi, prompt in enumerate(GEN_CLI_PROMPTS[:1]):
        row = tokenizer.tokenize([prompt], GEN_CLI_MODEL["text_seq_len"], truncate_text=True)[0]
        images, scores = generate.engine_images(engine, row, GEN_CLI_IMAGES, f"p{pi}",
                                                generate.request_seed(0, pi, 0))
        best_first = np.argsort(-scores)
        scores_by_prompt.append(scores[best_first])
        sub = prompt.replace(" ", "_")[:100]
        for rank, k in enumerate(best_first):
            want = (denormalize(torch.from_numpy(images[k])).numpy() * 255).astype(np.uint8)
            if not np.array_equal(arrays.get(f"{sub}/{rank}.png"), want):
                problems.append(f"{sub}/{rank}.png is not the engine's image {k}")
    del engine, vae, clip
    release_memory()

    # --gentxt, one image
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(Tee("generate CLI gentxt")) as tee:
        generate.main(["--dalle_path", str(GEN_CLI_DIR / "dalle.ckpt"), "--bf16", "--text",
                       GEN_CLI_PROMPTS[0], "--num_images", "1", "--batch_size", "1", "--gentxt",
                       "--outputs_dir", str(GEN_CLI_DIR / "gentxt")])
    gentxt_wall = time.perf_counter() - t0
    completed = [ln for ln in tee.getvalue().splitlines() if ln.startswith("completed prompt: ")]
    gentxt_pngs = list((GEN_CLI_DIR / "gentxt").rglob("*.png"))
    if len(completed) != 1 or len(gentxt_pngs) != 1:
        problems.append(f"gentxt: {completed}, {gentxt_pngs}")

    def quantiles(dump: str, name: str) -> str:
        pre = f"{name.replace('.', '_')}{{quantile="
        qs = [ln.split(" ")[-1] for ln in dump.splitlines() if ln.startswith(pre)]
        count = [ln.split(" ")[-1] for ln in dump.splitlines()
                 if ln.startswith(f"{name.replace('.', '_')}_count ")]
        return f"{name} p50/p95/p99 {'/'.join(qs)} s (count {count[0] if count else 0})"

    walls = {tele: [r["wall"] for r, t in zip(runs, order) if t == tele] for tele in ("off", "on")}
    tele_run = next(r for r in runs if "flight" in r)
    log(f"generate CLI: depth {depth}, {n} images of 256 px ({len(GEN_CLI_PROMPTS)} prompts x "
        f"{GEN_CLI_IMAGES}, bf16, CLIP rerank, batch 4), {first['dispatches']} dispatches "
        f"({first['decode_steps']} decode steps), stage dispatches {first['stage_dispatches']}; "
        f"walls in order " + ", ".join(f"{t} {r['wall']:.2f}" for r, t in zip(runs, order))
        + f" s (telemetry on / off {np.mean(walls['on']) / np.mean(walls['off']):.4f}); "
        f"launches {first['launched']} (expected {first['want']}); the first prompt's "
        f"best-first scores " + "; ".join(", ".join(f"{s:.4f}" for s in sc)
                                          for sc in scores_by_prompt))
    log("generate CLI telemetry: " + "; ".join(quantiles(tele_run["dump"], name) for name in (
        "serve.ttft_s", "serve.request_latency_s", "serve.decode_step_s",
        "serve.stage.vae_decode_s", "serve.stage.clip_rerank_s"))
        + f"; flight file {tele_run['flight'][0]['records']} records")
    log(f"generate CLI gentxt: {completed[0] if completed else None!r}, one image, "
        f"{gentxt_wall:.2f} s wall (the text completion, the model load and the image)")
    shutil.rmtree(GEN_CLI_DIR, ignore_errors=True)
    log(f"generate CLI: phase wall {time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise AssertionError("generate CLI: " + "; ".join(problems))
    return {k: v for k, v in first["launched"].items() if v}


def generate_flagship() -> dict:
    """Generation outside the engine at the flagship's width and the serve
    phases' depth (``SERVE_MODEL``; bf16, seeded random weights;
    ``models/sampling.py``), each run counted, L below its depth:
    (a) batch 1 (the policy's "4d" cache), ``fused_decode=True``,
        ``window_seg=0``: ``generate_image_tokens`` of one seeded caption,
        1024 tokens in range, the decode kernel launched exactly L x 1023
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
        decode kernel launched L x 1023 times and CLIP's text encoder the
        packed-qkv kernel once a layer;
    (d) batch 4 (the policy's "paged" cache), default arguments: the ragged
        kernel launched L x 1024 times (the prompt block, then every
        decode step), the decode kernel never;
    (e) batch 1 with default arguments (the "4d" cache, the default
        window, ``fused_decode=None``: the card's route), the decode kernel
        launched exactly L x 1023 times, ms a token printed beside (a)'s
        and (b)'s.
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
    model = DALLE(**SERVE_MODEL, **bf16).init_weights(gen(0))
    depth, T = SERVE_MODEL["depth"], model.text_len_internal
    steps = MAX_NEW - 1
    captions = torch.from_numpy(np.random.RandomState(13).randint(
        1, FLAGSHIP["num_text_tokens"], size=(8, FLAGSHIP["text_seq_len"]))).cuda()
    captions[1::2, 200:] = 0  # every other caption with a zero tail
    text = captions[:1]
    launches = {}

    walls = {}
    t0 = time.perf_counter()
    tokens_a, launches["generate_b1"] = generate_counted(
        "generate (a) batch 1, cache 4d, fused decode kernel, window 0",
        lambda: generate_image_tokens(model, text, 0, fused_decode=True, window_seg=0),
        {"fused_decode_attention": depth * steps}, MAX_NEW)
    walls["a"] = time.perf_counter() - t0
    check_image_tokens("generate (a)", tokens_a, 1)
    t0 = time.perf_counter()
    tokens_b, _ = generate_counted(
        "generate (b) batch 1, cache 4d, unfused chain, default window",
        lambda: generate_image_tokens(model, text, 0, fused_decode=False), {}, MAX_NEW)
    walls["b"] = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    tokens_e, launches["generate_b1_default"] = generate_counted(
        "generate (e) batch 1, default arguments (cache 4d, default window, the card's route)",
        lambda: generate_image_tokens(model, text, 0),
        {"fused_decode_attention": depth * steps}, MAX_NEW)
    walls["e"] = time.perf_counter() - t0
    check_image_tokens("generate (e)", tokens_e, 1)
    log("generate batch 1, ms per generated token (wall, this call): " + ", ".join(
        f"({k}) {1e3 * w / MAX_NEW:.3f}" for k, w in walls.items())
        + f"; (e) tokens equal to (a)'s {torch.equal(tokens_e, tokens_a)} (expected: the "
        "window changes no arithmetic on the kernel path; printed, not asserted)")
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
    TRAIN_RECORDS[label] = (losses, steady, tokens_per_step / steady)
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
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

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
    check_nan_guard(trainer, text, tokens, "train")
    return trainer, (text, images), launches


def train_defaults(vae, batch):
    """Phase 8c: the flagship's widths (dim 1024, depth 12, 16 heads of
    64, text 256) with every other flag train_dalle.py's default: learned
    positions (``rotary_emb=False``), no token shift, "full" layers,
    float32, batch 4, lr 3e-4, clip 0.5; ``DalleTrainer(vae)`` on phase
    8's VAE and batch, the counted run as phase 8 (the packed kernels'
    no-rotary instances depth x (steps + retries) times each). Returns
    (trainer, launches)."""
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda",
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"])
    dalle = trainer.dalle
    if dalle.rotary_emb or dalle.stable or dalle.transformer.shift_tokens or (
            dalle.dtype != torch.float32):
        raise AssertionError("train learned_pos: the trainer's defaults did not build a float32 "
                             "DALLE with learned positions and no token shift")
    log(f"train learned_pos: DalleTrainer(vae) with train_dalle.py's defaults at the flagship's "
        f"widths ({sum(p.numel() for p in dalle.parameters()):,} parameters, learned positions, "
        f"no token shift, float32, batch {trainer.batch_size})")
    launches = train_run(trainer, *batch, "train learned_pos",
                         {name: FLAGSHIP["depth"] for name in PACKED})
    return trainer, launches


def check_nan_guard(trainer, text, tokens, label: str) -> None:
    """One step of ``trainer``'s state with the NaN injected: every
    parameter and Adam moment bit-identical, skipped 1; the trainer keeps
    the new state."""
    from dalle_pytorch_tpu_torch.parallel.step import make_train_step
    from dalle_pytorch_tpu_torch.train_dalle import dalle_loss

    state = trainer.state
    snapshot = [t.clone() for part in (state.params, state.opt_state.mu, state.opt_state.nu)
                for t in part.values()]
    inject = make_train_step(dalle_loss, 0.5, nan_inject_step=int(state.step))
    new, loss = inject(state, trainer.dalle, {"text": text, "image": tokens}, trainer.lr)
    after = [t for part in (new.params, new.opt_state.mu, new.opt_state.nu) for t in part.values()]
    identical = all(torch.equal(a, b) for a, b in zip(snapshot, after))
    log(f"{label}: NaN injected at step {int(state.step)}: loss {loss.item()}, skipped "
        f"{int(new.skipped) - int(state.skipped)}, every parameter and Adam moment "
        f"bit-identical {identical}")
    if not (torch.isnan(loss) and int(new.skipped) == int(state.skipped) + 1 and identical
            and int(new.opt_state.count) == int(state.opt_state.count)):
        raise AssertionError(f"{label}: the NaN guard changed the state")
    trainer.state = new


def train_bf16(vae, batch):
    """The flagship DALLE of phase 8 trained in mixed precision
    (``DalleTrainer(bf16=True)``: bfloat16 compute on float32 parameters,
    the same seeded weights) on the same batch: the counted run, the
    packed kernels' bf16 instances once per layer, then the NaN-injected
    step. Returns (trainer, launches of the counted run)."""
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0, bf16=True,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True)
    log_mixed_precision(trainer, "train bf16")
    launches = train_run(trainer, *batch, "train bf16",
                         {name: FLAGSHIP["depth"] for name in PACKED})
    check_nan_guard(trainer, batch[0], vae.get_codebook_indices(batch[1]), "train bf16")
    return trainer, launches


def log_mixed_precision(trainer, label: str) -> None:
    """Check and print that ``trainer``'s DALLE computes in bfloat16 on
    float32 parameters and float32 Adam moments."""
    dalle, adam = trainer.dalle, trainer.state.opt_state
    types = {t.dtype for part in (dict(dalle.named_parameters()), adam.mu, adam.nu)
             for t in part.values()}
    log(f"{label}: compute {dalle.dtype}, parameters and Adam moments {sorted(map(str, types))}")
    if dalle.dtype != torch.bfloat16 or types != {torch.float32}:
        raise AssertionError(f"{label}: not bf16 on float32 parameters: {dalle.dtype}, {types}")


def train_sparse(vae, batch, bf16: bool = False):
    """The sparse configuration (BASELINE.json configs[2] at the flagship
    width: layers cycling full, axial_row, axial_col, conv_like) trained
    by ``DalleTrainer`` on the flagship batch, in float32 or with ``bf16``
    in mixed precision: the counted run. Returns (trainer, launches of the
    counted run)."""
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    label = "train sparse bf16" if bf16 else "train sparse"
    t0 = time.perf_counter()
    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0, bf16=bf16,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True, attn_types=SPARSE_TYPES)
    types = trainer.dalle.transformer.attn_types
    torch.cuda.synchronize()
    log(f"{label}: layers {types}, built in {time.perf_counter() - t0:.1f} s")
    if bf16:
        log_mixed_precision(trainer, label)
    per_kind = FLAGSHIP["depth"] // 2  # full + axial_col / axial_row + conv_like
    launches = train_run(trainer, *batch, label,
                         {name: per_kind for name in PACKED + PAIR_GRID})
    return trainer, launches


def train_512(text):
    """The flagship DALLE at 512 px trained in float32 by ``DalleTrainer``:
    the flagship VAE at image_size 512 encodes 4 seeded 512 px images to a
    64 x 64 grid (n = 256 + 4096 = 4352 positions, 17 x 17 flash blocks of
    256), the flagship captions ``text``; the counted run, every layer
    through the tiled forward, dq and dk/dv kernels. Returns (trainer,
    (text, images), launches of the counted run); the trainer's VAE is
    the 512 px one."""
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


def train_512_bf16(vae, batch):
    """Phase 11's model and batch (``vae`` the 512 px VAE) trained in mixed
    precision (``DalleTrainer(bf16=True)``): the counted run, every layer
    through the tiled forward, dq and dk/dv kernels' bf16 instances.
    Returns (trainer, launches of the counted run)."""
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0, bf16=True,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True)
    log_mixed_precision(trainer, "train 512 bf16")
    launches = train_run(trainer, *batch, "train 512 bf16",
                         {name: FLAGSHIP["depth"] for name in TILED_SPLIT})
    return trainer, launches


def train_512_plain(vae, batch) -> None:
    """Phase 11's float32 model (the same seed and flags) trained for the
    same ``TRAIN_STEPS`` steps on the same batch with the tiled flash
    kernels' plain versions in their place (``reference_flash_attention``
    and its dq and dk/dv passes, on the card): no kernel launched
    (checked). Prints both loss sequences side by side and the first step
    where they part by more than phase 4's float32 loss tolerance
    (relative 1e-5), or that they agree; the plain run's wall is printed
    and enters no timing."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    plain = {"flash_attention_fwd": fa.reference_flash_attention,
             "flash_attention_dq": fa.reference_flash_attention_dq,
             "flash_attention_dkdv": fa.reference_flash_attention_dkdv,
             "flash_attention_bwd_fused": fa.reference_flash_attention_bwd}
    saved = {name: getattr(fa, name) for name in plain}
    trainer = DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = []
    try:
        for name, fn in plain.items():
            setattr(fa, name, fn)
        for _ in range(TRAIN_STEPS):
            losses.append(trainer.train_step(*batch))
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)
    wall = time.perf_counter() - t0
    launched = {n: c for n, c in read_counts(tuple(kernel_counters())).items() if c}
    kernel_losses = TRAIN_RECORDS["train 512"][0]
    gaps = [abs(k - p) / abs(p) for k, p in zip(kernel_losses, losses)]
    log(f"train 512 plain: {trainer.steps} steps, {trainer.retries} retries on the plain "
        f"tiled attention in {wall:.1f} s (kept out of every timing), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launched}")
    log("train 512 losses, step: kernels / plain (relative gap): " + "; ".join(
        f"{i + 1}: {k:.6f} / {p:.6f} ({g:.2e})"
        for i, (k, p, g) in enumerate(zip(kernel_losses, losses, gaps))))
    parted = next((i for i, g in enumerate(gaps) if g > 1e-5), None)
    log("train 512 plain: " + (
        f"the sequences agree within 1e-5 through step {len(gaps)}" if parted is None else
        f"the sequences part at step {parted + 1} by {gaps[parted]:.3e} (tolerance 1e-5)"))
    if launched:
        raise AssertionError(f"train 512 plain: kernels launched {launched}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train 512 plain: losses {losses}")


def train_cli(vae):
    """Phase 12: the trainer's command line (``train_dalle.main``) in this
    process at the flagship widths on ``vae`` (phase 8's), with
    train_dalle.py's other defaults, on ``CLI_IMAGES`` seeded 256 px PNGs
    under ``CLI_DIR`` (removed at the end): ``--epochs 1`` (four steps, a
    sample at step 3, three saves), then ``--epochs 2`` without a sample,
    which resumes from the verified step directory for four more steps.
    The step is timed as the CLI runs it, with no synchronisation added:
    the wall between consecutive loss verdicts of one run (each run is
    one epoch) with no sample between them; each such wall holds the
    batch's copy, the VAE encode, the dispatch and the device's step,
    with the next batch's loading overlapped. Returns the launches of
    both runs."""
    import os
    import shutil

    from dalle_pytorch_tpu_torch import train_dalle
    from dalle_pytorch_tpu_torch.data import loader as data_loader
    from dalle_pytorch_tpu_torch.data.image_io import read_png
    from dalle_pytorch_tpu_torch.models.factory import restore_opt_state, save_vae_checkpoint
    from dalle_pytorch_tpu_torch.testing import write_caption_folder
    from dalle_pytorch_tpu_torch.utils.checkpoint import latest_verified_step, verify_step_dir

    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    free = shutil.disk_usage(CLI_DIR).free
    write_caption_folder(CLI_DIR / "data", CLI_IMAGES, CLI_IMAGE_SIZE, seed=21)
    save_vae_checkpoint(CLI_DIR / "vae.ckpt", vae)
    depth = FLAGSHIP["depth"]
    argv = ["--image_text_folder", str(CLI_DIR / "data"), "--vae_path",
            str(CLI_DIR / "vae.ckpt"), "--dim", str(FLAGSHIP["dim"]), "--depth", str(depth),
            "--heads", str(FLAGSHIP["heads"]), "--dim_head", str(FLAGSHIP["dim_head"]),
            "--sharded_ckpt", "--keep_n_checkpoints", "1", "--truncate_captions",
            "--dalle_output_file_name", str(CLI_DIR / "dalle")]
    log(f"train CLI: {CLI_IMAGES} PNGs of {CLI_IMAGE_SIZE} px and the VAE written under "
        f"{CLI_DIR} ({free / 2**30:.0f} GiB free)")

    from dalle_pytorch_tpu_torch.models import sampling

    losses, counts, item_s, sample_finite = [], [], [], []
    events = []  # ("verdict" or "sample", run, perf_counter) in order
    generate = sampling.generate_images
    verdict = train_dalle.DalleTrainer.verdict
    getitem = data_loader.TextImageDataset.__getitem__

    def recorded_verdict(self, loss):
        losses.append(verdict(self, loss))  # reads the loss: the CLI's own sync
        events.append(("verdict", run_no[0], time.perf_counter()))
        counts.append(int(self.state.opt_state.count))
        return losses[-1]

    def checked_generate(*a, **kw):
        images = generate(*a, **kw)
        sample_finite.append(bool(torch.isfinite(images).all()))
        events.append(("sample", run_no[0], time.perf_counter()))
        return images

    def timed_getitem(self, ind):
        t0 = time.perf_counter()
        out = getitem(self, ind)
        item_s.append(time.perf_counter() - t0)
        return out

    run_no = [0]

    def run(extra, label):
        run_no[0] += 1
        out = Tee(label)
        names = tuple(kernel_counters())
        cwd = os.getcwd()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        try:
            os.chdir(CLI_DIR)  # dalle_samples/ lands here
            with contextlib.redirect_stdout(out):
                train_dalle.main([*argv, *extra])
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t0
        return out.getvalue(), {n: c for n, c in read_counts(names).items() if c}, wall

    train_dalle.DalleTrainer.verdict = recorded_verdict
    data_loader.TextImageDataset.__getitem__ = timed_getitem
    sampling.generate_images = checked_generate
    try:
        text1, launched1, wall1 = run(["--epochs", "1", "--sample_every_n_steps", "3"],
                                      "train CLI run 1")
        n1, counts1 = len(losses), list(counts)
        text2, launched2, wall2 = run(["--epochs", "2", "--sample_every_n_steps", "1000"],
                                      "train CLI run 2")
    finally:
        train_dalle.DalleTrainer.verdict = verdict
        data_loader.TextImageDataset.__getitem__ = getitem
        sampling.generate_images = generate
    n2 = len(losses) - n1
    # the walls between consecutive verdicts of one run with no sample between
    walls = [b[2] - a[2] for a, b in zip(events, events[1:])
             if a[0] == b[0] == "verdict" and a[1] == b[1]]
    steps = vae.fmap_size**2 - 1  # the sample's decode steps: the image tokens after the first
    want1 = {"fused_qkv_attention": depth * n1, "fused_qkv_attention_bwd": depth * n1,
             "fused_decode_attention": depth * steps}
    want2 = {"fused_qkv_attention": depth * n2, "fused_qkv_attention_bwd": depth * n2}
    samples = sorted((CLI_DIR / "dalle_samples").glob("*.png"))
    pixels = read_png(samples[0].read_bytes()).pixels if samples else None
    cp = CLI_DIR / "dalle-cp"
    step_dirs = sorted(p.name for p in cp.glob("step_*"))
    verified = latest_verified_step(cp)
    adam = restore_opt_state(CLI_DIR / "dalle.ckpt", device="cpu")
    ckpt_bytes = (CLI_DIR / "dalle.ckpt").stat().st_size
    on_disk = sorted(p.name for p in CLI_DIR.iterdir())
    tokens_per_step = TRAIN_BATCH * (FLAGSHIP["text_seq_len"] + vae.fmap_size**2)
    steady = float(np.median(walls)) if walls else float("nan")
    ref = TRAIN_RECORDS.get("train learned_pos")
    log(f"train CLI: run 1 {n1} dispatches, run 2 {n2}; losses {[round(x, 4) for x in losses]}; "
        f"Adam counts {counts}; walls between verdicts {[round(w, 4) for w in walls]} s")
    log(f"train CLI: step as the CLI runs it (wall between verdicts, median of {len(walls)}) "
        f"{steady:.4f} s, {tokens_per_step / steady:.1f} training tokens/s" + (
            f" (phase 8c, DalleTrainer(vae).train_step, encode, dispatch and verdict in "
            f"turn: {ref[1]:.4f} s, {ref[2]:.1f} tokens/s)" if ref else ""))
    log(f"train CLI: loader {sum(item_s) / max(1, len(item_s)) * TRAIN_BATCH:.4f} s a batch "
        f"({len(item_s)} samples read, PNG decode, crop and resize in numpy)")
    log(f"train CLI: run 1 {wall1:.1f} s, run 2 {wall2:.1f} s; launches run 1 {launched1} "
        f"(expected {want1}), run 2 {launched2} (expected {want2})")
    log(f"train CLI: sample {[p.name for p in samples]} {None if pixels is None else pixels.shape}, "
        f"finite {sample_finite}; "
        f"step directories {step_dirs}, newest verified {verified} "
        f"({verify_step_dir(cp / f'step_{verified:08d}') if verified is not None else None}); "
        f"final .ckpt {ckpt_bytes:,} bytes, Adam count {int(adam.count)}; on disk {on_disk}")
    problems = []
    if not all(math.isfinite(x) for x in losses) or (n1, n2) != (4, 4) or len(walls) != 5:
        problems.append(f"losses {losses} over {n1} + {n2} dispatches")
    if launched1 != want1 or launched2 != want2:
        problems.append(f"launches {launched1} / {launched2}, expected {want1} / {want2}")
    if (len(samples) != 1 or pixels.shape != (CLI_IMAGE_SIZE, CLI_IMAGE_SIZE, 3)
            or sample_finite != [True]):
        problems.append(f"samples {samples}, finite {sample_finite}")
    if f"resuming from {cp} step 4" not in text2:
        problems.append("the relaunch did not resume from step 4")
    if counts1 != [1, 2, 3, 4] or counts[n1:] != [5, 6, 7, 8] or int(adam.count) != 8:
        problems.append(f"Adam counts {counts}, final {int(adam.count)}")
    if step_dirs != ["step_00000008"] or verified != 8 or verify_step_dir(
            cp / "step_00000008") != (True, "ok"):
        problems.append(f"step directories {step_dirs}, verified {verified}")
    if on_disk != ["dalle-cp", "dalle.ckpt", "dalle.ckpt.manifest.json", "dalle_samples",
                   "data", "vae.ckpt", "vae.ckpt.manifest.json"]:
        problems.append(f"files on disk {on_disk}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    log(f"train CLI: phase wall {time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise AssertionError("train CLI: " + "; ".join(problems))
    return {n: launched1.get(n, 0) + launched2.get(n, 0) for n in {*launched1, *launched2}}


def seeded_strings(n: int, seed: int = 0) -> list:
    """``n`` seeded strings of 1-60 code points drawn from ASCII, Latin,
    Greek, CJK, emoji, spaces, quotes, digits and the case-closure traps
    (long s, U+0345), as the native engine's tests draw them."""
    rng = np.random.RandomState(seed)
    pools = [list(range(0x20, 0x7F)), list(range(0xA0, 0x250)), list(range(0x370, 0x400)),
             list(range(0x4E00, 0x4E80)), [0x1F600 + i for i in range(40)],
             [0x20, 0x27, 0x2E, 0x31, 0x32], [0x27, 0x73, 0x17F, 0x345, 0x6C, 0x74],
             list(range(0x2000, 0x2030))]
    out = []
    for _ in range(n):
        k = rng.randint(1, 61)
        pool = pools[rng.randint(len(pools))]
        out.append("".join(chr(int(c)) for c in rng.choice(pool, size=k)))
    return out


def check_native_tokenizer(captions) -> None:
    """The native BPE engine on the card's host: built by g++ from the
    port's sources into build/native/, chosen by ``get_tokenizer()``, and
    byte-equal to ``SimpleTokenizer`` on ``captions`` and 10,000 seeded
    strings; each tokenizer's encode rate over those strings printed."""
    from dalle_pytorch_tpu_torch.data import native_bpe, tokenizers
    from dalle_pytorch_tpu_torch.native import build

    t0 = time.perf_counter()
    so = build.build()
    built_s = time.perf_counter() - t0
    tokenizers._default = None
    native = tokenizers.get_tokenizer()
    plain = tokenizers.SimpleTokenizer()
    texts = list(captions) + seeded_strings(10_000)
    rates = {}
    for label, tok in (("native", native), ("python", plain)):
        tok.encode("warm up")
        t0 = time.perf_counter()
        ids = [tok.encode(t) for t in texts]
        rates[label] = (len(texts) / (time.perf_counter() - t0), ids)
    chars = sum(len(t) for t in texts)
    bad = [t for t, a, b in zip(texts, rates["native"][1], rates["python"][1]) if a != b]
    decoded = all(native.decode(ids) == plain.decode(ids) for ids in rates["python"][1][:500])
    log(f"native BPE: {so} (built or found in {built_s:.1f} s); get_tokenizer() is "
        f"{type(native).__name__}; {len(texts):,} strings ({chars:,} code points): "
        f"{len(bad)} encodings differ from SimpleTokenizer's, decode equal {decoded}; encode "
        f"rate native {rates['native'][0]:,.0f} strings/s, SimpleTokenizer "
        f"{rates['python'][0]:,.0f} strings/s ({rates['native'][0] / rates['python'][0]:.1f}x; "
        f"{card_line()})")
    if (not isinstance(native, native_bpe.NativeSimpleTokenizer) or so is None
            or not str(so).startswith(str(ROOT / "build" / "native")) or bad or not decoded):
        raise AssertionError(f"native BPE: {type(native).__name__} from {so}, {len(bad)} "
                             f"encodings differ (first {bad[:2]!r}), decode equal {decoded}")


def check_dropout_on_card(trainer, text, tokens) -> None:
    """The dropout of a training forward on the card: the same micro-batch
    and generator key give a bitwise equal loss, another key another loss;
    the first layer's attention mask keeps within 4 binomial standard
    deviations of 0.9; and the dropout's output equals ``where(mask, x /
    0.9, 0)`` computed on the CPU from the same mask, bit for bit."""
    from dalle_pytorch_tpu_torch.ops import layers
    from dalle_pytorch_tpu_torch.testing import dropout_masks
    from dalle_pytorch_tpu_torch.train_dalle import dalle_loss

    batch = {"text": text, "image": tokens}
    dev = trainer.dalle.device
    losses = []
    with torch.no_grad(), dropout_masks() as drawn:
        for seed in (5, 5, 6):
            losses.append(dalle_loss(trainer.dalle, batch,
                                     torch.Generator(device=dev).manual_seed(seed)))
    depth = trainer.dalle.depth
    mask = drawn[0]
    kept = mask.float().mean().item()
    sd = math.sqrt(0.9 * 0.1 / mask.numel())
    x = torch.randn(mask.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    with dropout_masks() as redrawn:
        got = layers.dropout(x, 0.1, torch.Generator(device=dev).manual_seed(2))
    m = redrawn[0].cpu()
    want = torch.where(m, x.cpu() / torch.tensor(0.9), torch.zeros(()))
    formula = torch.equal(got.cpu(), want)
    log(f"dropout on the card: losses key 5, 5, 6 {[round(x.item(), 6) for x in losses]}; "
        f"{len(drawn)} masks over 3 forwards (depth {depth}: attention and feed-forward); layer "
        f"0's attention mask {tuple(mask.shape)} keeps {kept:.6f} (0.9 +- 4 x {sd:.2e}); "
        f"where(mask, x / 0.9, 0) bitwise the CPU's {formula}")
    if (not torch.equal(losses[0], losses[1]) or torch.equal(losses[0], losses[2])
            or len(drawn) != 3 * 2 * depth or abs(kept - 0.9) > 4 * sd or not formula):
        raise AssertionError("dropout on the card: same-key losses, other-key loss, mask count, "
                             "kept share or formula failed")


TELE_CLI_DIR = ROOT / "build" / "train_cli_telemetry"
# phase 12c: three steps (12 PNGs, batch 4) at the flagship widths, depth
# cut to 2 (each run writes two saves)
TELE_CLI_IMAGES, TELE_CLI_DEPTH = 12, 2


def train_cli_telemetry(vae) -> dict:
    """Phase 12c: the trainer's command line with ``--telemetry
    --telemetry_dir DIR --metrics_port PORT`` (a free port) against the
    same run without them, in this process on ``vae`` (phase 8's): the
    flagship widths at depth ``TELE_CLI_DEPTH``, ``TELE_CLI_IMAGES``
    seeded PNGs under ``TELE_CLI_DIR`` (removed at the end), one epoch of
    three steps. Checked: the losses bitwise those of the run without
    telemetry; one scrape of ``http://127.0.0.1:PORT/metrics`` returns the
    ``train.step_s`` histogram of three steps; the flight file validates
    with three closed ``train.step`` spans; the packed kernels launched
    depth x steps times in each run. Printed: each run's wall between
    verdicts (no sample, no save between them). Returns the telemetry
    run's launches."""
    import shutil
    import socket
    import urllib.request

    from dalle_pytorch_tpu_torch import train_dalle
    from dalle_pytorch_tpu_torch.models.factory import save_vae_checkpoint
    from dalle_pytorch_tpu_torch.testing import reset_registries, write_caption_folder
    from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY, validate_flight_file

    t_phase = time.perf_counter()
    shutil.rmtree(TELE_CLI_DIR, ignore_errors=True)
    TELE_CLI_DIR.mkdir(parents=True)
    write_caption_folder(TELE_CLI_DIR / "data", TELE_CLI_IMAGES, CLI_IMAGE_SIZE, seed=22)
    save_vae_checkpoint(TELE_CLI_DIR / "vae.ckpt", vae)
    with socket.socket() as sock:  # a free port on the loopback
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--image_text_folder", str(TELE_CLI_DIR / "data"), "--vae_path",
            str(TELE_CLI_DIR / "vae.ckpt"), "--dim", str(FLAGSHIP["dim"]), "--depth",
            str(TELE_CLI_DEPTH), "--heads", str(FLAGSHIP["heads"]), "--dim_head",
            str(FLAGSHIP["dim_head"]), "--truncate_captions", "--epochs", "1"]
    verdict = train_dalle.DalleTrainer.verdict
    runs = {}

    def run(label: str, extra) -> None:
        losses, stamps = [], []

        def recorded(self, loss):
            losses.append(verdict(self, loss))
            stamps.append(time.perf_counter())
            return losses[-1]

        reset_registries()
        train_dalle.DalleTrainer.verdict = recorded
        torch.cuda.synchronize()
        zero_counts()
        try:
            with contextlib.redirect_stdout(Tee(f"train CLI {label}")):
                train_dalle.main([*argv, "--dalle_output_file_name", str(TELE_CLI_DIR / label),
                                  *extra])
            torch.cuda.synchronize()
        finally:
            train_dalle.DalleTrainer.verdict = verdict
        runs[label] = dict(losses=losses, walls=list(np.diff(stamps)),
                           launched={k: v for k, v in read_counts(PACKED).items() if v})

    run("plain", [])
    flight = TELE_CLI_DIR / "flight"
    run("telemetry", ["--telemetry", "--telemetry_dir", str(flight), "--metrics_port", str(port)])
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    summary = validate_flight_file(TELEMETRY.drain("phase 12c"))
    reset_registries()  # stops the /metrics thread
    want = {k: TELE_CLI_DEPTH * 3 for k in PACKED}
    plain, tele = runs["plain"], runs["telemetry"]
    step_lines = [ln for ln in body.splitlines() if ln.startswith("train_step_s")]
    line = (f"train CLI telemetry: depth {TELE_CLI_DEPTH}, 3 steps; losses plain "
            f"{plain['losses']}, telemetry {tele['losses']} (bitwise {plain['losses'] == tele['losses']}); "
            f"walls between verdicts plain " + ", ".join(f"{w:.4f}" for w in plain["walls"])
            + ", telemetry " + ", ".join(f"{w:.4f}" for w in tele["walls"]) + " s; /metrics "
            + "; ".join(ln for ln in step_lines if "quantile" in ln or "_count" in ln)
            + f"; flight file {summary['records']} records, by name {summary['by_name']}; "
            f"launches {plain['launched']} / {tele['launched']} (expected {want})")
    log(line)
    shutil.rmtree(TELE_CLI_DIR, ignore_errors=True)
    log(f"train CLI telemetry: phase wall {time.perf_counter() - t_phase:.1f} s")
    ok = (plain["losses"] == tele["losses"] and len(tele["losses"]) == 3
          and all(math.isfinite(x) for x in tele["losses"])
          and "train_step_s_count 3" in body and 'train_step_s_bucket{le="+Inf"} 3' in body
          and summary["unclosed"] == [] and summary["by_name"].get("train.step") == 6
          and plain["launched"] == tele["launched"] == want)
    if not ok:
        raise AssertionError(line)
    return tele["launched"]


def train_cli_ga(vae):
    """Phase 12b: the trainer's command line with this slice's flags at the
    flagship widths on ``vae`` (phase 8's), train_dalle.py's other
    defaults (batch 4, learned positions, "full", float32), in this
    process on ``CLI_GA_DIR`` (removed at the end): four tar shards of 4
    samples written here (PNG and JPEG members named ``.img``, captions
    ``.cap``; one JPEG cut short), ``--wds img,cap``, ``--bpe_path`` a
    tokenizer JSON trained here on the captions (the HugTokenizer),
    ``--attn_dropout 0.1 --ff_dropout 0.1 --ga_steps 2 --epochs 1``. The
    15 samples that decode make 3 micro-batches an epoch. Run 1 is
    preempted by SIGTERM at its third micro-step (an emergency step
    directory mid-accumulation); the relaunch resumes from it, replays
    epoch 0 from its start (a tar stream's order is not reproducible) and
    ends it: 6 micro-steps, 3 Adam steps. Run 3 is the same-size control:
    the same command line, data and tokenizer with both rates 0 and
    ``--ga_steps 1`` (3 steps), so that the micro-step's wall is held
    against a step of the same model in the same call. Also the native
    BPE engine (``check_native_tokenizer``), the loader's seconds a batch
    and the dropout's checks (``check_dropout_on_card``). Returns the
    launches of the three runs."""
    import contextlib
    import io
    import os
    import shutil
    import signal

    from dalle_pytorch_tpu_torch import train_dalle
    from dalle_pytorch_tpu_torch.data import webdata
    from dalle_pytorch_tpu_torch.data.tokenizers import HugTokenizer
    from dalle_pytorch_tpu_torch.models.factory import restore_opt_state, save_vae_checkpoint
    from dalle_pytorch_tpu_torch.testing import (reset_registries, train_tokenizer_json,
                                                 write_tar_shards)
    from dalle_pytorch_tpu_torch.utils.metrics import counters as metric_counters

    t_phase = time.perf_counter()
    shutil.rmtree(CLI_GA_DIR, ignore_errors=True)
    CLI_GA_DIR.mkdir(parents=True)
    spec, captions = write_tar_shards(CLI_GA_DIR / "data", 4, 4, CLI_IMAGE_SIZE, seed=23,
                                      corrupt=(5,), image_ext="img", caption_ext="cap")
    train_tokenizer_json(CLI_GA_DIR / "tokenizer.json", captions)
    check_native_tokenizer(captions)
    hug = HugTokenizer(str(CLI_GA_DIR / "tokenizer.json"))
    t0 = time.perf_counter()
    loaded = list(webdata.TarLoader(webdata.TarImageTextDataset(
        spec, text_len=FLAGSHIP["text_seq_len"], image_size=CLI_IMAGE_SIZE, tokenizer=hug,
        truncate_captions=True, image_key="img", caption_key="cap"), TRAIN_BATCH))
    loader_s = (time.perf_counter() - t0) / max(1, len(loaded))
    save_vae_checkpoint(CLI_GA_DIR / "vae.ckpt", vae)
    depth = FLAGSHIP["depth"]
    common = ["--image_text_folder", spec, "--wds", "img,cap", "--vae_path",
              str(CLI_GA_DIR / "vae.ckpt"), "--bpe_path", str(CLI_GA_DIR / "tokenizer.json"),
              "--dim", str(FLAGSHIP["dim"]), "--depth", str(depth), "--heads",
              str(FLAGSHIP["heads"]), "--dim_head", str(FLAGSHIP["dim_head"]),
              "--truncate_captions", "--epochs", "1"]
    argv = [*common, "--attn_dropout", "0.1", "--ff_dropout", "0.1", "--ga_steps", "2",
            "--dalle_output_file_name", str(CLI_GA_DIR / "dalle")]
    control_argv = [*common, "--attn_dropout", "0", "--ff_dropout", "0", "--ga_steps", "1",
                    "--dalle_output_file_name", str(CLI_GA_DIR / "control")]
    log(f"train CLI ga: 4 tar shards of 4 samples at {CLI_IMAGE_SIZE} px (one JPEG cut short), "
        f"the tokenizer JSON ({hug.vocab_size} tokens) and the VAE under {CLI_GA_DIR}; loader "
        f"{loader_s:.4f} s a batch ({len(loaded)} batches of {TRAIN_BATCH}: tar read, Pillow "
        f"decode, crop and resize; {card_line()})")

    dispatch, verdict = train_dalle.DalleTrainer.dispatch, train_dalle.DalleTrainer.verdict
    tree_of, dataset_init = train_dalle.train_state_tree, webdata.TarImageTextDataset.__init__
    events, datasets, trainers, saved, resumed, losses, batches = [], [], [], [], [], [], []
    emits = []  # by dispatch: whether it ended an optimizer step

    def counted_dispatch(self, text, image_tokens):
        if run_no[0] == 2 and not resumed:  # the relaunch's state before its first step
            opt = self.state.opt_state
            resumed.append((int(opt.mini_step), all(
                torch.equal(opt.acc[n], saved[0][1][n]) for n in opt.acc)))
        if run_no[0] < 3:
            trainers[:] = [self]
            batches[:] = [(text, image_tokens)]
        emits.append(self._mini_step == self.ga_steps - 1)
        loss = dispatch(self, text, image_tokens)
        if run_no[0] == 1 and int(self.state.step) == 3:
            os.kill(os.getpid(), signal.SIGTERM)  # the step in flight finishes first
        return loss

    def recorded_verdict(self, loss):
        losses.append(verdict(self, loss))
        events.append((run_no[0], time.perf_counter()))
        return losses[-1]

    def recorded_tree(state):
        tree = tree_of(state)
        opt = tree["opt_state"]
        saved[:] = [(int(opt["mini_step"]), {n: a.clone() for n, a in opt["acc"].items()})]
        return tree

    def recorded_dataset(self, *a, **kw):
        dataset_init(self, *a, **kw)
        datasets.append(self)

    run_no = [0]

    run_errors = []

    def run(label, args):
        run_no[0] += 1
        out = io.StringIO()
        names = tuple(kernel_counters())
        # the loader counts into the process-wide registry, empty at the
        # start of each run as in a new process
        reset_registries()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                train_dalle.main(args)
        except SystemExit as e:
            if e.code not in (0, None):
                raise
        torch.cuda.synchronize()
        run_errors.append(metric_counters.get("webdata.decode_errors"))
        for line in out.getvalue().splitlines():
            if not line.startswith("config:"):
                log(f"{label} | {line}")
        return out.getvalue(), {n: c for n, c in read_counts(names).items() if c}, (
            time.perf_counter() - t0)

    train_dalle.DalleTrainer.dispatch = counted_dispatch
    train_dalle.DalleTrainer.verdict = recorded_verdict
    train_dalle.train_state_tree = recorded_tree
    webdata.TarImageTextDataset.__init__ = recorded_dataset
    try:
        text1, launched1, wall1 = run("train CLI ga run 1", argv)
        n1 = len(losses)
        text2, launched2, wall2 = run("train CLI ga run 2", argv)
        n2 = len(losses) - n1
        _, launched3, wall3 = run("train CLI ga control", control_argv)
    finally:
        train_dalle.DalleTrainer.dispatch, train_dalle.DalleTrainer.verdict = dispatch, verdict
        train_dalle.train_state_tree = tree_of
        webdata.TarImageTextDataset.__init__ = dataset_init
    micro = n1 + n2
    n3 = len(losses) - micro
    trainer = trainers[0]
    check_dropout_on_card(trainer, *batches[0])
    # the wall between consecutive verdicts of one run covers the later
    # dispatch: (run, whether that dispatch emitted, wall)
    walls = [(a[0], emits[j + 1], b[1] - a[1])
             for j, (a, b) in enumerate(zip(events, events[1:])) if a[0] == b[0]]
    ga_walls = [w for r, _, w in walls if r < 3]
    by_emit = {e: [w for r, x, w in walls if r < 3 and x == e] for e in (True, False)}
    control_walls = [w for r, _, w in walls if r == 3]
    steady = float(np.median(ga_walls)) if ga_walls else float("nan")
    control = float(np.median(control_walls)) if control_walls else float("nan")
    tokens_per_step = TRAIN_BATCH * (FLAGSHIP["text_seq_len"] + vae.fmap_size**2)
    opt = restore_opt_state(CLI_GA_DIR / "dalle.ckpt", device="cpu")
    decode_errors = run_errors if all(d.counters is metric_counters for d in datasets) else None
    want = {name: depth * (micro + n3) for name in PACKED}
    runs = (launched1, launched2, launched3)
    launched = {n: sum(r.get(n, 0) for r in runs) for n in set().union(*runs)}
    replayed = ("tar-stream loader has no reproducible epoch order: replaying epoch 0 from its "
                "start" in text2)
    log(f"train CLI ga: run 1 {n1} micro-steps (SIGTERM at the third), run 2 {n2}; losses "
        f"{[round(x, 4) for x in losses]}; emergency save mini_step {saved[0][0] if saved else None}"
        f", restored mini_step and accumulator bitwise {resumed}; tar replay logged {replayed}; "
        f"decode errors by run {decode_errors}; final Adam count {int(opt.inner.count)}, "
        f"mini_step {int(opt.mini_step)}, gradient_step {int(opt.gradient_step)}")
    log(f"train CLI ga: micro-step as the CLI runs it (wall between verdicts, median of "
        f"{len(ga_walls)}: {[round(w, 4) for w in ga_walls]}) {steady:.4f} s, "
        f"{tokens_per_step / steady:.1f} training tokens/s; emitting micro-steps "
        f"{[round(w, 4) for w in by_emit[True]]} s, the others "
        f"{[round(w, 4) for w in by_emit[False]]} s; the same-size control (both rates 0, "
        f"ga_steps 1, {n3} steps) {[round(w, 4) for w in control_walls]}, median "
        f"{control:.4f} s; micro-step / control step {steady / control:.4f}; run 1 "
        f"{wall1:.1f} s, run 2 {wall2:.1f} s, control {wall3:.1f} s; launches {launched} "
        f"(expected {want}); {card_line()}")
    problems = []
    if not all(math.isfinite(x) for x in losses) or (n1, n2, n3) != (3, 3, 3):
        problems.append(f"losses {losses} over {n1} + {n2} micro-steps and {n3} control steps")
    if launched != want:
        problems.append(f"launches {launched}, expected {want}")
    if (int(opt.inner.count), int(opt.mini_step), int(opt.gradient_step)) != (micro // 2, 0,
                                                                               micro // 2):
        problems.append(f"Adam count {int(opt.inner.count)}, mini_step {int(opt.mini_step)}")
    if not saved or saved[0][0] != 1 or resumed != [(1, True)]:
        problems.append(f"saved mini_step {saved[0][0] if saved else None}, restored {resumed}")
    if decode_errors != [1, 1, 1] or not replayed:
        problems.append(f"decode errors {decode_errors}, tar replay logged {replayed}")
    if f"resuming from {CLI_GA_DIR / 'dalle-cp'} step 3 (epoch 0, iter 2)" not in text2:
        problems.append("the relaunch did not resume from step 3")
    del trainer, trainers[:], batches[:], saved[:]
    shutil.rmtree(CLI_GA_DIR, ignore_errors=True)
    log(f"train CLI ga: phase wall {time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise AssertionError("train CLI ga: " + "; ".join(problems))
    return launched


# the tiled flash kernels of the 512 px training shape by device function:
# (the kernel phase's row, its key of the ms a launch)
# {kernel function: (kernel phase row, key of its time)} of the kernels
# whose profiled ms a step ``profile_train`` holds against the kernel
# phase's: the tiled ones (timed at the 512 px shape) and the pair grid's
# (timed at the training shape with the axial_row layout)
# ------------------------------------- reversible, remat, VAE and CLIP trainers


def flagship_trainer(vae, **flags):
    """``DalleTrainer`` of phase 8's flagship (seed 0, token shift,
    rotary) on ``vae`` with ``flags`` (``bf16``, ``reversible``,
    ``remat``)."""
    from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer

    return DalleTrainer(
        vae, num_text_tokens=FLAGSHIP["num_text_tokens"], device="cuda", seed=0,
        dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], heads=FLAGSHIP["heads"],
        dim_head=FLAGSHIP["dim_head"], text_seq_len=FLAGSHIP["text_seq_len"],
        shift_tokens=True, rotary_emb=True, **flags)


@contextlib.contextmanager
def plain_packed():
    """The packed-qkv kernels' plain versions in their wrappers' place
    (on the card; nothing counted while it lasts)."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    saved = fa.fused_qkv_attention, fa.fused_qkv_attention_bwd
    fa.fused_qkv_attention, fa.fused_qkv_attention_bwd = (fa.reference_fused_qkv,
                                                          fa.reference_fused_qkv_bwd)
    try:
        yield
    finally:
        fa.fused_qkv_attention, fa.fused_qkv_attention_bwd = saved


def timed_steps(trainer, batch, steps: int) -> dict:
    """``steps`` of ``trainer.train_step`` on ``batch``, each synchronised:
    {"losses", "walls" (s), "peak" (GiB since just before)}."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(*batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"losses": losses, "walls": walls,
            "peak": torch.cuda.max_memory_allocated() / 2**30}


def model_grads(dalle, text, tokens):
    """(loss, every parameter's gradient) of one forward and backward."""
    loss = dalle(text, tokens, return_loss=True)
    grads = torch.autograd.grad(loss, list(dalle.parameters()))
    return loss.item(), [g.detach() for g in grads]


def train_reversible(vae, batch) -> dict:
    """Phases 8d and 8e: reversible and remat execution at the flagship's
    widths (phase 8's model, seed, batch and VAE), float32 and mixed
    precision. For each type: a reversible DALLE's loss and every
    gradient with the packed kernels against the same with their plain
    versions on the card (phase 4's tolerances: float32 loss relative
    1e-5, each gradient 1e-4 of its largest entry; bf16 within
    ``BF16_GAP_FACTOR`` times the plain bf16-to-float32 gap); then
    ``REV_STEPS`` steps each of the sequential, reversible (kernels),
    reversible (plain versions: nothing launched) and remat trainers of
    the same seed, each counted: sequential the packed forward and
    backward depth x dispatches each, reversible and remat the forward 2 x
    depth x dispatches and the backward depth x dispatches. Reversible's
    losses against its plain run's at phase 4's tolerances; remat's loss
    sequence bitwise sequential's; reversible's and remat's peak memory
    below sequential's. Prints each run's step walls, losses and peak
    memory. Returns the launches by path."""
    from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio

    depth = FLAGSHIP["depth"]
    text, images = batch
    tokens = vae.get_codebook_indices(images)
    paths, f32_plain = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tag = " bf16" if bf16 else ""
        trainer = flagship_trainer(vae, bf16=bf16, reversible=True)
        zero_counts()
        loss_k, grads_k = model_grads(trainer.dalle, text, tokens)
        launched = read_counts(PACKED)
        with plain_packed():
            loss_p, grads_p = model_grads(trainer.dalle, text, tokens)
        names = [k for k, _ in trainer.dalle.named_parameters()]
        if not bf16:
            f32_plain["loss"], f32_plain["grads"] = loss_p, [g.cpu() for g in grads_p]
            loss_err = abs(loss_k - loss_p) / abs(loss_p)
            worst = max(((gk - gp).abs().max().item() / gp.abs().max().item(), n)
                        for gk, gp, n in zip(grads_k, grads_p, names))
            ok = loss_err <= 1e-5 and worst[0] <= 1e-4
        else:
            loss_err = gap_ratio(loss_k, loss_p, f32_plain["loss"])
            worst = max((gap_ratio(gk.cpu(), gp.cpu(), gf), n) for gk, gp, gf, n in
                        zip(grads_k, grads_p, f32_plain["grads"], names))
            ok = loss_err <= BF16_GAP_FACTOR and worst[0] <= BF16_GAP_FACTOR
        want = {"fused_qkv_attention": 2 * depth, "fused_qkv_attention_bwd": depth}
        log(f"train reversible{tag}: one forward and backward, kernels vs plain versions on "
            f"the card: loss {loss_k:.6f} / {loss_p:.6f} "
            f"({'relative' if not bf16 else 'of the bf16-to-float32 gap'} {loss_err:.3e}), "
            f"worst gradient {worst[0]:.3e} ({worst[1]}); launches {launched} (expected {want})")
        if not ok or launched != want:
            raise AssertionError(f"train reversible{tag}: kernels vs plain {loss_err}, {worst}, "
                                 f"launches {launched}")
        del trainer, grads_k, grads_p
        release_memory()

        runs = {}
        for mode in ("sequential", "reversible", "reversible plain", "remat"):
            flags = {} if mode == "sequential" else {mode.split()[0]: True}
            trainer = flagship_trainer(vae, bf16=bf16, **flags)
            zero_counts()
            if mode.endswith("plain"):
                with plain_packed():
                    runs[mode] = timed_steps(trainer, batch, REV_STEPS)
            else:
                runs[mode] = timed_steps(trainer, batch, REV_STEPS)
            counts = read_counts(PACKED)
            n = trainer.steps + trainer.retries
            fwd = {"sequential": depth, "reversible plain": 0}.get(mode, 2 * depth)
            want = {"fused_qkv_attention": fwd * n,
                    "fused_qkv_attention_bwd": (0 if mode.endswith("plain") else depth) * n}
            r = runs[mode]
            log(f"train {mode}{tag}: {trainer.steps} steps, {trainer.retries} retries, losses "
                + ", ".join(f"{x:.6f}" for x in r["losses"]) + "; step walls "
                + ", ".join(f"{w:.4f}" for w in r["walls"])
                + f" s; peak memory {r['peak']:.2f} GiB; launches {counts} (expected {want})")
            if counts != want or not all(np.isfinite(r["losses"])):
                raise AssertionError(f"train {mode}{tag}: launches {counts}, expected {want}; "
                                     f"losses {r['losses']}")
            if mode in ("reversible", "remat"):
                paths[f"train_{mode}{tag.replace(' ', '_')}"] = counts
            del trainer
            release_memory()
        seq, rev, plain, remat = (runs[m] for m in ("sequential", "reversible",
                                                    "reversible plain", "remat"))
        if not bf16:
            f32_plain["steps"] = plain["losses"]
            rev_gap = max(abs(k - p) / abs(p) for k, p in zip(rev["losses"], plain["losses"]))
            rev_ok = rev_gap <= 1e-5
        else:
            rev_gap = gap_ratio(rev["losses"], plain["losses"], f32_plain["steps"])
            rev_ok = rev_gap <= BF16_GAP_FACTOR
        steady = {m: float(np.median(r["walls"][1:])) for m, r in runs.items()}
        log(f"train reversible/remat{tag} ({REV_STEPS} steps, batch {TRAIN_BATCH}, median step "
            f"wall of steps 2-{REV_STEPS}): sequential {steady['sequential']:.4f} s "
            f"{seq['peak']:.2f} GiB; reversible {steady['reversible']:.4f} s "
            f"{rev['peak']:.2f} GiB; remat {steady['remat']:.4f} s {remat['peak']:.2f} GiB; "
            f"reversible losses vs plain {rev_gap:.3e}; remat losses bitwise sequential "
            f"{remat['losses'] == seq['losses']}")
        problems = []
        if not rev_ok:
            problems.append(f"reversible's losses part from the plain run's: {rev_gap}")
        if remat["losses"] != seq["losses"]:
            problems.append(f"remat's losses {remat['losses']} are not sequential's "
                            f"{seq['losses']}")
        for mode in ("reversible", "remat"):
            if not runs[mode]["peak"] < seq["peak"]:
                problems.append(f"{mode}'s peak memory {runs[mode]['peak']:.3f} GiB is not below "
                                f"sequential's {seq['peak']:.3f} GiB")
        if problems:
            raise AssertionError(f"train reversible/remat{tag}: " + "; ".join(problems))
    return paths


def serve_reversible() -> dict:
    """Phase 5h: a reversible DALLE served and generating: ``SERVE_MODEL``
    with ``reversible=True``, float32, seeded weights on the card and the
    same on the CPU, greedy (``filter_thres`` 0.99). 2 requests of 16
    tokens (full-length prompts with zero tails) through the split path
    (``EngineConfig``'s defaults, monolithic prefill) and the fused
    iteration (chunks of 16), max_batch 2: every outcome COMPLETED, the
    tokens on the card equal to the CPU's (plain versions), the ragged
    kernel launched depth x dispatches times and no other kernel. Then
    ``decode_tokens`` of 2 captions on the "flat" cache with the decode
    kernel, window 0, 16 tokens: tokens card = CPU, the decode kernel
    launched depth x 15 times. Returns the launches by path."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.models.sampling import decode_tokens
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Outcome, Request

    t0 = time.perf_counter()
    depth, new = SERVE_MODEL["depth"], REV_SERVE_TOKENS
    gpu = DALLE(**SERVE_MODEL, reversible=True, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(3))
    cpu = DALLE(**SERVE_MODEL, reversible=True, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.RandomState(31)
    prompts = rng.randint(1, FLAGSHIP["num_text_tokens"], size=(2, FLAGSHIP["text_seq_len"]))
    prompts[0, 200:], prompts[1, 90:] = 0, 0
    names = tuple(kernel_counters())
    paths, report = {}, []
    for path, config in (("split", {}), ("fused", dict(fused_iteration=True, prefill_chunk=16))):
        results = {}
        for model in (gpu, cpu):
            engine = Engine(model, EngineConfig(max_batch=2, filter_thres=0.99, **config),
                            device=model.device.type)
            for i, prompt in enumerate(prompts):
                assert engine.submit(Request(f"r{i}", prompt, new, seed=40 + i)) is None
            zero_counts()
            results[model] = engine.run(max_steps=2000)
            if model is gpu:
                launched = {n: c for n, c in read_counts(names).items() if c}
                want = {"ragged_attention": depth * engine.dispatches}
        done = all(r.outcome is Outcome.COMPLETED and len(r.tokens) == new
                   for run in results.values() for r in run.values())
        same = all(np.array_equal(results[gpu][r].tokens, results[cpu][r].tokens)
                   for r in results[gpu])
        report.append(f"{path}: COMPLETED {done}, tokens card = CPU {same}, launches "
                      f"{launched} (expected {want})")
        if not (done and same and launched == want):
            raise AssertionError(f"serve reversible, {path}: {report[-1]}")
        paths[f"serve_reversible_{path}"] = launched
    T = gpu.text_len_internal
    text = torch.from_numpy(prompts)
    tokens = {}
    for model in (gpu, cpu):
        buf = torch.zeros((2, T + gpu.image_seq_len), dtype=torch.int32, device=model.device)
        buf[:, :T] = model.remap_text(text.to(model.device))
        zero_counts()
        out = decode_tokens(model, buf, T, 0, num_steps=T + new - 1, prefill_len=T,
                            cache_format="flat", fused_decode=True, window_seg=0,
                            filter_thres=0.99)
        tokens[model] = out[:, T:T + new].cpu()
        if model is gpu:
            launched = {n: c for n, c in read_counts(names).items() if c}
    want = {"fused_decode_attention": depth * (new - 1)}
    same = torch.equal(tokens[gpu], tokens[cpu])
    report.append(f"generate flat with the decode kernel: tokens card = CPU {same}, launches "
                  f"{launched} (expected {want})")
    log(f"serve reversible (SERVE_MODEL, float32, greedy, {new} tokens a request) in "
        f"{time.perf_counter() - t0:.1f} s: " + "; ".join(report))
    if not same or launched != want:
        raise AssertionError(f"generate reversible: {report[-1]}")
    paths["generate_reversible"] = launched
    return paths


# phase 5i: requests of the prefix and speculative runs, their tokens,
# the spec run's draft depth and width, and the prefix runs' token
# budget (every prefilling row's chunk in each iteration)
PREFIX_NEW, SPEC_NEW, SPEC_K, SPEC_DRAFT_DEPTH = 64, 64, 3, 2
PREFIX_BUDGET = MAX_BATCH * (CHUNK + 1)


def prefix_prompts(n: int = 4) -> np.ndarray:
    """Phase 5i's prompts: full-length seeded captions, the first 127
    tokens (with <bos>, the first 128 internal positions: one page)
    shared by all, the rest each its own."""
    rng = np.random.RandomState(55)
    L = FLAGSHIP["text_seq_len"]
    prompts = rng.randint(1, FLAGSHIP["num_text_tokens"], size=(n, L))
    prompts[1:, :PAGE - 1] = prompts[0, :PAGE - 1]
    return prompts


def prefix_rounds():
    """(round name, [(request id, prompt index)]): a publisher, three
    partial hits on its first page, then the four prompts again (full
    hits, each copying its one-row terminal page)."""
    return (("cold", [("r0", 0)]), ("partial", [(f"r{i}", i) for i in (1, 2, 3)]),
            ("full", [(f"r{i}w", i) for i in range(4)]))


def run_rounds(engine, prompts, rounds, max_new: int) -> dict:
    """Submit and run each round in turn; the results by request id."""
    from dalle_pytorch_tpu_torch.serving.types import Request

    for _, reqs in rounds:
        for rid, i in reqs:
            assert engine.submit(Request(rid, prompts[i], max_new, seed=i)) is None
        engine.run(max_steps=20000)
    return engine.results


PREFIX_COUNTERS = ("hits", "misses", "pages_hit", "cow_copies", "published", "pages_deduped",
                   "publish_skips", "evictions")


def prefix_counts(engine) -> dict:
    return {k: engine.counters.get(f"serve.prefix.{k}") for k in PREFIX_COUNTERS}


def engine_launches(engine, names) -> tuple:
    """(launches read now, the ones the engine's counted model calls
    imply: depth x model dispatches (a full hit's draw is a dispatch that
    launches nothing) plus the drafter's depth x its steps, on the
    instance of the engine's pages)."""
    depth = SERVE_MODEL["depth"]
    draft = engine.config.spec_draft_depth or depth
    name = "ragged_attention_int8" if engine.kv_quant == "int8" else "ragged_attention"
    want = {n: 0 for n in names}
    want[name] = depth * (engine.dispatches - engine.cached_draws) + draft * engine.draft_steps
    return read_counts(names), want


def ttft_by_class(results, classes: dict) -> str:
    out = []
    for cls, rids in classes.items():
        t = [results[r].ttft_s * 1e3 for r in rids]
        out.append(f"{cls} {np.median(t):.1f} ms (median of {len(t)}: "
                   + ", ".join(f"{x:.1f}" for x in t) + ")")
    return "; ".join(out)


def spy_draft_gaps(engine) -> dict:
    """Record, on a speculative engine, the largest |drafter logits -
    verify logits| at each verify row's positions whose input tokens the
    two passes share (the accepted drafts and the first rejected one),
    and at the rejected positions alone. Patches the engine's model and
    its readback; returns the dict the records fill."""
    gaps = {"compared": 0.0, "rejected": []}
    calls = []
    model = engine.dalle
    fused_step = type(model).fused_step

    def spy(*args, **kw):
        out = fused_step(model, *args, **kw)
        calls.append(out)
        return out

    readback = engine._spec_readback

    def spied(out, entries, K):
        drafts, (cols, _) = calls[:-1], calls[-1]
        calls.clear()
        samples, drafted = out[:, :K], out[:, K:2 * K - 1]
        for s, kind, k in entries:
            if kind != "decode" or engine.slots[s.index] is not s:
                continue
            m = 0
            while m < k - 1 and drafted[s.index, m] == samples[s.index, m]:
                m += 1
            for i in range(min(m + 1, k - 1)):
                gap = (drafts[i][s.index] - cols[s.index, i]).abs().max().item()
                gaps["compared"] = max(gaps["compared"], gap)
                if i == m:
                    gaps["rejected"].append(gap)
        return readback(out, entries, K)

    model.fused_step = spy
    engine._spec_readback = spied
    return gaps


def serve_prefix_spec() -> dict:
    """Phase 5i: the prefix cache and speculative decode through the
    engine at ``SERVE_MODEL`` (bf16, phase 5's seed), max_batch 8, chunks
    of 16, pages of 128 (T = 257: a prompt fills two pages and one row of
    a third). Returns the launches by path.

    Prefix cache, on the fused path and on the split path with chunks,
    with bf16 and with int8 pages (token budget ``PREFIX_BUDGET``): the
    rounds of ``prefix_rounds`` (8 requests of 64 tokens: a publisher,
    three partial hits on its first page, the four prompts again as full
    hits) through an engine with the cache, and the four prompts through
    one without: every outcome COMPLETED, every warm request's tokens
    bitwise the cold engine's, the hit, miss, copy-on-write and other
    prefix counters equal those of a CPU engine with a small model of the
    same sequence geometry on the same rounds, the ragged kernel launched
    depth x model dispatches times, ``verify_invariants(idle=True)``; on
    the fused bf16 engine also a ``prefix_hash_collide`` round (cold
    fallback, tokens unchanged) and a ``prefix_publish_fail`` round (the
    request completes, the publish skipped). TTFT cold, partial and full
    on the real clock printed.

    Speculative decode on the fused path, spec_k 3, 4 of ``serve_
    requests`` of 64 tokens: a plain fused engine, then the exact drafter
    (every layer), the exact drafter with one ``spec_verify_abort``, the
    drafter of ``SPEC_DRAFT_DEPTH`` layers, and the exact drafter with the
    prefix cache over two rounds of the same requests (full hits): tokens
    bitwise the plain engine's (the warm round's the cold round's), the
    ragged kernel launched depth x dispatches + draft depth x draft steps
    times. Accept rates, and wall and tokens/s of spec against plain
    printed."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
    from dalle_pytorch_tpu_torch.serving.types import Outcome

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = DALLE(**SERVE_MODEL, device="cuda", dtype=torch.bfloat16).init_weights(gen)
    # the CPU engine's model: the serve model's sequence geometry at a
    # small width (the counters are host logic)
    small = DALLE(**dict(SERVE_MODEL, dim=64, depth=1, heads=1), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    prompts = prefix_prompts()
    rounds = prefix_rounds()
    paths, report = {}, []
    paths_cfg = {"fused": dict(fused_iteration=True), "split": {}}
    cpu_counts = {}
    for path, cfg in paths_cfg.items():
        # every engine whose counters are read writes series of its own
        cpu = Engine(small, EngineConfig(max_batch=MAX_BATCH, prefill_chunk=CHUNK,
                                         token_budget=PREFIX_BUDGET, prefix_cache=True, **cfg),
                     device="cpu", metric_labels={"engine": f"cpu {path}"})
        run_rounds(cpu, prompts, rounds, PREFIX_NEW)
        cpu_counts[path] = prefix_counts(cpu)
    for kv_quant in (None, "int8"):
        for path, cfg in paths_cfg.items():
            label = f"serve prefix {path} {kv_quant or 'bf16'}"
            config = dict(max_batch=MAX_BATCH, prefill_chunk=CHUNK, token_budget=PREFIX_BUDGET,
                          kv_quant=kv_quant, **cfg)
            cold = Engine(model, EngineConfig(**config), device="cuda")
            cold_results = run_rounds(cold, prompts, [("cold", [(f"r{i}", i) for i in range(4)])],
                                      PREFIX_NEW)
            engine = Engine(model, EngineConfig(prefix_cache=True, **config), device="cuda",
                            metric_labels={"engine": label})
            zero_counts()
            t0 = time.perf_counter()
            results = run_rounds(engine, prompts, rounds, PREFIX_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched, want = engine_launches(engine, RAGGED)
            for rid, r in results.items():
                if r.outcome is not Outcome.COMPLETED or len(r.tokens) != PREFIX_NEW:
                    raise AssertionError(f"{label}: {rid} {r.outcome} {r.detail!r}")
                if not np.array_equal(r.tokens, cold_results[rid.rstrip("w")].tokens):
                    raise AssertionError(f"{label}: {rid}'s tokens are not the cold run's")
            counts = prefix_counts(engine)
            engine.verify_invariants(idle=True)
            line = (f"{label}: 8 requests in {wall:.2f} s, {engine.dispatches} dispatches "
                    f"({engine.cached_draws} cached draws); counters {counts} (CPU engine "
                    f"{cpu_counts[path]}); launches {launched} (expected {want}); TTFT "
                    + ttft_by_class(results, {"cold": ["r0"], "partial": ["r1", "r2", "r3"],
                                              "full": [f"r{i}w" for i in range(4)]}))
            log(line)
            if counts != cpu_counts[path] or launched != want:
                raise AssertionError(line)
            if counts["hits"] != 7 or counts["cow_copies"] != 4:
                raise AssertionError(f"{label}: expected 7 hits and 4 copies, {counts}")
            paths[f"serve_prefix_{path}" + ("_int8" if kv_quant else "")] = launched
            if path == "fused" and kv_quant is None:
                from dalle_pytorch_tpu_torch.serving.types import Request

                engine.faults.arm("prefix_hash_collide", 1)
                assert engine.submit(Request("c0", prompts[0], PREFIX_NEW, seed=0)) is None
                engine.run(max_steps=20000)
                engine.faults.arm("prefix_publish_fail", 1)
                assert engine.submit(Request("f1", prompts[1], PREFIX_NEW, seed=1)) is None
                engine.run(max_steps=20000)
                c0, f1 = engine.results["c0"], engine.results["f1"]
                drill = (f"collide fired {engine.faults.fired.get('prefix_hash_collide')}, "
                         f"collisions {engine.prefix.stats.collisions}, tokens = cold "
                         f"{np.array_equal(c0.tokens, cold_results['r0'].tokens)}; publish "
                         f"fail fired {engine.faults.fired.get('prefix_publish_fail')}, "
                         f"{f1.outcome.value}, skips {engine.counters.get('serve.prefix.publish_skips')}")
                log(f"{label} drills: {drill}")
                engine.verify_invariants(idle=True)
                if not (engine.prefix.stats.collisions == 1
                        and np.array_equal(c0.tokens, cold_results["r0"].tokens)
                        and f1.outcome is Outcome.COMPLETED
                        and engine.counters.get("serve.prefix.publish_skips") == 1):
                    raise AssertionError(f"{label} drills: {drill}")
            del engine, cold

    requests = lambda: serve_requests(4, SPEC_NEW)  # noqa: E731
    runs = {}
    spec = dict(spec_decode=True, spec_k=SPEC_K)
    for name, cfg, arm in (("plain", {}, None), ("spec", spec, None),
                           ("spec_abort", spec, "spec_verify_abort"),
                           (f"spec_depth{SPEC_DRAFT_DEPTH}",
                            dict(spec, spec_draft_depth=SPEC_DRAFT_DEPTH), None),
                           ("spec_prefix", dict(spec, prefix_cache=True), None)):
        engine = Engine(model, EngineConfig(max_batch=MAX_BATCH, fused_iteration=True,
                                            prefill_chunk=CHUNK, **cfg), device="cuda",
                        metric_labels={"engine": name})
        if arm:
            engine.faults.arm(arm, 1)
        gaps = spy_draft_gaps(engine) if name == "spec" else None
        reqs = requests()
        for r in reqs:
            assert engine.submit(r) is None
        zero_counts()
        t0 = time.perf_counter()
        results = dict(engine.run(max_steps=20000))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched, want = engine_launches(engine, RAGGED)
        if name == "spec_prefix":
            for r in requests():
                assert engine.submit(dataclasses.replace(r, request_id=r.request_id + "w")) is None
            engine.run(max_steps=20000)
            launched, want = engine_launches(engine, RAGGED)
            results = engine.results
        engine.verify_invariants(idle=True)
        bad = [rid for rid, r in results.items()
               if r.outcome is not Outcome.COMPLETED or len(r.tokens) != SPEC_NEW]
        if bad:
            raise AssertionError(f"serve {name}: {bad} not COMPLETED")
        ref = runs["plain"]["results"] if name != "plain" else results
        same = all(np.array_equal(r.tokens, ref[rid.rstrip("w")].tokens)
                   for rid, r in results.items())
        rate = (engine._spec_accepted / engine._spec_drafted) if engine._spec_drafted else None
        runs[name] = dict(results=results, wall=wall, rate=rate)
        line = (f"serve {name}: {len(results)} requests, {engine.dispatches} dispatches, "
                f"{engine.draft_steps} draft steps, {wall:.2f} s wall, "
                f"{4 * SPEC_NEW / wall:.1f} tokens/s; drafted {engine._spec_drafted}, accepted "
                f"{engine._spec_accepted} (rate {rate}); fallbacks "
                f"{engine.counters.get('serve.spec.fallbacks')}; tokens = plain {same}; "
                f"launches {launched} (expected {want})")
        if gaps is not None:
            line += (f"; |draft - verify| logits at shared inputs max {gaps['compared']:.4g}, "
                     f"at the {len(gaps['rejected'])} rejections "
                     + ", ".join(f"{g:.4g}" for g in gaps["rejected"]))
        log(line)
        if not same or launched != want or (arm and engine.counters.get(
                "serve.spec.fallbacks") != 1):
            raise AssertionError(line)
        if name != "plain":
            paths[f"serve_{name}"] = launched
        del engine
    plain, exact = runs["plain"]["wall"], runs["spec"]["wall"]
    log(f"serve spec against plain ({card_line()}): spec_k {SPEC_K}, accept rates exact "
        f"{runs['spec']['rate']}, depth {SPEC_DRAFT_DEPTH} "
        f"{runs[f'spec_depth{SPEC_DRAFT_DEPTH}']['rate']}; wall plain {plain:.2f} s "
        f"({4 * SPEC_NEW / plain:.1f} tokens/s), exact {exact:.2f} s "
        f"({4 * SPEC_NEW / exact:.1f} tokens/s), depth {SPEC_DRAFT_DEPTH} "
        f"{runs[f'spec_depth{SPEC_DRAFT_DEPTH}']['wall']:.2f} s; phase 5i in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return paths


def run_cli(main, argv, label: str, cwd) -> tuple:
    """``main(argv, device="cuda")`` in ``cwd``, its output logged:
    (output, launches, wall s, peak GiB)."""
    import os

    out = Tee(label)
    names = tuple(kernel_counters())
    here = os.getcwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(out):
            main(argv, device="cuda")
        torch.cuda.synchronize()
    finally:
        os.chdir(here)
    return (out.getvalue(), {n: c for n, c in read_counts(names).items() if c},
            time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30)


def recorded_steps(module, sink: list):
    """Patch ``module.make_train_step`` so that every step is synchronised
    and appends (loss, its wall s from the call to the card's end) to
    ``sink``; returns the restorer."""
    make = module.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            sink.append((float(out[1]), time.perf_counter() - t0))
            return out
        return run

    module.make_train_step = recording
    return lambda: setattr(module, "make_train_step", make)


def train_vae_cli() -> None:
    """Phase 13: ``python -m dalle_pytorch_tpu_torch.train_vae`` in this
    process at BASELINE.json configs[0] (256 px, ``--num_tokens 8192
    --num_layers 3 --emb_dim 512 --hidden_dim 256 --num_resnet_blocks 2
    --batch_size 8``) on ``VAE_CLI_IMAGES`` seeded 256 px PNGs under
    ``VAE_CLI_DIR`` (removed at the end), ``--epochs VAE_CLI_EPOCHS``: 16
    steps an epoch, 112 in all, so that the run crosses the step-100 log
    (loss, codebook usage, a reconstruction grid) and epoch ends. Every
    loss finite; the last epoch's checkpoint read back through
    ``models.factory.vae_from_checkpoint`` bitwise equal to the trained
    state; two grids (steps 0 and 100) of (512, 1024, 3); no attention
    kernel launched. Prints the step wall (each step synchronised), steps
    and images a second, the phase's peak memory and wall."""
    import shutil

    from dalle_pytorch_tpu_torch import train_vae
    from dalle_pytorch_tpu_torch.data.image_io import read_png
    from dalle_pytorch_tpu_torch.models import factory
    from dalle_pytorch_tpu_torch.parallel import step as step_module
    from dalle_pytorch_tpu_torch.testing import write_caption_folder

    t_phase = time.perf_counter()
    shutil.rmtree(VAE_CLI_DIR, ignore_errors=True)
    write_caption_folder(VAE_CLI_DIR / "images", VAE_CLI_IMAGES, 256, seed=41)
    argv = ["--image_folder", str(VAE_CLI_DIR / "images"), "--image_size", "256",
            "--num_tokens", "8192", "--num_layers", "3", "--emb_dim", "512",
            "--hidden_dim", "256", "--num_resnet_blocks", "2", "--batch_size", "8",
            "--epochs", str(VAE_CLI_EPOCHS), "--output_file_name", str(VAE_CLI_DIR / "vae.ckpt"),
            "--samples_dir", str(VAE_CLI_DIR / "samples")]
    steps, saved = [], []
    save = factory.save_vae_checkpoint

    def keep_state(path, vae, extra=None):
        save(path, vae, extra)
        saved.append({k: t.detach().clone() for k, t in vae.state_dict().items()})

    restore = recorded_steps(step_module, steps)
    factory.save_vae_checkpoint = keep_state
    try:
        text, launched, wall, peak = run_cli(train_vae.main, argv, "train VAE CLI", VAE_CLI_DIR)
    finally:
        restore()
        factory.save_vae_checkpoint = save
    losses = [loss for loss, _ in steps]
    back, meta = factory.vae_from_checkpoint(VAE_CLI_DIR / "vae.ckpt", device="cuda")
    same = sorted(back.state_dict()) == sorted(saved[-1]) and all(
        torch.equal(back.state_dict()[k], t) for k, t in saved[-1].items())
    grids = sorted((VAE_CLI_DIR / "samples").glob("*.png"))
    shapes = [read_png(p.read_bytes()).pixels.shape for p in grids]
    step_s = float(np.median([w for _, w in steps[1:]]))
    log(f"train VAE CLI (configs[0]: 256 px, 8192 tokens, 3 layers, 2 ResBlocks, batch 8): "
        f"{len(losses)} steps over {VAE_CLI_EPOCHS} epochs, losses first {losses[0]:.5f} "
        f"last {losses[-1]:.5f}; step wall (synchronised, median of steps 2-{len(steps)}) "
        f"{step_s:.4f} s, {1 / step_s:.2f} steps/s, {8 / step_s:.1f} images/s; peak memory "
        f"{peak:.2f} GiB; run {wall:.1f} s; checkpoint epoch "
        f"{meta['epoch']}, read back bitwise {same}; grids {[p.name for p in grids]} {shapes}; "
        f"launches {launched}")
    shutil.rmtree(VAE_CLI_DIR, ignore_errors=True)
    log(f"train VAE CLI: phase wall {time.perf_counter() - t_phase:.1f} s")
    steps_want = VAE_CLI_EPOCHS * (VAE_CLI_IMAGES // 8)
    problems = []
    if len(losses) != steps_want or not all(np.isfinite(losses)):
        problems.append(f"{len(losses)} losses (expected {steps_want}), finite "
                        f"{all(np.isfinite(losses))}")
    if not same or meta["epoch"] != VAE_CLI_EPOCHS - 1 or len(saved) != VAE_CLI_EPOCHS:
        problems.append(f"checkpoint read back bitwise {same}, epoch {meta['epoch']}, "
                        f"{len(saved)} saves")
    if [p.name for p in grids] != ["recon_0000000.png", "recon_0000100.png"] or any(
            s != (512, 1024, 3) for s in shapes):
        problems.append(f"grids {grids} {shapes}")
    if "codebook_indices histogram" not in text or launched:
        problems.append(f"no codebook histogram logged, or kernels launched {launched}")
    if problems:
        raise AssertionError("train VAE CLI: " + "; ".join(problems))


def clip_loss_parts(logits):
    """(the 2b cross-entropy terms whose mean is CLIP's loss, the (b, b)
    summands ``dloss/dlogits * logits`` whose sum is the loss's gradient
    with respect to the temperature) of (b, b) logits, float64, as
    tests/test_torch_clip_train.py computes them."""
    logits = logits.double()
    b = logits.shape[0]
    log_p, log_q = torch.log_softmax(logits, -1), torch.log_softmax(logits.t(), -1)
    terms = -torch.cat([log_p.diagonal(), log_q.diagonal()])
    eye = torch.eye(b, dtype=torch.float64)
    dlogits = (log_p.exp() - eye) / (2 * b) + (log_q.exp() - eye).t() / (2 * b)
    return terms, dlogits * logits


def check_clip_loss_against_plain() -> None:
    """Phase 14's first check: one forward and backward of
    ``train_clip.clip_loss`` at ``FLAGSHIP_CLIP`` (batch 32, seeded text
    of lengths 1-256 zero-padded, so the key mask differs by row, and
    seeded pixels), with the packed kernels and with their plain versions
    on the card, float32 and then bf16 compute on float32 parameters. The
    similarity logits (``latents``, times ``exp(temperature)``) come from
    one more forward of each run. Float32: the loss within relative 1e-5,
    the logits and every gradient within 1e-4 of their largest entry.
    bf16, as tests/test_torch_clip_train.py holds it: the logits and every
    gradient of more than one entry within ``BF16_GAP_FACTOR`` times the
    plain bf16-to-float32 gap (``gap_ratio``); the two scalars, whose own
    gap is one draw in which the text and image sides' errors can cancel,
    on what they sum: the loss's relative error within the factor times
    the relative gap of its 2b cross-entropy terms, the temperature's
    gradient's within the factor times that of its (b, b) summands
    (``clip_loss_parts``, whose sum is checked against the plain run's
    gradient). The kernel runs launch the packed forward twice the text
    depth and its backward the text depth, the plain runs nothing
    (comparison launches: no path counts them)."""
    from dalle_pytorch_tpu_torch.models.clip import CLIP
    from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio, rel_l2
    from dalle_pytorch_tpu_torch.train_clip import clip_loss

    depth, n = FLAGSHIP_CLIP["text_enc_depth"], FLAGSHIP_CLIP["text_seq_len"]
    size = FLAGSHIP_CLIP["visual_image_size"]
    rng = np.random.RandomState(45)
    text = rng.randint(1, FLAGSHIP_CLIP["num_text_tokens"], size=(32, n))
    for i, length in enumerate(rng.randint(1, n + 1, size=32)):
        text[i, length:] = 0
    text = torch.from_numpy(text).cuda()
    pixels = torch.from_numpy(rng.rand(32, size, size, 3).astype(np.float32)).cuda()
    f32 = {}
    for dtype in (torch.float32, torch.bfloat16):
        clip = CLIP(**FLAGSHIP_CLIP, device="cuda", dtype=dtype, param_dtype=torch.float32
                    ).init_weights(torch.Generator(device="cuda").manual_seed(44))
        names = [k for k, _ in clip.named_parameters()]
        batch = {"text": text, "image": pixels.to(dtype)}
        runs = {}
        for plain in (False, True):
            zero_counts()
            with plain_packed() if plain else contextlib.nullcontext():
                loss = clip_loss(clip, batch)
                grads = torch.autograd.grad(loss, list(clip.parameters()))
                with torch.no_grad():
                    tl, il = clip.latents(text, batch["image"], text != 0)
                    logits = tl @ il.t() * clip.temperature.float().exp()
            runs[plain] = (loss.item(), logits.cpu(),
                           {name: g.cpu() for name, g in zip(names, grads)},
                           read_counts(PACKED))
            del loss, grads
        (loss_k, logits_k, grads_k, launched), (loss_p, logits_p, grads_p, plain_launched) = (
            runs[False], runs[True])
        if dtype == torch.float32:
            f32 = {"logits": logits_p, "grads": grads_p}
            loss_err = abs(loss_k - loss_p) / abs(loss_p)
            logits_err = ((logits_k - logits_p).abs().max() / logits_p.abs().max()).item()
            worst = max(((grads_k[k] - g).abs().max().item() / g.abs().max().item(), k)
                        for k, g in grads_p.items())
            ok = loss_err <= 1e-5 and logits_err <= 1e-4 and worst[0] <= 1e-4
            what = f"loss relative {loss_err:.3e}, logits {logits_err:.3e} of the largest"
        else:
            logits_err = gap_ratio(logits_k, logits_p, f32["logits"])
            worst = max((gap_ratio(grads_k[k], g, f32["grads"][k]), k)
                        for k, g in grads_p.items() if g.numel() > 1)
            (terms_p, summands_p), (terms_f, summands_f) = (
                clip_loss_parts(x) for x in (logits_p, f32["logits"]))
            loss_err = (rel_l2(torch.tensor(loss_k), torch.tensor(loss_p))
                        / rel_l2(terms_p, terms_f))
            temp_k, temp_p = grads_k["temperature"], grads_p["temperature"]
            temp_err = rel_l2(temp_k, temp_p) / rel_l2(summands_p, summands_f)
            summed = abs(summands_p.sum().item() - temp_p.item()) / abs(temp_p.item())
            ok = (logits_err <= BF16_GAP_FACTOR and worst[0] <= BF16_GAP_FACTOR
                  and loss_err <= BF16_GAP_FACTOR and temp_err <= BF16_GAP_FACTOR
                  and summed <= 1e-4)
            what = (f"loss {loss_k:.6f} / {loss_p:.6f} ({loss_err:.3f} of its terms' gap), "
                    f"temperature gradient {temp_err:.3f} of its summands' gap (their sum "
                    f"within {summed:.1e} of the plain gradient), logits {logits_err:.3f} of "
                    f"the plain bf16-to-float32 gap")
        want = {"fused_qkv_attention": 2 * depth, "fused_qkv_attention_bwd": depth}
        tag = "float32" if dtype == torch.float32 else "bf16"
        log(f"train CLIP loss {tag}: one forward and backward, kernels vs plain versions on the "
            f"card: {what}, worst gradient {worst[0]:.3e} ({worst[1]}); launches {launched} "
            f"(expected {want}), plain {plain_launched}")
        if not ok or launched != want or any(plain_launched.values()):
            raise AssertionError(f"train CLIP loss {tag}: kernels vs plain {what}, {worst}; "
                                 f"launches {launched}, plain {plain_launched}")
        del clip, runs, grads_k, grads_p
        release_memory()


def train_clip_cli() -> dict:
    """Phase 14: ``check_clip_loss_against_plain``, then ``python -m
    dalle_pytorch_tpu_torch.train_clip`` in this process at
    ``train_clip.py``'s defaults (dims 512, 6 + 6 layers of 8 heads, text
    256, 256 px in 32 px patches, batch 32, lr 3e-4, clip 0.5) on
    ``CLIP_CLI_IMAGES`` seeded 256 px PNGs with three captions each under
    ``CLIP_CLI_DIR`` (removed at the end): 2 steps an epoch. Runs:
    float32 ``--epochs 2`` with the kernels (counted: the packed forward
    and backward each text depth x steps), the same with the packed
    kernels' plain versions (``--epochs 1``: its losses within relative
    1e-5 of the kernel run's), ``--bf16`` with the kernels and with the
    plain versions (``--epochs 1``: within ``BF16_GAP_FACTOR`` times the
    plain bf16-to-float32 gap); and a resume from ``--clip_path`` the
    first float32 run's checkpoint at its first epoch's end (copied as it
    is written; it carries the dataset's caption and crop stream) to
    ``--epochs 2``: the resumed losses bitwise the uninterrupted run's
    second epoch, and its final checkpoint's params and Adam state
    bitwise the uninterrupted run's. Prints samples/s (each step
    synchronised). Returns the kernel runs' launches."""
    import shutil

    from dalle_pytorch_tpu_torch import train_clip
    from dalle_pytorch_tpu_torch.models import factory
    from dalle_pytorch_tpu_torch.parallel import step as step_module
    from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio, write_caption_folder
    from dalle_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    check_clip_loss_against_plain()
    shutil.rmtree(CLIP_CLI_DIR, ignore_errors=True)
    write_caption_folder(CLIP_CLI_DIR / "data", CLIP_CLI_IMAGES, 256, seed=43, lines=3)
    depth = FLAGSHIP_CLIP["text_enc_depth"]

    save = factory.save_clip_checkpoint

    def keep_first_epoch(path, clip, extra=None, opt_state=None):
        """Each save, and a copy of the first epoch's end (the resume's
        start)."""
        save(path, clip, extra, opt_state)
        if extra["epoch"] == 0:
            shutil.copyfile(path, CLIP_CLI_DIR / "epoch0.ckpt")

    def run(label, *extra, plain=False, keep_epoch0=False):
        steps = []
        argv = ["--image_text_folder", str(CLIP_CLI_DIR / "data"), "--truncate_captions",
                "--clip_output_file_name", str(CLIP_CLI_DIR / label.replace(" ", "_")), *extra]
        restore = recorded_steps(step_module, steps)
        if keep_epoch0:
            factory.save_clip_checkpoint = keep_first_epoch
        try:
            with plain_packed() if plain else contextlib.nullcontext():
                _, launched, wall, peak = run_cli(train_clip.main, argv, f"train CLIP CLI {label}",
                                                  CLIP_CLI_DIR)
        finally:
            restore()
            factory.save_clip_checkpoint = save
        step_s = float(np.median([w for _, w in steps[1:]]))
        losses = [loss for loss, _ in steps]
        log(f"train CLIP CLI {label}: losses {losses}; step wall (synchronised, median of "
            f"steps 2-{len(steps)}) {step_s:.4f} s, {32 / step_s:.1f} samples/s; peak memory "
            f"{peak:.2f} GiB; run {wall:.1f} s; launches {launched}")
        return losses, launched

    kernel, launched = run("f32", "--epochs", "2", keep_epoch0=True)
    resumed, _ = run("resumed", "--epochs", "2", "--clip_path", str(CLIP_CLI_DIR / "epoch0.ckpt"))
    plain, plain_launched = run("f32 plain", "--epochs", "1", plain=True)
    kernel16, launched16 = run("bf16", "--epochs", "1", "--bf16")
    plain16, plain_launched16 = run("bf16 plain", "--epochs", "1", "--bf16", plain=True)
    whole_state, _ = load_checkpoint(CLIP_CLI_DIR / "f32.ckpt")
    resumed_state, _ = load_checkpoint(CLIP_CLI_DIR / "resumed.ckpt")

    def flat(tree, prefix=""):
        items = {}
        for k, v in tree.items():
            items.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return items

    fa_, fb_ = flat(whole_state), flat(resumed_state)
    bitwise = fa_.keys() == fb_.keys() and all(
        np.array_equal(np.asarray(fa_[k]), np.asarray(fb_[k])) for k in fa_)
    f32_gap = max(abs(k - p) / abs(p) for k, p in zip(kernel, plain))
    bf16_gap = gap_ratio(kernel16, plain16, plain)
    per_epoch = CLIP_CLI_IMAGES // 32
    want = {n: depth * 2 * per_epoch for n in PACKED}
    want16 = {n: depth * per_epoch for n in PACKED}
    log(f"train CLIP CLI: float32 kernels vs plain relative {f32_gap:.3e} (tolerance 1e-5); "
        f"bf16 {bf16_gap:.3f} of the plain bf16-to-float32 gap (tolerance {BF16_GAP_FACTOR}); "
        f"resumed losses {resumed} vs the uninterrupted second epoch {kernel[per_epoch:]}, final "
        f"checkpoint bitwise {bitwise}; launches {launched} / {launched16} (expected {want} / "
        f"{want16}), plain runs {plain_launched} / {plain_launched16}")
    shutil.rmtree(CLIP_CLI_DIR, ignore_errors=True)
    log(f"train CLIP CLI: phase wall {time.perf_counter() - t_phase:.1f} s")
    problems = []
    if not all(np.isfinite(kernel + plain + kernel16 + plain16 + resumed)):
        problems.append("a loss is not finite")
    if len(kernel) != 2 * per_epoch or f32_gap > 1e-5 or bf16_gap > BF16_GAP_FACTOR:
        problems.append(f"kernels vs plain: {f32_gap}, {bf16_gap}")
    if resumed != kernel[per_epoch:] or not bitwise:
        problems.append(f"the resume is not the uninterrupted run: {resumed} {kernel}, "
                        f"checkpoint bitwise {bitwise}")
    if launched != want or launched16 != want16 or plain_launched or plain_launched16:
        problems.append(f"launches {launched} {launched16} {plain_launched} {plain_launched16}")
    if problems:
        raise AssertionError("train CLIP CLI: " + "; ".join(problems))
    return {"train_clip_cli": launched, "train_clip_cli_bf16": launched16}


PROFILE_ROWS = {
    "flash_fwd_tf32_kernel": ("flash_attention_fwd", "ms"),
    "flash_dq_tf32_kernel": ("flash_attention_dq", "ms"),
    "flash_dkdv_tf32_kernel": ("flash_attention_dkdv", "ms"),
    "flash_fwd_tc_kernel": ("flash_attention_fwd", "ms_bf16"),
    "flash_dq_tc_kernel": ("flash_attention_dq", "ms_bf16"),
    "flash_dkdv_tc_kernel": ("flash_attention_dkdv", "ms_bf16"),
    "bs_fwd_tf32_kernel": ("block_sparse_attention", "ms"),
    "bs_dq_tf32_kernel": ("block_sparse_dq", "ms"),
    "bs_dkdv_tf32_kernel": ("block_sparse_dkdv", "ms"),
    "bs_fwd_tc_kernel": ("block_sparse_attention", "ms_bf16"),
    "bs_dq_tc_kernel": ("block_sparse_dq", "ms_bf16"),
    "bs_dkdv_tc_kernel": ("block_sparse_dkdv", "ms_bf16"),
}


def profile_train(trainer, batch, steps: int = 3, label: str = "train profile",
                  kernel_rows=()) -> None:
    """Where a flagship train step's time goes: torch.profiler over a few
    steps after the counted run: wall and device-busy time per step,
    launches per step, the largest device-time kernels, the pair grid's
    and the tiled flash kernels' wherever they rank, and the tiled flash
    kernels' and the pair grid's ms per step together. With
    ``kernel_rows`` (the kernel phase's rows), each kernel of
    ``PROFILE_ROWS`` that ran: its profiled ms a step beside the kernel
    phase's ms a launch times its launches a step, a gap over 25% flagged
    (not failed; the pair grid's layers mix layouts that the kernel phase
    times apart)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    averages = prof.key_averages()
    log_device_profile(averages, label, "steps", "step", steps, wall_ms, 16,
                       watch=("::bs_", "flash_"))
    device = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    for what, marker in (("the tiled flash kernels", "flash_"),
                         ("the pair grid's kernels", "::bs_")):
        us = sum(e.self_device_time_total for e in device if marker in e.key)
        if us:
            log(f"{label}: {what} {us / 1e3 / steps:.3f} ms/step together")
    rows = {row["name"]: row for row in kernel_rows}
    for fn, (name, key) in PROFILE_ROWS.items():
        events = [e for e in device if fn in e.key]
        if not events or key not in rows.get(name, {}):
            continue
        profiled = sum(e.self_device_time_total for e in events) / 1e3 / steps
        per_step = sum(e.count for e in events) / steps
        timed = rows[name][key] * per_step
        gap = profiled / timed - 1
        log(f"{label}: {fn} profiled {profiled:.3f} ms/step over {per_step:.0f} launches; the "
            f"kernel phase's {rows[name][key]:.4f} ms x {per_step:.0f} = {timed:.3f} ms/step; "
            f"profiled / timed - 1 = {100 * gap:+.1f}%"
            + (" (a gap over 25%: the profile and the timer disagree)" if abs(gap) > 0.25
               else ""))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from dalle_pytorch_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in float32 to the end, split-K partials
    # too, as the TPU's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"TF32 cuDNN {torch.backends.cudnn.allow_tf32}, bf16 reduced-precision reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    t0 = time.perf_counter()
    ptxas = start_ptxas_report(PACKED + ("ragged_attention", "flash_attention",
                                         "block_sparse_attention", "decode_attention"))
    cuda_build.build()
    log(f"build: {sorted(cuda_build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s")
    log_ptxas_report(ptxas, ("_tc_kernel", "_tf32_kernel", "ragged_f32_kernel",
                             "decode_kernel"))
    log_sass_report(PACKED + ("flash_attention", "block_sparse_attention"))

    kernels = [*check_ragged_attention(), check_fused_qkv(), check_fused_qkv_bwd(),
               *check_block_sparse(), *check_flash_attention(), check_decode_attention()]
    release_memory()
    sparse_types = tuple(SPARSE_TYPES.split(","))
    for kv_quant, attn_types in ((None, None), ("int8", None), (None, sparse_types),
                                 ("int8", sparse_types)):
        check_path_against_plain(kv_quant, attn_types)
    check_preemption_on_card()
    check_split_engine_on_card()
    check_learned_pos_on_card()
    check_clip_against_plain()
    check_decode_against_plain()
    for variant in ("dense", "sparse", "tiled"):
        for dtype in (torch.float32, torch.bfloat16):
            check_train_against_plain(variant, dtype)
    # the one-block path: the only one that runs the single-block backward
    one_block_launches = check_train_against_plain("one_block")[0]
    one_block_bf16_launches = check_train_against_plain("one_block", torch.bfloat16)[0]
    for variant in ("learned_pos", "stable"):  # the packed kernels' no-rotary instances
        for dtype in (torch.float32, torch.bfloat16):
            check_train_against_plain(variant, dtype, steps=3)
    results, serve_launches, model, engine = serve_flagship()
    check_pixels(results)
    profile_iterations(model)
    int8_launches = serve_int8(model, results, engine)
    check_int8_logits(model)
    for kv_quant in ("int8", "int8", None):  # phase 7's bf16 profile came first
        profile_iterations(model, kv_quant=kv_quant)
    split_launches, split_mono_launches = serve_split(model, engine.postdecode.spec, results)
    profile_iterations(model, split=True)
    learned_model, learned_serve_launches = serve_learned_pos(engine.postdecode.spec)
    learned_generate_launches = generate_learned_pos(learned_model)
    # the staged engine and its pipeline refer to each other: only the
    # cyclic collector frees their pools before the next phase's peak
    del model, results, engine, learned_model
    release_memory()
    sparse_serve_launches = serve_sparse_int8()
    release_memory()
    reversible_serve_launches = serve_reversible()
    release_memory()
    prefix_spec_launches = serve_prefix_spec()
    release_memory()
    generate_cli_launches = generate_cli()
    release_memory()
    generate_launches = generate_flagship()
    release_memory()
    trainer, batch, train_launches = train_flagship()
    profile_train(trainer, batch)
    vae = trainer.vae
    del trainer
    release_memory()
    trainer, learned_train_launches = train_defaults(vae, batch)
    profile_train(trainer, batch, label="train learned_pos profile")
    del trainer
    release_memory()
    reversible_launches = train_reversible(vae, batch)
    release_memory()
    cli_launches = train_cli(vae)
    release_memory()
    cli_telemetry_launches = train_cli_telemetry(vae)
    release_memory()
    cli_ga_launches = train_cli_ga(vae)
    release_memory()
    trainer, bf16_launches = train_bf16(vae, batch)
    profile_train(trainer, batch, label="train bf16 profile")
    del trainer
    release_memory()
    trainer, sparse_launches = train_sparse(vae, batch)
    profile_train(trainer, batch, label="train sparse profile", kernel_rows=kernels)
    del trainer
    release_memory()
    trainer, sparse_bf16_launches = train_sparse(vae, batch, bf16=True)
    profile_train(trainer, batch, label="train sparse bf16 profile", kernel_rows=kernels)
    del trainer, vae
    release_memory()
    trainer, batch, launches_512 = train_512(batch[0])
    profile_train(trainer, batch, label="train 512 profile", kernel_rows=kernels)
    vae = trainer.vae
    del trainer
    release_memory()
    train_512_plain(vae, batch)
    release_memory()
    trainer, launches_512_bf16 = train_512_bf16(vae, batch)
    profile_train(trainer, batch, label="train 512 bf16 profile", kernel_rows=kernels)
    del trainer, vae
    release_memory()
    train_vae_cli()
    release_memory()
    clip_cli_launches = train_clip_cli()
    paths = (("serve", serve_launches), ("serve_int8", int8_launches),
             ("serve_split", split_launches), ("serve_split_monolithic", split_mono_launches),
             ("serve_sparse_int8", sparse_serve_launches), ("train", train_launches),
             ("train_bf16", bf16_launches), ("train_sparse", sparse_launches),
             ("train_sparse_bf16", sparse_bf16_launches), ("train_512", launches_512),
             ("train_512_bf16", launches_512_bf16), ("train_one_block", one_block_launches),
             ("train_one_block_bf16", one_block_bf16_launches),
             ("train_learned_pos", learned_train_launches), ("train_cli", cli_launches),
             ("train_cli_telemetry", cli_telemetry_launches), ("train_cli_ga", cli_ga_launches),
             ("generate_cli", generate_cli_launches),
             ("serve_learned_pos", learned_serve_launches),
             ("generate_learned_pos", learned_generate_launches), *generate_launches.items(),
             *reversible_launches.items(), *reversible_serve_launches.items(),
             *prefix_spec_launches.items(), *clip_cli_launches.items())
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


def alternate(calls: dict, use, rounds: int, iters: int) -> dict:
    """{(key, src): [ms, ...]} of each call of ``calls`` timed (cold L2)
    under ``use("other")`` and ``use("this")`` in the order other, this,
    this, other, ``rounds`` times; ``use("this")`` at the end."""
    ms = {(key, src): [] for key in calls for src in ("this", "other")}
    for _ in range(rounds):
        for src in ("other", "this", "this", "other"):
            use(src)
            for key, fn in calls.items():
                ms[key, src].append(cuda_time_ms(fn, iters=iters))
    use("this")
    return ms


def pair_text(this, other, names=("other", "this")) -> str:
    """Two trees' (or variants', ``names`` other first) alternating times
    as a log phrase, with whether this one is faster in every adjacent
    pair of the order other, this, this, other."""
    o_name, t_name = names
    return (f"{o_name} " + ", ".join(f"{t:.4f}" for t in other) + f" (mean "
            f"{np.mean(other):.4f} ms); {t_name} " + ", ".join(f"{t:.4f}" for t in this)
            + f" (mean {np.mean(this):.4f} ms); {t_name} / {o_name} "
            f"{np.mean(this) / np.mean(other):.4f}; {t_name} faster in every pair "
            f"{all(t < o for t, o in zip(this, other))}")


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

    calls = {key: packed_case(*key) for key in PACKED_COMPARE_CASES}
    ms = alternate({key: fn for key, (fn, *_) in calls.items()}, use, rounds, iters=20)
    for key, (_, sdpa, bounds) in calls.items():
        case, dtype, direction = key
        log(f"compare packed {direction} {case} {dtype}, cold L2: "
            f"{pair_text(ms[key, 'this'], ms[key, 'other'])}; sdpa "
            f"{cuda_time_ms(sdpa, iters=20):.4f} ms; {bound_text(bounds)}")


def build_other_library(name: str, source: Path, label: str, signatures=None) -> ctypes.CDLL:
    """``source`` (another commit's ``<name>.cu``) built under another
    library name with the headers beside it (another commit's csrc: its
    own), or this checkout's csrc headers where it has none, and bound
    with ``signatures`` (default ``cuda_build.SIGNATURES[name]``)."""
    from dalle_pytorch_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "compare" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{name}-{label}.so"
    # a quoted include looks beside the source first, then in -I
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                           "-o", str(lib_path), str(source)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in (signatures or cuda_build.SIGNATURES[name]).items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    return lib


def compare_tiled_sources(other_dir: str, rounds: int = 2) -> None:
    """The tiled flash kernels of this checkout against
    ``flash_attention.cu`` of ``other_dir`` (another commit's csrc, built
    by ``build_other_library``), in one process with one timer (cold L2).
    First, at ``testing.flash_inputs``' "train", "axial_col" and
    "one_block" cases, each tree's forward held against the plain version
    (float32: o and lse within ``testing.FLASH_F32_ATOL``; bfloat16: the
    row metric and lse within ``testing.FLASH_BF16_ROW_REL``; rows with no
    allowed key exactly 0 with lse -1e30) and its single-block backward on
    the plain forward's o and lse (float32: each of dq, dk, dv within
    ``testing.BWD_F32_REL``; bfloat16: the floored row metric within
    ``testing.BWD_BF16_ROW_REL``; dead rows exactly 0), with max |this -
    other| and whether each is bitwise the other tree's printed; this
    tree's bfloat16 single-block backward must be bitwise its own dq +
    dk/dv chain. The dq, delta, dk and dv of both types must be bitwise
    equal across the trees. Then the forward, dq and dk/dv of both types
    at the 512 px training shape (``flash_inputs("train")``, seed 1) and
    the single-block backward at ``flash_inputs("one_block")`` (both
    types) and ``"one_block_d32"`` (bfloat16) timed in the order other,
    this, this, other, ``rounds`` times, with sdpa forward / backward in
    the same type and the bounds beside; raises on a failed check."""
    from dalle_pytorch_tpu_torch.ops import cuda_build
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.testing import (
        BWD_BF16_ROW_REL, BWD_F32_REL, FLASH_BF16_ROW_REL, FLASH_F32_ATOL, flash_bwd_errors,
        flash_fwd_errors, flash_inputs)

    name = "flash_attention"
    libs = {"this": cuda_build.load_library(name),
            "other": build_other_library(name, Path(other_dir) / f"{name}.cu", "tiled_other")}

    def use(src: str) -> None:  # the wrappers load their library through this cache
        cuda_build._LOADED[name] = libs[src]

    for case in ("train", "axial_col", "one_block"):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, opts = flash_inputs(case, dtype, "cuda")
            po, plse = fa.reference_flash_attention(q, k, v, **opts)
            outs = {}
            for src in libs:
                use(src)
                dq, delta = fa.flash_attention_dq(q, k, v, po, plse, do, **opts)
                outs[src] = (*fa.flash_attention_fwd(q, k, v, **opts), dq, delta,
                             *fa.flash_attention_dkdv(q, k, v, do, plse, delta, **opts),
                             *fa.flash_attention_bwd_fused(q, k, v, po, plse, do, **opts))
            use("this")
            torch.cuda.synchronize()
            pairs = list(zip(outs["this"], outs["other"]))
            same = [torch.equal(a, b) for a, b in pairs]
            diff = [(a.float() - b.float()).abs().max().item() for a, b in pairs]
            plain = fa.reference_flash_attention_bwd(q, k, v, po, plse, do, **opts)
            label = f"compare tiled {case} {dtype}"
            log(f"{label}: dq, delta, dk, dv bitwise equal to the other tree's: {same[2:6]}; o, "
                f"lse {same[:2]}, single-block dq, dk, dv {same[6:]}")
            if not all(same[2:6]):
                raise AssertionError(f"{label}: dq or dk/dv outputs differ from the other tree's")
            bf16 = dtype == torch.bfloat16
            ok = True
            for src, (o, lse, _, _, dk, dv, fdq, fdk, fdv) in outs.items():
                err, row_rel, lse_err, dead_exact = flash_fwd_errors(o, lse, po, plse, **opts)
                rel, grad_row_rel, zeros_exact = flash_bwd_errors((fdq, fdk, fdv), plain, **opts)
                chain = [torch.equal(a, b) for a, b in zip((fdq, fdk, fdv), (outs[src][2], dk, dv))]
                if bf16:
                    ok &= (row_rel <= FLASH_BF16_ROW_REL and lse_err <= FLASH_BF16_ROW_REL
                           and grad_row_rel <= BWD_BF16_ROW_REL and dead_exact and zeros_exact
                           and (src != "this" or all(chain)))
                    log(f"{label}, {src}: forward row {row_rel:.3e}, lse {lse_err:.3e} "
                        f"(tolerance {FLASH_BF16_ROW_REL:.0e} each), dead rows exactly 0 "
                        f"{dead_exact}; single-block floored row {grad_row_rel:.3e} (tolerance "
                        f"{BWD_BF16_ROW_REL:.0e}), dead rows exactly 0 {zeros_exact}, bitwise "
                        f"the tree's dq + dk/dv chain {chain}")
                else:
                    ok &= (err <= FLASH_F32_ATOL and dead_exact and rel <= BWD_F32_REL
                           and zeros_exact)
                    log(f"{label}, {src}: forward max abs (o, lse) {err:.3e} (tolerance "
                        f"{FLASH_F32_ATOL:.0e}), dead rows exactly 0 {dead_exact}; single-block "
                        f"relative L2 {rel:.3e} (tolerance {BWD_F32_REL:.0e}), dead rows exactly "
                        f"0 {zeros_exact}")
            log(f"{label}: max |this - other| o {diff[0]:.3e}, lse {diff[1]:.3e}, single-block "
                f"dq {diff[6]:.3e}, dk {diff[7]:.3e}, dv {diff[8]:.3e}")
            if not ok:
                raise AssertionError(f"{label}: a tree's forward or single-block backward misses "
                                     "the plain version")
            del outs, pairs, plain

    calls, about = {}, {}  # about: (type, shape, sdpa phrase, bounds) of each call
    for dtype in (torch.float32, torch.bfloat16):
        type_name = str(dtype).split(".")[1]
        q, k, v, do, opts = flash_inputs("train", dtype, "cuda", seed=1)
        o, lse = fa.flash_attention_fwd(q, k, v, **opts)
        _, delta = fa.flash_attention_dq(q, k, v, o, lse, do, **opts)
        sdpa_ms = cuda_time_ms(lambda q=q, k=k, v=v, opts=opts:
                               torch.nn.functional.scaled_dot_product_attention(
                                   q, k, v, **sdpa_flash_kw(q, opts)), iters=10)
        sdpa_bwd_ms = cuda_time_ms(sdpa_flash_backward(q, k, v, do, opts), iters=10)
        bounds = flash_bounds(q, opts)
        fns = {"flash_attention_fwd": lambda q=q, k=k, v=v, opts=opts:
               fa.flash_attention_fwd(q, k, v, **opts),
               "flash_attention_dq": lambda q=q, k=k, v=v, o=o, lse=lse, do=do, opts=opts:
               fa.flash_attention_dq(q, k, v, o, lse, do, **opts),
               "flash_attention_dkdv": lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta,
               opts=opts: fa.flash_attention_dkdv(q, k, v, do, lse, delta, **opts)}
        for key, fn in fns.items():
            sdpa = (f"sdpa forward {sdpa_ms:.4f}" if key == "flash_attention_fwd"
                    else f"sdpa backward {sdpa_bwd_ms:.4f}")
            calls[f"{key} {type_name}"] = fn
            about[f"{key} {type_name}"] = (type_name, "b 4, 16 x 64, n 4352", sdpa, bounds[key])
    key = "flash_attention_bwd_fused"
    for case, dtype, shape in (("one_block", torch.float32, "b 2, 3 x 64, n 1280"),
                               ("one_block", torch.bfloat16, "b 2, 3 x 64, n 1280"),
                               ("one_block_d32", torch.bfloat16, "b 4, 16 x 32, n 1280")):
        type_name = str(dtype).split(".")[1]
        q, k, v, do, opts = flash_inputs(case, dtype, "cuda", seed=1)
        o, lse = fa.flash_attention_fwd(q, k, v, **opts)
        label = f"{key} {type_name}" + (" d32" if case.endswith("d32") else "")
        calls[label] = lambda q=q, k=k, v=v, o=o, lse=lse, do=do, opts=opts: (
            fa.flash_attention_bwd_fused(q, k, v, o, lse, do, **opts))
        sdpa_bwd_ms = cuda_time_ms(sdpa_flash_backward(q, k, v, do, opts), iters=10)
        about[label] = (type_name, shape, f"sdpa backward {sdpa_bwd_ms:.4f}",
                        flash_bounds(q, opts)[key])
    ms = alternate(calls, use, rounds, iters=10)
    for key in calls:
        type_name, shape, sdpa, bound = about[key]
        log(f"compare {key.split()[0]} {type_name} ({shape}, causal), cold L2: "
            f"{pair_text(ms[key, 'this'], ms[key, 'other'])}; {sdpa} ms; {bound_text(bound)}")


def compare_sparse_sources(other_dir: str, rounds: int = 2) -> None:
    """The pair-grid kernels of this checkout against
    ``block_sparse_attention.cu`` of ``other_dir`` (another commit's csrc,
    built by ``build_other_library``; a source whose forward and dq take
    the q-major pair table and offsets gets them on the card, in front of
    the class map, or in its and the tile order's place where it takes
    none; one whose dk/dv takes no k-major class map is bound without
    it), in one process with one timer (cold L2). First, on every ``testing.bs_inputs`` case, each
    kernel on the plain forward's o and lse and the plain delta: each
    tree's o and lse held against the plain forward (float32:
    ``testing.BS_F32_ATOL``; bfloat16: the row metric and lse within
    ``testing.BS_BF16_ROW_REL``; rows with no allowed key exactly 0 with
    lse -1e30), its dq against the plain dq and, in bfloat16, its dk and
    dv against the plain ones (float32 ``testing.BWD_F32_REL``, bfloat16
    the floored row metric within ``testing.BWD_BF16_ROW_REL``; dead rows
    and keys exactly 0), its delta against the plain delta (within 1e-4 of
    its largest entry), with max |this - other| printed; every float32
    output and the bfloat16 dq, delta, dk and dv must be bitwise equal
    across the trees. Then at the flagship training shape with the
    axial_row and conv_like layouts (``bs_inputs``, seed 1): the forward,
    dq and dk/dv of both types timed in the order other, this, this,
    other, ``rounds`` times, with sdpa forward / backward with the boolean
    mask in the same type (each backend that takes one, by name) and the
    bounds beside; and this tree's forward and dq of both types with the
    layout's tile order (longest row first) against launch order,
    alternated the same way. Last, the sparse bf16 path check
    (``check_train_against_plain("sparse", torch.bfloat16, seed)``) on
    both trees at seeds 7, 17 and 27, with the card settings of ``main``,
    its gap ratios printed side by side. Raises on a failed check."""
    import types

    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
    from dalle_pytorch_tpu_torch.ops import cuda_build

    name = "block_sparse_attention"
    source = Path(other_dir) / f"{name}.cu"
    text = source.read_text()
    signatures = dict(cuda_build.SIGNATURES[name])
    fwd_decl = text[text.index("int block_sparse_attention_fwd("):]
    fwd_decl = fwd_decl[:fwd_decl.index("{")]
    # {entry point: (where the class map sits in the pointers the wrappers
    # pass, the mask's place there, whether the other tree takes the map
    # and tile order)}: a forward and dq that take the q-major table and
    # offsets get them in front of the map, in place of the map and tile
    # order where they take none
    table_at = {}
    if "const void* table" in fwd_decl:
        maps = "const void* halves" in fwd_decl
        table_at = {"block_sparse_attention_fwd": (5, 4, maps),
                    "block_sparse_attention_dq": (8, 7, maps)}
    for fn, (_, _, maps) in table_at.items():
        argtypes, restype = signatures[fn]
        signatures[fn] = ([ctypes.c_void_p] * (2 * maps) + argtypes, restype)
    cut = {}  # {entry point: (where the map it does not take sits, how many)}
    if "const void* columns" not in text:
        cut["block_sparse_attention_dkdv"] = (10, 1)
    for fn, (at, count) in cut.items():
        argtypes, restype = signatures[fn]
        signatures[fn] = (argtypes[:at] + argtypes[at + count:], restype)
    other = build_other_library(name, source, "sparse_other", signatures)
    q_major = {}  # the mask's address: (layout, q-major table, offsets) on the card
    placed_by = bs.device_layout

    def device_layout(layout, device):  # the wrappers' layouts, with their q-major tables
        dl = placed_by(layout, device)
        if table_at and dl.mask.data_ptr() not in q_major:
            offsets = np.searchsorted(layout.fwd_table[0], np.arange(layout.nq + 1))
            q_major[dl.mask.data_ptr()] = (layout, *(
                torch.from_numpy(a.astype(np.int32)).to(device)
                for a in (layout.fwd_table, offsets)))
        return dl

    def with_table(f, at, mask_at, maps):
        def call(*args):
            _, table, offsets = q_major[args[mask_at].value]
            rest = args[at:] if maps else args[at + 2:]
            return f(*args[:at], ctypes.c_void_p(table.data_ptr()),
                     ctypes.c_void_p(offsets.data_ptr()), *rest)
        return call

    def without(f, at, count):
        return lambda *args: f(*args[:at], *args[at + count:])

    if table_at or cut:
        other = types.SimpleNamespace(**{
            fn: (with_table(getattr(other, fn), *table_at[fn]) if fn in table_at
                 else without(getattr(other, fn), *cut[fn]) if fn in cut
                 else getattr(other, fn))
            for fn in signatures})
    libs = {"this": cuda_build.load_library(name), "other": other}

    def use(src: str) -> None:  # the wrappers load their library through this cache
        cuda_build._LOADED[name] = libs[src]

    bs.device_layout = device_layout
    try:
        compare_sparse_trees(use, rounds)
    finally:
        bs.device_layout = placed_by


def compare_sparse_trees(use, rounds: int) -> None:
    """``compare_sparse_sources``' checks and timings, with ``use(src)``
    choosing the tree ("this" or "other") that the wrappers launch."""
    from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
    from dalle_pytorch_tpu_torch.testing import (
        BS_BF16_ROW_REL, BS_F32_ATOL, BWD_BF16_ROW_REL, BWD_F32_REL, bs_bwd_errors, bs_fwd_errors,
        bs_inputs)

    libs = ("this", "other")

    for case in ("axial_row", "conv_like", "d32", "d64", "d128", "synthetic"):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, layout, km = bs_inputs(case, dtype, "cuda")
            po, plse = bs.reference_block_sparse(q, k, v, layout, km)
            pdq, pdelta = bs.reference_block_sparse_dq(q, k, v, po, plse, do, layout, km)
            pdk, pdv = bs.reference_block_sparse_dkdv(q, k, v, do, plse, pdelta, layout, km)
            outs = {}
            for src in libs:
                use(src)
                outs[src] = (*bs.block_sparse_attention(q, k, v, layout, km),
                             *bs.block_sparse_dq(q, k, v, po, plse, do, layout, km),
                             *bs.block_sparse_dkdv(q, k, v, do, plse, pdelta, layout, km))
            use("this")
            torch.cuda.synchronize()
            pairs = list(zip(outs["this"], outs["other"]))
            same = [torch.equal(a, b) for a, b in pairs]
            label = f"compare sparse {case} {dtype}"
            bf16 = dtype == torch.bfloat16
            # bitwise across the trees: the kernels this comparison holds
            # unchanged (every float32 one; bf16 dq, delta, dk, dv)
            held = slice(2, 6) if bf16 else slice(0, 6)
            log(f"{label}: o, lse, dq, delta, dk, dv bitwise equal to the other tree's: {same}")
            if not all(same[held]):
                raise AssertionError(f"{label}: {'dq, delta, dk, dv' if bf16 else 'outputs'} "
                                     "differ from the other tree's")
            ok = True
            for src, (o, lse, dq, delta, dk, dv) in outs.items():
                err, row, lse_err, dead_exact = bs_fwd_errors(o, lse, po, plse, layout, km)
                grads = (dq, dk, dv) if bf16 else (dq, pdk, pdv)
                rel, grad_row, zeros_exact = bs_bwd_errors(grads, (pdq, pdk, pdv), layout, km)
                delta_err = (delta - pdelta).abs().max().item()
                delta_ok = delta_err <= 1e-4 * pdelta.abs().max().item()
                if bf16:
                    ok &= (row <= BS_BF16_ROW_REL and lse_err <= BS_BF16_ROW_REL and dead_exact
                           and grad_row <= BWD_BF16_ROW_REL and zeros_exact and delta_ok)
                    log(f"{label}, {src}: forward row {row:.3e}, lse {lse_err:.3e} (tolerance "
                        f"{BS_BF16_ROW_REL:.0e} each), dead rows exactly 0 {dead_exact}; dq, dk, "
                        f"dv floored row {grad_row:.3e}, relative L2 {rel:.3e} (tolerance "
                        f"{BWD_BF16_ROW_REL:.0e} floored row), dead rows and keys exactly 0 "
                        f"{zeros_exact}; delta max abs {delta_err:.3e} (within 1e-4 of its "
                        f"largest {delta_ok})")
                else:
                    ok &= (err <= BS_F32_ATOL and dead_exact and rel <= BWD_F32_REL
                           and zeros_exact and delta_ok)
                    log(f"{label}, {src}: forward max abs (o, lse) {err:.3e} (tolerance "
                        f"{BS_F32_ATOL:.0e}), dead rows exactly 0 {dead_exact}; dq relative L2 "
                        f"{rel:.3e} (tolerance {BWD_F32_REL:.0e}), dead rows exactly 0 "
                        f"{zeros_exact}; delta max abs {delta_err:.3e} (within 1e-4 of its "
                        f"largest {delta_ok})")
            diff = [(a.float() - b.float()).abs().max().item() for a, b in pairs]
            log(f"{label}: max |this - other| " + ", ".join(
                f"{what} {d:.3e}" for what, d in zip(("o", "lse", "dq", "delta", "dk", "dv"),
                                                     diff)))
            if not ok:
                raise AssertionError(f"{label}: a tree's kernels miss the plain versions")
            del outs, pairs

    for case in ("axial_row", "conv_like"):
        calls, about = {}, {}  # about: (sdpa phrase, bounds) of each call
        rows = {}  # the forward and dq of each type, timed by tile order below
        placed = []  # (layout, its device operands) of each type
        for dtype in (torch.float32, torch.bfloat16):
            type_name = str(dtype).split(".")[1]
            q, k, v, do, layout, _ = bs_inputs(case, dtype, "cuda", seed=1)
            placed.append((layout, bs.device_layout(layout, q.device)))
            o, lse = bs.block_sparse_attention(q, k, v, layout)
            _, delta = bs.block_sparse_dq(q, k, v, o, lse, do, layout)
            fns = {"block_sparse_attention": lambda q=q, k=k, v=v, layout=layout:
                   bs.block_sparse_attention(q, k, v, layout),
                   "block_sparse_dq": lambda q=q, k=k, v=v, o=o, lse=lse, do=do, layout=layout:
                   bs.block_sparse_dq(q, k, v, o, lse, do, layout),
                   "block_sparse_dkdv": lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                   layout=layout: bs.block_sparse_dkdv(q, k, v, do, lse, delta, layout)}
            times = sdpa_mask_times(q, k, v, bs.may_attend(layout, layout.n, q.device), do)
            bounds = bs_bounds(q, layout, None)
            for key, fn in fns.items():
                way = "forward" if key == "block_sparse_attention" else "backward"
                calls[f"{key} {type_name}"] = fn
                about[f"{key} {type_name}"] = (
                    f"{type_name} sdpa {way} with the mask {sdpa_fastest(times[way]):.4f} ms "
                    f"({sdpa_text(times[way])})", bounds[key])
            for key in ("block_sparse_attention", "block_sparse_dq"):
                rows[f"{key} {type_name}"] = fns[key]
        ms = alternate(calls, use, rounds, iters=20)
        shape = f"b 4, 16 x 64, n 1280, {layout.n_pairs} block pairs"
        for key in calls:
            sdpa, bound = about[key]
            log(f"compare {key} {case} ({shape}), cold L2: "
                f"{pair_text(ms[key, 'this'], ms[key, 'other'])}; {sdpa}; {bound_text(bound)}")

        def order(src: str) -> None:  # "this": the tile order, "other": launch order
            for lay, dl in placed:
                lay._on_device[q.device] = dl if src == "this" else dl._replace(order=None)

        ms = alternate(rows, order, rounds, iters=20)
        for key in rows:
            log(f"compare {key} {case} ({shape}), longest row first against launch order, "
                f"cold L2: "
                f"{pair_text(ms[key, 'this'], ms[key, 'other'], ('launch order', 'longest first'))}")

    # the sparse bf16 path check on both trees and three seeds, with main's
    # settings: its gap ratios' spread
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gaps = {src: [] for src in libs}
    try:
        for seed in (7, 17, 27):
            for src in libs:
                use(src)
                gaps[src].append(check_train_against_plain("sparse", torch.bfloat16, seed)[1])
    finally:
        use("this")
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags
    log("compare sparse bf16 path check, seeds 7, 17, 27, (loss, worst gradient) gap ratios: "
        + "; ".join(f"{src} " + ", ".join(f"({a:.3f}, {b:.3f})" for a, b in gaps[src])
                    for src in libs))


def compare_decode_sources(other_dir: str, rounds: int = 2) -> None:
    """The fused decode kernel of this checkout against
    ``decode_attention.cu`` of ``other_dir`` (another commit's csrc,
    built by ``build_other_library``; a source whose entry point takes no
    split runs one block a head), in one process with one timer (cold
    L2), at the generate path's shape (16 heads of 64, L 1281, idx 768,
    rotary, no key mask) at b 1 and b 8: each tree's out held against the
    plain version (float32 and bf16, ``testing``'s tolerances), k_row and
    v_row bitwise equal across the trees, max |this - other| of out
    printed; then bf16 timed in the order other, this, this, other,
    ``rounds`` times, with this tree's S, sdpa and the bound beside;
    raises on a failed check."""
    from dalle_pytorch_tpu_torch.ops import cuda_build
    from dalle_pytorch_tpu_torch.ops import decode_attention as da
    from dalle_pytorch_tpu_torch.testing import decode_errors, decode_inputs, decode_ok

    name = "decode_attention"
    source = Path(other_dir) / f"{name}.cu"
    split_arg = "int splits" in source.read_text()
    argtypes, restype = cuda_build.SIGNATURES[name]["decode_attention_fwd"]
    if not split_arg:
        argtypes = argtypes[:15] + argtypes[16:]
    other = build_other_library(name, source, "decode_other",
                                {"decode_attention_fwd": (argtypes, restype)})

    def run_other(qkv, kc, vc, idx, cos, sin, km, heads):
        b = qkv.shape[0]
        L, hd = kc.shape[1:]
        d = hd // heads
        out = torch.empty((b, 1, hd), dtype=qkv.dtype, device=qkv.device)
        k_row, v_row = torch.empty_like(out), torch.empty_like(out)
        p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
        extra = (da.decode_splits(b * heads, idx),) if split_arg else ()
        err = other.decode_attention_fwd(
            *(p(t) for t in (qkv, kc, vc, cos, sin, km, out, k_row, v_row)), b, heads, d, L,
            idx, d**-0.5, *extra, 0 if qkv.dtype == torch.float32 else 1,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"the other tree's decode kernel failed: error {err}")
        return out, k_row, v_row

    L, h, idx = 1281, 16, 768
    for b in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            qkv, kc, vc, cos, sin, _ = decode_inputs(b, L, h, 64, idx, dtype, "cuda", seed=1)
            args = (qkv, kc, vc, idx, cos, sin, None)
            outs = {"this": da.fused_decode_attention(*args, heads=h),
                    "other": run_other(*args, h)}
            plain = da.reference_fused_decode(*args, h)
            torch.cuda.synchronize()
            label = f"compare decode b {b} {dtype}"
            ok = True
            for src, got in outs.items():
                err, rel, rows_equal, dead_zero = decode_errors(got, plain, None, idx)
                ok &= decode_ok(dtype, err, rel, rows_equal, dead_zero)
                log(f"{label}, {src}: out max abs {err:.3e}, row-relative {rel:.3e}, k/v rows "
                    f"bitwise the plain version's {rows_equal}")
            rows_same = all(torch.equal(a, c) for a, c in zip(outs["this"][1:], outs["other"][1:]))
            diff = (outs["this"][0].float() - outs["other"][0].float()).abs().max()
            log(f"{label}: k_row, v_row bitwise equal across the trees {rows_same}; max |this - "
                f"other| out {diff:.3e}")
            if not (ok and rows_same):
                raise AssertionError(f"{label}: a tree misses the plain version, or rows differ")

    for b in (1, 8):
        qkv, kc, vc, cos, sin, _ = decode_inputs(b, L, h, 64, idx, torch.bfloat16, "cuda", seed=1)
        args = (qkv, kc, vc, idx, cos, sin, None)
        fns = {"this": lambda: da.fused_decode_attention(*args, heads=h),
               "other": lambda: run_other(*args, h)}
        ms = {"this": [], "other": []}
        for _ in range(rounds):
            for src in ("other", "this", "this", "other"):
                ms[src].append(cuda_time_ms(fns[src]))
        q = qkv[..., :h * 64].view(b, 1, h, 64).transpose(1, 2)
        kv = [t.view(b, L, h, 64)[:, :idx + 1].transpose(1, 2) for t in (kc, vc)]
        sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, *kv))
        bound_ms, bound_by = decode_bound(b, L, h, 64, idx, torch.bfloat16)
        this, oth = ms["this"], ms["other"]
        log(f"compare fused_decode_attention bf16 (b {b}, 16 x 64, idx {idx}, L {L}, rotary), "
            f"cold L2: other " + ", ".join(f"{t:.4f}" for t in oth) + f" (mean "
            f"{np.mean(oth):.4f} ms); this at S {da.decode_splits(b * h, idx)} " + ", ".join(
                f"{t:.4f}" for t in this) + f" (mean {np.mean(this):.4f} ms); this / other "
            f"{np.mean(this) / np.mean(oth):.4f}; this faster in every pair "
            f"{all(t < o for t, o in zip(this, oth))}; sdpa {sdpa_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by})")


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
    runs = {"a": dict(fused_decode=True, window_seg=0), "b": dict(fused_decode=False)}
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


def compare_serve(pairs: int = 2, window: int = 64) -> None:
    """The split engine against the fused one at steady decode: the serve
    phases' flagship (bf16, ``SERVE_MODEL``), 8 of their requests of 1024 tokens
    at max_batch 8 and chunks of 16 through a fresh engine of each path,
    stepped until every slot decodes, then ``window`` decode-only
    iterations timed by the host clock, in ``pairs`` pairs alternating
    split, fused, fused, split, ...; then torch.profiler over 15 more
    iterations of each. Prints every run's ms an iteration, each pair's
    ratio split / fused, and each profile's wall, busy share, launches
    an iteration and top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig

    model = DALLE(**SERVE_MODEL, device="cuda", dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    requests = serve_requests(MAX_BATCH, MAX_NEW)

    def steady(fused: bool):
        engine = Engine(model, EngineConfig(max_batch=MAX_BATCH, prefill_chunk=CHUNK,
                                            fused_iteration=fused), device="cuda")
        for request in requests:
            assert engine.submit(request) is None
        while not all(s is not None and s.phase == "decode" for s in engine.slots):
            engine.step()
        for _ in range(4):
            engine.step()
        torch.cuda.synchronize()
        return engine

    ms = {False: [], True: []}
    for p in range(pairs):
        for fused in ((False, True) if p % 2 == 0 else (True, False)):
            engine = steady(fused)
            t0 = time.perf_counter()
            for _ in range(window):
                engine.step()
            torch.cuda.synchronize()
            ms[fused].append(1e3 * (time.perf_counter() - t0) / window)
    ratios = [s / f for s, f in zip(ms[False], ms[True])]
    log(f"compare serve, {window} decode-only iterations of 8 rows, ms an iteration: split "
        + ", ".join(f"{t:.3f}" for t in ms[False]) + "; fused "
        + ", ".join(f"{t:.3f}" for t in ms[True]) + "; pair ratios split / fused "
        + ", ".join(f"{r:.4f}" for r in ratios))
    for fused in (False, True):
        engine = steady(fused)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(15):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 15
        log_device_profile(prof.key_averages(), "compare serve " + ("fused" if fused else "split"),
                           "decode-only iterations", "iteration", 15, wall_ms, 6,
                           watch=("ragged",))


def load_other_port(root: Path, alias: str):
    """The port package of another checkout (``root``) imported under
    ``alias`` (the package imports itself relatively only), its kernels
    built into this checkout's ``build/`` (a library's name is the hash
    of its sources, so an identical source is not built twice)."""
    import importlib
    import importlib.util

    pkg = Path(root) / "dalle_pytorch_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    from dalle_pytorch_tpu_torch.ops import cuda_build

    importlib.import_module(f"{alias}.ops.cuda_build").BUILD_DIR = cuda_build.BUILD_DIR
    return module


def compare_serve_sources(other: str, rounds: int = 2) -> None:
    """The serving engine of this checkout against another's (``other``:
    a checkout's root, its port package loaded by ``load_other_port``),
    to time a change in ``serving/`` or ``utils/``: the serve phases'
    flagship (bf16, ``SERVE_MODEL``) with their VAE and CLIP stages, each
    tree's own modules on the same seeded weights, a fresh engine a run,
    in the order other, this, this, other, ``rounds`` times, at two
    configurations: phase 5's ("fused": ``N_REQUESTS`` requests, the fused
    iteration) and phase 5e's ("split": the first ``SPLIT_REQUESTS``,
    the split path), both at max_batch 8 and chunks of 16. Every run's
    tokens bitwise the first's of its configuration. Prints each run's
    wall, tokens/s, TTFT (median and largest) and stage seconds."""
    import importlib

    trees = {"this": "dalle_pytorch_tpu_torch",
             "other": load_other_port(Path(other), "other_torch_port").__name__}
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    built = {}
    for label, pkg in trees.items():
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        dalle, vae, clip = (mod("models.dalle").DALLE, mod("models.vae").DiscreteVAE,
                            mod("models.clip").CLIP)
        built[label] = (dalle(**SERVE_MODEL, **bf16).init_weights(gen(0)),
                        vae(**FLAGSHIP_VAE, **bf16).init_weights(gen(1)),
                        clip(**FLAGSHIP_CLIP, **bf16).init_weights(gen(2)),
                        mod("serving.postdecode"), mod("serving.engine"),
                        mod("serving.types").Request)
    configs = {"fused": (N_REQUESTS, True), "split": (SPLIT_REQUESTS, False)}
    for name, (n, fused) in configs.items():
        first, rows = None, []
        for _ in range(rounds):
            for label in ("other", "this", "this", "other"):
                model, vae, clip, post, engine_mod, request = built[label]
                stages = post.StageSpec(vae, clip, config=post.StageConfig(
                    batch=STAGE_BATCH, queue_limit=n))
                engine = engine_mod.Engine(model, engine_mod.EngineConfig(
                    max_batch=MAX_BATCH, fused_iteration=fused, prefill_chunk=CHUNK),
                    device="cuda", stages=stages)
                for r in serve_requests(n, MAX_NEW):
                    assert engine.submit(request(r.request_id, r.prompt, r.max_new_tokens,
                                                 seed=r.seed)) is None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results = engine.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                tokens = {rid: r.tokens.tolist() for rid, r in results.items()}
                first = first or tokens
                ttft = [r.ttft_s * 1e3 for r in results.values()]
                stage_s = sum(engine.postdecode.seconds.values())
                rows.append((label, wall, float(np.median(ttft)), max(ttft), stage_s,
                             tokens == first))
        walls = {label: np.mean([w for lb, w, *_ in rows if lb == label])
                 for label in ("this", "other")}
        log(f"compare serve sources, {name} ({n} x {MAX_NEW} tokens, stages; {card_line()}): "
            + "; ".join(f"{label} {w:.2f} s ({n * MAX_NEW / w:.1f} tokens/s), TTFT median "
                        f"{m:.1f} ms, largest {x:.1f} ms, stages {st:.3f} s, tokens = first "
                        f"{same}" for label, w, m, x, st, same in rows)
            + f"; this / other {walls['this'] / walls['other']:.4f}")
        if not all(r[-1] for r in rows):
            raise AssertionError(f"compare serve sources, {name}: the trees' tokens differ")


def check_bf16_default_reduction() -> None:
    """The bf16 path checks (``check_train_against_plain(variant,
    torch.bfloat16)`` for "dense", "sparse" and "tiled") with cuBLAS's
    bf16 reduced-precision reduction at PyTorch's default, as a ``--bf16``
    trainer outside this script runs (``main`` sets it off): each
    variant's gap ratios printed; raises after all three if any exceeds
    ``testing.BF16_GAP_FACTOR``."""
    from dalle_pytorch_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("bf16 default reduction: bf16 reduced-precision reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction} (PyTorch's default)")
    cuda_build.build()
    failed = []
    for variant in ("dense", "sparse", "tiled"):
        try:
            check_train_against_plain(variant, torch.bfloat16)
        except AssertionError as err:
            failed.append(f"{variant}: {err}")
    if failed:
        raise AssertionError("bf16 path checks with the default reduction: " + "; ".join(failed))
    log("bf16 default reduction: every bf16 path check within its tolerance")


def compare_ga_step_sources(other: str, pairs: int = 2, micro: int = 6) -> None:
    """The micro-step of ``--ga_steps 2`` with both dropout rates 0.1 at
    the flagship widths (float32, batch 4, learned positions, the CLIP
    BPE vocabulary of 49,408 text tokens, 8192 image tokens at 32 x 32),
    this checkout's ``parallel/step.py`` against another's (``other``: a
    checkout's root) on the same DALLE, in ``pairs`` pairs alternating
    other, this, this, other; each run ``micro`` micro-steps from
    ``mini_step`` 0 on its own fresh optimizer state, each timed by the
    host clock from the dispatch to the loss read back (the trainer's
    verdict), as the trainer runs them: this checkout's step told whether
    each micro-step emits. Prints each run's emitting and other
    micro-steps' ms, the means and this / other."""
    import importlib.util

    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.ops import cuda_build
    from dalle_pytorch_tpu_torch.parallel import step as this_step
    from dalle_pytorch_tpu_torch.train_dalle import dalle_loss

    path = Path(other) / "dalle_pytorch_tpu_torch" / "parallel" / "step.py"
    spec = importlib.util.spec_from_file_location("other_parallel_step", path)
    other_step = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other_step  # the dataclasses look their module up
    spec.loader.exec_module(other_step)
    cuda_build.build(list(PACKED))
    model = DALLE(**{**FLAGSHIP, "num_text_tokens": 49408}, attn_dropout=0.1, ff_dropout=0.1,
                  rotary_emb=False, shift_tokens=False,
                  device="cuda").init_weights(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(17)
    batches = [{"text": torch.from_numpy(rng.randint(1, 49408, size=(TRAIN_BATCH, 256))).cuda(),
                "image": torch.from_numpy(rng.randint(0, 8192, size=(TRAIN_BATCH, 1024))).cuda()}
               for _ in range(micro)]
    versions = {}
    for label, mod in (("other", other_step), ("this", this_step)):
        versions[label] = [mod.make_train_step(dalle_loss, 0.5, ga_steps=2),
                           mod.create_train_state(model, ga_steps=2), label == "this"]

    def run(label):
        step, state, tell = versions[label]
        times = {True: [], False: []}
        for i in range(micro):
            emit = i % 2 == 1
            gen = torch.Generator(device="cuda").manual_seed(i)
            kw = {"emit": emit} if tell else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, model, batches[i], 3e-4, gen, **kw)
            loss = float(loss)
            times[emit].append(1e3 * (time.perf_counter() - t0))
            if not math.isfinite(loss):
                raise AssertionError(f"ga step {label}: micro-step {i} loss {loss}")
        torch.cuda.synchronize()
        versions[label][1] = state
        if int(state.opt_state.mini_step) != 0:
            raise AssertionError(f"ga step {label}: mini_step {int(state.opt_state.mini_step)}")
        return times

    n_params = sum(p.numel() for p in model.parameters())
    run("other"), run("this")  # warm-up
    ms = {"this": {True: [], False: []}, "other": {True: [], False: []}}
    for p in range(pairs):
        for label in (("other", "this", "this", "other") if p % 2 == 0
                      else ("this", "other", "other", "this")):
            times = run(label)
            for emit in (True, False):
                ms[label][emit].extend(times[emit])
    means = {label: {e: float(np.mean(ms[label][e])) for e in (True, False)} for label in ms}
    whole = {label: float(np.mean(ms[label][True] + ms[label][False])) for label in ms}
    for label in ("other", "this"):
        log(f"compare ga step {label} ({n_params:,} params, micro-steps of ga_steps 2, "
            f"dropout 0.1 / 0.1): emitting " + ", ".join(f"{t:.2f}" for t in ms[label][True])
            + f" ms (mean {means[label][True]:.2f}); the others " + ", ".join(
                f"{t:.2f}" for t in ms[label][False]) + f" ms (mean {means[label][False]:.2f}); "
            f"a micro-step {whole[label]:.2f} ms")
    log(f"compare ga step: this / other, emitting {means['this'][True] / means['other'][True]:.4f}"
        f", the others {means['this'][False] / means['other'][False]:.4f}, a micro-step "
        f"{whole['this'] / whole['other']:.4f}; {card_line()}")


def compare(argv) -> int:
    """``chip_smoke.py --ragged-source PATH``, ``--packed-source DIR``,
    ``--tiled-source DIR``, ``--sparse-source DIR``, ``--decode-source DIR``,
    ``--generate-pairs N``, ``--serve-pairs N``, ``--ga-step-source DIR``,
    ``--train-cli-ga``, ``--serve-prefix-spec``, ``--generate-cli``,
    ``--serve-source DIR`` and/or ``--bf16-default-reduction``: only the
    paired comparisons (and those phases), on one card."""
    import argparse

    parser = argparse.ArgumentParser(description=compare.__doc__)
    parser.add_argument("--ragged-source", action="append", default=[],
                        help="ragged_attention.cu of another commit or a variant (repeatable: "
                             "each is compared with this checkout's in turn)")
    parser.add_argument("--packed-source",
                        help="csrc directory of another commit (its fused_qkv_attention*.cu)")
    parser.add_argument("--tiled-source",
                        help="csrc directory of another commit (its flash_attention.cu)")
    parser.add_argument("--sparse-source",
                        help="csrc directory of another commit (its block_sparse_attention.cu)")
    parser.add_argument("--decode-source",
                        help="csrc directory of another commit (its decode_attention.cu)")
    parser.add_argument("--generate-pairs", type=int, default=0)
    parser.add_argument("--serve-pairs", type=int, default=0,
                        help="pairs of the split and the fused engine at steady decode")
    parser.add_argument("--ga-step-source",
                        help="root of another checkout (its parallel/step.py): the micro-step "
                             "of ga_steps 2 with dropout, paired with this checkout's")
    parser.add_argument("--train-cli-ga", action="store_true",
                        help="phase 12b alone (the train CLI's tar, tokenizer, dropout and "
                             "ga_steps run, with its same-size control) on a fresh VAE")
    parser.add_argument("--serve-prefix-spec", action="store_true",
                        help="phase 5i alone (the prefix cache and speculative decode through "
                             "the engine), after building the ragged kernel")
    parser.add_argument("--generate-cli", type=int, default=0, metavar="DEPTH",
                        help="phase 15 alone at DEPTH layers, telemetry off, on, on, off, "
                             "after building the ragged and packed kernels")
    parser.add_argument("--serve-source",
                        help="root of another checkout (its port package): phase 5's and 5e's "
                             "engines paired with this checkout's (other, this, this, other)")
    parser.add_argument("--bf16-default-reduction", action="store_true",
                        help="the bf16 path checks with cuBLAS's bf16 reduced-precision "
                             "reduction at PyTorch's default")
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
    if args.tiled_source:
        compare_tiled_sources(args.tiled_source)
    if args.sparse_source:
        compare_sparse_sources(args.sparse_source)
    if args.decode_source:
        compare_decode_sources(args.decode_source)
    if args.generate_pairs:
        compare_generate(args.generate_pairs)
    if args.serve_pairs:
        compare_serve(args.serve_pairs)
    if args.ga_step_source or args.train_cli_ga:
        torch.backends.cuda.matmul.allow_tf32 = False  # as main() runs the trainer
        torch.backends.cudnn.allow_tf32 = False
    if args.ga_step_source:
        compare_ga_step_sources(args.ga_step_source)
    if args.train_cli_ga:
        from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
        from dalle_pytorch_tpu_torch.ops import cuda_build

        cuda_build.build(list(PACKED))
        vae = DiscreteVAE(**FLAGSHIP_VAE, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(11))
        log(f"train CLI ga alone: launches {train_cli_ga(vae)}")
    if args.serve_prefix_spec:
        from dalle_pytorch_tpu_torch.ops import cuda_build

        cuda_build.build(["ragged_attention"])
        log(f"serve prefix and spec alone: launches {serve_prefix_spec()}")
    if args.generate_cli or args.serve_source:
        from dalle_pytorch_tpu_torch.ops import cuda_build

        cuda_build.build(["ragged_attention", "fused_qkv_attention"])
    if args.generate_cli:
        log(f"generate CLI alone: launches "
            f"{generate_cli(args.generate_cli, ('off', 'on', 'on', 'off'))}")
    if args.serve_source:
        compare_serve_sources(args.serve_source)
    if args.bf16_default_reduction:
        check_bf16_default_reduction()
    return 0


if __name__ == "__main__":
    sys.exit(compare(sys.argv[1:]) if len(sys.argv) > 1 else main())
