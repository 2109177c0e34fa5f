"""Host cost of the fused serving iteration with bf16 against int8 KV pages.

    python3 -m dalle_pytorch_tpu_torch.host_overhead            # one CUDA card
    python3 -m dalle_pytorch_tpu_torch.host_overhead --small --device cpu

The engine is host-bound (the card is busy a few percent of an
iteration), so what separates two page formats is the host's time to
issue an iteration. This measures it at the flagship (DALLE depth 12,
dim 1024, 16 heads of 64, 256 text + 32x32 image tokens, bf16 weights
from seed 0; ``--small`` a tiny model for a dry run) with both formats
in alternation inside one process (none, int8, int8, none), since the
host's speed drifts between and within runs. Each window is a fresh
engine (max_batch 8, prefill chunk 16) on 8 requests, warmed for 10
iterations, then timed over 30:

- ``iteration ms``: wall per ``Engine.step`` (the card synchronised at
  the window's end);
- ``fused_step ms``: the host time of ``DALLE.fused_step`` alone, the
  call's time to return (its kernels are queued, not awaited);
- ``gc``: passes of the cyclic garbage collector inside the window and
  their time (``gc.callbacks``);

then the same windows with the collector disabled, the append's pieces
timed alone (host time per call), and a cProfile of 20 iterations per
format with the functions ranked by their difference in own time.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import pstats
import time

import numpy as np
import torch

from .models.dalle import DALLE
from .ops import paged_kv
from .serving.engine import Engine, EngineConfig
from .serving.types import Request

FLAGSHIP = dict(dim=1024, depth=12, heads=16, dim_head=64, num_text_tokens=10000,
                text_seq_len=256, num_image_tokens=8192, image_fmap_size=32)
SMALL = dict(dim=64, depth=4, heads=2, dim_head=32, num_text_tokens=100,
             text_seq_len=32, num_image_tokens=64, image_fmap_size=8)
ORDER = ("none", "int8", "int8", "none")


class _GcClock:
    """Counts the collector's passes and their wall time while active."""

    def __init__(self):
        self.passes, self.seconds, self._t0 = 0, 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.passes += 1
            self.seconds += time.perf_counter() - self._t0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _engine(model, kv_quant, cfg, device):
    engine = Engine(model, EngineConfig(max_batch=8, fused_iteration=True, prefill_chunk=16,
                                        kv_quant=kv_quant),
                    device=device)
    prompts = np.random.RandomState(1).randint(
        1, cfg["num_text_tokens"], size=(8, cfg["text_seq_len"]))
    for i in range(8):
        engine.submit(Request(f"p{i}", prompts[i], cfg["image_fmap_size"] ** 2, seed=100 + i))
    return engine


def window(model, kv_quant, cfg, device, warmup=10, iters=30, collect=True) -> dict:
    """One timed window of a fresh engine (see the module docstring)."""
    engine = _engine(model, kv_quant, cfg, device)
    for _ in range(warmup):
        engine.step()
    _sync(device)
    inner, spent = model.fused_step, [0.0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        spent[0] += time.perf_counter() - t0
        return out

    clock = _GcClock()
    gc.collect()
    if not collect:
        gc.disable()
    gc.callbacks.append(clock)
    model.fused_step = timed
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.step()
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        del model.fused_step
        gc.callbacks.remove(clock)
        gc.enable()
    return {"iteration_ms": wall * 1e3 / iters, "fused_step_ms": spent[0] * 1e3 / iters,
            "gc_passes": clock.passes, "gc_ms": clock.seconds * 1e3 / iters}


def host_ms(fn, device, n: int = 200) -> float:
    """Mean host time of one call of ``fn`` with an idle launch queue."""
    total = 0.0
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    _sync(device)
    return total * 1e3 / n


def append_pieces(cfg, device, dtype) -> dict:
    """The decode append's pieces at the engine's block (8 rows of 16),
    host ms per call: quantizing K and V together, the two unquantized
    pool writes, the four int8 writes (bytes and scales)."""
    h, d = cfg["heads"], cfg["dim_head"]
    n_p = paged_kv.num_pages(cfg["text_seq_len"] + 1 + cfg["image_fmap_size"] ** 2)
    g = torch.Generator(device=device).manual_seed(0)
    k, v = (torch.randn(8, 16, h * d, generator=g, device=device).to(dtype) for _ in range(2))
    table = paged_kv.identity_table(8, n_p, device)
    idx = torch.arange(8, dtype=torch.int32, device=device) * 16
    limit = torch.full((8,), 16, dtype=torch.int32, device=device)
    pools = [paged_kv.alloc(8, n_p, paged_kv.DEFAULT_PAGE_SIZE, h * d, dtype, device)
             for _ in range(2)]
    pools8 = [paged_kv.alloc(8, n_p, paged_kv.DEFAULT_PAGE_SIZE, f, t, device)
              for f, t in ((h * d, torch.int8),) * 2 + ((h, paged_kv.SCALE_DTYPE),) * 2]
    q8, s = paged_kv.quantize_rows(torch.cat([k, v]), h)
    rows8 = [*q8.split(8), *s.split(8)]
    return {
        "quantize_rows": host_ms(lambda: paged_kv.quantize_rows(torch.cat([k, v]), h), device),
        "append bf16 (2 pools)": host_ms(
            lambda: paged_kv.append_(pools, table, idx, [k, v], limit), device),
        "append int8 (4 pools)": host_ms(
            lambda: paged_kv.append_(pools8, table, idx, rows8, limit), device),
    }


def profile(model, kv_quant, cfg, device, iters=20) -> dict:
    """Own time (s) per function over ``iters`` engine iterations."""
    engine = _engine(model, kv_quant, cfg, device)
    for _ in range(10):
        engine.step()
    _sync(device)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(iters):
        engine.step()
    _sync(device)
    prof.disable()
    stats = pstats.Stats(prof).stats
    return {f"{fn}:{line}({name})" if line else name: (tt, nc)
            for (fn, line, name), (_, nc, tt, _, _) in stats.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="a tiny model for a dry run")
    args = ap.parse_args(argv)
    cfg = SMALL if args.small else FLAGSHIP
    dtype = torch.bfloat16
    model = DALLE(**cfg, device=args.device, dtype=dtype).init_weights(
        torch.Generator(device=args.device).manual_seed(0))
    window(model, "none", cfg, args.device, warmup=2, iters=3)  # builds and warms the kernels

    for collect in (True, False):
        for q in ORDER:
            r = window(model, q, cfg, args.device, collect=collect)
            print(f"window {q:4s} gc {'on ' if collect else 'off'}: "
                  f"iteration {r['iteration_ms']:.3f} ms, fused_step {r['fused_step_ms']:.3f} "
                  f"ms, gc passes {r['gc_passes']} taking {r['gc_ms']:.3f} ms/iteration",
                  flush=True)
    for name, ms in append_pieces(cfg, args.device, dtype).items():
        print(f"piece {name}: {ms:.4f} ms host per call", flush=True)

    iters = 20
    own = {q: profile(model, q, cfg, args.device, iters) for q in ("none", "int8")}
    total = {q: sum(tt for tt, _ in own[q].values()) * 1e3 / iters for q in own}
    print(f"cprofile: own time {total['none']:.3f} ms/iteration bf16, {total['int8']:.3f} "
          "int8; largest differences (int8 - bf16, ms/iteration, calls/iteration bf16 -> int8):")
    names = set(own["none"]) | set(own["int8"])
    diff = {n: own["int8"].get(n, (0, 0))[0] - own["none"].get(n, (0, 0))[0] for n in names}
    for n in sorted(names, key=lambda n: -abs(diff[n]))[:20]:
        print(f"  {diff[n] * 1e3 / iters:+.3f}  {own['none'].get(n, (0, 0))[1] / iters:.0f} -> "
              f"{own['int8'].get(n, (0, 0))[1] / iters:.0f}  {n}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
