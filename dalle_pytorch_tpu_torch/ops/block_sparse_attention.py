"""Block-sparse pair-grid attention, forward and backward (counterpart of
``dalle_pytorch_tpu/ops/block_sparse_attention.py`` without its
sequence-parallel half).

A host-compiled ``BlockLayout`` lists the live (q-block, k-block) pairs
of a static (n, n) may-attend mask: q-major with first/last flags for
the forward and dq, k-major for dk/dv, with a synthetic all-masked pair
for every q block (k block) that has none, so its rows are written as
exact zeros. The compiler (``_pair_lists``, ``_table``,
``compile_block_layout``) is a numpy copy of JAX's; its tables come out
identical. ``device_layout`` puts on a device, once per layout, what the
kernels read: the int8 mask, the k-major table and its per-block run
offsets, and for a 128-block layout the tensor-core kernels' walks: the
q-major per-half class map of the forward and dq (``half_classes``) with
the query tiles longest row first (``tile_order``), and the k-major one
of the bf16 dk/dv (``half_columns``). Every kernel runs on the tensor
cores, float32 as split 3xTF32 and bfloat16 on bf16 ``mma.sync``: the
forward and dq of both types walk ``half_classes``, the float32 dk/dv
the k-major table, the bf16 dk/dv ``half_columns``. They copy rows by
16-byte ``cp.async``: an operand that is not 16-byte aligned, or a
missing class map, raises ValueError, with no fallback.

- ``reference_block_sparse`` (forward) and ``reference_block_sparse_dq``
  / ``reference_block_sparse_dkdv`` (their sum is
  ``reference_block_sparse_bwd``) are the plain versions.
- ``block_sparse_attention``, ``block_sparse_dq`` and
  ``block_sparse_dkdv`` wrap the hand-written CUDA kernels of
  ``csrc/block_sparse_attention.cu``. The tensor's device decides: a CUDA
  tensor launches the kernel or raises, a CPU tensor runs the plain
  version. Each wrapper's ``launches`` counts its kernel launches.
- ``BlockSparseAttention`` is the ``torch.autograd.Function`` over them:
  it saves q, k, v, o and lse; the key mask and the layout get no
  gradient.

Semantics (the JAX kernels' contract): q, k, v (b, h, n, d), q not
pre-scaled. Scores q.k^T accumulate in float32 and are scaled afterwards;
a pair may attend where ``layout.mask[:n, :n]`` and the (b, n) key mask
allow it, else its score is NEG_INF = -1e30; p = exp(s - m) only where
s > 0.5 * NEG_INF, else 0. Forward: p is cast to v's dtype before the
value product; o = acc / l with l = 1 where l == 0, so a row with every
key masked gives exactly 0 and lse = -1e30 (not the dense softmax's
uniform average); lse (b, h, n) float32. Backward: see
``reference_block_sparse_dq`` and ``reference_block_sparse_dkdv``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
# production block edge, the only one the kernels take (JAX's
# _sparse_block compiles no other)
DEFAULT_BLOCK = 128
# the pair grid engages only where the compiled layout visits at most
# this share of the dense-causal block pairs (JAX's routing threshold)
ENGAGE_FRAC = 0.9
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DIM_HEADS = (32, 64, 128)


# ------------------------------------------------------------------- layout


def _pair_lists(visit: np.ndarray):
    """q-major live pair arrays from a (nq, nk) visit map, with synthetic
    all-masked pairs (class 0) for empty q rows so every output block is
    written (an empty row finalizes with l == 0 -> exact 0 output)."""
    nq, nk = visit.shape
    q_idx, k_idx, kclass = [], [], []
    for qb in range(nq):
        cols = np.flatnonzero(visit[qb])
        if cols.size == 0:
            q_idx.append(qb)
            k_idx.append(min(qb, nk - 1))
            kclass.append(0)
            continue
        for kb in cols:
            q_idx.append(qb)
            k_idx.append(kb)
            kclass.append(int(visit[qb, kb]))
    q_idx = np.asarray(q_idx, np.int32)
    k_idx = np.asarray(k_idx, np.int32)
    kclass = np.asarray(kclass, np.int32)
    first = np.concatenate(([1], (q_idx[1:] != q_idx[:-1]).astype(np.int32)))
    last = np.concatenate(((q_idx[1:] != q_idx[:-1]).astype(np.int32), [1]))
    return q_idx, k_idx, kclass, first, last


def _table(q_idx, k_idx, kclass, first, last) -> np.ndarray:
    """(5, P) int32: rows are q-block index, k-block index, visit class
    (0 synthetic / 1 partial / 2 dense), first-of-group, last-of-group."""
    return np.stack([q_idx, k_idx, kclass, first, last]).astype(np.int32)


class DeviceLayout(NamedTuple):
    """A layout's operands on one device: the int8 (n_pad, n_pad) mask,
    the int32 k-major table and its (nk + 1,) run offsets (k block i owns
    columns [offsets[i], offsets[i + 1])) of the float32 dk/dv; for a
    128-block layout also the int8 (n_pad / 64, n_pad / 32)
    ``half_classes`` (forward and dq) and ``half_columns`` (bf16 dk/dv)
    and the int32 (n_pad / 64,) ``tile_order`` (None for other blocks,
    which no kernel takes). The q-major table stays on the host: no
    kernel reads it."""

    mask: torch.Tensor
    kv_table: torch.Tensor
    kv_offsets: torch.Tensor
    halves: Optional[torch.Tensor]
    order: Optional[torch.Tensor]
    columns: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class BlockLayout:
    """Host-compiled block program for one static pattern; hashes and
    compares by identity (build it once per pattern config and n).
    ``mask`` is the elementwise (n_pad, n_pad) may-attend matrix,
    zero-padded past ``n``: the kernels and the plain versions read it."""

    n: int
    n_pad: int
    block_q: int
    block_k: int
    visit: np.ndarray  # (nq, nk) int32: 0 skip / 1 partial / 2 dense
    mask: np.ndarray  # (n_pad, n_pad) bool
    fwd_table: np.ndarray  # (5, Pq) int32, q-major
    kv_table: np.ndarray  # (5, Pk) int32, k-major
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    @property
    def nq(self) -> int:
        return self.visit.shape[0]

    @property
    def nk(self) -> int:
        return self.visit.shape[1]

    @property
    def n_pairs(self) -> int:
        return int((self.visit > 0).sum())

    @property
    def dense_pairs(self) -> int:
        """Block pairs a full-causal layout visits at these block sizes."""
        q_hi = (np.arange(self.nq) + 1) * self.block_q - 1
        k_lo = np.arange(self.nk) * self.block_k
        return int((k_lo[None, :] <= q_hi[:, None]).sum())

    @property
    def visited_block_frac(self) -> float:
        """Live pairs / dense-causal pairs."""
        return self.n_pairs / max(self.dense_pairs, 1)


def compile_block_layout(mask: np.ndarray, block_q: int = DEFAULT_BLOCK,
                         block_k: int = DEFAULT_BLOCK) -> BlockLayout:
    """Compile an elementwise (n, n) may-attend mask into a BlockLayout.
    Ragged tails are zero-padded to the block grid: padded keys are never
    attendable, padded query rows are fully masked."""
    mask = np.asarray(mask, dtype=bool)
    n = mask.shape[0]
    assert mask.shape == (n, n), mask.shape
    nq = -(-n // block_q)
    nk = -(-n // block_k)
    n_pad = max(nq * block_q, nk * block_k)
    padded = np.zeros((n_pad, n_pad), dtype=bool)
    padded[:n, :n] = mask

    visit = np.zeros((nq, nk), dtype=np.int32)
    for qb in range(nq):
        row = padded[qb * block_q:(qb + 1) * block_q]
        for kb in range(nk):
            blk = row[:, kb * block_k:(kb + 1) * block_k]
            visit[qb, kb] = 0 if not blk.any() else (2 if blk.all() else 1)

    fwd = _table(*_pair_lists(visit))
    # k-major: groups per k block from the transposed visit map, index
    # rows swapped back to (q, k) order
    tk = _table(*_pair_lists(np.ascontiguousarray(visit.T)))
    kv = np.stack([tk[1], tk[0], tk[2], tk[3], tk[4]]).astype(np.int32)
    return BlockLayout(n=n, n_pad=n_pad, block_q=block_q, block_k=block_k,
                       visit=visit, mask=padded, fwd_table=fwd, kv_table=kv)


def _run_offsets(groups: np.ndarray, n_groups: int) -> np.ndarray:
    offsets = np.searchsorted(groups, np.arange(n_groups + 1)).astype(np.int32)
    assert (np.diff(offsets) > 0).all(), "every block owns a contiguous run"
    return offsets


# the tensor-core kernels' walks: a block owns a TILE-row query tile and
# walks its HALF-key halves (forward, dq), or a TILE-key tile and walks
# its HALF-row query halves (dk/dv)
TILE, HALF = 64, 32


def _tile_classes(layout: BlockLayout, rows: int, cols: int) -> np.ndarray:
    """(n_pad / rows, n_pad / cols) int8: the class of each (rows, cols)
    tile of ``layout.mask`` of a 128-block layout. 0 (passed over) where
    its 128-block pair is class 0 or absent, or the tile is empty (this
    holds every tile at or past n: the mask is zero there); 2 (no mask
    test) where the pair is class 2 or the tile is full (the test would
    pass everywhere); 1 (the mask tile decides) otherwise."""
    assert layout.block_q == layout.block_k == DEFAULT_BLOCK, "128-block layouts only"
    nr, nc = layout.n_pad // rows, layout.n_pad // cols
    tiles = layout.mask.reshape(nr, rows, nc, cols)
    some, full = tiles.any(axis=(1, 3)), tiles.all(axis=(1, 3))
    pair = layout.visit[np.arange(nr)[:, None] * rows // DEFAULT_BLOCK,
                        np.arange(nc)[None, :] * cols // DEFAULT_BLOCK]
    return np.where((pair == 0) | ~some, 0, np.where((pair == 2) | full, 2, 1)).astype(np.int8)


def half_classes(layout: BlockLayout) -> np.ndarray:
    """(n_pad / TILE, n_pad / HALF) int8: the class of each (64-row query
    tile, 32-key half) of a 128-block layout (``_tile_classes``), as the
    forward and the dq walk it (``tf32::HalfRow``)."""
    return _tile_classes(layout, TILE, HALF)


def half_columns(layout: BlockLayout) -> np.ndarray:
    """(n_pad / TILE, n_pad / HALF) int8, k-major: entry [kt, qh] is the
    class of the tile of query rows HALF * qh .. against keys TILE * kt
    .. of a 128-block layout (``_tile_classes``), as the bf16 dk/dv walks
    it (``tf32::HalfColumn``)."""
    return np.ascontiguousarray(_tile_classes(layout, HALF, TILE).T)


def tile_order(classes: np.ndarray) -> np.ndarray:
    """(n_pad / TILE,) int32: the query tiles by their count of live
    halves, most first (ties in tile order), so that a launch starts its
    longest rows first."""
    return np.argsort(-(classes != 0).sum(axis=1), kind="stable").astype(np.int32)


def device_layout(layout: BlockLayout, device) -> DeviceLayout:
    """The layout's operands on ``device``, copied there once per layout."""
    device = torch.device(device)
    cached = layout._on_device.get(device)
    if cached is None:
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        halves = order = columns = None
        if layout.block_q == layout.block_k == DEFAULT_BLOCK:
            classes = half_classes(layout)
            halves, order = put(classes), put(tile_order(classes))
            columns = put(half_columns(layout))
        cached = layout._on_device[device] = DeviceLayout(
            mask=put(layout.mask.astype(np.int8)),
            kv_table=put(layout.kv_table),
            kv_offsets=put(_run_offsets(layout.kv_table[1], layout.nk)),
            halves=halves,
            order=order,
            columns=columns,
        )
    return cached


# ----------------------------------------------------------- plain versions


def may_attend(layout: BlockLayout, n: int, device, key_mask=None) -> torch.Tensor:
    """(b or 1, 1, n, n) bool: the (query, key) pairs that may attend,
    ``layout.mask[:n, :n]`` and the (b, n) key mask."""
    allowed = (device_layout(layout, device).mask[:n, :n] != 0)[None, None]
    if key_mask is not None:
        allowed = allowed & (key_mask != 0)[:, None, None, :]
    return allowed


def _scores(q, k, layout, key_mask, scale):
    """Masked float32 scores (b, h, n, n)."""
    n = q.shape[2]
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    return s.masked_fill(~may_attend(layout, n, q.device, key_mask), NEG_INF)


def _probs(q, k, lse, layout, key_mask, scale):
    """p = exp(s - lse) where s > 0.5 * NEG_INF, else 0 (float32)."""
    s = _scores(q, k, layout, key_mask, scale)
    return torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse[..., None]), 0.0)


def _scale(d: int, sm_scale) -> float:
    return d**-0.5 if sm_scale is None else float(sm_scale)


def reference_block_sparse(q, k, v, layout: BlockLayout, key_mask=None,
                           sm_scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: q, k, v (b, h, n, d) float32 or bfloat16, q not
    pre-scaled; key_mask (b, n) (nonzero = attend). Returns o (b, h, n, d)
    in q's dtype and lse (b, h, n) float32."""
    scale = _scale(q.shape[-1], sm_scale)
    s = _scores(q, k, layout, key_mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    o = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), v.float())
    return (o / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


def reference_block_sparse_dq(q, k, v, o, lse, do, layout: BlockLayout,
                              key_mask=None, sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dq pass, the TPU kernel's arithmetic step by step: delta =
    rowsum(do * o) in float32; p = exp(s - lse) on the masked scores,
    dp = do . v^T, ds = p * (dp - delta) * scale in float32, cast to k's
    dtype before dq = ds . k. Returns dq in q's dtype and delta
    (b, h, n) float32."""
    scale = _scale(q.shape[-1], sm_scale)
    delta = (do.float() * o.float()).sum(dim=-1)
    p = _probs(q, k, lse, layout, key_mask, scale)
    dp = torch.einsum("bhid,bhjd->bhij", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhij,bhjd->bhid", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), delta


def reference_block_sparse_dkdv(q, k, v, do, lse, delta, layout: BlockLayout,
                                key_mask=None, sm_scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dk/dv pass: dv = p (cast to do's dtype)^T . do; ds = p *
    (dp - delta) * scale cast to q's dtype, dk = ds^T . q. Returns dk and
    dv in q's dtype."""
    scale = _scale(q.shape[-1], sm_scale)
    p = _probs(q, k, lse, layout, key_mask, scale)
    dv = torch.einsum("bhij,bhid->bhjd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bhid,bhjd->bhij", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dk = torch.einsum("bhij,bhid->bhjd", ds.float(), q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def reference_block_sparse_bwd(q, k, v, o, lse, do, layout: BlockLayout,
                               key_mask=None, sm_scale: Optional[float] = None):
    """Plain backward: (dq, dk, dv), each in q's dtype."""
    dq, delta = reference_block_sparse_dq(q, k, v, o, lse, do, layout,
                                          key_mask, sm_scale)
    dk, dv = reference_block_sparse_dkdv(q, k, v, do, lse, delta, layout,
                                         key_mask, sm_scale)
    return dq, dk, dv


# ------------------------------------------------------------------ kernels


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _operands(q, k, v, layout: BlockLayout, key_mask, *rest):
    """Check what the kernels take; return q, k, v and ``rest`` contiguous,
    the uint8 key mask (or None) and the layout's device operands."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the block-sparse kernels take float32 or bfloat16, got {q.dtype}")
    b, h, n, d = q.shape
    if d not in _DIM_HEADS:
        raise ValueError(f"the kernels have instances for dim_head {_DIM_HEADS}, got {d}")
    if layout.block_q != DEFAULT_BLOCK or layout.block_k != DEFAULT_BLOCK:
        raise ValueError(f"the kernels take {DEFAULT_BLOCK}-blocks, the layout has "
                         f"{layout.block_q} x {layout.block_k}")
    if layout.n != n:
        raise ValueError(f"the layout is for n={layout.n}, the tensors have n={n}")
    for t in (k, v, *rest):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"operands must all be {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    km = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (b, n) or key_mask.device != q.device:
            raise ValueError(f"key_mask must be {(b, n)} on {q.device}, got "
                             f"{tuple(key_mask.shape)} on {key_mask.device}")
        km = (key_mask.view(torch.uint8) if key_mask.dtype == torch.bool
              else (key_mask != 0).to(torch.uint8)).contiguous()
    tensors = [t.contiguous() for t in (q, k, v, *rest)]
    return tensors, km, device_layout(layout, q.device)


def _row_stats(lse, q, name="lse"):
    b, h, n, _ = q.shape
    if (lse.shape != (b, h, n) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"{name} must be {(b, h, n)} float32 on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    return lse.contiguous()


def _launch(fn_name: str, pointers, q, layout: BlockLayout, n_pairs: int,
            scale: float) -> None:
    from .cuda_build import load_library

    b, h, n, d = q.shape
    fn = getattr(load_library("block_sparse_attention"), fn_name)
    err = fn(*(_ptr(t) for t in pointers), b, h, n, layout.n_pad, d,
             layout.block_q, n_pairs, ctypes.c_float(scale), _DTYPE_CODE[q.dtype],
             ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err == -1:
        raise ValueError(f"{fn_name} cannot take b={b}, heads={h}, n={n}, dim_head={d}")
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: error {err}")


def block_sparse_attention(q, k, v, layout: BlockLayout, key_mask=None,
                           sm_scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (o (b, h, n, d), lse (b, h, n) float32); arguments as
    ``reference_block_sparse``. CPU tensors run the plain version; CUDA
    tensors launch the kernel, which takes float32 or bfloat16, dim_head
    32/64/128 and a 128-block layout for this n. Both types run on the
    tensor cores over the layout's ``half_classes`` and copy rows by
    16-byte ``cp.async``: an operand that is not 16-byte aligned raises
    ValueError, with no fallback."""
    if not q.is_cuda:
        return reference_block_sparse(q, k, v, layout, key_mask, sm_scale)
    (q, k, v), km, dl = _operands(q, k, v, layout, key_mask)
    b, h, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
    _launch("block_sparse_attention_fwd",
            (q, k, v, km, dl.mask, dl.halves, dl.order, o, lse),
            q, layout, layout.fwd_table.shape[1], _scale(d, sm_scale))
    block_sparse_attention.launches += 1
    return o, lse


block_sparse_attention.launches = 0


def block_sparse_dq(q, k, v, o, lse, do, layout: BlockLayout, key_mask=None,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dq pass: (dq (b, h, n, d), delta (b, h, n) float32); arguments as
    ``reference_block_sparse_dq``. The kernel computes delta from o and
    do for its own query rows and writes it for ``block_sparse_dkdv``.
    Both types run on the tensor cores over the layout's ``half_classes``
    and copy rows by 16-byte ``cp.async``: an operand that is not 16-byte
    aligned raises ValueError, with no fallback."""
    if not q.is_cuda:
        return reference_block_sparse_dq(q, k, v, o, lse, do, layout, key_mask,
                                         sm_scale)
    (q, k, v, o, do), km, dl = _operands(q, k, v, layout, key_mask, o, do)
    lse = _row_stats(lse, q)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _launch("block_sparse_attention_dq",
            (q, k, v, o, do, lse, km, dl.mask, dl.halves, dl.order, dq, delta),
            q, layout, layout.fwd_table.shape[1], _scale(q.shape[-1], sm_scale))
    block_sparse_dq.launches += 1
    return dq, delta


block_sparse_dq.launches = 0


def block_sparse_dkdv(q, k, v, do, lse, delta, layout: BlockLayout,
                      key_mask=None, sm_scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv pass: (dk, dv), each (b, h, n, d); arguments as
    ``reference_block_sparse_dkdv``. Both types run on the tensor cores
    (float32 over the k-major pair table, bfloat16 over the layout's
    ``half_columns``): an operand that is not 16-byte aligned raises
    ValueError, with no fallback."""
    if not q.is_cuda:
        return reference_block_sparse_dkdv(q, k, v, do, lse, delta, layout,
                                           key_mask, sm_scale)
    (q, k, v, do), km, dl = _operands(q, k, v, layout, key_mask, do)
    lse, delta = _row_stats(lse, q), _row_stats(delta, q, "delta")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("block_sparse_attention_dkdv",
            (q, k, v, do, lse, delta, km, dl.mask, dl.kv_table, dl.kv_offsets, dl.columns,
             dk, dv),
            q, layout, layout.kv_table.shape[1], _scale(q.shape[-1], sm_scale))
    block_sparse_dkdv.launches += 1
    return dk, dv


block_sparse_dkdv.launches = 0


class BlockSparseAttention(torch.autograd.Function):
    """Differentiable block-sparse attention: ``apply(q, k, v, key_mask,
    layout, sm_scale) -> (o, lse)``, forward by ``block_sparse_attention``,
    backward by ``block_sparse_dq`` and ``block_sparse_dkdv``. Saves q, k,
    v, o and lse; lse is not differentiable, and the key mask and layout
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, layout, sm_scale):
        o, lse = block_sparse_attention(q, k, v, layout, key_mask, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.options = (key_mask, layout, sm_scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        key_mask, layout, sm_scale = ctx.options
        # the dq pass writes delta = rowsum(do * o) for the dk/dv pass
        dq, delta = block_sparse_dq(q, k, v, o, lse, do, layout, key_mask, sm_scale)
        dk, dv = block_sparse_dkdv(q, k, v, do, lse, delta, layout, key_mask, sm_scale)
        return dq, dk, dv, None, None, None
