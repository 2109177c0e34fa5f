"""Flash attention, packed and tiled, forward and backward (counterpart of
``dalle_pytorch_tpu/ops/flash_attention.py``: the packed
``fused_qkv_attention`` with its kernel bodies ``_fused_qkv_fwd_kernel``
and ``_fused_qkv_bwd_kernel``, and the tiled ``flash_attention`` with
``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and
``_bwd_fused_kernel``, each with its vjp rules).

Packed: the attention projection's raw (b, n, 3*h*d) output goes in and
(b, n, h*d) comes out, in the projection's own layout: head j of q is
columns [j*d, (j+1)*d), of k h*d + j*d, of v 2*h*d + j*d. Rotary is
applied to q, k AND v, the reference's quirk, from cos/sin tables that
``rotary.rot_tables`` builds (and checks) once per table, not per call.

- ``reference_fused_qkv`` and ``reference_fused_qkv_bwd`` are the plain
  versions.
- ``fused_qkv_attention`` and ``fused_qkv_attention_bwd`` wrap the
  hand-written CUDA kernels (``csrc/fused_qkv_attention.cu``,
  ``csrc/fused_qkv_attention_bwd.cu``). The tensor's device decides: a
  CUDA tensor launches the kernel or raises, a CPU tensor runs the plain
  version. Each wrapper's ``launches`` counts its kernel launches. Both
  types run on the tensor cores: bfloat16 as bf16 tiles, float32 as
  split 3xTF32 tiles, which hold float32's accuracy.
- ``FusedQKVAttention`` is the ``torch.autograd.Function`` over the two:
  it saves qkv, o and the lse, whose own gradient is not defined; the key
  mask gets none.

Semantics, shared by both forms and directions: scores q.k^T with
float32 accumulation, times ``sm_scale`` on the float32 result. A static
(n, n) pattern mask alone decides which pairs may attend; without one,
``causal`` allows row >= col and non-causal allows all. The runtime
(b, n) key mask is applied after either. Disallowed scores are
NEG_INF = -1e30, and p = exp(s - max) only where s > 0.5 * NEG_INF,
else 0, so a fully masked row gives exactly 0 output and lse = -1e30
(and exactly 0 gradient). Forward: p is rounded to v's dtype before the
value product (float32 accumulation); o = acc / l with l = 1 where
l == 0; lse = max + log(l) in float32. Backward: see
``reference_fused_qkv_bwd`` and ``reference_flash_attention_bwd``.

Tiled: q, k, v (b, h, n, d) split and rotated by the caller, lse
(b, h, n). The kernels (``csrc/flash_attention.cu``) walk tiles of
``TILE`` query rows by ``TILE`` keys and skip every tile that
``block_visit_map`` classes 0 (JAX's visit classes at the kernels' own
tile); ``device_visit_map`` caches the map on a device once per
(n, tile, causal, pattern).

- ``reference_flash_attention`` and ``reference_flash_attention_bwd``
  are the plain versions (``reference_flash_attention_dq`` and
  ``reference_flash_attention_dkdv`` give its two passes alone).
- ``flash_attention_fwd``, ``flash_attention_dq`` (dq and delta =
  rowsum(do * o)), ``flash_attention_dkdv`` (on dq's delta) and
  ``flash_attention_bwd_fused`` (all three gradients from one launch)
  wrap the kernels, with the device rule and launch counts above.
- ``FlashAttention`` is the ``torch.autograd.Function`` over them: its
  backward runs the fused kernel where JAX's grid is one block
  (``flash_block(n) == n``), else dq then dk/dv, as JAX's ``_bwd_rule``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .rotary import rotate_half

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DIM_HEADS = (32, 64, 128)

# The TPU's scoped-VMEM budget that JAX's fused_qkv_supported derives its
# n bound from. Kept so that the port takes the packed path exactly where
# JAX does; the Hopper kernel has no (n, n) footprint, and for the shapes
# that reach it (_flash_block(n) == n, n <= 1280) the term never binds.
FUSED_VMEM_LIMIT_BYTES = 100 * 1024 * 1024


def fused_qkv_supported(n, heads, dim_head):
    """The dispatch rule of JAX's packed path, verbatim: n a multiple of
    128, the TPU backward's (n, n) temporaries within its VMEM budget, and
    128-lane head groups (``hpb`` heads per group) that divide the heads."""
    hpb = max(1, 128 // dim_head)
    vmem_budget = int(FUSED_VMEM_LIMIT_BYTES * 0.8)
    bwd_temp_bytes = 4 * n * n * 4 * hpb
    return (
        n % 128 == 0
        and bwd_temp_bytes <= vmem_budget
        and (dim_head * hpb) % 128 == 0
        and heads % hpb == 0
        and (heads * dim_head) % 128 == 0
    )


def may_attend(n: int, device, key_mask=None, causal: bool = True,
               pattern_mask=None) -> torch.Tensor:
    """(b or 1, 1, n, n) bool: which (query, key) pairs may attend under
    the masking rule of the module docstring (nonzero entries attend)."""
    if pattern_mask is not None:
        allowed = pattern_mask.to(device) != 0
    elif causal:
        allowed = torch.ones(n, n, dtype=torch.bool, device=device).tril()
    else:
        allowed = torch.ones(n, n, dtype=torch.bool, device=device)
    allowed = allowed[None, None]
    if key_mask is not None:
        allowed = allowed & (key_mask != 0)[:, None, None, :]
    return allowed


def reference_fused_qkv(qkv, heads: int, dim_head: int, key_mask=None,
                        causal: bool = True, pattern_mask=None, rot=None,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version. qkv (b, n, 3*h*d) float32 or bfloat16; key_mask
    (b, n) (nonzero = attend); pattern_mask (n, n) (nonzero = attend);
    rot the (cos, sin) pair of ``rotary.rot_tables``, each (>= n, d) in
    qkv's dtype. Returns o (b, n, h*d) in qkv's dtype and lse
    (b, h, 1, n) float32."""
    b, n, _ = qkv.shape
    h, d = heads, dim_head
    dtype = qkv.dtype
    scale = d**-0.5 if sm_scale is None else sm_scale
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    if rot is not None:
        cos, sin = (t[:n, None] for t in rot)
        q, k, v = (t * cos + rotate_half(t) * sin for t in (q, k, v))
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    allowed = may_attend(n, qkv.device, key_mask, causal, pattern_mask)
    s = s.masked_fill(~allowed, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    o = torch.einsum("bhij,bjhd->bihd", p.to(dtype).float(), v.float())
    o = (o / l_safe.permute(0, 2, 1, 3)).to(dtype)
    lse = (m + torch.log(l_safe)).permute(0, 1, 3, 2)
    return o.reshape(b, n, h * d), lse


def reference_fused_qkv_bwd(qkv, o, lse, do, heads: int, dim_head: int,
                            key_mask=None, causal: bool = True,
                            pattern_mask=None, rot=None,
                            sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain backward, the TPU kernel's arithmetic step by step. qkv and
    the other arguments as ``reference_fused_qkv``; o (b, n, h*d) and lse
    (b, h, 1, n) the forward's outputs; do (b, n, h*d) the gradient of o.
    Returns dqkv (b, n, 3*h*d) in qkv's dtype:

    - q, k, v rotated as the forward rotates them;
    - s = q.k^T in float32 times the scale, masked as the forward masks;
      p = exp(s - lse) where s > 0.5 * NEG_INF, else 0;
    - dv = p (cast to do's dtype)^T . do, dp = do . v^T;
    - delta = rowsum(do * o) in float32 from the stored o;
    - ds = p * (dp - delta) * scale, cast to q's dtype;
    - dq = ds . k, dk = ds^T . q on the rotated q and k;
    - the inverse rotation t*cos - rotate_half(t)*sin in float32 on dq, dk
      and dv (the true VJP for a pair-constant table), cast to qkv's dtype.
    """
    b, n, _ = qkv.shape
    h, d = heads, dim_head
    dtype = qkv.dtype
    scale = d**-0.5 if sm_scale is None else sm_scale
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    if rot is not None:
        cos, sin = (t[:n, None] for t in rot)
        q, k, v = (t * cos + rotate_half(t) * sin for t in (q, k, v))
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    allowed = may_attend(n, qkv.device, key_mask, causal, pattern_mask)
    s = s.masked_fill(~allowed, NEG_INF)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse.transpose(-1, -2)), 0.0)
    do4 = do.reshape(b, n, h, d)
    dv = torch.einsum("bhij,bihd->bjhd", p.to(do.dtype).float(), do4.float())
    dp = torch.einsum("bihd,bjhd->bhij", do4.float(), v.float())
    delta = (do4.float() * o.reshape(b, n, h, d).float()).sum(-1)
    ds = (p * (dp - delta.permute(0, 2, 1)[..., None]) * scale).to(dtype)
    dq = torch.einsum("bhij,bjhd->bihd", ds.float(), k.float())
    dk = torch.einsum("bhij,bihd->bjhd", ds.float(), q.float())
    grads = (dq, dk, dv)
    if rot is not None:
        cosf, sinf = cos.float(), sin.float()
        grads = (t * cosf - rotate_half(t) * sinf for t in grads)
    return torch.cat([t.reshape(b, n, h * d).to(dtype) for t in grads], dim=-1)


def _kernel_operands(qkv, h: int, d: int, key_mask, pattern_mask, rot):
    """Check what both kernels take and give their mask and table
    operands: (uint8 key mask or None, int8 pattern or None, cos, sin)."""
    b, n, width = qkv.shape
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"the packed-qkv kernels take float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("the packed-qkv kernels: qkv must be contiguous")
    if width != 3 * h * d:
        raise ValueError(f"qkv width {width} is not 3 * heads * dim_head = 3*{h}*{d}")
    if d not in _DIM_HEADS:
        raise ValueError(f"the kernels have instances for dim_head {_DIM_HEADS}, got {d}")
    dev = qkv.device
    km = _key_mask_operand(key_mask, b, n, dev)
    pm = None
    if pattern_mask is not None:
        if tuple(pattern_mask.shape) != (n, n):
            raise ValueError(f"pattern_mask shape {tuple(pattern_mask.shape)} != {(n, n)}")
        pm = (pattern_mask.to(dev) != 0).to(torch.int8).contiguous()
    cos = sin = None
    if rot is not None:
        cos, sin = (t[:n] for t in rot)
        for t in (cos, sin):
            if (t.shape != (n, d) or t.dtype != qkv.dtype or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"rot tables must be contiguous ({n}, {d}) {qkv.dtype} on "
                    f"qkv's device (rotary.rot_tables), got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")
    return km, pm, cos, sin


def _key_mask_operand(key_mask, b: int, n: int, device):
    """The kernels' key-mask operand: (b, n) uint8 contiguous on
    ``device`` (nonzero = attend), or None."""
    if key_mask is None:
        return None
    if tuple(key_mask.shape) != (b, n) or key_mask.device != device:
        raise ValueError(f"key_mask must be {(b, n)} on {device}, got "
                         f"{tuple(key_mask.shape)} on {key_mask.device}")
    return (key_mask.view(torch.uint8) if key_mask.dtype == torch.bool
            else (key_mask != 0).to(torch.uint8)).contiguous()


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(err: int, name: str, n: int, h: int, d: int) -> None:
    if err == -1:
        raise ValueError(f"the {name} kernel cannot take n={n}, heads={h}, dim_head={d}, "
                         "or an operand that is not 16-byte aligned")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")


def fused_qkv_attention(qkv, heads: int, dim_head: int, key_mask=None,
                        causal: bool = True, pattern_mask=None, rot=None,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed attention: qkv (b, n, 3*h*d) -> o (b, n, h*d), lse
    (b, h, 1, n) float32; arguments as ``reference_fused_qkv``. CPU
    tensors run ``reference_fused_qkv``; CUDA tensors launch the kernel,
    which takes contiguous float32 or bfloat16 qkv, dim_head 32/64/128
    and any n, with qkv and the rotary tables 16-byte aligned (both types
    run on the tensor cores and load tiles by 16-byte ``cp.async``)."""
    if not qkv.is_cuda:
        return reference_fused_qkv(qkv, heads, dim_head, key_mask, causal,
                                   pattern_mask, rot, sm_scale)
    b, n, _ = qkv.shape
    h, d = heads, dim_head
    km, pm, cos, sin = _kernel_operands(qkv, h, d, key_mask, pattern_mask, rot)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    from .cuda_build import load_library

    lib = load_library("fused_qkv_attention")
    o = torch.empty(b, n, h * d, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, h, 1, n, dtype=torch.float32, device=qkv.device)
    err = lib.fused_qkv_attention_fwd(
        _ptr(qkv), _ptr(km), _ptr(pm), _ptr(cos), _ptr(sin), _ptr(o), _ptr(lse),
        b, n, h, d, int(causal), ctypes.c_float(scale), _DTYPE_CODE[qkv.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream),
    )
    _check(err, "fused_qkv_attention", n, h, d)
    fused_qkv_attention.launches += 1
    return o, lse


fused_qkv_attention.launches = 0


def fused_qkv_attention_bwd(qkv, o, lse, do, heads: int, dim_head: int,
                            key_mask=None, causal: bool = True,
                            pattern_mask=None, rot=None,
                            sm_scale: Optional[float] = None) -> torch.Tensor:
    """Gradient of the packed attention with respect to qkv: dqkv
    (b, n, 3*h*d); arguments as ``reference_fused_qkv_bwd``. CPU tensors
    run ``reference_fused_qkv_bwd``; CUDA tensors launch the kernel, which
    takes what the forward kernel takes, with o and do contiguous
    (b, n, h*d) of qkv's dtype and 16-byte aligned, and lse contiguous
    (b, h, 1, n) float32."""
    if not qkv.is_cuda:
        return reference_fused_qkv_bwd(qkv, o, lse, do, heads, dim_head,
                                       key_mask, causal, pattern_mask, rot,
                                       sm_scale)
    b, n, _ = qkv.shape
    h, d = heads, dim_head
    km, pm, cos, sin = _kernel_operands(qkv, h, d, key_mask, pattern_mask, rot)
    for name, t in (("o", o), ("do", do)):
        if (t.shape != (b, n, h * d) or t.dtype != qkv.dtype
                or t.device != qkv.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {(b, n, h * d)} {qkv.dtype} "
                             f"on qkv's device, got {tuple(t.shape)} {t.dtype}")
    if (lse.shape != (b, h, 1, n) or lse.dtype != torch.float32
            or lse.device != qkv.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous {(b, h, 1, n)} float32 on qkv's "
                         f"device, got {tuple(lse.shape)} {lse.dtype}")
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    from .cuda_build import load_library

    lib = load_library("fused_qkv_attention_bwd")
    dqkv = torch.empty_like(qkv)
    rotated = None if cos is None else torch.empty_like(qkv)
    delta = torch.empty(b, h, n, dtype=torch.float32, device=qkv.device)
    err = lib.fused_qkv_attention_bwd(
        _ptr(qkv), _ptr(o), _ptr(lse), _ptr(do), _ptr(km), _ptr(pm), _ptr(cos),
        _ptr(sin), _ptr(rotated), _ptr(delta), _ptr(dqkv),
        b, n, h, d, int(causal), ctypes.c_float(scale), _DTYPE_CODE[qkv.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream),
    )
    _check(err, "fused_qkv_attention_bwd", n, h, d)
    fused_qkv_attention_bwd.launches += 1
    return dqkv


fused_qkv_attention_bwd.launches = 0


class FusedQKVAttention(torch.autograd.Function):
    """Differentiable packed attention: ``apply(qkv, key_mask, heads,
    dim_head, causal, pattern_mask, rot, sm_scale) -> (o, lse)``, forward
    by ``fused_qkv_attention``, backward by ``fused_qkv_attention_bwd``.
    Saves qkv, o and lse; lse is not differentiable, and the key mask,
    pattern mask and tables get no gradient."""

    @staticmethod
    def forward(ctx, qkv, key_mask, heads, dim_head, causal, pattern_mask,
                rot, sm_scale):
        o, lse = fused_qkv_attention(qkv, heads, dim_head, key_mask, causal,
                                     pattern_mask, rot, sm_scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.options = (heads, dim_head, key_mask, causal, pattern_mask, rot, sm_scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, o, lse = ctx.saved_tensors
        heads, dim_head, key_mask, causal, pattern_mask, rot, sm_scale = ctx.options
        dqkv = fused_qkv_attention_bwd(qkv, o, lse, do.contiguous(), heads,
                                       dim_head, key_mask, causal,
                                       pattern_mask, rot, sm_scale)
        return dqkv, None, None, None, None, None, None, None


# -------------------------------------------------------------------- tiled

TILE = 64  # query rows and keys of one tile of the tiled kernels
_TILED_DIM_HEADS = (32, 64, 96, 128)
# (n, tile, causal, id(pattern), device) -> (pattern, visit map, int8
# pattern); the entry holds the pattern, so its id names it while cached
_VISIT_CACHE: dict = {}


def flash_block(n: int) -> int:
    """JAX's flash block for a sequence of n: the largest of 1280, 1024,
    640, 512, 384, 256, 128 that divides n, else 0."""
    for b in (1280, 1024, 640, 512, 384, 256, 128):
        if n % b == 0:
            return b
    return 0


def block_visit_map(n: int, tile_q: int, tile_k: int, causal: bool = True,
                    pattern=None) -> np.ndarray:
    """JAX's ``_block_visit_map`` at tiles of ``tile_q`` x ``tile_k``:
    (n / tile_q, n / tile_k) int32, 0 = skip (no pair may attend), 1 =
    needs masking, 2 = dense. A pattern (n, n) (array or tensor, nonzero
    = attend) decides alone; without one, causal classes the tiles by the
    diagonal and non-causal makes every tile dense."""
    if n % tile_q or n % tile_k:
        raise ValueError(f"n={n} is not a multiple of the tiles {tile_q} x {tile_k}")
    nq, nk = n // tile_q, n // tile_k
    if pattern is not None:
        if tuple(pattern.shape) != (n, n):
            raise ValueError(f"pattern shape {tuple(pattern.shape)} != {(n, n)}")
        tiles = torch.as_tensor(pattern).cpu().ne(0).reshape(nq, tile_q, nk, tile_k)
        live = tiles.any(dim=3).any(dim=1).numpy()
        full = tiles.all(dim=3).all(dim=1).numpy()
        return np.where(live, np.where(full, 2, 1), 0).astype(np.int32)
    if not causal:
        return np.full((nq, nk), 2, dtype=np.int32)
    qb, kb = np.arange(nq)[:, None], np.arange(nk)[None]
    above = kb * tile_k > (qb + 1) * tile_q - 1  # fully above the diagonal
    crossing = (kb + 1) * tile_k - 1 > qb * tile_q
    return np.where(above, 0, np.where(crossing, 1, 2)).astype(np.int32)


def device_visit_map(n: int, causal: bool, pattern, device):
    """(visit map at ``TILE`` as an int8 (n / TILE, n / TILE) tensor, the
    pattern as a contiguous int8 (n, n) tensor or None), both on
    ``device``, built once per (n, tile, causal, pattern)."""
    device = torch.device(device)
    key = (n, TILE, causal, None if pattern is None else id(pattern), device)
    cached = _VISIT_CACHE.get(key)
    if cached is None:
        visit = block_visit_map(n, TILE, TILE, causal, pattern)
        pm = None if pattern is None else (pattern.to(device) != 0).to(torch.int8).contiguous()
        cached = _VISIT_CACHE[key] = (
            pattern, torch.from_numpy(visit.astype(np.int8)).to(device), pm)
    return cached[1], cached[2]


def _scores(q, k, key_mask, causal, pattern, scale):
    """Masked float32 scores (b, h, n, n)."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    allowed = may_attend(q.shape[2], q.device, key_mask, causal, pattern)
    return s.masked_fill(~allowed, NEG_INF)


def _scale(d: int, sm_scale) -> float:
    return d**-0.5 if sm_scale is None else float(sm_scale)


def reference_flash_attention(q, k, v, key_mask=None, causal: bool = True,
                              pattern=None, sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: q, k, v (b, h, n, d) float32 or bfloat16, q not
    pre-scaled; key_mask (b, n) and pattern (n, n), nonzero = attend.
    Returns o (b, h, n, d) in q's dtype and lse (b, h, n) float32."""
    s = _scores(q, k, key_mask, causal, pattern, _scale(q.shape[-1], sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    o = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), v.float())
    return (o / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _delta(o, do) -> torch.Tensor:
    """rowsum(do * o) in float32, (b, h, n)."""
    return (do.float() * o.float()).sum(dim=-1)


def _reference_grads(q, k, v, lse, do, delta, key_mask, causal, pattern,
                     sm_scale):
    """The TPU kernels' backward arithmetic on one recomputation of p:
    p = exp(s - lse) on the masked scores, dv = p (cast to do's dtype)^T
    . do, dp = do . v^T, ds = p * (dp - delta) * scale in float32, cast to
    k's dtype for dq = ds . k and to q's dtype for dk = ds^T . q."""
    scale = _scale(q.shape[-1], sm_scale)
    s = _scores(q, k, key_mask, causal, pattern, scale)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse[..., None]), 0.0)
    del s
    dv = torch.einsum("bhij,bhid->bhjd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bhid,bhjd->bhij", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    del p, dp
    dq = torch.einsum("bhij,bhjd->bhid", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhij,bhid->bhjd", ds.to(q.dtype).float(), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def reference_flash_attention_bwd(q, k, v, o, lse, do, key_mask=None,
                                  causal: bool = True, pattern=None,
                                  sm_scale: Optional[float] = None):
    """Plain backward: o and lse the forward's outputs, do the gradient of
    o; delta = rowsum(do * o) in float32, then ``_reference_grads``.
    Returns (dq, dk, dv), each in q's dtype."""
    return _reference_grads(q, k, v, lse, do, _delta(o, do), key_mask, causal,
                            pattern, sm_scale)


def reference_flash_attention_dq(q, k, v, o, lse, do, key_mask=None,
                                 causal: bool = True, pattern=None,
                                 sm_scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dq pass: (dq, delta (b, h, n) float32), the arithmetic of
    ``reference_flash_attention_bwd``."""
    delta = _delta(o, do)
    return _reference_grads(q, k, v, lse, do, delta, key_mask, causal, pattern,
                            sm_scale)[0], delta


def reference_flash_attention_dkdv(q, k, v, do, lse, delta, key_mask=None,
                                   causal: bool = True, pattern=None,
                                   sm_scale: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dk/dv pass on a given delta: (dk, dv)."""
    return _reference_grads(q, k, v, lse, do, delta, key_mask, causal, pattern,
                            sm_scale)[1:]


def _tiled_operands(q, k, v, key_mask, causal, pattern, *rest):
    """Check what the tiled kernels take; return q, k, v and ``rest``
    contiguous, the uint8 key mask (or None), the device visit map and the
    int8 pattern (or None)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the tiled flash kernels take float32 or bfloat16, got {q.dtype}")
    b, h, n, d = q.shape
    if d not in _TILED_DIM_HEADS:
        raise ValueError(f"the kernels have instances for dim_head {_TILED_DIM_HEADS}, got {d}")
    if n % TILE:
        raise ValueError(f"the kernels take n a multiple of {TILE}, got {n}")
    for t in (k, v, *rest):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"operands must all be {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    visit, pm = device_visit_map(n, causal, pattern, q.device)
    return ([t.contiguous() for t in (q, k, v, *rest)],
            _key_mask_operand(key_mask, b, n, q.device), visit, pm)


def _row_stats(t, q, name: str):
    b, h, n, _ = q.shape
    if t.shape != (b, h, n) or t.dtype != torch.float32 or t.device != q.device:
        raise ValueError(f"{name} must be {(b, h, n)} float32 on {q.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _launch_tiled(fn_name: str, pointers, q, sm_scale) -> None:
    from .cuda_build import load_library

    b, h, n, d = q.shape
    fn = getattr(load_library("flash_attention"), fn_name)
    err = fn(*(_ptr(t) for t in pointers), b, h, n, d,
             ctypes.c_float(_scale(d, sm_scale)), _DTYPE_CODE[q.dtype],
             ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err == -1:
        raise ValueError(f"{fn_name} cannot take b={b}, heads={h}, n={n}, dim_head={d}")
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: error {err}")


def flash_attention_fwd(q, k, v, key_mask=None, causal: bool = True,
                        pattern=None, sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled forward: (o (b, h, n, d), lse (b, h, n) float32); arguments
    as ``reference_flash_attention``. CPU tensors run the plain version;
    CUDA tensors launch the kernel, which takes float32 or bfloat16,
    dim_head 32/64/96/128 and n a multiple of ``TILE``."""
    if not q.is_cuda:
        return reference_flash_attention(q, k, v, key_mask, causal, pattern, sm_scale)
    (q, k, v), km, visit, pm = _tiled_operands(q, k, v, key_mask, causal, pattern)
    b, h, n, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
    _launch_tiled("flash_attention_fwd", (q, k, v, km, pm, visit, o, lse), q, sm_scale)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_dq(q, k, v, o, lse, do, key_mask=None, causal: bool = True,
                       pattern=None, sm_scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dq pass: (dq (b, h, n, d), delta (b, h, n) float32). The kernel
    computes delta = rowsum(do * o) for its own query rows and writes it
    for ``flash_attention_dkdv``."""
    if not q.is_cuda:
        return reference_flash_attention_dq(q, k, v, o, lse, do, key_mask, causal,
                                            pattern, sm_scale)
    (q, k, v, o, do), km, visit, pm = _tiled_operands(q, k, v, key_mask, causal,
                                                      pattern, o, do)
    lse = _row_stats(lse, q, "lse")
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _launch_tiled("flash_attention_dq", (q, k, v, o, do, lse, km, pm, visit, dq, delta),
                  q, sm_scale)
    flash_attention_dq.launches += 1
    return dq, delta


flash_attention_dq.launches = 0


def flash_attention_dkdv(q, k, v, do, lse, delta, key_mask=None,
                         causal: bool = True, pattern=None,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv pass on the delta of ``flash_attention_dq``: (dk, dv), each
    (b, h, n, d)."""
    if not q.is_cuda:
        return reference_flash_attention_dkdv(q, k, v, do, lse, delta, key_mask,
                                              causal, pattern, sm_scale)
    (q, k, v, do), km, visit, pm = _tiled_operands(q, k, v, key_mask, causal,
                                                   pattern, do)
    lse, delta = _row_stats(lse, q, "lse"), _row_stats(delta, q, "delta")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch_tiled("flash_attention_dkdv", (q, k, v, do, lse, delta, km, pm, visit, dk, dv),
                  q, sm_scale)
    flash_attention_dkdv.launches += 1
    return dk, dv


flash_attention_dkdv.launches = 0


def flash_attention_bwd_fused(q, k, v, o, lse, do, key_mask=None,
                              causal: bool = True, pattern=None,
                              sm_scale: Optional[float] = None):
    """The whole backward from one launch: (dq, dk, dv), each
    (b, h, n, d); arguments as ``reference_flash_attention_bwd``. Query
    tiles compute dq and key tiles dk and dv, each deriving delta from its
    own rows of do and o; delta is never written."""
    if not q.is_cuda:
        return reference_flash_attention_bwd(q, k, v, o, lse, do, key_mask, causal,
                                             pattern, sm_scale)
    (q, k, v, o, do), km, visit, pm = _tiled_operands(q, k, v, key_mask, causal,
                                                      pattern, o, do)
    lse = _row_stats(lse, q, "lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    _launch_tiled("flash_attention_bwd_fused", (q, k, v, o, do, lse, km, pm, visit,
                                                dq, dk, dv), q, sm_scale)
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


flash_attention_bwd_fused.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable tiled attention: ``apply(q, k, v, key_mask, causal,
    pattern, sm_scale) -> (o, lse)``, forward by ``flash_attention_fwd``;
    backward by ``flash_attention_bwd_fused`` where JAX's grid is one
    block (``flash_block(n) == n``), else ``flash_attention_dq`` then
    ``flash_attention_dkdv`` on its delta. Saves q, k, v (contiguous), o
    and lse; lse is not differentiable, and the key mask and pattern get
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, pattern, sm_scale):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, key_mask, causal, pattern, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.options = (key_mask, causal, pattern, sm_scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        options = ctx.options
        do = do.contiguous()
        n = q.shape[2]
        if flash_block(n) == n:
            dq, dk, dv = flash_attention_bwd_fused(q, k, v, o, lse, do, *options)
        else:
            dq, delta = flash_attention_dq(q, k, v, o, lse, do, *options)
            dk, dv = flash_attention_dkdv(q, k, v, do, lse, delta, *options)
        return dq, dk, dv, None, None, None, None
