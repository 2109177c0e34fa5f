"""Packed-qkv attention, forward and backward (counterpart of the fused
section of ``dalle_pytorch_tpu/ops/flash_attention.py``:
``fused_qkv_attention`` with its kernel bodies ``_fused_qkv_fwd_kernel``
and ``_fused_qkv_bwd_kernel`` and its vjp rules).

The attention projection's raw (b, n, 3*h*d) output goes in and
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
  version. Each wrapper's ``launches`` counts its kernel launches.
- ``FusedQKVAttention`` is the ``torch.autograd.Function`` over the two:
  it saves qkv, o and the lse, whose own gradient is not defined; the key
  mask gets none.

Semantics, shared by both directions: scores q.k^T with float32
accumulation, times ``sm_scale`` on the float32 result. A static (n, n)
pattern mask alone decides which pairs may attend; without one,
``causal`` allows row >= col and non-causal allows all. The runtime
(b, n) key mask is applied after either. Disallowed scores are
NEG_INF = -1e30, and p = exp(s - max) only where s > 0.5 * NEG_INF,
else 0, so a fully masked row gives exactly 0 output and lse = -1e30
(and exactly 0 gradient). Forward: p is rounded to v's dtype before the
value product (float32 accumulation); o = acc / l with l = 1 where
l == 0; lse = max + log(l) as (b, h, 1, n) float32. Backward: see
``reference_fused_qkv_bwd``.

The tiled ``flash_attention`` is not ported (``ops/attention.py`` raises
for the shapes JAX sends there).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
    km = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (b, n):
            raise ValueError(f"key_mask shape {tuple(key_mask.shape)} != {(b, n)}")
        if key_mask.device != dev:
            raise ValueError("key_mask must be on qkv's device")
        km = (key_mask.view(torch.uint8) if key_mask.dtype == torch.bool
              else (key_mask != 0).to(torch.uint8)).contiguous()
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


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(err: int, name: str, n: int, h: int, d: int) -> None:
    if err == -1:
        raise ValueError(f"the {name} kernel cannot take n={n}, heads={h}, dim_head={d}")
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
    and any n."""
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
    (b, n, h*d) of qkv's dtype and lse contiguous (b, h, 1, n) float32."""
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
