"""The port's tiled flash attention against the JAX package on the CPU,
float32 (``dalle_pytorch_tpu_torch/ops/flash_attention.py``'s tiled
section, the full-sequence dispatch of ``ops/attention.py``, and the
training slice at shapes that take it):

- ops: ``block_visit_map`` equals JAX's ``_block_visit_map``; the plain
  forward (o, lse) against JAX ``flash_attention(..., interpret=True)``
  at n 256 and 384 with blocks of 128 (atol 1e-5), and the plain backward
  and autograd through ``FlashAttention`` against ``jax.vjp`` of it (each
  gradient within 1e-4 of its largest entry): causal, non-causal, an
  axial_row ``StaticMask``, a key mask whose dead rows give exactly
  0 / -1e30 / 0, dim_head 32, 64, 96 and 128, and a one-block grid
  (block = n), where JAX runs ``_bwd_fused_kernel``;
- routing: ``full_route`` equals JAX's choice among the packed kernel,
  the tiled split backward, the tiled one-block backward and the dense
  path, read from JAX's own predicates; a spy confirms both frameworks'
  calls on one shape; no listed shape raises;
- the layer: ``Attention`` on converted weights against JAX
  ``PatternAttention``, output and every gradient, for a "full" layer at
  n 1152 (3 x 3 blocks of 384), an axial_col layer at n 1152 whose pair
  grid declines and a 3-head layer at n 384 (one block), each with and
  without a key mask;
- the slice: a small DALLE on converted weights against JAX (logits atol
  1e-4, loss rtol 1e-5, every gradient within 1e-4 of its largest entry)
  and 3 clipped-Adam steps against JAX ``make_train_step``, at n 1152
  (tiled, split backward) and at n 384 with 3 heads (one block).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.ops import attention as jattention
from dalle_pytorch_tpu.ops import masks as jmasks
from dalle_pytorch_tpu.ops.attention import PatternAttention
from dalle_pytorch_tpu.ops.flash_attention import StaticMask, StaticTable
from dalle_pytorch_tpu.parallel import create_train_state as j_create_state
from dalle_pytorch_tpu.parallel import make_runtime
from dalle_pytorch_tpu.parallel import make_train_step as j_make_step
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops.attention import Attention, full_attend, full_route
from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step

# the module, not the function that dalle_pytorch_tpu.ops exports under its name
jfa = importlib.import_module("dalle_pytorch_tpu.ops.flash_attention")

torch.set_num_threads(2)


def _grad_err(got, want) -> float:
    """Max abs error of ``got`` over the largest entry of ``want``."""
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("n,tile", [(384, 64), (384, 128), (256, 256), (4352, 64)])
@pytest.mark.parametrize("pattern", ["none", "axial_row", "axial_col", "conv_like"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_visit_map_equals_jax(n, tile, pattern, causal):
    fmap = 16 if n < 4352 else 64
    mask = None if pattern == "none" else jmasks.pattern_mask(pattern, n + 1 - fmap**2,
                                                                fmap)[:n, :n]
    ours = fa.block_visit_map(n, tile, tile, causal, mask)
    theirs = jfa._block_visit_map(n // tile, n // tile, tile, tile, causal, mask)
    np.testing.assert_array_equal(ours, theirs)


def test_device_visit_map_is_built_once_per_pattern():
    pattern = torch.from_numpy(jmasks.axial_mask(129, 16, 1)[:384, :384])
    visit, pm = fa.device_visit_map(384, True, pattern, "cpu")
    assert fa.device_visit_map(384, True, pattern, "cpu")[0] is visit
    assert visit.dtype == torch.int8 and tuple(visit.shape) == (6, 6)
    assert pm.dtype == torch.int8 and torch.equal(pm != 0, pattern)
    other = pattern.clone()
    assert fa.device_visit_map(384, True, other, "cpu")[0] is not visit
    causal, none = fa.device_visit_map(384, True, None, "cpu")
    assert none is None and torch.equal(
        causal, torch.from_numpy(fa.block_visit_map(384, 64, 64).astype(np.int8)))


def _key_mask(b, n):
    """Row 0 drops key 0 (query 0 then attends nothing under the causal
    rule) and every seventh key; row 1 drops every key (all its rows
    dead)."""
    km = np.ones((b, n), bool)
    km[0, 0], km[0, 5::7] = False, False
    km[1] = False
    return km


# (n, dim_head, causal, pattern, key mask, block)
OP_CASES = {
    "causal": (256, 64, True, None, False, 128),
    "noncausal": (384, 64, False, None, False, 128),
    "axial_row": (384, 32, True, "axial_row", False, 128),
    "key_mask": (384, 64, True, None, True, 128),
    "d32": (256, 32, True, None, True, 128),
    "d96": (256, 96, True, None, True, 128),
    "d128": (384, 128, False, None, True, 128),
    "one_block": (384, 64, True, None, True, 384),
    "one_block_pattern": (256, 32, True, "axial_row", False, 256),
}


def _op_inputs(name, seed):
    n, d, causal, pattern, with_mask, block = OP_CASES[name]
    b, h = 2, 2
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(4))
    mask = None
    if pattern is not None:
        mask = jmasks.pattern_mask(pattern, n + 1 - 16**2, 16)[:n, :n]
    km = _key_mask(b, n) if with_mask else None
    return (q, k, v, do), dict(causal=causal, mask=mask, km=km, block=block)


def _jax_flash(q, k, v, o):
    return jfa.flash_attention(
        q, k, v, key_mask=None if o["km"] is None else jnp.asarray(o["km"]),
        causal=o["causal"], pattern_mask=None if o["mask"] is None else StaticMask(o["mask"]),
        sm_scale=q.shape[-1] ** -0.5, block_q=o["block"], block_k=o["block"], interpret=True)


def _torch_opts(o):
    return dict(key_mask=None if o["km"] is None else torch.from_numpy(o["km"]),
                causal=o["causal"],
                pattern=None if o["mask"] is None else torch.from_numpy(o["mask"]))


@pytest.mark.parametrize("name", list(OP_CASES))
def test_forward_matches_jax_interpret(name):
    (q, k, v, _), o = _op_inputs(name, 0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jkm = None if o["km"] is None else jnp.asarray(o["km"])
    jmask = None if o["mask"] is None else StaticMask(o["mask"])
    ref_o, ref_lse = jfa._flash_fwd(jq, jk, jv, jkm, o["causal"], jmask, None,
                                    o["block"], o["block"], True)
    opts = _torch_opts(o)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), **opts)
    assert fa.flash_attention_fwd.launches == before  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5, rtol=0)
    if o["km"] is not None:
        allowed = fa.may_attend(q.shape[2], "cpu", opts["key_mask"], o["causal"],
                                opts["pattern"])[:, 0]
        dead = (~allowed.any(dim=2))[:, None].expand(lse.shape)
        assert dead.any()
        assert (out[dead] == 0).all() and (lse[dead] == fa.NEG_INF).all()


@pytest.mark.parametrize("name", list(OP_CASES))
def test_backward_matches_jax_vjp(name):
    (q, k, v, do), o = _op_inputs(name, 1)
    _, vjp = jax.vjp(lambda q, k, v: _jax_flash(q, k, v, o), *map(jnp.asarray, (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    opts = _torch_opts(o)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.reference_flash_attention(tq, tk, tv, **opts)
    plain = fa.reference_flash_attention_bwd(tq, tk, tv, out, lse, tdo, **opts)
    dq, delta = fa.flash_attention_dq(tq, tk, tv, out, lse, tdo, **opts)
    split = (dq, *fa.flash_attention_dkdv(tq, tk, tv, tdo, lse, delta, **opts))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    res, _ = fa.FlashAttention.apply(*leaves, opts["key_mask"], o["causal"], opts["pattern"],
                                     None)
    auto = torch.autograd.grad(res, leaves, tdo)
    for part, want, *got in zip("qkv", ref, plain, split, auto):
        for g in got:
            assert _grad_err(g.numpy(), want) <= 1e-4, (part, _grad_err(g.numpy(), want))
    if o["km"] is not None:
        allowed = fa.may_attend(q.shape[2], "cpu", opts["key_mask"], o["causal"],
                                opts["pattern"])[:, 0]
        dead_q = (~allowed.any(dim=2))[:, None].expand(lse.shape)
        dead_k = (~allowed.any(dim=1))[:, None].expand(lse.shape)
        assert (plain[0][dead_q] == 0).all() and (auto[0][dead_q] == 0).all()
        assert all((g[dead_k] == 0).all() for g in (*plain[1:], *auto[1:]))


# --------------------------------------------------------------- routing


def _jax_route(n, h, d):
    """JAX's choice, from its own predicates."""
    block = jattention._flash_block(n)
    if block == n and jfa.fused_qkv_supported(n, h, d):
        return "packed"
    if block == n:
        return "tiled_one_block"
    return "tiled" if block > 0 else "dense"


ROUTE_NS = (128, 200, 384, 1152, 1280, 4352)
ROUTE_HEADS = ((2, 64), (3, 64), (16, 64), (4, 96))


@pytest.mark.parametrize("n", ROUTE_NS)
def test_route_is_jax(n):
    routes = {(h, d): full_route(n, h, d) for h, d in ROUTE_HEADS}
    assert routes == {(h, d): _jax_route(n, h, d) for h, d in ROUTE_HEADS}
    assert fa.flash_block(n) == jattention._flash_block(n)
    if n == 4352:  # the 512 px training shape
        assert set(routes.values()) == {"tiled"}


def test_no_listed_shape_raises():
    """Every listed shape up to n 1280 attends on the CPU (the plain
    versions) and gives finite (b, n, h*d) outputs; the tiled kernels'
    shapes at n 4352 are checked by their route (their plain version's
    (n, n) scores are too large for a CPU test)."""
    rng = np.random.RandomState(0)
    seen = set()
    for n in ROUTE_NS[:-1]:
        for h, d in ROUTE_HEADS:
            qkv = torch.from_numpy(rng.randn(1, n, 3 * h * d).astype(np.float32))
            out = full_attend(qkv, h, d)
            assert out.shape == (1, n, h * d) and torch.isfinite(out).all()
            seen.add(full_route(n, h, d))
    assert seen == {"packed", "tiled", "tiled_one_block", "dense"}


@pytest.mark.parametrize("n,heads,want", [(384, 3, "tiled_one_block"), (768, 2, "tiled")],
                         ids=["one_block", "split"])
def test_spies_see_jax_and_the_port_take_the_same_kernels(monkeypatch, n, heads, want):
    """JAX's PatternAttention calls ``flash_attention`` (not the packed
    kernel) with the flash block; the port's layer calls the tiled forward
    and, backward, the single-block kernel (one block) or dq then dk/dv
    (a grid of several blocks)."""
    dim, d = 64, 64
    jlayer = PatternAttention(dim=dim, seq_len=n, attn_type="full", heads=heads, dim_head=d)
    x = np.random.RandomState(1).randn(1, n, dim).astype(np.float32)
    params = jlayer.init(jax.random.key(0), jnp.asarray(x))
    jcalls = []
    real = jattention.flash_attention

    def spy(*args, **kw):
        jcalls.append(("tiled", kw["block_q"]))
        return real(*args, **kw)

    monkeypatch.setattr(jattention, "flash_attention", spy)
    monkeypatch.setattr(jattention, "fused_qkv_attention",
                        lambda *a, **kw: jcalls.append("packed"))
    jlayer.apply(params, jnp.asarray(x))
    assert jcalls == [("tiled", jattention._flash_block(n))]

    layer = Attention(dim, n, heads, d, device="cpu")
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkdv",
                 "flash_attention_bwd_fused"):
        monkeypatch.setattr(fa, name, (lambda f, name: lambda *a, **kw: (
            calls.append(name), f(*a, **kw))[1])(getattr(fa, name), name))
    layer(torch.from_numpy(x)).sum().backward()
    backward = (["flash_attention_bwd_fused"] if want == "tiled_one_block"
                else ["flash_attention_dq", "flash_attention_dkdv"])
    assert full_route(n, heads, d) == want
    assert calls == ["flash_attention_fwd", *backward]


# ----------------------------------------------------- the attention layer


DIM = 64


def _layer_pair(attn_type, heads, dim_head, text_len, fmap, seed):
    """(JAX PatternAttention, its params, the port's Attention on the same
    converted weights)."""
    seq_len = text_len + fmap**2
    jlayer = PatternAttention(dim=DIM, seq_len=seq_len, attn_type=attn_type, heads=heads,
                              dim_head=dim_head, image_fmap_size=fmap)
    rng = np.random.RandomState(seed)
    inner = heads * dim_head
    params = {
        "to_qkv": {"kernel": rng.randn(DIM, 3 * inner).astype(np.float32) * 0.2},
        "to_out": {"kernel": rng.randn(inner, DIM).astype(np.float32) * 0.2,
                   "bias": rng.randn(DIM).astype(np.float32) * 0.1},
    }
    layer = Attention(DIM, seq_len, heads, dim_head, attn_type=attn_type,
                      image_fmap_size=fmap, device="cpu")
    layer.load_state_dict({
        "to_qkv.weight": torch.from_numpy(params["to_qkv"]["kernel"].T.copy()),
        "to_out.weight": torch.from_numpy(params["to_out"]["kernel"].T.copy()),
        "to_out.bias": torch.from_numpy(params["to_out"]["bias"]),
    })
    return jlayer, params, layer


# (attention type, heads, dim_head, text length with <bos>, grid, n)
LAYER_CASES = {
    "full_n1152": ("full", 2, 32, 129, 32, 1152),
    "axial_col_n1152": ("axial_col", 2, 32, 129, 32, 1152),
    "three_heads_n384": ("full", 3, 32, 129, 16, 384),
}


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_attention_layer_matches_jax(monkeypatch, name, with_mask):
    """Converted weights, the DALL-E rotary table, a text key mask that
    keeps <bos> (x float32): the output within atol 2e-5 and the gradients
    of x and of every parameter within 1e-4 of their largest entry. JAX
    evaluates its pair-grid rule as on the TPU; the axial_col layout
    visits every causal pair, so both decline it."""
    monkeypatch.setenv("DALLE_TPU_SPARSE_KERNEL", "1")
    attn_type, heads, d, text_len, fmap, n = LAYER_CASES[name]
    jlayer, params, layer = _layer_pair(attn_type, heads, d, text_len, fmap, seed=3)
    assert full_route(n, heads, d).startswith("tiled") and not layer.uses_block_sparse(n)
    rng = np.random.RandomState(4)
    x = rng.randn(2, n, DIM).astype(np.float32)
    w = rng.randn(2, n, DIM).astype(np.float32)
    km = None
    if with_mask:
        km = np.ones((2, n), bool)
        km[0, 3:text_len:2] = False
        km[1, text_len - 6:text_len] = False
    table = dalle_rotary_table(d, text_len, fmap)
    padded = StaticTable(np.pad(table, ((0, 0), (0, d - table.shape[1]))))
    jkm = None if km is None else jnp.asarray(km)

    def j_loss(p, x):
        out = jlayer.apply({"params": p}, x, mask=jkm, rotary_pos_emb=padded)
        return (out * w).sum(), out

    (_, ref), (jgp, jgx) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    rot = rot_tables(torch.from_numpy(table), n, d, torch.float32)
    tx = torch.from_numpy(x).requires_grad_()
    out = layer(tx, rotary=rot, mask=None if km is None else torch.from_numpy(km))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert _grad_err(tx.grad.numpy(), jgx) <= 1e-4
    grads = {"to_qkv.weight": jgp["to_qkv"]["kernel"].T, "to_out.weight": jgp["to_out"]["kernel"].T,
             "to_out.bias": jgp["to_out"]["bias"]}
    for key, p in layer.named_parameters():
        assert _grad_err(p.grad.numpy(), np.asarray(grads[key])) <= 1e-4, key


# ------------------------------------------------------------- the slice


SLICES = {
    # n = 128 + 32 x 32 = 1152: 3 x 3 flash blocks of 384, dq then dk/dv
    "n1152": dict(dim=128, depth=2, num_text_tokens=50, text_seq_len=128,
                  num_image_tokens=40, image_fmap_size=32, heads=2, dim_head=64,
                  shift_tokens=True, rotary_emb=True),
    # n = 128 + 16 x 16 = 384 at 3 heads: one flash block the packed kernel
    # refuses, the single-block backward
    "n384_three_heads": dict(dim=128, depth=2, num_text_tokens=50, text_seq_len=128,
                             num_image_tokens=40, image_fmap_size=16, heads=3,
                             dim_head=64, shift_tokens=True, rotary_emb=True),
}
LR, CLIP = 3e-4, 0.5


def _batch(config, seed, b=2):
    """Seeded captions with zero tails and image tokens."""
    rng = np.random.RandomState(seed)
    t = config["text_seq_len"]
    text = rng.randint(1, config["num_text_tokens"], size=(b, t)).astype(np.int32)
    for i in range(b):
        text[i, rng.randint(5, t):] = 0
    image = rng.randint(0, config["num_image_tokens"],
                        size=(b, config["image_fmap_size"] ** 2)).astype(np.int32)
    return text, image


@pytest.fixture(scope="module", params=list(SLICES))
def slice_model(request):
    """(config, JAX DALLE, its params with every leaf perturbed)."""
    config = SLICES[request.param]
    jmodel = JDALLE(**config)
    text, image = _batch(config, 0)
    params = jmodel.init(jax.random.key(0), jnp.asarray(text), jnp.asarray(image))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params,
    )
    return config, jmodel, params


def _port(config, params) -> DALLE:
    model = DALLE(**config, device="cpu")
    model.load_state_dict(dalle_state_dict(params))
    return model


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def test_slice_logits_loss_and_every_gradient_match(slice_model):
    config, jmodel, params = slice_model
    model = _port(config, params)
    n = model.total_seq_len
    assert full_route(n, config["heads"], config["dim_head"]) == (
        "tiled" if n == 1152 else "tiled_one_block")
    text, image = _batch(config, 2)
    ref_logits = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image))

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(text), jnp.asarray(image),
                            return_loss=True)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref = dalle_state_dict(jax.device_get(ref_grads))
    with torch.no_grad():
        logits = model(*_t(text, image))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)
    loss = model(*_t(text, image), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert sorted(k for k, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        err = (p.grad - ref[name]).abs().max().item()
        assert err <= 1e-4 * ref[name].abs().max().item() + 1e-12, (name, err)


def test_slice_three_steps_match_jax_step(slice_model):
    """Params and Adam moments after 3 clipped-Adam steps (lr 3e-4, clip
    0.5) against JAX ``make_train_step``: per tensor, the relative L2
    error of the 3 steps' update within 1e-3 and of each moment within
    1e-5, losses to rtol 1e-5 (``tests/test_torch_train.py``'s bounds)."""
    config, jmodel, params = slice_model
    batches = [_batch(config, 10 + i) for i in range(3)]
    runtime = make_runtime(devices=jax.devices()[:1])
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.scale_by_adam())

    def j_loss(p, batch, rng):
        return jmodel.apply({"params": p}, batch["text"], batch["image"], return_loss=True)

    jstate, shardings = j_create_state(jax.device_get(params), opt, runtime)
    jstep = j_make_step(j_loss, opt, runtime, shardings, dynamic_lr=True)
    model = _port(config, params)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = create_train_state(model)
    step = make_train_step(train_dalle.dalle_loss, CLIP)
    for i, (text, image) in enumerate(batches):
        jstate, jloss = jstep(jstate, {"text": jnp.asarray(text), "image": jnp.asarray(image)},
                              jax.random.key(i), jnp.asarray(LR, jnp.float32))
        text_t, image_t = _t(text, image)
        state, loss = step(state, model, {"text": text_t, "image": image_t}, LR)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    adam = jstate.opt_state[1]
    assert int(state.opt_state.count) == int(adam.count) == 3
    for ours, theirs, origin, tol in (
        (state.params, jstate.params, before, 1e-3),
        (state.opt_state.mu, adam.mu, None, 1e-5),
        (state.opt_state.nu, adam.nu, None, 1e-5),
    ):
        ref = dalle_state_dict(jax.device_get(theirs))
        for name, t in ours.items():
            got, want = t.detach(), ref[name]
            if origin is not None:
                got, want = got - origin[name], want - origin[name]
            err = ((got - want).norm() / want.norm()).item()
            assert err <= tol, (name, err)
