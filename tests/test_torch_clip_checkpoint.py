"""CLIP checkpoints of the port against the JAX package on the CPU:
``models.factory.save_clip_checkpoint`` / ``clip_from_checkpoint`` /
``restore_opt_state`` both ways with JAX's ``save_clip_checkpoint`` /
``clip_from_checkpoint`` / ``restore_opt_state``, on the tiny CLIP of
test_torch_clip.py (every leaf perturbed), float32 and bfloat16 compute
on float32 parameters: the params bitwise, the configuration equal, and
the ``chain(clip_by_global_norm, adam(lr))`` state (count, mu, nu)
bitwise, JAX's after two optax updates and the port's after two steps of
its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_pytorch_tpu.models.factory import clip_from_checkpoint as j_clip_from_checkpoint
from dalle_pytorch_tpu.models.factory import restore_opt_state as j_restore_opt_state
from dalle_pytorch_tpu.models.factory import save_clip_checkpoint as j_save_clip
from dalle_pytorch_tpu_torch.convert import clip_params, clip_state_dict
from dalle_pytorch_tpu_torch.models import factory
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step
from test_torch_clip import CANON, converted, inputs

torch.set_num_threads(2)

CONFIGS = {"dense": CANON}


def _jax_adam_state(params, steps=2):
    """optax's ``chain(clip_by_global_norm(0.5), adam(1e-3))`` state after
    ``steps`` updates of seeded gradients."""
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3))
    state = opt.init(params)
    rng = np.random.RandomState(2)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32), params)
        _, state = opt.update(grads, state, params)
    return opt, jax.device_get(state)


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, tuple, list)) and not hasattr(v, "shape"):
            out.update(_flat(v if not hasattr(v, "_asdict") else v._asdict(), f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = np.asarray(v)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_reads_in_the_port(dtype, tmp_path):
    config = CONFIGS["dense"]
    jclip, params, _ = converted(config, seed=4)
    jclip = jclip.clone(dtype=getattr(jnp, dtype))
    _, opt_state = _jax_adam_state(params)
    j_save_clip(str(tmp_path / "jax.ckpt"), jclip, params, extra={"epoch": 2},
                opt_state=opt_state)
    clip, meta = factory.clip_from_checkpoint(tmp_path / "jax.ckpt", device="cpu")
    assert meta["epoch"] == 2 and clip.dtype == getattr(torch, dtype)
    assert clip.param_dtype == torch.float32
    for k, t in clip_state_dict(params).items():
        assert torch.equal(clip.state_dict()[k], t), k
    assert factory.clip_config(clip) == meta["config"]
    adam = factory.restore_opt_state(tmp_path / "jax.ckpt", device="cpu")
    inner = opt_state[1][0]
    assert int(adam.count) == int(inner.count) == 2
    for ours, theirs in ((adam.mu, inner.mu), (adam.nu, inner.nu)):
        ref = clip_state_dict(theirs)
        assert sorted(ours) == sorted(ref)
        assert all(torch.equal(ours[k], ref[k]) for k in ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_reads_in_jax(dtype, tmp_path):
    config = CONFIGS["dense"]
    _, params, _ = converted(config, seed=5)
    clip = CLIP(**config, device="cpu", dtype=getattr(torch, dtype), param_dtype=torch.float32)
    clip.load_state_dict(clip_state_dict(params))
    # an optimizer state of the port's own step
    state = create_train_state(clip)
    text, image = inputs(config, b=2, seed=6)
    t = torch.from_numpy(text).long()
    step = make_train_step(lambda m, b: m(b["t"], b["i"], text_mask=b["t"] != 0,
                                          return_loss=True), 0.5)
    for _ in range(2):
        state, _ = step(state, clip, {"t": t, "i": torch.from_numpy(image).to(clip.dtype)}, 1e-3)
    factory.save_clip_checkpoint(tmp_path / "port.ckpt", clip, extra={"epoch": 0},
                                 opt_state=state.opt_state)
    jclip, jparams, meta = j_clip_from_checkpoint(str(tmp_path / "port.ckpt"))
    assert meta["epoch"] == 0 and jclip.dtype == getattr(jnp, dtype)
    ref = clip_params(clip.state_dict())
    assert _flat(jax.device_get(jparams)).keys() == _flat(ref).keys()
    for k, v in _flat(jax.device_get(jparams)).items():
        np.testing.assert_array_equal(v, _flat(ref)[k])
    opt, template = _jax_adam_state(jax.device_get(jparams), steps=0)
    restored = j_restore_opt_state(str(tmp_path / "port.ckpt"), template)
    inner = restored[1][0]
    assert int(inner.count) == int(state.opt_state.count) == 2
    for theirs, ours in ((inner.mu, state.opt_state.mu), (inner.nu, state.opt_state.nu)):
        ref = clip_state_dict(jax.device_get(theirs))
        assert all(torch.equal(ours[k], ref[k]) for k in ours)
    # and the port's reader gives back what it wrote
    back, _ = factory.clip_from_checkpoint(tmp_path / "port.ckpt", device="cpu")
    assert all(torch.equal(back.state_dict()[k], v) for k, v in clip.state_dict().items())
    adam = factory.restore_opt_state(tmp_path / "port.ckpt", device="cpu")
    assert all(torch.equal(adam.mu[k], v) for k, v in state.opt_state.mu.items())
