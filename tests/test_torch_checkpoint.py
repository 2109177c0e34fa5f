"""The port's checkpoints against the JAX package's, on the CPU.

- ``utils/msgpack.py`` against ``flax.serialization``: a tree gives the
  bytes flax gives it; each side reads the other's bytes to equal trees
  (float32, bfloat16, int, bool and uint8 arrays, 0-d arrays, numpy
  scalars, str, bin, int, float, bool, nil, lists, nested maps), and the
  chunked form of large arrays both ways (``MAX_CHUNK_SIZE`` lowered on
  both sides).
- A port-written DALLE ``.ckpt`` (params, bundled VAE, Adam state, step)
  read by JAX's ``dalle_from_checkpoint`` / ``restore_opt_state`` /
  ``vae_from_checkpoint``: JAX's logits on it within atol 1e-4 of the
  port's, the moments bitwise, the VAE's codes equal; a JAX-written one
  read by the port the same way. Learned positions (train_dalle.py's
  default) and token shift with rotary.
- The file and directory manifests and ``check_checkpoint_file``: the same
  bytes from both writers, each side's verifier accepting the other's
  files and refusing the same corruptions.
- Step directories: ``keep_n`` rotation, a torn directory skipped and
  removed, the ``ckpt_corrupt`` fault caught by the checksums (the
  newest verified directory wins), and the train state restored bitwise.
- Refused configurations raise ``NotImplementedError``.
- ``utils/resilience.py``: ``retry``'s attempts and backoff schedule
  equal JAX's under the same seeded jitter; ``PreemptionHandler`` sets its
  flag on the first SIGTERM and raises ``KeyboardInterrupt`` on the
  second, and restores the previous handler.
- ``convert``: a flax -> torch -> flax round trip of the DALLE (token
  shift and rotary on and off) and the VAE (with and without residual
  blocks) is bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.models import factory as jfactory
from dalle_pytorch_tpu.utils import checkpoint as jckpt
from dalle_pytorch_tpu.utils import resilience as jres
from dalle_pytorch_tpu_torch.convert import (
    dalle_params,
    dalle_state_dict,
    vae_params,
    vae_state_dict,
)
from dalle_pytorch_tpu_torch.models import factory
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.parallel.step import (
    create_train_state,
    load_train_state,
    make_train_step,
    train_state_tree,
)
from dalle_pytorch_tpu_torch.train_dalle import dalle_loss
from dalle_pytorch_tpu_torch.utils import checkpoint as ckpt
from dalle_pytorch_tpu_torch.utils import msgpack, resilience
from dalle_pytorch_tpu_torch.utils.faults import FaultRegistry

torch.set_num_threads(2)

VAE_CONFIG = dict(image_size=16, num_layers=2, num_resnet_blocks=1, hidden_dim=8,
                  num_tokens=40, codebook_dim=8)
CONFIGS = {
    "learned_pos": dict(dim=64, depth=2, num_text_tokens=50, text_seq_len=12,
                        num_image_tokens=40, image_fmap_size=4, heads=2, dim_head=32,
                        shift_tokens=False, rotary_emb=False, attn_types=("full",),
                        loss_img_weight=7),
    "shift_rotary": dict(dim=64, depth=2, num_text_tokens=50, text_seq_len=12,
                         num_image_tokens=40, image_fmap_size=4, heads=2, dim_head=32,
                         shift_tokens=True, rotary_emb=True),
}


def _tree():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.randn(4, 2), jnp.bfloat16)),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3), "zero_d": np.asarray(7, np.int32),
        "u8": rng.randint(0, 256, size=(300,)).astype(np.uint8),
        "b": np.array([True, False]), "scalar": np.float32(2.5), "empty": {},
        "meta": "héllo " * 10, "bin": b"\x00\xff" * 150, "ints": [0, -1, 127, -33, 255, 70000,
                                                                -2**40],
        "float": 0.1, "flag": False, "none": None, "nested": {str(i): {"k": i} for i in range(18)},
    }


def _as_torch(x):
    if isinstance(x, dict):
        return {k: _as_torch(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_as_torch(v) for v in x]
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return x


def _equal(a, b) -> bool:
    """``a`` (numpy / flax side) equals ``b`` (the port's side)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return b.dtype == torch.bfloat16 and np.array_equal(
                a.view(np.int16), b.view(torch.int16).numpy())
        return tuple(b.shape) == a.shape and np.array_equal(a, b.numpy()) and (
            str(b.dtype).split(".")[-1] == a.dtype.name)
    return type(a) is type(b) and a == b


def test_msgpack_bytes_equal_flax_and_each_side_reads_the_other():
    tree = _tree()
    ref = serialization.msgpack_serialize(tree)
    assert msgpack.dumps(tree) == ref
    assert msgpack.dumps(_as_torch({k: v for k, v in tree.items() if k != "scalar"})) == (
        serialization.msgpack_serialize({k: v for k, v in tree.items() if k != "scalar"}))
    assert _equal({k: v for k, v in tree.items()}, msgpack.loads(ref))
    back = serialization.msgpack_restore(msgpack.dumps(_as_torch(tree)))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), tree, back))


def test_msgpack_chunked_arrays_both_ways(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 100)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 100)
    rng = np.random.RandomState(1)
    tree = {"big": rng.randn(7, 11).astype(np.float32), "w": {"x": rng.randn(60)},
            "small": np.arange(3, dtype=np.int64)}
    ref = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in ref and msgpack.dumps(tree) == ref
    assert _equal(tree, msgpack.loads(ref))
    back = serialization.msgpack_restore(msgpack.dumps(_as_torch(tree)))
    assert np.array_equal(back["big"], tree["big"])
    assert np.array_equal(back["w"]["x"], tree["w"]["x"])


def _port_trained(config, seed=0):
    """A port DALLE and VAE on the CPU after two clipped-Adam steps (so the
    moments and count are not zero), the train state."""
    vae = DiscreteVAE(**VAE_CONFIG, device="cpu").init_weights(torch.Generator().manual_seed(seed))
    model = DALLE(**config, device="cpu").init_weights(torch.Generator().manual_seed(seed + 1))
    state = create_train_state(model)
    step = make_train_step(dalle_loss, 0.5)
    text, image = _batch(config, seed)
    for _ in range(2):
        state, _ = step(state, model, {"text": torch.from_numpy(text).long(),
                                       "image": torch.from_numpy(image).long()}, 1e-3)
    return model, vae, state


def _batch(config, seed):
    rng = np.random.RandomState(seed + 5)
    text = rng.randint(1, config["num_text_tokens"], size=(2, config["text_seq_len"]))
    text[0, 5:] = 0
    image = rng.randint(0, config["num_image_tokens"], size=(2, config["image_fmap_size"] ** 2))
    return text.astype(np.int32), image.astype(np.int32)


def _opt_template(params):
    return optax.chain(optax.clip_by_global_norm(0.5), optax.scale_by_adam()).init(params)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_reads_a_port_checkpoint(name, tmp_path):
    config = CONFIGS[name]
    model, vae, state = _port_trained(config)
    path = tmp_path / "port.ckpt"
    factory.save_dalle_checkpoint(path, model, vae, extra={"epoch": 3, "scheduler_state": {
        "lr": 3e-4}}, opt_state=state.opt_state, step=int(state.step))
    jmodel, jparams, jvae, jvae_params, meta = jfactory.dalle_from_checkpoint(str(path))
    assert meta["epoch"] == 3 and meta["config"] == factory.dalle_config(model)
    text, image = _batch(config, 9)
    ref = jmodel.apply({"params": jparams}, jnp.asarray(text), jnp.asarray(image))
    with torch.no_grad():
        logits = model(torch.from_numpy(text).long(), torch.from_numpy(image).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    jopt = jfactory.restore_opt_state(str(path), _opt_template(jparams))
    assert int(jopt[1].count) == int(state.opt_state.count) == 2
    for moment, own in ((jopt[1].mu, state.opt_state.mu), (jopt[1].nu, state.opt_state.nu)):
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, jax.device_get(moment), dalle_params(own)))
    imgs = np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32)
    codes = jvae.apply({"params": jvae_params}, jnp.asarray(imgs), method="get_codebook_indices")
    np.testing.assert_array_equal(np.asarray(codes),
                                  vae.get_codebook_indices(torch.from_numpy(imgs)).numpy())
    state_tree, _ = jckpt.load_checkpoint(str(path))
    assert state_tree["step"] == 2


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_reads_a_jax_checkpoint(name, tmp_path):
    cfg = {k: v for k, v in CONFIGS[name].items()}
    jmodel = JDALLE(**cfg)
    text, image = _batch(cfg, 3)
    params = jmodel.init(jax.random.key(0), jnp.asarray(text), jnp.asarray(image))["params"]
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
        np.float32), params)
    opt = _opt_template(params)
    opt = (opt[0], opt[1]._replace(
        count=jnp.asarray(5, jnp.int32),
        mu=jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), params),
        nu=jax.tree_util.tree_map(lambda a: rng.rand(*a.shape).astype(np.float32), params)))
    jvae = JVAE(**VAE_CONFIG)
    vparams = jvae.init({"params": jax.random.key(1), "gumbel": jax.random.key(2)},
                        jnp.zeros((1, 16, 16, 3)))["params"]
    path = tmp_path / "jax.ckpt"
    jfactory.save_dalle_checkpoint(str(path), jmodel, params, jvae, jax.device_get(vparams),
                                   extra={"epoch": 1}, opt_state=jax.device_get(opt), step=5)
    ckpt.check_checkpoint_file(path, require_manifest=True)
    model, vae, meta = factory.dalle_from_checkpoint(path, device="cpu")
    assert meta["epoch"] == 1 and factory.dalle_config(model) == meta["config"]
    assert factory.vae_config(vae) == meta["vae_config"]
    ref = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image))
    with torch.no_grad():
        logits = model(torch.from_numpy(text).long(), torch.from_numpy(image).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    adam = factory.restore_opt_state(path, device="cpu")
    assert int(adam.count) == 5
    for moment, own in ((opt[1].mu, adam.mu), (opt[1].nu, adam.nu)):
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, jax.device_get(moment), dalle_params(own)))
    sd = vae.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in vae_state_dict(jax.device_get(vparams)).items())


def test_vae_checkpoints_cross_read(tmp_path):
    vae = DiscreteVAE(**VAE_CONFIG, device="cpu").init_weights(torch.Generator().manual_seed(3))
    factory.save_vae_checkpoint(tmp_path / "vae.ckpt", vae)
    jvae, jparams, meta = jfactory.vae_from_checkpoint(str(tmp_path / "vae.ckpt"))
    assert meta["config"] == json.loads(json.dumps(jfactory._config_dict(JVAE(**VAE_CONFIG))))
    imgs = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    codes = jvae.apply({"params": jparams}, jnp.asarray(imgs), method="get_codebook_indices")
    np.testing.assert_array_equal(np.asarray(codes),
                                  vae.get_codebook_indices(torch.from_numpy(imgs)).numpy())
    jfactory.save_vae_checkpoint(str(tmp_path / "j.ckpt"), jvae, jax.device_get(jparams))
    back, _ = factory.vae_from_checkpoint(tmp_path / "j.ckpt", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                  vae.state_dict().values()))


def test_manifests_agree_across_sides(tmp_path):
    tree = {"x": np.arange(10, dtype=np.float32)}
    ckpt.save_checkpoint(tmp_path / "p.ckpt", tree, {"a": 1})
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), tree, {"a": 1})
    assert (tmp_path / "p.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()
    for side in ("p", "j"):
        sidecar = tmp_path / f"{side}.ckpt.manifest.json"
        assert json.loads(sidecar.read_text()) == json.loads(
            (tmp_path / "p.ckpt.manifest.json").read_text())
        for verify in (resilience.verify_file_manifest, jres.verify_file_manifest):
            assert verify(str(tmp_path / f"{side}.ckpt")) == (True, "ok")
    assert (tmp_path / "p.ckpt.manifest.json").read_bytes() == (
        tmp_path / "j.ckpt.manifest.json").read_bytes()
    data = bytearray((tmp_path / "p.ckpt").read_bytes())
    data[-1] ^= 1
    (tmp_path / "p.ckpt").write_bytes(bytes(data))
    with pytest.raises(ckpt.CheckpointError, match="checksum mismatch"):
        ckpt.check_checkpoint_file(tmp_path / "p.ckpt")
    with pytest.raises(jckpt.CheckpointError, match="checksum mismatch"):
        jckpt.check_checkpoint_file(str(tmp_path / "p.ckpt"))
    (tmp_path / "j.ckpt").write_bytes((tmp_path / "j.ckpt").read_bytes()[:-3])
    assert resilience.verify_file_manifest(tmp_path / "j.ckpt")[1].startswith("size mismatch")
    (tmp_path / "n.ckpt").write_bytes(b"x")
    ckpt.check_checkpoint_file(tmp_path / "n.ckpt")  # no manifest: a warning
    with pytest.raises(ckpt.CheckpointError, match="no manifest"):
        ckpt.check_checkpoint_file(tmp_path / "n.ckpt", require_manifest=True)
    for writer, verifier in ((resilience.write_dir_manifest, jres.verify_dir_manifest),
                             (jres.write_dir_manifest, resilience.verify_dir_manifest)):
        d = tmp_path / f"dir_{writer.__module__.split('.')[0]}"
        (d / "sub").mkdir(parents=True)
        (d / "sub" / "a.bin").write_bytes(b"abc")
        (d / "b.bin").write_bytes(b"xyz" * 100)
        writer(str(d), extra={"step": 3, "meta": {"epoch": 0}})
        assert verifier(str(d)) == (True, "ok")
        (d / "b.bin").write_bytes(b"xyz" * 99 + b"xyZ")
        assert verifier(str(d)) == (False, "checksum mismatch b.bin")
    assert (tmp_path / "dir_dalle_pytorch_tpu_torch" / "MANIFEST.json").read_bytes() == (
        tmp_path / "dir_dalle_pytorch_tpu" / "MANIFEST.json").read_bytes()


def _state_tree():
    model, _, state = _port_trained(CONFIGS["learned_pos"], seed=2)
    return model, state


def test_step_directories_rotate_skip_torn_and_catch_corruption(tmp_path):
    model, state = _state_tree()
    root = tmp_path / "cp"
    (root / "step_00000009").mkdir(parents=True)  # torn: no COMMITTED
    for step in (1, 2, 3):
        ckpt.save_sharded_checkpoint(root, step, train_state_tree(state), meta={"epoch": step},
                                     keep_n=2)
    assert sorted(p.name for p in root.glob("step_*")) == ["step_00000002", "step_00000003"]
    assert json.loads((root / "aux.json").read_text()) == {"meta": {"epoch": 3}, "latest": 3}
    faults = FaultRegistry.from_env({"DALLE_TPU_FAULTS": "ckpt_corrupt=1"})
    ckpt.save_sharded_checkpoint(root, 4, train_state_tree(state), meta={"epoch": 4},
                                 faults=faults)
    assert faults.fired == {"ckpt_corrupt": 1}
    ok, reason = ckpt.verify_step_dir(root / "step_00000004")
    assert not ok and reason == "checksum mismatch train_state.msgpack"
    assert ckpt.latest_verified_step(root) == 3
    (root / "step_00000005").mkdir()  # torn again
    tree, meta, step = ckpt.load_sharded_checkpoint(root)
    assert step == 3 and meta == {"epoch": 3}
    with pytest.raises(ckpt.CheckpointError, match="failed verification"):
        ckpt.load_sharded_checkpoint(root, step=4)
    fresh = create_train_state(DALLE(**CONFIGS["learned_pos"], device="cpu"))
    restored = load_train_state(fresh, tree)
    for part in ("params",):
        assert all(torch.equal(getattr(restored, part)[k], getattr(state, part)[k])
                   for k in state.params)
    assert all(torch.equal(restored.opt_state.mu[k], state.opt_state.mu[k]) for k in state.params)
    assert all(torch.equal(restored.opt_state.nu[k], state.opt_state.nu[k]) for k in state.params)
    assert (int(restored.step), int(restored.opt_state.count), int(restored.skipped)) == (
        int(state.step), int(state.opt_state.count), int(state.skipped))
    assert ckpt.latest_verified_step(tmp_path / "none") is None


def test_fault_registry_reads_the_jax_format():
    faults = FaultRegistry.from_env({"DALLE_TPU_FAULTS": "nan_at_step=5, ckpt_corrupt=2"})
    assert faults.value("nan_at_step") == 5 and not faults.take("nan_at_step")
    assert faults.take("ckpt_corrupt") and faults.take("ckpt_corrupt")
    assert not faults.take("ckpt_corrupt")
    assert FaultRegistry.from_env({}).value("nan_at_step") is None
    for bad in ("download=1", "nan_at_step"):
        with pytest.raises(ValueError):
            FaultRegistry.from_env({"DALLE_TPU_FAULTS": bad})


@pytest.mark.parametrize("field,value", [
    ("ff_experts", 4),
    ("serve_quant", True), ("attn_types", ["full", "mlp"]),
    ("dtype", "float16"),
])
def test_refused_dalle_configs_raise(field, value):
    config = {**factory.DALLE_FIELDS, **CONFIGS["learned_pos"], field: value}
    with pytest.raises(NotImplementedError, match=field if field != "attn_types" else "gMLP"):
        factory.build_dalle(config, device="cpu")


def test_refused_vae_configs_raise():
    # the pretrained VAEs are built since they were ported; parameters in
    # another type than float32 stay refused
    assert type(factory.build_vae("OpenAIDiscreteVAE", {}, device="meta")).__name__ == \
        "OpenAIDiscreteVAE"
    with pytest.raises(NotImplementedError, match="OpenAIDiscreteVAE"):
        factory.build_vae("OpenAIDiscreteVAE", {"param_dtype": "bfloat16"}, device="cpu")
    with pytest.raises(NotImplementedError, match="normalization"):
        factory.build_vae("DiscreteVAE", {**VAE_CONFIG, "normalization": [[0.4] * 3, [0.5] * 3]},
                          device="cpu")
    config = {**factory.DALLE_FIELDS, **CONFIGS["learned_pos"], "sp_axis": "sp"}
    assert factory.build_dalle(config, device="cpu").dim == 64  # a run's layout: ignored


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shift,rotary", [(False, False), (True, True), (True, False),
                                          (False, True)])
def test_dalle_flax_torch_flax_round_trip_is_bitwise(shift, rotary):
    cfg = {**CONFIGS["learned_pos"], "shift_tokens": shift, "rotary_emb": rotary}
    text, image = _batch(cfg, 0)
    params = jax.device_get(JDALLE(**cfg).init(jax.random.key(3), jnp.asarray(text),
                                               jnp.asarray(image))["params"])
    model = DALLE(**cfg, device="cpu")
    model.load_state_dict(dalle_state_dict(params))
    assert _tree_equal(jax.tree_util.tree_map(np.asarray, params),
                       dalle_params(model.state_dict()))


@pytest.mark.parametrize("blocks", [0, 1])
def test_vae_flax_torch_flax_round_trip_is_bitwise(blocks):
    cfg = {**VAE_CONFIG, "num_resnet_blocks": blocks}
    params = jax.device_get(JVAE(**cfg).init({"params": jax.random.key(0),
                                              "gumbel": jax.random.key(1)},
                                             jnp.zeros((1, 16, 16, 3)))["params"])
    vae = DiscreteVAE(**cfg, device="cpu")
    vae.load_state_dict(vae_state_dict(params))
    assert _tree_equal(jax.tree_util.tree_map(np.asarray, params), vae_params(vae.state_dict()))


def test_retry_schedule_equals_jax():
    import random

    runs = {}
    for side, mod in (("port", resilience), ("jax", jres)):
        calls, sleeps = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "done"

        policy = mod.RetryPolicy(attempts=4, base_delay=0.5, max_delay=0.8, jitter=0.5)
        out = mod.retry(flaky, policy, sleep=sleeps.append, rng=random.Random(3))
        runs[side] = (out, len(calls), sleeps)
        with pytest.raises(OSError):
            mod.retry(lambda: (_ for _ in ()).throw(OSError("down")),
                      mod.RetryPolicy(attempts=2), sleep=lambda s: None)
    assert runs["port"] == runs["jax"] and runs["port"][1] == 3


def test_preemption_handler_flags_then_interrupts():
    import os
    import signal

    before = signal.getsignal(signal.SIGTERM)
    with resilience.PreemptionHandler() as preempt:
        os.kill(os.getpid(), signal.SIGTERM)
        assert preempt.triggered and preempt.signum == signal.SIGTERM
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is before
