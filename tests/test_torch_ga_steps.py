"""Gradient accumulation (``--ga_steps``: optax's ``MultiSteps`` around the
clipped Adam, ``parallel/step.py``) against the JAX package on the CPU,
float32, with both dropout rates 0.1.

- 6 micro-steps of ``ga_steps`` 2 against JAX's ``make_train_step`` with
  ``optax.MultiSteps(chain(clip_by_global_norm(0.5), scale_by_adam()),
  2)`` on the same weights and batches, the port fed each micro-step's
  JAX dropout masks (``testing.dropout_masks``): every loss within rtol
  1e-5; after every micro-step Adam's count, ``mini_step`` and
  ``gradient_step`` equal JAX's, and the parameters stay bitwise where
  they were on the micro-steps that do not emit; at the end the 6 steps'
  update and the moments within ``tests/test_torch_train.py``'s relative
  L2 (1e-3, 1e-5); the accumulator after micro-step 5 within 1e-4 of its
  largest entry (the gradients' tolerance);
- a micro-step the NaN guard rejects leaves params, moments, accumulator
  and every counter bitwise as they were, ``mini_step`` included;
- a micro-step that does not emit skips the clip and Adam (``emit=False``)
  and ends bitwise where the whole body, selected on the device, ends; a
  wrong ``emit=False`` fails the device-side check; ``DalleTrainer``
  keeps ``mini_step`` on the host from its verdicts;
- a ``.ckpt`` JAX wrote after micro-step 3 (its ``MultiStepsState`` under
  flax's names) resumes in the port with ``mini_step`` 1 and the
  accumulator bitwise, and its micro-steps 4-6 end within the same
  tolerances of JAX's; a port-written one loads in JAX's
  ``restore_opt_state`` bitwise, and the train state's step-directory
  tree round-trips;
- the trainer's command line with ``--ga_steps 2 --attn_dropout 0.1
  --ff_dropout 0.1`` (a PNG folder): preempted by SIGTERM at its third
  micro-step (an emergency step directory holding ``mini_step`` 1) and
  relaunched, it ends bitwise the uninterrupted run: params, moments,
  accumulator, counters.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dalle_pytorch_tpu.models.factory import restore_opt_state as j_restore_opt_state
from dalle_pytorch_tpu.models.factory import save_dalle_checkpoint as j_save_dalle
from dalle_pytorch_tpu.parallel import create_train_state as j_create_state
from dalle_pytorch_tpu.parallel import make_runtime
from dalle_pytorch_tpu.parallel import make_train_step as j_make_step
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models.factory import (
    dalle_from_checkpoint,
    restore_opt_state,
    save_dalle_checkpoint,
    save_vae_checkpoint,
)
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.parallel.step import (
    MultiStepsState,
    create_train_state,
    load_opt_state,
    load_train_state,
    make_train_step,
    train_state_tree,
)
from dalle_pytorch_tpu_torch.testing import dropout_masks, write_caption_folder
from dalle_pytorch_tpu_torch.utils.checkpoint import latest_verified_step, load_checkpoint
from test_torch_dropout import CONFIGS, RATES, batch, jax_dropout_masks, jax_params, port

torch.set_num_threads(2)

CONFIG = CONFIGS["dense"]
LR, CLIP, K, MICRO = 3e-4, 0.5, 2, 6


def _opt():
    return optax.MultiSteps(optax.chain(optax.clip_by_global_norm(CLIP), optax.scale_by_adam()),
                            every_k_schedule=K)


def _batch_t(i):
    text, image = batch(CONFIG, 30 + i)
    return {"text": torch.from_numpy(text).long(), "image": torch.from_numpy(image).long()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's 6 micro-steps: (initial params, losses, counters after each
    micro-step, the accumulator after micro-step 5, the final state, each
    micro-step's masks, the .ckpt written after micro-step 3)."""
    jmodel, params = jax_params(CONFIG)
    runtime = make_runtime(devices=jax.devices()[:1])

    def j_loss(p, b, rng):
        return jmodel.apply({"params": p}, b["text"], b["image"], return_loss=True,
                            deterministic=False, rngs={"dropout": rng})

    jstate, shardings = j_create_state(jax.device_get(params), _opt(), runtime)
    jstep = j_make_step(j_loss, _opt(), runtime, shardings, dynamic_lr=True)
    ckpt = tmp_path_factory.mktemp("ga") / "jax.ckpt"
    losses, counters, masks, acc5 = [], [], [], None
    for i in range(MICRO):
        text, image = batch(CONFIG, 30 + i)
        masks.append(jax_dropout_masks(jmodel, params, text, image, jax.random.key(i)))
        jstate, loss = jstep(jstate, {"text": jnp.asarray(text), "image": jnp.asarray(image)},
                             jax.random.key(i), jnp.asarray(LR, jnp.float32))
        losses.append(float(loss))
        opt = jstate.opt_state
        counters.append((int(opt.inner_opt_state[1].count), int(opt.mini_step),
                         int(opt.gradient_step)))
        if i == 2:
            j_save_dalle(str(ckpt), jmodel, jax.device_get(jstate.params),
                         opt_state=jax.device_get(jstate.opt_state), step=3)
        if i == 4:
            acc5 = dalle_state_dict(jax.device_get(opt.acc_grads))
    return dict(params=params, losses=losses, counters=counters, acc5=acc5,
                final=jax.device_get(jstate), masks=masks, ckpt=ckpt)


def _counters(state):
    opt = state.opt_state
    return int(opt.inner.count), int(opt.mini_step), int(opt.gradient_step)


def _rel(got, want, origin=None):
    if origin is not None:
        got, want = got - origin, want - origin
    return ((got - want).norm() / want.norm()).item()


def _check_final(model, state, final, before):
    adam = final.opt_state.inner_opt_state[1]
    for ours, theirs, origin, tol in ((state.params, final.params, before, 1e-3),
                                      (state.opt_state.inner.mu, adam.mu, None, 1e-5),
                                      (state.opt_state.inner.nu, adam.nu, None, 1e-5)):
        ref = dalle_state_dict(theirs)
        for name, t in ours.items():
            err = _rel(t.detach(), ref[name], None if origin is None else origin[name])
            assert err <= tol, (name, err)


def test_six_micro_steps_match_optax_multisteps(jax_run):
    model = port(jax_run["params"], CONFIG)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = create_train_state(model, ga_steps=K)
    assert isinstance(state.opt_state, MultiStepsState)
    step = make_train_step(train_dalle.dalle_loss, CLIP, ga_steps=K)
    for i in range(MICRO):
        prior = [p.detach().clone() for p in model.parameters()]
        with dropout_masks(replay=jax_run["masks"][i]) as drawn:
            state, loss = step(state, model, _batch_t(i), LR, torch.Generator().manual_seed(i),
                               emit=i % K == K - 1)
        assert len(drawn) == 2 * CONFIG["depth"]
        np.testing.assert_allclose(loss.item(), jax_run["losses"][i], rtol=1e-5)
        assert _counters(state) == jax_run["counters"][i]
        assert state.opt_state.mini_step.dtype == state.opt_state.gradient_step.dtype \
            == torch.int32
        moved = [not torch.equal(a, b) for a, b in zip(prior, model.parameters())]
        assert all(moved) if i % K == K - 1 else not any(moved)
        if i == 4:
            for name, a in state.opt_state.acc.items():
                ref = jax_run["acc5"][name]
                err = (a - ref).abs().max().item()
                assert err <= 1e-4 * ref.abs().max().item() + 1e-12, (name, err)
    assert jax_run["counters"][-1] == (3, 0, 3) and int(state.step) == MICRO
    assert all(not a.any() for a in state.opt_state.acc.values())  # zeroed at the emit
    _check_final(model, state, jax_run["final"], before)


def _snapshot(state):
    opt = state.opt_state
    tensors = [*state.params.values(), *opt.inner.mu.values(), *opt.inner.nu.values(),
               *opt.acc.values()]
    counters = [opt.inner.count, opt.mini_step, opt.gradient_step]
    return [t.detach().clone() for t in tensors + counters]


def test_rejected_micro_step_leaves_the_state_bitwise(jax_run):
    model = port(jax_run["params"], CONFIG)
    state = create_train_state(model, ga_steps=K)
    gen = torch.Generator().manual_seed(0)
    state, _ = make_train_step(train_dalle.dalle_loss, CLIP, ga_steps=K)(
        state, model, _batch_t(0), LR, gen, emit=False)
    assert _counters(state) == (0, 1, 0) and any(a.any() for a in state.opt_state.acc.values())
    before = _snapshot(state)
    step = make_train_step(train_dalle.dalle_loss, CLIP, ga_steps=K, nan_inject_step=1)
    state, loss = step(state, model, _batch_t(1), LR, torch.Generator().manual_seed(1))
    assert torch.isnan(loss) and int(state.skipped) == 1 and int(state.consec_skipped) == 1
    after = _snapshot(state)
    assert len(before) == len(after) and all(torch.equal(a, b) for a, b in zip(before, after))
    state, loss = step(state, model, _batch_t(1), LR, torch.Generator().manual_seed(1))
    assert torch.isfinite(loss) and _counters(state) == (1, 0, 1)
    # and a rejected micro-step that does not emit (the fourth dispatch)
    step = make_train_step(train_dalle.dalle_loss, CLIP, ga_steps=K, nan_inject_step=3)
    before = _snapshot(state)
    state, loss = step(state, model, _batch_t(2), LR, torch.Generator(), emit=False)
    assert torch.isnan(loss) and int(state.skipped) == 2 and _counters(state) == (1, 0, 1)
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(state)))


def test_skipped_inner_update_is_bitwise_the_guarded_one(jax_run):
    """A micro-step that does not emit launches no clip and no Adam
    (``emit=False``); its state is bitwise what the whole body, selected
    on the device by ``mini_step``, gives. ``emit=False`` where the
    device's ``mini_step`` is k - 1 fails the device-side check."""
    step = make_train_step(train_dalle.dalle_loss, CLIP, ga_steps=K)
    snaps = []
    for emit in (False, True):
        model = port(jax_run["params"], CONFIG)
        state = create_train_state(model, ga_steps=K)
        with dropout_masks(replay=jax_run["masks"][0]):
            state, loss = step(state, model, _batch_t(0), LR, torch.Generator(), emit=emit)
        snaps.append((loss, _snapshot(state), int(state.step)))
    (loss_a, a, step_a), (loss_b, b, step_b) = snaps
    assert torch.equal(loss_a, loss_b) and step_a == step_b == 1
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[-2]) == 1  # mini_step: the next micro-step emits
    with pytest.raises(RuntimeError):
        step(state, model, _batch_t(1), LR, torch.Generator(), emit=False)


def test_trainer_keeps_mini_step_on_the_host(jax_run):
    """``DalleTrainer`` counts ``mini_step`` by its verdicts (a rejected
    micro-step keeps it), reads it again from a state set from outside,
    and refuses a second dispatch before the first one's verdict."""
    trainer = train_dalle.DalleTrainer(_vae(), port(jax_run["params"], CONFIG), batch_size=3,
                                       device="cpu", nan_inject_step=1, ga_steps=K, **RATES)
    b = _batch_t(0)
    seen = []
    for _ in range(4):
        seen.append(trainer._mini_step)
        trainer.verdict(trainer.dispatch(b["text"], b["image"]))
        assert trainer._mini_step == int(trainer.state.opt_state.mini_step)
    assert seen == [0, 1, 1, 0] and trainer.retries == 1
    loss = trainer.dispatch(b["text"], b["image"])
    with pytest.raises(RuntimeError, match="verdict"):
        trainer.dispatch(b["text"], b["image"])
    trainer.verdict(loss)
    trainer.verdict(trainer.dispatch(b["text"], b["image"]))
    tree = train_state_tree(trainer.state)
    assert trainer._mini_step == int(tree["opt_state"]["mini_step"]) == 1
    fresh = train_dalle.DalleTrainer(_vae(), port(jax_run["params"], CONFIG), batch_size=3,
                                     device="cpu", ga_steps=K, **RATES)
    assert fresh._mini_step == 0
    fresh.state = load_train_state(fresh.state, tree)
    assert fresh._mini_step == 1


def test_jax_mid_accumulation_ckpt_resumes_in_the_port(jax_run):
    ckpt = jax_run["ckpt"]
    dalle, _, meta = dalle_from_checkpoint(ckpt, "cpu")
    assert (dalle.attn_dropout, dalle.ff_dropout) == (0.1, 0.1)
    saved = restore_opt_state(ckpt, "cpu")
    assert isinstance(saved, MultiStepsState)
    assert (int(saved.mini_step), int(saved.gradient_step), int(saved.inner.count)) == (1, 1, 1)
    raw, _ = load_checkpoint(ckpt)
    ref_acc = dalle_state_dict(raw["opt_state"]["acc_grads"])
    assert sorted(raw["opt_state"]) == ["acc_grads", "gradient_step", "inner_opt_state",
                                        "mini_step", "skip_state"]
    for name, a in saved.acc.items():
        assert torch.equal(a, ref_acc[name])
    before = {k: p.detach().clone() for k, p in port(jax_run["params"], CONFIG)
              .named_parameters()}
    state = load_opt_state(create_train_state(dalle, ga_steps=K), saved)
    state = state._replace(step=torch.tensor(3, dtype=torch.int32))
    step = make_train_step(train_dalle.dalle_loss, CLIP, ga_steps=K)
    for i in range(3, MICRO):
        with dropout_masks(replay=jax_run["masks"][i]):
            state, loss = step(state, dalle, _batch_t(i), LR, torch.Generator(),
                               emit=i % K == K - 1)
        np.testing.assert_allclose(loss.item(), jax_run["losses"][i], rtol=1e-5)
        assert _counters(state) == jax_run["counters"][i]
    _check_final(dalle, state, jax_run["final"], before)
    with pytest.raises(ValueError, match="MultiSteps"):
        load_opt_state(create_train_state(dalle), saved)


def test_port_written_ckpt_loads_in_jax(jax_run, tmp_path):
    model = port(jax_run["params"], CONFIG)
    state = create_train_state(model, ga_steps=K)
    step = make_train_step(train_dalle.dalle_loss, CLIP, ga_steps=K)
    for i in range(3):
        state, _ = step(state, model, _batch_t(i), LR, torch.Generator().manual_seed(i),
                        emit=i % K == K - 1)
    path = tmp_path / "port.ckpt"
    save_dalle_checkpoint(path, model, opt_state=state.opt_state, step=3)
    _, template_state = jax_params(CONFIG)
    target = jax.tree_util.tree_map(np.asarray, _opt().init(template_state))
    restored = j_restore_opt_state(str(path), target)
    assert type(restored).__name__ == "MultiStepsState"
    assert (int(restored.mini_step), int(restored.gradient_step)) == (1, 1)
    assert np.asarray(restored.mini_step).dtype == np.int32
    adam = restored.inner_opt_state[1]
    assert int(adam.count) == 1
    for ours, theirs in ((state.opt_state.acc, restored.acc_grads),
                         (state.opt_state.inner.mu, adam.mu), (state.opt_state.inner.nu, adam.nu)):
        ref = dalle_state_dict(theirs)
        assert all(torch.equal(t, ref[n]) for n, t in ours.items())
    assert serialization.to_state_dict(restored).keys() == load_checkpoint(path)[0][
        "opt_state"].keys()
    # the step-directory tree round-trips, the accumulator with it
    tree = train_state_tree(state)
    fresh = load_train_state(create_train_state(port(jax_run["params"], CONFIG), ga_steps=K),
                             {k: v for k, v in tree.items()})
    assert _counters(fresh) == _counters(state) == (1, 1, 1)
    assert all(torch.equal(fresh.opt_state.acc[n], a) for n, a in state.opt_state.acc.items())


# ------------------------------------------------------------- the trainer


def _vae():
    return DiscreteVAE(image_size=16, num_layers=2, hidden_dim=8, num_tokens=40,
                       codebook_dim=8, device="cpu").init_weights(torch.Generator().manual_seed(3))


DISPATCH = train_dalle.DalleTrainer.dispatch


def test_preempted_cli_with_ga_and_dropout_ends_bitwise(tmp_path, monkeypatch):
    """8 square PNGs of 32 px (one caption each, crop ratio 1.0: the
    batches do not depend on the dataset's rng), batch 4, 4 epochs: 8
    micro-steps, 4 Adam steps."""
    monkeypatch.chdir(tmp_path)
    write_caption_folder("data", 8, 32, seed=5)
    vae = DiscreteVAE(image_size=32, num_layers=2, hidden_dim=16, num_tokens=40,
                      codebook_dim=8, device="cpu").init_weights(torch.Generator().manual_seed(4))
    save_vae_checkpoint("vae.ckpt", vae)
    argv = ["--image_text_folder", "data", "--vae_path", "vae.ckpt", "--dim", "64", "--depth",
            "2", "--heads", "2", "--dim_head", "32", "--text_seq_len", "16",
            "--truncate_captions", "--epochs", "4", "--random_resize_crop_lower_ratio", "1.0",
            "--ga_steps", "2", "--attn_dropout", "0.1", "--ff_dropout", "0.1"]
    train_dalle.main([*argv, "--dalle_output_file_name", "clean"], device="cpu")
    dispatched = []

    def preempting(self, text, image_tokens):
        dispatched.append(1)
        if len(dispatched) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return DISPATCH(self, text, image_tokens)

    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", preempting)
    with pytest.raises(SystemExit) as exit_:
        train_dalle.main([*argv, "--dalle_output_file_name", "pre"], device="cpu")
    assert exit_.value.code == 0 and latest_verified_step("pre-cp") == 3
    tree, _ = load_checkpoint("pre-cp/step_00000003/train_state.msgpack")
    assert int(tree["opt_state"]["mini_step"]) == 1 and int(tree["opt_state"]["count"]) == 1
    monkeypatch.setattr(train_dalle.DalleTrainer, "dispatch", DISPATCH)
    train_dalle.main([*argv, "--dalle_output_file_name", "pre"], device="cpu")
    finals = []
    for name in ("clean", "pre"):
        state, meta = load_checkpoint(f"{name}.ckpt")
        finals.append((dalle_state_dict(state["params"]), restore_opt_state(f"{name}.ckpt",
                                                                            "cpu"), meta))
    (params, opt, meta), (params_r, opt_r, meta_r) = finals
    assert meta["epoch"] == meta_r["epoch"] == 3
    assert (int(opt.inner.count), int(opt.mini_step), int(opt.gradient_step)) == (4, 0, 4)
    assert (int(opt_r.inner.count), int(opt_r.mini_step), int(opt_r.gradient_step)) == (4, 0, 4)
    for a, b in ((params, params_r), (opt.inner.mu, opt_r.inner.mu),
                 (opt.inner.nu, opt_r.inner.nu), (opt.acc, opt_r.acc)):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
