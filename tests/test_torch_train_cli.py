"""The port's trainer command line against the repository's
``train_dalle.py`` on the CPU, float32.

A JAX ``DiscreteVAE`` (image_size 32) is saved with JAX's
``save_vae_checkpoint``; JAX's command line runs with ``--epochs 0``,
which writes only its pre-flight ``.ckpt`` (the JAX DALLE's initial
params, Adam at zero). Both command lines then resume from that file with
the same flags (a tiny model: dim 64, depth 2, 2 heads of 32, text 16, an
8 x 8 grid; 8 square PNGs of 32 px with one caption each, batch 4, 6
epochs, ``--lr_decay``, ``--random_resize_crop_lower_ratio 1.0``):

- every loss, recorded at every verdict, to rtol 1e-5 (JAX's at its
  step function's output);
- the final checkpoints read by both readers (JAX's
  ``dalle_from_checkpoint`` / ``restore_opt_state``, the port's
  ``models.factory``): the same bytes for what JAX wrote, and the port's
  params and Adam moments against JAX's, per tensor, the relative L2 of
  the 12 steps' update (final minus initial) within 1e-3 and of each
  moment within 1e-5 (``tests/test_torch_train.py``'s tolerances), the
  Adam count equal;
- the metas: epoch, the scheduler state (``--lr_decay``: the best loss to
  rtol 1e-5, the counts equal) and the model configuration, equal;
- the flag surface: the port's ``build_parser()`` equals JAX's action by
  action (option strings, dest, type, default, nargs, const, action kind,
  required) and in its mutually exclusive group.

JAX's command line runs in this process on one of the suite's 8 virtual
CPU devices (``make_runtime`` handed ``jax.devices()[:1]``), so that
batch 4 needs no mesh flag.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dalle_pytorch_tpu.parallel as j_parallel
import train_dalle as j_train_dalle
from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.models.factory import dalle_from_checkpoint as j_dalle_from_checkpoint
from dalle_pytorch_tpu.models.factory import restore_opt_state as j_restore_opt_state
from dalle_pytorch_tpu.models.factory import save_vae_checkpoint as j_save_vae
from dalle_pytorch_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_params
from dalle_pytorch_tpu_torch.models.factory import dalle_from_checkpoint, restore_opt_state
from dalle_pytorch_tpu_torch.testing import write_caption_folder
from dalle_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)

VAE_CONFIG = dict(image_size=32, num_layers=2, num_resnet_blocks=1, hidden_dim=16,
                  num_tokens=40, codebook_dim=8)
MODEL_FLAGS = ["--dim", "64", "--depth", "2", "--heads", "2", "--dim_head", "32",
               "--text_seq_len", "16", "--truncate_captions", "--lr_decay"]
RUN_FLAGS = ["--epochs", "6", "--batch_size", "4", "--random_resize_crop_lower_ratio", "1.0"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _run_jax(monkeypatch, argv, losses):
    """JAX's ``main()`` on one virtual device; ``losses`` gets every
    dispatched step's loss."""
    make_runtime, make_step = j_parallel.make_runtime, j_parallel.make_train_step

    def one_device(**kw):
        return make_runtime(devices=jax.devices()[:1], **kw)

    def recording(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            state, loss = step(*args)
            losses.append(float(loss))
            return state, loss
        return run

    monkeypatch.setattr(j_parallel, "make_runtime", one_device)
    monkeypatch.setattr(j_parallel, "make_train_step", recording)
    monkeypatch.setattr(sys, "argv", ["train_dalle.py", *argv])
    j_train_dalle.main()
    monkeypatch.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work dir, JAX's pre-flight checkpoint, {"jax" | "port": (final
    checkpoint, losses)})."""
    work = tmp_path_factory.mktemp("cli")
    write_caption_folder(work / "data", 8, 32, seed=3)
    vae = JVAE(**VAE_CONFIG)
    img = jnp.zeros((1, 32, 32, 3))
    params = vae.init({"params": jax.random.key(1), "gumbel": jax.random.key(2)}, img)["params"]
    j_save_vae(str(work / "vae.ckpt"), vae, jax.device_get(params))
    common = ["--image_text_folder", str(work / "data"), *MODEL_FLAGS]
    mp = pytest.MonkeyPatch()
    pre = work / "jax_pre"
    _run_jax(mp, [*common, "--vae_path", str(work / "vae.ckpt"), "--epochs", "0",
                  "--dalle_output_file_name", str(pre)], [])
    out = {}
    jax_losses = []
    _run_jax(mp, [*common, *RUN_FLAGS, "--dalle_path", f"{pre}.ckpt",
                  "--dalle_output_file_name", str(work / "jax_out")], jax_losses)
    out["jax"] = (work / "jax_out.ckpt", jax_losses)
    port_losses = []
    verdict = train_dalle.DalleTrainer.verdict

    def recording(self, loss):
        port_losses.append(float(loss))
        return verdict(self, loss)

    mp.setattr(train_dalle.DalleTrainer, "verdict", recording)
    try:
        train_dalle.main([*common, *RUN_FLAGS, "--dalle_path", f"{pre}.ckpt",
                          "--dalle_output_file_name", str(work / "port_out")], device="cpu")
    finally:
        mp.undo()
    out["port"] = (work / "port_out.ckpt", port_losses)
    return work, Path(f"{pre}.ckpt"), out


def test_losses_agree(runs):
    _, _, out = runs
    jax_losses, port_losses = out["jax"][1], out["port"][1]
    assert len(jax_losses) == len(port_losses) == 12
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)


def test_final_params_and_moments_agree_in_both_readers(runs):
    work, pre, out = runs
    _, start, _, _, _ = j_dalle_from_checkpoint(str(pre))
    start = _flat(jax.device_get(start))
    finals = {}
    for side, (path, _) in out.items():
        jmodel, jparams, _, _, meta = j_dalle_from_checkpoint(str(path))
        target = jax.tree_util.tree_map(np.zeros_like, j_parallel_opt_template(jparams))
        jopt = j_restore_opt_state(str(path), target)
        model, vae, pmeta = dalle_from_checkpoint(path, device="cpu")
        adam = restore_opt_state(path, device="cpu")
        # the two readers agree on every value of the file
        assert _same(_flat(jax.device_get(jparams)), _flat(dalle_params(model.state_dict())))
        assert _same(_flat(jax.device_get(jopt[1].mu)), _flat(dalle_params(adam.mu)))
        assert _same(_flat(jax.device_get(jopt[1].nu)), _flat(dalle_params(adam.nu)))
        assert int(jopt[1].count) == int(adam.count) == 12 and pmeta == meta
        finals[side] = (_flat(jax.device_get(jparams)), _flat(jax.device_get(jopt[1].mu)),
                        _flat(jax.device_get(jopt[1].nu)))
    (jp, jmu, jnu), (pp, pmu, pnu) = finals["jax"], finals["port"]
    assert set(jp) == set(pp)
    for name in jp:
        assert _rel(pp[name] - start[name], jp[name] - start[name]) < 1e-3, name
        assert _rel(pmu[name], jmu[name]) < 1e-5, name
        assert _rel(pnu[name], jnu[name]) < 1e-5, name


def j_parallel_opt_template(params):
    import optax

    return optax.chain(optax.clip_by_global_norm(0.5), optax.scale_by_adam()).init(params)


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def test_metas_and_scheduler_state_agree(runs):
    work, _, out = runs
    (_, jmeta), (_, pmeta) = (j_load_checkpoint(str(out[s][0])) for s in ("jax", "port"))
    assert jmeta["epoch"] == pmeta["epoch"] == 5
    assert pmeta["config"] == jmeta["config"] and pmeta["vae_config"] == jmeta["vae_config"]
    js, ps = jmeta["scheduler_state"], pmeta["scheduler_state"]
    assert (js["lr"], js["num_bad"], js["cooldown_counter"]) == (
        ps["lr"], ps["num_bad"], ps["cooldown_counter"])
    np.testing.assert_allclose(ps["best"], js["best"], rtol=1e-5)
    # the port's reader gets the same meta and step from JAX's file
    state, meta = load_checkpoint(out["jax"][0])
    assert meta == jmeta and state["step"] == 12
    assert json.loads(json.dumps(pmeta)) == pmeta


def _actions(parser):
    return {tuple(a.option_strings): (a.dest, a.type, a.default, a.nargs, a.const,
                                      type(a).__name__, a.required)
            for a in parser._actions if a.dest != "help"}


def test_flag_surface_equals_train_dalle():
    port, ref = train_dalle.build_parser(), j_train_dalle.build_parser()
    assert _actions(port) == _actions(ref)
    groups = [[(g.required, [a.option_strings for a in g._group_actions])
               for g in p._mutually_exclusive_groups] for p in (port, ref)]
    assert groups[0] == groups[1] == [(False, [["--vae_path"], ["--dalle_path"]])]
    dests = {a.dest for a in ref._actions if a.dest != "help"}
    assert set(train_dalle.FLAGS) | set(train_dalle.NOT_PORTED) == dests
    assert not set(train_dalle.FLAGS) & set(train_dalle.NOT_PORTED)
    defaults = vars(ref.parse_args(["--image_text_folder", "x"]))
    assert {k: defaults[k] for k in train_dalle.CLI_FLAGS if k != "image_text_folder"} == {
        k: v for k, v in train_dalle.CLI_FLAGS.items() if k != "image_text_folder"}
