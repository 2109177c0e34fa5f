"""The VAE trainer's parts against the JAX package on the CPU, float32:

- ``DiscreteVAE.forward``, the training forward, on a JAX-initialised
  VAE (image_size 32, 2 layers, hidden 16, one ResBlock, 40 tokens)
  with every leaf perturbed and converted, given the Gumbel noise that
  ``jax.random.gumbel`` returned while JAX's module ran: the loss to rtol
  1e-5, the reconstructions to atol 1e-4 and every parameter's gradient
  within 1e-4 of its tensor's max abs gradient, with the soft and the
  straight-through relaxation, MSE and smooth-L1, KL weight 0 and 0.5;
- the Gumbel-softmax and smooth-L1 functions alone, and the port's own
  Gumbel draws (standard Gumbel moments, a generator's seed decides);
- ``ImageFolderDataset`` and its batches through ``DataLoader`` with its
  ``collate`` bitwise JAX's on the same folder and seed (one file of
  garbage skipped by both);
- the unclipped Adam step (``make_train_step(loss, None, has_aux=True)``)
  against JAX's ``make_train_step`` with ``optax.scale_by_adam()``,
  ``dynamic_lr=True`` and ``has_aux=True`` on the VAE loss: 3 steps,
  losses to rtol 1e-5, the reconstructions (aux) to atol 1e-4, and per
  tensor the update's relative L2 error within 1e-3 and each moment's
  within 1e-5 (test_torch_train.py's tolerances);
- a checkpoint with the training fields reads both ways with JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dalle_pytorch_tpu.data.loader import DataLoader as JDataLoader
from dalle_pytorch_tpu.data.loader import ImageFolderDataset as JImageFolder
from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.models import vae as jvae_module
from dalle_pytorch_tpu.models.factory import save_vae_checkpoint as j_save_vae
from dalle_pytorch_tpu.models.factory import vae_from_checkpoint as j_vae_from_checkpoint
from dalle_pytorch_tpu.parallel import create_train_state as j_create_state
from dalle_pytorch_tpu.parallel import make_runtime
from dalle_pytorch_tpu.parallel import make_train_step as j_make_step
from dalle_pytorch_tpu_torch.convert import vae_params, vae_state_dict
from dalle_pytorch_tpu_torch.data.image_io import write_png
from dalle_pytorch_tpu_torch.data.loader import DataLoader, ImageFolderDataset
from dalle_pytorch_tpu_torch.models import factory
from dalle_pytorch_tpu_torch.models.vae import (
    DiscreteVAE,
    gumbel_noise,
    gumbel_softmax,
    smooth_l1_loss,
)
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step
from dalle_pytorch_tpu_torch.train_vae import vae_loss

torch.set_num_threads(2)

CONFIG = dict(image_size=32, num_layers=2, num_resnet_blocks=1, hidden_dim=16,
              num_tokens=40, codebook_dim=8)
LOSSES = {"mse": dict(), "smooth_l1": dict(smooth_l1_loss=True),
          "mse_kl": dict(kl_div_loss_weight=0.5),
          "smooth_l1_kl": dict(smooth_l1_loss=True, kl_div_loss_weight=0.5)}
RELAXATIONS = {"soft": dict(), "straight_through": dict(straight_through=True)}


def _images(seed, b=2):
    return np.random.RandomState(seed).rand(b, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    params = JVAE(**CONFIG).init({"params": jax.random.key(0), "gumbel": jax.random.key(1)},
                                 jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.RandomState(2)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.02 * rng.randn(*a.shape).astype(np.float32), params)


def _port(params, **fields) -> DiscreteVAE:
    vae = DiscreteVAE(**CONFIG, **fields, device="cpu")
    vae.load_state_dict(vae_state_dict(params))
    return vae


@pytest.fixture
def recorded_gumbel(monkeypatch):
    """Every array ``jax.random.gumbel`` returns, in call order."""
    drawn = []
    draw = jax.random.gumbel

    def gumbel(*args, **kwargs):
        out = draw(*args, **kwargs)
        if not isinstance(out, jax.core.Tracer):  # a jitted step's draw is traced
            drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "gumbel", gumbel)
    return drawn


@pytest.mark.parametrize("relax", list(RELAXATIONS))
@pytest.mark.parametrize("loss", list(LOSSES))
def test_training_forward_and_every_gradient_match_jax(jax_params, recorded_gumbel, relax,
                                                       loss):
    fields = {**LOSSES[loss], **RELAXATIONS[relax]}
    jvae = JVAE(**CONFIG, **fields)
    img, temp, key = _images(3), 0.7, jax.random.key(5)
    ref_recons = jvae.apply({"params": jax_params}, jnp.asarray(img), temp=temp,
                            rngs={"gumbel": key})
    assert len(recorded_gumbel) == 1
    noise = recorded_gumbel[0].copy()

    def loss_fn(p):
        return jvae.apply({"params": p}, jnp.asarray(img), return_loss=True,
                          return_recons=True, temp=temp, rngs={"gumbel": key})

    (ref_loss, ref_out), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(jax_params)
    ref = vae_state_dict(jax.device_get(ref_grads))
    np.testing.assert_allclose(np.asarray(ref_out), np.asarray(ref_recons), atol=1e-6)

    vae = _port(jax_params, **fields)
    got_loss, got_out = vae(torch.from_numpy(img), return_loss=True, return_recons=True,
                            temp=temp, gumbels=torch.from_numpy(noise))
    grads = torch.autograd.grad(got_loss, list(vae.parameters()))
    np.testing.assert_allclose(got_loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(ref_out), atol=1e-4)
    names = [k for k, _ in vae.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, g in zip(names, grads):
        scale = ref[name].abs().max().item()
        err = (g - ref[name]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (name, err, scale)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax(hard, recorded_gumbel):
    logits = np.random.RandomState(7).randn(3, 5, 11).astype(np.float32)
    ref = np.asarray(jvae_module.gumbel_softmax(jnp.asarray(logits), jax.random.key(2), 0.6,
                                                hard=hard))
    got = gumbel_softmax(torch.from_numpy(logits), torch.from_numpy(recorded_gumbel[0].copy()), 0.6,
                         hard=hard)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    if hard:  # a one-hot forward, up to the rounding of (y_hard + y_soft) - y_soft
        one_hot = np.eye(11, dtype=np.float32)[got.numpy().argmax(-1)]
        np.testing.assert_allclose(got.numpy(), one_hot, atol=1e-6)


def test_smooth_l1_matches_jax():
    rng = np.random.RandomState(8)
    a, b = (rng.randn(4, 9).astype(np.float32) * 2 for _ in range(2))
    ref = float(jvae_module.smooth_l1_loss(jnp.asarray(a), jnp.asarray(b)))
    got = smooth_l1_loss(torch.from_numpy(a), torch.from_numpy(b)).item()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got == pytest.approx(torch.nn.functional.smooth_l1_loss(
        torch.from_numpy(a), torch.from_numpy(b)).item(), rel=1e-6)


def test_gumbel_noise_is_standard_gumbel_and_seeded():
    draw = lambda seed: gumbel_noise((200, 500), torch.Generator().manual_seed(seed))  # noqa: E731
    g = draw(0)
    assert torch.isfinite(g).all() and torch.equal(g, draw(0)) and not torch.equal(g, draw(1))
    assert abs(g.mean().item() - 0.5772) < 0.01 and abs(g.var().item() - np.pi**2 / 6) < 0.03


def test_forward_needs_noise_or_a_generator(jax_params):
    vae = _port(jax_params)
    img = torch.from_numpy(_images(4))
    with pytest.raises(ValueError, match="generator"):
        vae(img, return_loss=True)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    assert torch.equal(vae(img, return_loss=True, generator=gen()),
                       vae(img, return_loss=True, generator=gen()))
    logits = vae(img, return_logits=True)
    assert logits.shape == (2, 8, 8, 40)
    with pytest.raises(ValueError, match="image size"):
        vae(torch.zeros(1, 16, 16, 3), generator=gen())


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """11 PNGs of mixed sizes in two directories, and one of garbage."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(9)
    for i in range(11):
        h, w = (40, 40) if i % 3 == 0 else (rng.randint(24, 60), rng.randint(24, 60))
        sub = root / ("sub" if i % 2 else "")
        sub.mkdir(exist_ok=True)
        write_png(sub / f"img_{i:02d}.png", rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8))
    (root / "img_05x.png").write_bytes(b"not an image")
    return root


def test_image_folder_dataset_is_bitwise_jax(image_folder):
    jds, ds = JImageFolder(str(image_folder), 32, seed=4), ImageFolderDataset(str(image_folder),
                                                                              32, seed=4)
    assert [str(p) for p in jds.files] == [str(p) for p in ds.files] and len(ds) == 12
    for i in list(range(len(ds))) * 2:  # the second pass draws other crops
        (ji, jl), (im, label) = jds[i], ds[i]
        assert im.dtype == np.float32 and im.shape == (32, 32, 3) and label == jl == 0
        np.testing.assert_array_equal(im, ji)


def test_image_folder_batches_are_bitwise_jax(image_folder):
    jds, ds = JImageFolder(str(image_folder), 16, seed=1), ImageFolderDataset(str(image_folder),
                                                                              16, seed=1)
    jl = JDataLoader(jds, 4, seed=3, collate_fn=JImageFolder.collate)
    pl = DataLoader(ds, 4, seed=3, collate_fn=ImageFolderDataset.collate)
    assert len(jl) == len(pl) == 3
    for _ in range(2):
        for jb, b in zip(list(jl), list(pl), strict=True):
            assert set(b) == {"image"}
            np.testing.assert_array_equal(b["image"], jb["image"])


def test_image_folder_refuses_an_empty_folder(tmp_path):
    with pytest.raises(ValueError, match="no images"):
        ImageFolderDataset(str(tmp_path), 16)


def test_unclipped_adam_steps_match_jax(jax_params, recorded_gumbel):
    jvae = JVAE(**CONFIG, kl_div_loss_weight=0.1)
    runtime = make_runtime(devices=jax.devices()[:1])
    opt = optax.scale_by_adam()
    temps, lr = [1.0, 0.9, 0.8], 1e-3

    def j_loss(p, batch, rng):
        return jvae.apply({"params": p}, batch["image"], return_loss=True, return_recons=True,
                          temp=batch["temp"], rngs={"gumbel": rng})

    jstate, shardings = j_create_state(jax.device_get(jax_params), opt, runtime)
    replicated = NamedSharding(runtime.mesh, P())
    jstep = j_make_step(j_loss, opt, runtime, shardings, has_aux=True, dynamic_lr=True,
                        donate=False,
                        data_shardings={"image": runtime.data_sharding, "temp": replicated})
    vae = _port(jax_params, kl_div_loss_weight=0.1)
    before = {k: p.detach().clone() for k, p in vae.named_parameters()}
    state = create_train_state(vae)
    noises = []  # each step's noise: the module's draw from that step's key, run eagerly
    for i, temp in enumerate(temps):
        recorded_gumbel.clear()
        jvae.apply({"params": jax_params}, jnp.asarray(_images(10 + i)), temp=temp,
                   rngs={"gumbel": jax.random.key(i)})
        noises.append(recorded_gumbel[0].copy())
    step = make_train_step(
        lambda m, b, g: m(b["image"], return_loss=True, return_recons=True, temp=b["temp"],
                          gumbels=g), None, has_aux=True)
    for i, temp in enumerate(temps):
        img = _images(10 + i)
        jstate, jloss, jrec = jstep(jstate, {"image": jnp.asarray(img),
                                             "temp": jnp.asarray(temp, jnp.float32)},
                                    jax.random.key(i), jnp.asarray(lr, jnp.float32))
        state, loss, rec = step(state, vae, {"image": torch.from_numpy(img), "temp": temp}, lr,
                                torch.from_numpy(noises[i]))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=1e-4)
        assert not rec.requires_grad
    assert int(state.opt_state.count) == int(jstate.opt_state.count) == 3
    for ours, theirs, origin, tol in (
        (state.params, jstate.params, before, 1e-3),
        (state.opt_state.mu, jstate.opt_state.mu, None, 1e-5),
        (state.opt_state.nu, jstate.opt_state.nu, None, 1e-5),
    ):
        ref = vae_state_dict(jax.device_get(theirs))
        for name, t in ours.items():
            got, want = t.detach(), ref[name]
            if origin is not None:
                got, want = got - origin[name], want - origin[name]
            err = ((got - want).norm() / want.norm()).item()
            assert err <= tol, (name, err)


def test_unclipped_step_keeps_the_nan_guard(jax_params):
    vae = _port(jax_params)
    state = create_train_state(vae)
    before = [p.detach().clone() for p in vae.parameters()]
    step = make_train_step(vae_loss, None, has_aux=True, nan_inject_step=0)
    img = torch.from_numpy(_images(6))
    state, loss, rec = step(state, vae, {"image": img, "temp": 1.0}, 1e-3,
                            torch.Generator().manual_seed(0))
    assert torch.isnan(loss) and int(state.skipped) == 1 and rec.shape == (2, 32, 32, 3)
    assert all(torch.equal(a, b) for a, b in zip(before, vae.parameters()))
    state, loss, _ = step(state, vae, {"image": img, "temp": 1.0}, 1e-3,
                          torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and int(state.opt_state.count) == 1


def test_training_fields_read_both_ways(jax_params, tmp_path):
    fields = dict(smooth_l1_loss=True, straight_through=True, kl_div_loss_weight=0.25,
                  temperature=0.7)
    vae = _port(jax_params, **fields)
    factory.save_vae_checkpoint(tmp_path / "port.ckpt", vae, extra={"epoch": 3})
    jvae, jp, meta = j_vae_from_checkpoint(str(tmp_path / "port.ckpt"))
    assert {k: getattr(jvae, k) for k in fields} == fields and meta["epoch"] == 3
    ref = vae_params(vae.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        want = ref
        for p in path:
            want = want[p.key]
        np.testing.assert_array_equal(np.asarray(leaf), want)
    j_save_vae(str(tmp_path / "jax.ckpt"), JVAE(**CONFIG, **fields), jax_params,
               extra={"epoch": 1})
    back, bmeta = factory.vae_from_checkpoint(tmp_path / "jax.ckpt", device="cpu")
    assert {k: getattr(back, k) for k in fields} == fields and bmeta["epoch"] == 1
    for k, t in vae_state_dict(jax_params).items():
        assert torch.equal(back.state_dict()[k], t)
