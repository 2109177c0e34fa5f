"""DiscreteVAE training on one card (counterpart of the repository's
``train_vae.py``).

    python -m dalle_pytorch_tpu_torch.train_vae --image_folder DIR [train_vae.py's flags]

``main(argv, device="cuda")`` is ``train_vae.py``'s ``main()`` with its
flags and defaults (``build_parser()`` is JAX's ``parse_args`` parser,
action by action): the ``DiscreteVAE`` of the model flags with seeded
random weights; the folder's images (``data.loader.ImageFolderDataset``,
shuffled by ``--seed``); the step (``parallel.step.make_train_step``
without a clip: optax's ``scale_by_adam`` with ``-lr`` applied in the
step, the NaN guard, the reconstructions as its aux) with the Gumbel
noise of step k drawn from a generator on the card seeded with k, as JAX
keys it; every 100 steps the loss, lr and temperature, the
codebook-usage count and histogram, a PNG grid of ``--num_images_save``
originals over their reconstructions in ``--samples_dir``, and the next
temperature (``utils.schedules.gumbel_temperature``); the lr decayed
by ``--lr_decay_rate`` each epoch (``ExponentialDecay``), then
``models.factory.save_vae_checkpoint`` to ``--output_file_name`` with the
epoch and the scheduler state: JAX's ``.ckpt`` format, which JAX's
``vae_from_checkpoint`` and ``train_dalle --vae_path`` read.

The flags in ``NOT_PORTED`` (a mesh axis above 1, Weights & Biases)
raise ``NotImplementedError`` with their ROADMAP.md queue item before
anything is built.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_MESH = "queue 1 item 6 (torch.distributed mesh)"
NOT_PORTED = {"fsdp": _MESH, "tp": _MESH,
              "wandb": "not queued: Weights & Biases needs the network"}
SAMPLE_EVERY = 100  # steps between the logs, grids and temperature updates


def build_parser() -> argparse.ArgumentParser:
    """``train_vae.py``'s parser: the same option strings, dests, types
    and defaults."""
    parser = argparse.ArgumentParser(description="Train a DiscreteVAE (PyTorch port, one card)")
    parser.add_argument("--image_folder", type=str, required=True,
                        help="folder of images for learning the discrete VAE and its codebook")
    parser.add_argument("--image_size", type=int, default=128)

    mesh_group = parser.add_argument_group("Mesh settings (not ported: one card)")
    mesh_group.add_argument("--fsdp", type=int, default=1)
    mesh_group.add_argument("--tp", type=int, default=1)

    train_group = parser.add_argument_group("Training settings")
    train_group.add_argument("--epochs", type=int, default=20)
    train_group.add_argument("--batch_size", type=int, default=8)
    train_group.add_argument("--learning_rate", type=float, default=1e-3)
    train_group.add_argument("--lr_decay_rate", type=float, default=0.98)
    train_group.add_argument("--starting_temp", type=float, default=1.0)
    train_group.add_argument("--temp_min", type=float, default=0.5)
    train_group.add_argument("--anneal_rate", type=float, default=1e-6)
    train_group.add_argument("--num_images_save", type=int, default=4)
    train_group.add_argument("--seed", type=int, default=0)
    train_group.add_argument("--output_file_name", type=str, default="vae.ckpt")
    train_group.add_argument("--samples_dir", type=str, default="vae_samples")
    train_group.add_argument("--wandb", action="store_true", help="not ported")

    model_group = parser.add_argument_group("Model settings")
    model_group.add_argument("--num_tokens", type=int, default=8192)
    model_group.add_argument("--num_layers", type=int, default=3)
    model_group.add_argument("--num_resnet_blocks", type=int, default=2)
    model_group.add_argument("--smooth_l1_loss", action="store_true")
    model_group.add_argument("--emb_dim", type=int, default=512)
    model_group.add_argument("--hidden_dim", type=int, default=256)
    model_group.add_argument("--kl_loss_weight", type=float, default=0.0)
    return parser


def refuse_unported(args: argparse.Namespace) -> None:
    """``NotImplementedError`` for every flag in ``NOT_PORTED`` set to
    anything but its default."""
    defaults = build_parser().parse_args(["--image_folder", "."])
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise NotImplementedError(f"--{flag} is not ported (ROADMAP.md {item})")


def vae_loss(vae, batch: dict, generator: Optional[torch.Generator] = None):
    """(loss, reconstructions) of a batch {"image", "temp"}, the Gumbel
    noise drawn from ``generator``."""
    return vae(batch["image"], return_loss=True, return_recons=True, temp=batch["temp"],
               generator=generator)


def recon_grid(images: np.ndarray, recons: np.ndarray) -> np.ndarray:
    """The originals (k, h, w, 3) in a row over their reconstructions,
    both in [0, 1]: (2h, k*w, 3) uint8."""
    grid = np.concatenate([np.concatenate(list(images), 1), np.concatenate(list(recons), 1)], 0)
    return (grid * 255).astype(np.uint8)


def main(argv=None, *, device="cuda") -> None:
    """``train_vae.py``'s ``main()`` on ``device`` (a Python argument,
    not a flag: the tests run on the CPU)."""
    from .data.image_io import write_png
    from .data.loader import DataLoader, ImageFolderDataset
    from .models.factory import save_vae_checkpoint
    from .models.vae import DiscreteVAE, denormalize
    from .parallel.step import create_train_state, make_train_step
    from .utils.metrics import MetricsLogger, Throughput
    from .utils.schedules import ExponentialDecay, gumbel_temperature

    args = build_parser().parse_args(argv)
    refuse_unported(args)

    vae = DiscreteVAE(
        image_size=args.image_size, num_tokens=args.num_tokens, codebook_dim=args.emb_dim,
        num_layers=args.num_layers, num_resnet_blocks=args.num_resnet_blocks,
        hidden_dim=args.hidden_dim, smooth_l1_loss=args.smooth_l1_loss,
        kl_div_loss_weight=args.kl_loss_weight, device=device,
    ).init_weights(torch.Generator(device=device).manual_seed(args.seed))

    dataset = ImageFolderDataset(args.image_folder, args.image_size, seed=args.seed)
    loader = DataLoader(dataset, args.batch_size, shuffle=True, seed=args.seed,
                        collate_fn=ImageFolderDataset.collate)
    if len(loader) == 0:
        raise ValueError("dataset too small for one batch")
    logger = MetricsLogger(config=vars(args))
    n_params = sum(p.numel() for p in vae.parameters())
    logger.log_text(f"DiscreteVAE with {n_params:,} params on {torch.device(device)}")

    state = create_train_state(vae)
    step_fn = make_train_step(vae_loss, None, has_aux=True)
    sched = ExponentialDecay(args.learning_rate, args.lr_decay_rate)
    lr, temp = args.learning_rate, args.starting_temp
    throughput = Throughput(window=10)
    samples_dir = Path(args.samples_dir)

    global_step = 0
    for epoch in range(args.epochs):
        for batch in loader:
            images = torch.from_numpy(batch["image"]).to(device)
            generator = torch.Generator(device=device).manual_seed(global_step)
            state, loss, recons = step_fn(state, vae, {"image": images, "temp": temp}, lr,
                                          generator)

            if global_step % SAMPLE_EVERY == 0:
                logs = {"loss": float(loss), "lr": lr, "temp": temp, "epoch": epoch}
                # codebook usage: the unique count, and the histogram's shape
                idx = vae.get_codebook_indices(images).cpu().numpy()
                logs["codebook_used"] = int(np.unique(idx).size)
                logger.log_histogram("codebook_indices", idx, step=global_step)
                k = min(args.num_images_save, images.shape[0])
                samples_dir.mkdir(parents=True, exist_ok=True)
                rec = denormalize(recons[:k].float()).cpu().numpy()
                write_png(samples_dir / f"recon_{global_step:07d}.png",
                          recon_grid(batch["image"][:k], rec))
                temp = gumbel_temperature(global_step, args.starting_temp, args.anneal_rate,
                                          args.temp_min)
                logger.log(logs, step=global_step)

            rate = throughput.update(args.batch_size)
            if rate is not None:
                logger.log({"sample_per_sec": rate}, step=global_step)
            global_step += 1

        lr = sched.step()
        save_vae_checkpoint(args.output_file_name, vae,
                            extra={"epoch": epoch, "scheduler_state": sched.state_dict()})
        logger.log_text(f"epoch {epoch} done; saved {args.output_file_name}")


if __name__ == "__main__":
    main()
