"""CLIP training on one card (counterpart of the repository's
``train_clip.py``).

    python -m dalle_pytorch_tpu_torch.train_clip --image_text_folder DIR [train_clip.py's flags]

``main(argv, device="cuda")`` is ``train_clip.py``'s ``main()`` with its
flags and defaults (``build_parser()`` is JAX's ``parse_args`` parser,
action by action): the tokenizer (the HuggingFace tokenizer JSON at
``--bpe_path`` with ``--hug``, else the CLIP BPE of ``data.tokenizers`` on
``--bpe_path``'s merges); the CLIP of the model flags with seeded random
weights, or the CLIP, its optimizer state and ``epoch + 1`` from
``--clip_path`` (computing in this run's type, as JAX re-clones it); the
folder of images with same-stem captions (``data.loader``); the step
(``parallel.step.make_train_step``: optax's ``clip_by_global_norm`` then
``adam(--learning_rate)``, the NaN guard) on the symmetric InfoNCE loss
with the key mask ``text != 0``; the pre-flight save at ``start_epoch -
1``, a save every ``--save_every_n_steps`` and at each epoch's end
(``models.factory.save_clip_checkpoint``: JAX's ``.ckpt`` format with
the optimizer state, which JAX's ``clip_from_checkpoint`` and
``restore_opt_state`` read). ``--bf16`` (``--fp16``) computes in
bfloat16 on float32 parameters, Adam in float32, as JAX does.

Two differences from ``train_clip.py``, both so that a run resumed at an
epoch's end trains on the uninterrupted run's batches: the loader's
shuffle order of an epoch is that epoch's on a resume too
(``loader.epoch = epoch``, as ``train_dalle.py`` keeps it), and a save at
an epoch's end (and the pre-flight save) carries the dataset's caption
and crop stream (``data_rng`` in its metadata), which ``--clip_path``
restores; ``train_clip.py`` restarts both at the first epoch's. A save
inside an epoch carries no stream: a resume from it skips the rest of
that epoch, as JAX's does, and draws from the seed's stream.

The flags in ``NOT_PORTED`` (the Chinese tokenizer, a mesh axis above 1,
Weights & Biases) raise ``NotImplementedError`` with their ROADMAP.md
queue item before anything is built.
"""

from __future__ import annotations

import argparse

import torch

_MESH = "queue 1 item 6 (torch.distributed mesh)"
_WANDB = "not queued: Weights & Biases needs the network"
NOT_PORTED = {"chinese": "not queued: ChineseTokenizer downloads its vocabulary",
              "fsdp": _MESH, "tp": _MESH, "wandb": _WANDB, "wandb_name": _WANDB}


def build_parser() -> argparse.ArgumentParser:
    """``train_clip.py``'s parser: the same option strings, dests, types
    and defaults."""
    parser = argparse.ArgumentParser(description="Train CLIP (PyTorch port, one card)")
    parser.add_argument("--image_text_folder", type=str, required=True,
                        help="folder of images + same-stem .txt captions")
    parser.add_argument("--clip_path", type=str, default=None,
                        help="path to a partially trained CLIP to resume")
    parser.add_argument("--clip_output_file_name", type=str, default="clip")
    parser.add_argument("--truncate_captions", action="store_true")
    parser.add_argument("--chinese", action="store_true", help="not ported")
    parser.add_argument("--hug", action="store_true",
                        help="a HuggingFace tokenizer JSON at --bpe_path")
    parser.add_argument("--bpe_path", type=str, default=None)
    parser.add_argument("--fp16", "--bf16", dest="bf16", action="store_true",
                        help="bfloat16 compute on float32 parameters")
    parser.add_argument("--wandb", action="store_true", help="not ported")
    parser.add_argument("--wandb_name", default="clip_train", help="not ported")
    parser.add_argument("--seed", type=int, default=42)

    mesh_group = parser.add_argument_group("Mesh settings (not ported: one card)")
    mesh_group.add_argument("--fsdp", type=int, default=1)
    mesh_group.add_argument("--tp", type=int, default=1)

    model_group = parser.add_argument_group("Model settings")
    model_group.add_argument("--dim_text", type=int, default=512)
    model_group.add_argument("--dim_image", type=int, default=512)
    model_group.add_argument("--dim_latent", type=int, default=512)
    model_group.add_argument("--text_enc_depth", type=int, default=6)
    model_group.add_argument("--text_seq_len", type=int, default=256)
    model_group.add_argument("--text_heads", type=int, default=8)
    model_group.add_argument("--visual_enc_depth", type=int, default=6)
    model_group.add_argument("--visual_heads", type=int, default=8)
    model_group.add_argument("--visual_image_size", type=int, default=256)
    model_group.add_argument("--visual_patch_size", type=int, default=32)

    train_group = parser.add_argument_group("Training settings")
    train_group.add_argument("--epochs", default=20, type=int)
    train_group.add_argument("--save_every_n_steps", default=1000, type=int)
    train_group.add_argument("--batch_size", default=32, type=int)
    train_group.add_argument("--learning_rate", default=3e-4, type=float)
    train_group.add_argument("--clip_grad_norm", default=0.5, type=float)
    return parser


def refuse_unported(args: argparse.Namespace) -> None:
    """``NotImplementedError`` for every flag in ``NOT_PORTED`` set to
    anything but its default."""
    defaults = build_parser().parse_args(["--image_text_folder", "."])
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise NotImplementedError(f"--{flag} is not ported (ROADMAP.md {item})")


def clip_loss(clip, batch: dict) -> torch.Tensor:
    """The InfoNCE loss of a batch {"text", "image"}, padding (id 0)
    masked out of the text encoder's keys and its pooling."""
    return clip(batch["text"], batch["image"], text_mask=batch["text"] != 0, return_loss=True)


def main(argv=None, *, device="cuda") -> None:
    """``train_clip.py``'s ``main()`` on ``device`` (a Python argument,
    not a flag: the tests run on the CPU)."""
    from .data.loader import DataLoader, TextImageDataset
    from .data.tokenizers import HugTokenizer, SimpleTokenizer
    from .models.clip import CLIP
    from .models.factory import clip_from_checkpoint, restore_opt_state, save_clip_checkpoint
    from .parallel.step import create_train_state, load_opt_state, make_train_step
    from .utils.metrics import MetricsLogger, Throughput

    args = build_parser().parse_args(argv)
    refuse_unported(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    tokenizer = HugTokenizer(args.bpe_path) if args.hug else SimpleTokenizer(args.bpe_path)

    if args.clip_path:
        clip, meta = clip_from_checkpoint(args.clip_path, device, dtype=dtype)
        start_epoch = int(meta.get("epoch", -1)) + 1
    else:
        clip = CLIP(
            dim_text=args.dim_text, dim_image=args.dim_image, dim_latent=args.dim_latent,
            num_text_tokens=tokenizer.vocab_size, text_enc_depth=args.text_enc_depth,
            text_seq_len=args.text_seq_len, text_heads=args.text_heads,
            visual_enc_depth=args.visual_enc_depth, visual_heads=args.visual_heads,
            visual_image_size=args.visual_image_size, visual_patch_size=args.visual_patch_size,
            device=device, dtype=dtype, param_dtype=torch.float32,
        ).init_weights(torch.Generator(device=device).manual_seed(args.seed))
        start_epoch = 0

    dataset = TextImageDataset(args.image_text_folder, text_len=clip.text_seq_len,
                               image_size=clip.visual_image_size,
                               truncate_captions=args.truncate_captions, tokenizer=tokenizer,
                               shuffle=True, seed=args.seed)
    if len(dataset) == 0:
        raise ValueError(f"no image-text pairs found at {args.image_text_folder}")
    if args.clip_path and "data_rng" in meta:
        dataset.set_rng_state(meta["data_rng"])
    loader = DataLoader(dataset, args.batch_size, shuffle=True, seed=args.seed)
    logger = MetricsLogger(config=vars(args))
    n_params = sum(p.numel() for p in clip.parameters())
    logger.log_text(f"CLIP {n_params:,} params | device {torch.device(device)}")

    state = create_train_state(clip)
    if args.clip_path:  # keep the Adam moments across a resume
        opt_state = restore_opt_state(args.clip_path, device)
        if opt_state is not None:
            state = load_opt_state(state, opt_state)
    step_fn = make_train_step(clip_loss, args.clip_grad_norm)
    ckpt_path = f"{args.clip_output_file_name}.ckpt"

    def save(epoch, data_rng=None):
        """``data_rng``: the stream where the next epoch starts (none
        inside an epoch, whose batches are made ahead on a thread)."""
        extra = {"epoch": epoch} if data_rng is None else {"epoch": epoch, "data_rng": data_rng}
        save_clip_checkpoint(ckpt_path, clip, extra=extra, opt_state=state.opt_state)

    # pre-flight: a misconfigured run fails before training
    save(start_epoch - 1, dataset.rng_state())

    throughput = Throughput(window=10)
    global_step = 0
    for epoch in range(start_epoch, args.epochs):
        loader.epoch = epoch  # the shuffle order of this epoch, on a resume too
        for i, batch in enumerate(loader):
            text = torch.from_numpy(batch["text"]).long().to(device)
            image = torch.from_numpy(batch["image"]).to(device, dtype)
            state, loss = step_fn(state, clip, {"text": text, "image": image},
                                  args.learning_rate)
            if i % 10 == 9 or i == 0:
                logger.log({"loss": float(loss), "epoch": epoch, "iter": i}, step=global_step)
                logger.log_text(f"step {global_step}: loss={float(loss):.4f} epoch={epoch}")
            rate = throughput.update(args.batch_size)
            if rate is not None:
                logger.log({"sample_per_sec": rate}, step=global_step)
            if global_step % args.save_every_n_steps == args.save_every_n_steps - 1:
                save(epoch)
            global_step += 1
        save(epoch, dataset.rng_state())
        logger.log_text(f"epoch {epoch} complete")


if __name__ == "__main__":
    main()
