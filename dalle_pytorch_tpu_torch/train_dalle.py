"""DALL-E training loop (counterpart of the step loop of the repository's
``train_dalle.py``).

``DalleTrainer(vae, dalle, **flags)`` builds the train state, the step
(``parallel.step.make_train_step`` with the clipped Adam and the NaN
guard) and the learning-rate controller; ``train_step(text, images)``
encodes the images to tokens with the VAE under ``no_grad``, takes one
step, and steps the controller on a finite loss. A step the device
rejected (non-finite loss or gradients) is retried on the same batch,
and ``consec_skipped`` reaching ``nan_abort_after`` raises ``NanAbort``.

The flags keep ``train_dalle.py``'s names and defaults. The ported ones
are in ``FLAGS``; passing any other flag of ``train_dalle.py`` raises
``NotImplementedError``: data loading, the tokenizer, checkpoints and
resume, the pretrained VAEs, telemetry, profiling, dropout, gradient
accumulation, reversible and remat execution, MoE and the mesh are not
ported, and neither is the command line. ``attn_types``
takes every type but "mlp" (gMLP), which raises ``NotImplementedError``.

``bf16`` (``--bf16``, ``--fp16`` and ``--amp`` in ``train_dalle.py``)
trains in mixed precision as JAX does: the DALLE computes in bfloat16 on
float32 parameters (``DALLE(dtype=torch.bfloat16,
param_dtype=torch.float32)``), the gradients, Adam moments and the step
stay float32, and there is no loss scaling. The VAE stays as passed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .models.dalle import DALLE
from .parallel.step import create_train_state, make_train_step
from .utils.schedules import ConstantLR, ReduceLROnPlateau

# train_dalle.py's flags that the trainer takes, with their defaults
MODEL_FLAGS = dict(dim=512, depth=2, heads=8, dim_head=64, text_seq_len=256,
                   loss_img_weight=7, shift_tokens=False, rotary_emb=False,
                   stable_softmax=False, attn_types="full")
FLAGS = dict(MODEL_FLAGS, batch_size=4, learning_rate=3e-4, clip_grad_norm=0.5,
             lr_decay=False, nan_abort_after=5, seed=42, bf16=False)
# train_dalle.py's other flags (argparse dests)
NOT_PORTED = (
    "vae_path", "dalle_path", "image_text_folder", "wds", "truncate_captions",
    "resize_ratio", "chinese", "hug", "bpe_path", "taming", "vqgan_model_path",
    "vqgan_config_path", "openai_enc_path", "openai_dec_path",
    "dalle_output_file_name", "wandb", "wandb_name", "wandb_entity", "fsdp",
    "tp", "sp", "pp", "pp_microbatches", "ep",
    "moe_experts", "moe_every", "moe_aux_weight", "moe_capacity_factor",
    "epochs", "save_every_n_steps", "sample_every_n_steps",
    "keep_n_checkpoints", "ga_steps", "sharded_ckpt", "auto_resume",
    "profile_trace_dir", "profile_step", "telemetry", "telemetry_dir",
    "metrics_port", "ff_dropout", "attn_dropout", "reversible", "remat",
)


class NanAbort(RuntimeError):
    """``nan_abort_after`` consecutive steps were rejected as non-finite."""


def dalle_loss(model: DALLE, batch: dict) -> torch.Tensor:
    """The training loss of a batch {"text", "image"} (image token ids)."""
    return model(batch["text"], batch["image"], return_loss=True)


class DalleTrainer:
    """``vae`` encodes images (b, h, w, c) in [0, 1] to tokens. ``dalle``
    is the model to train; without one the trainer builds it from the
    model flags (``num_text_tokens`` the tokenizer's vocabulary, the image
    vocabulary and grid from the VAE) with seeded random weights on
    ``device``, in bfloat16 on float32 parameters with ``bf16``; a given
    ``dalle`` must compute in the type ``bf16`` names, on float32
    parameters. ``nan_inject_step`` forces the loss to NaN at that step
    (the fault hook of the JAX step)."""

    def __init__(self, vae, dalle: Optional[DALLE] = None, *,
                 num_text_tokens: int = 10000, device="cuda",
                 nan_inject_step: Optional[int] = None, **flags):
        lacking = sorted(set(flags) & set(NOT_PORTED))
        if lacking:
            raise NotImplementedError(
                f"train_dalle.py flags {lacking} are not ported")
        unknown = sorted(set(flags) - set(FLAGS))
        if unknown:
            raise TypeError(f"train_dalle.py has no flags {unknown}")
        args = {**FLAGS, **flags}
        attn_types = tuple(args["attn_types"].split(","))
        compute_dtype = torch.bfloat16 if args["bf16"] else torch.float32
        if "mlp" in attn_types:
            raise NotImplementedError(
                f"attn_types {args['attn_types']!r}: gMLP ('mlp') layers are not ported")
        if dalle is None:
            dalle = DALLE(
                dim=args["dim"], depth=args["depth"],
                num_text_tokens=num_text_tokens,
                text_seq_len=args["text_seq_len"],
                num_image_tokens=vae.num_tokens, image_fmap_size=vae.fmap_size,
                heads=args["heads"], dim_head=args["dim_head"],
                attn_types=attn_types,
                loss_img_weight=args["loss_img_weight"],
                shift_tokens=args["shift_tokens"],
                rotary_emb=args["rotary_emb"], stable=args["stable_softmax"],
                device=device,
                dtype=compute_dtype, param_dtype=torch.float32,
            ).init_weights(torch.Generator(device=device).manual_seed(args["seed"]))
        elif set(flags) & set(MODEL_FLAGS):
            raise ValueError("the model flags build the DALLE: pass them or a "
                             "dalle, not both")
        elif (dalle.dtype, dalle.param_dtype) != (compute_dtype, torch.float32):
            raise ValueError(f"bf16={args['bf16']} trains a DALLE computing in "
                             f"{compute_dtype} on float32 parameters, got {dalle.dtype} "
                             f"on {dalle.param_dtype}")
        self.vae, self.dalle = vae, dalle
        self.batch_size = args["batch_size"]
        self.nan_abort_after = args["nan_abort_after"]
        self.state = create_train_state(dalle)
        self.step_fn = make_train_step(dalle_loss, args["clip_grad_norm"],
                                       nan_inject_step=nan_inject_step)
        lr = args["learning_rate"]
        self.sched = ReduceLROnPlateau(lr) if args["lr_decay"] else ConstantLR(lr)
        self.lr = self.sched.lr
        self.steps = 0    # applied (finite) steps
        self.retries = 0  # dispatches the device rejected

    def train_step(self, text: torch.Tensor, images: torch.Tensor) -> float:
        """One applied step on the batch: text (b, text_seq_len) raw ids,
        images (b, h, w, c) in [0, 1] on the model's device. Returns the
        finite loss; retries a rejected step on the same batch and raises
        ``NanAbort`` once ``consec_skipped`` reaches ``nan_abort_after``."""
        if text.shape[0] != self.batch_size:
            raise ValueError(f"batch of {text.shape[0]}, batch_size is {self.batch_size}")
        batch = {"text": text, "image": self.vae.get_codebook_indices(images)}
        while True:
            self.state, loss = self.step_fn(self.state, self.dalle, batch, self.lr)
            loss = float(loss)
            if math.isfinite(loss):
                self.steps += 1
                self.lr = self.sched.step(loss)
                return loss
            self.retries += 1
            consec = int(self.state.consec_skipped)
            if consec >= self.nan_abort_after:
                raise NanAbort(f"{consec} consecutive non-finite steps")
