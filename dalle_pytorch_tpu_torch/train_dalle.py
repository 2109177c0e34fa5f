"""DALL-E training: the trainer and its command line (counterpart of the
repository's ``train_dalle.py``).

    python -m dalle_pytorch_tpu_torch.train_dalle \\
        --image_text_folder DIR --vae_path VAE.ckpt [train_dalle.py's flags]

``DalleTrainer(vae, dalle, **flags)`` builds the train state, the step
(``parallel.step.make_train_step`` with the clipped Adam, optax's
``MultiSteps`` around it with ``ga_steps`` above 1, and the NaN guard)
and the learning-rate controller. ``dispatch(text, image_tokens)`` takes
one step without reading its loss; ``verdict(loss)`` reads it and steps
the controller on a finite one. With ``ga_steps`` above 1 the trainer
keeps ``mini_step`` on the host, counted by the verdicts (a rejected
micro-step keeps it) and read from the device only when a state is set
from outside (``trainer.state = ...``), and tells each dispatch whether
it emits: a verdict is read before the next dispatch, which raises
otherwise. ``train_step(text, images)`` encodes the
images with the VAE, dispatches, and retries a step the device rejected
(non-finite loss or gradients) on the same batch until
``consec_skipped`` reaches ``nan_abort_after`` (``NanAbort``). With
``attn_dropout`` or ``ff_dropout`` above 0 the step is not deterministic
(JAX's rule: deterministic only when both are 0) and each dispatch draws
its dropout masks from a ``torch.Generator`` on the model's device seeded
with the applied steps so far, as JAX keys its dropout rng: a retried
batch draws the masks it drew before, and a resumed run the masks an
uninterrupted one draws. A card's generator and the CPU's give different
streams.

``main(argv, device="cuda")`` is ``train_dalle.py``'s ``main()`` on one
card, with its flags (``build_parser()`` is JAX's, action by action): the
DALLE, its VAE, the epoch, the scheduler state and the optimizer state
from ``--dalle_path`` (a frozen pretrained VAE's weights from the local
files its flags name), or else the VAE in JAX's order: ``--vae_path`` (a
VAE checkpoint), ``--taming`` (the VQGAN of ``--vqgan_config_path`` and
``--vqgan_model_path``), else the OpenAI dVAE of ``--openai_enc_path``
and ``--openai_dec_path``; a pretrained VAE computes in bfloat16 under
``--bf16``, as JAX's loaders are handed the type, and a missing weight
file is refused with ``models.pretrained.MissingWeights``, naming its
flag, never downloaded; the folder dataset (``data.loader``), or tar shards
(``data.webdata``, with ``--wds [img,cap]`` or an ``--image_text_folder``
ending in ``.tar``; a resume replays a partial epoch of a tar stream from
its start, and says so); the tokenizer (``pick_tokenizer``: the
HugTokenizer for ``--hug`` or a ``.json`` ``--bpe_path``, the
YttmTokenizer for a ``.model`` one, else the CLIP BPE of
``data.tokenizers`` on ``--bpe_path``'s merges); the pre-flight save;
a ``.ckpt`` (``models.factory``, the format JAX reads) every epoch and
every ``--save_every_n_steps``, with a step directory under
``<name>-cp/`` beside it with ``--sharded_ckpt`` (``--keep_n_checkpoints``
rotates them); the resume probe, which restores the newest verified step
directory and skips the batches it had consumed (off with
``--no_auto_resume``); the NaN retry and, after ``--nan_abort_after``
consecutive rejections, an emergency step directory and ``SystemExit``;
SIGTERM / SIGINT (``PreemptionHandler``): the step in flight finishes, an
emergency step directory is written, exit 0; a sample every
``--sample_every_n_steps`` through ``models.sampling.generate_images``,
denormalized with the VAE's ``normalization`` and written as PNG to
``dalle_samples/``; ``torch.profiler`` over three steps
from ``--profile_step`` into ``--profile_trace_dir`` (a Chrome trace).
``global_step`` counts dispatches (micro-steps with ``--ga_steps``), as
JAX's does: a rejected step and its retry are two. ``DALLE_TPU_FAULTS``
arms ``nan_at_step``, ``ckpt_corrupt``, ``shard_open``, ``shard_read`` and
``telemetry_sink_fail`` (``utils.faults``); the tar loader's
``webdata.*`` counters (in the process-wide ``utils.metrics.counters``)
are logged every 100 steps. ``--telemetry`` turns on ``utils.telemetry``:
a ``train.step`` span from each dispatch to its verdict (its ``_s``
histogram the step's latency, the device included), ``train.data_wait``
around the wait for a batch, ``train.ckpt_save`` around every save, the
events ``train.nan_skip``, ``train.nan_abort`` and
``train.preempt_signal``, and a flight file under ``--telemetry_dir``
(default ``<dalle_output_file_name>-telemetry``), drained when the ring
fills, at exit, on the NaN abort and inside the preemption signal's
handler; ``--metrics_port`` serves ``/metrics`` on 127.0.0.1.

The flags in ``NOT_PORTED`` raise ``NotImplementedError`` (with their
ROADMAP.md queue item) when set to anything but their default, before any
model or file is built: the Chinese tokenizer, Weights & Biases, and the
mesh and MoE flags.
``--reversible`` and ``--remat`` build the DALLE in those
executions (``models/transformer.py``); a DALLE read from
``--dalle_path`` keeps its checkpoint's, as in JAX.

``bf16`` (``--bf16``, ``--fp16`` and ``--amp``) trains in mixed precision
as JAX does: the DALLE computes in bfloat16 on float32 parameters, the
gradients, Adam moments and the step stay float32, and there is no loss
scaling. A DALLE read from ``--dalle_path`` keeps its checkpoint's type,
as in JAX.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .models.dalle import DALLE
from .parallel.step import (
    MultiStepsState,
    TrainState,
    create_train_state,
    load_opt_state,
    load_train_state,
    make_train_step,
    train_state_tree,
)
from .utils.schedules import ConstantLR, ReduceLROnPlateau

# train_dalle.py's flags that DalleTrainer takes, with their defaults
MODEL_FLAGS = dict(dim=512, depth=2, heads=8, dim_head=64, text_seq_len=256,
                   loss_img_weight=7, shift_tokens=False, rotary_emb=False,
                   stable_softmax=False, attn_types="full", reversible=False, remat=False)
# the dropout rates also build the DALLE, and with a given one (a resume)
# they decide only whether the step is deterministic, as in JAX
TRAINER_FLAGS = dict(MODEL_FLAGS, batch_size=4, learning_rate=3e-4, clip_grad_norm=0.5,
                     lr_decay=False, nan_abort_after=5, seed=42, bf16=False, ga_steps=1,
                     attn_dropout=0.0, ff_dropout=0.0)
# the flags only the command line takes
CLI_FLAGS = dict(vae_path=None, dalle_path=None, image_text_folder=None, wds="",
                 truncate_captions=False, resize_ratio=0.75, hug=False, bpe_path=None,
                 dalle_output_file_name="dalle", epochs=20, save_every_n_steps=1000,
                 sample_every_n_steps=1000, keep_n_checkpoints=None, sharded_ckpt=False,
                 auto_resume=True, profile_trace_dir=None, profile_step=200, telemetry=False,
                 telemetry_dir=None, metrics_port=None, taming=False, vqgan_model_path=None,
                 vqgan_config_path=None, openai_enc_path=None, openai_dec_path=None)
FLAGS = {**TRAINER_FLAGS, **CLI_FLAGS}
# train_dalle.py's other flags (argparse dests), each with its ROADMAP.md item
_MESH = "queue 1 item 6 (torch.distributed mesh)"
_MOE = "queue 1 item 6 (ops/moe.py)"
_WANDB = "not queued: Weights & Biases needs the network"
NOT_PORTED = {
    "chinese": "not queued: ChineseTokenizer downloads its vocabulary",
    "wandb": _WANDB, "wandb_name": _WANDB, "wandb_entity": _WANDB,
    "fsdp": _MESH, "tp": _MESH, "sp": _MESH, "pp": _MESH, "pp_microbatches": _MESH,
    "ep": _MESH,
    "moe_experts": _MOE, "moe_every": _MOE, "moe_aux_weight": _MOE,
    "moe_capacity_factor": _MOE,
}


class NanAbort(RuntimeError):
    """``nan_abort_after`` consecutive steps were rejected as non-finite."""


def dalle_loss(model: DALLE, batch: dict,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The training loss of a batch {"text", "image"} (image token ids);
    with a ``generator``, not deterministic (dropout drawn from it)."""
    return model(batch["text"], batch["image"], return_loss=True, generator=generator)


class DalleTrainer:
    """``vae`` encodes images (b, h, w, c) in [0, 1] to tokens. ``dalle``
    is the model to train; without one the trainer builds it from the
    model flags and the dropout rates (``num_text_tokens`` the tokenizer's
    vocabulary, the image vocabulary and grid from the VAE) with seeded
    random weights on ``device``, in bfloat16 on float32 parameters with
    ``bf16``; a given ``dalle`` must compute in the type ``bf16`` names,
    on float32 parameters, and keeps its own rates. ``nan_inject_step``
    forces the loss to NaN at that step (the fault hook of the JAX
    step)."""

    def __init__(self, vae, dalle: Optional[DALLE] = None, *,
                 num_text_tokens: int = 10000, device="cuda",
                 nan_inject_step: Optional[int] = None, **flags):
        lacking = sorted(set(flags) & set(NOT_PORTED))
        if lacking:
            raise NotImplementedError(
                f"train_dalle.py flags {lacking} are not ported "
                f"({'; '.join(NOT_PORTED[f] for f in lacking)})")
        cli = sorted(set(flags) & set(CLI_FLAGS))
        if cli:
            raise TypeError(f"{cli} are flags of the command line (main()), not of the trainer")
        unknown = sorted(set(flags) - set(TRAINER_FLAGS))
        if unknown:
            raise TypeError(f"train_dalle.py has no flags {unknown}")
        args = {**TRAINER_FLAGS, **flags}
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
                attn_dropout=args["attn_dropout"], ff_dropout=args["ff_dropout"],
                attn_types=attn_types,
                loss_img_weight=args["loss_img_weight"],
                shift_tokens=args["shift_tokens"],
                rotary_emb=args["rotary_emb"], stable=args["stable_softmax"],
                reversible=args["reversible"], remat=args["remat"], device=device,
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
        self.deterministic = args["attn_dropout"] == 0 and args["ff_dropout"] == 0
        self.ga_steps = args["ga_steps"]
        self._unread = False  # a dispatch whose verdict is not read yet
        self.state = create_train_state(dalle, ga_steps=self.ga_steps)
        self.step_fn = make_train_step(dalle_loss, args["clip_grad_norm"],
                                       nan_inject_step=nan_inject_step,
                                       ga_steps=args["ga_steps"])
        lr = args["learning_rate"]
        self.sched = ReduceLROnPlateau(lr) if args["lr_decay"] else ConstantLR(lr)
        self.lr = self.sched.lr
        self.steps = 0    # applied (finite) steps
        self.retries = 0  # dispatches the device rejected

    @property
    def state(self) -> TrainState:
        return self._state

    @state.setter
    def state(self, state: TrainState) -> None:
        """A state set from outside (a fresh or a restored one): the host's
        ``mini_step`` is read from it."""
        self._state = state
        self._mini_step = (int(state.opt_state.mini_step)
                           if isinstance(state.opt_state, MultiStepsState) else 0)

    def generator(self) -> Optional[torch.Generator]:
        """The next dispatch's dropout generator, seeded with the applied
        steps so far; None when the step is deterministic."""
        if self.deterministic:
            return None
        return torch.Generator(device=self.dalle.device).manual_seed(self.steps)

    def dispatch(self, text: torch.Tensor, image_tokens: torch.Tensor) -> torch.Tensor:
        """One step on text (b, text_seq_len) raw ids and image token ids
        (b, image_seq_len): the state moves on and the loss comes back
        unread, a () tensor that is NaN for a step the device rejected.
        With ``ga_steps`` above 1 the previous dispatch's verdict must have
        been read (the host's ``mini_step`` follows the verdicts)."""
        if self._unread and self.ga_steps > 1:
            raise RuntimeError("ga_steps > 1: read the previous dispatch's verdict first")
        self._state, loss = self.step_fn(self._state, self.dalle,
                                         {"text": text, "image": image_tokens}, self.lr,
                                         self.generator(),
                                         emit=self._mini_step == self.ga_steps - 1)
        self._unread = True
        return loss

    def verdict(self, loss: torch.Tensor) -> float:
        """Read a dispatched step's loss: a finite one counts the step and
        steps the learning-rate controller; a rejected one counts a
        retry. Returns the loss as a float."""
        loss = float(loss)
        self._unread = False
        if math.isfinite(loss):
            self.steps += 1
            self._mini_step = (self._mini_step + 1) % self.ga_steps
            self.lr = self.sched.step(loss)
        else:
            self.retries += 1
        return loss

    def train_step(self, text: torch.Tensor, images: torch.Tensor) -> float:
        """One applied step on the batch: text (b, text_seq_len) raw ids,
        images (b, h, w, c) in [0, 1] on the model's device. Returns the
        finite loss; retries a rejected step on the same batch and raises
        ``NanAbort`` once ``consec_skipped`` reaches ``nan_abort_after``."""
        if text.shape[0] != self.batch_size:
            raise ValueError(f"batch of {text.shape[0]}, batch_size is {self.batch_size}")
        tokens = self.vae.get_codebook_indices(images)
        while True:
            loss = self.verdict(self.dispatch(text, tokens))
            if math.isfinite(loss):
                return loss
            consec = int(self.state.consec_skipped)
            if consec >= self.nan_abort_after:
                raise NanAbort(f"{consec} consecutive non-finite steps")


# ------------------------------------------------------------ command line


def build_parser() -> argparse.ArgumentParser:
    """``train_dalle.py``'s parser: the same option strings, dests, types,
    defaults, nargs, consts and mutually exclusive group."""
    parser = argparse.ArgumentParser(description="Train DALL-E (PyTorch port, one CUDA card)")
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--vae_path", type=str, help="path to a trained DiscreteVAE checkpoint")
    group.add_argument("--dalle_path", type=str,
                       help="path to a partially trained DALL-E to resume")
    parser.add_argument("--image_text_folder", type=str, required=True,
                        help="folder of images + same-stem .txt captions")
    parser.add_argument("--wds", type=str, nargs="?", const="auto", default="",
                        help="tar shards (the folder is a shard spec); optional "
                             "img,cap member names")
    parser.add_argument("--truncate_captions", action="store_true")
    parser.add_argument("--random_resize_crop_lower_ratio", dest="resize_ratio",
                        type=float, default=0.75)
    parser.add_argument("--chinese", action="store_true", help="not ported")
    parser.add_argument("--hug", action="store_true",
                        help="a HuggingFace tokenizer JSON at --bpe_path")
    parser.add_argument("--bpe_path", type=str, default=None,
                        help="a BPE merges file for the CLIP tokenizer (plain or gzip), "
                             "a tokenizer .json or a youtokentome .model")
    parser.add_argument("--taming", action="store_true", help="not ported")
    parser.add_argument("--vqgan_model_path", type=str, default=None, help="not ported")
    parser.add_argument("--vqgan_config_path", type=str, default=None, help="not ported")
    parser.add_argument("--openai_enc_path", type=str, default=None, help="not ported")
    parser.add_argument("--openai_dec_path", type=str, default=None, help="not ported")
    parser.add_argument("--dalle_output_file_name", type=str, default="dalle")
    parser.add_argument("--fp16", "--bf16", dest="bf16", action="store_true",
                        help="bfloat16 compute on float32 parameters")
    parser.add_argument("--amp", dest="bf16", action="store_true")
    parser.add_argument("--wandb", action="store_true", help="not ported")
    parser.add_argument("--wandb_name", default="dalle_train_transformer", help="not ported")
    parser.add_argument("--wandb_entity", default=None, help="not ported")
    parser.add_argument("--stable_softmax", action="store_true")
    parser.add_argument("--seed", type=int, default=42)

    mesh_group = parser.add_argument_group("Mesh settings (not ported: one card)")
    mesh_group.add_argument("--fsdp", type=int, default=1)
    mesh_group.add_argument("--tp", type=int, default=1)
    mesh_group.add_argument("--sp", type=int, default=1)
    mesh_group.add_argument("--pp", type=int, default=1)
    mesh_group.add_argument("--pp_microbatches", type=int, default=4)
    mesh_group.add_argument("--ep", type=int, default=1)

    moe_group = parser.add_argument_group("Mixture-of-experts settings (not ported)")
    moe_group.add_argument("--moe_experts", type=int, default=0)
    moe_group.add_argument("--moe_every", type=int, default=2)
    moe_group.add_argument("--moe_aux_weight", type=float, default=1e-2)
    moe_group.add_argument("--moe_capacity_factor", type=float, default=1.25)

    train_group = parser.add_argument_group("Training settings")
    train_group.add_argument("--epochs", default=20, type=int)
    train_group.add_argument("--save_every_n_steps", default=1000, type=int)
    train_group.add_argument("--sample_every_n_steps", default=1000, type=int)
    train_group.add_argument("--keep_n_checkpoints", default=None, type=int)
    train_group.add_argument("--batch_size", default=4, type=int)
    train_group.add_argument("--ga_steps", default=1, type=int,
                             help="micro-steps accumulated into each optimizer step")
    train_group.add_argument("--learning_rate", default=3e-4, type=float)
    train_group.add_argument("--clip_grad_norm", default=0.5, type=float)
    train_group.add_argument("--lr_decay", action="store_true")
    train_group.add_argument("--sharded_ckpt", action="store_true",
                             help="also write verified step directories under <name>-cp/")
    train_group.add_argument("--no_auto_resume", dest="auto_resume", action="store_false",
                             help="don't resume from a verified <name>-cp step directory")
    train_group.add_argument("--nan_abort_after", default=5, type=int,
                             help="abort after this many consecutive non-finite steps")
    train_group.add_argument("--profile_trace_dir", default=None, type=str,
                             help="write a torch.profiler Chrome trace of 3 steps here")
    train_group.add_argument("--profile_step", default=200, type=int,
                             help="global step at which the trace starts")
    train_group.add_argument("--telemetry", action="store_true", help="not ported")
    train_group.add_argument("--telemetry_dir", default=None, type=str, help="not ported")
    train_group.add_argument("--metrics_port", default=None, type=int, help="not ported")

    model_group = parser.add_argument_group("Model settings")
    model_group.add_argument("--dim", default=512, type=int)
    model_group.add_argument("--text_seq_len", default=256, type=int)
    model_group.add_argument("--depth", default=2, type=int)
    model_group.add_argument("--heads", default=8, type=int)
    model_group.add_argument("--dim_head", default=64, type=int)
    model_group.add_argument("--ff_dropout", default=0.0, type=float)
    model_group.add_argument("--attn_dropout", default=0.0, type=float)
    model_group.add_argument("--reversible", action="store_true")
    model_group.add_argument("--remat", action="store_true",
                             help="recompute each block's activations in the backward")
    model_group.add_argument("--loss_img_weight", default=7, type=int)
    model_group.add_argument("--attn_types", default="full", type=str,
                             help="comma-separated: full, sparse, axial_row, axial_col, "
                                  "conv_like")
    model_group.add_argument("--shift_tokens", action="store_true")
    model_group.add_argument("--rotary_emb", action="store_true")
    return parser


def refuse_unported(args: argparse.Namespace) -> None:
    """``NotImplementedError`` for every flag the port does not run, set
    to anything but its default."""
    defaults = build_parser().parse_args(["--image_text_folder", "."])
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise NotImplementedError(f"--{flag} is not ported (ROADMAP.md {item})")


def pick_tokenizer(args):
    """JAX's rules: ``--hug`` (which needs ``--bpe_path``) or a ``.json``
    ``--bpe_path`` the HugTokenizer, a ``.model`` one the YttmTokenizer,
    else the CLIP BPE tokenizer on ``--bpe_path``'s merges when given
    (``--chinese`` is refused before this)."""
    from .data.tokenizers import HugTokenizer, SimpleTokenizer, YttmTokenizer

    if args.hug:
        assert args.bpe_path is not None, "--hug requires --bpe_path (tokenizer json)"
        return HugTokenizer(args.bpe_path)
    if args.bpe_path is not None:
        if args.bpe_path.endswith(".json"):
            return HugTokenizer(args.bpe_path)
        if args.bpe_path.endswith(".model"):
            return YttmTokenizer(args.bpe_path)
    return SimpleTokenizer(args.bpe_path)


def main(argv=None, *, device="cuda") -> None:
    """``train_dalle.py``'s ``main()`` on ``device`` (a Python argument,
    not a flag: the tests run on the CPU)."""
    from .data.image_io import write_png
    from .data.loader import DataLoader, TextImageDataset
    from .data.webdata import TarImageTextDataset, TarLoader
    from .models.factory import (
        VAE_WEIGHT_KEYS,
        dalle_from_checkpoint,
        load_pretrained_vae,
        restore_opt_state,
        save_dalle_checkpoint,
        vae_from_checkpoint,
    )
    from .models.sampling import generate_images
    from .models.vae import denormalize
    from .utils.checkpoint import (
        check_checkpoint_file,
        latest_verified_step,
        load_checkpoint,
        load_sharded_checkpoint,
        save_sharded_checkpoint,
    )
    from .utils.faults import FaultRegistry
    from .utils.metrics import MetricsLogger, Throughput, counters
    from .utils.resilience import PreemptionHandler
    from .utils.telemetry import TELEMETRY

    args = build_parser().parse_args(argv)
    refuse_unported(args)
    faults = FaultRegistry.from_env()
    tokenizer = pick_tokenizer(args)

    # ---- VAE and DALLE (resume | vae_path | taming | OpenAI dVAE) ----------
    start_epoch, sched_state, opt_state, dalle = 0, None, None, None
    weight_paths = {k: getattr(args, k) for k in VAE_WEIGHT_KEYS}
    if args.dalle_path:
        check_checkpoint_file(args.dalle_path)
        loaded = load_checkpoint(args.dalle_path)
        dalle, vae, meta = dalle_from_checkpoint(args.dalle_path, device, loaded=loaded,
                                                 vae_weight_paths=weight_paths)
        if vae is None:
            raise ValueError(f"{args.dalle_path}: the resume checkpoint carries no VAE")
        start_epoch = int(meta.get("epoch", -1)) + 1
        sched_state = meta.get("scheduler_state")
        opt_state = restore_opt_state(args.dalle_path, device, loaded=loaded)
        del loaded
    elif args.vae_path:
        check_checkpoint_file(args.vae_path)
        vae, _ = vae_from_checkpoint(args.vae_path, device)
    else:
        vae_dtype = torch.bfloat16 if args.bf16 else torch.float32
        if args.taming:
            vae = load_pretrained_vae("VQGanVAE", weight_paths, vae_dtype, device)
        else:
            print("using OpenAI's pretrained VAE for encoding images to tokens")
            vae = load_pretrained_vae("OpenAIDiscreteVAE", weight_paths, vae_dtype, device)

    # ---- data ---------------------------------------------------------------
    text_seq_len = dalle.text_seq_len if dalle is not None else args.text_seq_len
    data = dict(text_len=text_seq_len, image_size=vae.image_size,
                truncate_captions=args.truncate_captions, resize_ratio=args.resize_ratio,
                tokenizer=tokenizer)
    if args.wds or args.image_text_folder.endswith(".tar"):
        cols = [c.strip() for c in ("" if args.wds == "auto" else args.wds).split(",")
                if c.strip()]
        if cols and len(cols) != 2:
            raise SystemExit(f"--wds wants 2 comma-separated column names (img,cap); "
                             f"got {args.wds!r}")
        dataset = TarImageTextDataset(
            args.image_text_folder, **data, image_key=cols[0] if cols else None,
            caption_key=cols[1] if cols else None, counters=counters, faults=faults)
        loader = TarLoader(dataset, args.batch_size)
    else:
        dataset = TextImageDataset(args.image_text_folder, **data, shuffle=True, seed=args.seed)
        if len(dataset) == 0:
            raise ValueError(f"no image-text pairs found at {args.image_text_folder}")
        loader = DataLoader(dataset, args.batch_size, shuffle=True, seed=args.seed)
    logger = MetricsLogger(config=vars(args))
    if args.telemetry:
        TELEMETRY.configure(
            enabled=True, flight_dir=args.telemetry_dir or f"{args.dalle_output_file_name}-telemetry",
            metrics_port=args.metrics_port, faults=faults)

    # ---- state, step ----------------------------------------------------------
    run_flags = {k: getattr(args, k) for k in TRAINER_FLAGS if k not in MODEL_FLAGS}
    if dalle is not None:
        run_flags["bf16"] = dalle.dtype == torch.bfloat16  # the checkpoint's type
    else:
        run_flags.update({k: getattr(args, k) for k in MODEL_FLAGS})
    trainer = DalleTrainer(vae, dalle, num_text_tokens=tokenizer.vocab_size, device=device,
                           nan_inject_step=faults.value("nan_at_step"), **run_flags)
    dalle = trainer.dalle
    if opt_state is not None:  # keep the optimizer state across a resume
        trainer.state = load_opt_state(trainer.state, opt_state)
    del opt_state
    sched = trainer.sched
    if sched_state:
        sched.load_state_dict(sched_state)
        trainer.lr = sched.lr
    n_params = sum(p.numel() for p in dalle.parameters())
    logger.log_text(f"DALLE {n_params:,} params | seq {dalle.total_seq_len} | "
                    f"device {torch.device(device)}")

    ckpt_path = f"{args.dalle_output_file_name}.ckpt"
    sharded_dir = f"{args.dalle_output_file_name}-cp"

    # ---- step-granular resume -------------------------------------------------
    resume_epoch = resume_iter = -1
    global_step = 0
    verified = latest_verified_step(sharded_dir) if args.auto_resume else None
    if verified is not None:
        tree, smeta, global_step = load_sharded_checkpoint(sharded_dir, step=verified,
                                                           verify=False)
        trainer.state = load_train_state(trainer.state, tree)
        del tree
        resume_epoch = int(smeta.get("epoch", -1))
        resume_iter = int(smeta.get("iter", -1))
        if smeta.get("scheduler_state"):
            sched.load_state_dict(smeta["scheduler_state"])
            trainer.lr = sched.lr
        if resume_epoch >= 0:
            start_epoch = resume_epoch
        logger.log_text(f"resuming from {sharded_dir} step {global_step} "
                        f"(epoch {resume_epoch}, iter {resume_iter})")
        # the folder loader's epoch order is reproducible in a new process
        # (seed + epoch); a tar stream's is not, so skipping batches would
        # drop or repeat samples: replay the partial epoch from its start
        if resume_iter >= 0 and not hasattr(loader, "epoch"):
            logger.log_text(f"tar-stream loader has no reproducible epoch order: replaying "
                            f"epoch {resume_epoch} from its start (up to {resume_iter + 1} "
                            f"batches re-seen)")
            resume_iter = -1
    # the dropout generator's key: the applied steps (dispatches less
    # rejections), as JAX keys its rng
    trainer.steps = global_step - int(trainer.state.skipped)

    def save(epoch):
        t0 = time.perf_counter()
        with TELEMETRY.span("train.ckpt_save", kind="full", epoch=epoch):
            save_dalle_checkpoint(ckpt_path, dalle, vae,
                                  extra={"epoch": epoch, "scheduler_state": sched.state_dict()},
                                  opt_state=trainer.state.opt_state, step=int(trainer.state.step))
        logger.log_text(f"saved {ckpt_path}: {os.path.getsize(ckpt_path):,} bytes in "
                        f"{time.perf_counter() - t0:.2f} s")

    def save_sharded(step, epoch, it, emergency=False):
        t0 = time.perf_counter()
        with TELEMETRY.span("train.ckpt_save", kind="sharded", step=step, emergency=emergency):
            target = save_sharded_checkpoint(
                sharded_dir, step, train_state_tree(trainer.state),
                meta={"epoch": epoch, "iter": it, "scheduler_state": sched.state_dict(),
                      "emergency": emergency},
                keep_n=args.keep_n_checkpoints, faults=faults)
        size = sum(p.stat().st_size for p in Path(target).rglob("*") if p.is_file())
        logger.log_text(f"saved {target}: {size:,} bytes in {time.perf_counter() - t0:.2f} s")

    save(start_epoch - 1)  # pre-flight: a misconfigured run fails before training

    throughput = Throughput(window=10)
    prev_loss = None
    step_span = None  # the open train.step span: dispatch to verdict
    prof = None
    nan_run = 0
    last_fed = None  # (i, batch) of the latest dispatch, for a retry
    retry_batch = None
    epoch = start_epoch

    def process_verdict():
        """Read the dispatched step's loss (a sync with the device): step
        the scheduler on a finite one, or set the batch up for a retry,
        and abort after ``nan_abort_after`` rejections in a row."""
        nonlocal prev_loss, nan_run, retry_batch, step_span
        if prev_loss is None:
            return
        loss_val = trainer.verdict(prev_loss)
        prev_loss = None
        TELEMETRY.end(step_span, loss=loss_val, finite=math.isfinite(loss_val))
        step_span = None
        if math.isfinite(loss_val):
            nan_run = 0
            return
        nan_run = int(trainer.state.consec_skipped)
        counters.inc("train.nan_skips")
        TELEMETRY.event("train.nan_skip", step=global_step - 1, consec=nan_run)
        logger.log_text(f"step {global_step - 1}: non-finite loss — update skipped on device, "
                        f"retrying batch ({nan_run}/{args.nan_abort_after})")
        if nan_run >= args.nan_abort_after:
            # the flight file first: the record must reach disk even if
            # the save hangs
            TELEMETRY.event("train.nan_abort", step=global_step - 1, consec=nan_run)
            TELEMETRY.drain("nan_abort")
            # the rejected batch's update is not in the state: record its
            # predecessor so a resume replays it
            save_sharded(int(trainer.state.step), epoch, last_fed[0] - 1, emergency=True)
            raise SystemExit(f"{nan_run} consecutive non-finite steps — aborting (state saved "
                             f"for post-mortem at {sharded_dir})")
        retry_batch = last_fed

    def to_device(batch):
        text = torch.from_numpy(batch["text"]).long().to(device)
        return text, torch.from_numpy(batch["image"]).to(device)

    def on_preempt_signal(signum):
        # inside the signal handler: the flight file is on disk even if the
        # step in flight or the emergency save then hangs
        TELEMETRY.event("train.preempt_signal", signum=signum, step=global_step)
        TELEMETRY.drain("preempt_signal")

    with PreemptionHandler(on_signal=on_preempt_signal) as preempt:
        for epoch in range(start_epoch, args.epochs):
            if hasattr(loader, "epoch"):
                loader.epoch = epoch  # the shuffle order of this epoch, on a resume too
            retry_batch = None
            nxt = None
            exhausted = False
            batches = enumerate(loader)
            while True:
                # take the next batch before the verdict, so the host's
                # batch work overlaps the step in flight
                if nxt is None and not exhausted:
                    with TELEMETRY.span("train.data_wait", epoch=epoch):
                        while nxt is None and not exhausted:
                            try:
                                cand = next(batches)
                            except StopIteration:
                                exhausted = True
                                break
                            if epoch == resume_epoch and cand[0] <= resume_iter:
                                continue  # consumed before the preemption
                            nxt = cand

                process_verdict()

                if retry_batch is not None:
                    i, batch = retry_batch
                    retry_batch = None
                elif nxt is not None:
                    i, batch = nxt
                    nxt = None
                else:
                    break
                last_fed = (i, batch)

                # train.step runs from the dispatch (the VAE encode that
                # feeds it included) to its verdict in process_verdict
                step_span = TELEMETRY.begin("train.step", step=global_step, epoch=epoch)
                text, images = to_device(batch)
                if args.profile_trace_dir is not None:
                    if global_step == args.profile_step:
                        _synchronize(device)
                        prof = _start_profiler(device)
                    elif global_step == args.profile_step + 3 and prof is not None:
                        _stop_profiler(prof, device, args.profile_trace_dir, logger,
                                       args.profile_step)
                        prof = None

                prev_loss = trainer.dispatch(text, vae.get_codebook_indices(images))

                if global_step % 10 == 0:
                    logger.log({"loss": float(prev_loss), "epoch": epoch, "iter": i,
                                "lr": trainer.lr, "nan_skips": counters.get("train.nan_skips")},
                               step=global_step)
                if global_step % 100 == 0:
                    logger.log_counters(counters, step=global_step, prefix="webdata.")
                rate = throughput.update(args.batch_size)
                if rate is not None:
                    logger.log({"sample_per_sec": rate}, step=global_step)

                if global_step > 0 and global_step % args.save_every_n_steps == 0:
                    # the saved scheduler state must include the step in
                    # flight, and a rejected batch is not in the state
                    process_verdict()
                    save(epoch)
                    if args.sharded_ckpt:
                        it = i - 1 if retry_batch is not None else i
                        save_sharded(int(trainer.state.step), epoch, it)

                if global_step > 0 and global_step % args.sample_every_n_steps == 0:
                    pixels = denormalize(generate_images(dalle, vae, text[:1], global_step),
                                         vae.normalization)
                    out = Path("dalle_samples")
                    out.mkdir(exist_ok=True)
                    arr = (pixels[0].float().cpu().numpy() * 255).astype(np.uint8)
                    write_png(out / f"sample_{global_step:07d}.png", arr)

                global_step += 1

                if preempt.triggered:
                    # the step in flight is done: write the emergency step
                    # directory and exit; the next launch resumes from it
                    if prof is not None:
                        _stop_profiler(prof, device, args.profile_trace_dir, logger,
                                       args.profile_step)
                        prof = None
                    process_verdict()
                    it = i - 1 if retry_batch is not None else i
                    save_sharded(int(trainer.state.step), epoch, it, emergency=True)
                    logger.log_text(f"emergency checkpoint at step {global_step} (epoch {epoch}, "
                                    f"iter {i}) written to {sharded_dir}; exiting")
                    sys.exit(0)

            save(epoch)
            if args.sharded_ckpt:  # the epoch is consumed: a resume starts the next
                save_sharded(int(trainer.state.step), epoch + 1, -1)
            logger.log_text(f"epoch {epoch} complete")

    if prof is not None:  # training ended inside the trace window
        _stop_profiler(prof, device, args.profile_trace_dir, logger, args.profile_step)


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device, trace_dir: str, logger, first: int) -> None:
    _synchronize(device)
    prof.stop()
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    path = Path(trace_dir) / f"trace_steps_{first}-{first + 2}.json"
    prof.export_chrome_trace(str(path))
    logger.log_text(f"profiler trace for steps {first}..{first + 2} written to {path}")


if __name__ == "__main__":
    main()
