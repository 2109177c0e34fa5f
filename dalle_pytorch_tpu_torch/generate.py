"""Text to saved images from a DALLE checkpoint (counterpart of the
repository's ``generate.py``, whose flags it takes, action by action).

    python -m dalle_pytorch_tpu_torch.generate --dalle_path DALLE.ckpt \\
        --text "a red circle|a blue square" [--clip_path CLIP.ckpt] [--bf16]

``main(argv, device="cuda")`` reads the checkpoint (refused with JAX's two
lines and exit code 2 unless it verifies against its manifest sidecar),
builds the DALLE and its VAE (``models.factory``), casts them for serving
under ``--bf16`` (``utils.quantize.prepare_for_serving``), picks the
tokenizer (``HugTokenizer(--bpe_path)`` with ``--hug``, else the CLIP BPE
``SimpleTokenizer``) and, with ``--clip_path``, the CLIP that reranks.
Prompts are split on ``|``. Images come from ONE serving engine reused
across prompts (``serving.engine``, the split path at ``max_batch =
--batch_size``), with the VAE decode and the CLIP rerank as its
post-decode stages: the path serving takes. Each image is one request,
``p{prompt}-img{i}``, drawing with its own seed
(``request_seed(seed, prompt, i)``, JAX's), and every one must complete.
The images are saved best first by their rerank score when a CLIP is
given, as ``<outputs_dir>/<text with _ for spaces, 100 characters>/{i}.png``
with ``caption.txt``.

``--gentxt`` first completes each prompt with ``generate_texts`` from
its encoded tokens. JAX splits a threefry key a prompt; the port draws
with the seed ``text_seed(seed, prompt)`` instead, so only a greedy
completion (``--top_k 1.0``) equals JAX's.

Refused with ``NotImplementedError`` (naming their ROADMAP.md item)
before any file is read or any directory made: ``--int8``,
``--chinese``, and the VQGAN and OpenAI dVAE weight paths. A gMLP
checkpoint fails with the factory's typed error, so JAX's fused-scan
fallback for models the engine cannot serve is not needed here.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

# flags the port does not run, with their ROADMAP.md items
NOT_PORTED = {
    "int8": "queue 1 item 6 (int8 serving, utils/quantize.py)",
    "chinese": "not queued: ChineseTokenizer downloads its vocabulary",
    "vqgan_model_path": "queue 1 item 6 (models/vqgan.py)",
    "vqgan_config_path": "queue 1 item 6 (models/vqgan.py)",
    "openai_enc_path": "queue 1 item 6 (models/pretrained.py)",
    "openai_dec_path": "queue 1 item 6 (models/pretrained.py)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Generate images from a DALL-E checkpoint")
    parser.add_argument("--dalle_path", type=str, required=True)
    parser.add_argument("--text", type=str, required=True,
                        help="prompt(s); multiple prompts split on |")
    parser.add_argument("--num_images", type=int, default=128)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--top_k", type=float, default=0.9,
                        help="fractional top-k filter threshold")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--outputs_dir", type=str, default="./outputs")
    parser.add_argument("--bpe_path", type=str, default=None)
    parser.add_argument("--hug", action="store_true")
    parser.add_argument("--chinese", action="store_true")
    parser.add_argument("--gentxt", action="store_true",
                        help="complete the prompt with the model before generating images")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fp16", "--bf16", dest="bf16", action="store_true",
                        help="serve in bfloat16")
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 serving (not ported)")
    parser.add_argument("--vqgan_model_path", type=str, default=None)
    parser.add_argument("--vqgan_config_path", type=str, default=None)
    parser.add_argument("--openai_enc_path", type=str, default=None)
    parser.add_argument("--openai_dec_path", type=str, default=None)
    parser.add_argument("--clip_path", type=str, default=None,
                        help="CLIP checkpoint that scores the generations; images are "
                             "saved best first")
    return parser


def refuse_unported(args: argparse.Namespace) -> None:
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(f"--{flag} is not ported (ROADMAP.md {item})")


def request_seed(seed: int, prompt: int, image: int) -> int:
    """The seed of image ``image`` of prompt ``prompt`` (JAX's)."""
    return seed * 1_000_003 + prompt * 65_537 + image


def text_seed(seed: int, prompt: int) -> int:
    """The seed of prompt ``prompt``'s ``--gentxt`` completion: the last
    of the prompt's block of request seeds."""
    return request_seed(seed, prompt, 65_536)


def engine_images(engine, prompt_row: np.ndarray, num_images: int, tag: str, seed: int):
    """``num_images`` images of one prompt through ``engine`` (one request
    each, ids ``{tag}-img{i}``, seeds ``seed + i``) -> (images (N, H, W, C)
    float32 in the VAE's normalized space, rerank scores (N,) or None).
    Any outcome but COMPLETED raises ``RuntimeError``."""
    from .serving.types import Outcome, Request

    ids = [f"{tag}-img{i}" for i in range(num_images)]
    for i, rid in enumerate(ids):
        rejected = engine.submit(Request(request_id=rid, prompt=np.asarray(prompt_row, np.int32),
                                         max_new_tokens=engine.dalle.image_seq_len,
                                         seed=seed + i))
        assert rejected is None, rejected
    results = engine.run()
    bad = {rid: results[rid].outcome.value for rid in ids
           if results[rid].outcome is not Outcome.COMPLETED}
    if bad:
        raise RuntimeError(f"engine failed requests: {bad}")
    images = np.stack([results[rid].image for rid in ids])
    scores = None
    if engine.postdecode is not None and engine.postdecode.rerank:
        scores = np.asarray([results[rid].rerank_score for rid in ids], np.float32)
    return images, scores


def main(argv=None, *, device="cuda") -> None:
    """``generate.py``'s ``main()`` on ``device`` (a Python argument, not
    a flag: the tests run on the CPU)."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)

    import torch

    from .data.image_io import write_png
    from .data.tokenizers import HugTokenizer, SimpleTokenizer
    from .models.factory import clip_from_checkpoint, dalle_from_checkpoint
    from .models.sampling import generate_texts
    from .models.vae import denormalize
    from .serving.engine import Engine, EngineConfig
    from .serving.postdecode import StageConfig, StageSpec
    from .utils.checkpoint import CheckpointError, check_checkpoint_file

    try:
        check_checkpoint_file(args.dalle_path)
    except CheckpointError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        print("refusing to load an unverifiable checkpoint; regenerate it or "
              "restore from a verified save", file=sys.stderr)
        sys.exit(2)
    dalle, vae, _ = dalle_from_checkpoint(args.dalle_path, device)
    assert vae is not None, "checkpoint carries no VAE — cannot decode images"
    if args.bf16:
        from .utils.quantize import prepare_for_serving

        dalle = prepare_for_serving(dalle)

    tokenizer = HugTokenizer(args.bpe_path) if args.hug else SimpleTokenizer(args.bpe_path)
    clip = None
    if args.clip_path:
        clip, _ = clip_from_checkpoint(args.clip_path, device)

    texts = [t.strip() for t in args.text.split("|") if t.strip()]
    outputs_dir = Path(args.outputs_dir)
    queue = max(args.num_images, 1)
    # one engine for every prompt; the stage queue holds every image, so
    # no request is degraded by the stage backlog
    engine = Engine(dalle, EngineConfig(max_batch=args.batch_size, queue_limit=queue,
                                        filter_thres=args.top_k, temperature=args.temperature),
                    device=device,
                    stages=StageSpec(vae, clip, config=StageConfig(batch=args.batch_size,
                                                                   queue_limit=queue)))
    pad_tokens = set(range(dalle.num_text_tokens_ext - dalle.text_seq_len,
                           dalle.num_text_tokens_ext))

    for pi, text in enumerate(texts):
        if args.gentxt:
            prompt_ids = torch.tensor([tokenizer.encode(text)], dtype=torch.int32)
            ids = generate_texts(dalle, text_seed(args.seed, pi), prompt_ids,
                                 filter_thres=args.top_k, temperature=args.temperature)
            completed = tokenizer.decode([int(t) for t in ids[0].cpu()], pad_tokens=pad_tokens)
            text = completed.strip()
            print(f"completed prompt: {text}")

        prompt_row = np.asarray(tokenizer.tokenize([text], dalle.text_seq_len,
                                                   truncate_text=True))[0]
        images, scores = engine_images(engine, prompt_row, args.num_images, tag=f"p{pi}",
                                       seed=request_seed(args.seed, pi, 0))
        images = denormalize(torch.from_numpy(images)).numpy()
        if scores is not None:
            # best first; the scores are the engine's rerank stage's
            images = images[np.argsort(-scores)]

        sub_dir = outputs_dir / text.replace(" ", "_")[:100]
        sub_dir.mkdir(parents=True, exist_ok=True)
        for i, arr in enumerate(images):
            write_png(sub_dir / f"{i}.png", (arr * 255).astype(np.uint8))
        (sub_dir / "caption.txt").write_text(text)
        print(f"created {len(images)} images at '{sub_dir}'")


if __name__ == "__main__":
    main()
