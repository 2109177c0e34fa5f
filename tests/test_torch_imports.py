"""The PyTorch port stands alone: no module of dalle_pytorch_tpu_torch/
and nothing in chip_smoke.py imports jax, flax, optax or the JAX package
(an AST walk), and the port's engine, post-decode stages and CLIP import
and run (a CPU fused_step, a CLIP similarity) in a process where
importing jax fails."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu")
SOURCES = sorted((REPO / "dalle_pytorch_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_with_jax_unimportable():
    code = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
model = DALLE(dim=32, depth=1, num_text_tokens=16, text_seq_len=4,
              num_image_tokens=12, image_fmap_size=2, heads=2, dim_head=16,
              device="cpu")
cache = init_decode_cache(model, 2, page_size=2)
i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
logits = model.fused_step(i32([1, 2], [3, 0]), i32(0, 0), i32(2, 1),
                          torch.tensor([False, False]), cache)
assert logits.shape == (2, 12) and torch.isfinite(logits).all()
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.serving.postdecode import PostDecodePipeline, StageSpec
clip = CLIP(dim_text=16, dim_image=16, dim_latent=8, num_text_tokens=16,
            text_enc_depth=1, text_seq_len=4, text_heads=2, text_dim_head=8,
            visual_enc_depth=1, visual_heads=2, visual_dim_head=8,
            visual_image_size=4, visual_patch_size=2, device="cpu")
text = i32(1, 2, 0, 0)[None].long()
sim = clip(text, torch.zeros(1, 4, 4, 3), text_mask=text != 0)
assert sim.shape == (1,) and torch.isfinite(sim).all()
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
