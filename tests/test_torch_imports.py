"""The PyTorch port stands alone: no module of dalle_pytorch_tpu_torch/
(``ops/reversible.py``, ``train_vae.py`` and ``train_clip.py`` among
them) and nothing in chip_smoke.py imports jax, flax, optax or the JAX
package (an AST walk), and the port's engine, post-decode stages, CLIP
and trainer import and run (a CPU fused_step, a CLIP similarity, a train
step) in a process where importing jax fails. The trainers' command
lines (DALLE, VAE and CLIP) also run (an epoch on a PNG folder, to a
checkpoint), and reversible and remat DALLE steps too, where none of the
card's missing host packages can be imported either: PIL, regex,
msgpack, tokenizers and ftfy; so do the generate command line (bf16,
a CLIP rerank) and the trainer with ``--telemetry``. The tar-shard loader
(``data/webdata.py``), the native engine's binding
(``data/native_bpe.py``) and its build (``native/``) import and run where
jax and the JAX package cannot be imported, and name no path of the JAX
package's ``native/``."""

import ast
import os
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


def test_the_guard_covers_the_new_modules():
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {f"dalle_pytorch_tpu_torch/{m}" for m in (
        "ops/reversible.py", "train_vae.py", "train_clip.py", "models/pretrained.py",
        "models/vqgan.py")} <= names


def test_the_guard_covers_the_prefix_cache():
    assert REPO / "dalle_pytorch_tpu_torch/serving/prefix_cache.py" in SOURCES


def test_the_guard_covers_the_generate_cli_and_telemetry():
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {f"dalle_pytorch_tpu_torch/{m}" for m in (
        "generate.py", "utils/telemetry.py", "utils/telemetry_names.py",
        "utils/quantize.py")} <= names


def test_generate_cli_and_telemetry_run_without_the_missing_host_packages(tmp_path):
    """``generate.main`` (bf16, a CLIP rerank, telemetry on through the
    environment) and the trainer with ``--telemetry`` where jax, the JAX
    package and the card's missing host packages cannot be imported."""
    code = """
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu", "PIL", "regex", "msgpack",
           "tokenizers", "ftfy")
for name in BLOCKED:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from dalle_pytorch_tpu_torch import generate, train_dalle
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.factory import save_clip_checkpoint, save_dalle_checkpoint
from dalle_pytorch_tpu_torch.models.factory import save_vae_checkpoint
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.testing import write_caption_folder
from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY, validate_flight_file
assert TELEMETRY.enabled
vae = DiscreteVAE(image_size=8, num_layers=1, hidden_dim=4, num_tokens=12, codebook_dim=4,
                  device="cpu").init_weights(torch.Generator().manual_seed(0))
dalle = DALLE(dim=32, depth=1, num_text_tokens=49408, text_seq_len=4, num_image_tokens=12,
              image_fmap_size=4, heads=2, dim_head=16, device="cpu")
save_dalle_checkpoint("dalle.ckpt", dalle.init_weights(torch.Generator().manual_seed(1)), vae)
clip = CLIP(dim_text=16, dim_image=16, dim_latent=8, num_text_tokens=49408, text_enc_depth=1,
            text_seq_len=4, text_heads=2, text_dim_head=8, visual_enc_depth=1, visual_heads=2,
            visual_dim_head=8, visual_image_size=8, visual_patch_size=4, device="cpu")
save_clip_checkpoint("clip.ckpt", clip)
generate.main(["--dalle_path", "dalle.ckpt", "--clip_path", "clip.ckpt", "--text", "a|b",
               "--num_images", "2", "--batch_size", "2", "--bf16"], device="cpu")
write_caption_folder("data", 4, 8, seed=1)
save_vae_checkpoint("vae.ckpt", vae)
train_dalle.main(["--image_text_folder", "data", "--vae_path", "vae.ckpt", "--dim", "32",
                  "--depth", "1", "--heads", "2", "--dim_head", "16", "--text_seq_len", "8",
                  "--truncate_captions", "--epochs", "1", "--batch_size", "2", "--telemetry",
                  "--telemetry_dir", "flight"], device="cpu")
by_name = validate_flight_file(TELEMETRY.drain("end"))["by_name"]
assert by_name["serve.request"] == 8 and by_name["train.step"] == 4, by_name
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m])
assert not leaked, leaked
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO), "DALLE_TPU_TELEMETRY": "1",
           "DALLE_TPU_TELEMETRY_DIR": str(tmp_path / "flight")}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
    assert sorted(p.name for p in (tmp_path / "outputs").iterdir()) == ["a", "b"]


def test_prefix_and_spec_engine_run_with_jax_unimportable():
    """A speculative engine with the prefix cache serves a cold and a
    warm round with jax and the JAX package blocked."""
    code = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu"):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(1)
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import Request
model = DALLE(dim=32, depth=2, num_text_tokens=16, text_seq_len=4,
              num_image_tokens=12, image_fmap_size=2, heads=2, dim_head=16,
              device="cpu")
eng = Engine(model, EngineConfig(max_batch=2, prefill_chunk=2, fused_iteration=True,
                                 spec_decode=True, spec_k=2, prefix_cache=True,
                                 page_size=2), device="cpu")
for rid in ("cold", "warm"):
    assert eng.submit(Request(rid, np.array([3, 4, 5, 0]), 4, seed=1)) is None
    eng.run(max_steps=200)
eng.verify_invariants(idle=True)
assert np.array_equal(eng.results["cold"].tokens, eng.results["warm"].tokens)
assert eng.counters.get("serve.prefix.hits") == 1
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


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
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.train_dalle import DalleTrainer
from dalle_pytorch_tpu_torch.utils.schedules import ReduceLROnPlateau
vae = DiscreteVAE(image_size=8, num_layers=1, hidden_dim=4, num_tokens=12,
                  codebook_dim=4, device="cpu")
trainer = DalleTrainer(vae, num_text_tokens=16, device="cpu", dim=32, depth=1,
                       heads=2, dim_head=16, text_seq_len=4, shift_tokens=True,
                       rotary_emb=True, batch_size=2)
loss = trainer.train_step(i32([1, 2, 0, 0], [3, 0, 0, 0]).long(), torch.rand(2, 8, 8, 3))
assert loss == loss and trainer.steps == 1
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_train_cli_runs_without_the_missing_host_packages(tmp_path):
    code = """
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu", "PIL", "regex", "msgpack",
           "tokenizers", "ftfy")
for name in BLOCKED:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from dalle_pytorch_tpu_torch.models.factory import save_vae_checkpoint
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.testing import write_caption_folder
from dalle_pytorch_tpu_torch.train_dalle import main
from dalle_pytorch_tpu_torch.utils.checkpoint import check_checkpoint_file
write_caption_folder("data", 8, 16, seed=1)
vae = DiscreteVAE(image_size=16, num_layers=1, hidden_dim=4, num_tokens=12, codebook_dim=4,
                  device="cpu").init_weights(torch.Generator().manual_seed(0))
save_vae_checkpoint("vae.ckpt", vae)
main(["--image_text_folder", "data", "--vae_path", "vae.ckpt", "--dim", "32", "--depth", "1",
      "--heads", "2", "--dim_head", "16", "--text_seq_len", "8", "--truncate_captions",
      "--epochs", "1", "--sharded_ckpt"], device="cpu")
check_checkpoint_file("dalle.ckpt", require_manifest=True)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m])
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
    assert (tmp_path / "dalle.ckpt").exists() and (tmp_path / "dalle-cp" / "step_00000002").is_dir()


def test_vae_and_clip_trainers_run_without_the_missing_host_packages(tmp_path):
    """``train_vae.main`` and ``train_clip.main`` (and reversible and remat
    DALLE steps) where jax, the JAX package and the card's missing host
    packages cannot be imported."""
    code = """
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu", "PIL", "regex", "msgpack",
           "tokenizers", "ftfy")
for name in BLOCKED:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from dalle_pytorch_tpu_torch import train_clip, train_vae
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.ops import reversible
from dalle_pytorch_tpu_torch.testing import write_caption_folder
from dalle_pytorch_tpu_torch.utils.checkpoint import check_checkpoint_file
write_caption_folder("data", 4, 16, seed=1)
train_vae.main(["--image_folder", "data", "--image_size", "16", "--num_layers", "1",
                "--num_resnet_blocks", "0", "--hidden_dim", "4", "--num_tokens", "12",
                "--emb_dim", "4", "--batch_size", "2", "--epochs", "1"], device="cpu")
check_checkpoint_file("vae.ckpt")
train_clip.main(["--image_text_folder", "data", "--dim_text", "16", "--dim_image", "16",
                 "--dim_latent", "8", "--text_enc_depth", "1", "--text_seq_len", "8",
                 "--text_heads", "2", "--visual_enc_depth", "1", "--visual_heads", "2",
                 "--visual_image_size", "16", "--visual_patch_size", "8", "--batch_size", "2",
                 "--epochs", "1", "--truncate_captions"], device="cpu")
check_checkpoint_file("clip.ckpt")
for flag in ("reversible", "remat"):
    model = DALLE(dim=32, depth=2, num_text_tokens=16, text_seq_len=4, num_image_tokens=12,
                  image_fmap_size=2, heads=2, dim_head=16, device="cpu", **{flag: True})
    loss = model(torch.tensor([[1, 2, 0, 0]]), torch.tensor([[1, 2, 3, 4]]), return_loss=True)
    loss.backward()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m])
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
    assert (tmp_path / "vae_samples" / "recon_0000000.png").exists()


NEW_MODULES = ("data/webdata.py", "data/native_bpe.py", "native/build.py",
               "native/gen_unicode_tables.py", "native/bpe_tokenizer.cc")


@pytest.mark.parametrize("name", NEW_MODULES)
def test_data_and_native_sources_name_no_jax_native_path(name):
    text = (REPO / "dalle_pytorch_tpu_torch" / name).read_text()
    assert "dalle_pytorch_tpu/native" not in text and "dalle_pytorch_tpu.native" not in text
    assert ".cache" not in text


def test_data_and_native_modules_run_with_jax_unimportable(tmp_path):
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu"):
    sys.modules[name] = None
from dalle_pytorch_tpu_torch.data.native_bpe import NativeSimpleTokenizer
from dalle_pytorch_tpu_torch.data.webdata import TarImageTextDataset, TarLoader
from dalle_pytorch_tpu_torch.native import build, gen_unicode_tables
from dalle_pytorch_tpu_torch.testing import write_tar_shards
spec, _ = write_tar_shards({str(tmp_path)!r}, 2, 2, 16, seed=1)
tok = NativeSimpleTokenizer()
batches = list(TarLoader(TarImageTextDataset(spec, text_len=8, image_size=8, tokenizer=tok,
                                             truncate_captions=True), 2))
assert len(batches) == 2 and batches[0]["image"].shape == (2, 8, 8, 3)
assert str(build.library_path()).startswith(str(build.BUILD_DIR))
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "dalle_pytorch_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr


RECOVERY_MODULES = ("serving/journal.py", "serving/router.py", "serving/control.py",
                    "utils/vitals.py")


@pytest.mark.parametrize("name", RECOVERY_MODULES)
def test_the_guard_covers_the_router_and_recovery(name):
    assert REPO / "dalle_pytorch_tpu_torch" / name in SOURCES


def test_router_journal_snapshot_and_control_run_with_jax_unimportable(tmp_path):
    """A two-replica router with a journal loses a replica mid-decode,
    shuts down into a prefix snapshot, and a fresh engine restores it; a
    speculative engine runs its controller: all where jax and the JAX
    package cannot be imported."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.serving.control import ControlConfig
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.journal import RequestJournal
from dalle_pytorch_tpu_torch.serving.router import Router, RouterConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Request
dalle = DALLE(dim=32, depth=2, num_text_tokens=16, text_seq_len=4, num_image_tokens=12,
              image_fmap_size=2, heads=2, dim_head=8, device="cpu").init_weights(
                  torch.Generator().manual_seed(0))
cfg = EngineConfig(max_batch=2, prefill_chunk=2, page_size=2, prefix_cache=True)
router = Router(dalle, RouterConfig(n_replicas=2), cfg, clock=FakeClock(step_dt=0.1),
                journal=RequestJournal({str(tmp_path / "j.jsonl")!r}), device="cpu")
for i in range(3):
    assert router.submit(Request(f"r{{i}}", np.arange(1, 5, dtype=np.int32), 4, seed=i)) is None
for _ in range(3):
    router.step()
router.faults.arm("replica_crash", 1)
router.run(max_steps=500)
router.shutdown(snapshot_dir={str(tmp_path / "snap")!r})
assert all(r.outcome.value == "completed" for r in router.results.values())
assert RequestJournal.verify({str(tmp_path / "j.jsonl")!r}) == (True, "ok")
eng = Engine(dalle, cfg, device="cpu")
assert eng.load_prefix_snapshot({str(tmp_path / "snap")!r})
spec = Engine(dalle, EngineConfig(max_batch=2, prefill_chunk=2, page_size=2, fused_iteration=True,
                                  spec_decode=True, controller=True,
                                  control=ControlConfig(interval=2)), device="cpu")
spec.submit(Request("s", np.arange(1, 5, dtype=np.int32), 4))
spec.run(max_steps=200)
assert spec.controller.log
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "dalle_pytorch_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr


def test_pretrained_vae_trainer_epoch_runs_with_jax_unimportable(tmp_path):
    """An epoch of the trainer command line with ``--taming`` on a
    VQGAN's ``model.yaml`` and ``last.ckpt``, and the OpenAI dVAE's
    loader on whole-module pickles whose classes are gone, where jax, the
    JAX package and the card's missing host packages cannot be
    imported."""
    code = """
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu", "PIL", "regex", "msgpack",
           "tokenizers", "ftfy")
for name in BLOCKED:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from dalle_pytorch_tpu_torch.models.pretrained import OpenAIDiscreteVAE, load_torch_checkpoint
from dalle_pytorch_tpu_torch.models.vqgan import VQGanVAE
from dalle_pytorch_tpu_torch.testing import write_caption_folder, write_pretrained_files
from dalle_pytorch_tpu_torch.train_dalle import main
from dalle_pytorch_tpu_torch.utils.checkpoint import load_checkpoint
write_caption_folder("data", 4, 16, seed=1)
vae = VQGanVAE(image_size=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
               z_channels=64, n_embed=24, embed_dim=64, device="cpu").init_weights(
                   torch.Generator().manual_seed(0))
paths = write_pretrained_files("vqgan", vae)
main(["--image_text_folder", "data", "--taming", "--vqgan_config_path",
      paths["vqgan_config_path"], "--vqgan_model_path", paths["vqgan_model_path"], "--dim", "32",
      "--depth", "1", "--heads", "2", "--dim_head", "16", "--text_seq_len", "8",
      "--truncate_captions", "--epochs", "1", "--batch_size", "2"], device="cpu")
state, meta = load_checkpoint("dalle.ckpt")
assert meta["vae_class"] == "VQGanVAE" and "vae_params" not in state
dvae = OpenAIDiscreteVAE(image_size=16, num_tokens=16, n_hid=8, device="cpu")
dpaths = write_pretrained_files("dvae", dvae.init_weights(torch.Generator().manual_seed(1)))
sd = load_torch_checkpoint(dpaths["openai_enc_path"])
assert all(torch.equal(sd[k], v) for k, v in dvae.enc.state_dict().items())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m])
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
