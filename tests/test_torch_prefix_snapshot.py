"""The port's prefix-cache snapshots (``Engine.save_prefix_snapshot`` /
``load_prefix_snapshot``) against the JAX package's on the CPU: JAX's ten
snapshot cases (``tests/test_recovery.py``, ``TestSnapshot`` and
``TestQuantSnapshot``) on the port, on the recovery tests' tiny DALLE
(pages of 2, so the terminal prompt page is partial and a restored full
hit copies it on write), converted, greedy, the split path with chunks
of 2.

Held against JAX: the snapshot's records (chain digests, parents, token
blocks, starts, arena pages, payload flags) and KV format tag equal those
of JAX's snapshot of the same run; a warm request served from a restored
snapshot takes a full hit and its tokens are bitwise its cold run's and
JAX's. Every rejection is typed and counted (``serve.snapshot.rejected``)
and leaves the engine cold, serving bitwise cold tokens. A snapshot
written by the JAX package is refused by the port as a foreign format:
its leaves are named by JAX's flax tree paths ("cache leaf paths
differ"), and the port's pools are not JAX's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.prefix_cache import verify_snapshot_records
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.utils.metrics import counters
from dalle_pytorch_tpu_torch.utils.resilience import write_dir_manifest
from dalle_pytorch_tpu_torch.testing import reset_registries

torch.set_num_threads(1)

PAGE = 2
GREEDY = 0.99  # k = max(int(0.01 * 32 total tokens), 1) = 1
RECOVERY = dict(dim=32, depth=2, num_text_tokens=16, text_seq_len=4, num_image_tokens=12,
                image_fmap_size=2, heads=2, dim_head=8, attn_types=("full",),
                shift_tokens=True, rotary_emb=True)
ENGINE = dict(max_batch=2, prefill_chunk=2, filter_thres=GREEDY)


def recovery_models():
    """(JAX DALLE, its params, the converted port DALLE on the CPU): the
    model of the JAX package's router and recovery tests."""
    jdalle = JDALLE(**RECOVERY)
    rng = np.random.RandomState(0)
    text = jnp.asarray(rng.randint(1, 16, size=(2, 4)), jnp.int32)
    image = jnp.asarray(rng.randint(0, 12, size=(2, 4)), jnp.int32)
    params = jdalle.init(jax.random.key(0), text, image)["params"]
    model = DALLE(**RECOVERY, device="cpu", dtype=torch.float32)
    model.load_state_dict(dalle_state_dict(jax.device_get(params)))
    return jdalle, params, model


@pytest.fixture(scope="module")
def models():
    return recovery_models()


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    reset_registries()
    FAULTS.reset()
    yield
    reset_registries()
    FAULTS.reset()


def prompt(i=0):
    return np.random.RandomState(100 + i).randint(1, 16, size=(4,)).astype(np.int32)


def req(i, seed, cls=Request, rid=None):
    return cls(request_id=rid or f"r{i}", prompt=prompt(i), max_new_tokens=4, seed=seed)


def run_port(models, requests, snapshot_dir=None, load_from=None, prefix_cache=True, **kw):
    """One port engine run: (engine, results, restored)."""
    eng = Engine(models[2], EngineConfig(prefix_cache=prefix_cache, page_size=PAGE,
                                         **ENGINE, **kw),
                 clock=FakeClock(step_dt=0.1), device="cpu")
    restored = eng.load_prefix_snapshot(load_from) if load_from is not None else None
    for r in requests:
        assert eng.submit(r) is None
    results = eng.run(max_steps=2000)
    eng.verify_invariants(idle=True)
    if snapshot_dir is not None:
        eng.save_prefix_snapshot(snapshot_dir)
    return eng, results, restored


def run_jax(models, requests, snapshot_dir=None, load_from=None, **kw):
    eng = JEngine(models[0], models[1], JEngineConfig(prefix_cache=True, **ENGINE, **kw),
                  clock=JFakeClock(step_dt=0.1))
    restored = eng.load_prefix_snapshot(load_from) if load_from is not None else None
    for r in requests:
        assert eng.submit(r) is None
    results = eng.run(max_steps=2000)
    if snapshot_dir is not None:
        eng.save_prefix_snapshot(snapshot_dir)
    return eng, results, restored


def cold_tokens(models, request, **kw):
    _, results, _ = run_port(models, [request], prefix_cache=False, **kw)
    return results[request.request_id].tokens


def records(snap):
    index = json.loads((snap / "index.json").read_text())
    return [{k: v for k, v in rec.items() if k != "content_sha256"} for rec in index["nodes"]]


def rejected_cold(models, snap, request, **kw):
    """Load ``snap`` into a fresh engine that then serves ``request``:
    the load must reject, counted once, and the request run cold."""
    rejected0 = counters.get("serve.snapshot.rejected")
    eng, res, restored = run_port(models, [request], load_from=str(snap), **kw)
    assert restored is False
    assert counters.get("serve.snapshot.rejected") == rejected0 + 1
    assert eng.prefix.stats.hits == 0
    out = res[request.request_id]
    assert out.outcome is Outcome.COMPLETED
    np.testing.assert_array_equal(out.tokens, cold_tokens(models, request, **kw))


def test_records_equal_jax_snapshot(models, tmp_path):
    """The same run snapshotted by both packages: the same chain records
    and format tag."""
    for kv_quant in (None, "int8"):
        ours, theirs = tmp_path / f"port_{kv_quant}", tmp_path / f"jax_{kv_quant}"
        run_port(models, [req(0, 11), req(1, 12)], snapshot_dir=str(ours), kv_quant=kv_quant)
        run_jax(models, [req(0, 11, JRequest), req(1, 12, JRequest)], snapshot_dir=str(theirs),
                kv_quant=kv_quant)
        assert records(ours) == records(theirs) and len(records(ours)) >= 4
        a, b = (json.loads((p / "index.json").read_text()) for p in (ours, theirs))
        assert a["kv_format"] == b["kv_format"] and a["T"] == b["T"]
        assert a["page_size"] == b["page_size"] == PAGE


def test_jax_snapshot_refused_as_foreign_format(models, tmp_path, monkeypatch):
    snap = tmp_path / "jax_snapshot"
    run_jax(models, [req(0, 11, JRequest)], snapshot_dir=str(snap))
    reasons, reject = [], Engine._reject_snapshot
    monkeypatch.setattr(Engine, "_reject_snapshot",
                        lambda self, reason: reasons.append(reason) or reject(self, reason))
    rejected_cold(models, snap, req(0, 77, rid="warm"))
    assert reasons == ["cache leaf paths differ"]


# ---------------------------------------------------- JAX's TestSnapshot


def test_roundtrip_warm_hit_bit_identical(models, tmp_path):
    snap = str(tmp_path / "prefix_snapshot")
    run_port(models, [req(0, 11)], snapshot_dir=snap)
    warm = req(0, 77, rid="warm")
    eng, res, restored = run_port(models, [warm], load_from=snap)
    assert restored is True and counters.get("serve.snapshot.restored") == 1
    assert eng.prefix.stats.hits >= 1 and eng.cached_draws == 1  # a full hit
    assert res["warm"].outcome is Outcome.COMPLETED
    np.testing.assert_array_equal(res["warm"].tokens, cold_tokens(models, warm))
    jsnap = str(tmp_path / "jax_snapshot")
    run_jax(models, [req(0, 11, JRequest)], snapshot_dir=jsnap)
    _, jres, jrestored = run_jax(models, [req(0, 77, JRequest, rid="warm")], load_from=jsnap)
    assert jrestored is True
    np.testing.assert_array_equal(res["warm"].tokens, jres["warm"].tokens)


def test_snapshot_corrupt_rejects_to_cold(models, tmp_path):
    snap = tmp_path / "prefix_snapshot"
    run_port(models, [req(0, 11)], snapshot_dir=str(snap))
    eng = Engine(models[2], EngineConfig(prefix_cache=True, page_size=PAGE, **ENGINE),
                 clock=FakeClock(step_dt=0.1), device="cpu")
    eng.faults.arm("snapshot_corrupt", 1)
    assert eng.load_prefix_snapshot(str(snap)) is False
    assert counters.get("serve.fault_snapshot_corrupt") == 1
    assert counters.get("serve.snapshot.rejected") == 1 and len(eng.prefix) == 0
    assert eng.submit(req(3, 33)) is None
    np.testing.assert_array_equal(eng.run(max_steps=2000)["r3"].tokens,
                                  cold_tokens(models, req(3, 33)))
    eng.verify_invariants(idle=True)


def test_uncommitted_dir_rejected(models, tmp_path):
    snap = tmp_path / "prefix_snapshot"
    run_port(models, [req(0, 11)], snapshot_dir=str(snap))
    (snap / "COMMITTED").unlink()
    rejected_cold(models, snap, req(1, 22))


def test_duplicate_and_incoherent_snapshots_reject_typed(models, tmp_path):
    snap = tmp_path / "prefix_snapshot"
    run_port(models, [req(0, 11)], snapshot_dir=str(snap))
    index = json.loads((snap / "index.json").read_text())
    ok, reason = verify_snapshot_records([index["nodes"][0], dict(index["nodes"][0])],
                                         int(index["page_size"]))
    assert not ok and "duplicate" in reason
    tampered = dict(index, dtypes=dict(index["dtypes"], pages_l0="float16"))
    (snap / "index.json").write_text(json.dumps(tampered, sort_keys=True))
    write_dir_manifest(str(snap))
    rejected_cold(models, snap, req(1, 22))
    with np.load(snap / "arrays.npz") as z:
        kept = {k: z[k] for k in z.files if not k.startswith("ring")}
    np.savez(snap / "arrays.npz", **kept)
    (snap / "index.json").write_text(json.dumps(index, sort_keys=True))
    write_dir_manifest(str(snap))
    rejected_cold(models, snap, req(2, 23))


def test_chain_digest_catches_re_manifested_tamper(models, tmp_path):
    snap = tmp_path / "prefix_snapshot"
    run_port(models, [req(0, 11)], snapshot_dir=str(snap))
    index = json.loads((snap / "index.json").read_text())
    index["nodes"][0]["tokens"][0] += 1
    (snap / "index.json").write_text(json.dumps(index, sort_keys=True))
    write_dir_manifest(str(snap))
    rejected_cold(models, snap, req(1, 22))


# ----------------------------------------------- JAX's TestQuantSnapshot


def quant_snapshot(models, tmp_path):
    snap = tmp_path / "prefix_snapshot"
    run_port(models, [req(0, 11)], snapshot_dir=str(snap), kv_quant="int8")
    index = json.loads((snap / "index.json").read_text())
    scale_key = next(f"pages_l{j}" for j, p in enumerate(index["leaf_paths"])
                     if "scale_pages" in p)
    return snap, index, scale_key


def test_quant_roundtrip_dtype_exact_warm_hit_bit_identical(models, tmp_path):
    snap, index, _ = quant_snapshot(models, tmp_path)
    page_dtypes = sorted({v for k, v in index["dtypes"].items() if k.startswith("pages_")})
    assert "int8" in page_dtypes and "float32" in page_dtypes
    assert index["kv_format"].startswith("kv:int8:")
    assert len([p for p in index["leaf_paths"] if "scale_pages" in p]) >= 2
    assert all("content_sha256" in r for r in index["nodes"])
    warm = req(0, 77, rid="warm")
    eng, res, restored = run_port(models, [warm], load_from=str(snap), kv_quant="int8")
    assert restored is True and eng.prefix.stats.hits >= 1
    np.testing.assert_array_equal(res["warm"].tokens, cold_tokens(models, warm, kv_quant="int8"))


def test_quant_cross_format_restore_rejected(models, tmp_path):
    snap, _, _ = quant_snapshot(models, tmp_path)
    rejected_cold(models, snap, req(1, 22))


def test_quant_foreign_dtype_cast_rejected(models, tmp_path):
    snap, index, scale_key = quant_snapshot(models, tmp_path)
    index["dtypes"][scale_key] = "float16"
    (snap / "index.json").write_text(json.dumps(index, sort_keys=True))
    write_dir_manifest(str(snap))
    rejected_cold(models, snap, req(1, 22), kv_quant="int8")


def test_quant_scale_length_mismatch_rejected(models, tmp_path):
    snap, _, scale_key = quant_snapshot(models, tmp_path)
    with np.load(snap / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays[scale_key] = arrays[scale_key][:-1]
    np.savez(snap / "arrays.npz", **arrays)
    write_dir_manifest(str(snap))
    rejected_cold(models, snap, req(1, 22), kv_quant="int8")


def test_quant_content_digest_catches_re_manifested_scale_tamper(models, tmp_path):
    snap, _, scale_key = quant_snapshot(models, tmp_path)
    with np.load(snap / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    tampered = arrays[scale_key].copy()
    tampered.reshape(-1)[0] ^= 0xFF
    arrays[scale_key] = tampered
    np.savez(snap / "arrays.npz", **arrays)
    write_dir_manifest(str(snap))
    rejected_cold(models, snap, req(1, 22), kv_quant="int8")
