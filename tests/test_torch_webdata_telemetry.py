"""The tar loader's telemetry events against the JAX package's, on the
shards of test_torch_webdata.py (its helpers: the same shards, the port's
dataset and JAX's with two attempts and no backoff): with both telemetry
layers on, a transient open fault, a dead shard (quarantined, then
skipped) and a mid-shard read fault give the same ``data.shard_open``,
``data.shard_quarantined`` and ``data.shard_abort`` events (url, the
counter each goes with, the error) in the same order, and each name is a
registered event of the port's ``telemetry_names``."""

import pytest
import torch

from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu.utils.telemetry import TELEMETRY as JTELEMETRY
from dalle_pytorch_tpu_torch.testing import reset_registries
from dalle_pytorch_tpu_torch.utils import telemetry_names
from dalle_pytorch_tpu_torch.utils.faults import FaultRegistry
from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY
from test_torch_webdata import _pair, clean_jax_registries, shards, toks  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _telemetry():
    reset_registries()
    TELEMETRY.configure(enabled=True)
    JTELEMETRY.configure(enabled=True)
    yield
    reset_registries()


def _events(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records
            if r.get("name", "").startswith("data.")]


CASES = {
    "transient_open": ("{0000..0000}", {"shard_open": 1}, 1),
    "dead_shard": ("{0000..0001}", {"shard_open": 2}, 2),
    "midshard_abort": ("{0001..0002}", {"shard_read": 1}, 1),
}


@pytest.mark.parametrize("case", CASES)
def test_shard_events_equal_jax(shards, toks, case):
    shard_range, arm, passes = CASES[case]
    spec = shards[0].replace("{0000..0002}", shard_range)
    faults = FaultRegistry()
    jds, ds = _pair(spec, toks, faults=faults)
    for site, n in arm.items():
        FAULTS.arm(site, n)
        faults.arm(site, n)
    for _ in range(passes):
        assert len(list(jds)) == len(list(ds))
    ours, theirs = _events(TELEMETRY.records()), _events(list(JTELEMETRY._buf))
    assert ours == theirs and ours
    names = {e["name"] for e in ours}
    assert names <= {"data.shard_open", "data.shard_quarantined", "data.shard_abort"}
    assert all(telemetry_names.is_registered(n, "event") for n in names)
    if case == "dead_shard":
        assert [e["name"] for e in ours].count("data.shard_quarantined") == 1
    if case == "midshard_abort":
        assert "data.shard_abort" in names
