"""On a card: a whole traced run of each cell at its tiny size reads
device activity from the profiler, reports every per-layer metric the
cell lists, and keeps every roofline and peak share at or under 100 %."""

import tempfile
from pathlib import Path

import pytest
import torch

from portbench import run
from tiny import bench_with, tiny_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profiler's device trace")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell,config", [("gnet_sp.train", "gnet_sp"),
                                         ("unet3d.train", "unet3d"),
                                         ("gnet_sp.eval_g", "gnet_sp"),
                                         ("unet3d.eval", "unet3d")])
def test_traced_run_on_the_card(dev, cell, config):
    spec = run.resolve(bench_with(cell), cell)
    spec["config"] = tiny_config(config)
    spec["traffic"] = dict(spec["traffic"], steps_per_dispatch=4,
                           trace_dispatches=2, trace_cases=2)
    with tempfile.TemporaryDirectory() as tmp:
        res = run.execute(spec, 2 ** 31 + 3, 0.5, True, dev, Path(tmp))
    assert res["device"]["busy_s"] > 0
    assert res["device"]["busy_s"] <= res["device"]["window_s"]
    assert set(res["metrics"]) == {m["name"] for m in spec["per_layer"]}
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
    assert res["breakdown"]["device_ops"]
