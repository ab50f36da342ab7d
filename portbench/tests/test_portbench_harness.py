"""The harness finds every cell, configuration, traffic mix, limit file and
per-layer reader by the names in BENCHMARK.json; BENCHMARK.json keeps to
the benchmark's contract; and a new cell, configuration, traffic mix and
metric are added by adding files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    spec = run.resolve(BENCH, cell)
    assert spec["cell"]["chips"] in (1, 4)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["driver"]
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    for m in spec["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_config_files_hold_their_reductions():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])


def test_judge_limits():
    checks, ok = run.judge({"a": 0.5, "b": 2.0}, {"a": 1.0})
    assert ok and checks["b"]["limit"] is None
    assert not run.judge({"a": float("nan")}, {"a": 1.0})[1]
    assert not run.judge({"a": 1.5}, {"a": 1.0})[1]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    limit file and a per-layer metric by new files and new entries; the
    harness resolves the new cell and reads the new metric unchanged."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "gnet_sp.json").read_text())
    cfg["name"] = "gnet_sp_bs16"
    (pb / "configs" / "gnet_sp_bs16.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "train_k8.json").write_text(json.dumps(
        {"driver": "train", "steps_per_dispatch": 8, "host_workers": 1,
         "trace_dispatches": 4}))
    (pb / "checks" / "gnet_sp_bs16.train_k8.json").write_text(json.dumps(
        {"loss_gap": 1.0, "grad1_gap": 1.0, "change3_gap": 1.0}))
    (pb / "metrics" / "steps_traced.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    bench["configs"].append({"name": "gnet_sp_bs16", "source": "x",
                             "file": "portbench/configs/gnet_sp_bs16.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gnet_sp_bs16.train_k8",
                               "config": "gnet_sp_bs16",
                               "traffic": "train_k8", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("gnet_sp_bs16.train_k8")
    bench["per_layer"].append({"name": "steps_traced", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "train loop",
                               "moves": "train_samples_per_s",
                               "workloads": ["gnet_sp_bs16.train_k8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.resolve(run.load_bench(tmp_path), "gnet_sp_bs16.train_k8",
                       root=tmp_path)
    assert spec["config"]["name"] == "gnet_sp_bs16"
    assert spec["traffic"]["steps_per_dispatch"] == 8
    assert [m["name"] for m in spec["per_layer"]] == ["steps_traced"]
    assert run.reader("steps_traced", root=tmp_path)({"steps": 3}) == 3.0


def test_unknown_workload_is_refused():
    with pytest.raises(run.Refused):
        run.resolve(BENCH, "no.such")
