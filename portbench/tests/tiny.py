"""Tiny forms of the benchmark's configurations for CPU tests: the same
files with the TINY model widths, small images and few steps."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _set(flags, name, *values):
    flags = list(flags)
    if name in flags:
        i = flags.index(name)
        j = i + 1
        while j < len(flags) and not flags[j].startswith("--"):
            j += 1
        flags[i + 1:j] = list(values)
    else:
        flags += [name, *values]
    return flags


def tiny_config(name: str):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg = copy.deepcopy(cfg)
    s, m = cfg["settings"], cfg["model"]
    f = cfg["flags"] + cfg.pop("train_flags")
    if m["arch"] == "GUNet":
        m.update(init_channels=8, num_down_samples=2, mod_layers=[1, 2],
                 context_fc_channels=[16, 16])
        f = _set(f, "--model_config", "GUNet_TINY.yml")
        f = _set(f, "--im_height", "32")
        f = _set(f, "--im_width", "32")
        f = _set(f, "--batch_size", "2")
        f = _set(f, "--log_step", "4")
        s.update(im_height=32, im_width=32, batch_size=2)
        cfg["data"]["shape"] = [8, 64, 64]
        cfg["cases"] = {"train": 2, "test": 1}
    else:
        f = _set(f, "--compute_dtype", "float32")
        s["compute_dtype"] = "float32"
        f = _set(f, "--im_height", "32")
        f = _set(f, "--im_width", "32")
        f = _set(f, "--batch_size", "2")
        f = _set(f, "--log_step", "4")
        s.update(im_height=32, im_width=32, batch_size=2)
        cfg["data"]["shape"] = [16, 96, 96]
        cfg["cases"] = {"train": 2, "test": 1}
    cfg["flags"], cfg["train_flags"] = f, []
    return cfg


def bench_with(cell: str):
    """BENCHMARK.json with ``cell`` added where it is not a cell of it (the
    3-D whole-volume eval, kept in portbench/ for a later PR: PERF.md §7),
    reporting what the eval cells report."""
    from portbench import run

    bench = copy.deepcopy(run.load_bench())
    if cell not in {w["name"] for w in bench["workloads"]}:
        config, traffic = {"unet3d.eval": ("unet3d", "eval_whole")}[cell]
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "gnet_sp.eval_g" in m.get("workloads", []):
                m["workloads"].append(cell)
    return bench
