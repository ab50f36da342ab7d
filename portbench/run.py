"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload gnet_sp.train --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout.  The cell names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``driver`` names the module
of ``portbench/drivers/`` that runs it); each per-layer metric is read by
``portbench/metrics/<name>.py``; the limits of the comparison that decides
``correct`` are ``portbench/checks/<workload>.json``.  The run sets up,
measures for ``--seconds`` (with ``--trace 1``: a fixed number of
dispatches under the profiler), checks the outputs against the plain
reference, prints each compared number beside its limit as the last lines
of standard error, and prints one JSON line as the last line of standard
output.  It exits with another code than 0, printing no result, where the
card is missing, the program is missing, or JAX was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "boxsegliver_tpu")


class Refused(SystemExit):
    """A run that must print no result."""


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def load_bench(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def resolve(bench: Dict, workload: str, root: Path = ROOT) -> Dict:
    """The cell, its configuration, traffic, limits and metric lists, found
    by the names in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / "portbench"
    config = load_json(root / conf["file"])
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(here / "checks" / f"{workload}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if mine(m)
                 and m["moves"] in reported]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def reader(name: str, root: Path = ROOT):
    """The ``read(records)`` function of metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(compared: Dict[str, float], limits: Dict[str, float]):
    """{name: {"value", "limit"}} and whether every number is within its
    limit; a number without a limit is printed, not judged."""
    out, ok = {}, True
    for name, value in compared.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is not None and not (value <= limit):
            ok = False
    return out, ok


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


class Context:
    """What a driver gets: the cell's files, the seed, the device, the
    scratch directory, and the harness's hooks (set-up mark, profiler,
    trace reduction, peak memory)."""

    def __init__(self, spec: Dict, seed: int, seconds: float, trace: bool,
                 device, tmp: Path):
        self.cell, self.config = spec["cell"], spec["config"]
        self.traffic = spec["traffic"]
        self.seed = seed % (2 ** 62)
        self.program_seed = seed % (2 ** 31)
        self.seconds, self.trace = seconds, trace
        self.device, self.tmp = device, tmp
        self.setup_s: Optional[float] = None

    def setup_done(self):
        self.setup_s = time.perf_counter() - T_START

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def reduce(self, prof):
        from portbench import trace
        return trace.reduce(prof)

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())

    def free(self):
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def set_cache_dirs():
    """Fixed cache directories inside the checkout, set before torch loads;
    JAX stays unloaded in any library that would take it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # torch.utils.tensorboard (the program's summaries) imports TensorFlow
    # where it is installed, and TensorFlow imports JAX; tensorboard's own
    # TF-free build is marked by this module, which makes it use its stub
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))


def execute(spec: Dict, seed: int, seconds: float, trace: bool, device,
            tmp: Path) -> Dict:
    """Run the cell's driver and assemble the result line (without the
    device's name)."""
    ctx = Context(spec, seed, seconds, trace, device, tmp)
    driver = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    out = driver.measure(ctx)
    metrics = {}
    if trace:
        rec = out["records"]
        for m in spec["per_layer"]:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks, ok = judge(out["compared"], spec["limits"])
    result = {"correct": bool(ok and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "count": int(spec["cell"]["chips"]),
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        rec = out["records"]
        result["device"].update(busy_s=rec["busy_s"],
                                window_s=rec["window_s"])
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_cache_dirs()
    spec = resolve(load_bench(), a.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(f"{a.workload} needs {chips} CUDA device(s); torch "
                      f"sees {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        result = execute(spec, a.seed, a.seconds, bool(a.trace), device,
                         Path(tmp))
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded in the measuring process: {found}")
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        **{k: v for k, v in result["device"].items()
                           if k != "platform"}}
    for name, c in result["checks"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']!r}"
        print(f"check {name} = {c['value']!r} {limit}", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        sys.exit(2)
