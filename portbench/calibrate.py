"""Readings that set the limits of a cell's comparison: for each seed, the
program's readings against the reference (the lower reading), and on the
first seeds the control's (the reference in float8 e4m3 operands, the
precision below the configurations' bf16) and the planted faults' (the
upper readings), as the cell's driver defines them (``calibrate`` of
``portbench/drivers/<driver>.py``).  No measured window.

    python3 -m portbench.calibrate --workload gnet_sp.train \
        --seeds 11 12 13 --controls 3

Prints one JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
from pathlib import Path

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3,
                   help="seeds (the first ones) that also read the control "
                        "and the faults")
    a = p.parse_args(argv)
    run.set_cache_dirs()
    import torch

    spec = run.resolve(run.load_bench(), a.workload)
    driver = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(a.seeds):
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            ctx = run.Context(spec, seed, 0.0, False, dev, Path(tmp))
            rows = driver.calibrate(ctx, i < a.controls)
            for kind, numbers in rows.items():
                print(json.dumps({"workload": a.workload, "seed": seed,
                                  "reading": kind, **numbers}), flush=True)
            ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
