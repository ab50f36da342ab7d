"""No module that a run loads is JAX's or the JAX package's, and the
reference loads nothing of the program (top-level names compared whole:
the port's name begins with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN_MODULES = ["portbench.run", "portbench.calibrate", "portbench.data",
               "portbench.drivers.train", "portbench.drivers.eval_sweep",
               "portbench.drivers.eval_volume3d", "portbench.trace",
               "portbench.flops", "boxsegliver_torch.cli.main",
               "boxsegliver_torch.train.trainer",
               "boxsegliver_torch.data.pipeline",
               "boxsegliver_torch.data.sampler",
               "boxsegliver_torch.data.sampler3d",
               "boxsegliver_torch.data.device_cache",
               "boxsegliver_torch.data.pipeline3d",
               "boxsegliver_torch.evaluators.volume",
               "boxsegliver_torch.evaluators.volume3d",
               "boxsegliver_torch.interactive.device_sweep"]
REF_MODULES = ["portbench.reference.nets", "portbench.reference.train",
               "portbench.reference.eval3d", "portbench.reference.sweep",
               "portbench.weights", "portbench.flops"]


def _loaded(modules, pre=""):
    code = (pre + "import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import glob, os, importlib.util\n"
            "for p in sorted(glob.glob('portbench/metrics/*.py')):\n"
            "    if {with_metrics}:\n"
            "        s = importlib.util.spec_from_file_location('m', p)\n"
            "        s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    return code


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    pre = "from portbench import run\nrun.set_cache_dirs()\n"
    tops = _tops(_loaded(RUN_MODULES, pre).replace("{with_metrics}", "True"))
    assert not tops & {"jax", "jaxlib", "flax", "boxsegliver_tpu"}
    assert "boxsegliver_torch" in tops


def test_reference_loads_no_program():
    tops = _tops(_loaded(REF_MODULES).replace("{with_metrics}", "False"))
    assert not tops & {"jax", "jaxlib", "flax", "boxsegliver_tpu",
                       "boxsegliver_torch"}


def test_forbidden_names_are_whole_top_level_names():
    from portbench import run
    sys.modules.setdefault("boxsegliver_tpu_like", sys)
    try:
        assert "boxsegliver_tpu_like" not in run.forbidden_modules()
    finally:
        del sys.modules["boxsegliver_tpu_like"]
