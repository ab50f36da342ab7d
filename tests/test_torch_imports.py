"""The port stands alone: no file of boxsegliver_torch/ nor chip_smoke.py
imports JAX, flax, optax, orbax, the JAX package, OpenCV, PyYAML or
matplotlib (the GPU machine has none of them), and every module imports
without them."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "boxsegliver_tpu",
             "cv2", "yaml", "matplotlib"}
PORT_FILES = sorted((ROOT / "boxsegliver_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


TRAIN_SLICE = ["ops/losses.py", "ops/image_ops.py", "ops/metrics.py",
               "data/sampler.py", "data/device_cache.py", "data/pipeline.py",
               "train/solver.py", "train/hooks.py", "train/checkpoint.py",
               "train/trainer.py", "utils/summary.py",
               "evaluators/online2d.py", "csrc/in_relu.cu"]


@pytest.mark.parametrize("rel", TRAIN_SLICE)
def test_train_slice_modules_are_checked(rel):
    """The training slice's modules exist and fall under the checks above
    (the CUDA source is built, not imported)."""
    path = ROOT / "boxsegliver_torch" / rel
    assert path.exists()
    assert path.suffix == ".cu" or path in PORT_FILES


HOST_TOOLS = ["cli/prepare.py", "cli/viewer.py", "cli/vis.py",
              "cli/compare_preds.py", "cli/annotate.py", "utils/viewer.py",
              "utils/ckpt_tools.py", "ops/glcm.py"]


@pytest.mark.parametrize("rel", HOST_TOOLS)
def test_host_tool_modules_are_checked(rel):
    """The data-preparation CLI, the viewers and the annotator exist and
    fall under the checks above."""
    assert ROOT / "boxsegliver_torch" / rel in PORT_FILES


DIST_SLICE = ["parallel/__init__.py", "parallel/mesh.py"]


@pytest.mark.parametrize("rel", DIST_SLICE)
def test_parallel_modules_are_checked(rel):
    """The data-parallel modules (the ranks of a multi-GPU run import them
    in processes of their own) exist and fall under the checks above."""
    assert ROOT / "boxsegliver_torch" / rel in PORT_FILES


def test_port_imports_without_the_jax_stack():
    """Import every port module in a fresh interpreter where the forbidden
    packages cannot be found."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT_FILES if p.name != "chip_smoke.py")
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules] + ["chip_smoke"]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {sorted(FORBIDDEN)!r}:\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert importlib.util.find_spec("boxsegliver_torch") is not None
