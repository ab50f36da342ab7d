"""Kernel G1 before and after on one card: an earlier geodesic.cu (the
kernel before its redesign: one CTA a field, C interface
geodesic2d_raster(img, seeds, dist, n, h, w, lamb, iters, stream)) against
the checkout's kernel, in turns (old, new, new, old).

    git show <commit>:boxsegliver_torch/csrc/geodesic.cu > .scratch/old.cu
    python tools/g1_ab.py --old .scratch/old.cu

Builds the old source with nvcc into build/ab/, holds both kernels on the
same inputs against the plain version (1e-5 of the field's largest finite value, +inf at the
same pixels), times each at the device refiner's fields of 256^2 and 512^2
slices ([64, 128, 128], [64, 256, 256]) with chip_smoke.g1_timed,
then runs the device refiner over the CLI's synthetic NF test cases with a
seeded full-width UNetInter.yml (bf16): geodesic guides with the old G1,
the new, the new, the old, and gaussian guides once, each split by
chip_smoke.refiner_split.  Needs one CUDA card."""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_old(src):
    """The old kernel as a function of (img, seeds) like geodesic2d_batch."""
    from boxsegliver_torch.csrc import build

    lib_path = ROOT / "build" / "ab" / "libgeodesic_old.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).geodesic2d_raster
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def old(img, seeds, lamb=1.0, iterations=4):
        out = torch.empty_like(img)
        rc = fn(img.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                *img.shape, float(lamb), int(iterations),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old geodesic2d_raster: CUDA error {rc}")
        return out

    return old


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="the earlier geodesic.cu")
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("g1_ab: no CUDA device visible", file=sys.stderr)
        return 2
    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.cli import interactive_eval as icli
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.ops import kernels
    from boxsegliver_torch.ops.geodesic import geodesic2d

    config_mod.resolve_device("cuda")
    dev = torch.device("cuda")
    kernel = {"old": build_old(opts.old), "new": kernels.geodesic2d_batch}
    rng = np.random.default_rng(opts.seed)
    for shape in ((64, 128, 128), (4, 256, 256), (2, 48, 257)):
        img, seeds = cs.g1_inputs(rng, *shape, dev, 2)
        ref = geodesic2d(img, seeds)
        errs = {name: cs.g1_err(fn(img, seeds), ref, f"{name} {shape}")
                for name, fn in kernel.items()}
        print(f"  G1 {list(shape)} vs plain (abs, rel): {errs}")

    for n, h, w in ((64, 128, 128), (64, 256, 256)):
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            times[name].append(cs.g1_timed(
                rng, dev, n, h, w, f"G1 {name}",
                kernel=kernel["old"] if name == "old" else None)["device_ms"])
        row = {k: min(v) * 1e3 / (2 * cs.G1_ITERATIONS * h)
               for k, v in times.items()}
        print(f"  G1 [{n}, {h}, {w}] device ms per launch (old, new, new, "
              f"old): old {times['old']}, new {times['new']}; per row step "
              f"old {row['old']:.4f} us, new {row['new']:.4f} us; "
              f"{cs.smi()}")

    with tempfile.TemporaryDirectory(prefix="g1_ab_") as tmp:
        cs.nf_dataset(tmp)
        md = Path(tmp) / "md"
        for kind, g1 in (("geodesic", "old"), ("geodesic", "new"),
                         ("geodesic", "new"), ("geodesic", "old"),
                         ("gaussian", None)):
            args = icli.build_parser().parse_args(cs.click_eval_argv(
                tmp, md, "on", kind))
            config_mod.fill_default_args(args)
            model = cli._build_model(args)
            model.reset_parameters(torch.Generator().manual_seed(opts.seed))
            res = cs.refiner_split(model.to(dev).eval(), args,
                                   cs.click_eval_cases(args), dev,
                                   g1=kernel["old"] if g1 == "old" else None)
            cs.print_split(f"device refiner, {kind} guides, G1 {g1 or '-'} "
                           "(seeded UNetInter.yml, bf16, 256^2)", res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
