"""The two tuning choices of B2's backward on one card, each timed against
its alternatives at the training shapes that take it (bf16, device time
per launch by chip_smoke.graph_ms, inputs cycled past the L2, the best of
two turns):

- ``--parts``: how many parts a fused staged CTA loads its chunk of g and
  x̂ in, each on its own mbarrier so the sums start on the first part
  (csrc/in_relu.cu kStageParts).  Builds copies of csrc/in_relu.cu with
  kStageParts = 1, 2 and 4 into build/tune/ and times B2f under the plan's
  cluster and its neighbours (chip_smoke.bwd_alternatives).
- ``--splits``: B2a's CTAs a plane on the split plan (ops/kernels
  STATS_TARGET_CTAS) at UNet3D's level 0 and the 3-D eval's, through the
  wrapper with the plan's splits replaced.

Every variant is held against the plain version first (dx within one bf16
step, the sums within 1e-4 relative).  Needs one CUDA card:

    python tools/b2_bwd_tune.py --parts --splits
"""

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PARTS = (1, 2, 4)
PART_SHAPES = [(8, 64, 256, 256), (8, 128, 128, 128), (16, 128, 128, 128),
               (8, 256, 64, 64), (4, 60, 10, 128, 128), (4, 120, 10, 64, 64),
               (4, 240, 10, 32, 32)]
SPLITS = (4, 8, 9, 16, 24, 35, 64)
SPLIT_SHAPES = [(4, 30, 10, 256, 256), (1, 30, 24, 256, 256)]


def inputs(shape, dev):
    """One set of (g, x̂, rstd) and COLD_BYTES of sets in all."""
    from boxsegliver_torch.ops import kernels as K

    x, g, w, b = cs.b2_inputs(shape, torch.bfloat16, dev, 1)
    n_sets = max(1, min(20, math.ceil(cs.COLD_BYTES / (x.numel() * 2))))
    sets = []
    for i in range(n_sets):
        xi, gi, _, _ = cs.b2_inputs(shape, torch.bfloat16, dev, 1 + i)
        _, xhi, rstdi = K.in_relu_fwd(xi, w, b)
        sets.append((gi, xhi, rstdi))
    return sets, w, b


def close(dx, s1, ref, hw):
    err = (dx.float() - ref[0].float()).abs()
    ok_dx = bool((err <= 2.0 ** -7 * ref[0].float().abs() + 1e-5).all())
    ok_s = bool(((s1 - ref[1]).abs() <= 1e-4 * ref[1].abs()
                 + 1e-6 * math.sqrt(hw)).all())
    return ok_dx and ok_s


def build_parts():
    """{parts: the in_relu_bwd C function of a copy built with that many}."""
    from boxsegliver_torch.csrc import build

    src = (build.CSRC / "in_relu.cu").read_text()
    out = ROOT / "build" / "tune"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for parts in PARTS:
        path = out / f"in_relu_parts{parts}.cu"
        path.write_text(re.sub(r"constexpr int kStageParts = \d+;",
                               f"constexpr int kStageParts = {parts};", src))
        lib = out / f"libin_relu_parts{parts}.so"
        procs[parts] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for parts, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for kStageParts {parts}:\n{log}")
        fn = ctypes.CDLL(str(lib)).in_relu_bwd
        fn.argtypes = build._ARGTYPES["in_relu"]["in_relu_bwd"]
        fn.restype = ctypes.c_int
        fns[parts] = fn
    return fns


def parts_phase(dev):
    from boxsegliver_torch.ops import kernels as K

    fns = build_parts()
    for shape in PART_SHAPES:
        planes, hw = shape[0] * shape[1], math.prod(shape[2:])
        sets, w, b = inputs(shape, dev)
        ref = K.in_relu_bwd_plain(sets[0][0], sets[0][1], w, b, sets[0][2])
        bound = cs.b2_bound_ms("in_relu_bwd", shape)[0]
        row = []
        for name, plan in cs.bwd_alternatives(planes, hw,
                                              torch.bfloat16).items():
            if plan.path != K.FWD_STAGED:
                continue
            for parts, fn in fns.items():
                def call(i, fn=fn, plan=plan):
                    g, xh, rstd = sets[i]
                    dx = torch.empty_like(g)
                    s1 = torch.empty(shape[:2], dtype=torch.float32,
                                     device=dev)
                    s2 = torch.empty_like(s1)
                    rc = fn(g.data_ptr(), xh.data_ptr(), w.data_ptr(),
                            b.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                            s1.data_ptr(), s2.data_ptr(), planes, shape[1],
                            hw, 1, plan.path, plan.packs, plan.cluster,
                            plan.smem_bytes,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"in_relu_bwd: CUDA error {rc}")
                    return dx, s1, s2
                dx, s1, _ = call(0)
                torch.cuda.synchronize()
                if not close(dx, s1, ref, hw):
                    raise AssertionError(f"kStageParts {parts} {shape} "
                                         f"x{plan.cluster} disagrees")
                ms = min(cs.graph_ms(call, len(sets), 20) for _ in range(2))
                row.append(f"{name} x{plan.cluster} parts {parts} {ms:.4f} "
                           f"({bound / ms:.1%})")
        print(f"  B2f staged {shape}: " + "; ".join(row), flush=True)


def splits_phase(dev):
    from boxsegliver_torch.ops import kernels as K

    for shape in SPLIT_SHAPES:
        planes, hw = shape[0] * shape[1], math.prod(shape[2:])
        sets, w, b = inputs(shape, dev)
        g, xh, _ = sets[0]
        ref = K.in_relu_bwd_stats_plain(g, xh, w, b)
        base = K.in_relu_bwd_split_plan(planes, hw, torch.bfloat16)
        bound = cs.b2_bound_ms("in_relu_bwd_stats", shape)[0]
        row = []
        for splits in SPLITS:
            chunk = -(-(hw // 8) // splits) * 8
            plan = base._replace(splits=-(-hw // chunk), chunk=chunk)
            s1, s2 = K.in_relu_bwd_stats(g, xh, w, b, plan)
            torch.cuda.synchronize()
            if not bool(((s1 - ref[0]).abs() <= 1e-4 * ref[0].abs()
                         + 1e-6 * math.sqrt(hw)).all()):
                raise AssertionError(f"B2a x{plan.splits} {shape} disagrees")
            ms = min(cs.graph_ms(lambda i, plan=plan: K.in_relu_bwd_stats(
                sets[i][0], sets[i][1], w, b, plan), len(sets), 20)
                for _ in range(2))
            row.append(f"x{plan.splits} ({plan.splits * planes} CTAs) "
                       f"{ms:.4f} ({bound / ms:.1%})")
        print(f"  B2a split {shape} (plan: x{base.splits}): "
              + "; ".join(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--splits", action="store_true")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b2_bwd_tune: needs a CUDA card", file=sys.stderr)
        return 2
    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.csrc import build

    config_mod.resolve_device("cuda")
    build.build_all()
    dev = torch.device("cuda")
    print(cs.smi(), flush=True)
    if opts.parts:
        parts_phase(dev)
    if opts.splits:
        splits_phase(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
