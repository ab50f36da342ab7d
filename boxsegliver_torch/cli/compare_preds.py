"""Prediction parity checker: compare two directories of saved predictions
voxel by voxel (port of boxsegliver_tpu/cli/compare_preds.py; BASELINE.md
row 3 — "saved predictions match the TF reference slice-for-slice").

Both sides are the artifact format produced by `--save_predict`
(predict-<pid>.nii.gz summed class maps, evaluators/volume.py save_case —
the same format the reference's maybe_save_case writes,
evaluator_liver.py:998-1026) or prob .npz dumps.

The day real LiTS/NF volumes are mounted, the one-command procedure is:

    # 1. dump reference predictions with the TF1 repo (--save_predict), then
    # 2. dump ours:
    python -m boxsegliver_torch.cli.main liver --mode infer --tag X \
        --model UNet ... --save_predict --pred_type pred
    # 3. compare:
    python -m boxsegliver_torch.cli.compare_preds <ref_dir> <ours_dir> \
        --classes Liver Tumor --min_dice 0.995

Prints per-case voxel-identical %, per-class Dice, and aggregates; exits 1
if any class mean Dice falls below --min_dice (so it can gate CI).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load(path: Path) -> np.ndarray:
    if path.suffix == ".npz":
        return np.load(path)["arr_0"]
    from boxsegliver_torch.data import nii as nii_kits
    _, arr = nii_kits.read_nii(path, out_dtype=np.uint8)
    return arr


def _pid(path: Path) -> str:
    return path.name.split(".")[0].split("-")[-1]


def _dice(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.count_nonzero(a & b)
    s = np.count_nonzero(a) + np.count_nonzero(b)
    return 2.0 * inter / s if s else 1.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref_dir")
    ap.add_argument("our_dir")
    ap.add_argument("--classes", nargs="+", default=["Liver", "Tumor"],
                    help="class names for labels 1..N of the summed map")
    ap.add_argument("--min_dice", type=float, default=0.995,
                    help="gate: fail if any class mean Dice is below this")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    ref_dir, our_dir = Path(args.ref_dir), Path(args.our_dir)
    refs = {_pid(p): p for p in
            sorted(ref_dir.glob("predict-*.nii*")) +
            sorted(ref_dir.glob("*.npz"))}
    ours = {_pid(p): p for p in
            sorted(our_dir.glob("predict-*.nii*")) +
            sorted(our_dir.glob("*.npz"))}
    common = sorted(set(refs) & set(ours), key=lambda s: int(s))
    if not common:
        print(f"No common cases between {ref_dir} and {our_dir}",
              file=sys.stderr)
        return 2
    missing = sorted(set(refs) ^ set(ours))
    if missing:
        print(f"WARNING: {len(missing)} cases present on one side only: "
              f"{missing[:10]}", file=sys.stderr)

    per_case = []
    sums = {c: [] for c in args.classes}
    ident = []
    for pid in common:
        a = _load(refs[pid])
        b = _load(ours[pid])
        if a.shape != b.shape:
            print(f"case {pid}: SHAPE MISMATCH {a.shape} vs {b.shape}",
                  file=sys.stderr)
            per_case.append({"pid": pid, "error": "shape",
                             "ref": list(a.shape), "ours": list(b.shape)})
            for c in args.classes:
                sums[c].append(0.0)
            ident.append(0.0)
            continue
        same = float(np.mean(a == b))
        row = {"pid": pid, "voxel_identical": round(same, 6)}
        for i, cls in enumerate(args.classes):
            d = _dice(a == i + 1, b == i + 1)
            row[cls + "_dice"] = round(d, 6)
            sums[cls].append(d)
        ident.append(same)
        per_case.append(row)
        if not args.json:
            detail = " ".join(f"{c}={row[c + '_dice']:.4f}"
                              for c in args.classes)
            print(f"case {pid}: identical={same:.4%} {detail}")

    agg = {"cases": len(common),
           "voxel_identical_mean": round(float(np.mean(ident)), 6)}
    ok = True
    for cls in args.classes:
        m = float(np.mean(sums[cls]))
        agg[cls + "_dice_mean"] = round(m, 6)
        ok = ok and m >= args.min_dice
    if args.json:
        print(json.dumps({"aggregate": agg, "per_case": per_case}))
    else:
        print("—" * 60)
        print(" ".join(f"{k}={v}" for k, v in agg.items()))
        print("PARITY OK" if ok else
              f"PARITY FAIL (min_dice {args.min_dice})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
