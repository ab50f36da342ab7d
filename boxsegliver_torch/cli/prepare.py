"""Offline preprocessing CLI of the port (port of
boxsegliver_tpu/cli/prepare.py; reference DataLoader/*/extract.py
interactive menu → explicit subcommands).  Host numpy only: it writes the
npy cache, meta.json and context features every ported path reads.

    python -m boxsegliver_torch.cli.prepare extract  --src <nifti dir> --dst <cache dir>
    python -m boxsegliver_torch.cli.prepare hist     --dst <cache dir>
    python -m boxsegliver_torch.cli.prepare glcm     --dst <cache dir>
    python -m boxsegliver_torch.cli.prepare prior    --dst <cache dir>
    python -m boxsegliver_torch.cli.prepare kfold    --dst <cache dir> --k 5
    python -m boxsegliver_torch.cli.prepare synthetic --dst <cache dir> \\
        [--cases N] [--modality nf] [--variant hard]
    python -m boxsegliver_torch.cli.prepare infer_context --dst <cache dir> \\
        --guide_file <interactions json>
    python -m boxsegliver_torch.cli.prepare negcache --dst <cache dir> \\
        --pred_dir <predictions dir> [<predictions dir> ...]

``negcache`` writes the nf_inter false-positive cache (``--fp_sample``)
from saved predictions (``--mode eval --save_predict``): one directory
gives ``neg/``, several their union in ``neg_v2/`` (``--fp_version 2``).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("extract", help="NIfTI → npy cache + meta.json")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--only_meta", action="store_true")
    p.add_argument("--modality", choices=["liver", "nf"], default="liver",
                   help="Value window + lesion label preset")
    p.add_argument("--no_lits_quirk", action="store_true",
                   help="Disable the LiTS case-28..51 orientation fix")

    p = sub.add_parser("hist", help="Histogram context features")
    p.add_argument("--dst", required=True)
    p.add_argument("--bins", type=int, default=100)

    p = sub.add_parser("glcm", help="GLCM texture context features "
                       "(reference dump_glcm_feature_for_train/_eval)")
    p.add_argument("--dst", required=True)

    p = sub.add_parser("prior", help="Simulated user prior (prior.json)")
    p.add_argument("--dst", required=True)

    p = sub.add_parser("kfold", help="Create k-fold split file")
    p.add_argument("--dst", required=True)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--seed", type=int, default=1357)

    p = sub.add_parser("synthetic", help="Generate hermetic synthetic dataset")
    p.add_argument("--dst", required=True)
    p.add_argument("--cases", type=int, default=4)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--modality", choices=["liver", "nf"], default="liver")
    p.add_argument("--variant", choices=["easy", "hard"], default="easy",
                   help="hard = low-contrast small lesions + unlabeled "
                        "distractor twins (guide-value benchmark)")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("infer_context", help="Histogram context from REAL "
                       "user interactions (reference gen_infer_context)")
    p.add_argument("--dst", required=True)
    p.add_argument("--guide_file", required=True,
                   help="JSON {pid: {sid: [{center, stddev, z}]}}")
    p.add_argument("--bins", type=int, default=100)

    p = sub.add_parser("negcache", help="False-positive negatives cache from "
                       "saved predictions (nf_inter --fp_sample); several "
                       "--pred_dir values build the union cache (reference "
                       "--fp_version 2, load_neg_v2)")
    p.add_argument("--dst", required=True)
    p.add_argument("--pred_dir", required=True, nargs="+")
    p.add_argument("--min_size", type=int, default=5)

    args = parser.parse_args(argv)

    if args.cmd == "extract":
        from boxsegliver_torch.data.meta import extract_dataset
        metas = extract_dataset(args.src, args.dst, only_meta=args.only_meta,
                                lits_quirk=not args.no_lits_quirk,
                                modality=args.modality)
        print(f"Extracted {len(metas)} cases → {args.dst}/meta.json")
    elif args.cmd == "hist":
        from boxsegliver_torch.data.meta import dump_hist_features
        out = dump_hist_features(args.dst, bins=args.bins)
        print(f"Histogram features → {out}")
    elif args.cmd == "glcm":
        from boxsegliver_torch.data.meta import dump_glcm_features
        out = dump_glcm_features(args.dst)
        print(f"GLCM features → {out}")
    elif args.cmd == "prior":
        from boxsegliver_torch.data.meta import load_meta, simulate_user_prior
        metas = load_meta(args.dst)
        simulate_user_prior(metas, Path(args.dst) / "prior.json")
        print(f"Prior → {args.dst}/prior.json")
    elif args.cmd == "kfold":
        from boxsegliver_torch.data.kfold import read_or_create_k_folds
        from boxsegliver_torch.data.meta import load_meta
        metas = load_meta(args.dst)
        folds = read_or_create_k_folds(Path(args.dst) / "k_folds.txt",
                                       [m["PID"] for m in metas],
                                       k_split=args.k, seed=args.seed)
        for i, f in enumerate(folds):
            print(f"Fold {i}: {' '.join(f)}")
    elif args.cmd == "synthetic":
        from boxsegliver_torch.data.synthetic import make_synthetic_dataset
        root = make_synthetic_dataset(args.dst, n_cases=args.cases,
                                      shape=(args.depth, args.size, args.size),
                                      modality=args.modality,
                                      variant=args.variant, seed=args.seed)
        print(f"Synthetic dataset → {root}")
    elif args.cmd == "infer_context":
        from boxsegliver_torch.data.meta import gen_infer_context
        written = gen_infer_context(args.dst, args.guide_file, bins=args.bins)
        print("\n".join(written))
    elif args.cmd == "negcache":
        from boxsegliver_torch.data.sampler_inter import build_neg_cache
        written = build_neg_cache(args.pred_dir, args.dst,
                                  min_size=args.min_size)
        print(f"Negatives cache: {len(written)} cases → {args.dst}/neg")


if __name__ == "__main__":
    main()
