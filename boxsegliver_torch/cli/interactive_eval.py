"""The interactive click-refinement eval (port of
boxsegliver_tpu/cli/interactive_eval.py:1-203; reference
entry/main_eval.py:43-396, entry/main_eval_3d.py:152-420): per lesion slice
(``--dim 2``) or per whole volume (``--dim 3``, UNet3D), clicks at the
largest error until Dice clears ``--dice_thresh`` or ``--max_iters`` clicks
are spent, on the test fold's lesion-bearing cases; per-case Dice and
clicks and their means, which go to ``model_dir/eval_results_inter.txt``.

    python -m boxsegliver_torch.cli.interactive_eval --mode eval \\
        --tag 101_unetinter_v10 --model UNetInter --loss_numeric_w 1 1 \\
        --use_spatial --local_enhance --stddev 5. --classes NF \\
        --test_fold 0 --im_height 256 --im_width 256 --im_channel 3 \\
        --normalizer instance_norm --batch_size 1 --dataset NF --dim 2 \\
        [--device_refine on|off|auto] [--guide_kind gaussian|euclidean|
        geodesic] [--device cpu]      # 101_unetinter_v10.sh inter
    python -m boxsegliver_torch.cli.interactive_eval --mode eval \
        --tag 202_unetinter_v2 --model UNet3D --use_spatial \
        --local_enhance --classes NF --im_height 256 --im_width 256 \
        --normalizer instance_norm --dataset NF --dim 3 [--tta] \
        [--device_refine on|off]      # the 3-D click eval

Runs on the card unless ``--device cpu``.  Weights as ``--mode eval`` of
cli/main (restore_weights: ``--ckpt_path``, else the best checkpoint, else
the latest).  Each 2.5-D stack of ``--im_channel`` slices (edge-padded) is
z-scored over its non-zero voxels, as the click training normalizes.  The
refinement runs as the device refiner (interactive/device_refine.py: all
lesion slices of a case at once, B1 or G1 drawing the guides) or the
per-slice host loop (interactive/refine.py), by ``--device_refine``.
``--dim 3`` z-scores the whole volume over its non-zero voxels, pads it to
(2, 16, 16) multiples and refines with ``DeviceRefiner3D`` (unless
``--device_refine off``) or the host loop, which also carries
``--use_cascade`` (the GT-oracle channel), as in JAX.
``--num_replicas N > 1`` with the ``--dim 2`` device refiner starts N
spawned workers (NCCL, one GPU a rank; gloo with ``--device cpu``) that
split each case's slice batch (JAX's refiner mesh); rank 0 writes the
results.  The host loops and ``--dim 3`` take no mesh in JAX and run in one
process.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from boxsegliver_torch import config as config_mod
from boxsegliver_torch.utils.logger import setup_logger


def build_parser():
    parser = config_mod.build_parser()
    group = parser.add_argument_group(title="Interactive Eval Arguments")
    group.add_argument("--dim", type=int, choices=[2, 3], default=2)
    group.add_argument("--dice_thresh", type=float, default=0.85)
    group.add_argument("--max_iters", type=int, default=10)
    group.add_argument("--guide_stddev", type=float, default=5.0)
    group.add_argument("--guide_kind", type=str, default="gaussian",
                       choices=["gaussian", "euclidean", "geodesic"])
    group.add_argument("--tta", action="store_true",
                       help="8-way mirror TTA in the 3D loop")
    group.add_argument("--device_refine", choices=["on", "off", "auto"],
                       default="auto",
                       help="on = the device refiner (all lesion slices of a "
                            "case together on the card; --dim 3: the whole "
                            "volume); off = the host loop; auto = on (the "
                            "faster of the two on the card at 128^2 and "
                            "256^2: chip_smoke.py phase 20d); --dim 3 "
                            "--use_cascade takes the host loop")
    group.add_argument("--task", type=str, default="synthetic",
                       help="dataset pairing (as in cli.main); 'synthetic' "
                            "auto-generates, anything else resolves "
                            "<data_root>/<dataset>")
    return parser


def build_refiner(args, model, device, group=None):
    """The device refiner, or None for the host loop (--device_refine; the
    3-D cascade channel keeps the host loop); ``group``: the 2-D refiner's
    data-parallel group."""
    if getattr(args, "device_refine", "auto") == "off":
        return None
    if args.dim == 3:
        if getattr(args, "use_cascade", False):
            return None
        from boxsegliver_torch.interactive.device_refine import \
            DeviceRefiner3D
        return DeviceRefiner3D(
            model, dice_thresh=args.dice_thresh, max_iters=args.max_iters,
            stddev=args.guide_stddev, tta=bool(args.tta),
            guide_channel=int(getattr(args, "guide_channel", 1)),
            device=device)
    from boxsegliver_torch.interactive.device_refine import DeviceRefiner2D
    return DeviceRefiner2D(
        model, dice_thresh=args.dice_thresh, max_iters=args.max_iters,
        stddev=args.guide_stddev, guide_kind=args.guide_kind,
        guide_channel=int(args.guide_channel), device=device, mesh=group)


def make_predict(model):
    """predict_fn of the host loop: softmax of the model's logits."""
    import torch

    @torch.no_grad()
    def predict(feats):
        return torch.softmax(model(feats), dim=-1)

    return predict


def slice_stacks(vol: np.ndarray, channels: int) -> np.ndarray:
    """[d, h, w] -> [d, h, w, channels] 2.5-D stacks, edge-padded, each
    z-scored over its non-zero voxels (pipeline_inter's normalization)."""
    from boxsegliver_torch.ops.array_kits import zscore

    vol = vol.astype(np.float32)
    lh = (channels - 1) // 2
    rh = channels - 1 - lh
    padded = np.concatenate([np.repeat(vol[:1], lh, 0), vol,
                             np.repeat(vol[-1:], rh, 0)], axis=0)
    return np.stack([zscore(np.transpose(padded[z:z + channels], (1, 2, 0)))
                     for z in range(vol.shape[0])]).astype(np.float32)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    config_mod.check_args(args, parser)
    config_mod.fill_default_args(args)
    device = config_mod.resolve_device(args.device)
    n = int(getattr(args, "num_replicas", 0) or 0)
    if n > 1 and args.dim == 2 and args.device_refine != "off":
        from boxsegliver_torch.parallel import launch, resolve_replicas
        return launch(_rank_main, resolve_replicas(n, device), device, args)
    return run(args, device)


def _rank_main(group, args):
    return run(args, config_mod.resolve_device(args.device), group)


def run(args, device, group=None):
    """The click eval on this process (one rank of ``group``, if given)."""
    import logging

    if group is None or group.chief:
        logger = setup_logger(args.model_dir, "eval_inter", args.tag)
    else:
        logger = setup_logger(level=logging.WARNING)

    from boxsegliver_torch.cli.main import (build_model_from_args,
                                            resolve_dataset_dir)
    from boxsegliver_torch.data.kfold import (LITS_SEED,
                                              read_or_create_k_folds,
                                              train_test_split)
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.volume3d import pad_to_multiple
    from boxsegliver_torch.interactive.refine import (interactive_eval_2d,
                                                      interactive_eval_3d)
    from boxsegliver_torch.ops.array_kits import zscore

    dataset_dir = resolve_dataset_dir(args)
    model = build_model_from_args(args, device)
    logger.info("Restored %s from %s on %s", args.model, args.restored_from,
                device)

    metas = load_meta(dataset_dir)
    folds = read_or_create_k_folds(
        Path(dataset_dir) / "k_folds.txt", [m["PID"] for m in metas],
        k_split=args.k_folds, seed=LITS_SEED)
    _, test_pids = train_test_split(folds, args.test_fold)
    test_pids = set(int(p) for p in test_pids)
    # only lesion-bearing cases, like the reference eval's nf_set filter
    eval_metas = [m for m in metas
                  if int(m["PID"]) in test_pids and m["tumors"]]
    if args.eval_num > 0:
        eval_metas = eval_metas[:args.eval_num]

    refiner = build_refiner(args, model, device, group)
    logger.info("refinement path: %s",
                type(refiner).__name__ if refiner is not None
                else "host loop")
    predict = make_predict(model)

    all_results = []
    for meta in eval_metas:
        t_case = time.perf_counter()
        pid = int(meta["PID"])
        case = Path(dataset_dir) / f"volume-{pid}"
        vol = np.load(case / "volume.npy")
        lab = (np.load(case / "segmentation.npy") > 0).astype(np.uint8)
        if args.dim == 3:
            # the whole volume z-scored at once (3-D convolutions), padded
            # to the model's alignment; Dice and clicks see the valid part
            vol = zscore(vol.astype(np.float32))
            pvol, pads = pad_to_multiple(vol[..., None], (2, 16, 16))
            plab = np.pad(lab, [(0, p) for p in pads]) if any(pads) else lab
            if refiner is not None:
                res = refiner.refine_case(pvol[..., 0], plab,
                                          valid_shape=vol.shape)
            else:
                res = interactive_eval_3d(
                    predict, pvol[..., 0], plab,
                    dice_thresh=args.dice_thresh, max_iters=args.max_iters,
                    stddev=args.guide_stddev, tta=args.tta,
                    use_cascade=bool(getattr(args, "use_cascade", False)),
                    cascade_binary=bool(getattr(args, "cascade_binary",
                                                False)),
                    guide_channel=int(getattr(args, "guide_channel", 1)),
                    valid_shape=vol.shape, device=device)
        else:
            images = slice_stacks(vol, args.im_channel)
            if refiner is not None:
                res = refiner.refine_case(images, lab)
            else:
                res = interactive_eval_2d(
                    predict, images, lab, dice_thresh=args.dice_thresh,
                    max_iters=args.max_iters, stddev=args.guide_stddev,
                    guide_kind=args.guide_kind,
                    guide_channel=int(args.guide_channel), device=device)
        res["sec_per_case"] = time.perf_counter() - t_case
        logger.info("case %s: Dice=%.3f clicks=%.1f (%.2f s)", pid,
                    res["Dice"], res["clicks"], res["sec_per_case"])
        all_results.append(res)

    means = {k: float(np.mean([r[k] for r in all_results]))
             for k in all_results[0]} if all_results else {}
    logger.info("---- %d cases: %s", len(all_results),
                " ".join(f"{k}={v:.3f}" for k, v in means.items()))
    if group is not None and not group.chief:
        return means
    out = Path(args.model_dir) / "eval_results_inter.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(means))
    return means


if __name__ == "__main__":
    main()
