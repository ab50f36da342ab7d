"""Hybrid 2-D + 3-D evaluation entry (port of
boxsegliver_tpu/cli/hybrid_eval.py:41-191; reference
entry/main_train_hybrid.py:1-304).

Despite the reference's name it evaluates: it restores a UNet3D (and, with
``--use_cascade --ckpt_2d``, a frozen 2-D model), drops tiny lesions from
the labels ("slim" labels: 2-D components of at most 2 px, then 3-D
components of at most 5 px, main_train_hybrid.py:80-95), runs whole-volume
mirror-TTA inference on z-scored volumes resized to the training
resolution, and reports metric_3d and the global Dice per case and overall
(``model_dir/eval_results_hybrid.txt``).  The forwards run on the card
unless ``--device cpu``; JAX's ``ensure_compile_cache()`` is a TPU compile
cache and has no counterpart.

    python -m boxsegliver_torch.cli.hybrid_eval nf_3d --mode eval --tag h \\
        --model UNet3D --classes NF --use_cascade --ckpt_2d ... [flags]
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np
from scipy import ndimage as ndi

from boxsegliver_torch.ops.metrics import ConfusionMatrix
from boxsegliver_torch.ops.metrics3d import metric_3d

logger = logging.getLogger("boxsegliver")

# 8-way mirror axes over [1, d, h, w, c] inputs (reference run_TTA,
# main_train_hybrid.py:203-243)
TTA_AXES = [(), (3,), (2,), (2, 3), (1,), (1, 3), (1, 2), (1, 2, 3)]


def filter_tiny_nf(mask: np.ndarray) -> np.ndarray:
    """Slim labels: drop per-slice 2-D components of at most 2 px, then 3-D
    components of at most 5 px (reference main_train_hybrid.py:80-95)."""
    mask = mask.copy()
    s2 = ndi.generate_binary_structure(2, 1)
    for i in range(mask.shape[0]):
        comp, _ = ndi.label(mask[i], s2)
        sizes = np.bincount(comp.ravel())
        kill = np.isin(comp, np.where(sizes <= 2)[0])
        mask[i][kill & (comp > 0)] = 0
    s3 = ndi.generate_binary_structure(3, 2)
    comp, _ = ndi.label(mask, s3)
    sizes = np.bincount(comp.ravel())
    kill = np.isin(comp, np.where(sizes <= 5)[0])
    mask[kill & (comp > 0)] = 0
    return mask


def slim_labels_for(dataset_dir, pid: int) -> np.ndarray:
    """Cached slim label volume (reference slim_labels.gz.pkl cache,
    main_train_hybrid.py:103-121): <dataset>/slim/volume-<pid>.npy."""
    root = Path(dataset_dir)
    cache = root / "slim" / f"volume-{pid}.npy"
    if cache.exists():
        return np.load(cache)
    lab = np.clip(np.load(root / f"volume-{pid}" / "segmentation.npy"), 0, 1)
    slim = filter_tiny_nf(lab)
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.save(cache, slim)
    return slim


def tta_predict(predict_fn, feats: Dict[str, np.ndarray],
                eval_mirror: bool = True) -> np.ndarray:
    """Probabilities averaged over up to 8 flip combinations; predict_fn
    gives host arrays."""
    axes_list = TTA_AXES if eval_mirror else [()]
    acc = None
    for axes in axes_list:
        flipped = {k: np.ascontiguousarray(np.flip(v, axis=axes)) if axes
                   else v for k, v in feats.items()}
        p = np.asarray(predict_fn(flipped), np.float32)
        if axes:
            p = np.flip(p, axis=axes)
        acc = p if acc is None else acc + p
    return acc / len(axes_list)


def run_hybrid_eval(args, dataset_dir, model=None,
                    device=None) -> Dict[str, float]:
    """Whole-volume TTA eval of the UNet3D against slim labels.  ``model``:
    a UNet3D in eval mode on ``device``; by default the flagged one with
    JAX's weights: --ckpt_path, else the latest periodic checkpoint under
    --model_dir, else the seeded init (JAX trainer.restore)."""
    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.cli.main import (_build_model, _test_metas,
                                            build_eval_cascade,
                                            checkpoint_path, initial_weights)
    from boxsegliver_torch.evaluators.volume3d import make_volume_predict
    from boxsegliver_torch.train.checkpoint import model_state

    root = Path(dataset_dir)
    if device is None:
        device = config_mod.resolve_device(args.device)
    if model is None:
        model = _build_model(args)
        path = checkpoint_path(args, eval_final=True)
        if path is not None:
            model.load_state_dict(model_state(path), strict=True)
        else:
            initial_weights(args, model)
        model = model.to(device).eval()
    predict = make_volume_predict(model, device, ret="prob")
    cascade = build_eval_cascade(args, device)

    accu = defaultdict(list)
    conf_totals = defaultdict(int)
    n = 0
    for meta in _test_metas(args, root):
        pid = int(meta["PID"])
        t0 = time.time()
        volume = np.load(root / f"volume-{pid}" / "volume.npy")
        slim = slim_labels_for(root, pid)

        # resize h / w to the training resolution, pad the depth even,
        # z-score the non-zero voxels (reference main_train_hybrid.py:
        # 272-284)
        img = volume.astype(np.float32)
        scale = np.array([1.0, args.im_height / img.shape[1],
                          args.im_width / img.shape[2]])
        img = ndi.zoom(img, scale, order=1)
        d_pad = img.shape[0] % 2
        if d_pad:
            img = np.pad(img, ((0, 1), (0, 0), (0, 0)))
        nz = img > 0
        vals = img[nz]
        img[nz] = (vals - vals.mean()) / (vals.std() + 1e-8)

        feats = {"images": img[None, ..., None]}
        if cascade is not None:
            extra = cascade.extra_channel(img)
            feats["images"] = np.concatenate(
                [feats["images"], extra[None, ..., None]], axis=-1)
        elif getattr(args, "use_cascade", False):
            # the neutral zero channel of a cascade-trained model without a
            # frozen-2-D producer (see volume3d.predict_case)
            feats["images"] = np.concatenate(
                [feats["images"], np.zeros_like(feats["images"])], axis=-1)
        probs = tta_predict(predict, feats,
                            eval_mirror=getattr(args, "eval_mirror", True))
        pred = probs[0].argmax(-1).astype(np.uint8)
        if d_pad:
            pred = pred[:-1]
        pred = ndi.zoom(pred, 1.0 / scale, order=0)
        pred = pred[:slim.shape[0], :slim.shape[1], :slim.shape[2]]

        case = metric_3d(pred, slim, required=args.metrics_eval,
                         sampling=meta["spacing"])
        conf = ConfusionMatrix(pred, slim)
        for k, v in case.items():
            accu[k].append(v)
        conf_totals["tp"] += conf.tp
        conf_totals["fp"] += conf.fp
        conf_totals["fn"] += conf.fn
        n += 1
        msg = " ".join(f"{k}: {v:.3f}" for k, v in case.items())
        logger.info("Hybrid-%d case %s %s (%.3f s)", n, pid, msg,
                    time.time() - t0)

    results = {k: float(np.mean(v)) for k, v in accu.items()}
    denom = 2 * conf_totals["tp"] + conf_totals["fp"] + conf_totals["fn"]
    if denom:
        results["GlobalDice"] = 2 * conf_totals["tp"] / denom
    logger.info("----Hybrid eval %d cases %s", n,
                " ".join(f"{k}: {v:.3f}" for k, v in results.items()))
    out = Path(args.model_dir) / "eval_results_hybrid.txt"
    if Path(args.model_dir).exists():
        out.write_text(json.dumps(results))
    return results


def main(argv=None):
    from boxsegliver_torch.cli.main import get_args, resolve_dataset_dir
    from boxsegliver_torch.utils.logger import setup_logger

    args = get_args(argv)
    setup_logger(args.model_dir, "hybrid_eval", args.tag, args.out_file)
    return run_hybrid_eval(args, resolve_dataset_dir(args))


if __name__ == "__main__":
    main()
