"""Whole-volume 3-D evaluation of UNet3D: padded single-shot or
sliding-window inference on the device (port of
boxsegliver_tpu/evaluators/volume3d.py:32-311; reference threed_script/
201_unet_v*.sh eval and the patch eval, evaluator_liver.py:524-586).

- ``make_volume_predict``: one forward of the whole padded volume; with
  ``in_zscore`` the raw volume is uploaded once and z-scored on the device,
  with ``ret="pred"`` the argmax comes back as uint8, and
  ``blank_guide_channels`` synthesizes the click-free zero guide of a
  ``--use_spatial`` model on the device.
- ``make_sliding_predict``: the padded volume is uploaded once and the tiles
  run in JAX's order, their softmax summed into a float32 accumulator and
  divided by the overlap count on the device (JAX's ``lax.scan`` is a
  Python loop of forwards here).
- ``sliding_window_3d``: the same averaging on the host over any predict
  function (the per-tile reference).
- ``EvaluateVolume3D``: z-score, alignment padding, one of the above,
  crop, then per-class ``metric_3d`` and the confusion totals per case.

With a ``group`` of ``z_axis_shards`` > 1 ranks (``--z_shards``, JAX's
``mesh`` / ``z_axis_shards``: the depth axis sharded over the devices) each
rank takes its planes of the padded volume, z-scores them with the
whole volume's statistics, runs UNet3D on them with halo-exchanged convs
and split instance norms (parallel/spatial.py), and the blocks of the
argmax or the softmax are gathered back; ``EvaluateVolume3D.run`` walks the
same cases on every rank and rank 0 alone scores.  Predict functions take
feature dicts of arrays or tensors and give host arrays.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from boxsegliver_torch.data.device_cache import widen
from boxsegliver_torch.evaluators.base import EvaluateBase
from boxsegliver_torch.ops.image_ops import zscore
from boxsegliver_torch.ops.metrics import ConfusionMatrix
from boxsegliver_torch.ops.metrics3d import metric_3d
from boxsegliver_torch.parallel.spatial import SpatialShard, sharded
from boxsegliver_torch.utils.trace import span

logger = logging.getLogger("boxsegliver")


def pad_to_multiple(vol: np.ndarray, mult: Tuple[int, int, int]):
    """Zero-pad [d, h, w, ...] so each of the first three dims divides
    ``mult``; returns (padded, pads)."""
    pads = [(-s) % m for s, m in zip(vol.shape[:3], mult)]
    if any(pads):
        vol = np.pad(vol, [(0, p) for p in pads] + [(0, 0)] * (vol.ndim - 3))
    return vol, pads


def to_device(arr, device) -> torch.Tensor:
    """A host array (uint16 travels as its int16 view and is widened on the
    device) or a tensor, on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        return widen(torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).to(device))
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_volume_predict(model: torch.nn.Module, device, ret: str = "prob",
                        in_zscore: bool = False,
                        blank_guide_channels: int = 0, group=None,
                        z_axis_shards: int = 0) -> Callable:
    """Whole-volume forward {"images": [1, d, h, w, c]} → probabilities
    [1, d, h, w, nc] float32, or with ``ret="pred"`` the argmax [1, d, h,
    w] uint8 — both as host arrays.

    With ``z_axis_shards`` > 1 and a ``group`` of that many ranks, the
    depth is sharded over them (module docstring): each rank computes its
    block of planes (whole multiples of ``model.spatial_unit``) and every
    rank returns the whole volume.  A depth that ``z_axis_shards`` does
    not divide raises ValueError, as JAX's ``device_put`` of the volume to
    ``P(None, "data")`` does.  A depth it divides that holds fewer whole
    units than there are ranks (JAX shards it all the same) runs unsharded
    on every rank: the same forward, logged once a predict function."""
    shards = int(z_axis_shards or 0)
    if shards > 1 and (group is None or group.size != shards):
        raise ValueError(f"z_axis_shards={shards} needs a group of "
                         f"{shards} ranks, got "
                         f"{None if group is None else group.size}")
    if shards <= 1:
        group = None

    logged = []

    @torch.no_grad()
    def predict(feats):
        feats = {k: to_device(v, device) for k, v in feats.items()}
        depth = feats["images"].shape[1]
        grp = group
        if grp is not None:
            if depth % shards:
                raise ValueError(
                    f"the padded depth {depth} of the volume is not "
                    f"divisible by z_shards={shards}")
            if depth // model.spatial_unit < shards:
                if not logged:
                    logger.info(
                        "z_shards=%d: a padded depth of %d planes holds "
                        "fewer than %d whole multiples of %d; every rank "
                        "runs such a case unsharded", shards, depth, shards,
                        model.spatial_unit)
                    logged.append(depth)
                grp = None
            else:
                planes = grp.block(depth, model.spatial_unit)
                feats = {k: v[:, planes].contiguous()
                         for k, v in feats.items()}
        x = feats["images"].float()
        if in_zscore:
            x = zscore(x) if grp is None else SpatialShard(grp).zscore(x)
        feats["images"] = x
        if blank_guide_channels and "sp_guide" not in feats:
            feats["sp_guide"] = torch.zeros(
                x.shape[:-1] + (blank_guide_channels,), device=x.device)
        with sharded(model, grp):
            logits = model(feats)
        out = (logits.argmax(dim=-1).to(torch.int32) if ret == "pred"
               else torch.softmax(logits, dim=-1))
        if grp is not None:
            out = grp.gather_blocks(out.contiguous(), 1, depth,
                                    model.spatial_unit)
        return host(out.to(torch.uint8) if ret == "pred" else out)

    predict.ret = ret
    predict.in_zscore = in_zscore
    return predict


def _tile_starts(size: int, patch: int, step: int) -> List[int]:
    return sorted(set(list(range(0, size - patch + 1, step))
                      + [size - patch]))


def tile_starts(shape, patch, overlap: float = 0.5):
    """The tile (patch, starts) of a volume of ``shape`` (JAX's order:
    z, then y, then x)."""
    pd, ph, pw = (min(p, s) for p, s in zip(patch, shape))
    steps = [max(1, int(p * (1 - overlap))) for p in (pd, ph, pw)]
    starts = [(z0, y0, x0)
              for z0 in _tile_starts(shape[0], pd, steps[0])
              for y0 in _tile_starts(shape[1], ph, steps[1])
              for x0 in _tile_starts(shape[2], pw, steps[2])]
    return (pd, ph, pw), starts


def make_sliding_predict(model: torch.nn.Module, device,
                         patch: Tuple[int, int, int], num_classes: int,
                         overlap: float = 0.5, ret: str = "pred",
                         in_zscore: bool = False,
                         blank_guide_channels: int = 0) -> Callable:
    """Device sliding-window inference over a PADDED [d, h, w, c] volume
    (raw under ``in_zscore``, else host-normalized, cascade channels
    allowed): one upload, a forward a tile, the overlap-count average on the
    device; the argmax [d, h, w] uint8 (``ret="pred"``) or the averaged
    probabilities as a host array.  Marked ``.sliding`` for
    EvaluateVolume3D.predict_case."""

    @torch.no_grad()
    def predict(vol) -> np.ndarray:
        vol = to_device(vol, device).float()
        if in_zscore:
            vol = zscore(vol[None])[0]
        (pd, ph, pw), starts = tile_starts(vol.shape[:3], patch, overlap)
        probs = torch.zeros(vol.shape[:3] + (num_classes,), device=device)
        counts = torch.zeros(vol.shape[:3] + (1,), device=device)
        for z0, y0, x0 in starts:
            tile = vol[z0:z0 + pd, y0:y0 + ph, x0:x0 + pw][None]
            feats = {"images": tile}
            if blank_guide_channels:
                feats["sp_guide"] = torch.zeros(
                    (1, pd, ph, pw, blank_guide_channels), device=device)
            p = torch.softmax(model(feats), dim=-1)[0]
            probs[z0:z0 + pd, y0:y0 + ph, x0:x0 + pw] += p
            counts[z0:z0 + pd, y0:y0 + ph, x0:x0 + pw] += 1.0
        avg = probs / counts
        if ret == "pred":
            return host(avg.argmax(dim=-1).to(torch.uint8))
        return host(avg)

    predict.ret = ret
    predict.in_zscore = in_zscore
    predict.sliding = True
    return predict


def sliding_window_3d(predict_fn: Callable, volume: np.ndarray,
                      patch: Tuple[int, int, int], num_classes: int,
                      overlap: float = 0.5) -> np.ndarray:
    """Overlap-averaged sliding-window inference on the host (reference
    patch eval, evaluator_liver.py:524-586).  volume: [d, h, w, c]
    normalized; predict_fn gives [1, pd, ph, pw, nc] probabilities."""
    (pd, ph, pw), starts = tile_starts(volume.shape[:3], patch, overlap)
    probs = np.zeros(volume.shape[:3] + (num_classes,), np.float32)
    counts = np.zeros(volume.shape[:3] + (1,), np.float32)
    for z0, y0, x0 in starts:
        tile = volume[z0:z0 + pd, y0:y0 + ph, x0:x0 + pw]
        p = host(predict_fn({"images": tile[None]}))[0]
        probs[z0:z0 + pd, y0:y0 + ph, x0:x0 + pw] += p
        counts[z0:z0 + pd, y0:y0 + ph, x0:x0 + pw] += 1.0
    return probs / counts


class EvaluateVolume3D(EvaluateBase):
    """Whole-volume 3-D evaluator (the UNet3D path)."""

    def __init__(self, args, dataset_dir, classes: List[str],
                 align: Tuple[int, int, int] = (2, 16, 16), group=None):
        super().__init__(classes, list(args.metrics_eval),
                         getattr(args, "primary_metric", None),
                         getattr(args, "secondary_metric", None))
        self.args = args
        self.dataset_dir = Path(dataset_dir)
        self.align = align
        # under a group (--z_shards) every rank predicts each case and
        # rank 0 alone scores
        self.chief = group is None or group.chief

    def predict_case(self, predict_fn: Callable, volume: np.ndarray,
                     cascade=None) -> np.ndarray:
        """z-score + pad + (whole or sliding-window) forward → probabilities
        [d, h, w, nc] float32, or the prediction [d, h, w] uint8 from a
        ``ret="pred"`` predict function.

        cascade: an optional interactive.cascade.Cascade2D, whose frozen-2-D
        prediction channel is appended to the input (reference
        main_eval_3d.py:348-369)."""
        args = self.args
        fn_zscores = bool(getattr(predict_fn, "in_zscore", False))
        needs_extra = cascade is not None or getattr(args, "use_cascade",
                                                     False)
        if fn_zscores and needs_extra:
            raise ValueError("cascade channels need the host-normalized "
                             "volume; build the predict fn with "
                             "in_zscore=False")
        if fn_zscores:
            vol = volume[..., None]      # raw upload; z-scored on the device
        else:
            vol = zscore(torch.from_numpy(volume.astype(np.float32))[None]
                         )[0].numpy()[..., None]
        if cascade is not None:
            extra = cascade.extra_channel(vol[..., 0])
            vol = np.concatenate([vol, extra[..., None]], axis=-1)
        elif getattr(args, "use_cascade", False):
            # a cascade-trained model without a frozen-2-D producer: the
            # neutral zero channel (the train-time value without clicks)
            vol = np.concatenate([vol, np.zeros_like(vol)], axis=-1)
        padded, pads = pad_to_multiple(vol, self.align)
        if getattr(predict_fn, "sliding", False):
            out = predict_fn(padded)
        elif args.im_depth > 0 and padded.shape[0] > args.im_depth:
            if getattr(predict_fn, "ret", "prob") != "prob":
                raise ValueError("the host sliding window needs a "
                                 "prob-mode predict fn")
            out = sliding_window_3d(
                predict_fn, padded,
                (args.im_depth, args.im_height, args.im_width),
                num_classes=len(self.classes) + 1)
        else:
            out = host(predict_fn({"images": padded[None]}))[0]
        if any(pads):
            out = out[:out.shape[0] - pads[0], :out.shape[1] - pads[1],
                      :out.shape[2] - pads[2]]
        return out

    def run(self, predict_fn: Callable, case_metas: Iterable[Dict],
            do_eval: bool = True, cascade=None) -> Dict[str, float]:
        """Per-case metric_3d of every class (means) and the global Dice of
        the confusion totals, as JAX's ``run``."""
        args = self.args
        self.clear_metrics()
        accumulator: Dict[str, int] = defaultdict(int)
        n = 0
        limit = getattr(args, "eval_num", -1)
        for meta in list(case_metas)[getattr(args, "eval_skip_num", 0):]:
            if 0 < limit <= n:
                break
            with span("boxseg.eval.case"):
                t0 = time.time()
                pid = int(meta["PID"])
                case = self.dataset_dir / f"volume-{pid}"
                with span("boxseg.eval.parse"):
                    vol = np.load(case / "volume.npy")
                    lab = np.load(case / "segmentation.npy")
                out = self.predict_case(predict_fn, vol, cascade=cascade)
                with span("boxseg.eval.postprocess"):
                    pred = (out if out.dtype == np.uint8
                            else out.argmax(-1).astype(np.uint8))
                results = {}
                if do_eval and self.chief:
                    with span("boxseg.eval.score"):
                        for i, cls in enumerate(self.classes):
                            p = pred == i + 1
                            r = lab == i + 1
                            conf = ConfusionMatrix(p.astype(int),
                                                   r.astype(int))
                            accumulator[cls + "_tp"] += conf.tp
                            accumulator[cls + "_fp"] += conf.fp
                            accumulator[cls + "_fn"] += conf.fn
                            pairs = metric_3d(p, r,
                                              required=self.metrics_str,
                                              sampling=meta["spacing"])
                            for met, v in pairs.items():
                                results[f"{cls}/{met}"] = v
                    self.append_metrics(results)
                n += 1
                msg = " ".join(f"{k}: {v:.3f}" for k, v in results.items())
                logger.info("Evaluate3D-%d case %s %s (%.3f s)", n, pid, msg,
                            time.time() - t0)
        if not self.chief:
            return {}
        results = self.mean_metrics()
        for cls in self.classes:
            denom = (2 * accumulator[cls + "_tp"] + accumulator[cls + "_fn"]
                     + accumulator[cls + "_fp"])
            if denom:
                results["G" + cls + "Dice"] = (2 * accumulator[cls + "_tp"]
                                              / denom)
        return results
