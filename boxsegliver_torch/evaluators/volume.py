"""Volume evaluator of the port: the unguided whole-volume eval ``run``,
the interactive guided eval ``run_g``, the NF sp-point eval ``run_sp`` and
the nf2 patch eval ``run_patch``
(port of boxsegliver_tpu/evaluators/volume.py:77-538;
reference EvaluateVolume, evaluators/evaluator_liver.py:524-586, 616-904,
998-1026, and NF/input_pipeline_g.py:721-830).

A case's probability volume comes from the device: ``run`` takes a
DeviceSlicePredictor's whole-case ``device_case`` (evaluators/device_eval.py)
or, for a plain ``predict_fn`` such as ``Trainer.predict`` (the inline
``--eval_3d`` eval), the host slice batches of eval_loader.slice_batches
with their mirror variants; ``run_g`` takes the device sweep
(interactive/device_sweep.py), or the per-slice host propagation loop
(interactive/propagation.py) where the sweep overflows its caps, guides are
dumped (``--save_sp_guide``) or the predictor has no sweep
(``--device_sweep off``); ``run_sp`` draws each case's fixed sp-point
guides with kernel B1, one launch per case, on the predictor's device and
then predicts like ``run``.  Everything after it — argmax, nearest resize
back to the crop, postprocess (tumor→liver merge, largest liver component,
tumor masked by liver), 3D metrics, global-Dice accumulation and NIfTI save
— is host numpy as in the JAX package, with the port's cv2-equivalent
resizes.

``run_patch`` is the nf2 per-lesion patch eval (evaluators/iin_eval.py):
each lesion's patch batch is one forward (mirror TTA inside it) and one B1
launch for its guides, the patch probabilities max / min-merged into the
full frame on the host.

Under a data-parallel ``group`` (parallel.Group; the CLI's
``--num_replicas > 1``) every rank walks the same cases and its predictor
splits each slice batch over the ranks (``run``, ``run_sp``); rank 0 alone
scores, saves and persists, and the other ranks return {}.  ``run_g``
shards one image over the devices in JAX (ROADMAP item 4b) and raises.
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from boxsegliver_torch.data import nii as nii_kits
from boxsegliver_torch.evaluators.base import EvaluateBase
from boxsegliver_torch.evaluators.eval_loader import (EvalCase,
                                                      load_eval_context,
                                                      parse_case_eval,
                                                      slice_batches)
from boxsegliver_torch.interactive.propagation import (GuidePropagationLoader,
                                                      mirror_variants)
from boxsegliver_torch.ops import array_kits
from boxsegliver_torch.ops.image_ops import resize_nearest
from boxsegliver_torch.ops.kernels import gaussian_guide_batch
from boxsegliver_torch.ops.metrics import ConfusionMatrix
from boxsegliver_torch.ops.metrics3d import metric_3d

logger = logging.getLogger("boxsegliver")

_FLIPS = {1: (2,), 2: (1,), 3: (1, 2)}


def _host(probs) -> np.ndarray:
    """A predict_fn's probabilities as a float32 host array."""
    if isinstance(probs, torch.Tensor):
        return probs.float().cpu().numpy()
    return np.asarray(probs, np.float32)


class EvaluateVolume(EvaluateBase):

    def __init__(self, args, dataset_dir, classes: List[str],
                 merge_tumor_to_liver: bool = True, largest: bool = True,
                 group=None):
        super().__init__(classes, list(args.metrics_eval),
                         getattr(args, "primary_metric", None),
                         getattr(args, "secondary_metric", None))
        self.args = args
        self.group = group
        self.chief = group is None or group.chief
        self.dataset_dir = Path(dataset_dir)
        self.merge_tumor_to_liver = merge_tumor_to_liver
        self.largest = largest
        self.mirror_div = len(mirror_variants(
            int(getattr(args, "random_flip", 3)),
            bool(getattr(args, "eval_mirror", False))))
        self.context_list = None
        if getattr(args, "use_context", False):
            raw = getattr(args, "context_list", None) or ["hist", "200"]
            self.context_list = [(raw[i], int(raw[i + 1]))
                                 for i in range(0, len(raw), 2)]
        self.nf = getattr(args, "task", "liver").startswith("nf")
        if self.nf:
            self.norm = ("nf_zscore" if getattr(args, "zscore", False)
                         else "nf_clip")
        else:
            self.norm = "window"
        # only_liver / tumor task variants score against remapped GT
        # (reference Liver/input_pipeline_li.py / Tumor/input_pipeline.py)
        self.gt_label_mode = {"only_liver": "liver01",
                              "tumor": "tumor"}.get(
            getattr(args, "task", "liver"), "none")

    # ------------------------------------------------------------------
    # per-case prediction
    # ------------------------------------------------------------------

    def predict_case(self, predict_fn: Callable, case: EvalCase,
                     sp_guide: Optional[np.ndarray] = None) -> np.ndarray:
        """Mirror-averaged softmax volume [cz, ph, pw, nc] for one case
        (reference _predict_case accumulation, evaluator_liver.py:642-656):
        the predictor's ``device_case`` when it has one, else host slice
        batches through ``predict_fn``."""
        args = self.args
        pshape = (args.im_height, args.im_width)
        context = None
        if self.context_list is not None:
            context = load_eval_context(self.dataset_dir, case.pid,
                                        self.context_list, args.hist_scale)
        if hasattr(predict_fn, "device_case"):
            return predict_fn.device_case(case, context=context,
                                          sp_guide=sp_guide)
        chunks: List[np.ndarray] = []
        pads = 0
        for batch in slice_batches(case, args.batch_size, pshape,
                                   eval_mirror=getattr(args, "eval_mirror",
                                                       False),
                                   random_flip=getattr(args, "random_flip", 3),
                                   context=context, sp_guide=sp_guide,
                                   guide_bg=0.0 if self.nf else 0.5):
            mirror = batch.pop("mirror")
            pads = batch.pop("pads") or pads
            feats = {k: v for k, v in batch.items() if k != "names"}
            probs = _host(predict_fn(feats))
            if mirror == 0:
                chunks.append(probs / self.mirror_div)
            else:
                chunks[-1] += (np.flip(probs, axis=_FLIPS[mirror])
                               / self.mirror_div)
        volume = np.concatenate(chunks, axis=0)
        if pads:
            volume = volume[:-pads]
        return volume

    def predict_case_patches(self, predict_fn: Callable, case: EvalCase,
                             overlap: float = 0.5) -> np.ndarray:
        """Patch-based 2D eval (--eval_in_patches, reference
        input_pipeline.py:676 + evaluator_liver.py:524-586): each slice is
        tiled at (im_height, im_width) with overlap-count averaging."""
        args = self.args
        ph, pw = args.im_height, args.im_width
        cz = case.depth
        _, ch, cw = case.volume.shape
        c = case.lhc + case.rhc + 1
        nc = len(self.classes) + 1
        ys = sorted(set(list(range(0, max(ch - ph, 0) + 1,
                                   max(1, int(ph * (1 - overlap)))))
                        + [max(ch - ph, 0)]))
        xs = sorted(set(list(range(0, max(cw - pw, 0) + 1,
                                   max(1, int(pw * (1 - overlap)))))
                        + [max(cw - pw, 0)]))
        tiles = [(y, x) for y in ys for x in xs]
        probs = np.zeros((cz, ch, cw, nc), np.float32)
        counts = np.zeros((ch, cw, 1), np.float32)
        bs = args.batch_size
        for z in range(cz):
            stack = np.transpose(case.volume[z:z + c], (1, 2, 0))
            batch_tiles = [stack[y:y + ph, x:x + pw] for (y, x) in tiles]
            for i0 in range(0, len(batch_tiles), bs):
                chunk = batch_tiles[i0:i0 + bs]
                arr = np.zeros((bs, ph, pw, c), np.float32)
                arr[:len(chunk)] = np.stack(chunk)
                out = _host(predict_fn({"images": arr}))
                for j, (y, x) in enumerate(tiles[i0:i0 + len(chunk)]):
                    probs[z, y:y + ph, x:x + pw] += out[j]
                    if z == 0:
                        counts[y:y + ph, x:x + pw] += 1.0
        return probs / counts[None]

    # ------------------------------------------------------------------
    # postprocess + metrics
    # ------------------------------------------------------------------

    def postprocess(self, volume, is_label: bool = False) -> Dict[str, np.ndarray]:
        """Decouple classes, merge tumor→liver, largest-CC liver, mask tumor
        FPs by liver (reference _postprocess, evaluator_liver.py:680-702)."""
        if not isinstance(volume, dict):
            out = {cls: volume == i + 1 for i, cls in enumerate(self.classes)}
        else:
            out = volume
        if self.merge_tumor_to_liver and "Tumor" in out and "Liver" in out:
            out["Liver"] = out["Liver"] + out["Tumor"]
        if self.largest and "Liver" in out and not is_label:
            out["Liver"] = array_kits.get_largest_component(out["Liver"], rank=3)
            if self.merge_tumor_to_liver and "Tumor" in out:
                out["Tumor"] = out["Tumor"] * out["Liver"].astype(out["Tumor"].dtype)
        return out

    @staticmethod
    def _resize_pred_to_crop(pred: np.ndarray, cshape) -> np.ndarray:
        """Nearest-resize [cz, ph, pw] class map back to the crop shape
        (cv2.INTER_NEAREST semantics)."""
        tgt = (int(cshape[0]), int(cshape[1]))
        if pred.shape[1:] == tgt:
            return pred
        return resize_nearest(torch.from_numpy(pred), tgt).numpy()

    def evaluate_case(self, case: EvalCase, probs: np.ndarray,
                      accumulator: Optional[Dict] = None) -> Dict[str, float]:
        """argmax → back to crop shape → postprocess → metric_3d + confusion
        accumulation (reference _run_actual body, evaluator_liver.py:926-946)."""
        pred = np.argmax(probs, axis=-1).astype(np.uint8)
        pred = self._resize_pred_to_crop(pred, case.segmentation.shape[1:])
        vols = self.postprocess(pred)
        seg = case.segmentation.astype(np.int32)
        if self.gt_label_mode == "liver01":
            seg = np.clip(seg, 0, 1)
        elif self.gt_label_mode == "tumor":
            seg = (seg == 2).astype(np.int32)
        labs = self.postprocess(seg, is_label=True)
        results = {}
        for cls in self.classes:
            if accumulator is not None:
                conf = ConfusionMatrix(vols[cls].astype(int), labs[cls].astype(int))
                accumulator[cls + "_tp"] += conf.tp
                accumulator[cls + "_fp"] += conf.fp
                accumulator[cls + "_fn"] += conf.fn
            pairs = metric_3d(vols[cls], labs[cls], required=self.metrics_str,
                              sampling=case.spacing)
            for met, value in pairs.items():
                results[f"{cls}/{met}"] = value
        return results

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------

    def full_class_map(self, case: EvalCase, pred: np.ndarray) -> np.ndarray:
        """Class-map volume at the ORIGINAL case shape: resize the [cz, ph,
        pw] prediction back to the crop, postprocess, sum the class masks
        (liver=1, tumor voxels=2 — reference maybe_save_case,
        evaluator_liver.py:1004-1016), un-crop pad."""
        z1, z2, y1, y2, x1, x2 = case.crop
        d, h, w = case.oshape
        if pred.ndim == 4:  # probability volume — collapse to the class map
            pred = np.argmax(pred, axis=-1).astype(np.uint8)
        pred = self._resize_pred_to_crop(pred, (y2 - y1, x2 - x1))
        vols = self.postprocess(pred)
        arr = np.zeros(pred.shape, np.uint8)
        for cls in self.classes:
            if cls in vols:
                arr += vols[cls].astype(np.uint8)
        return np.pad(arr, ((z1, d - z2), (y1, h - y2), (x1, w - x2)),
                      mode="constant")

    def save_case(self, case: EvalCase, volume: np.ndarray, save_path,
                  dtype: str = "pred"):
        """Un-crop pad to original shape → NIfTI (pred) or npz (prob)
        (reference maybe_save_case, evaluator_liver.py:998-1026)."""
        save_path = Path(save_path)
        save_path.mkdir(parents=True, exist_ok=True)
        z1, z2, y1, y2, x1, x2 = case.crop
        d, h, w = case.oshape
        pad = ((z1, d - z2), (y1, h - y2), (x1, w - x2))
        if dtype == "pred":
            arr = self.full_class_map(case, volume)
            out = save_path / f"predict-{case.pid}.nii.gz"
            nii_kits.write_nii(arr, out, zooms=case.spacing)
        else:
            arr = np.pad(volume, pad + ((0, 0),), mode="constant")
            out = save_path / f"{case.pid}.npz"
            np.savez_compressed(out, arr)
        logger.info("    ==> Save to %s", out)
        return out

    # ------------------------------------------------------------------
    # interactive guided eval (reference run_g + _predict_case_g,
    # evaluator_liver.py:768-904)
    # ------------------------------------------------------------------

    def run_g(self, predict_fn, case_metas: Iterable[Dict],
              prior: Optional[Dict] = None, save: bool = False,
              save_path=None, do_eval: bool = True) -> Dict[str, float]:
        """Interactive guided evaluation: Forward/Backward guide-propagation
        sweeps merged by max.

        prior: {pid_str: {sid_str: [{z, center, stddev}]}} — defaults to the
        dataset's prior.json; --real_sp points at real user interactions
        (reference input_pipeline_g.py:1217-1224).
        """
        args = self.args
        if self.group is not None and self.group.size > 1:
            raise NotImplementedError(
                f"run_g over {self.group.size} ranks (the height-sharded "
                "sweep) is not ported yet (ROADMAP item 4b: spatial "
                "sharding)")
        if prior is None:
            prior_file = Path(getattr(args, "real_sp", None) or
                              self.dataset_dir / "prior.json")
            prior = json.loads(Path(prior_file).read_text())

        self.clear_metrics()
        accumulator: Dict[str, int] = defaultdict(int)
        n = 0
        skip = getattr(args, "eval_skip_num", 0)
        limit = getattr(args, "eval_num", -1)
        for meta in list(case_metas)[skip:]:
            if 0 < limit <= n:
                break
            t0 = time.time()
            case, probs3d = self.predict_case_g(
                predict_fn, meta, prior.get(str(int(meta["PID"])), {}),
                parse_label=do_eval)
            n += 1
            self._finish_case(case, probs3d, accumulator, save, save_path,
                              do_eval, n, t0)
        return self._finish_run(accumulator, n)

    # ------------------------------------------------------------------
    # main entry (reference run + _run_actual, evaluator_liver.py:704-766,
    # 906-996)
    # ------------------------------------------------------------------

    def run(self, predict_fn: Callable, case_metas: Iterable[Dict],
            save: bool = False, save_path=None, do_eval: bool = True
            ) -> Dict[str, float]:
        """Unguided whole-volume evaluation of ``case_metas``."""
        args = self.args
        self.clear_metrics()
        accumulator: Dict[str, int] = defaultdict(int)
        n = 0
        skip = getattr(args, "eval_skip_num", 0)
        limit = getattr(args, "eval_num", -1)
        for meta in list(case_metas)[skip:]:
            if 0 < limit <= n:
                break
            t0 = time.time()
            case = parse_case_eval(meta, self.dataset_dir,
                                   im_channel=args.im_channel,
                                   parse_label=do_eval and self.chief,
                                   norm=self.norm, whole_frame=self.nf)
            if getattr(args, "eval_in_patches", False):
                probs = self.predict_case_patches(predict_fn, case)
            else:
                probs = self.predict_case(predict_fn, case)
            n += 1
            self._finish_case(case, probs, accumulator, save, save_path,
                              do_eval, n, t0)
        return self._finish_run(accumulator, n)

    def run_sp(self, predict_fn: Callable, case_metas: Iterable[Dict],
               save: bool = False, save_path=None, do_eval: bool = True
               ) -> Dict[str, float]:
        """NF sp-point guided evaluation (reference get_dataset_for_sp_point,
        NF/input_pipeline_g.py:721-830): whole-frame volume, per-slice FIXED
        Gaussian guides at the GT tumor centers with constant base stddev
        --guide_scale (both scaled from original to target resolution),
        times --eval_discount, zero background, no propagation.  --real_sp
        substitutes real user interactions; --eval_no_sp zeros all guides.
        The guides of a case are one launch of kernel B1 (sp_point_guides)
        on the predictor's device."""
        args = self.args
        real_meta = None
        rsp = getattr(args, "real_sp", None)
        if rsp and Path(rsp).exists():
            real_meta = json.loads(Path(rsp).read_text())
        device = getattr(predict_fn, "device", "cpu")

        self.clear_metrics()
        accumulator: Dict[str, int] = defaultdict(int)
        n = 0
        skip = getattr(args, "eval_skip_num", 0)
        limit = getattr(args, "eval_num", -1)
        for meta in list(case_metas)[skip:]:
            if 0 < limit <= n:
                break
            t0 = time.time()
            case = parse_case_eval(meta, self.dataset_dir,
                                   im_channel=args.im_channel,
                                   parse_label=do_eval and self.chief,
                                   norm=self.norm, whole_frame=True)
            guide = self.sp_point_guides(meta, case, real_meta, device)
            if not hasattr(predict_fn, "device_case"):
                guide = guide.cpu().numpy()
            probs = self.predict_case(predict_fn, case, sp_guide=guide)
            n += 1
            self._finish_case(case, probs, accumulator, save, save_path,
                              do_eval, n, t0)
        return self._finish_run(accumulator, n)

    def sp_point_guides(self, meta: Dict, case: EvalCase,
                        real_meta: Optional[Dict] = None,
                        device="cpu") -> torch.Tensor:
        """[depth, ph, pw] float32 guide volume of one case on ``device``:
        on each guided slice the max of Gaussians at its centers (the
        case's --real_sp interactions, else its GT tumor centers with
        stddev --guide_scale), scaled to the target size, times
        --eval_discount; zero elsewhere.  All guided slices are one B1
        launch (rows = slices, K = the most centers on a slice, scale =
        eval_discount, offset 0)."""
        args = self.args
        pshape = (int(args.im_height), int(args.im_width))
        scale = (np.asarray(pshape, np.float32)
                 / np.asarray(case.oshape[1:], np.float32))
        rows = []                              # (slice, centers, stddevs)
        spid = str(case.pid)
        if real_meta is not None and spid in real_meta:
            for ssid, g in real_meta[spid].items():
                rows.append((int(ssid),
                             np.asarray(g["centers"], np.float32) * scale,
                             np.asarray(g["stddevs"], np.float32) * scale))
        elif not getattr(args, "eval_no_sp", False):
            ft = meta["tumor_slices_from_to"]
            for k, sid in enumerate(meta["tumor_slices_index"]):
                centers = np.asarray(
                    meta["tumor_slices_centers"][ft[k]:ft[k + 1]],
                    np.float32) * scale
                stddevs = np.full(centers.shape, args.guide_scale,
                                  np.float32) * scale
                rows.append((int(sid), centers, stddevs))
        guide = torch.zeros((case.depth,) + pshape, dtype=torch.float32,
                            device=device)
        if not rows:
            return guide
        k = max(len(c) for _, c, _ in rows)
        c = np.zeros((len(rows), k, 2), np.float32)
        s = np.ones((len(rows), k, 2), np.float32)
        valid = np.zeros((len(rows), k), bool)
        for r, (_, cr, sr) in enumerate(rows):
            c[r, :len(cr)], s[r, :len(sr)], valid[r, :len(cr)] = cr, sr, True
        out = gaussian_guide_batch(
            torch.from_numpy(c).to(device), torch.from_numpy(s).to(device),
            torch.from_numpy(valid).to(device), height=pshape[0],
            width=pshape[1], scale=float(args.eval_discount), offset=0.0)
        sids = torch.tensor([sid for sid, _, _ in rows], device=device)
        guide[sids] = out[..., 0]
        return guide

    def run_patch(self, predict_fn: Callable, case_metas: Iterable[Dict],
                  save: bool = False, save_path=None, do_eval: bool = True
                  ) -> Dict[str, float]:
        """nf2 / IIN per-lesion patch evaluation (JAX volume.py:412-447;
        reference evaluator_nf.run with the nf2 pipeline ->
        _predict_case_v2, evaluator_nf.py:336-575): every lesion's
        expanded-bbox patch is predicted and max / min-merged into a
        full-frame volume whose background starts at 1, so unvisited voxels
        stay background.  ``predict_fn``: iin_eval.make_patch_predict (the
        mirror TTA inside it); the guides are drawn on its device."""
        from boxsegliver_torch.evaluators.iin_eval import (IinPatchLoader,
                                                           merge_patch_probs)

        args = self.args
        device = getattr(predict_fn, "device", "cpu")
        self.clear_metrics()
        accumulator: Dict[str, int] = defaultdict(int)
        n = 0
        skip = getattr(args, "eval_skip_num", 0)
        limit = getattr(args, "eval_num", -1)
        nc = len(self.classes) + 1
        for meta in list(case_metas)[skip:]:
            if 0 < limit <= n:
                break
            t0 = time.time()
            loader = IinPatchLoader(meta, self.dataset_dir, args,
                                    device=device)
            d, h, w = loader.volume.shape
            logits3d = np.zeros((d, h, w, nc), np.float32)
            logits3d[..., 0] = 1.0  # evaluator_nf.py:541-542
            for batch in loader.batches(args.batch_size):
                probs = _host(predict_fn(batch))
                merge_patch_probs(logits3d, probs, batch["sid"], batch["bb"],
                                  batch["pads"])
            case = EvalCase(pid=int(meta["PID"]), volume=None,
                            segmentation=loader.lab3d,
                            crop=(0, d, 0, h, 0, w), oshape=(d, h, w),
                            spacing=tuple(meta["spacing"]), lhc=0, rhc=0)
            n += 1
            self._finish_case(case, logits3d, accumulator, save, save_path,
                              do_eval, n, t0)
        return self._finish_run(accumulator, n)

    def predict_case_g(self, predict_fn, meta: Dict, prior_case: Dict,
                       parse_label: bool = True):
        """One case of the run_g protocol: parse → (device | host) double
        guide-propagation sweep → merged probability volume.  Returns
        ``(case, probs3d)`` with probs3d of shape [cz, ph, pw, nc]."""
        args = self.args
        tumor_id = (self.classes.index("Tumor") + 1 if "Tumor" in self.classes
                    else len(self.classes))
        case = parse_case_eval(meta, self.dataset_dir,
                               im_channel=args.im_channel,
                               parse_label=parse_label, norm=self.norm,
                               whole_frame=self.nf)
        context = None
        if self.context_list is not None:
            context = load_eval_context(self.dataset_dir, case.pid,
                                        self.context_list, args.hist_scale)
        # the device double sweep (interactive/device_sweep.py) unless the
        # predictor has none or guides are dumped; None => host loop
        sweep_dev: Optional[Callable] = getattr(predict_fn, "sweep_case", None)
        probs3d = None
        if sweep_dev is None:
            logger.info("  case %s: the predictor has no device sweep; host "
                        "loop", case.pid)
        elif getattr(args, "save_sp_guide", False):
            logger.info("  case %s: --save_sp_guide dumps the host loop's "
                        "guides; host loop", case.pid)
        else:
            probs3d, n_objs = sweep_dev(case, prior_case, context)
            if probs3d is None:
                logger.info("  case %s: %d objects overflow the device sweep "
                            "caps; host loop", case.pid, n_objs)
        if probs3d is None:
            probs3d = self._sweep_case_host(predict_fn, case, prior_case,
                                            context, tumor_id)
        return case, probs3d

    def _sweep_case_host(self, predict_fn: Callable, case: EvalCase,
                         prior_case: Dict, context, tumor_id: int
                         ) -> np.ndarray:
        """Reference-shaped per-slice propagation loop (one predictor call
        per slice and direction, on the predictor's device); the parity
        oracle for the device sweep."""
        args = self.args
        loader = GuidePropagationLoader(
            case, prior_case, args, context=context,
            device=getattr(predict_fn, "device", "cpu"))
        volumes = {}
        for direction in ("Forward", "Backward"):
            chunks = []
            for idx in loader.sweep(direction):
                feats = loader.slice_features(idx)
                merged = loader.merge_mirrors(predict_fn(feats))
                chunks.append(merged)
                loader.set_last_pred(
                    (merged.argmax(-1) == tumor_id).astype(np.uint8))
            volumes[direction] = np.stack(chunks, axis=0)
            if getattr(args, "save_sp_guide", False):
                loader.save_guides(Path(args.model_dir) / "sp_guide")
        return np.maximum(volumes["Forward"], volumes["Backward"][::-1])

    def _finish_case(self, case: EvalCase, probs: np.ndarray, accumulator,
                     save: bool, save_path, do_eval: bool, n: int,
                     t0: float) -> Dict[str, float]:
        """Per-case tail: score + confusion accumulation, optional save,
        per-case log line (rank 0's alone under a group)."""
        results = {}
        if not self.chief:
            return results
        if do_eval:
            results = self.evaluate_case(case, probs, accumulator)
            self.append_metrics(results)
        if save:
            vol = (np.argmax(probs, -1).astype(np.uint8)
                   if self.args.pred_type == "pred" else probs)
            self.save_case(case, vol, save_path or
                           Path(self.args.model_dir) / self.args.save_path,
                           dtype=self.args.pred_type)
        msg = " ".join(f"{k}: {v:.3f}" for k, v in results.items())
        logger.info("Evaluate-%d case %s %s (%.3f s)", n, case.pid, msg,
                    time.time() - t0)
        return results

    def _finish_run(self, accumulator: Dict[str, int], n: int
                    ) -> Dict[str, float]:
        """End-of-run tail: mean metrics + global dice from the confusion
        accumulator + summary log + JSON persist (rank 0's alone under a
        group)."""
        if not self.chief:
            return {}
        results = self.mean_metrics()
        if accumulator:
            for cls in self.classes:
                denom = (2 * accumulator[cls + "_tp"] + accumulator[cls + "_fn"]
                         + accumulator[cls + "_fp"])
                results["G" + cls + "Dice"] = (
                    2 * accumulator[cls + "_tp"] / denom if denom else 0.0)
        display = " ".join(f"{k}: {v:.3f}" for k, v in results.items())
        logger.info("----Process %d cases %s", n, display)
        self._persist_results(results)
        return results

    def _persist_results(self, results: Dict[str, float]):
        """eval_results_3d.txt JSON next to the checkpoints
        (reference core/estimator.py:277-279)."""
        model_dir = Path(getattr(self.args, "model_dir", "") or ".")
        if model_dir.exists():
            (model_dir / "eval_results_3d.txt").write_text(
                json.dumps({k: float(v) for k, v in results.items()}))


def make_inline_eval_fn(evaluator: EvaluateVolume, case_metas: List[Dict],
                        max_cases: int = -1):
    """eval_fn(trainer) for Trainer.train — the epoch-end 3D eval of the
    held-out cases through the trainer's predict and the host slice batches
    (reference EvaluatorHook + evaluate_online, core/hooks.py:79-191 /
    core/estimator.py:334-357)."""
    def eval_fn(trainer):
        metas = case_metas if max_cases <= 0 else case_metas[:max_cases]
        return evaluator.run(trainer.predict, metas, save=False, do_eval=True)
    return eval_fn
