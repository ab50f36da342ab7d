"""Cheap 2D online evaluation: batch-metric averaging over fixed val batches
(port of boxsegliver_tpu/evaluators/online2d.py:34-151; reference
evaluators/evaluator_liver.py:164-332, 2D branch).

The val batches are sampled once at construction with a fixed RNG (so every
epoch scores the same data), kept as host arrays, and pushed through the
deterministic eval-mode device processing and the trainer's predict each
epoch.  The per-batch metrics stay on the device until one bulk copy at the
end of the epoch's eval.  Under a data-parallel group every rank runs the
same batches; ``trainer.predict`` splits each batch over the ranks and
gives every rank the whole batch's probabilities, so every rank computes
the same metrics (rank 0 alone writes them).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from boxsegliver_torch.data.pipeline import batch_to_device
# surface metrics (ASSD/RMSD/MSD) need full volumes; METRIC_FNS has no entry
# for them, and they are skipped here as in the JAX package
from boxsegliver_torch.ops.metrics import METRIC_FNS as _METRIC_FNS
from boxsegliver_torch.ops.metrics import ConfusionMatrix

EVAL_SEED = 1234


class OnlineEval2D:
    """eval_fn(trainer) -> {'<Class>/<Metric>': float} over fixed batches.

    sampler: a TrainSampler or an InterSampler on the eval split;
    process_fn(batch, draws) -> (features, labels) must be the
    deterministic eval-mode processing (it is called with draws None).
    ``trainer`` needs ``predict``, ``device``, ``global_step`` and
    ``summary`` (or None)."""

    def __init__(self, sampler, args, process_fn: Callable,
                 classes: Sequence[str], num_batches: int = 0,
                 use_global_dice: bool = False):
        rng = np.random.RandomState(EVAL_SEED)
        n = num_batches or int(getattr(args, "eval_num_batches_per_epoch", 100))
        self.batches: List[Dict[str, np.ndarray]] = [
            sampler.sample_batch(args.batch_size, rng=rng) for _ in range(n)]
        self.process_fn = process_fn
        self.classes = list(classes)  # includes Background at index 0
        self.metric_names = list(getattr(args, "metrics_eval", ["Dice"]))
        self.use_global_dice = use_global_dice

    def _batch_metrics(self, probs, labels) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for i, cls in enumerate(self.classes):
            if i == 0:
                continue
            pred_i = (probs[..., i] > 0.5).float()
            lab_i = (labels == i).float()
            for met in self.metric_names:
                fn = _METRIC_FNS.get(met.lower())
                if fn is None:  # surface metrics need volumes, skip in 2D
                    continue
                if met.lower() in ("vd", "rvd"):
                    # relative volume error is undefined on an empty GT
                    # sample: mask such samples out of the mean (the JAX
                    # package's deviation from the raw reference batch mean)
                    per = fn(pred_i[..., None], lab_i[..., None],
                             reduce=False)
                    axes = tuple(range(1, lab_i.ndim))
                    present = (lab_i.sum(dim=axes) > 0).float()
                    out[f"_masked_sum/{cls}/{met}"] = (per * present).sum()
                    out[f"_masked_n/{cls}/{met}"] = present.sum()
                else:
                    out[f"{cls}/{met}"] = fn(pred_i[..., None],
                                             lab_i[..., None])
            if self.use_global_dice:
                t, r = pred_i != 0, lab_i != 0
                out[f"_cm/tp/{cls}"] = (t & r).sum()
                out[f"_cm/fp/{cls}"] = (t & ~r).sum()
                out[f"_cm/tn/{cls}"] = (~t & ~r).sum()
                out[f"_cm/fn/{cls}"] = (~t & r).sum()
        return out

    def __call__(self, trainer) -> Dict[str, float]:
        per_batch = []
        n_pixels = 0
        for batch in self.batches:
            features, labels = self.process_fn(
                batch_to_device(batch, trainer.device), None)
            probs = trainer.predict(features)
            vals = self._batch_metrics(probs, labels)
            if not per_batch:
                self._image_summaries(trainer, features, labels, probs)
            per_batch.append(torch.stack([v.double() for v in vals.values()]))
            n_pixels += labels.numel()
        keys = list(vals)
        host = torch.stack(per_batch).cpu().numpy()      # one bulk copy
        count = len(self.batches)
        sums = dict(zip(keys, host.sum(axis=0)))
        out = {k: float(v) / max(count, 1) for k, v in sums.items()
               if not k.startswith(("_masked_", "_cm/"))}
        # presence-masked means (RVD/VD): sum over contributing samples
        # across all batches / number of contributing samples
        for key in [k for k in sums if k.startswith("_masked_sum/")]:
            tail = key[len("_masked_sum/"):]
            n = sums.get(f"_masked_n/{tail}", 0.0)
            out[tail] = float(sums[key]) / n if n > 0 else 0.0
        if self.use_global_dice:
            for cls in self.classes[1:]:
                cm = ConfusionMatrix()
                for kind in ("tp", "fp", "tn", "fn"):
                    setattr(cm, kind, int(sums[f"_cm/{kind}/{cls}"]))
                cm.size = n_pixels
                out[f"{cls}/GlobalDice"] = cm.global_dice
        return out

    def _image_summaries(self, trainer, features, labels, probs):
        """Input / label / prediction / guide image summaries of the first
        eval sample (reference _build_summaries, NetworksV2/GUNet.py:
        435-487)."""
        summary = getattr(trainer, "summary", None)
        if summary is None:
            return
        step = trainer.global_step
        img = features["images"][0].float().cpu().numpy()
        mid = img[..., img.shape[-1] // 2]
        lo, hi = float(mid.min()), float(mid.max())
        summary.image("eval/image", (mid - lo) / (hi - lo + 1e-8), step)
        nc = probs.shape[-1]
        summary.image("eval/label", labels[0].cpu().numpy() / max(nc - 1, 1),
                      step)
        summary.image("eval/pred",
                      probs[0].argmax(-1).cpu().numpy() / max(nc - 1, 1), step)
        if "sp_guide" in features:
            summary.image("eval/guide",
                          features["sp_guide"][0, ..., 0].cpu().numpy(), step)
