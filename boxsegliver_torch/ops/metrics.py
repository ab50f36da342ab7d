"""Batch metrics (Dice / VOE / VD) of the train step and the online eval,
and the host-side confusion accumulator for global Dice (own copy of
boxsegliver_tpu/ops/metrics.py:16-116; reference loss_metrics.py:261-339,
506-580)."""

from __future__ import annotations

import numpy as np
import torch

TRAIN_METRIC_CHOICES = ("Dice", "VOE", "VD")
EVAL_METRIC_CHOICES = ("Dice", "VOE", "RVD", "ASSD", "RMSD", "MSD")


def metric_dice(logits, labels, eps: float = 1e-5, reduce: bool = True):
    """Soft dice over all non-batch axes (reference loss_metrics.py:261-301)."""
    logits, labels = logits.float(), labels.float()
    axes = tuple(range(1, logits.ndim))
    intersection = (logits * labels).sum(dim=axes)
    left = logits.sum(dim=axes)
    right = labels.sum(dim=axes)
    dice = (2.0 * intersection + eps) / (left + right + eps)
    return dice.mean() if reduce else dice


def metric_voe(logits, labels, eps: float = 1e-5, reduce: bool = True):
    """Volumetric overlap error, percent (reference loss_metrics.py:304-320)."""
    logits, labels = logits.float(), labels.float()
    axes = tuple(range(1, logits.ndim))
    numerator = (logits * labels).sum(dim=axes)
    denominator = torch.clamp(logits + labels, 0.0, 1.0).sum(dim=axes)
    voe = 100.0 * (1.0 - numerator / (denominator + eps))
    return voe.mean() if reduce else voe


def metric_vd(logits, labels, eps: float = 1e-5, reduce: bool = True):
    """Relative volume difference, percent (reference loss_metrics.py:323-339)."""
    logits, labels = logits.float(), labels.float()
    axes = tuple(range(1, logits.ndim))
    a = logits.sum(dim=axes)
    b = labels.sum(dim=axes)
    vd = 100.0 * ((a - b).abs() / (b + eps))
    return vd.mean() if reduce else vd


# 'rvd' aliases metric_vd: the eval-metric surface names it RVD
# (loss_metrics.py:60) while the train-metric surface names it VD
METRIC_FNS = {"dice": metric_dice, "voe": metric_voe, "vd": metric_vd,
              "rvd": metric_vd}


def build_train_metrics(probs, labels, classes, metric_names, group=None):
    """Per-foreground-class train metrics dict keyed '<Class>/<Metric>'
    (reference UNet.py:137-155).  ``classes`` includes 'Background' at index
    0; probs [bs, ..., c] are thresholded at 0.5 like the reference's
    <Class>Pred tensors.  Under a ``group`` of more than one rank each
    metric is the mean over the global batch: the ranks' per-sample sums
    are summed in one all-reduce."""
    split = group is not None and group.size > 1
    out = {}
    for i in range(1, len(classes)):
        pred_i = (probs[..., i] > 0.5).float()
        lab_i = (labels == i).float()
        for met in metric_names:
            fn = METRIC_FNS[met.lower()]
            out[f"{classes[i]}/{met}"] = fn(pred_i[..., None],
                                            lab_i[..., None],
                                            reduce=not split)
    if split and out:
        n = probs.shape[0] * group.size
        sums = group.all_reduce_(torch.stack([v.sum() for v in out.values()]))
        out = dict(zip(out, sums / n))
    return out


class ConfusionMatrix:
    """tp/fp/tn/fn accumulator for global dice (reference loss_metrics.py:506-580).

    Works on numpy arrays host-side; accumulate with `+=` across cases.
    """

    def __init__(self, test=None, reference=None):
        self.tp = self.fp = self.tn = self.fn = 0
        self.size = 0
        if test is not None and reference is not None:
            self.add(test, reference)

    def add(self, test, reference):
        test = np.asarray(test)
        reference = np.asarray(reference)
        assert test.shape == reference.shape, \
            f"Shape mismatch: {test.shape} and {reference.shape}"
        t = test != 0
        r = reference != 0
        self.tp += int(np.count_nonzero(t & r))
        self.fp += int(np.count_nonzero(t & ~r))
        self.tn += int(np.count_nonzero(~t & ~r))
        self.fn += int(np.count_nonzero(~t & r))
        self.size += reference.size
        return self

    def get_matrix(self):
        return self.tp, self.fp, self.tn, self.fn

    @property
    def global_dice(self):
        denom = 2 * self.tp + self.fp + self.fn
        return 2 * self.tp / denom if denom else 0.0

    @property
    def global_voe(self):
        denom = self.tp + self.fp + self.fn
        return 1.0 - self.tp / denom if denom else 0.0

    @property
    def global_rvd(self):
        if self.tp + self.fn == 0:
            return 0.0
        return abs((self.tp + self.fp) - (self.tp + self.fn)) / (self.tp + self.fn)
