"""Segmentation losses of the train step (port of
boxsegliver_tpu/ops/losses.py:81-127,161-179,204-251; reference
loss_metrics.py:115-231, NetworksV2/base.py:128-135).

- weighted_sparse_softmax_cross_entropy for ``none`` / ``numerical`` pixel
  weights: per-sample weights normalized to sum to the image area, then
  TF1's SUM_BY_NONZERO_WEIGHTS reduction, sum(w·ce) / count_nonzero(w).
  The math is ported, not the JAX package's channel-unrolled TPU lowering.
- sparse_dice_loss: generalized dice on softmax probabilities, background
  excluded.
- l2_regularization: slim's 0.5·wd·Σw² over the tensors the JAX package
  decays, chosen from their flax names (models/weights.flax_names).
The other weight types (proportion, boundary, examples) are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.nn.functional as F

_WEIGHTS = ("loss weight type {!r} is not ported yet (ROADMAP queue A, "
            "other loss weight types)")


def weighted_sparse_softmax_cross_entropy(logits: torch.Tensor,
                                          labels: torch.Tensor,
                                          w_type: str = "none",
                                          numeric_w=None) -> torch.Tensor:
    """Weighted softmax CE over logits [bs, ..., C] and labels [bs, ...]."""
    w_type = w_type.lower()
    if w_type not in ("none", "numerical"):
        raise NotImplementedError(_WEIGHTS.format(w_type))
    logits = logits.float()
    lbl = labels.long()
    ce = (torch.logsumexp(logits, dim=-1)
          - torch.gather(logits, -1, lbl[..., None])[..., 0])
    if w_type == "none":
        return ce.mean()
    if numeric_w is None:
        raise KeyError("w_type `numerical` needs keyword argument `numeric_w`")
    nw = torch.tensor([float(v) for v in numeric_w], dtype=torch.float32,
                      device=ce.device)
    w = nw[lbl]
    axes = tuple(range(1, ce.ndim))
    area = 1.0
    for ax in axes:
        area = area * ce.shape[ax]
    w = w / w.sum(dim=axes, keepdim=True) * area
    nonzero = torch.clamp_min((w != 0).float().sum(), 1.0)
    return (w * ce).sum() / nonzero


def sparse_dice_loss(probs: torch.Tensor, labels: torch.Tensor,
                     with_bg: bool = False, eps: float = 1e-8) -> torch.Tensor:
    """1 − mean over the batch of 2·Σ(onehot·p) / (Σ(onehot + p) + eps),
    pooled over all spatial axes and the (foreground) classes."""
    n_classes = probs.shape[-1]
    probs = probs.float()
    one_hot = F.one_hot(labels.long(), n_classes).float()
    if not with_bg:
        probs = probs[..., 1:]
        one_hot = one_hot[..., 1:]
    axes = tuple(range(1, probs.ndim))
    intersection = (one_hot * probs).sum(dim=axes)
    union = (one_hot + probs).sum(dim=axes)
    return 1.0 - (2.0 * intersection / (union + eps)).mean()


def make_loss_fn(loss_type: str, loss_weight_type: str = "none", **w_params):
    """Data loss from ``--loss_type``: "xentropy", "dice" or "xentropy+dice"
    (both terms added when both substrings are present)."""
    use_xent = "xentropy" in loss_type
    use_dice = "dice" in loss_type
    if not (use_xent or use_dice):
        raise ValueError(f"Not supported loss_type: {loss_type}")
    if loss_weight_type.lower() not in ("none", "numerical"):
        raise NotImplementedError(_WEIGHTS.format(loss_weight_type))

    def loss_fn(logits, labels):
        total = 0.0
        if use_xent:
            total = total + weighted_sparse_softmax_cross_entropy(
                logits, labels, loss_weight_type, **w_params)
        if use_dice:
            probs = torch.softmax(logits.float(), dim=-1)
            total = total + sparse_dice_loss(probs, labels)
        return total

    return loss_fn


def is_decayed(flax_name: str, bias_decay: bool = False) -> bool:
    """Whether the JAX package's l2_regularization decays the parameter of
    this flattened flax name ('params/<path>/<leaf>'): conv, dense and
    transpose-conv kernels, and their biases unless ``bias_decay``; never a
    tensor under a norm (path containing 'norm', 'bn' or 'scale_param')."""
    parts = flax_name.split("/")
    if parts[0] != "params":
        return False
    joined = "/".join(parts[1:]).lower()
    if any(t in joined for t in ("norm", "bn", "scale_param")):
        return False
    return parts[-1] == "kernel" or (parts[-1] == "bias" and not bias_decay)


def decayed_parameters(model: torch.nn.Module,
                       bias_decay: bool = False) -> List[str]:
    """Names (``model.named_parameters``) of the tensors that L2 decays,
    picked through the weight bridge's flax names."""
    from boxsegliver_torch.models.weights import flax_names

    names = flax_names(model)
    return [n for n, _ in model.named_parameters()
            if is_decayed(names[n], bias_decay)]


def l2_regularization(params: Iterable[torch.Tensor],
                      weight_decay_rate: float) -> torch.Tensor:
    """0.5·wd·Σ‖w‖² over ``params`` (slim l2_regularizer semantics)."""
    params = list(params)
    if weight_decay_rate <= 0 or not params:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([p.float() for p in params])
    sq = torch.stack([n * n for n in norms]).sum()
    return 0.5 * weight_decay_rate * sq

