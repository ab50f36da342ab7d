"""Segmentation losses of the train step (port of
boxsegliver_tpu/ops/losses.py:26-179,204-251; reference
loss_metrics.py:115-231, NetworksV2/base.py:128-135).

- compute_weights: the pixel-weight schemes none / numerical / proportion /
  boundary / examples, each sample's weights normalized to sum to its area.
- weighted_sparse_softmax_cross_entropy: TF1's SUM_BY_NONZERO_WEIGHTS
  reduction, sum(w·ce) / count_nonzero(w).  The math is ported, not the
  JAX package's channel-unrolled TPU lowering.
- sparse_dice_loss: generalized dice on softmax probabilities, background
  excluded.
- l2_regularization: slim's 0.5·wd·Σw² over the tensors the JAX package
  decays, chosen from their flax names (models/weights.flax_names).
Nothing here makes a host number from a device tensor or uploads one, so
the loss runs inside a captured CUDA graph (train/trainer.py).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.nn.functional as F

from boxsegliver_torch.ops.image_ops import (binary_dilation2d,
                                             distance_transform_cityblock)

W_TYPES = ("none", "numerical", "proportion", "boundary", "examples")


def _host_constant(values, like: torch.Tensor, cache: dict) -> torch.Tensor:
    """``values`` as a float32 tensor on ``like``'s device, uploaded once
    per device into ``cache`` (an upload inside a graph capture would
    synchronize)."""
    t = cache.get(like.device)
    if t is None:
        t = cache[like.device] = torch.tensor(
            [float(v) for v in values], dtype=torch.float32,
            device=like.device)
    return t


def compute_weights(w_type: str, labels: torch.Tensor, num_classes: int, *,
                    numeric_w: Optional[torch.Tensor] = None,
                    proportion_decay: Optional[float] = None,
                    examples_w: Optional[torch.Tensor] = None):
    """Pixel weights for class-imbalance compensation (JAX
    losses.compute_weights, reference loss_metrics.py:115-165) of labels
    [bs, ...]: normalized so each sample's weights sum to its pixel count,
    or the scalar 1.0 for ``none``.  ``numeric_w`` [C] and ``examples_w``
    [bs] are float32 tensors on the labels' device.  ``boundary``:
    exp(−d/25) + 1 with d the city-block distance to the class boundary
    band (dilate(class) − class over the classes)."""
    w_type = w_type.lower()
    lbl = labels.long()
    axes = tuple(range(1, lbl.ndim))
    area = 1.0
    for ax in axes:
        area = area * lbl.shape[ax]
    if w_type == "none":
        return 1.0
    if w_type == "numerical":
        if numeric_w is None:
            raise KeyError("w_type `numerical` needs keyword argument "
                           "`numeric_w`")
        w = numeric_w[lbl]
    elif w_type == "proportion":
        one_hot = F.one_hot(lbl, num_classes).float()
        num_labels = one_hot.sum(dim=axes)                     # [bs, C]
        if proportion_decay is not None:
            num_labels = num_labels + proportion_decay
        proportions = 1.0 / num_labels
        wc = proportions / proportions.sum(dim=1, keepdim=True)
        w = torch.gather(wc, 1, lbl.reshape(lbl.shape[0], -1)).reshape(
            lbl.shape)
    elif w_type == "examples":
        if examples_w is None:
            raise KeyError("w_type `examples` needs keyword argument "
                           "`examples_w`")
        w = examples_w.reshape((-1,) + (1,) * len(axes)).expand(lbl.shape)
    elif w_type == "boundary":
        one_hot = F.one_hot(lbl, num_classes).float().movedim(-1, 1)
        band = torch.clamp(binary_dilation2d(one_hot, connection=2), 0, 1) \
            - one_hot
        not_boundary = (band.sum(dim=1) == 0).float()          # [bs, h, w]
        dist = distance_transform_cityblock(not_boundary, axes=(1, 2))
        w = torch.exp(-dist / 25.0) + 1.0
    else:
        raise ValueError("Not supported weight type: " + w_type)
    return w / w.sum(dim=axes, keepdim=True) * area


def _split(group) -> bool:
    return group is not None and group.size > 1


def weighted_sparse_softmax_cross_entropy(logits: torch.Tensor,
                                          labels: torch.Tensor,
                                          w_type: str = "none", group=None,
                                          **w_params) -> torch.Tensor:
    """Weighted softmax CE over logits [bs, ..., C] and labels [bs, ...];
    ``w_params`` as compute_weights takes them.  Under a ``group`` (a
    parallel.Group of more than one rank) the rank's rows are its share of
    the global batch's loss: its own sum over the global normalizer
    (count_nonzero(w) summed over the ranks; the global pixel count)."""
    logits = logits.float()
    lbl = labels.long()
    ce = (torch.logsumexp(logits, dim=-1)
          - torch.gather(logits, -1, lbl[..., None])[..., 0])
    w = compute_weights(w_type, lbl, logits.shape[-1], **w_params)
    if not isinstance(w, torch.Tensor):
        if _split(group):
            return ce.sum() / (ce.numel() * group.size) * w
        return ce.mean() * w
    nonzero = (w != 0).float().sum()
    if _split(group):
        group.all_reduce_(nonzero)
    return (w * ce).sum() / torch.clamp_min(nonzero, 1.0)


def sparse_dice_loss(probs: torch.Tensor, labels: torch.Tensor,
                     with_bg: bool = False, eps: float = 1e-8,
                     group=None) -> torch.Tensor:
    """1 − mean over the batch of 2·Σ(onehot·p) / (Σ(onehot + p) + eps),
    pooled over all spatial axes and the (foreground) classes.  Under a
    ``group`` of more than one rank, the rank's share of the global
    batch's loss: 1/N − Σ its samples' dice / the global batch."""
    n_classes = probs.shape[-1]
    probs = probs.float()
    one_hot = F.one_hot(labels.long(), n_classes).float()
    if not with_bg:
        probs = probs[..., 1:]
        one_hot = one_hot[..., 1:]
    axes = tuple(range(1, probs.ndim))
    intersection = (one_hot * probs).sum(dim=axes)
    union = (one_hot + probs).sum(dim=axes)
    dice = 2.0 * intersection / (union + eps)
    if _split(group):
        return 1.0 / group.size - dice.sum() / (dice.numel() * group.size)
    return 1.0 - dice.mean()


def make_loss_fn(loss_type: str, loss_weight_type: str = "none", *,
                 numeric_w=None, proportion_decay: Optional[float] = None,
                 examples_w=None, group=None):
    """Data loss from ``--loss_type``: "xentropy", "dice" or "xentropy+dice"
    (both terms added when both substrings are present), the CE weighted by
    ``loss_weight_type``.  The weight vectors are uploaded once per
    device.  Under a ``group`` the loss is the rank's share of the global
    batch's: the ranks' shares sum to it, and so do their gradients."""
    use_xent = "xentropy" in loss_type
    use_dice = "dice" in loss_type
    if not (use_xent or use_dice):
        raise ValueError(f"Not supported loss_type: {loss_type}")
    if loss_weight_type.lower() not in W_TYPES:
        raise ValueError("Not supported weight type: " + loss_weight_type)
    uploads = {"numeric_w": {}, "examples_w": {}}

    def loss_fn(logits, labels):
        total = 0.0
        if use_xent:
            w_params = {"proportion_decay": proportion_decay}
            for name, values in (("numeric_w", numeric_w),
                                 ("examples_w", examples_w)):
                if values is not None:
                    w_params[name] = _host_constant(values, logits,
                                                    uploads[name])
            total = total + weighted_sparse_softmax_cross_entropy(
                logits, labels, loss_weight_type, group=group, **w_params)
        if use_dice:
            probs = torch.softmax(logits.float(), dim=-1)
            total = total + sparse_dice_loss(probs, labels, group=group)
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
    """0.5·wd·Σ‖w‖² over ``params`` (slim l2_regularizer semantics), as one
    sum of squares over the concatenated tensors: a fixed number of
    launches whatever the parameter count, and a pairwise sum on the CPU
    (torch's CPU norm accumulates float32 sequentially, which puts
    LGNet_v3's loss outside 1e-5 of JAX's; ROADMAP C4)."""
    params = list(params)
    if weight_decay_rate <= 0 or not params:
        return torch.zeros((), dtype=torch.float32)
    flat = torch.cat([p.reshape(-1).float() for p in params])
    sq = (flat * flat).sum()
    return 0.5 * weight_decay_rate * sq

