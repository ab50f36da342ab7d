"""Device-side 3-D batch processing of UNet3D training (port of
boxsegliver_tpu/data/pipeline3d.py:22-113; reference
DataLoader/NF/input_pipeline_3d.py:352-408 ``data_processing``).

One call per batch on the device: the nonzero z-score of each patch,
Gaussian (``--local_enhance``) or normalized-Euclidean click guides
(ops/guides, plain torch: JAX renders them with XLA, not Pallas), flips
along width, height and depth (``--random_flip`` bits 1, 2, 4), gamma with
retained statistics (p = 0.3, ``--gamma``).  The cascade image channel
(``--use_cascade``) travels through the flips but is kept out of z-score
and gamma.  JAX's per-sample ``vmap`` is a written-out batch dimension, and
the random draws come in as tensors (``draw_augment_3d``): the trainer takes
them from its seeded generator, the tests inject JAX's.  Nothing reads the
device from the host, so the function runs inside a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from boxsegliver_torch.data.device_cache import widen
from boxsegliver_torch.ops import image_ops
from boxsegliver_torch.ops.guides import euclidean_guide, gaussian_guide
from boxsegliver_torch.parallel.mesh import rank_draws


def draw_augment_3d(generator: torch.Generator, bs: int, device,
                    gamma: bool = False) -> Dict[str, torch.Tensor]:
    """One batch's draws: ``flip`` coins [bs, 3] in [0, 1) (width, height,
    depth) and, with ``gamma``, augment_gamma's [bs, 3] uniforms."""
    out = {"flip": torch.rand((bs, 3), generator=generator, device=device)}
    if gamma:
        out["gamma"] = torch.rand((bs, 3), generator=generator,
                                  device=device)
    return out


def random_flip_3d(image: torch.Tensor, label: torch.Tensor,
                   coins: torch.Tensor, flip: int):
    """Per-sample flips of image [bs, d, h, w, c] and label [bs, d, h, w]:
    bit 1 flips the width where coins[:, 0] >= 0.5, bit 2 the height
    (coins[:, 1]), bit 4 the depth (coins[:, 2]) (JAX ops/image_ops.
    random_flip over [d, h, w, c])."""
    for bit, col, axis in ((1, 0, 3), (2, 1, 2), (4, 2, 1)):
        if flip & bit:
            c = coins[:, col] >= 0.5
            image = torch.where(c[:, None, None, None, None],
                                image.flip(axis), image)
            label = torch.where(c[:, None, None, None], label.flip(axis),
                                label)
    return image, label


def batch_click_guides(shape, pts: torch.Tensor, *, stddev: float,
                       local_enhance: bool) -> torch.Tensor:
    """Guides [bs, d, h, w, 1] of click slots pts [bs, K, 3] (z, y, x; -1
    rows are empty): the max-over-clicks Gaussian of ``stddev`` under
    ``local_enhance``, else the Euclidean distance map over
    shape[1]·√2·0.8 (input_pipeline_3d.py:371-372); zeros for a sample
    without a click."""
    valid = pts[..., 0] >= 0.0
    if local_enhance:
        stds = torch.full_like(pts[0], float(stddev))
        g = torch.stack([gaussian_guide(shape, pts[i], stds, mask=valid[i])
                         for i in range(pts.shape[0])])
    else:
        g = euclidean_guide(shape, pts, mask=valid) / (
            shape[1] * math.sqrt(2) * 0.8)
    return torch.where(valid.any(dim=1)[:, None, None, None, None], g, 0.0)


def process_batch_3d(batch: Dict[str, torch.Tensor],
                     draws: Optional[Dict[str, torch.Tensor]], *,
                     stddev: float, local_enhance: bool, guide_channel: int,
                     random_flip: int, gamma: bool, use_spatial: bool,
                     use_cascade: bool = False):
    """(features, labels [bs, d, h, w] int64) of one raw 3-D batch (patch
    [bs, d, h, w] as its int16 view, label, names, and fg_pts / bg_pts
    [bs, K, 3] and cascade [bs, d, h, w] when the flags need them)."""
    patch = widen(batch["patch"]).float()
    shape = tuple(patch.shape[1:])
    img = image_ops.zscore(patch)[..., None]                 # [bs, d, h, w, 1]
    if use_cascade:
        img = torch.cat([img, batch["cascade"].float()[..., None]], dim=-1)
    lab = batch["label"].long()
    joint = img
    if use_spatial:
        kw = dict(stddev=stddev, local_enhance=local_enhance)
        fg = batch_click_guides(shape, batch["fg_pts"].float(), **kw)
        bg = batch_click_guides(shape, batch["bg_pts"].float(), **kw)
        guide = torch.cat([fg, bg], dim=-1) if guide_channel == 2 else fg - bg
        joint = torch.cat([img, guide], dim=-1)
    if random_flip:
        joint, lab = random_flip_3d(joint, lab, draws["flip"], random_flip)
    n_im = 2 if use_cascade else 1
    img = joint[..., :1]
    if gamma:
        img = image_ops.augment_gamma(img, (0.7, 1.5), draws["gamma"],
                                      retain_stats=True, p_per_sample=0.3)
    if use_cascade:
        img = torch.cat([img, joint[..., 1:2]], dim=-1)
    feats = {"images": img, "names": batch["names"]}
    if use_spatial:
        feats["sp_guide"] = joint[..., n_im:]
    return feats, lab


def statics_3d(args) -> Dict:
    """The flags process_batch_3d reads (JAX make_preprocess_fn_3d)."""
    return dict(stddev=float(getattr(args, "stddev", 3.0)),
                local_enhance=bool(getattr(args, "local_enhance", True)),
                guide_channel=int(getattr(args, "guide_channel", 2)),
                random_flip=int(args.random_flip),
                gamma=bool(getattr(args, "gamma", False)),
                use_spatial=bool(getattr(args, "use_spatial", False)),
                use_cascade=bool(getattr(args, "use_cascade", False)))


def make_preprocess_fn_3d(args, group=None):
    """(device batch, generator) -> (features, labels): the 3-D train
    step's augmentation, its draws taken from ``generator``.  Under a
    ``group`` the draws are the global batch's and the rank keeps its rows
    (parallel.mesh.rank_draws)."""
    statics = statics_3d(args)

    def fn(batch, generator):
        bs = batch["names"].shape[0] * (group.size if group else 1)
        draws = rank_draws(draw_augment_3d(generator, bs,
                                           batch["names"].device,
                                           statics["gamma"]), group)
        return process_batch_3d(batch, draws, **statics)
    return fn
