"""Device-side processing for nf2 / IIN click-instance training (port of
boxsegliver_tpu/data/pipeline_iin.py; reference
DataLoader/NF/input_pipeline_iin.py:252-315 ``data_processing_cuda``).

One batched function performs the nonzero z-score or the window clip, the
one-click Gaussian guide, the context pyramid's normalization with the
image's statistics (JAX :62-70), gamma (``p_per_sample=0.5``), normal
noise, the pad mask, and the joint flips of image, guide, context and label
with the same coins (JAX :89-102).  The guide of a batch is ONE launch of
kernel B1 with K = 1 (the click's centre and stddev, valid = ``sp_on``): a
sample without a click comes out all zeros, as JAX's ``guide * sp_on``.

Host/device contract (data/sampler_iin.IinSampler): images arrive
host-resized at the target size, the click already in target coordinates,
the context as raw uint16 patches.

Randomness: the draws come in as tensors (``draws``: ``flip`` coins
[bs, 3], ``gamma`` [bs, 3] and normal ``noise`` of the image shape, from
``draw_iin``); the tests inject JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from boxsegliver_torch.data.device_cache import widen
from boxsegliver_torch.ops import image_ops
from boxsegliver_torch.ops.kernels import gaussian_guide_batch
from boxsegliver_torch.parallel.mesh import rank_draws


def draw_iin(generator: torch.Generator, shape, noise: bool, gamma: bool,
             device) -> Dict[str, torch.Tensor]:
    """One batch's draws from ``generator``: flip coins [bs, 3], gamma
    uniforms [bs, 3] (with ``gamma``) and standard-normal noise of the image
    shape [bs, h, w, c] (with ``noise``)."""
    out = image_ops.draw_augment(generator, shape, noise=False,
                                 device=device, gamma=gamma)
    if noise:
        out["noise"] = torch.randn(tuple(shape), generator=generator,
                                   device=device)
    return out


def _process_batch_iin(batch: Dict[str, torch.Tensor],
                       draws: Optional[Dict], *, im_h: int, im_w: int,
                       noise_scale: float, random_flip: int,
                       use_context: bool, use_spatial: bool, zscore: bool,
                       use_gamma: bool, gamma_range: Tuple[float, float],
                       train: bool):
    """(features {images[, sp_guide][, context], names}, labels [bs, h, w]
    int64) of a raw IinSampler batch on the device; ``draws`` may be None
    when train is False."""
    img = widen(batch["image"]).float()
    lab = batch["label"].long()
    dims = (1, 2, 3)
    if zscore:
        # image_ops.zscore, its statistics kept for the context
        region = (img > 0).float()
        cnt = torch.clamp_min(region.sum(dim=dims, keepdim=True), 1.0)
        mean = (img * region).sum(dim=dims, keepdim=True) / cnt
        var = (torch.square(img - mean) * region).sum(dim=dims,
                                                     keepdim=True) / cnt
        img = (img - region * mean) / (region * torch.sqrt(var) + 1e-8)
    else:
        lo = batch["clip"][:, 0, None, None, None]
        hi = batch["clip"][:, 1, None, None, None]
        img = (torch.clamp(img, lo, hi) - lo) / (hi - lo)

    feats = {}
    if use_context:
        ct = widen(batch["ct_patch"]).float()
        if zscore:
            # the image's nonzero statistics (the reference crops the patches
            # out of the z-scored image, input_pipeline_iin.py:272-275)
            ct_region = (ct > 0).float()
            ct = (ct - ct_region * mean) / (ct_region * torch.sqrt(var)
                                            + 1e-8)
        else:
            ct = (torch.clamp(ct, lo, hi) - lo) / (hi - lo)
        feats["context"] = ct * batch["ct_on"][:, None, None, None]
    if use_spatial:
        # kernel B1, K = 1: an invalid row (sp_on = 0) is all zeros
        feats["sp_guide"] = gaussian_guide_batch(
            batch["sp_center"].float()[:, None].contiguous(),
            batch["sp_std"].float()[:, None].contiguous(),
            (batch["sp_on"] > 0)[:, None].contiguous(),
            height=im_h, width=im_w)

    if train and use_gamma:
        img = image_ops.augment_gamma(img, gamma_range, draws["gamma"],
                                      retain_stats=True, p_per_sample=0.5)
    if train and noise_scale > 0:
        img = image_ops.random_noise(img, noise_scale, draws["noise"])
    if train and (use_gamma or noise_scale > 0):
        # out-of-volume 2.5D channels stay zero through gamma and noise
        img = img * batch["pad_mask"][:, None, None, :]

    if train and random_flip:
        if use_context:
            # the same coins: JAX flips the context with the image's key
            feats["context"], _ = image_ops.random_flip(
                feats["context"], lab, draws["flip"], flip=random_flip)
        c = img.shape[-1]
        joint = (torch.cat([img, feats["sp_guide"]], dim=-1)
                 if use_spatial else img)
        joint, lab = image_ops.random_flip(joint, lab, draws["flip"],
                                           flip=random_flip)
        img = joint[..., :c]
        if use_spatial:
            feats["sp_guide"] = joint[..., c:]
    feats["images"] = img
    feats["names"] = batch["names"]
    return feats, lab


def make_iin_preprocess_fn(args, train: bool = True, group=None):
    """(device batch, generator) -> (features, labels): the nf2 train
    step's processing with its draws from ``generator`` (train=True), or
    the deterministic processing of the online eval (train=False: no
    noise, flips or gamma, draws None).  Under a ``group`` the draws are
    the global batch's and the rank keeps its rows
    (parallel.mesh.rank_draws)."""
    static = dict(
        im_h=int(args.im_height), im_w=int(args.im_width),
        noise_scale=float(args.noise_scale) if train else 0.0,
        random_flip=int(args.random_flip) if train else 0,
        use_context=bool(getattr(args, "use_context", False)),
        use_spatial=bool(getattr(args, "use_spatial", False)),
        zscore=bool(getattr(args, "zscore", False)),
        use_gamma=bool(getattr(args, "gamma", False)),
        gamma_range=tuple(getattr(args, "gamma_range", (0.7, 1.5))),
        train=train)

    def fn(batch, generator):
        draws = None
        if train:
            bs = batch["names"].shape[0] * (group.size if group else 1)
            draws = rank_draws(draw_iin(
                generator, (bs, static["im_h"], static["im_w"],
                            int(args.im_channel)),
                noise=static["noise_scale"] > 0, gamma=static["use_gamma"],
                device=batch["names"].device), group)
        return _process_batch_iin(batch, draws, **static)

    return fn
