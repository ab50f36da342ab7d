"""Device-side processing for 2D click-simulation training (nf_inter; port of
boxsegliver_tpu/data/pipeline_inter.py:28-140; reference
DataLoader/NF/input_pipeline_g_simply.py:435-527 ``data_processing``).

One batched function performs the nonzero z-score, the click-guide render
(Gaussian ``--local_enhance`` or Euclidean), joint flips, gamma
augmentation and noise; the trainer runs it inside its train step.  Under
``--local_enhance`` the fg and bg click guides of a batch are ONE launch of
kernel B1 over 2·bs rows (K = ``--max_clicks``, stddev = ``--stddev`` /
rescale per row and axis, valid = arange(K) < n); the Euclidean guides are
plain torch (ops/guides.euclidean_guide; JAX has no kernel for them).
Under ``--geodesic`` the guides are the sampler's host geodesic maps
(``fg_gd``, ``bg_gd``: data/sampler_inter.InterSampler._geodesic_maps).

Host/device contract (data/sampler_inter.InterSampler): images arrive
host-resized at target size with click coordinates pre-scaled into target
coordinates plus a ``rescale = crop/target`` factor, so guide values keep the
reference's crop-resolution semantics.

Randomness: the draws come in as tensors (``draws``: ``flip`` coins [bs, 3],
``gamma`` [bs, 3] and ``noise`` of the image shape, as
ops/image_ops.draw_augment makes them); the tests inject JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from boxsegliver_torch.data.device_cache import widen
from boxsegliver_torch.ops import image_ops
from boxsegliver_torch.ops.guides import euclidean_guide
from boxsegliver_torch.ops.kernels import gaussian_guide_batch
from boxsegliver_torch.parallel.mesh import rank_draws


def click_guides(shape: Tuple[int, int], pts: torch.Tensor, n: torch.Tensor,
                 rescale: torch.Tensor, *, local_enhance: bool,
                 stddev: float) -> torch.Tensor:
    """Guide maps [rows, h, w, 1] from up to K clicks a row (pts [rows, K,
    2], n [rows], rescale [rows, 2]; reference data_processing,
    input_pipeline_g_simply.py:447-470): a Gaussian of constant crop-space
    stddev under local_enhance (kernel B1, one launch for all rows), else
    the Euclidean distance in crop pixels; zeros for a row without clicks
    (the reference's false_fn)."""
    valid = (torch.arange(pts.shape[1], device=pts.device)[None]
             < n[:, None])
    if local_enhance:
        # constant stddev in crop pixels → stddev/rescale in target pixels
        stds = (stddev / rescale.float())[:, None, :].expand(pts.shape)
        return gaussian_guide_batch(pts.float().contiguous(),
                                    stds.contiguous(), valid.contiguous(),
                                    height=shape[0], width=shape[1])
    g = euclidean_guide(shape, pts.float(), mask=valid,
                        weights=rescale.float())
    return torch.where((n > 0)[:, None, None, None], g, 0.0)


def _process_batch_inter(batch: Dict[str, torch.Tensor],
                         draws: Optional[Dict], *, im_h: int, im_w: int,
                         noise_scale: float, random_flip: int,
                         guide_channel: int, local_enhance: bool,
                         geodesic: bool, stddev: float,
                         gamma_range: Tuple[float, float], use_gamma: bool,
                         train: bool):
    """(features {images, sp_guide, names}, labels [bs, h, w] int64) of a
    raw inter batch on the device; ``draws`` may be None when train is
    False."""
    bs = batch["names"].shape[0]
    # the nonzero z-score (JAX nonzero_zscore; reference data_processing,
    # input_pipeline_g_simply.py:437-443): zeros stay zero
    img = image_ops.zscore(widen(batch["image"]).float())
    lab = batch["label"].long()
    if geodesic:
        guides = torch.cat([batch["fg_gd"], batch["bg_gd"]]).float()[..., None]
    else:
        guides = click_guides(
            (im_h, im_w), torch.cat([batch["fg_pts"], batch["bg_pts"]]),
            torch.cat([batch["n_fg"], batch["n_bg"]]),
            torch.cat([batch["rescale"], batch["rescale"]]),
            local_enhance=local_enhance, stddev=stddev)
    ch = img.shape[-1]
    joint = torch.cat([img, guides[:bs], guides[bs:]], dim=-1)
    if train and random_flip:
        joint, lab = image_ops.random_flip(joint, lab, draws["flip"],
                                           flip=random_flip)
    img = joint[..., :ch]
    if guide_channel == 2:
        sp_guide = joint[..., ch:ch + 2]
    else:  # 1-channel: fg - bg (input_pipeline_g_simply.py:503-508)
        sp_guide = joint[..., ch:ch + 1] - joint[..., ch + 1:ch + 2]
    if train and use_gamma:
        img = image_ops.augment_gamma(img, gamma_range, draws["gamma"],
                                      retain_stats=True, p_per_sample=0.3)
    if train and noise_scale > 0:
        img = image_ops.random_noise(img, noise_scale, draws["noise"])
        img = img * batch["pad_mask"][:, None, None, :]
    return {"images": img, "sp_guide": sp_guide,
            "names": batch["names"]}, lab


def make_inter_preprocess_fn(args, train: bool = True, group=None):
    """(device batch, generator) -> (features, labels): the train step's
    processing with its draws from ``generator`` (train=True), or the
    deterministic eval processing of the online evaluator (train=False,
    flips, gamma and noise off, draws None).  Under a ``group`` the draws
    are the global batch's and the rank keeps its rows
    (parallel.mesh.rank_draws)."""
    static = dict(
        im_h=int(args.im_height), im_w=int(args.im_width),
        noise_scale=float(args.noise_scale),
        random_flip=int(args.random_flip),
        guide_channel=int(getattr(args, "guide_channel", 2)),
        local_enhance=bool(getattr(args, "local_enhance", False)),
        geodesic=bool(getattr(args, "geodesic", False)),
        stddev=float(getattr(args, "stddev", 3.0)),
        gamma_range=tuple(getattr(args, "gamma_range", (0.7, 1.5))),
        # the reference applies gamma unconditionally in this pipeline
        # (input_pipeline_g_simply.py:510-513); --no_gamma opts out
        use_gamma=not bool(getattr(args, "no_gamma", False)),
        train=train)

    def fn(batch, generator):
        draws = None
        if train:
            bs = batch["names"].shape[0] * (group.size if group else 1)
            draws = rank_draws(image_ops.draw_augment(
                generator, (bs, static["im_h"], static["im_w"],
                            args.im_channel),
                noise=static["noise_scale"] > 0,
                device=batch["names"].device, gamma=static["use_gamma"]),
                group)
        return _process_batch_inter(batch, draws, **static)

    return fn
