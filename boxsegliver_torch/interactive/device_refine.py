"""Device-resident click refinement on the card (port of
boxsegliver_tpu/interactive/device_refine.py:33-361; host loops:
interactive/refine.py).  2-D: all lesion slices of a case refine together
(``DeviceRefiner2D``); 3-D: the whole volume of a UNet3D
(``DeviceRefiner3D``, below).

JAX compiles the loop into one ``lax.while_loop``; here it is a Python loop
of at most ``max_iters`` click rounds with one host read (``done``) a
round.  Each round, on the card and for every slice of the bucket at once:

1. the next click at the largest error component
   (ops/labeling.largest_error_click);
2. the fg and bg guides — gaussian: ONE launch of kernel B1 over 2·sb rows
   with K = ``max_iters`` click slots; euclidean: plain torch; geodesic:
   ONE launch of kernel G1 (ops/kernels.geodesic2d_batch) for the new
   click's half-resolution field, min-folded into the carried fg or bg
   field (the raster relaxation is min-plus linear, so
   dist(seeds ∪ {p}) = min(dist(seeds), dist({p}))), then a bilinear
   upsample;
3. ONE batched model forward and the per-slice Dice.

Slices that clear the threshold or run out of error freeze through masked
updates, so the trajectory of every slice is the host loop's.  Slices pad
to a bucket of ``_S_BUCKETS`` (fewer distinct shapes for cuDNN's plans).

``mesh``: a data-parallel parallel.Group (JAX's data mesh,
device_refine.py:44-65,206-215).  The bucket pads to a multiple of the
group, each rank refines its rows of it (its clicks, its B1 or G1 launch,
its forward), the stop test sums the ranks' unfinished slices, and the
per-slice Dice and clicks are gathered.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from boxsegliver_torch.interactive.refine import (TTA_FLIPS, click_guide_3d,
                                                  click_guide_maps)
from boxsegliver_torch.ops.kernels import geodesic2d_batch
from boxsegliver_torch.ops.labeling import (largest_error_click,
                                            largest_error_click_3d)
from boxsegliver_torch.parallel.mesh import Group

_S_BUCKETS = (8, 16, 32, 64, 128, 256)


def slice_bucket(s: int, ranks: int = 1) -> int:
    """Rows of the refiner's slice batch for ``s`` lesion slices: the
    smallest bucket that holds them (``s`` itself past the last), padded
    to a multiple of ``ranks`` (JAX device_refine.py:205-207)."""
    sb = next((b for b in _S_BUCKETS if s <= b), s)
    if sb % ranks:
        sb += ranks - sb % ranks
    return sb


class DeviceRefiner2D:
    """Drop-in for the ``interactive_eval_2d`` call of cli/interactive_eval:
    ``refine_case(images [S, h, w, c], labels [S, h, w])`` returns the same
    {"Dice", "clicks", "slices"} dict; ``rounds`` then holds the number of
    click rounds (batched forwards) that case ran."""

    def __init__(self, model: torch.nn.Module, *, dice_thresh: float = 0.85,
                 max_iters: int = 10, stddev: float = 5.0,
                 guide_kind: str = "gaussian", guide_channel: int = 2,
                 device="cuda", mesh=None):
        if guide_kind not in ("gaussian", "euclidean", "geodesic"):
            raise ValueError(f"unknown guide kind {guide_kind!r}")
        if mesh is not None and not isinstance(mesh, Group):
            raise TypeError("mesh must be a parallel.Group (one rank a "
                            f"process), not {type(mesh).__name__}")
        self.mesh = mesh
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.dice_thresh = float(dice_thresh)
        self.max_iters = int(max_iters)
        self.stddev = float(stddev)
        self.guide_kind = guide_kind
        self.guide_channel = int(guide_channel)
        self.rounds = 0

    def _render(self, pts, valid_fg, valid_bg, h, w):
        """fg and bg maps [2, sb, h, w] from the click slots (gaussian: one
        B1 launch over the 2·sb rows)."""
        g = click_guide_maps(torch.cat([pts, pts]),
                             torch.cat([valid_fg, valid_bg]), (h, w),
                             self.stddev, self.guide_kind)
        return g.reshape((2,) + tuple(pts.shape[:1]) + (h, w))

    @staticmethod
    def _geo_render(dist, any_click, h, w):
        """Half-res field bilinearly upsampled; zeros for slices without a
        click of the kind (this also masks their +inf field)."""
        full = F.interpolate(dist[:, None], size=(h, w), mode="bilinear",
                             align_corners=False)[:, 0]
        return torch.where(any_click[:, None, None], full, 0.0)

    @torch.no_grad()
    def refine_case(self, images: np.ndarray, labels: np.ndarray
                    ) -> Dict[str, float]:
        """images [S, h, w, c] float32, labels [S, h, w] (nonzero =
        lesion)."""
        lab = np.asarray(labels) > 0
        lesion = lab.any(axis=(1, 2))
        self.rounds = 0
        if not lesion.any():
            return {"Dice": 1.0, "clicks": 0.0, "slices": 0.0}
        images = np.asarray(images, np.float32)[lesion]
        lab = lab[lesion]
        s, h, w = lab.shape
        c = images.shape[-1]
        group = self.mesh
        sb = slice_bucket(s, 1 if group is None else group.size)
        dev = self.device
        imgs = torch.zeros((sb, h, w, c), dtype=torch.float32, device=dev)
        imgs[:s] = torch.from_numpy(images).to(dev)
        labs = torch.zeros((sb, h, w), dtype=torch.bool, device=dev)
        labs[:s] = torch.from_numpy(lab).to(dev)
        if group is not None:               # this rank's rows of the bucket
            rows = group.rows(sb)
            imgs, labs = imgs[rows].contiguous(), labs[rows].contiguous()
            sb = imgs.shape[0]

        t_max = self.max_iters
        pred = torch.zeros((sb, h, w), dtype=torch.bool, device=dev)
        pts = torch.zeros((sb, t_max, 2), dtype=torch.int64, device=dev)
        isfg = torch.zeros((sb, t_max), dtype=torch.bool, device=dev)
        valid = torch.zeros((sb, t_max), dtype=torch.bool, device=dev)
        done = torch.zeros((sb,), dtype=torch.bool, device=dev)
        dice = torch.zeros((sb,), dtype=torch.float32, device=dev)
        clicks = torch.zeros((sb,), dtype=torch.int64, device=dev)
        geodesic = self.guide_kind == "geodesic"
        if geodesic:
            ds_imgs = imgs[:, ::2, ::2, c // 2].contiguous()
            h2, w2 = ds_imgs.shape[1:]
            fg_d = torch.full((sb, h2, w2), float("inf"), device=dev)
            bg_d = torch.full((sb, h2, w2), float("inf"), device=dev)
            iy2 = torch.arange(h2, device=dev)
            ix2 = torch.arange(w2, device=dev)
        for t in range(t_max):
            coords, fg, has_err = largest_error_click(pred, labs)
            clicking = ~done & has_err
            pts[:, t] = coords
            isfg[:, t] = fg
            valid[:, t] = clicking
            clicks += clicking
            if geodesic:
                sy = (coords[:, 0] // 2).clamp(0, h2 - 1)
                sx = (coords[:, 1] // 2).clamp(0, w2 - 1)
                seeds = ((iy2[None, :, None] == sy[:, None, None])
                         & (ix2[None, None, :] == sx[:, None, None]))
                dnew = geodesic2d_batch(ds_imgs, seeds.contiguous())
                fg_d = torch.where((clicking & fg)[:, None, None],
                                   torch.minimum(fg_d, dnew), fg_d)
                bg_d = torch.where((clicking & ~fg)[:, None, None],
                                   torch.minimum(bg_d, dnew), bg_d)
                fg_g = self._geo_render(fg_d, (valid & isfg).any(dim=1), h, w)
                bg_g = self._geo_render(bg_d, (valid & ~isfg).any(dim=1), h,
                                        w)
            else:
                fg_g, bg_g = self._render(pts, valid & isfg, valid & ~isfg,
                                          h, w)
            if self.guide_channel == 2:
                guide = torch.stack([fg_g, bg_g], dim=-1)
            else:
                guide = (fg_g - bg_g)[..., None]
            logits = self.model({"images": imgs, "sp_guide": guide})
            new_pred = logits.argmax(dim=-1) > 0
            tp = (new_pred & labs).sum(dim=(1, 2))
            fp = (new_pred & ~labs).sum(dim=(1, 2))
            fn = (~new_pred & labs).sum(dim=(1, 2))
            denom = (2 * tp + fp + fn).float()
            new_dice = torch.where(denom > 0, 2.0 * tp.float()
                                   / denom.clamp_min(1.0), 0.0)
            pred = torch.where(clicking[:, None, None], new_pred, pred)
            dice = torch.where(clicking, new_dice, dice)
            done = done | ~has_err | (clicking & (new_dice > self.dice_thresh))
            self.rounds = t + 1
            if group is None:
                if bool(done.all()):
                    break
            elif int(group.all_reduce_((~done).sum())) == 0:
                break
        if group is not None:
            dice = group.gather_rows(dice)
            clicks = group.gather_rows(clicks)
        dice = dice[:s].cpu().numpy()
        clicks = clicks[:s].cpu().numpy()
        return {"Dice": float(dice.mean()), "clicks": float(clicks.mean()),
                "slices": float(s)}


class DeviceRefiner3D:
    """Whole-volume click refinement on the card (port of JAX
    device_refine.py:228-361; host loop: interactive/refine.
    interactive_eval_3d).  JAX's ``lax.while_loop`` is an eager loop of at
    most ``max_iters`` rounds with one host read a round (the stop flag).
    Each round, on the device: the next click at the largest 3-D error
    component (ops/labeling.largest_error_click_3d), its Gaussian max-folded
    into the fg or bg guide, one forward (eight with ``tta``: the mean of
    the mirrored forwards' probabilities), the prediction masked to the
    valid region, and the Dice.  The cascade channel stays on the host
    loop, as in JAX.  ``rounds`` holds the rounds of the last case."""

    def __init__(self, model: torch.nn.Module, *, dice_thresh: float = 0.85,
                 max_iters: int = 20, stddev: float = 5.0, tta: bool = False,
                 guide_channel: int = 1, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.dice_thresh = float(dice_thresh)
        self.max_iters = int(max_iters)
        self.stddev = float(stddev)
        self.flips = TTA_FLIPS if tta else [()]
        self.guide_channel = int(guide_channel)
        self.rounds = 0

    @torch.no_grad()
    def refine_case(self, volume: np.ndarray, label: np.ndarray, *,
                    valid_shape=None) -> Dict[str, float]:
        """volume [d, h, w] or [d, h, w, c] float32 (padded and normalized,
        as the host loop's), label [d, h, w] (nonzero = lesion)."""
        dev = self.device
        vol = np.asarray(volume, np.float32)
        if vol.ndim == 3:
            vol = vol[..., None]
        image = torch.from_numpy(np.ascontiguousarray(vol))[None].to(dev)
        labs = torch.from_numpy(np.asarray(label) > 0).to(dev)
        shape = tuple(labs.shape)
        vd, vh, vw = valid_shape if valid_shape is not None else shape
        valid = torch.zeros(shape, dtype=torch.bool, device=dev)
        valid[:vd, :vh, :vw] = True
        pred = torch.zeros(shape, dtype=torch.bool, device=dev)
        fg_g = torch.zeros(shape, device=dev)
        bg_g = torch.zeros(shape, device=dev)
        dice = torch.zeros((), device=dev)
        clicks = torch.zeros((), dtype=torch.int64, device=dev)
        self.rounds = 0
        for t in range(self.max_iters):
            coords, fg, has_err = largest_error_click_3d(pred, labs)
            g_new = click_guide_3d(shape, [coords], self.stddev, dev)
            fg_g = torch.where(has_err & fg, torch.maximum(fg_g, g_new),
                               fg_g)
            bg_g = torch.where(has_err & ~fg, torch.maximum(bg_g, g_new),
                               bg_g)
            clicks += has_err
            guide = (torch.stack([fg_g, bg_g], dim=-1)
                     if self.guide_channel == 2
                     else (fg_g - bg_g)[..., None])[None]
            acc = None
            for axes in self.flips:
                logits = self.model({
                    "images": image.flip(axes) if axes else image,
                    "sp_guide": guide.flip(axes) if axes else guide})
                probs = torch.softmax(logits, dim=-1)
                probs = probs.flip(axes) if axes else probs
                acc = probs if acc is None else acc + probs
            new_pred = (acc[0].argmax(dim=-1) > 0) & valid
            tp = (new_pred & labs).sum()
            fp = (new_pred & ~labs).sum()
            fn = (~new_pred & labs).sum()
            denom = (2 * tp + fp + fn).float()
            new_dice = torch.where(denom > 0, 2.0 * tp.float()
                                   / denom.clamp_min(1.0), 0.0)
            pred = torch.where(has_err, new_pred, pred)
            dice = torch.where(has_err, new_dice, dice)
            self.rounds = t + 1
            if bool(~has_err | (new_dice > self.dice_thresh)):
                break
        return {"Dice": float(dice), "clicks": float(clicks)}
