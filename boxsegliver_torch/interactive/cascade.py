"""2-D → 3-D cascade: a frozen 2-D model's per-slice predictions become an
extra input channel of UNet3D (port of
boxsegliver_tpu/interactive/cascade.py:22-210; reference
entry/infer_2d.py:32-128 ``InferenceWithGuide2D`` and its use in
DataLoader/NF/input_pipeline_3d.py:474-539).

The 2-D model runs with mirror TTA over slices; the resulting binary mask
feeds the 3-D net as a binary channel or as an exp(-EDT/τ) boundary-distance
channel.  Training variants (gen_kernel, input_pipeline_3d.py:508-534): the
click-guided 2-D model runs only on the slices that carry foreground clicks
(``CascadeClick2D``; its fg and bg Gaussian click guides are ONE launch of
kernel B1 a slice), or a GT-oracle channel takes the label slice at the
first click's z (``gt_cascade_channel``).  Masks, zooms and distance
transforms are host scipy, as in JAX; the forwards and their mirrors run on
``device``.  Predict functions take feature dicts of tensors on ``device``
and return probabilities there.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from scipy import ndimage as ndi

from boxsegliver_torch.ops.kernels import gaussian_guide_batch


def inner_boundaries(mask: np.ndarray) -> np.ndarray:
    """Per-slice inner boundary pixels (skimage find_boundaries(mode=
    'inner') for 2-D slices: object pixels with a background 4-neighbour)."""
    mask = mask.astype(bool)
    eroded = ndi.binary_erosion(mask, ndi.generate_binary_structure(2, 1),
                                border_value=1)
    return mask & ~eroded


def edt_cascade_channel(slice_masks: np.ndarray, zs, tau: float = 25.0
                        ) -> np.ndarray:
    """exp(-EDT/τ) around the inner boundaries of the given slices
    (reference gen_kernel, input_pipeline_3d.py:512-519)."""
    boundaries = np.zeros(slice_masks.shape, bool)
    for z in zs:
        z = int(z)
        boundaries[z] = inner_boundaries(slice_masks[z])
    dist = ndi.distance_transform_edt(~boundaries)
    return np.exp(-dist / max(tau, 1e-6)).astype(np.float32)


def gt_cascade_channel(lab_patch: np.ndarray, fg_pts: np.ndarray,
                       binary: bool = True, tau: float = 25.0) -> np.ndarray:
    """GT-oracle cascade channel: the label slice at the FIRST foreground
    click's z, binary or boundary-EDT (reference gen_kernel 'not use_2d'
    branch, input_pipeline_3d.py:521-534)."""
    out = np.zeros(lab_patch.shape, np.float32)
    valid = fg_pts[fg_pts[:, 0] >= 0] if fg_pts.size else fg_pts
    if valid.shape[0] == 0:
        return out
    z = int(valid[0, 0])
    if binary:
        out[z] = (lab_patch[z] > 0).astype(np.float32)
        return out
    masks = np.zeros(lab_patch.shape, np.uint8)
    masks[z] = lab_patch[z] > 0
    return edt_cascade_channel(masks, [z], tau)


def _mirror_mean(predict_fn: Callable, feats, eval_mirror: bool):
    """Probabilities of ``feats`` ([n, h, w, c] tensors) averaged over the
    width, height and both flips (``eval_mirror``), as JAX's lr / ud / both
    TTA: each flipped input's output flipped back."""
    probs = predict_fn(feats).float()
    count = 1
    if eval_mirror:
        for axes in ((2,), (1,), (1, 2)):
            p = predict_fn({k: v.flip(axes) for k, v in feats.items()})
            probs = probs + p.float().flip(axes)
            count += 1
    return probs / count


class CascadeClick2D:
    """Click-guided frozen-2-D cascade for 3-D TRAINING patches (reference
    InferenceWithGuide2D.get_pred_2d, entry/infer_2d.py:81-128): the 2-D
    interactive model runs only on the slices with foreground clicks, with
    Gaussian click guides (stddev 5; fg and bg as the two rows of one B1
    launch) and lr / ud / both mirror TTA.

    predict_fn: {"images": [1, H, W, C], "sp_guide": [1, H, W, 2]} tensors
    on ``device`` → probabilities."""

    def __init__(self, predict_fn: Callable, im_height: int, im_width: int,
                 im_channel: int = 3, stddev: float = 5.0,
                 fg_index: int = 1, eval_mirror: bool = True,
                 device="cpu"):
        self.predict_fn = predict_fn
        self.pshape = (im_height, im_width)
        self.channel = im_channel
        self.stddev = stddev
        self.fg_index = fg_index
        self.eval_mirror = eval_mirror
        self.device = torch.device(device)

    def _slice_pred(self, stack: np.ndarray, fg: np.ndarray, bg: np.ndarray
                    ) -> np.ndarray:
        h, w = stack.shape[:2]
        nz = stack > 0
        if nz.any():
            vals = stack[nz]
            stack = stack.copy()
            stack[nz] = (vals - vals.mean()) / (vals.std() + 1e-8)
        k = max(len(fg), len(bg), 1)
        pts = np.zeros((2, k, 2), np.float32)
        valid = np.zeros((2, k), bool)
        for row, p in enumerate((fg, bg)):
            pts[row, :len(p)] = p
            valid[row, :len(p)] = True
        pts = torch.from_numpy(pts).to(self.device)
        guide = gaussian_guide_batch(
            pts, torch.full_like(pts, float(self.stddev)),
            torch.from_numpy(valid).to(self.device), height=h, width=w)
        feats = {"images": torch.from_numpy(stack.astype(np.float32))[None]
                 .to(self.device),
                 "sp_guide": guide[..., 0].permute(1, 2, 0)[None]}
        probs = _mirror_mean(self.predict_fn, feats, self.eval_mirror)
        return (probs[0].argmax(dim=-1) == self.fg_index).cpu().numpy()

    def pred_from_clicks(self, patch: np.ndarray, fg_pts: np.ndarray,
                         bg_pts: np.ndarray):
        """patch [d, h, w] raw values; fg / bg_pts [n, 3] (z, y, x), -1
        padded.  Returns (mask [d, h, w] uint8, zs of predicted slices)."""
        fg_pts = fg_pts[fg_pts[:, 0] >= 0] if fg_pts.size else fg_pts
        bg_pts = bg_pts[bg_pts[:, 0] >= 0] if bg_pts.size else bg_pts
        d = patch.shape[0]
        scale = np.array([1.0, self.pshape[0] / patch.shape[1],
                          self.pshape[1] / patch.shape[2]])
        zoomed = ndi.zoom(patch.astype(np.float32), scale, order=1)
        fg = fg_pts * scale
        bg = bg_pts * scale if bg_pts.shape[0] else bg_pts
        lh = (self.channel - 1) // 2
        mask = np.zeros(zoomed.shape, np.uint8)
        zs = np.unique(fg[:, 0].astype(np.int64)) if fg.shape[0] else []
        for z in zs:
            z = int(z)
            stack = np.zeros(self.pshape + (self.channel,), np.float32)
            for k in range(self.channel):
                src = z - lh + k
                if 0 <= src < d:
                    stack[..., k] = zoomed[src]
            fg_z = fg[fg[:, 0].astype(np.int64) == z, 1:]
            bg_z = bg[bg[:, 0].astype(np.int64) == z, 1:] if bg.shape[0] \
                else np.zeros((0, 2), np.float32)
            mask[z] = self._slice_pred(stack, fg_z, bg_z)
        back = ndi.zoom(mask, 1.0 / scale, order=0)
        return back[:d, :patch.shape[1], :patch.shape[2]], zs

    def extra_channel_from_clicks(self, patch: np.ndarray, fg_pts: np.ndarray,
                                  bg_pts: np.ndarray, binary: bool = True,
                                  tau: float = 25.0) -> np.ndarray:
        """Training cascade channel (reference gen_kernel use_2d branch)."""
        mask, zs = self.pred_from_clicks(patch, fg_pts, bg_pts)
        if len(zs) == 0:
            return np.zeros(patch.shape, np.float32)
        if binary:
            return mask.astype(np.float32)
        return edt_cascade_channel(mask, zs, tau)


class Cascade2D:
    """A 2-D predict function as a volume → extra-channel producer (eval):
    2.5-D stacks of ``im_channel`` edge-padded slices, ``batch_size`` slices
    a forward, mirror TTA."""

    def __init__(self, predict_fn: Callable, batch_size: int = 8,
                 im_channel: int = 3, eval_mirror: bool = True,
                 channel_mode: str = "binary", tau: float = 5.0,
                 fg_index: int = 1, device="cpu"):
        self.predict_fn = predict_fn
        self.batch_size = batch_size
        self.im_channel = im_channel
        self.eval_mirror = eval_mirror
        self.channel_mode = channel_mode  # binary | edt
        self.tau = tau
        self.fg_index = fg_index
        self.device = torch.device(device)

    def predict_volume(self, volume: np.ndarray) -> np.ndarray:
        """volume: [d, h, w] normalized → binary mask [d, h, w] uint8."""
        d, h, w = volume.shape
        lh = (self.im_channel - 1) // 2
        rh = self.im_channel - 1 - lh
        padded = np.concatenate([
            np.repeat(volume[:1], lh, axis=0), volume,
            np.repeat(volume[-1:], rh, axis=0)], axis=0)
        mask = np.zeros((d, h, w), np.uint8)
        bs = self.batch_size
        for z0 in range(0, d, bs):
            n = min(bs, d - z0)
            batch = np.zeros((bs, h, w, self.im_channel), np.float32)
            for j in range(n):
                batch[j] = np.transpose(
                    padded[z0 + j:z0 + j + self.im_channel], (1, 2, 0))
            feats = {"images": torch.from_numpy(batch).to(self.device)}
            probs = _mirror_mean(self.predict_fn, feats, self.eval_mirror)
            mask[z0:z0 + n] = (probs[:n].argmax(dim=-1)
                               == self.fg_index).cpu().numpy()
        return mask

    def extra_channel(self, volume: np.ndarray) -> np.ndarray:
        """[d, h, w] float32 cascade channel: the binary mask, or
        exp(-EDT/τ) of the distance to the predicted boundary (reference
        input_pipeline_3d.py:474-539)."""
        mask = self.predict_volume(volume)
        if self.channel_mode == "binary":
            return mask.astype(np.float32)
        inner = ndi.distance_transform_edt(mask)
        outer = ndi.distance_transform_edt(1 - mask)
        dist = np.where(mask > 0, inner, outer)
        return np.exp(-dist / max(self.tau, 1e-6)).astype(np.float32)
