"""The interactive click-refinement eval's host loops, 2-D and 3-D (port of
boxsegliver_tpu/interactive/refine.py:27-228; reference
entry/main_eval.py:43-396, entry/main_eval_3d.py:152-420).

Per lesion slice: place the next click at the largest error component
(interactive/clicks.next_click_from_error, host scipy), render the fg / bg
guides, predict, and repeat until Dice clears the threshold or the click
budget runs out.  Guides:

- gaussian: ``max_k exp(-d² / 2σ²)`` — kernel B1 on the card (fg and bg as
  the two rows of ONE launch a click; ops/kernels.gaussian_guide_batch), its
  plain version on the CPU;
- euclidean: ``exp(-min_k d / σ)`` in plain torch;
- geodesic: the training convention (data/sampler_inter): the host C++
  raster scan (csrc/native.geodesic2d) on the 2x-downsampled middle channel,
  then OpenCV's float32 bilinear upsample (ops/image_ops.resize_linear_f32,
  a numpy copy: the GPU machine has no OpenCV).

A slice without clicks of a kind renders zeros.  The 3-D loop
(``interactive_eval_3d``, port of refine.py:151-228) clicks in the whole
volume of a UNet3D, its Gaussian guides rendered in plain torch on the
device, with optional 8-way mirror TTA.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from boxsegliver_torch.csrc import native
from boxsegliver_torch.interactive.clicks import next_click_from_error
from boxsegliver_torch.ops.image_ops import resize_linear_f32
from boxsegliver_torch.ops.kernels import gaussian_guide_batch
from boxsegliver_torch.ops.metrics import ConfusionMatrix


def click_guide_maps(pts: torch.Tensor, valid: torch.Tensor, shape,
                     stddev: float = 5.0, kind: str = "gaussian"
                     ) -> torch.Tensor:
    """Guide maps [rows, h, w] float32 from click slots (pts [rows, K, 2]
    float32 ij, valid [rows, K] bool): gaussian ``max_k exp(-d² / 2σ²)`` by
    kernel B1 (one launch for all rows), euclidean ``exp(-min_k d / σ)`` in
    plain torch; zeros for a row without a valid click."""
    h, w = int(shape[0]), int(shape[1])
    pts = pts.float().contiguous()
    valid = valid.contiguous()
    if kind == "gaussian":
        stds = torch.full_like(pts, float(stddev))
        return gaussian_guide_batch(pts, stds, valid, height=h,
                                    width=w)[..., 0]
    if kind != "euclidean":
        raise ValueError(f"Unknown guide kind {kind}")
    iy = torch.arange(h, dtype=torch.float32, device=pts.device)
    ix = torch.arange(w, dtype=torch.float32, device=pts.device)
    d2 = ((iy[None, None, :, None] - pts[..., 0, None, None]) ** 2
          + (ix[None, None, None, :] - pts[..., 1, None, None]) ** 2)
    d2 = torch.where(valid[..., None, None], d2, float("inf"))
    out = torch.exp(-torch.sqrt(d2.amin(dim=1)) / max(stddev, 1e-6))
    return torch.where(valid.any(dim=1)[:, None, None], out, 0.0)


def render_click_guides(shape, fg: List[Tuple], bg: List[Tuple],
                        stddev: float = 5.0, kind: str = "gaussian",
                        device="cpu") -> torch.Tensor:
    """fg and bg guide maps [2, h, w] float32 on ``device`` from click
    lists (ij): one click_guide_maps call (one B1 launch) for both."""
    k = max(len(fg), len(bg), 1)
    pts = np.zeros((2, k, 2), np.float32)
    valid = np.zeros((2, k), bool)
    for row, clicks in enumerate((fg, bg)):
        if clicks:
            pts[row, :len(clicks)] = np.asarray(clicks, np.float32)
            valid[row, :len(clicks)] = True
    return click_guide_maps(torch.from_numpy(pts).to(device),
                            torch.from_numpy(valid).to(device), shape,
                            stddev, kind)


def render_click_guide(shape, clicks: List[Tuple], stddev: float = 5.0,
                       kind: str = "gaussian", device="cpu") -> torch.Tensor:
    """One max-over-clicks guide map [h, w] (JAX render_click_guide, 2-D)."""
    return render_click_guides(shape, clicks, [], stddev, kind, device)[0]


def render_geodesic_guide(image: np.ndarray, clicks: List[Tuple],
                          lamb: float = 1.0, iterations: int = 4,
                          scale: float = 10.0,
                          spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                          ) -> np.ndarray:
    """exp(-geodesic distance / scale) at full resolution over a [h, w]
    slice or a [d, h, w] volume (``spacing`` scales a volume's steps;
    reference GeodisTK usage, DataLoader/NF/input_pipeline_g_simply.py:
    476-489)."""
    seeds = np.zeros(image.shape, np.uint8)
    for c in clicks:
        seeds[tuple(int(x) for x in c)] = 1
    if image.ndim == 3:
        dist = native.geodesic3d(image, seeds, lamb, iterations, spacing)
    else:
        dist = native.geodesic2d(image, seeds, lamb, iterations)
    return np.exp(-dist / max(scale, 1e-6)).astype(np.float32)


def render_geodesic_eval_guide(image: np.ndarray, clicks: List[Tuple],
                               lamb: float = 1.0, iterations: int = 4
                               ) -> np.ndarray:
    """Raw-distance geodesic guide in the training convention
    (data/sampler_inter.InterSampler._geodesic_maps): the raster scan on the
    2x-downsampled slice from the halved clicks, upsampled back with
    OpenCV's float32 bilinear.  No clicks -> zeros."""
    h, w = image.shape
    if len(clicks) == 0:
        return np.zeros((h, w), np.float32)
    ds = np.ascontiguousarray(image[::2, ::2], np.float32)
    pts = np.asarray(clicks)
    seeds = np.zeros(ds.shape, np.uint8)
    ys = np.clip((pts[:, 0] / 2).astype(np.int32), 0, ds.shape[0] - 1)
    xs = np.clip((pts[:, 1] / 2).astype(np.int32), 0, ds.shape[1] - 1)
    seeds[ys, xs] = 1
    dist = native.geodesic2d(ds, seeds, lamb, iterations)
    return resize_linear_f32(dist, (h, w))


def interactive_eval_2d(predict_fn: Callable, images: np.ndarray,
                        labels: np.ndarray, *, dice_thresh: float = 0.85,
                        max_iters: int = 10, stddev: float = 5.0,
                        guide_kind: str = "gaussian", guide_channel: int = 2,
                        device="cpu") -> Dict[str, float]:
    """Per-slice interactive refinement (reference entry/main_eval.py loop).

    images [S, h, w, c] float32, labels [S, h, w]; ``predict_fn({"images":
    [1, h, w, c], "sp_guide": [1, h, w, gc]})`` takes tensors on ``device``
    and returns probabilities [1, h, w, nc].  Only lesion-bearing slices
    are scored.  Returns the mean final Dice and clicks per slice and the
    slice count."""
    n_slices = images.shape[0]
    shape = labels.shape[1:]
    total_dice, total_clicks = [], []
    for z in range(n_slices):
        lab = labels[z] > 0
        if not lab.any():
            continue
        fg_clicks: List[Tuple] = []
        bg_clicks: List[Tuple] = []
        pred = np.zeros(shape, np.uint8)
        clicks_used = 0
        dice = 0.0
        image = torch.from_numpy(np.ascontiguousarray(
            images[z][None], np.float32)).to(device)
        for _ in range(max_iters):
            coords, is_fg = next_click_from_error(pred, lab)
            if coords is None:
                break
            (fg_clicks if is_fg else bg_clicks).append(coords)
            clicks_used += 1
            if guide_kind == "geodesic":
                center = images[z][..., images.shape[-1] // 2]
                g = torch.from_numpy(np.stack([
                    render_geodesic_eval_guide(center, fg_clicks),
                    render_geodesic_eval_guide(center, bg_clicks)])).to(device)
            else:
                g = render_click_guides(shape, fg_clicks, bg_clicks, stddev,
                                        guide_kind, device)
            guide = (g.permute(1, 2, 0) if guide_channel == 2
                     else (g[0] - g[1])[..., None])
            probs = predict_fn({"images": image, "sp_guide": guide[None]})
            pred = (probs[0].argmax(dim=-1) > 0).to(torch.uint8).cpu().numpy()
            dice = ConfusionMatrix(pred, lab.astype(int)).global_dice
            if dice > dice_thresh:
                break
        total_dice.append(dice)
        total_clicks.append(clicks_used)
    if not total_dice:  # no lesion-bearing slices in this case
        return {"Dice": 1.0, "clicks": 0.0, "slices": 0.0}
    return {"Dice": float(np.mean(total_dice)),
            "clicks": float(np.mean(total_clicks)),
            "slices": float(len(total_dice))}


def click_guide_3d(shape, clicks, stddev: float = 5.0,
                   device="cpu") -> torch.Tensor:
    """Max-over-clicks Gaussian ``exp(-d² / 2σ²)`` [d, h, w] float32 on
    ``device`` (JAX render_click_guide at rank 3), zeros without a click;
    plain torch, one click at a time.  A click is a tuple of ints or a [3]
    tensor on ``device`` (read without a host sync)."""
    out = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    axes = [torch.arange(n, dtype=torch.float32, device=device)
            for n in shape]
    for c in clicks:
        if isinstance(c, torch.Tensor):
            c = c.float()
        else:
            c = [float(v) for v in c]
        d2 = ((axes[0] - c[0]) ** 2)[:, None, None] + (
            (axes[1] - c[1]) ** 2)[None, :, None] + (
            (axes[2] - c[2]) ** 2)[None, None, :]
        out = torch.maximum(out, torch.exp(-d2 / (2.0 * stddev ** 2)))
    return out


# 8-way mirror TTA over [1, d, h, w, *] (reference main_eval_3d.py TTA)
TTA_FLIPS = [(), (1,), (2,), (3,), (1, 2), (1, 3), (2, 3), (1, 2, 3)]


def interactive_eval_3d(predict_fn: Callable, volume: np.ndarray,
                        label: np.ndarray, *, dice_thresh: float = 0.85,
                        max_iters: int = 20, stddev: float = 5.0,
                        tta: bool = False, use_cascade: bool = False,
                        cascade_binary: bool = False,
                        guide_channel: int = 1, valid_shape=None,
                        device="cpu") -> Dict[str, float]:
    """Whole-volume interactive loop (reference entry/main_eval_3d.py:
    326-420): a click at the largest error component's core (host scipy),
    the 3-D Gaussian guides of all clicks, a forward (with ``tta``, the mean
    of the 8 mirrored forwards' probabilities), until Dice clears the
    threshold or the budget runs out.

    volume [d, h, w] or [d, h, w, c] float32 (padded, normalized), label
    [d, h, w]; ``predict_fn({"images": [1, d, h, w, c], "sp_guide": [1, d,
    h, w, gc]})`` takes tensors on ``device`` and returns probabilities
    (guide_channel 1 = fg − bg, 2 = stacked).  ``use_cascade`` adds the
    GT-oracle image channel of the first positive click's slice once it
    exists; voxels beyond ``valid_shape`` (the alignment padding) are
    predicted background.  Returns the final Dice and the clicks used."""
    from boxsegliver_torch.interactive.cascade import gt_cascade_channel

    shape = label.shape
    fg_clicks: List[Tuple] = []
    bg_clicks: List[Tuple] = []
    pred = np.zeros(shape, np.uint8)
    dice = 0.0
    clicks_used = 0
    vol = volume[..., None] if volume.ndim == 3 else volume
    image = torch.from_numpy(np.ascontiguousarray(vol, np.float32))[None]
    image = image.to(device)
    cascade_ch = (torch.zeros((1,) + shape + (1,), device=device)
                  if use_cascade else None)
    cascade_set = False
    flips = TTA_FLIPS if tta else [()]
    valid = None
    if valid_shape is not None:
        valid = np.zeros(shape, np.uint8)
        valid[:valid_shape[0], :valid_shape[1], :valid_shape[2]] = 1
    for _ in range(max_iters):
        coords, is_fg = next_click_from_error(pred, label)
        if coords is None:
            break
        (fg_clicks if is_fg else bg_clicks).append(coords)
        clicks_used += 1
        if use_cascade and not cascade_set and fg_clicks:
            cascade_ch = torch.from_numpy(gt_cascade_channel(
                (label > 0).astype(np.uint8),
                np.asarray(fg_clicks, np.float32),
                binary=cascade_binary))[None, ..., None].to(device)
            cascade_set = True
        fg_g = click_guide_3d(shape, fg_clicks, stddev, device)
        bg_g = click_guide_3d(shape, bg_clicks, stddev, device)
        guide = (torch.stack([fg_g, bg_g], dim=-1) if guide_channel == 2
                 else (fg_g - bg_g)[..., None])[None]
        x = torch.cat([image, cascade_ch], dim=-1) if use_cascade else image
        acc = None
        for axes in flips:
            probs = predict_fn({"images": x.flip(axes) if axes else x,
                                "sp_guide": guide.flip(axes) if axes
                                else guide})
            probs = probs.flip(axes) if axes else probs
            acc = probs if acc is None else acc + probs
        probs = acc[0] / len(flips)
        pred = (probs.argmax(dim=-1) > 0).to(torch.uint8).cpu().numpy()
        if valid is not None:
            pred *= valid
        dice = ConfusionMatrix(pred, label.astype(int)).global_dice
        if dice > dice_thresh:
            break
    return {"Dice": float(dice), "clicks": float(clicks_used)}
