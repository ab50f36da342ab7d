"""Image resizes with OpenCV's ``cv2.resize`` semantics, on torch tensors.

The JAX package resizes eval volumes and predictions on the host with
``cv2.INTER_LINEAR`` / ``cv2.INTER_NEAREST`` (evaluators/device_eval.py,
evaluators/volume.py, evaluators/eval_loader.py).  The port carries no
OpenCV dependency and resizes on the tensor's device instead:

- bilinear: ``F.interpolate(mode="bilinear", align_corners=False)`` samples on
  the same half-pixel grid with the same edge clamping as INTER_LINEAR
  (float weights; agreement with cv2 to ~3e-5 on [0, 1] data,
  tests/test_torch_resize.py);
- nearest: cv2 picks ``min(floor(x * (1 / (dst / src))), src - 1)`` in double
  precision.  ``F.interpolate(mode="nearest")`` does the same product in
  float32 and so picks another source pixel at some sizes; the index vectors
  here are computed in float64 exactly as cv2 does and applied with a gather,
  so nearest resizes are bit-identical to cv2;
- area (downscale only): cv2.INTER_AREA's weights, the fractional overlap
  of each destination pixel's footprint with the source pixels, computed in
  float64 as cv2 computes them and applied as one matrix per axis; uint8
  results are rounded half to even as cv2's saturate_cast rounds, and half
  up at a factor of exactly 2 as cv2's integer 2x2 path does.  cv2 sums in
  float32, so a pixel may differ from it by one level
  (tests/test_torch_viewer.py counts them).

It also carries the train-time crop-and-resize, noise and flips of the JAX
package's device pipeline (below).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """[..., h, w] float -> [..., H, W] float32, cv2.INTER_LINEAR semantics."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x.float()
    lead = x.shape[:-2]
    flat = x.reshape((-1, 1) + tuple(x.shape[-2:])).float()
    out = F.interpolate(flat, size=size, mode="bilinear", align_corners=False)
    return out.reshape(lead + size)


def _cv2_nearest_index(src: int, dst: int) -> np.ndarray:
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64),
                      src - 1)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """[..., h, w] any dtype -> [..., H, W], cv2.INTER_NEAREST semantics."""
    size = (int(size[0]), int(size[1]))
    h, w = x.shape[-2:]
    if (h, w) == size:
        return x
    iy = torch.from_numpy(_cv2_nearest_index(h, size[0])).to(x.device)
    ix = torch.from_numpy(_cv2_nearest_index(w, size[1])).to(x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def _linear_taps(src: int, dst: int):
    """cv2.INTER_LINEAR's taps along one axis: f = (d + 0.5)·(src / dst) −
    0.5 in double, s = floor(f), weight (float)(f − s).  Returns (s, weight
    float32); taps outside [0, src − 1] are the caller's to clamp."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def resize_linear_f32(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR) of a [h, w]
    or [h, w, c] image in float32, in numpy: a horizontal pass (taps clamped
    to the first and last column, weight 0 at the clamp), then a vertical
    pass (rows clamped, weights kept), as OpenCV's float path computes it
    (its vector code may contract a product into an FMA: a few ulp).  An
    unchanged size is a float32 copy."""
    H, W = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    x = np.array(img, np.float32)
    if (h, w) == (H, W):
        return x
    sx, fx = _linear_taps(w, W)
    lo = sx < 0
    hi = sx >= w - 1
    fx = np.where(lo | hi, np.float32(0), fx).astype(np.float32)
    sx = np.clip(sx, 0, w - 1)
    ax1 = np.minimum(sx + 1, w - 1)
    ax0 = (np.float32(1) - fx).astype(np.float32)
    shp = (1, W) + (1,) * (img.ndim - 2)
    rows = (x[:, sx] * ax0.reshape(shp) + x[:, ax1] * fx.reshape(shp))
    sy, fy = _linear_taps(h, H)
    y0 = np.clip(sy, 0, h - 1)
    y1 = np.clip(sy + 1, 0, h - 1)
    by0 = (np.float32(1) - fy).astype(np.float32)
    shp = (H,) + (1,) * (img.ndim - 1)
    return rows[y0] * by0.reshape(shp) + rows[y1] * fy.reshape(shp)


def resize_linear_u16(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR) of a uint16
    [h, w] or [h, w, c] image, in numpy: OpenCV's 16U path computes in
    float32 (resize_linear_f32's two passes) and rounds half to even with
    saturation.  An unchanged size is a copy.  OpenCV's vector code may sum
    a pixel on a rounding tie in another order, so such a pixel can land one
    level off its result."""
    if tuple(img.shape[:2]) == (int(size[0]), int(size[1])):
        return img.copy()
    out = resize_linear_f32(img, size)
    return np.clip(np.rint(out), 0, 65535).astype(np.uint16)


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] INTER_AREA weights (cv2 computeResizeAreaTab): pixel d
    covers [d·s, (d+1)·s) with s = src / dst, each source pixel weighted by
    its overlap over the footprint's width."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = (s1 - f1) / cell
        w[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return w


def resize_area(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """[..., h, w] -> [..., H, W] with H <= h and W <= w, cv2.INTER_AREA
    semantics; uint8 in, uint8 out (rounded), else float32."""
    size = (int(size[0]), int(size[1]))
    h, w = x.shape[-2:]
    if size[0] > h or size[1] > w:
        raise ValueError(f"resize_area shrinks only: {(h, w)} -> {size}")
    wy = torch.from_numpy(_area_weights(h, size[0])).to(x.device)
    wx = torch.from_numpy(_area_weights(w, size[1])).to(x.device)
    out = wy @ x.double() @ wx.T
    if x.dtype != torch.uint8:
        return out.float()
    if (h, w) == (2 * size[0], 2 * size[1]):
        out = torch.floor(out + 0.5)     # cv2's 2x2 path: (sum + 2) >> 2
    return torch.round(out).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Train-time crop-and-resize and augmentation (port of
# boxsegliver_tpu/ops/image_ops.py:59-149,177-189), batched.  The random
# functions take their draws as tensors; ``draw_augment`` fills them from a
# torch.Generator, and the tests inject JAX's draws instead.
# ---------------------------------------------------------------------------

def _grid_1d(out_size: int, crop_size: torch.Tensor,
             crop_start: torch.Tensor) -> torch.Tensor:
    """[bs] crop sizes / origins -> [bs, out_size] sampling coordinates on
    the half-pixel grid (jax.image.resize 'linear' convention)."""
    scale = crop_size.float()[:, None] / out_size
    dst = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    return (dst[None] + 0.5) * scale - 0.5 + crop_start.float()[:, None]


def _gather_rows_cols(x: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor) -> torch.Tensor:
    """x [bs, h, w, ...] -> x[b, rows[b]][:, cols[b]] as [bs, oh, ow, ...]."""
    tail = x.shape[3:]
    ones = (1,) * len(tail)
    ri = rows.reshape(rows.shape + (1,) + ones).expand(
        rows.shape + (x.shape[2],) + tail)
    top = torch.gather(x, 1, ri)
    ci = cols.reshape((cols.shape[0], 1, cols.shape[1]) + ones).expand(
        (cols.shape[0], rows.shape[1], cols.shape[1]) + tail)
    return torch.gather(top, 2, ci)


def crop_and_resize_2d(image: torch.Tensor, label: Optional[torch.Tensor],
                       y0: torch.Tensor, x0: torch.Tensor,
                       crop_h: torch.Tensor, crop_w: torch.Tensor,
                       out_h: int, out_w: int):
    """Bilinear resize of each sample's crop window [y0, y0 + crop_h) x
    [x0, x0 + crop_w) of image [bs, H, W, C] float32 to [bs, out_h, out_w,
    C], edge-clamped; label [bs, H, W] by nearest sampling with
    round-half-even, as the JAX package samples it."""
    ys = _grid_1d(out_h, crop_h, y0)
    xs = _grid_1d(out_w, crop_w, x0)
    h, w = image.shape[1], image.shape[2]
    fy0 = torch.clamp(torch.floor(ys), 0, h - 1)
    fx0 = torch.clamp(torch.floor(xs), 0, w - 1)
    fy1 = torch.clamp(fy0 + 1, 0, h - 1)
    fx1 = torch.clamp(fx0 + 1, 0, w - 1)
    wy = torch.clamp(ys - fy0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - fx0, 0.0, 1.0)[:, None, :, None]
    y0i, y1i = fy0.long(), fy1.long()
    x0i, x1i = fx0.long(), fx1.long()
    tl = _gather_rows_cols(image, y0i, x0i)
    tr = _gather_rows_cols(image, y0i, x1i)
    bl = _gather_rows_cols(image, y1i, x0i)
    br = _gather_rows_cols(image, y1i, x1i)
    out = (tl * (1 - wy) * (1 - wx) + tr * (1 - wy) * wx
           + bl * wy * (1 - wx) + br * wy * wx)
    if label is None:
        return out, None
    yi = torch.clamp(torch.round(ys), 0, h - 1).long()
    xi = torch.clamp(torch.round(xs), 0, w - 1).long()
    return out, _gather_rows_cols(label, yi, xi)


def random_noise(image: torch.Tensor, scale: float,
                 uniform: torch.Tensor) -> torch.Tensor:
    """image + uniform·|scale| with ``uniform`` drawn in [-1, 1) of the
    image's shape (reference image_ops.py:209-238)."""
    return image + uniform * abs(scale)


def random_flip(image: torch.Tensor, label: torch.Tensor, coins: torch.Tensor,
                flip: int = 1):
    """Per-sample flips of image [bs, h, w, c] and label [bs, h, w]: bit 1
    flips the width axis where coins[:, 0] >= 0.5, bit 2 the height axis
    where coins[:, 1] >= 0.5 (reference image_ops.py:241-315)."""
    for bit, col, img_axis in ((1, 0, 2), (2, 1, 1)):
        if flip & bit:
            c = coins[:, col] >= 0.5
            image = torch.where(c[:, None, None, None],
                                image.flip(img_axis), image)
            label = torch.where(c[:, None, None], label.flip(img_axis),
                                label)
    return image, label


def zscore(img: torch.Tensor) -> torch.Tensor:
    """Per-sample z-score over the non-zero region of img [bs, ...]
    (reference image_ops.py:25-32): (x − region·mean) / (region·std +
    1e-8), so pixels outside the region stay exactly 0."""
    dims = tuple(range(1, img.ndim))
    region = (img > 0).float()
    cnt = torch.clamp_min(region.sum(dim=dims, keepdim=True), 1.0)
    mean = (img * region).sum(dim=dims, keepdim=True) / cnt
    var = (torch.square(img - mean) * region).sum(dim=dims, keepdim=True) / cnt
    return (img - region * mean) / (region * torch.sqrt(var) + 1e-8)


def augment_gamma(image: torch.Tensor, gamma_range: Sequence[float],
                  draws: torch.Tensor, retain_stats: bool = False,
                  p_per_sample: float = 1.0,
                  epsilon: float = 1e-7) -> torch.Tensor:
    """Per-sample gamma augmentation of image [bs, ...] (reference
    image_ops.py:339-354).  draws [bs, 3] in [0, 1): where draws[:, 0] <
    p_per_sample, gamma = lo + draws[:, 1]·(1 − lo), else 1 + draws[:, 2]·
    (hi − 1).  retain_stats restores each sample's mean and (population)
    standard deviation."""
    dims = tuple(range(1, image.ndim))
    shape = (-1,) + (1,) * (image.ndim - 1)
    # the spans in float32 on the host, as jax.random.uniform forms them;
    # no tensor is made here, so the function runs inside a CUDA graph
    lo, hi, one = (np.float32(v) for v in tuple(gamma_range) + (1.0,))
    draws = draws.float()
    g_lo = torch.clamp_min(draws[:, 1] * float(one - lo) + float(lo),
                           float(lo))
    g_hi = torch.clamp_min(draws[:, 2] * float(hi - one) + 1.0, 1.0)
    gamma = torch.where(draws[:, 0] < p_per_sample, g_lo, g_hi).view(shape)
    if retain_stats:
        mn = image.mean(dim=dims, keepdim=True)
        sd = image.std(dim=dims, keepdim=True, unbiased=False)
    minm = image.amin(dim=dims, keepdim=True)
    rnge = image.amax(dim=dims, keepdim=True) - minm
    out = torch.pow((image - minm) / (rnge + epsilon), gamma) * rnge + minm
    if retain_stats:
        new_mn = out.mean(dim=dims, keepdim=True)
        new_sd = out.std(dim=dims, keepdim=True, unbiased=False)
        out = (out - new_mn + mn) / (new_sd + 1e-8) * sd
    return out


def draw_augment(generator: torch.Generator, shape: Sequence[int],
                 noise: bool, device, gamma: bool = False) -> dict:
    """The draws of one batch's augmentation from ``generator`` (on
    ``device``): ``noise`` uniform in [-1, 1) of the image shape
    [bs, h, w, c] (when noise is on), ``flip`` coins [bs, 3] in [0, 1) and,
    with ``gamma``, augment_gamma's [bs, 3] uniforms in [0, 1)."""
    out = {"flip": torch.rand((shape[0], 3), generator=generator,
                              device=device)}
    if noise:
        out["noise"] = torch.rand(tuple(shape), generator=generator,
                                  device=device) * 2.0 - 1.0
    if gamma:
        out["gamma"] = torch.rand((shape[0], 3), generator=generator,
                                  device=device)
    return out


# ---------------------------------------------------------------------------
# Boundary loss weights (port of boxsegliver_tpu/ops/image_ops.py:218-288)
# ---------------------------------------------------------------------------

def binary_dilation2d(x: torch.Tensor, connection: int = 1,
                      iterations: int = 1) -> torch.Tensor:
    """Binary dilation of non-negative [..., h, w] float arrays with zero
    padding (reference image_ops.py:357-393): connection=1 → cross
    structuring element, connection=2 → full 3x3.  The 3x3 case is a
    stride-1 max pool: its -inf padding equals zero padding on values >= 0,
    the centre being in every window."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    flat = x.reshape((-1, 1, h, w))
    for _ in range(iterations):
        if connection == 2:
            flat = F.max_pool2d(flat, 3, stride=1, padding=1)
        else:
            pad = F.pad(flat, (1, 1, 1, 1))
            flat = torch.stack([flat, pad[..., :-2, 1:-1], pad[..., 2:, 1:-1],
                                pad[..., 1:-1, :-2],
                                pad[..., 1:-1, 2:]]).amax(dim=0)
    return flat.reshape(lead + (h, w))


def _minplus_scan(dist: torch.Tensor, axis: int) -> torch.Tensor:
    """d[i] = min_k d0[k] + |i − k| along ``axis``: JAX's forward and
    backward lax.scan of min(row, carry + 1) in closed form, a forward
    cummin(d0 − i) + i, then the same on the flipped result.  Exact in
    float32 while the distances stay below 2**24."""
    dist = dist.movedim(axis, -1)
    idx = torch.arange(dist.shape[-1], dtype=dist.dtype, device=dist.device)
    fwd = torch.cummin(dist - idx, dim=-1).values + idx
    bwd = torch.cummin((fwd + idx).flip(-1), dim=-1).values.flip(-1) - idx
    return bwd.movedim(-1, axis)


def distance_transform_cityblock(mask: torch.Tensor,
                                 axes: Optional[Sequence[int]] = None
                                 ) -> torch.Tensor:
    """City-block (L1) distance to the nearest zero of ``mask`` over
    ``axes`` (default: all), float32; with no zero the distance is the
    mask's element count over those axes (JAX's ``big``)."""
    axes = list(range(mask.ndim) if axes is None else axes)
    big = float(np.prod([mask.shape[a] for a in axes]))
    dist = torch.where(mask > 0, big, 0.0).float()
    for ax in axes:
        dist = _minplus_scan(dist, ax)
    return dist
