"""Host-side numpy/scipy array utilities (own copy of the subset of
boxsegliver_tpu/ops/array_kits.py that metadata extraction and volume eval
need; semantics of reference utils/array_kits.py).

Citations are reference utils/array_kits.py lines:
- zscore                           :31-40 (the click eval's per-stack norm)
- bbox_from_mask                   :85-232
- extract_region                   :263-329
- get_largest_component            :357-384
- compute_robust_moments           :387-440
- create_gaussian_distribution_v2  :452-486 (the numpy render that kernel
  B1 replaces in the host propagation loop; the tests hold B1's plain
  version against it)
- xiaolinwu_line, ascent_line      :1078-1139 (the host loop's FP filter)
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage as ndi


def zscore(img: np.ndarray) -> np.ndarray:
    """Z-score over the non-zero region (reference array_kits.py:31-40)."""
    mask = img > 0
    if not np.any(mask):
        return img.astype(np.float32)
    vals = img[mask]
    mean, std = vals.mean(), vals.std()
    out = (img - mask * mean) / (mask * std + 1e-8)
    return out.astype(np.float32)


def bbox_from_mask(mask: np.ndarray, mask_values, min_shape=None, padding=None):
    """Bounding box (x1, y1[, z1], x2, y2[, z2]) from mask (reference :85-232).

    Coordinates are in reversed-axis (x first) order and are INCLUSIVE at both
    ends (`x2 - x1 + 1` is the width).
    """
    ndim = mask.ndim
    if not np.count_nonzero(mask):
        return np.zeros(2 * ndim, np.int64)
    if min_shape is not None:
        assert len(min_shape) == ndim
    values = np.atleast_1d(mask_values)

    lo_rev, hi_rev = [], []
    for axis in range(ndim - 1, -1, -1):  # x first
        other = tuple(a for a in range(ndim) if a != axis)
        # reference semantics: a slab counts when its MAX is one of the
        # selected values (a higher label shadows lower ones, :96-99)
        hits = np.flatnonzero(np.isin(mask.max(axis=other), values))
        lo_rev.append(int(hits[0]))
        hi_rev.append(int(hits[-1]))
    bbox = np.asarray(lo_rev + hi_rev, np.int64)

    frame_rev = np.asarray(mask.shape[::-1])
    if padding is not None:
        grow = np.asarray(padding if np.ndim(padding) else [padding] * ndim)
        bbox[:ndim] = np.clip(bbox[:ndim] - grow, 0, None)
        bbox[ndim:] = np.clip(bbox[ndim:] + grow, None, frame_rev - 1)
    elif min_shape is not None:
        deficit = np.clip(np.asarray(min_shape[::-1])
                          - (bbox[ndim:] - bbox[:ndim] + 1), 0, None)
        bbox[:ndim] = np.clip(bbox[:ndim] - deficit // 2, 0, None)
        bbox[ndim:] = np.clip(bbox[ndim:] + (deficit - deficit // 2), None,
                              frame_rev - 1)
    return bbox


def extract_region(mask: np.ndarray, align=1, padding=0, min_bbox_shape=None):
    """Aligned sub-region bbox around a mask (semantics of reference
    array_kits.py:263-329): pad the tight bbox, round its extent up to the
    alignment, center the aligned window on the padded bbox, and shift it
    back inside the frame when it overflows."""
    mask = np.asarray(mask, bool)
    ndim = mask.ndim
    align = np.asarray((align,) * ndim if isinstance(align, int) else align,
                       np.int32)
    tight = bbox_from_mask(mask, mask_values=1,
                           min_shape=((1,) * ndim if min_bbox_shape is None
                                      else min_bbox_shape)[::-1])

    frame_rev = np.asarray(mask.shape[::-1])
    start = np.clip(tight[:ndim] - padding, 0, None).astype(np.int64)
    stop = np.clip(tight[ndim:] + padding, None, frame_rev - 1).astype(np.int64)

    extent = -(-(stop - start + 1) // align) * align   # round up to align
    center = (start + stop) / 2
    a1 = np.clip((center - (extent - 1) / 2).astype(np.int32), 0, None)
    a2 = np.minimum(frame_rev - 1, a1 + extent - 1)
    if ((a2 - a1 + 1) % align).any():                  # overflowed: shift back
        a1 = a2 + 1 - extent
    return np.concatenate((a1, a2))


def get_largest_component(inputs: np.ndarray, rank: int, connectivity: int = 1):
    """Largest connected component as int8 mask (reference :357-384)."""
    struct = ndi.generate_binary_structure(rank, connectivity)
    res = inputs.astype(bool)
    if np.count_nonzero(res) == 0:
        return np.zeros_like(inputs, dtype=np.int8)
    labeled_res, _ = ndi.label(res, struct)
    areas = np.bincount(labeled_res.flat)[1:]
    largest = int(np.argmax(areas)) + 1
    return (labeled_res == largest).astype(np.int8)


# MAD → stddev consistency factor for normal data (the reference hard-codes
# the same constant, :387-440); parity pinned by tests/test_golden.py.
_MAD_TO_STD = 1.4826


def compute_robust_moments(binary_image: np.ndarray, isotropic: bool = False,
                           indexing: str = "ij", min_std: float = 0.0):
    """Outlier-robust object moments: median center and MAD-derived stddev
    per axis (semantics of reference :387-440).  Empty masks yield (-1, -1)
    vectors — the padding convention the guide renderers mask out."""
    if indexing not in ("ij", "xy", "", None):
        raise ValueError("Valid values for `indexing` are 'xy' and 'ij'.")
    ndim = binary_image.ndim
    pts = np.argwhere(binary_image).astype(np.float32)      # [n, ndim], ij
    if not len(pts):
        empty = np.full(ndim, -1.0, np.float32)
        return empty, empty.copy()
    center = np.median(pts, axis=0).astype(np.float32)
    if isotropic:
        radial = np.linalg.norm(pts - center, axis=1)
        mad = np.full(ndim, np.median(radial), np.float32)
    else:
        mad = np.median(np.abs(pts - center), axis=0)
    std = np.maximum(_MAD_TO_STD * mad, min_std).astype(np.float32)
    if indexing == "ij":
        return center, std
    return center[::-1], std[::-1]                           # xy order


def _index_grid(shape, indexing: str = "ij") -> np.ndarray:
    """[*shape, ndim] stack of per-axis indices (float32)."""
    axes = [np.arange(s, dtype=np.float32) for s in shape]
    return np.stack(np.meshgrid(*axes, indexing=indexing), axis=-1)


def create_gaussian_distribution_v2(shape, centers, stddevs, indexing="ij"):
    """Multi-object map: max-over-objects Gaussian (semantics of reference
    :452-486; its Euclidean-distance variant has no caller here).
    centers/stddevs: [n, ndim] in `indexing` order."""
    centers = np.asarray(centers, np.float32)
    assert centers.ndim == 2, centers.shape
    n, ndim = centers.shape
    grid = _index_grid(shape, indexing)[None]                # [1, *shape, ndim]
    per_obj = (n,) + (1,) * ndim + (ndim,)
    diff = grid - centers.reshape(per_obj)                   # [n, *shape, ndim]
    stddevs = np.asarray(stddevs, np.float32).reshape(per_obj)
    expo = (0.5 * (diff / stddevs) ** 2).sum(axis=-1)
    return np.exp(-expo).max(axis=0)


# ---------------------------------------------------------------------------
# Guide-aware false-positive filtering (reference utils/array_kits.py:987-1139)
# ---------------------------------------------------------------------------

def xiaolinwu_line(x0: int, y0: int, x1: int, y1: int):
    """Integer pixel chain of Xiaolin Wu's line between two points
    (reference utils/array_kits.py:1078-1139; used by the guide-propagation
    monotone-ascent test).  Returns (xs, ys, forward)."""
    if x0 == x1 and y0 == y1:
        raise ValueError(f"Must be different points, got ({x0},{y0}) twice")
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    forward = True
    if x0 > x1:
        forward = False
        x0, x1 = x1, x0
        y0, y1 = y1, y0
    dx, dy = x1 - x0, y1 - y0
    gradient = dy / dx if dx else 1.0

    xs, ys = [], []

    def emit(px, py):
        if steep:
            xs.append(py)
            ys.append(px)
        else:
            xs.append(px)
            ys.append(py)

    xend = round(x0)
    yend = y0 + gradient * (xend - x0)
    emit(xend, math.floor(yend))
    intery = yend + gradient
    xend2 = round(x1)
    yend2 = y1 + gradient * (xend2 - x1)
    for x in range(round(x0) + 1, xend2):
        emit(x, math.floor(intery))
        intery += gradient
    emit(xend2, math.floor(yend2))
    return xs, ys, forward


def ascent_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> bool:
    """True when img values along the line (x0,y0)→(x1,y1) are monotonically
    non-decreasing (reference EvalImage3DLoader.ascent_line,
    input_pipeline_g.py:1498-1513)."""
    xs, ys, forward = xiaolinwu_line(x0, y0, x1, y1)
    if not forward:
        xs, ys = xs[::-1], ys[::-1]
    pre = img[ys[0], xs[0]]
    for x, y in zip(xs[1:], ys[1:]):
        cur = img[y, x]
        if cur < pre:
            return False
        pre = cur
    return True
