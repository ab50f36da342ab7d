"""Spatial-guide rendering in plain torch (port of
boxsegliver_tpu/ops/guides.py:19-86,97-99,111-142; reference
utils/image_ops.py:396-434, utils/array_kits.py:387-440).

Ragged per-slice object lists are padded to a static count and masked;
padding rows use center = stddev = -1 as in the reference.  The batched,
fused render that the guided sweep runs every step is kernel B1
(ops/kernels.gaussian_guide_batch).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# Guide images of empty slices are all-background. The guided pipelines remap
# guides into [0.5, 1] with background 0.5 (reference input_pipeline_g.py:382-394).
GUIDE_BG = 0.5


def _coord_grid(shape: Sequence[int], device=None) -> torch.Tensor:
    """Stack of index coordinates, shape [*shape, ndim]."""
    coords = [torch.arange(s, dtype=torch.float32, device=device)
              for s in shape]
    return torch.stack(torch.meshgrid(*coords, indexing="ij"), dim=-1)


def gaussian_guide(shape: Sequence[int], centers: torch.Tensor,
                   stddevs: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   keepdims: bool = True) -> torch.Tensor:
    """Max-over-objects Gaussian guide (ij indexing).

    centers / stddevs: [n, ndim] float; padded rows may be -1 (a valid row's
    stddev is never 0; an exact 0 is replaced by 1e-6 as in the JAX package).
    mask: optional [n] bool of valid objects; default: center[:, 0] >= 0.
    Returns [*shape, 1] (keepdims) or [*shape] in [0, 1]; all-zero when no
    object is valid.
    """
    centers = torch.as_tensor(centers, dtype=torch.float32)
    stddevs = torch.as_tensor(stddevs, dtype=torch.float32,
                              device=centers.device)
    if mask is None:
        mask = centers[:, 0] >= 0.0
    ndim = len(shape)
    if centers.shape[0] == 0:
        out = torch.zeros(tuple(shape), device=centers.device)
    else:
        coords = _coord_grid(shape, centers.device)
        c = centers.reshape((-1,) + (1,) * ndim + (ndim,))
        s = stddevs.reshape((-1,) + (1,) * ndim + (ndim,))
        s = torch.where(s == 0.0, torch.full_like(s, 1e-6), s)
        normalizer = 2.0 * s * s
        d = torch.exp(-torch.sum((coords[None] - c) ** 2 / normalizer, dim=-1))
        d = torch.where(mask.reshape((-1,) + (1,) * ndim).to(d.device), d, 0.0)
        out = d.amax(dim=0)
    out = torch.clamp(out, 0.0, 1.0)
    return out[..., None] if keepdims else out


def euclidean_guide(shape: Sequence[int], centers: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, keepdims: bool = True,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Min-over-objects Euclidean distance map (reference
    image_ops.py:427-429), batched over the leading axes of ``centers``.

    centers: [*B, n, ndim] (ij); mask: [*B, n] bool of valid objects,
    default center[..., 0] >= 0; weights: optional [*B, ndim] per-axis
    multipliers of the coordinate differences (the click guides' crop /
    target rescale: the distances come out in crop pixels, as the reference
    renders them at crop resolution).  Returns [*B, *shape, 1] (keepdims) or
    [*B, *shape]; where no object is valid, sum(s² for s in shape)."""
    centers = torch.as_tensor(centers, dtype=torch.float32)
    if mask is None:
        mask = centers[..., 0] >= 0.0
    ndim = len(shape)
    lead = centers.shape[:-1]                            # [*B, n]
    d2 = 0.0
    for ax, size in enumerate(shape):
        coord = torch.arange(size, dtype=torch.float32, device=centers.device)
        diff = coord - centers[..., ax, None]            # [*B, n, size]
        if weights is not None:
            diff = diff * weights[..., None, ax, None].to(diff)
        view = lead + tuple(size if a == ax else 1 for a in range(ndim))
        d2 = d2 + (diff * diff).reshape(view)
    d = torch.sqrt(d2)
    big = float(sum(s ** 2 for s in shape))
    d = torch.where(mask.reshape(lead + (1,) * ndim).to(d.device), d, big)
    out = d.amin(dim=len(lead) - 1)
    return out[..., None] if keepdims else out


def to_guided_range(guide: torch.Tensor, background: float = GUIDE_BG):
    """Remap a [0,1] guide to [background, 1] (reference input_pipeline_g.py:382-394)."""
    return guide * (1.0 - background) + background


def moments_from_mask(binary: torch.Tensor, min_std: float = 0.0):
    """Robust moments of one binary object of any rank: median center and
    1.4826 * MAD stddev per axis (ij), (-1, ...) vectors when empty (JAX
    ops/guides.moments_from_mask: medians by sorting the masked
    coordinates, the unselected pushed to 1e9)."""
    ndim = binary.ndim
    coords = _coord_grid(binary.shape, binary.device).reshape(-1, ndim)
    mask = binary.reshape(-1) > 0
    n = int(mask.sum())
    lo, hi = max((n - 1) // 2, 0), n // 2

    def masked_median(vals):
        v = torch.sort(torch.where(mask, vals, 1e9)).values
        return (v[lo] + v[hi]) / 2.0

    center = torch.stack([masked_median(coords[:, d]) for d in range(ndim)])
    diff = torch.abs(coords - center)
    mad = torch.stack([masked_median(diff[:, d]) for d in range(ndim)])
    std = torch.clamp_min(1.4826 * mad, float(min_std))
    if n == 0:
        center = -torch.ones(ndim, device=binary.device)
        std = -torch.ones(ndim, device=binary.device)
    return center, std
