"""Connected-component labeling, the interactive eval's click placement,
per-object robust moments and the Wu-line ascent test on tensors (port of
boxsegliver_tpu/ops/labeling.py:66-177,206-299), batched over leading dims
so both sweep directions, or all slices of a case, run together.

The math is the JAX package's; the lowering is not (its forms were chosen
for the TPU):
- ``label_components``: each foreground pixel carries the raster index of
  its 4-connected component's first pixel (the order ``ndi.label`` numbers
  components), background carries h*w.  Instead of segmented associative
  scans, each pass replaces every label by the minimum over its row run and
  then its column run (a scatter-amin over run ids) until nothing changes —
  the same unique fixpoint.
- ``object_moments``: median + 1.4826 * MAD per axis from coordinate
  histograms, with the rank selection done by sort + cumsum instead of the
  [K, B, B] comparison einsum.  Exact: the values are integers and
  half-integers.
- ``wu_ascent``: the Wu-line pixel values come from a gather instead of the
  one-hot contraction.
- ``largest_error_click``: the terminal core of the cross erosion (JAX's
  data-dependent ``while_loop``) is read off the city-block distance to the
  component's complement, outside the image included: k erosions keep the
  pixels farther than k, so the last non-empty one keeps those at the
  largest distance.  No loop, no host read.  The volume forms
  ``label_components_3d`` and ``largest_error_click_3d`` add the run
  minimum along the depth axis and the 3-D city-block core.
Integer results equal the JAX package's (tests/test_torch_labeling.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boxsegliver_torch.ops.image_ops import distance_transform_cityblock

_MAD_TO_STD = 1.4826  # array_kits._MAD_TO_STD (reference utils/array_kits.py)


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------

def _run_min(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each element becomes the min over its contiguous run of True along
    the last axis (background elements are runs of their own)."""
    rows, length = labels.shape[0], labels.shape[1]
    bg = ~mask
    starts = bg | F.pad(bg[:, :-1], (1, 0), value=True)
    seg = torch.cumsum(starts, dim=1) + (
        torch.arange(rows, device=labels.device)[:, None] * (length + 1))
    seg = seg.reshape(-1)
    mins = torch.full((rows * (length + 1) + 1,), torch.iinfo(labels.dtype).max,
                      dtype=labels.dtype, device=labels.device)
    mins.scatter_reduce_(0, seg, labels.reshape(-1), "amin")
    return mins[seg].reshape(rows, length)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """4-connectivity (ndi connectivity=1) components of bool masks
    [..., h, w].  Returns int32 labels: the raster index (within each
    image) of the component's first pixel, h*w on background."""
    h, w = mask.shape[-2:]
    m = mask.reshape(-1, h, w)
    b = m.shape[0]
    sentinel = h * w
    lin = torch.arange(h * w, device=mask.device).reshape(1, h, w)
    labels = torch.where(m, lin, sentinel).to(torch.int64)
    mt = m.transpose(1, 2).reshape(-1, h)
    m = m.reshape(-1, w)
    while True:
        new = _run_min(labels.reshape(-1, w), m).reshape(b, h, w)
        new = _run_min(new.transpose(1, 2).reshape(-1, h), mt)
        new = new.reshape(b, w, h).transpose(1, 2)
        if torch.equal(new, labels):
            break
        labels = new
    return labels.to(torch.int32).reshape(mask.shape)


def ordered_seeds(labels: torch.Tensor, max_objects: int):
    """First-raster-pixel seeds of each component in ``ndi.label`` order.

    labels: [..., h, w] from ``label_components``.  Returns (seeds
    [..., K] int32 ascending, padded with h*w; n_objects [...] int32 — ALL
    components, so callers can detect overflow against K)."""
    h, w = labels.shape[-2:]
    sentinel = h * w
    flat = labels.reshape(labels.shape[:-2] + (h * w,))
    lin = torch.arange(h * w, dtype=flat.dtype, device=flat.device)
    is_seed = (flat == lin) & (flat != sentinel)
    vals = torch.where(is_seed, lin, sentinel)
    seeds = torch.topk(vals, max_objects, dim=-1, largest=False,
                       sorted=True).values
    return seeds.to(torch.int32), is_seed.sum(dim=-1).to(torch.int32)


def largest_error_click(pred: torch.Tensor, label: torch.Tensor):
    """``interactive.clicks.next_click_from_error`` for slices [..., h, w]
    at once (JAX ops/labeling.largest_error_click, 2-D).

    pred / label: bool.  Returns (coords [..., 2] int64, is_fg [...] bool,
    has_error [...] bool); coords mean something only where has_error.
    The largest 4-connected error component (the first in raster order on a
    tie), eroded with a cross and a zero border to its terminal non-empty
    core, its float32 center of mass rounded half to even — or, when that
    misses the component, the core's middle raster pixel."""
    lead, (h, w) = pred.shape[:-2], pred.shape[-2:]
    p = pred.reshape(-1, h, w).bool()
    lab = label.reshape(-1, h, w).bool()
    b = p.shape[0]
    error = p ^ lab
    has_error = error.reshape(b, -1).any(dim=1)
    labels = label_components(error).reshape(b, -1).long()
    sizes = torch.zeros((b, h * w + 1), dtype=torch.int64, device=p.device)
    sizes.scatter_add_(1, labels, torch.ones_like(labels))
    largest = torch.argmax(sizes[:, :-1], dim=1)
    comp = (labels == largest[:, None]).reshape(b, h, w)
    # terminal erosion core = the pixels at the largest city-block distance
    # to the complement (outside the image counts as complement)
    dist = distance_transform_cityblock(F.pad(comp, (1, 1, 1, 1)),
                                        axes=(1, 2))[:, 1:-1, 1:-1]
    dist = torch.where(comp, dist, 0.0)
    core = comp & (dist == dist.reshape(b, -1).amax(dim=1)[:, None, None])
    cf = core.float()
    n_core = core.reshape(b, -1).sum(dim=1)
    n = torch.clamp_min(n_core, 1).float()
    iy = torch.arange(h, dtype=torch.float32, device=p.device)
    ix = torch.arange(w, dtype=torch.float32, device=p.device)
    cy = torch.round((cf * iy[:, None]).sum(dim=(1, 2)) / n).long()
    cx = torch.round((cf * ix[None, :]).sum(dim=(1, 2)) / n).long()
    cy = cy.clamp(0, h - 1)
    cx = cx.clamp(0, w - 1)
    flat = comp.reshape(b, -1)
    on_comp = torch.gather(flat, 1, (cy * w + cx)[:, None])[:, 0]
    # fallback: the core's middle raster pixel (host: pts[len(pts) // 2])
    cum = torch.cumsum(core.reshape(b, -1).to(torch.int32), dim=1)
    mid = torch.argmax((cum > (n_core // 2)[:, None]).to(torch.uint8), dim=1)
    cy = torch.where(on_comp, cy, mid // w)
    cx = torch.where(on_comp, cx, mid % w)
    is_fg = torch.gather(lab.reshape(b, -1), 1, (cy * w + cx)[:, None])[:, 0]
    coords = torch.stack([cy, cx], dim=-1)
    return (coords.reshape(lead + (2,)), is_fg.reshape(lead),
            has_error.reshape(lead))


def label_components_3d(mask: torch.Tensor) -> torch.Tensor:
    """6-connectivity (ndi connectivity=1) components of bool volumes
    [..., d, h, w]: each pass takes the run minimum along the width, the
    height and the depth axis, until nothing changes (the fixpoint, however
    twisted the component; one host read a pass).  Returns int32 labels:
    the raster index (within each volume) of the component's first voxel,
    d*h*w on background."""
    shape = mask.shape[-3:]
    size = shape[0] * shape[1] * shape[2]
    m = mask.reshape((-1,) + shape)
    lin = torch.arange(size, device=mask.device).reshape((1,) + shape)
    labels = torch.where(m, lin, size).to(torch.int64)
    # each axis moved last and its runs flattened to rows, once
    masks = [m.movedim(ax, -1).reshape(-1, shape[ax - 1])
             for ax in (3, 2, 1)]
    while True:
        new = labels
        for ax, mt in zip((3, 2, 1), masks):
            moved = new.movedim(ax, -1)
            new = _run_min(moved.reshape(-1, shape[ax - 1]), mt).reshape(
                moved.shape).movedim(-1, ax)
        if torch.equal(new, labels):
            break
        labels = new
    return labels.to(torch.int32).reshape(mask.shape)


def largest_error_click_3d(pred: torch.Tensor, label: torch.Tensor):
    """``interactive.clicks.next_click_from_error`` for volumes [..., d, h,
    w] (JAX ops/labeling.largest_error_click at rank 3).

    pred / label: bool.  Returns (coords [..., 3] int64 (z, y, x), is_fg
    [...] bool, has_error [...] bool); coords mean something only where
    has_error.  The largest 6-connected error component (the first in
    raster order on a tie), eroded with the 3-D cross and a zero border to
    its terminal non-empty core — the voxels at the largest city-block
    distance to the complement, outside the volume included —, its float32
    center of mass rounded half to even, or, when that misses the
    component, the core's middle raster voxel."""
    lead, shape = pred.shape[:-3], tuple(pred.shape[-3:])
    size = shape[0] * shape[1] * shape[2]
    p = pred.reshape((-1,) + shape).bool()
    lab = label.reshape((-1,) + shape).bool()
    b = p.shape[0]
    error = p ^ lab
    has_error = error.reshape(b, -1).any(dim=1)
    labels = label_components_3d(error).reshape(b, -1).long()
    sizes = torch.zeros((b, size + 1), dtype=torch.int64, device=p.device)
    sizes.scatter_add_(1, labels, torch.ones_like(labels))
    largest = torch.argmax(sizes[:, :-1], dim=1)
    comp = (labels == largest[:, None]).reshape((b,) + shape)
    dist = distance_transform_cityblock(F.pad(comp, (1, 1, 1, 1, 1, 1)),
                                        axes=(1, 2, 3))[:, 1:-1, 1:-1, 1:-1]
    dist = torch.where(comp, dist, 0.0)
    core = comp & (dist == dist.reshape(b, -1).amax(dim=1).view(b, 1, 1, 1))
    cf = core.float()
    n_core = core.reshape(b, -1).sum(dim=1)
    n = torch.clamp_min(n_core, 1).float()
    com = []
    for ax in range(3):
        iota = torch.arange(shape[ax], dtype=torch.float32,
                            device=p.device).reshape(
            tuple(shape[ax] if a == ax else 1 for a in range(3)))
        c = torch.round((cf * iota).sum(dim=(1, 2, 3)) / n).long()
        com.append(c.clamp(0, shape[ax] - 1))
    strides = (shape[1] * shape[2], shape[2], 1)
    flat_idx = sum(c * st for c, st in zip(com, strides))
    on_comp = torch.gather(comp.reshape(b, -1), 1, flat_idx[:, None])[:, 0]
    # fallback: the core's middle raster voxel (host: pts[len(pts) // 2])
    cum = torch.cumsum(core.reshape(b, -1).to(torch.int32), dim=1)
    mid = torch.argmax((cum > (n_core // 2)[:, None]).to(torch.uint8), dim=1)
    mid_c = (mid // strides[0], mid // strides[1] % shape[1], mid % shape[2])
    coords = torch.stack([torch.where(on_comp, c, m)
                          for c, m in zip(com, mid_c)], dim=-1)
    idx = (coords * torch.tensor(strides, device=p.device)).sum(dim=-1)
    is_fg = torch.gather(lab.reshape(b, -1), 1, idx[:, None])[:, 0]
    return (coords.reshape(lead + (3,)), is_fg.reshape(lead),
            has_error.reshape(lead))


# ---------------------------------------------------------------------------
# per-object robust moments (median + MAD) from coordinate histograms
# ---------------------------------------------------------------------------

def _select_by_rank(vals: torch.Tensor, counts: torch.Tensor,
                    rank: torch.Tensor, presorted: bool = False):
    """Smallest v of the multiset {vals[y] x counts[y]} whose count of
    elements <= v exceeds ``rank`` (per leading index)."""
    if not presorted:
        order = torch.argsort(vals, dim=-1, stable=True)
        vals = torch.gather(vals, -1, order)
        counts = torch.gather(counts, -1, order)
    cum = torch.cumsum(counts, dim=-1)
    idx = torch.argmax((cum > rank[..., None]).to(torch.uint8), dim=-1,
                       keepdim=True)
    return torch.gather(vals, -1, idx)[..., 0]


def _axis_median_mad(counts: torch.Tensor, n: torch.Tensor):
    """counts: [..., B] pixel counts per integer coordinate; n: [...] totals.
    Returns (median, mad) with numpy's even-count averaging."""
    b = counts.shape[-1]
    coords = torch.arange(b, dtype=torch.float32,
                          device=counts.device).expand(counts.shape)
    r1 = torch.clamp_min(torch.div(n - 1, 2, rounding_mode="floor"), 0)
    r2 = torch.div(n, 2, rounding_mode="floor")
    med = (_select_by_rank(coords, counts, r1, presorted=True)
           + _select_by_rank(coords, counts, r2, presorted=True)) / 2.0
    dev = torch.abs(coords - med[..., None])
    mad = (_select_by_rank(dev, counts, r1)
           + _select_by_rank(dev, counts, r2)) / 2.0
    return med, mad


def object_moments(obj_masks: torch.Tensor, min_std: float = 0.0):
    """Robust moments of binary objects [..., K, h, w] at once.

    Returns (centers [..., K, 2] float32 ij, stds [..., K, 2] float32)
    matching ``array_kits.compute_robust_moments(indexing="ij")`` per object;
    empty objects give (-1, -1) rows."""
    m = obj_masks.to(torch.int32)
    rowc = m.sum(dim=-1)                                    # [..., K, h]
    colc = m.sum(dim=-2)                                    # [..., K, w]
    n = rowc.sum(dim=-1)
    cy, mad_y = _axis_median_mad(rowc, n)
    cx, mad_x = _axis_median_mad(colc, n)
    center = torch.stack([cy, cx], dim=-1)
    std = torch.clamp_min(_MAD_TO_STD * torch.stack([mad_y, mad_x], dim=-1),
                          float(min_std))
    empty = (n == 0)[..., None]
    center = torch.where(empty, -1.0, center)
    std = torch.where(empty, -1.0, std)
    return center, std


# ---------------------------------------------------------------------------
# Xiaolin-Wu monotone-ascent line test
# ---------------------------------------------------------------------------

def wu_ascent(img: torch.Tensor, peaks: torch.Tensor,
              centers: torch.Tensor) -> torch.Tensor:
    """``array_kits.ascent_line`` of every peak against every center.

    img: [..., h, w] float; peaks: [..., P, 2] int (ij); centers:
    [..., M, 2] int (ij), leading dims equal.  Returns [..., P, M] bool:
    True when img is monotonically non-decreasing along the Wu-line pixel
    chain from peak to center, and True where center == peak.  As in the
    JAX package the line's minor coordinate is evaluated in closed form in
    float32 (the host accumulates it in float64), with exact end points.
    """
    h, w = img.shape[-2:]
    length = max(h, w)
    lead = img.shape[:-2]
    peaks = peaks.to(torch.int64)
    centers = centers.to(torch.int64)
    py, px = peaks[..., :, None, 0], peaks[..., :, None, 1]       # [.., P, 1]
    cy, cx = centers[..., None, :, 0], centers[..., None, :, 1]   # [.., 1, M]

    # host arg order: (x0, y0) = peak in xy, (x1, y1) = center in xy
    steep = torch.abs(cy - py) > torch.abs(cx - px)
    a0 = torch.where(steep, py, px)
    b0 = torch.where(steep, px, py)
    a1 = torch.where(steep, cy, cx)
    b1 = torch.where(steep, cx, cy)
    fwd = a0 <= a1                       # host flips so the low-a end leads
    la0 = torch.where(fwd, a0, a1)
    lb0 = torch.where(fwd, b0, b1)
    la1 = torch.where(fwd, a1, a0)
    lb1 = torch.where(fwd, b1, b0)
    da = la1 - la0
    grad = torch.where(da > 0, (lb1 - lb0).float()
                       / torch.clamp_min(da, 1).float(), 1.0)

    # the line visits each absolute major-axis position a at most once, at
    # minor coordinate b(a) = floor(lb0 + grad * (a - la0))
    a = torch.arange(length, device=img.device)                    # [L]
    t = a - la0[..., None]                                         # [.., P, M, L]
    bvals = torch.floor(lb0[..., None].float()
                        + grad[..., None] * t.float()).to(torch.int64)
    bvals = torch.where(t == 0, lb0[..., None], bvals)
    bvals = torch.where(t == da[..., None], lb1[..., None], bvals)
    st = steep[..., None]
    bvals = torch.minimum(torch.clamp_min(bvals, 0),
                          torch.where(st, w - 1, h - 1))
    row = torch.where(st, a.clamp(max=h - 1), bvals)
    col = torch.where(st, bvals, a.clamp(max=w - 1))
    # positions past the image edge read 0, as the JAX package's padding does
    inside = torch.where(st, a < h, a < w)
    flat = img.reshape(lead + (h * w,))
    idx = (row * w + col).reshape(lead + (-1,))
    v = torch.gather(flat, -1, idx).reshape(row.shape)
    v = torch.where(inside, v, 0.0)

    pair_ok = (t[..., :-1] >= 0) & (t[..., 1:] <= da[..., None])
    diff = v[..., 1:] - v[..., :-1]
    asc = torch.all(torch.where(pair_ok, diff >= 0, True), dim=-1)
    desc = torch.all(torch.where(pair_ok, diff <= 0, True), dim=-1)
    ok = torch.where(fwd, asc, desc)     # traversal runs peak -> center
    same = (cy == py) & (cx == px)
    return torch.where(same, True, ok)
