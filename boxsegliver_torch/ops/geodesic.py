"""2-D geodesic distance as a raster scan in plain PyTorch (port of
boxsegliver_tpu/ops/geodesic.py:39-120; host twin
csrc/boxseg_native.cpp::geodesic2d_raster_scan), batched over leading dims.

Each raster pass factors into rows: row y reads only the final row y-1
through its three upper neighbours, and within a row
``d[x] = min(c[x], d[x-1] + w[x])`` is a min-plus affine recurrence whose
maps compose associatively, ``combine(a, b) = (w_a + w_b, min(c_b, c_a +
w_b))``, so a row solves in log2(w) doubling steps.  The backward pass is
the forward pass on the doubly flipped arrays.  Float rounding differs from
the C++ scan only where the min-plus sums reassociate (about 1e-5
relative).  Unreached pixels hold +inf (the C++ scan's FLT_MAX).

This is the plain version of kernel G1 (csrc/geodesic.cu,
ops/kernels.geodesic2d_batch), which runs the same recurrence on the card.
"""

from __future__ import annotations

import torch

_INF = float("inf")


def _step(l2: float, dI: torch.Tensor, lamb: float) -> torch.Tensor:
    # csrc: sqrt((1-lamb)*local^2 + lamb*dI^2)
    return torch.sqrt((1.0 - lamb) * l2 + lamb * dI * dI)


def _shift_x(row: torch.Tensor, dx: int, fill: float) -> torch.Tensor:
    """row[..., x + dx] at position x; out of range -> fill."""
    pad = torch.full(row.shape[:-1] + (abs(dx),), fill, dtype=row.dtype,
                     device=row.device)
    if dx > 0:
        return torch.cat([row[..., dx:], pad], dim=-1)
    return torch.cat([pad, row[..., :dx]], dim=-1)


def _minplus_row(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Solve d[x] = min(c[x], d[x-1] + w[x]) along the last axis by
    doubling (w[..., 0] is +inf: x = 0 has no left neighbour)."""
    n = c.shape[-1]
    k = 1
    while k < n:
        c = torch.cat([c[..., :k], torch.minimum(c[..., k:],
                                                 c[..., :-k] + w[..., k:])],
                      dim=-1)
        w = torch.cat([w[..., :k], w[..., :-k] + w[..., k:]], dim=-1)
        k *= 2
    return c


def _forward_pass(img: torch.Tensor, dist: torch.Tensor,
                  lamb: float) -> torch.Tensor:
    """One causal raster pass over [B, h, w]: top-left -> bottom-right."""
    w_in = _step(1.0, img - _shift_x(img, -1, 0.0), lamb)
    w_in[..., 0] = _INF
    rows = []
    prev = None
    for y in range(img.shape[-2]):
        c = dist[:, y]
        if prev is not None:
            i_row, i_up = img[:, y], img[:, y - 1]
            for dx, l2 in ((-1, 2.0), (0, 1.0), (1, 2.0)):
                nd = prev if dx == 0 else _shift_x(prev, dx, _INF)
                ni = i_up if dx == 0 else _shift_x(i_up, dx, 0.0)
                c = torch.minimum(c, nd + _step(l2, i_row - ni, lamb))
        prev = _minplus_row(c, w_in[:, y])
        rows.append(prev)
    return torch.stack(rows, dim=1)


def geodesic2d(img: torch.Tensor, seeds: torch.Tensor, lamb: float = 1.0,
               iterations: int = 4) -> torch.Tensor:
    """Geodesic distance from the nonzero pixels of ``seeds`` over images
    [..., h, w] (float32 out, +inf where no seed is reached): the C++
    scan's neighbour geometry, pass order and iteration count."""
    shape = img.shape
    img = img.float().reshape((-1,) + tuple(shape[-2:]))
    dist = torch.where(seeds.reshape(img.shape).bool(), 0.0, _INF)
    img_r = img.flip(-2, -1)
    for _ in range(int(iterations)):
        dist = _forward_pass(img, dist, float(lamb))
        dist = _forward_pass(img_r, dist.flip(-2, -1),
                             float(lamb)).flip(-2, -1)
    return dist.reshape(shape)


def geodesic_guide(img: torch.Tensor, seeds: torch.Tensor, lamb: float = 1.0,
                   iterations: int = 4, scale: float = 10.0) -> torch.Tensor:
    """exp(-geodesic / scale) click guide; seedless maps render zeros."""
    dist = geodesic2d(img, seeds, lamb, iterations)
    out = torch.exp(-dist / max(scale, 1e-6))
    return torch.where(torch.isfinite(dist), out, 0.0)
