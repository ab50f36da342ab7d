"""Simulated user clicks for interactive segmentation training and eval
(own numpy + scipy copy of boxsegliver_tpu/interactive/clicks.py; given the
same RandomState it places the same clicks).

Re-implements the reference's interaction simulator (reference
DataLoader/NF/input_pipeline_g_simply.py:346-412 ``inter_simulation``):
foreground clicks sampled inside an eroded object core, background clicks by
strategy — whole background / band around the object / evenly-surrounding
(farthest-point) / false-positive regions — with min-distance exclusion
circles between successive clicks.  Also the click placement of the
interactive eval loop (reference entry/main_eval_3d.py:152-185: click at
the center of the largest error component, an erosion-core fallback in
place of the skeleton).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage as ndi


def erode_iterations(mask: np.ndarray, k: int, border_value: int = 0
                     ) -> np.ndarray:
    """k-iteration binary erosion with the cross structuring element as ONE
    city-block distance pass: erosion^k keeps exactly the pixels whose
    taxicab distance to the background exceeds k.  Exact equivalent of
    ``ndi.binary_erosion(mask, iterations=k, border_value=b)`` (the
    reference's inner loop, NF/input_pipeline_g_simply.py:367-372) at O(1)
    passes instead of O(k) — the click simulator's host-side hot spot
    (band width d=40 → 40 erosions per sample otherwise)."""
    if k <= 0:
        return mask.astype(bool)
    m = mask.astype(bool)
    if border_value and m.all():  # no background anywhere: identity
        return m
    # pad with the border convention so outside-the-frame pixels join the
    # distance field (cdt alone never treats the frame edge as background)
    padded = np.pad(m, 1, constant_values=bool(border_value))
    dist = ndi.distance_transform_cdt(padded, metric="taxicab")
    return dist[1:-1, 1:-1] > k


def inter_simulation(mask: np.ndarray, margin: int = 5, step: int = 10,
                     N: int = 5, bg: bool = False, d: int = 40,
                     strategy: int = 0, ret_type=np.float32,
                     neg_patch: Optional[np.ndarray] = None,
                     random: bool = True,
                     rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Sample up to N click points on a binary 2D mask.

    strategy: 0 random in whole region; 1 random in band (bg only);
    3 evenly surround (farthest-point heuristic); 4 random in `neg_patch`
    false-positive regions.  Returns [m, 2] (y, x) coordinates.
    """
    rng = rng or np.random
    small = False
    first = True
    all_pts = []
    if neg_patch is not None and strategy == 4:
        region = neg_patch.astype(bool).copy()
    else:
        region = erode_iterations(mask, margin, border_value=int(bg))
        if bg and strategy != 0:
            region = region ^ erode_iterations(region, d, border_value=int(bg))
        if not region.max():  # object too small to erode
            region = mask.astype(bool).copy()
            small = True

    height, width = mask.shape
    n_clicks = rng.randint(int(not bg), N) if random else N
    for _ in range(n_clicks):
        cy, cx = np.where(region)
        if cy.size == 0:
            break
        if not small:
            if first or strategy in (0, 1, 4):
                i = rng.choice(cy.shape[0])
            else:  # strategy 3: farthest from existing clicks
                cand = np.stack([cy, cx], axis=1).reshape(-1, 1, 2)
                prev = np.asarray(all_pts).reshape(1, -1, 2)
                i = int(np.argmax(np.sum((cand - prev) ** 2, -1).min(1)))
            cy, cx = int(cy[i]), int(cx[i])
        else:
            cy, cx = int(cy.mean()), int(cx.mean())
        first = False
        all_pts.append((cy, cx))
        # carve a `step`-radius exclusion circle
        y1, y2 = max(cy - step, 0), min(cy + step + 1, height)
        x1, x2 = max(cx - step, 0), min(cx + step + 1, width)
        yy, xx = np.meshgrid(np.arange(y1, y2), np.arange(x1, x2),
                             indexing="ij", sparse=True)
        region[y1:y2, x1:x2] &= ((xx - cx) ** 2 + (yy - cy) ** 2) > step ** 2
        if small or not region.max():
            break

    return np.asarray(all_pts, dtype=ret_type).reshape(-1, 2)


def simulate_batch_clicks(label: np.ndarray, margin: int = 3, step: int = 10,
                          N: int = 5, bg_strategy: int = 0, d: int = 40,
                          rng: Optional[np.random.RandomState] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Foreground + background clicks for one training slice (the worker-side
    step of reference gen_kernel, input_pipeline_g_simply.py:530-561)."""
    fg = inter_simulation(label > 0, margin=margin, step=step, N=N, bg=False,
                          strategy=0, rng=rng)
    bg = inter_simulation(label == 0, margin=margin, step=step, N=N, bg=True,
                          d=d, strategy=bg_strategy, rng=rng)
    return fg, bg


def next_click_from_error(pred: np.ndarray, label: np.ndarray,
                          min_size: int = 0):
    """Interactive-eval click placement: center of the largest error
    component (reference inter_simulation_test, entry/main_eval_3d.py:152-185).

    Works for 2D or 3D arrays.  Returns (coords tuple, is_fg_click) or
    (None, None) when prediction is already perfect.
    """
    error = pred.astype(bool) ^ label.astype(bool)
    if not error.any():
        return None, None
    disc = ndi.generate_binary_structure(error.ndim, connectivity=1)
    labeled, n = ndi.label(error, disc)
    sizes = ndi.sum(error, labeled, index=np.arange(1, n + 1))
    largest = int(np.argmax(sizes)) + 1
    if sizes[largest - 1] <= min_size:
        return None, None
    comp = labeled == largest
    # robust interior point: erode until nearly empty, then take center of mass
    core = comp
    while True:
        nxt = ndi.binary_erosion(core)
        if nxt.sum() < 1:
            break
        core = nxt
    com = ndi.center_of_mass(core)
    coords = tuple(int(round(c)) for c in com)
    if not comp[coords]:  # fall back to any point of the component
        pts = np.argwhere(core if core.any() else comp)
        coords = tuple(int(c) for c in pts[len(pts) // 2])
    is_fg = bool(label[coords])  # under-segmented → positive click
    return coords, is_fg
