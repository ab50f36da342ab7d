"""Headless segmentation viewer: prediction-vs-GT overlay PNGs (port of
boxsegliver_tpu/utils/viewer.py without matplotlib).

The reference ships Qt/traitsui GUI viewers (reference viewer.py:28-220,
visualization/, interaction/) for manual inspection; headless, the
equivalent surface is rendered PNG overlays per slice plus a per-case
contact sheet.  The JAX package draws them with matplotlib; the port
composites the RGB pixels itself and encodes them with cli/viewer's zlib PNG
encoder, at the slice's own resolution:

- the gray image is min-max normalized over the volume;
- each predicted class is filled at alpha 0.35 with its color;
- each ground-truth class is drawn as its one-pixel inner boundary (a pixel
  of the class with a 4-neighbour outside it, or on the image's edge) in
  its color, where matplotlib draws ``contour(levels=[0.5])``;
- the figure title (case, z, scores) goes into the PNG's tEXt "Title".
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

# class id → RGB overlay color (GT drawn as contours, pred as fill)
_COLORS = {1: (0.2, 0.6, 1.0), 2: (1.0, 0.3, 0.2), 3: (0.2, 1.0, 0.4)}
PRED_ALPHA = 0.35


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Pixels of ``mask`` with a 4-neighbour outside it (outside the image
    counts as outside the mask)."""
    p = np.pad(mask, 1)
    inner = (p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2]
             & p[1:-1, 2:])
    return mask & ~inner


def composite(gray: np.ndarray, pred: np.ndarray,
              label: Optional[np.ndarray] = None) -> np.ndarray:
    """gray [h, w] in [0, 1], class maps [h, w] -> RGB uint8 [h, w, 3]: per
    class in _COLORS order the prediction's fill, then the label's
    boundary."""
    rgb = np.repeat(gray.astype(np.float32)[..., None], 3, axis=-1)
    for cls, color in _COLORS.items():
        c = np.asarray(color, np.float32)
        m = pred == cls
        rgb[m] = (1.0 - PRED_ALPHA) * rgb[m] + PRED_ALPHA * c
        if label is not None:
            rgb[_boundary(label == cls)] = c
    return np.round(rgb * 255.0).astype(np.uint8)


def save_case_overlays(volume: np.ndarray, label: Optional[np.ndarray],
                       pred: np.ndarray, out_dir, case_name: str = "case",
                       scores: Optional[Dict[str, float]] = None,
                       every: int = 1, max_slices: int = 64):
    """Write per-slice overlay PNGs + a contact sheet.

    volume: [d, h, w] grayscale (any range); label/pred: [d, h, w] class ids.
    """
    from boxsegliver_torch.cli.viewer import encode_png

    out = Path(out_dir) / case_name
    out.mkdir(parents=True, exist_ok=True)
    v = volume.astype(np.float32)
    v = (v - v.min()) / (v.max() - v.min() + 1e-8)

    interesting = [z for z in range(0, volume.shape[0], every)
                   if pred[z].any() or (label is not None and label[z].any())]
    if not interesting:
        interesting = list(range(0, volume.shape[0], every))
    interesting = interesting[:max_slices]

    for z in interesting:
        title = f"{case_name} z={z}"
        if scores:
            title += "  " + " ".join(f"{k}={v_:.3f}" for k, v_ in scores.items())
        img = composite(v[z], pred[z], None if label is None else label[z])
        (out / f"slice_{z:03d}.png").write_bytes(
            encode_png(img, text={"Title": title}))

    # contact sheet: the prediction fills only, at most 8 columns, white
    # where a row has no slice
    cols = min(8, len(interesting))
    rows = (len(interesting) + cols - 1) // cols
    h, w = volume.shape[1:]
    sheet = np.full((rows * h, cols * w, 3), 255, np.uint8)
    for i, z in enumerate(interesting):
        r, c = divmod(i, cols)
        sheet[r * h:(r + 1) * h, c * w:(c + 1) * w] = composite(v[z], pred[z])
    (out / "sheet.png").write_bytes(encode_png(sheet, text={
        "Title": f"{case_name} z=" + ",".join(str(z) for z in interesting)}))
    return out
