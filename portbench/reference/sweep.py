"""Plain float32 guided eval of one LiTS-like case, the ``run_g`` protocol
of the configuration (mirror test-time augmentation, the user prior, the
hist context), for judging the program's merged probability volumes; and
the per-case Dice, VOE and RVD of a prediction.  Nothing here imports the
program.

- The crop: the organ's box (labels > 0) padded by 25 pixels in-plane,
  centred and aligned to 16; the organ's z-range.
- The images: the stored values back to HU, the crop's z-range with one
  neighbour slice each side (HU 0 beyond the volume), windowed to
  [-200, 250] HU → [0, 1], each slice resized bilinearly (half-pixel
  centres, no antialias) to the input size; slice z reads z − 1, z, z + 1.
- The context of slice z: the eval hist features (100-bin densities over
  [-200, 250] HU of the organ's pixels and of the user-guided pixels, each
  3-D tumour's middle-slice pixels tiled over its z-range) × hist_scale.
- The guide: the user prior's objects marked on that slice (stddev over
  min_std; centre mapped to the input grid by truncation; stddev clamped
  below at min_std), the max over objects of a clipped Gaussian,
  · discount / 2 + 0.5.
- The probabilities: the mean over the mirrors (none, width, height,
  both) of the softmax of the un-flipped logits.
- The propagated state: a slice's predicted tumour components found beside
  a guide guide the next slice, in each of the two sweeps, which are then
  merged by their maximum.  Under the weights of the benchmark's guided
  cell no voxel is predicted tumour: the state stays empty, both sweeps
  see the same guides, and their merge is either sweep's probabilities.
  ``case_probs`` follows the sweep there only, and says whether a tumour
  voxel was predicted.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi

from portbench.reference import nets
from portbench.reference.train import gaussian_guide

STORE_MIN_HU, STORE_SCALE = -250.0, 64.0
WINDOW = (-200.0, 250.0)
GUIDE_BG = 0.5
MIRRORS = ((), (2,), (1,), (1, 2))         # NHWC axes: 2 width, 1 height
CHUNK = 8                                   # slices a forward


def aligned_crop(labels: np.ndarray, align: int = 16, padding: int = 25):
    """(z1, z2, y1, y2, x1, x2), ends exclusive, of the organ's box."""
    d, h, w = labels.shape
    nz = [np.nonzero(labels.any(axis=a))[0] for a in ((1, 2), (0, 2), (0, 1))]
    z1, z2 = int(nz[0][0]), int(nz[0][-1]) + 1
    y1 = max(int(nz[1][0]) - padding, 0)
    y2 = min(int(nz[1][-1]) + 1 + padding, h)
    x1 = max(int(nz[2][0]) - padding, 0)
    x2 = min(int(nz[2][-1]) + 1 + padding, w)
    cy, cx = (y1 + y2 - 1) / 2, (x1 + x2 - 1) / 2
    sy = int(math.ceil((y2 - y1) / align)) * align
    sx = int(math.ceil((x2 - x1) / align)) * align
    y1, x1 = max(int(cy - (sy - 1) / 2), 0), max(int(cx - (sx - 1) / 2), 0)
    y2, x2 = min(y1 + sy, h), min(x1 + sx, w)
    if (y2 - y1) % align or (x2 - x1) % align:
        y1, x1 = max(y2 - sy, 0), max(x2 - sx, 0)
    return z1, z2, y1, y2, x1, x2


def eval_hist(hu: np.ndarray, labels: np.ndarray, tumor: int = 2,
              bins: int = 100) -> np.ndarray:
    """[d, 2·bins] densities of each slice's organ pixels and user-guided
    pixels (each tumour's pixels counted, also where two overlap; 0 where
    a slice has none)."""
    guided = [[] for _ in range(labels.shape[0])]
    objs, _ = ndi.label(labels == tumor, ndi.generate_binary_structure(3, 2))
    for j, sl in enumerate(ndi.find_objects(objs)):
        z1, z2 = sl[0].start, sl[0].stop
        mid = (z2 - z1 - 1) // 2 + z1
        ys, xs = np.nonzero(objs[mid][sl[1], sl[2]] == j + 1)
        ys, xs = ys + sl[1].start, xs + sl[2].start
        for z in range(z1, z2):
            guided[z].append(hu[z, ys, xs])
    out = np.zeros((hu.shape[0], 2 * bins), np.float32)
    for k in range(hu.shape[0]):
        values = (hu[k][labels[k] >= 1],
                  np.concatenate(guided[k]) if guided[k] else hu[k, :0, 0])
        for i, v in enumerate(values):
            with np.errstate(invalid="ignore"):
                h, _ = np.histogram(v, bins=bins, range=WINDOW, density=True)
            out[k, i * bins:(i + 1) * bins] = np.nan_to_num(h)
    return out


def images(stored: np.ndarray, crop, pshape, device) -> torch.Tensor:
    """[cz + 2, ph, pw] windowed, resized slices of the crop, one
    neighbour each side."""
    z1, z2, y1, y2, x1, x2 = crop
    d = stored.shape[0]
    hu = stored[max(z1 - 1, 0):min(z2 + 1, d), y1:y2, x1:x2].astype(
        np.float32) / STORE_SCALE + STORE_MIN_HU
    pads = [np.zeros((n,) + hu.shape[1:], np.float32)
            for n in (max(1 - z1, 0), max(z2 + 1 - d, 0))]
    hu = np.concatenate([pads[0], hu, pads[1]])
    x = torch.from_numpy(hu).to(device)
    x = (torch.clamp(x, *WINDOW) - WINDOW[0]) / (WINDOW[1] - WINDOW[0])
    return F.interpolate(x[:, None], size=tuple(pshape), mode="bilinear",
                         align_corners=False)[:, 0]


def user_guides(prior_case: Dict, crop, pshape, min_std: float, depth: int):
    """Per cropped slice: [(centre (row, col) on the input grid, stddev)]
    of the objects the user marked there."""
    z1, _, y1, y2, x1, x2 = crop
    ch, cw = y2 - y1, x2 - x1
    out = [[] for _ in range(depth)]
    for sid, objs in (prior_case or {}).items():
        idx = int(sid) - z1
        if not 0 <= idx < depth:
            continue
        for o in objs:
            if min(o["stddev"]) <= min_std:
                continue
            c = (int((o["center"][0] - y1) / ch * pshape[0]),
                 int((o["center"][1] - x1) / cw * pshape[1]))
            out[idx].append((c, tuple(o["stddev"])))
    return out


@torch.no_grad()
def case_probs(net, stored: np.ndarray, labels: np.ndarray, prior_case,
               settings: Dict, device, ops=None, guides: bool = True
               ) -> Tuple[torch.Tensor, bool]:
    """(probabilities [cz, ph, pw, classes] of the merged sweeps, whether a
    tumour voxel was predicted); ``guides=False`` renders no user guide."""
    ops = ops or nets.Ops()
    pshape = (int(settings["im_height"]), int(settings["im_width"]))
    crop = aligned_crop(labels)
    cz = crop[1] - crop[0]
    hu = stored.astype(np.float32) / STORE_SCALE + STORE_MIN_HU
    ctx = eval_hist(hu, labels)[crop[0]:crop[1]] * float(
        settings["hist_scale"])
    ctx = torch.from_numpy(ctx).to(device)
    vol = images(stored, crop, pshape, device)
    marks = user_guides(prior_case if guides else {}, crop, pshape,
                        float(settings["min_std"]), cz)
    m = max(1, max(len(o) for o in marks))
    cen = torch.zeros((cz, m, 2), device=device)
    std = torch.ones((cz, m, 2), device=device)
    valid = torch.zeros((cz, m), dtype=torch.bool, device=device)
    for z, objs in enumerate(marks):
        for k, (c, s) in enumerate(objs):
            cen[z, k] = torch.tensor(c, dtype=torch.float32)
            std[z, k] = torch.tensor(s, dtype=torch.float32)
            valid[z, k] = True
    std = torch.clamp_min(std, float(settings["min_std"]))
    scale = float(settings["eval_discount"]) / 2.0
    out = []
    for z0 in range(0, cz, CHUNK):
        zs = range(z0, min(z0 + CHUNK, cz))
        img = torch.stack([vol[z:z + 3].permute(1, 2, 0) for z in zs])
        gd = gaussian_guide(cen[z0:z0 + len(zs)], std[z0:z0 + len(zs)],
                            valid[z0:z0 + len(zs)], *pshape, scale, GUIDE_BG)
        n = len(MIRRORS)
        feats = {"images": torch.cat([img.flip(a) if a else img
                                      for a in MIRRORS]),
                 "sp_guide": torch.cat([gd.flip(a) if a else gd
                                        for a in MIRRORS]),
                 "context": ctx[z0:z0 + len(zs)].repeat(n, 1)}
        probs = torch.softmax(net(feats, ops), dim=-1).view(
            (n, len(zs)) + tuple(pshape) + (-1,))
        acc = sum(probs[i].flip(a) if a else probs[i]
                  for i, a in enumerate(MIRRORS))
        out.append(acc / n)
    probs = torch.cat(out)
    return probs, bool((probs.argmax(-1) == 2).any())


def log_odds(probs: torch.Tensor) -> torch.Tensor:
    """log p(Tumor) − log p(Background) of each voxel."""
    p = probs.double().clamp_min(1e-300)
    return torch.log(p[..., 2]) - torch.log(p[..., 0])


def crop_classes(probs: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """argmax class map [cz, ph, pw] brought back to the crop's (ch, cw)
    by nearest sampling (source index floor(i · src / dst))."""
    pred = np.argmax(probs, axis=-1).astype(np.uint8)
    for axis, dst in ((1, shape[0]), (2, shape[1])):
        src = pred.shape[axis]
        if src != dst:
            idx = np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src)))
                             .astype(np.int64), src - 1)
            pred = np.take(pred, idx, axis=axis)
    return pred


def case_metrics(probs: np.ndarray, labels: np.ndarray, classes
                 ) -> Dict[str, float]:
    """{"<class>/Dice", "/VOE", "/RVD"} of one case's merged probabilities
    against its labels: the organ is Liver ∪ Tumour, its largest
    6-connected component kept, the tumour inside it."""
    crop = aligned_crop(labels)
    z1, z2, y1, y2, x1, x2 = crop
    seg = np.asarray(labels[z1:z2, y1:y2, x1:x2])
    pred = crop_classes(probs, (y2 - y1, x2 - x1))
    liver = pred >= 1
    if liver.any():
        lab, _ = ndi.label(liver, ndi.generate_binary_structure(3, 1))
        liver = lab == int(np.argmax(np.bincount(lab.flat)[1:])) + 1
    masks = {"Liver": (liver, seg >= 1), "Tumor": ((pred == 2) & liver,
                                                   seg == 2)}
    out = {}
    for cls in classes:
        a, b = masks[cls]
        inter = np.count_nonzero(a & b)
        sa, sb = np.count_nonzero(a), np.count_nonzero(b)
        union = np.count_nonzero(a | b)
        out[f"{cls}/Dice"] = 2.0 * inter / (sa + sb) if sa + sb else 0.0
        out[f"{cls}/VOE"] = 1.0 - inter / union if union else 0.0
        out[f"{cls}/RVD"] = (abs(sa - sb) / sb if sb
                             else (0.0 if sa == 0 else np.inf))
    return out


def load_case(dataset: Path, pid: int):
    root = Path(dataset) / f"volume-{pid}"
    return np.load(root / "volume.npy"), np.load(root / "segmentation.npy")
