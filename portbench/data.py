"""Synthetic data sets made from the run's seed, on the device, in the
layout the program reads (``<root>/volume-<pid>/{volume,segmentation}.npy``,
``meta.json``, ``k_folds.txt``, the hist features, the user prior).

The cases follow the synthetic generators the repository has always used
(a LiTS-like CT case: an ellipsoid liver at 60 HU with 1-3 spherical
tumours at 20 HU over -200 HU fat, noise 15 + 10 HU; an NF-like MRI case:
an ellipsoid body at 300 with 1-4 spherical lesions at 700, noise 30,
range [0, 1000]), drawn here with the scalars from a numpy generator and
the noise from a torch generator on the card, so a 96 x 512 x 512 case
takes milliseconds.  The per-case metadata and the hist features are the
program's own prepare step (``data.meta``), which every user of the program
runs before training.  The user prior (``prior.json``: the simulated
user's ellipse on each tumour's middle slice, with its z-range), which the
guided eval reads as the user's input, is drawn here from the labels.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

# LiTS HU window and the cache's scale (stored = (clip(v) − min) · 64)
LIVER_WINDOW = (-250, 300)
NF_WINDOW = (0, 1000)
IM_SCALE = 64


def _grid(shape, device):
    d, h, w = shape
    z = torch.arange(d, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    return z, y, x


def liver_case(rng: np.random.Generator, gen: torch.Generator,
               shape: Sequence[int], device, max_tumors: int = 3,
               organ=None):
    """(HU volume int16, labels uint8, spacing) of one CT-like case; with
    ``organ`` (radii as fractions of the shape) the liver is that
    ellipsoid at the volume's centre, else drawn."""
    d, h, w = shape
    z, y, x = _grid(shape, device)
    if organ is None:
        c = rng.uniform(0.4, 0.6, 3) * (d, h, w)
        r = rng.uniform(0.25, 0.4, 3) * (d, h, w)
    else:
        c = 0.5 * np.array([d, h, w], np.float64)
        r = np.array(organ, np.float64) * (d, h, w)
    liver = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
             + ((x - c[2]) / r[2]) ** 2) <= 1.0
    labels = liver.to(torch.uint8)
    for _ in range(int(rng.integers(1, max_tumors + 1))):
        t = c + rng.uniform(-0.5, 0.5, 3) * r
        tr = rng.uniform(0.08, 0.2) * min(h, w)
        tumor = ((z - t[0]) ** 2 + (y - t[1]) ** 2 + (x - t[2]) ** 2) <= tr ** 2
        labels[tumor & liver] = 2
    vol = -200.0 + 15.0 * torch.randn(tuple(shape), generator=gen,
                                      device=device)
    vol[labels == 1] = 60.0
    vol[labels == 2] = 20.0
    vol += 10.0 * torch.randn(tuple(shape), generator=gen, device=device)
    spacing = (float(rng.uniform(1.0, 3.0)), 0.8, 0.8)
    return vol.to(torch.int16), labels, spacing


def nf_case(rng: np.random.Generator, gen: torch.Generator,
            shape: Sequence[int], device, max_lesions: int = 4):
    """(volume int16 in [0, 1000], labels uint8, spacing) of one MRI-like
    neurofibroma case."""
    d, h, w = shape
    z, y, x = _grid(shape, device)
    c = (0.5 * d, 0.5 * h, 0.5 * w)
    r = (0.45 * d, 0.4 * h, 0.4 * w)
    body = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
            + ((x - c[2]) / r[2]) ** 2) <= 1.0
    labels = torch.zeros(tuple(shape), dtype=torch.uint8, device=device)
    for _ in range(int(rng.integers(1, max_lesions + 1))):
        t = [ci + rng.uniform(-0.5, 0.5) * ri for ci, ri in zip(c, r)]
        tr = rng.uniform(0.08, 0.18) * min(h, w)
        lesion = ((z - t[0]) ** 2 + (y - t[1]) ** 2 + (x - t[2]) ** 2) \
            <= tr ** 2
        labels[lesion & body] = 1
    vol = torch.where(body, 300.0, 0.0)
    vol = torch.where(labels == 1, 700.0, vol)
    vol += 30.0 * torch.randn(tuple(shape), generator=gen,
                              device=device) * body
    spacing = (float(rng.uniform(3.0, 6.0)), 1.0, 1.0)
    return torch.clamp(vol, 0, 1000).to(torch.int16), labels, spacing


MODALITIES = {"liver": (liver_case, LIVER_WINDOW, 2),
              "nf": (nf_case, NF_WINDOW, 1)}


def k_folds_lines(train: Sequence[int], test: Sequence[int], k: int,
                  test_fold: int) -> str:
    """k_folds.txt with ``test`` in fold ``test_fold`` and ``train`` dealt
    round-robin over the other folds."""
    folds: List[List[int]] = [[] for _ in range(k)]
    others = [i for i in range(k) if i != test_fold]
    for j, pid in enumerate(train):
        folds[others[j % len(others)]].append(pid)
    folds[test_fold] = list(test)
    return "".join("Fold %d:" % i + " ".join(str(p) for p in f) + "\n"
                   for i, f in enumerate(folds))


def user_prior(labels: np.ndarray, tumor_value: int) -> Dict[str, List]:
    """{slice: [{"z", "center", "stddev"}]} of one case: for each 3-D
    tumour (26-connected), its z-range [z1, z2) and, on its middle slice,
    the mean and the standard deviation of its pixels' (row, column)."""
    from scipy import ndimage as ndi

    objs, _ = ndi.label(labels == tumor_value, np.ones((3, 3, 3), bool))
    out: Dict[str, List] = {}
    for j, sl in enumerate(ndi.find_objects(objs)):
        z1, z2 = sl[0].start, sl[0].stop
        mid = (z2 - z1 - 1) // 2 + z1
        ys, xs = np.nonzero(objs[mid] == j + 1)
        if len(ys) == 0:
            continue
        pts = np.stack([ys, xs], 1).astype(np.float64)
        out.setdefault(str(mid), []).append({
            "z": [int(z1), int(z2)],
            "center": [float(v) for v in pts.mean(0)],
            "stddev": [round(float(v), 3) for v in pts.std(0)]})
    return out


def make_dataset(root: Path, data: Dict, seed: int, device, *,
                 train_cases: int, test_cases: int, k_folds: int,
                 test_fold: int, hist_modes=(), prior: bool = False
                 ) -> Path:
    """Write ``train_cases`` + ``test_cases`` cases of ``data["shape"]``
    (modality ``data["modality"]``) drawn from ``seed``, the training cases
    first, the hist features of ``hist_modes`` and, with ``prior``, the
    user prior; returns ``root``.  Where ``data`` lists ``test_organ``
    (liver radii as fractions of the shape), the test cases take those
    organs in that order, so that every seed gives the eval the same case
    sizes."""
    from boxsegliver_torch.data import meta as meta_mod

    make, (lo, hi), tumor_value = MODALITIES[data["modality"]]
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng([seed, 0xDA7A])
    gen = torch.Generator(device=device).manual_seed(seed ^ 0xDA7A)
    metas, priors = [], {}
    n = train_cases + test_cases
    organs = data.get("test_organ")
    for pid in range(n):
        fixed = ({"organ": organs[(pid - train_cases) % len(organs)]}
                 if organs and pid >= train_cases else {})
        vol, lab, spacing = make(rng, gen, data["shape"], device, **fixed)
        vol, lab = vol.cpu().numpy(), lab.cpu().numpy()
        if prior:
            priors[str(pid)] = user_prior(lab, tumor_value)
        metas.append(meta_mod.process_case(
            vol, lab, spacing, pid, f"synthetic://volume-{pid}",
            f"synthetic://segmentation-{pid}", tumor_value=tumor_value))
        case = root / f"volume-{pid}"
        case.mkdir(exist_ok=True)
        stored = ((np.clip(vol, lo, hi) - lo) * IM_SCALE).astype(np.uint16)
        np.save(case / "volume.npy", stored)
        np.save(case / "segmentation.npy", lab)
    (root / "meta.json").write_text(json.dumps(metas))
    (root / "k_folds.txt").write_text(k_folds_lines(
        range(train_cases), range(train_cases, n), k_folds, test_fold))
    if hist_modes:
        meta_mod.dump_hist_features(root, modes=tuple(hist_modes))
    if prior:
        (root / "prior.json").write_text(json.dumps(priors))
    return root
