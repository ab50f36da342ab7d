"""Synthetic dataset generators (own copy of
boxsegliver_tpu/data/synthetic.py: same generators, same bytes for the same
seed).

Liver cases are ellipsoid "livers" (label 1) with darker spherical
"tumors" (label 2) plus CT-like noise; NF cases (``modality="nf"``) are
bright MRI-like lesions (label 1) on a gray body, gray range [0, 1000], and
``variant="hard"`` adds unlabeled distractor blobs, low contrast and a bias
field.  Each dataset is written as the npy cache + meta.json + k_folds.txt
+ hist features + prior.json that the samplers and evaluators read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from boxsegliver_torch.data import meta as meta_mod
from boxsegliver_torch.data.kfold import read_or_create_k_folds


def make_case(rng: np.random.Generator, shape: Tuple[int, int, int] = (32, 128, 128),
              max_tumors: int = 3):
    """One synthetic case → (HU volume int16, labels uint8, spacing)."""
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")

    # Ellipsoid liver somewhere center-ish
    cz = rng.uniform(0.4, 0.6) * d
    cy = rng.uniform(0.4, 0.6) * h
    cx = rng.uniform(0.4, 0.6) * w
    rz = rng.uniform(0.25, 0.4) * d
    ry = rng.uniform(0.25, 0.4) * h
    rx = rng.uniform(0.25, 0.4) * w
    liver = (((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2
             + ((xx - cx) / rx) ** 2) <= 1.0

    labels = np.zeros(shape, np.uint8)
    labels[liver] = 1

    n_tumors = int(rng.integers(1, max_tumors + 1))
    for _ in range(n_tumors):
        # tumor center inside the liver ellipsoid
        tz = cz + rng.uniform(-0.5, 0.5) * rz
        ty = cy + rng.uniform(-0.5, 0.5) * ry
        tx = cx + rng.uniform(-0.5, 0.5) * rx
        tr = rng.uniform(0.08, 0.2) * min(h, w)
        tumor = ((zz - tz) ** 2 + (yy - ty) ** 2 + (xx - tx) ** 2) <= tr ** 2
        labels[tumor & liver] = 2

    volume = np.full(shape, -200.0, np.float32)           # background fat-ish
    volume += rng.normal(0.0, 15.0, shape).astype(np.float32)
    volume[labels == 1] = 60.0                             # liver parenchyma
    volume[labels == 2] = 20.0                             # hypodense tumor
    volume += rng.normal(0.0, 10.0, shape).astype(np.float32)
    spacing = (float(rng.uniform(1.0, 3.0)), 0.8, 0.8)
    return volume.astype(np.int16), labels, spacing


def make_nf_case(rng: np.random.Generator,
                 shape: Tuple[int, int, int] = (32, 128, 128),
                 max_lesions: int = 4):
    """One synthetic NF-like MRI case: bright lesions (label 1) on a gray body
    background, value range [0, 1000] (reference NF gray range,
    NF/input_pipeline.py:45-46)."""
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    cz, cy, cx = 0.5 * d, 0.5 * h, 0.5 * w
    body = (((zz - cz) / (0.45 * d)) ** 2 + ((yy - cy) / (0.4 * h)) ** 2
            + ((xx - cx) / (0.4 * w)) ** 2) <= 1.0
    labels = np.zeros(shape, np.uint8)
    for _ in range(int(rng.integers(1, max_lesions + 1))):
        tz = cz + rng.uniform(-0.5, 0.5) * 0.45 * d
        ty = cy + rng.uniform(-0.5, 0.5) * 0.4 * h
        tx = cx + rng.uniform(-0.5, 0.5) * 0.4 * w
        tr = rng.uniform(0.08, 0.18) * min(h, w)
        lesion = ((zz - tz) ** 2 + (yy - ty) ** 2 + (xx - tx) ** 2) <= tr ** 2
        labels[lesion & body] = 1
    volume = np.zeros(shape, np.float32)
    volume[body] = 300.0
    volume[labels == 1] = 700.0                            # hyperintense NF
    volume += rng.normal(0.0, 30.0, shape).astype(np.float32) * body
    spacing = (float(rng.uniform(3.0, 6.0)), 1.0, 1.0)
    return np.clip(volume, 0, 1000).astype(np.int16), labels, spacing


def _smooth_field(rng: np.random.Generator, shape, low: float, high: float,
                  grid: int = 4) -> np.ndarray:
    """Low-frequency multiplicative bias field in [low, high] (trilinear
    upsampling of a coarse random grid)."""
    coarse = rng.uniform(low, high, size=(grid, grid, grid)).astype(np.float32)
    from scipy import ndimage as ndi
    zoom = [s / g for s, g in zip(shape, coarse.shape)]
    return ndi.zoom(coarse, zoom, order=1, mode="nearest")


def make_nf_hard_case(rng: np.random.Generator,
                      shape: Tuple[int, int, int] = (32, 256, 256),
                      n_lesions: Tuple[int, int] = (3, 8),
                      return_info: bool = False):
    """One HARD synthetic NF case, built so that appearance alone cannot
    solve it (the round-2 verdict's de-saturation demand):

    - lesions are SMALL (in-plane radius 2-9 px, z radius 1-3) with soft
      gaussian edges and LOW contrast over a noisy, bias-field-modulated body;
    - every case also contains the same number of DISTRACTOR blobs drawn from
      the same size distribution but left unlabeled — a no-guide model
      cannot tell lesion from distractor, so its Dice is structurally
      capped (~2L/(2L+D) if it marks everything blob-like), while spatial
      guides / clicks (which mark true lesions) disambiguate;
    - lesion and distractor intensity deltas come from two DISJOINT
      per-case bands (one in [90,115], one in [135,160]) and which band is
      the lesion one flips randomly per case: the MARGINAL delta
      distribution is identical for lesions and distractors (appearance
      alone stays capped), but the per-case GT-region histogram — exactly
      what the hist context feature encodes (meta.case_hist_features,
      reference extract.py:340-374 dump_hist_feature_v2) — reveals it, so
      histogram context carries real, learnable signal.  This mirrors the
      reference's finding that context+spatial beats spatial-only
      (experiments.md:40-41,120); before round 4 both blob families shared
      one band and context was provably dead weight on this benchmark.
    - the background OUTSIDE the body is low-level MRI-like noise, never
      exactly zero (v3).  Real NF frames have no exact-zero pixels, which is
      why the reference gets away with its own train/eval z-score
      inconsistency (masked nonzero z-score at train, utils/image_ops.py:
      25-33, vs UNMASKED per-slice z-score at eval, NF/input_pipeline_g.py:
      699-705 — reproduced verbatim in evaluators/eval_loader.py).  A
      zero background turns that inconsistency into a catastrophic eval
      domain shift (background -mean/std ~ -3 sigma vs 0 seen in training:
      the round-4 ladder collapse, all rungs <0.15 Dice with train Dice
      0.9+); a nonzero background makes the masked and unmasked forms
      equivalent, exactly as on real data.
    - per-case global gain jitter makes normalization matter.

    Mirrors the difficulty axis of the reference's real-NF ladder
    (experiments.md:103-127: UNet 0.492 -> spatial GUNet 0.802 ->
    interactive 0.837) in a synthetic, hermetic form.

    With return_info=True additionally returns {"mu_lesion", "mu_distractor"}
    (pre-gain-jitter band centers) for tests.
    """
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    cz, cy, cx = 0.5 * d, 0.5 * h, 0.5 * w
    body = (((zz - cz) / (0.48 * d)) ** 2 + ((yy - cy) / (0.42 * h)) ** 2
            + ((xx - cx) / (0.42 * w)) ** 2) <= 1.0

    labels = np.zeros(shape, np.uint8)
    volume = np.zeros(shape, np.float32)
    volume[body] = 300.0
    volume *= _smooth_field(rng, shape, 0.8, 1.25)

    distractors = np.zeros(shape, bool)

    def add_blob(labeled: bool, delta: float):
        ty = cy + rng.uniform(-0.8, 0.8) * 0.4 * h
        tx = cx + rng.uniform(-0.8, 0.8) * 0.4 * w
        tz = cz + rng.uniform(-0.8, 0.8) * 0.45 * d
        r_in = rng.uniform(2.0, 9.0)
        r_z = rng.uniform(1.0, 3.0)
        dist2 = (((zz - tz) / r_z) ** 2 + ((yy - ty) / r_in) ** 2
                 + ((xx - tx) / r_in) ** 2)
        # soft gaussian edge: contrast fades across the boundary
        blob = np.exp(-0.5 * np.clip(dist2, 0, 16.0)).astype(np.float32)
        volume[...] += delta * blob * body
        if labeled:
            labels[(dist2 <= 1.0) & body] = 1
        else:
            distractors[(dist2 <= 1.0) & body] = True

    # Two disjoint intensity bands; which one is the lesion band flips per
    # case, so appearance alone cannot learn "bright blob = lesion" but the
    # case's GT-region histogram can.
    lo = float(rng.uniform(90.0, 115.0))
    hi = float(rng.uniform(135.0, 160.0))
    mu_lesion, mu_distractor = (lo, hi) if rng.random() < 0.5 else (hi, lo)

    n = int(rng.integers(n_lesions[0], n_lesions[1] + 1))
    for _ in range(n):
        add_blob(True, float(rng.normal(mu_lesion, 6.0)))
    for _ in range(n):          # same sizes/count, the OTHER band, unlabeled
        add_blob(False, float(rng.normal(mu_distractor, 6.0)))

    volume += rng.normal(0.0, 55.0, shape).astype(np.float32) * body
    # v3: MRI-like nonzero background (see docstring); >= 8 so the uint16
    # cache keeps every pixel strictly positive
    bg = 8.0 + np.abs(rng.normal(0.0, 15.0, shape)).astype(np.float32)
    volume = np.where(body, volume, bg)
    gain = float(rng.uniform(0.75, 1.3))          # per-case gain jitter
    volume *= gain
    spacing_ = (float(rng.uniform(3.0, 6.0)), 1.0, 1.0)
    vol16 = np.clip(volume, 0, 1000).astype(np.int16)
    if return_info:
        return vol16, labels, spacing_, {"mu_lesion": mu_lesion,
                                         "mu_distractor": mu_distractor,
                                         "gain": gain, "body": body,
                                         "distractors": distractors}
    return vol16, labels, spacing_


def make_synthetic_dataset(root, n_cases: int = 4,
                           shape: Tuple[int, int, int] = (32, 128, 128),
                           seed: int = 0, k_split: int = 4,
                           with_features: bool = True,
                           modality: str = "liver",
                           variant: str = "easy") -> Path:
    """Write a ready-to-train dataset: npy cache + meta.json + k_folds.txt +
    hist features + prior.json, mirroring the reference's prepare/ layout.
    modality='nf' writes NF-like MRI (lesion label 1, gray range [0,1000]);
    variant='hard' uses the distractor/low-contrast generator
    (make_nf_hard_case) that separates guided from unguided models."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    preset = meta_mod.MODALITIES[modality]
    metas = []
    for pid in range(n_cases):
        if variant == "hard":
            volume, labels, spacing = make_nf_hard_case(rng, shape)
        elif modality == "nf":
            volume, labels, spacing = make_nf_case(rng, shape)
        else:
            volume, labels, spacing = make_case(rng, shape)
        m = meta_mod.process_case(volume, labels, spacing, pid,
                                  f"synthetic://volume-{pid}",
                                  f"synthetic://segmentation-{pid}",
                                  tumor_value=preset["tumor_value"])
        case_dir = root / f"volume-{pid}"
        case_dir.mkdir(parents=True, exist_ok=True)
        np.save(case_dir / "volume.npy",
                meta_mod.window_clip_uint16(volume, preset["gray_min"],
                                            preset["gray_max"]))
        np.save(case_dir / "segmentation.npy", labels)
        metas.append(m)
    with (root / "meta.json").open("w") as f:
        json.dump(metas, f)
    read_or_create_k_folds(root / "k_folds.txt", [m["PID"] for m in metas],
                           k_split=k_split, seed=1357)
    if with_features:
        if modality == "liver":
            meta_mod.dump_hist_features(root)
        else:
            # NF context histograms: lesion label doubles as the "organ"
            # region, gray range [0, 1000] (reference NF/extract.py hist)
            meta_mod.dump_hist_features(root, xrng=(50.0, 950.0),
                                        gray_min=preset["gray_min"],
                                        organ_val=1, tumor_val=1)
        meta_mod.simulate_user_prior(metas, root / "prior.json")
    return root
