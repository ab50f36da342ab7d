"""Grey-level co-occurrence matrix (GLCM) texture features (own copy of
boxsegliver_tpu/ops/glcm.py).

scikit-image is no dependency of the port, so this implements both the co-occurrence
matrix and the extended property set of the reference's skimage fork
(reference utils/array_kits.py:1140-1243 ``greycoprops``/``glcm_features``):
contrast, dissimilarity, homogeneity, ASM, energy, entropy, correlation,
cluster_shade, cluster_prominence, with the reference's norm_levels scaling.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

ALL_FEATURES = ("contrast", "dissimilarity", "homogeneity", "asm", "energy",
                "entropy", "correlation", "cluster_shade", "cluster_prominence")


def greycomatrix(image: np.ndarray, distances: Sequence[int],
                 angles: Sequence[float], levels: int = 256,
                 symmetric: bool = True, normed: bool = True) -> np.ndarray:
    """Co-occurrence histogram P[i, j, d, a] (skimage.feature.greycomatrix
    semantics: angle 0 → right, pi/2 → up in row coordinates)."""
    image = np.ascontiguousarray(image)
    assert image.ndim == 2 and image.dtype.kind in "ui"
    rows, cols = image.shape
    P = np.zeros((levels, levels, len(distances), len(angles)), np.float64)
    for di, dist in enumerate(distances):
        for ai, angle in enumerate(angles):
            dr = int(round(np.sin(angle))) * dist
            dc = int(round(np.cos(angle))) * dist
            r0 = max(0, -dr)
            r1 = min(rows, rows - dr)
            c0 = max(0, -dc)
            c1 = min(cols, cols - dc)
            if r0 >= r1 or c0 >= c1:
                continue
            a = image[r0:r1, c0:c1].ravel()
            b = image[r0 + dr:r1 + dr, c0 + dc:c1 + dc].ravel()
            idx = a.astype(np.int64) * levels + b
            counts = np.bincount(idx, minlength=levels * levels)
            P[:, :, di, ai] += counts.reshape(levels, levels)
    if symmetric:
        P = P + P.transpose(1, 0, 2, 3)
    if normed:
        sums = P.sum(axis=(0, 1), keepdims=True)
        sums[sums == 0] = 1
        P = P / sums
    return P


def greycoprops(P: np.ndarray, props: Sequence[str] = ("contrast",)
                ) -> "OrderedDict[str, np.ndarray]":
    """Extended property set over P[level, level, d, a] → each [d, a]."""
    num_level = P.shape[0]
    results: "OrderedDict[str, np.ndarray]" = OrderedDict()
    I, J = np.ogrid[0:num_level, 0:num_level]
    if "asm" in props or "energy" in props:
        asm = np.sum(P ** 2, axis=(0, 1))
        if "asm" in props:
            results["asm"] = asm
        if "energy" in props:
            results["energy"] = np.sqrt(asm)
    if "contrast" in props:
        results["contrast"] = np.sum(P * ((I - J) ** 2)[:, :, None, None],
                                     axis=(0, 1))
    if "dissimilarity" in props:
        results["dissimilarity"] = np.sum(P * np.abs(I - J)[:, :, None, None],
                                          axis=(0, 1))
    if "entropy" in props:
        results["entropy"] = -np.sum(P * np.log(P + 1e-16), axis=(0, 1))
    if "homogeneity" in props:
        results["homogeneity"] = np.sum(
            P * (1.0 / (1.0 + (I - J) ** 2))[:, :, None, None], axis=(0, 1))
    if {"correlation", "cluster_shade", "cluster_prominence"} & set(props):
        Ii = np.arange(num_level).reshape(num_level, 1, 1, 1)
        Jj = np.arange(num_level).reshape(1, num_level, 1, 1)
        mean_i = np.sum(Ii * P, axis=(0, 1))
        mean_j = np.sum(Jj * P, axis=(0, 1))
        diff_i = Ii - mean_i
        diff_j = Jj - mean_j
        if "correlation" in props:
            std_i = np.sqrt(np.sum(P * diff_i ** 2, axis=(0, 1)))
            std_j = np.sqrt(np.sum(P * diff_j ** 2, axis=(0, 1)))
            cov = np.sum(P * diff_i * diff_j, axis=(0, 1))
            corr = np.ones_like(cov)
            ok = (std_i > 1e-15) & (std_j > 1e-15)
            corr[ok] = cov[ok] / (std_i[ok] * std_j[ok])
            results["correlation"] = corr
        if "cluster_shade" in props:
            results["cluster_shade"] = np.sum(P * (diff_i + diff_j) ** 3,
                                              axis=(0, 1))
        if "cluster_prominence" in props:
            results["cluster_prominence"] = np.sum(P * (diff_i + diff_j) ** 4,
                                                   axis=(0, 1))
    return results


def glcm_features(image: np.ndarray, distances: Sequence[int],
                  angles: Sequence[float], levels: int = 256,
                  symmetric: bool = True, normed: bool = True,
                  features: Optional[Sequence[str]] = None, flat: bool = False,
                  norm_levels: bool = False
                  ) -> Tuple[np.ndarray, Optional[Dict[str, np.ndarray]]]:
    """GLCM + extended props with the reference's scale normalization
    (array_kits.py:1203-1239)."""
    glcm = greycomatrix(image, distances, angles, levels, symmetric, normed)
    if features is None:
        return glcm, None
    feats = list(ALL_FEATURES) if features == "all" else list(features)
    for f in feats:
        if f not in ALL_FEATURES:
            raise ValueError(f"{f} is an invalid property")
    results = greycoprops(glcm, props=feats)
    if flat:
        results = OrderedDict((k, v.reshape(-1)) for k, v in results.items())
    if norm_levels:
        scale = {
            "dissimilarity": 1.0 / (levels / 4),
            "contrast": 1.0 / (levels / 4) ** 2,
            "cluster_shade": 1.0 / (levels / 4) ** 3,
            "cluster_prominence": 1.0 / (levels / 4) ** 4,
            "homogeneity": 2.0, "asm": 2.0, "energy": 2.0,
            "entropy": 1.0 / 8,
        }
        for k in results:
            if k in scale:
                results[k] = results[k] * scale[k]
    return glcm, results


# The reference's "all" feature list for the context dumps (extract.py:
# 460-461): 8 props x 3 distances x 4 angles = 96 dims, matching the
# pre-computed per-dimension train-noise scales (data/sampler.GLCM_NOISE_SCALE)
DUMP_FEATURES = ("contrast", "dissimilarity", "homogeneity", "energy",
                 "entropy", "correlation", "cluster_shade",
                 "cluster_prominence")


def case_glcm_features(volume_hu: np.ndarray, meta: Dict, mode: str = "train",
                       distances=(1, 2, 3),
                       angles=(0.0, np.pi / 4, np.pi / 2, np.pi * 3 / 4),
                       levels: int = 256,
                       features: Sequence[str] = DUMP_FEATURES,
                       gray_min: float = -200, gray_max: float = 250,
                       filter_size: int = 20) -> np.ndarray:
    """Per-slice GLCM context vectors over tumor bbox patches
    (reference dump_glcm_feature_for_train/_eval, extract.py:377-661):
    train = mean over the slice's own tumor patches; eval = each tumor's
    middle-slice patch tiled across its z-range.  Patches are smoothed with a
    0.5-sigma Gaussian first like the reference (extract.py:476)."""
    from scipy import ndimage as ndi

    vol8 = ((np.clip(volume_hu, gray_min, gray_max) - gray_min)
            * (255.0 / (gray_max - gray_min))).astype(np.uint8)
    f_len = len(distances) * len(angles) * len(features)
    out = np.zeros((volume_hu.shape[0], f_len), np.float32)

    ft = meta["tumor_slices_from_to"]

    def patch_feature(z, bbox):
        y1, x1, y2, x2 = bbox
        patch = vol8[z, y1:y2, x1:x2]
        if patch.size < filter_size:
            return None
        patch = ndi.gaussian_filter(patch, 0.5)
        _, res = glcm_features(patch, distances, angles, levels,
                               features=features, flat=True, norm_levels=True)
        return np.concatenate([res[k] for k in features])

    if mode == "train":
        for ind, z in enumerate(meta["tumor_slices_index"]):
            vals = []
            for j in range(ft[ind], ft[ind + 1]):
                v = patch_feature(z, meta["tumor_slices"][j])
                if v is not None:
                    vals.append(v)
            if vals:
                out[z] = np.mean(vals, axis=0)
    else:  # eval: middle-slice patch tiled over each tumor's z range
        for tid, tumor in enumerate(meta["tumors"]):
            z1, _, _, z2, _, _ = tumor
            mid = (z2 - z1 - 1) // 2 + z1
            if mid not in meta["tumor_slices_index"]:
                continue
            ind = meta["tumor_slices_index"].index(mid)
            for j in range(ft[ind], ft[ind + 1]):
                if meta["tumor_slices_tid"][j] != tid:
                    continue
                v = patch_feature(mid, meta["tumor_slices"][j])
                if v is not None:
                    for z in range(z1, z2):
                        out[z] = v
    return out
