"""Offline preprocessing: NIfTI volumes → npy cache + meta.json + context
features (own copy of boxsegliver_tpu/data/meta.py; semantics of reference
DataLoader/Liver/extract.py:61-374, 377-661, 664-717, 742-793).

Each case is cached as ``<case>/volume.npy`` (uint16, window-clipped,
x IM_SCALE) and ``<case>/segmentation.npy`` (uint8 class ids) beside a
meta.json whose schema matches the reference's.  ``cli/prepare`` drives the
functions here; NIfTI files are read with the port's own data/nii.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import ndimage as ndi

from boxsegliver_torch.data import nii as nii_kits
from boxsegliver_torch.ops import array_kits

# LiTS constants (reference extract.py:40-44)
GRAY_MIN = -250
GRAY_MAX = 300
IM_SCALE = 64


def process_case(volume: np.ndarray, labels: np.ndarray, spacing: Sequence[float],
                 pid: int, vol_case: str = "", lab_case: str = "",
                 tumor_value: int = 2) -> Dict:
    """Per-case metadata (reference extract.py:61-176): organ bbox, 3D tumor
    objects, and per-2D-slice tumor centers/stddevs (robust moments)/areas/
    bboxes with z→tumor reverse maps flattened into from_to run-length lists."""
    assert volume.shape == labels.shape, f"Vol{volume.shape} vs Lab{labels.shape}"
    disc3 = ndi.generate_binary_structure(3, connectivity=2)

    b = array_kits.extract_region(labels).tolist()
    # reference stores bbox as [x1, y1, z1, x2+1, y2+1, z2+1]
    bbox = [b[2], b[1], b[0], b[5] + 1, b[4] + 1, b[3] + 1]

    tumors, _ = ndi.label(labels == tumor_value, disc3)
    slices = ndi.find_objects(tumors)
    objects = [[z.start, y.start, x.start, z.stop, y.stop, x.stop]
               for z, y, x in slices]
    all_centers, all_stddevs, tumor_areas = [], [], []
    per_slice: Dict[int, List] = {}
    for j, sli in enumerate(slices):
        region = labels[sli] == tumor_value
        center, stddev = array_kits.compute_robust_moments(region, indexing="ij",
                                                           min_std=0.0)
        center = [center[0] + objects[j][0], center[1] + objects[j][1],
                  center[2] + objects[j][2]]
        all_centers.append([float(x) for x in center])
        all_stddevs.append([round(float(x), 3) for x in stddev])
        tumor_areas.append(int(np.count_nonzero(region)))
        for k in range(region.shape[0]):
            patch = region[k]
            if not patch.any():
                continue
            c2, s2 = array_kits.compute_robust_moments(patch, indexing="ij",
                                                       min_std=0.0)
            # bbox_from_mask returns x-first (x1, y1, x2, y2), inclusive
            x1, y1, x2, y2 = array_kits.bbox_from_mask(patch, mask_values=1).tolist()
            per_slice.setdefault(objects[j][0] + k, []).append({
                "tid": j,
                "center": [float(c2[0]) + objects[j][1], float(c2[1]) + objects[j][2]],
                "stddev": [round(float(x), 3) for x in s2],
                "area": int(np.count_nonzero(patch)),
                # reference stores [y1, x1, y2+1, x2+1] in volume coords
                "bbox": [y1 + objects[j][1], x1 + objects[j][2],
                         y2 + 1 + objects[j][1], x2 + 1 + objects[j][2]],
            })

    tumor_slices_indices = sorted(per_slice)
    from_to = [0]
    centers2, stddevs2, areas2, boxes2, tids2 = [], [], [], [], []
    for z in tumor_slices_indices:
        regions = per_slice[z]
        from_to.append(from_to[-1] + len(regions))
        for r in regions:
            centers2.append(r["center"])
            stddevs2.append(r["stddev"])
            areas2.append(r["area"])
            boxes2.append(r["bbox"])
            tids2.append(r["tid"])

    return {
        "PID": int(pid),
        "vol_case": str(vol_case),
        "lab_case": str(lab_case),
        "size": [int(x) for x in volume.shape],
        "spacing": [float(x) for x in spacing],
        "bbox": bbox,
        "tumors": objects,
        "tumor_areas": tumor_areas,
        "tumor_centers": all_centers,
        "tumor_stddevs": all_stddevs,
        "tumor_slices_from_to": from_to,
        "tumor_slices": boxes2,
        "tumor_slices_index": tumor_slices_indices,
        "tumor_slices_centers": centers2,
        "tumor_slices_stddevs": stddevs2,
        "tumor_slices_areas": areas2,
        "tumor_slices_tid": tids2,
    }


def window_clip_uint16(volume: np.ndarray, gray_min=GRAY_MIN, gray_max=GRAY_MAX,
                       scale=IM_SCALE) -> np.ndarray:
    """HU clip + scale to uint16 (reference extract.py:72): the online pipeline
    undoes the scale, so stored = (clip(v) - min) * scale."""
    return ((np.clip(volume, gray_min, gray_max) - gray_min) * scale).astype(np.uint16)


# Modality presets: value window + tumor label id
# - liver: LiTS CT (reference Liver/extract.py:32-33), tumor label 2
# - nf: neurofibroma MRI, gray range [0, 1000] (reference
#   NF/input_pipeline.py:45-46), lesion label 1
MODALITIES = {
    "liver": {"gray_min": GRAY_MIN, "gray_max": GRAY_MAX, "tumor_value": 2},
    "nf": {"gray_min": 0, "gray_max": 1000, "tumor_value": 1},
}


def extract_case(vol_path, dst_root: Path, only_meta: bool = False,
                 lits_quirk: bool = True, modality: str = "liver") -> Dict:
    """One NIfTI case → npy cache + meta dict.  With the LiTS quirk the
    y axis of volumes 28-47 and of labels 28-51 is flipped on read (the two
    ranges differ, reference extract.py:190-196)."""
    preset = MODALITIES[modality]
    vol_path = Path(vol_path)
    pid = int(vol_path.stem.split(".")[0].split("-")[-1])
    lab_path = vol_path.parent / vol_path.name.replace("volume", "segmentation")
    if lits_quirk and modality == "liver":
        vh, volume = nii_kits.read_nii(vol_path, out_dtype=np.int16,
                                       special=28 <= pid < 48)
        _, labels = nii_kits.read_nii(lab_path, out_dtype=np.uint8,
                                      special=28 <= pid < 52)
    else:
        vh, volume = nii_kits.read_nii(vol_path, out_dtype=np.int16)
        _, labels = nii_kits.read_nii(lab_path, out_dtype=np.uint8)
    spacing = list(vh.get_zooms()[::-1])[-3:]
    meta = process_case(volume, labels, spacing, pid, str(vol_path),
                        str(lab_path), tumor_value=preset["tumor_value"])
    if not only_meta:
        case_dir = Path(dst_root) / vol_path.stem.split(".")[0]
        case_dir.mkdir(parents=True, exist_ok=True)
        np.save(case_dir / "volume.npy",
                window_clip_uint16(volume, preset["gray_min"],
                                   preset["gray_max"]))
        np.save(case_dir / "segmentation.npy", labels)
    return meta


def extract_dataset(src_dir, dst_dir, only_meta: bool = False,
                    pattern: str = "volume-*.nii*", lits_quirk: bool = True,
                    modality: str = "liver") -> List[Dict]:
    """All cases → dst_dir/<case>/*.npy + dst_dir/meta.json
    (reference nii_3d_to_png, extract.py:190-213; NF/extract.py:36-710)."""
    src, dst = Path(src_dir), Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    cases = sorted(src.glob(pattern),
                   key=lambda x: int(x.stem.split(".")[0].split("-")[-1]))
    metas = [extract_case(c, dst, only_meta, lits_quirk, modality)
             for c in cases]
    metas.sort(key=lambda m: m["PID"])
    with (dst / "meta.json").open("w") as f:
        json.dump(metas, f)
    return metas


def load_meta(dataset_dir) -> List[Dict]:
    with (Path(dataset_dir) / "meta.json").open() as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Histogram context features (reference extract.py:340-374)
# ---------------------------------------------------------------------------

def guide_pixel_list(labels: np.ndarray, obj_val: int = 2,
                     tile_guide: bool = True) -> List[Tuple[np.ndarray, ...]]:
    """Per-slice (z, y, x) index lists of 'user-guided' pixels: each 3D tumor
    contributes its *middle slice* pixels, tiled across the tumor's z-range
    (reference utils/array_kits.py:780-880, guide='middle')."""
    disc3 = ndi.generate_binary_structure(3, connectivity=2)
    objs, n = ndi.label(labels == obj_val, disc3)
    per_slice: List[List[np.ndarray]] = [[] for _ in range(labels.shape[0])]
    for j, sli in enumerate(ndi.find_objects(objs)):
        z1, z2 = sli[0].start, sli[0].stop
        mid = (z2 - z1 - 1) // 2 + z1
        region = objs[mid][sli[1], sli[2]] == (j + 1)
        ys, xs = np.where(region)
        ys = ys + sli[1].start
        xs = xs + sli[2].start
        zs = range(z1, z2) if tile_guide else [mid]
        for z in zs:
            per_slice[z].append(np.stack([np.full_like(ys, z), ys, xs]))
    out = []
    for lst in per_slice:
        if lst:
            cat = np.concatenate(lst, axis=1)
            out.append((cat[0], cat[1], cat[2]))
        else:
            e = np.empty((0,), np.int64)
            out.append((e, e, e))
    return out


def case_hist_features(volume: np.ndarray, labels: np.ndarray, mode: str = "train",
                       bins: int = 100,
                       xrng: Tuple[float, float] = (GRAY_MIN + 50, GRAY_MAX - 50),
                       organ_val: int = 1, tumor_val: int = 2) -> np.ndarray:
    """Per-slice [2*bins] density histograms: organ region + tumor region
    (train = GT tumor pixels; eval = middle-slice simulated-guide pixels,
    reference dump_hist_feature_v2 extract.py:340-374). `volume` in HU."""
    if mode == "train":
        gpl = [np.where(sli == tumor_val) for sli in labels]
        gpl = [(np.full_like(g[0], k), g[0], g[1]) for k, g in enumerate(gpl)]
    else:
        gpl = guide_pixel_list(labels, obj_val=tumor_val, tile_guide=True)
    hists = np.zeros((volume.shape[0], bins * 2), np.float32)
    for k in range(volume.shape[0]):
        with np.errstate(invalid="ignore"):
            v1, _ = np.histogram(volume[k][labels[k] >= organ_val], bins=bins,
                                 range=xrng, density=True)
            v2, _ = np.histogram(volume[gpl[k][0], gpl[k][1], gpl[k][2]], bins=bins,
                                 range=xrng, density=True)
        hists[k, :bins] = np.nan_to_num(v1.astype(np.float32))
        hists[k, bins:] = np.nan_to_num(v2.astype(np.float32))
    return hists


def dump_hist_features(dataset_dir, out_dir=None, modes=("train", "eval"),
                       bins: int = 100,
                       xrng: Tuple[float, float] = (GRAY_MIN + 50, GRAY_MAX - 50),
                       gray_min: float = GRAY_MIN, organ_val: int = 1,
                       tumor_val: int = 2):
    """feat/hist/{train,eval}/<PID>.npy next to the npy cache.

    Reads the cached uint16 volumes and converts back to raw intensity before
    histogram (stored = (raw - gray_min) * IM_SCALE).  NF datasets pass
    gray_min=0 and organ_val=tumor_val=1 (the lesion label doubles as the
    region of interest; reference NF/extract.py hist menu)."""
    root = Path(dataset_dir)
    out = Path(out_dir) if out_dir else root / "feat" / "hist"
    metas = load_meta(root)
    for mode in modes:
        (out / mode).mkdir(parents=True, exist_ok=True)
    for m in metas:
        case_dir = root / f"volume-{m['PID']}"
        if not case_dir.exists():
            case_dir = root / Path(m["vol_case"]).stem.split(".")[0]
        volume = np.load(case_dir / "volume.npy").astype(np.float32) / IM_SCALE \
            + gray_min
        labels = np.load(case_dir / "segmentation.npy")
        for mode in modes:
            hists = case_hist_features(volume, labels, mode, bins, xrng,
                                       organ_val=organ_val,
                                       tumor_val=tumor_val)
            np.save(out / mode / ("%03d.npy" % m["PID"]), hists)
    return out


def gen_infer_context(dataset_dir, guide_file, bins: int = 100,
                      xrng: Tuple[float, float] = (GRAY_MIN + 50, GRAY_MAX - 50),
                      out_dir=None) -> List[str]:
    """Infer-time histogram context from REAL user interactions
    (reference gen_infer_context, Liver/extract.py:742-793): the user marks
    each tumor with an ellipse (center/stddev, z-range) in guide_file
    ({pid: {sid: [{center, stddev, z}]}}); pixels inside the ellipse
    (stddev scaled by the 0.7413 MAD factor) are tiled over the z-range and
    histogrammed like the eval-time guide features.  Writes
    feat/hist/infer/<PID>.npy."""
    root = Path(dataset_dir)
    with Path(guide_file).open() as f:
        guide_list = json.load(f)
    metas = {int(m["PID"]): m for m in load_meta(root)}
    out = Path(out_dir) if out_dir else root / "feat" / "hist" / "infer"
    out.mkdir(parents=True, exist_ok=True)

    written = []
    for pid_str, guide in guide_list.items():
        pid = int(pid_str)
        case = metas[pid]
        d, hgt, wid = case["size"]
        gpl: List[List[List[int]]] = [[[], [], []] for _ in range(d)]
        yy, xx = np.meshgrid(np.arange(hgt), np.arange(wid), indexing="ij")
        coords = np.stack([yy, xx], axis=-1)
        for sid_str, objs in guide.items():
            sid = int(sid_str)  # annotated slice: its pixels are tiled over z
            for t in objs:
                radii = np.asarray(t["stddev"], np.float64) / 0.7413
                inside = np.sum(((coords - np.asarray(t["center"])) / radii) ** 2,
                                axis=-1) <= 1
                pi, pj = np.where(inside)
                for m in range(t["z"][0], t["z"][1]):
                    if 0 <= m < d:
                        gpl[m][0].extend([sid] * len(pi))
                        gpl[m][1].extend(pi.tolist())
                        gpl[m][2].extend(pj.tolist())

        case_dir = root / f"volume-{pid}"
        volume = np.load(case_dir / "volume.npy").astype(np.float32) / IM_SCALE \
            + GRAY_MIN
        labels = np.load(case_dir / "segmentation.npy")
        hists = np.zeros((d, bins * 2), np.float32)
        for n in range(d):
            with np.errstate(invalid="ignore"):
                v1, _ = np.histogram(volume[n][labels[n] >= 1], bins=bins,
                                     range=xrng, density=True)
                v2, _ = np.histogram(volume[gpl[n][0], gpl[n][1], gpl[n][2]],
                                     bins=bins, range=xrng, density=True)
            hists[n, :bins] = np.nan_to_num(v1.astype(np.float32))
            hists[n, bins:] = np.nan_to_num(v2.astype(np.float32))
        path = out / ("%03d.npy" % pid)
        np.save(path, hists)
        written.append(str(path))
    return written


# ---------------------------------------------------------------------------
# Simulated user prior (reference extract.py:664-717)
# ---------------------------------------------------------------------------

def simulate_user_prior(metas: List[Dict], out_file=None) -> Dict:
    """Assume the user marks each tumor's middle slice with an ellipse
    (center + stddev) and provides its z-range."""
    all_prior: Dict[str, Dict] = {}
    for case in metas:
        case_dict: Dict[int, List] = {}
        for tid, tumor in enumerate(case["tumors"]):
            z1, _, _, z2, _, _ = tumor
            middle = (z2 - z1 - 1) // 2 + z1
            if middle not in case["tumor_slices_index"]:
                continue
            ind = case["tumor_slices_index"].index(middle)
            for j in range(case["tumor_slices_from_to"][ind],
                           case["tumor_slices_from_to"][ind + 1]):
                if case["tumor_slices_tid"][j] == tid:
                    case_dict.setdefault(middle, []).append({
                        "z": [z1, z2],
                        "center": case["tumor_slices_centers"][j],
                        "stddev": case["tumor_slices_stddevs"][j],
                    })
        all_prior[str(case["PID"])] = {str(k): v for k, v in case_dict.items()}
    if out_file is not None:
        out_file = Path(out_file)
        out_file.parent.mkdir(parents=True, exist_ok=True)
        with out_file.open("w") as f:
            json.dump(all_prior, f)
    return all_prior


def dump_glcm_features(dataset_dir, out_dir=None, modes=("train", "eval"),
                       **glcm_kwargs):
    """feat/glcm/{train,eval}/<PID>.npy GLCM context features
    (reference dump_glcm_feature_for_train/_eval, extract.py:377-661)."""
    from boxsegliver_torch.ops.glcm import case_glcm_features

    root = Path(dataset_dir)
    out = Path(out_dir) if out_dir else root / "feat" / "glcm"
    metas = load_meta(root)
    for mode in modes:
        (out / mode).mkdir(parents=True, exist_ok=True)
    for m in metas:
        case_dir = root / f"volume-{m['PID']}"
        volume = np.load(case_dir / "volume.npy").astype(np.float32) / IM_SCALE + GRAY_MIN
        for mode in modes:
            feats = case_glcm_features(volume, m, mode, **glcm_kwargs)
            np.save(out / mode / ("%03d.npy" % m["PID"]), feats)
    return out
