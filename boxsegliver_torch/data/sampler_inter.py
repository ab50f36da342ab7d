"""Host-side sampler for 2D interactive click-simulation training
(nf_inter; own numpy copy of boxsegliver_tpu/data/sampler_inter.py:58-387;
reference DataLoader/NF/input_pipeline_g_simply.py:564-641 ``gen_batch`` +
:530-561 ``gen_kernel``):

- tumor_percent of each batch is forced to NF cases, with the crop centered on
  a uniformly-sampled foreground voxel; optional sample_neg fraction centered
  on false-positive voxels from a negatives cache; the rest random.
- 2.5D channel stacks are center-cropped at a random zoom of the target size
  (misc.img_crop semantics, reference DataLoader/misc.py:108-130).
- Click simulation runs at CROP resolution on the binary label patch
  (interactive.clicks.inter_simulation): foreground strategy 0; background
  strategy 4 when the crop contains false positives (--fp_sample), else a fair
  coin between strategies 1 (band) and 3 (evenly surround)
  (reference gen_kernel, input_pipeline_g_simply.py:546-559).

The host resizes the pixel window to the target size and scales click
coordinates into target coordinates, shipping a ``rescale = crop/target``
factor so the device render (data/pipeline_inter.py) reproduces the
reference's crop-resolution guide values (Gaussian stddevs and Euclidean
distances are defined in crop pixels there).  The JAX package resizes with
OpenCV; the port's ops/image_ops.resize_linear_u16 is OpenCV's uint16
bilinear path in numpy (a pixel on a rounding tie may land one level off
OpenCV's) and labels go through the bit-exact nearest resize.  Given the
same RandomState, the batches' clicks, rescales and labels equal the JAX
sampler's.

``--geodesic`` adds the raw geodesic distance maps of the fg and bg clicks
(``fg_gd``, ``bg_gd``): the host C++ raster scan (csrc/native.py) on the
2x-downsampled, non-zero z-scored middle channel, upsampled back with
OpenCV's float32 bilinear (interactive/refine.render_geodesic_eval_guide,
which the click eval's geodesic guides share).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from boxsegliver_torch.data.kfold import (LITS_SEED, read_or_create_k_folds,
                                          train_test_split)
from boxsegliver_torch.data.meta import load_meta
from boxsegliver_torch.data.sampler import (CaseVolumes, DownsampledVolumes,
                                            ds_size)
from boxsegliver_torch.interactive.clicks import inter_simulation
from boxsegliver_torch.interactive.refine import render_geodesic_eval_guide
from boxsegliver_torch.ops.image_ops import resize_linear_u16, resize_nearest

# Fixed simulator constants (reference gen_kernel,
# input_pipeline_g_simply.py:546-559)
CLICK_MARGIN = 3
CLICK_STEP = 10
CLICK_N = 5
BG_BAND = 40
# Validation batches use a fixed zoom + seed (reference gen_batch:593-595)
EVAL_ZOOM = 1.125
EVAL_SEED = 1234


def _center_crop_bounds(center: int, crop: int, size: int) -> int:
    """misc.img_crop window origin: clamp [center - crop//2, ...] into range."""
    return int(min(max(center - crop // 2, 0), max(size - crop, 0)))


class InterSampler:
    """Infinite batch sampler emitting host-resized windows + padded click
    arrays for the device processing (pipeline_inter)."""

    def __init__(self, dataset_dir, args, mode: str = "train",
                 pids: Optional[Sequence[int]] = None,
                 seed: Optional[int] = None, max_clicks: int = 8):
        self.root = Path(dataset_dir)
        self.args = args
        metas = load_meta(self.root)
        if pids is None:
            folds = read_or_create_k_folds(
                self.root / "k_folds.txt", [m["PID"] for m in metas],
                k_split=getattr(args, "k_folds", 5), seed=LITS_SEED)
            train, test = train_test_split(folds, args.test_fold)
            pids = [int(p) for p in (train if mode == "train" else test)]
        pid_set = set(int(p) for p in pids)
        self.metas: List[Dict] = [m for m in metas if int(m["PID"]) in pid_set]
        if not self.metas:
            raise ValueError(f"No cases for mode={mode} in {dataset_dir}")
        self.downsampling = bool(getattr(args, "downsampling", False))
        self.vols = (DownsampledVolumes(self.root) if self.downsampling
                     else CaseVolumes(self.root))
        self.mode = mode
        self.train = mode == "train"
        self.rng = np.random.RandomState(EVAL_SEED if not self.train else seed)

        self.target = (args.im_height, args.im_width)
        self.channel = args.im_channel
        self.zoom = (tuple(args.zoom_scale) if self.train
                     else (EVAL_ZOOM, EVAL_ZOOM))
        self.max_clicks = max_clicks
        self.geodesic = bool(getattr(args, "geodesic", False))
        self.fp_sample = bool(getattr(args, "fp_sample", False)) and self.train
        self.sample_neg = float(getattr(args, "sample_neg", 0.0) or 0.0)

        # per-case foreground-voxel sampling tables: slice ids + per-slice
        # areas (→ area-weighted slice choice + uniform in-slice pixel =
        # uniform over all fg voxels, like the reference's data['pos'] choice)
        self.nf_idx: List[int] = []
        self._fg_slices: Dict[int, np.ndarray] = {}
        self._fg_weights: Dict[int, np.ndarray] = {}
        for i, m in enumerate(self.metas):
            sids = np.asarray(m["tumor_slices_index"], np.int64)
            if sids.size:
                self.nf_idx.append(i)
                ft = m["tumor_slices_from_to"]
                areas = np.asarray(m["tumor_slices_areas"], np.float64)
                per_slice = np.array([areas[ft[k]:ft[k + 1]].sum()
                                      for k in range(len(sids))])
                self._fg_slices[i] = sids
                self._fg_weights[i] = per_slice / per_slice.sum()

        self._neg: Dict[int, Optional[np.ndarray]] = {}
        self._neg_tables: Dict[int, Optional[Dict]] = {}

    # -- negatives cache (reference load_neg[_v2], --fp_version,
    # input_pipeline_g_simply.py:207-335) --
    def _neg_volume(self, pid: int) -> Optional[np.ndarray]:
        if pid not in self._neg:
            sub = ("neg" if int(getattr(self.args, "fp_version", 1)) == 1
                   else "neg_v2")
            path = self.root / sub / f"volume-{pid}.npy"
            neg = np.load(path, mmap_mode="r") if path.exists() else None
            if neg is not None and self.downsampling:
                neg = neg[:, ::2, ::2]  # keep FP coords in ds space
            self._neg[pid] = neg
        return self._neg[pid]

    def _neg_table(self, pid: int) -> Optional[Dict]:
        """Per-slice FP-voxel counts for uniform FP-voxel sampling."""
        if pid not in self._neg_tables:
            neg = self._neg_volume(pid)
            if neg is None:
                self._neg_tables[pid] = None
            else:
                counts = np.asarray(neg, np.uint8).reshape(neg.shape[0], -1)\
                    .astype(np.int64).sum(axis=1)
                sids = np.where(counts > 0)[0]
                w = counts[sids].astype(np.float64)
                self._neg_tables[pid] = ({"sids": sids, "w": w / w.sum()}
                                         if sids.size else None)
        return self._neg_tables[pid]

    # -- sampling helpers ----------------------------------------------------
    def _sample_fg_voxel(self, rng, case_idx: int):
        sids = self._fg_slices[case_idx]
        sid = int(sids[rng.choice(len(sids), p=self._fg_weights[case_idx])])
        pid = int(self.metas[case_idx]["PID"])
        lab = self.vols.label(pid)
        ys, xs = np.nonzero(np.asarray(lab[sid]) > 0)
        j = rng.choice(ys.size)
        return sid, int(ys[j]), int(xs[j])

    def _sample_fp_voxel(self, rng, case_idx: int):
        pid = int(self.metas[case_idx]["PID"])
        table = self._neg_table(pid)
        if table is None:
            return None
        sid = int(table["sids"][rng.choice(len(table["sids"]), p=table["w"])])
        neg = self._neg_volume(pid)
        ys, xs = np.nonzero(np.asarray(neg[sid]) > 0)
        j = rng.choice(ys.size)
        return sid, int(ys[j]), int(xs[j])

    def _stack(self, pid: int, sid: int, y1: int, x1: int, crop):
        """Center-cropped 2.5D window → host-resized [H, W, C] uint16 +
        [H, W] uint8 binary label + crop-resolution label patch (for clicks)."""
        vol = self.vols.volume(pid)
        lab = self.vols.label(pid)
        depth = vol.shape[0]
        ch = self.channel
        lh = ch // 2
        h, w = self.target
        win = np.zeros((crop[0], crop[1], ch), np.uint16)
        pad_mask = np.zeros((ch,), np.float32)
        for k in range(ch):
            z = sid - lh + k
            if 0 <= z < depth:
                win[..., k] = vol[z, y1:y1 + crop[0], x1:x1 + crop[1]]
                pad_mask[k] = 1.0
        lab_patch = np.clip(np.asarray(lab[sid, y1:y1 + crop[0],
                                           x1:x1 + crop[1]]), 0, 1).astype(np.uint8)
        img = resize_linear_u16(win, (h, w))
        lab_out = resize_nearest(torch.from_numpy(lab_patch), (h, w)).numpy()
        return img, np.ascontiguousarray(lab_out), lab_patch, pad_mask

    # -- batch ---------------------------------------------------------------
    def _geodesic_maps(self, img_u16: np.ndarray, pts: np.ndarray):
        """Geodesic guide at target resolution (reference data_processing
        geodesic branch, input_pipeline_g_simply.py:478-496): the raster
        scan on the 2x-downsampled z-scored middle channel from the halved
        clicks, upsampled back; zeros without clicks."""
        if pts.shape[0] == 0:
            return np.zeros(self.target, np.float32)
        img = img_u16[..., self.channel // 2].astype(np.float32)
        nz = img > 0
        n = max(int(nz.sum()), 1)
        mean = float(img[nz].sum()) / n
        sd = math.sqrt(max(float(((img - mean) ** 2)[nz].sum()) / n, 1e-12))
        img = (img - nz * mean) / (nz * sd + 1e-8)
        return render_geodesic_eval_guide(img, pts)

    def sample_batch(self, batch_size: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        args = self.args
        h, w = self.target
        target = np.asarray(self.target, np.float32)
        force_tumor = math.ceil(batch_size * args.tumor_percent)
        force_fp = math.ceil(batch_size * self.sample_neg) if self.sample_neg else 0

        n_cases = len(self.metas)
        nf_pool = self.nf_idx or list(range(n_cases))
        picks = []  # (case_idx, flag)
        chosen = rng.choice(len(nf_pool), size=min(force_tumor, len(nf_pool)),
                            replace=False)
        picks += [(nf_pool[c], 1) for c in chosen]
        while len(picks) < force_tumor:  # tiny datasets: fall back to replace
            picks.append((nf_pool[int(rng.choice(len(nf_pool)))], 1))
        for c in rng.choice(len(nf_pool), size=min(force_fp, len(nf_pool)),
                            replace=False):
            picks.append((nf_pool[c], 2))
        while len(picks) < batch_size:
            picks.append((int(rng.choice(n_cases)), 0))
        picks = picks[:batch_size]

        mc = self.max_clicks
        out = {
            "image": np.zeros((batch_size, h, w, self.channel), np.uint16),
            "label": np.zeros((batch_size, h, w), np.uint8),
            "pad_mask": np.zeros((batch_size, self.channel), np.float32),
            "fg_pts": np.full((batch_size, mc, 2), -1.0, np.float32),
            "bg_pts": np.full((batch_size, mc, 2), -1.0, np.float32),
            "n_fg": np.zeros((batch_size,), np.int32),
            "n_bg": np.zeros((batch_size,), np.int32),
            "rescale": np.ones((batch_size, 2), np.float32),
            "names": np.zeros((batch_size,), np.int32),
        }
        if self.geodesic:
            out["fg_gd"] = np.zeros((batch_size, h, w), np.float32)
            out["bg_gd"] = np.zeros((batch_size, h, w), np.float32)

        for j, (ci, flag) in enumerate(picks):
            case = self.metas[ci]
            pid = int(case["PID"])
            depth, height, width = ds_size(case["size"], self.downsampling)
            crop = (target * rng.uniform(self.zoom[0], self.zoom[1],
                                         size=2)).astype(np.int32)
            crop = (int(min(crop[0], height)), int(min(crop[1], width)))

            if flag == 1:
                sid, py, px = self._sample_fg_voxel(rng, ci)
            elif flag == 2:
                fp = self._sample_fp_voxel(rng, ci)
                if fp is None:
                    sid = rng.randint(depth)
                    py, px = rng.randint(height), rng.randint(width)
                else:
                    sid, py, px = fp
            else:
                sid = rng.randint(depth)
                py, px = rng.randint(height), rng.randint(width)

            y1 = _center_crop_bounds(py, crop[0], height)
            x1 = _center_crop_bounds(px, crop[1], width)
            img, lab_out, lab_patch, pad = self._stack(pid, sid, y1, x1, crop)

            neg_patch = None
            if self.fp_sample:
                neg = self._neg_volume(pid)
                if neg is not None:
                    neg_patch = np.asarray(neg[sid, y1:y1 + crop[0],
                                               x1:x1 + crop[1]])

            # click simulation at crop resolution (gen_kernel semantics)
            is_nf = ci in self._fg_slices
            if is_nf and lab_patch.max() > 0:
                fg = inter_simulation(lab_patch, margin=CLICK_MARGIN,
                                      step=CLICK_STEP, N=CLICK_N, bg=False,
                                      strategy=0, rng=rng)
            else:
                fg = np.zeros((0, 2), np.float32)
            if neg_patch is not None and neg_patch.max() > 0:
                strategy = 4
            elif rng.random_sample() > 0.5:
                strategy = 1
            else:
                strategy = 3
            bg = inter_simulation((1 - lab_patch).astype(np.uint8),
                                  margin=CLICK_MARGIN, step=CLICK_STEP,
                                  N=CLICK_N, bg=True, d=BG_BAND,
                                  strategy=strategy, neg_patch=neg_patch,
                                  rng=rng)

            scale = target / np.asarray(crop, np.float32)  # crop → target
            fg_t = (fg * scale)[:mc]
            bg_t = (bg * scale)[:mc]
            out["image"][j] = img
            out["label"][j] = lab_out
            out["pad_mask"][j] = pad
            out["names"][j] = pid
            out["rescale"][j] = 1.0 / scale
            out["n_fg"][j] = fg_t.shape[0]
            out["n_bg"][j] = bg_t.shape[0]
            if fg_t.shape[0]:
                out["fg_pts"][j, :fg_t.shape[0]] = fg_t
            if bg_t.shape[0]:
                out["bg_pts"][j, :bg_t.shape[0]] = bg_t
            if self.geodesic:
                out["fg_gd"][j] = self._geodesic_maps(img, fg_t)
                out["bg_gd"][j] = self._geodesic_maps(img, bg_t)
        return out


def _load_pred(path) -> np.ndarray:
    from boxsegliver_torch.data import nii as nii_kits
    if path.suffix == ".npz":
        return np.load(path)["arr_0"]
    _, pred = nii_kits.read_nii(path, out_dtype=np.uint8)
    return pred


def build_neg_cache(pred_dirs, dataset_dir, min_size: int = 5) -> List[Path]:
    """Build the false-positive negatives cache from saved predictions
    (reference load_neg, input_pipeline_g_simply.py:207-262, dim=2): per
    slice, 2D-connected components of the prediction that do not touch the
    ground truth and are larger than `min_size` pixels.  Written as
    ``<dataset>/neg/volume-<pid>.npy`` uint8 masks consumed by InterSampler
    (--fp_sample / --sample_neg).

    pred_dirs: one directory, or several — with several, each case's
    prediction is the UNION over the dirs before component analysis
    (reference load_neg_v2, input_pipeline_g_simply.py:265-335, the
    --fp_version 2 cache built from five checkpoints' predictions).
    version selects the on-disk cache name (neg/ vs neg_v2/), matching the
    reference's neg_2d vs neg_2d_v2 pickles selected by --fp_version."""
    from scipy import ndimage as ndi

    if isinstance(pred_dirs, (str, Path)):
        pred_dirs = [pred_dirs]
    pred_dirs = [Path(p) for p in pred_dirs]
    version = 2 if len(pred_dirs) > 1 else 1
    root = Path(dataset_dir)
    out_dir = root / ("neg" if version == 1 else "neg_v2")
    out_dir.mkdir(parents=True, exist_ok=True)
    struct = ndi.generate_binary_structure(2, 1)
    written = []
    for path in sorted(pred_dirs[0].glob("predict-*.nii*")) + \
            sorted(pred_dirs[0].glob("predict-*.npz")):
        pid = int(path.name.split(".")[0].split("-")[-1])
        pred = (_load_pred(path) > 0).astype(np.uint8)
        for extra in pred_dirs[1:]:
            other = extra / path.name
            if other.exists():
                pred |= (_load_pred(other) > 0).astype(np.uint8)
        lab = np.load(root / f"volume-{pid}" / "segmentation.npy",
                      mmap_mode="r")
        result = np.zeros(pred.shape, np.uint8)
        for s in np.where(pred.max(axis=(1, 2)))[0]:
            comp, _ = ndi.label(pred[s] > 0, struct)
            gt = np.asarray(lab[s]) > 0
            for sli, i in zip(ndi.find_objects(comp),
                              range(1, comp.max() + 1)):
                if sli is None:
                    continue
                m = comp[sli] == i
                if (m & gt[sli]).any() or m.sum() <= min_size:
                    continue
                result[s][sli][m] = 1
        out = out_dir / f"volume-{pid}.npy"
        np.save(out, result)
        written.append(out)
    return written
