"""3D patch sampler for UNet3D training (own copy of
boxsegliver_tpu/data/sampler3d.py:28-171; host numpy, the same draws).

Re-implements the decisions of the reference 3D generator (reference
DataLoader/NF/input_pipeline_3d.py:544-614 ``gen_batch`` + misc.volume_crop
DataLoader/misc.py:131-143): tumor-centered sampling (a random foreground
voxel becomes the patch center) with tumor_percent forcing, center-clamped
volume crops, and simulated 3D clicks (foreground from tumor voxels,
background from a surrounding band) padded to static [max_clicks, 3] arrays.

Pixel work (z-score, guide rendering, flips, gamma) runs on the device
(data/pipeline3d.make_preprocess_fn_3d).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage as ndi

from boxsegliver_torch.data.kfold import (LITS_SEED, read_or_create_k_folds,
                                          train_test_split)
from boxsegliver_torch.data.meta import load_meta
from boxsegliver_torch.data.sampler import CaseVolumes, DownsampledVolumes


def volume_crop(shape: Tuple[int, int, int], center, crop: Tuple[int, int, int]):
    """Center-clamped crop slices (reference misc.volume_crop,
    DataLoader/misc.py:131-143)."""
    starts = []
    for c, s, cs in zip(center, shape, crop):
        lo = min(max(c - cs // 2, 0), max(s - cs, 0))
        starts.append(int(lo))
    return tuple(slice(lo, lo + cs) for lo, cs in zip(starts, crop))


class Sampler3D:
    """Infinite 3D patch batch sampler over the npy cache."""

    def __init__(self, dataset_dir, args, mode: str = "train",
                 pids: Optional[Sequence[int]] = None,
                 seed: Optional[int] = None, cascade2d=None):
        """cascade2d: interactive.cascade.CascadeClick2D for the frozen-2D
        cascade channel (--use_cascade --use_2d, reference gen_kernel,
        input_pipeline_3d.py:508-534); without it --use_cascade uses the
        GT-oracle channel."""
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
        self.metas = [m for m in metas if int(m["PID"]) in pid_set]
        if not self.metas:
            raise ValueError(f"No cases for mode={mode} in {dataset_dir}")
        self.vols = (DownsampledVolumes(self.root)
                     if getattr(args, "downsampling", False)
                     else CaseVolumes(self.root))
        self.rng = np.random.RandomState(seed)
        self.patch = (args.im_depth if args.im_depth > 0 else 8,
                      args.im_height, args.im_width)
        self.use_spatial = bool(getattr(args, "use_spatial", False))
        self.use_cascade = bool(getattr(args, "use_cascade", False))
        self.cascade_binary = bool(getattr(args, "cascade_binary", False))
        self.cascade2d = cascade2d
        self.max_clicks = int(getattr(args, "max_objs", 8))
        self.tumor_cases = [i for i, m in enumerate(self.metas) if m["tumors"]]
        # cache foreground voxel lists lazily
        self._fg_cache: Dict[int, np.ndarray] = {}

    def _fg_voxels(self, pid: int) -> np.ndarray:
        if pid not in self._fg_cache:
            lab = self.vols.label(pid)
            self._fg_cache[pid] = np.argwhere(np.asarray(lab) == 2)
        return self._fg_cache[pid]

    def _clicks(self, lab_patch: np.ndarray, rng: np.random.RandomState):
        """fg clicks from tumor voxels, bg clicks from a surrounding band."""
        K = self.max_clicks
        fg = -np.ones((K, 3), np.float32)
        bg = -np.ones((K, 3), np.float32)
        tumor = lab_patch == 2 if (lab_patch == 2).any() else lab_patch > 0
        n_fg = 0
        if tumor.any():
            vox = np.argwhere(tumor)
            n_fg = min(rng.randint(1, K + 1), len(vox))
            sel = rng.choice(len(vox), n_fg, replace=False)
            fg[:n_fg] = vox[sel]
            band = ndi.binary_dilation(tumor, iterations=6) & ~ndi.binary_dilation(
                tumor, iterations=2)
            bvox = np.argwhere(band)
            n_bg = min(rng.randint(0, K + 1), len(bvox))
            if n_bg:
                sel = rng.choice(len(bvox), n_bg, replace=False)
                bg[:n_bg] = bvox[sel]
        return fg, bg

    def sample_batch(self, batch_size: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        d, h, w = self.patch
        force_tumor = math.ceil(batch_size * self.args.tumor_percent)
        out = {
            "patch": np.zeros((batch_size, d, h, w), np.uint16),
            "label": np.zeros((batch_size, d, h, w), np.uint8),
            "names": np.zeros((batch_size,), np.int32),
        }
        need_clicks = self.use_spatial or self.use_cascade
        if need_clicks:
            out["fg_pts"] = -np.ones((batch_size, self.max_clicks, 3), np.float32)
            out["bg_pts"] = -np.ones((batch_size, self.max_clicks, 3), np.float32)
        if self.use_cascade:
            out["cascade"] = np.zeros((batch_size, d, h, w), np.float32)

        for j in range(batch_size):
            if j < force_tumor and self.tumor_cases:
                mi = self.tumor_cases[rng.randint(len(self.tumor_cases))]
            else:
                mi = rng.randint(len(self.metas))
            meta = self.metas[mi]
            pid = int(meta["PID"])
            vol = self.vols.volume(pid)
            lab = self.vols.label(pid)
            shape = vol.shape
            if j < force_tumor and meta["tumors"]:
                vox = self._fg_voxels(pid)
                if len(vox):
                    center = vox[rng.randint(len(vox))]
                else:
                    center = [rng.randint(s) for s in shape]
            else:
                center = [rng.randint(s) for s in shape]
            sl = volume_crop(shape, center, self.patch)
            vp = np.zeros((d, h, w), np.uint16)
            lp = np.zeros((d, h, w), np.uint8)
            src = vol[sl]
            vp[:src.shape[0], :src.shape[1], :src.shape[2]] = src
            srcl = lab[sl]
            lp[:srcl.shape[0], :srcl.shape[1], :srcl.shape[2]] = srcl
            out["patch"][j] = vp
            out["label"][j] = lp
            out["names"][j] = pid
            if need_clicks:
                fg, bg = self._clicks(lp, rng)
                out["fg_pts"][j] = fg
                out["bg_pts"][j] = bg
                if self.use_cascade:
                    out["cascade"][j] = self._cascade_channel(vp, lp, fg, bg)
        if not self.use_spatial and need_clicks:
            # clicks were only needed to place the cascade channel
            out.pop("fg_pts")
            out.pop("bg_pts")
        return out

    def _cascade_channel(self, vp: np.ndarray, lp: np.ndarray,
                         fg: np.ndarray, bg: np.ndarray) -> np.ndarray:
        """Frozen-2D or GT-oracle extra channel (reference gen_kernel,
        input_pipeline_3d.py:508-534)."""
        from boxsegliver_torch.interactive.cascade import gt_cascade_channel

        if self.cascade2d is not None:
            return self.cascade2d.extra_channel_from_clicks(
                vp, fg, bg, binary=self.cascade_binary)
        return gt_cascade_channel((lp > 0).astype(np.uint8), fg,
                                  binary=self.cascade_binary)
