"""Host-side nf2 / IIN training sampler: click-instance crops + patch
context (own numpy copy of boxsegliver_tpu/data/sampler_iin.py; reference
DataLoader/NF/input_pipeline_iin.py:486-618 ``gen_train_batch``):
class-balanced tumor forcing, random zoom crop windows centred on a sampled
lesion pixel (the "click"), per-instance binary labels from connected
components, a random window level (0, 500..700) or z-score, the click's
``sp_center`` / ``sp_std`` / ``sp_on``, and the multi-scale image-patch
context pyramid (``--ct_base`` sizes around the click, each resized to
32 x 32).

The host copies and resizes uint16 windows; the pixel math (normalize, the
click guide by kernel B1, the context normalization, gamma / noise / flips)
runs on the device (data/pipeline_iin.py).  JAX resizes with OpenCV; the
port with ops/image_ops: resize_linear_u16 (OpenCV's uint16 INTER_LINEAR,
a rounding tie may land one level off) and cv2's nearest index for the
label.  Given the same RandomState the draws are JAX's, draw for draw; the
JAX module's docstring lists where both deviate from the reference.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage as ndi

from boxsegliver_torch.data.kfold import (LITS_SEED, read_or_create_k_folds,
                                          train_test_split)
from boxsegliver_torch.data.meta import IM_SCALE, load_meta
from boxsegliver_torch.data.sampler import (CaseVolumes, _randint,
                                            compact_case, host_window)
from boxsegliver_torch.models.layers import CT_PATCH, ct_sizes
from boxsegliver_torch.ops.image_ops import resize_linear_u16


def extract_ct_pyramid(plane: np.ndarray, y: int, x: int,
                       sizes: Tuple[int, int, int]) -> np.ndarray:
    """[32, 32, 3] uint16 pyramid of `sizes`-px patches of one slice around
    (y, x), each clamped inside the slice and resized to 32x32 (reference
    eval-path extraction, input_pipeline_iin.py:825-835)."""
    h, w = plane.shape
    out = np.zeros((CT_PATCH, CT_PATCH, len(sizes)), np.uint16)
    for k, s in enumerate(sizes):
        s = min(s, h, w)
        oy = min(h - s, max(0, y - s // 2))
        ox = min(w - s, max(0, x - s // 2))
        patch = np.ascontiguousarray(plane[oy:oy + s, ox:ox + s])
        if s != CT_PATCH:
            patch = resize_linear_u16(patch, (CT_PATCH, CT_PATCH))
        out[..., k] = patch
    return out


class IinSampler:
    """Infinite class-balanced click-instance batch sampler (task nf2)."""

    def __init__(self, dataset_dir, args, mode: str = "train",
                 pids: Optional[Sequence[int]] = None,
                 seed: Optional[int] = None,
                 tumor_percent: Optional[float] = None,
                 spatial_random: Optional[float] = None):
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
        self.cases: List[Dict] = [compact_case(m) for m in metas
                                  if int(m["PID"]) in pid_set]
        # filter_size: drop per-slice objects smaller than the threshold
        # (reference _get_datasets parse(), input_pipeline_iin.py:141-150)
        fs = int(getattr(args, "filter_size", 0))
        if fs > 0:
            for m, case in zip([m for m in metas if int(m["PID"]) in pid_set],
                               self.cases):
                areas = m["tumor_slices_areas"]
                ft = m["tumor_slices_from_to"]
                keep_i, keep_s, keep_c, keep_d = [], [], [], []
                for ind, sid in enumerate(case["tumor_slices_index"]):
                    sel = [k for k in range(ft[ind + 1] - ft[ind])
                           if areas[ft[ind] + k] > fs]
                    if sel:
                        keep_i.append(sid)
                        keep_s.append([case["slices"][ind][k] for k in sel])
                        keep_c.append([case["centers"][ind][k] for k in sel])
                        keep_d.append([case["stddevs"][ind][k] for k in sel])
                case["tumor_slices_index"] = keep_i
                case["slices"] = keep_s
                case["centers"] = keep_c
                case["stddevs"] = keep_d
        self.vols = CaseVolumes(self.root)
        self.mode = mode
        self.rng = np.random.RandomState(seed)
        self.target = (args.im_height, args.im_width)
        self.channel = args.im_channel
        self.zoom = tuple(args.zoom_scale)
        # eval_online uses the same generator with tumor_percent=0 and
        # spatial_random=1 (reference get_dataset_for_eval_online,
        # input_pipeline_iin.py:658-672)
        self.tumor_percent = (args.tumor_percent if tumor_percent is None
                              else tumor_percent)
        self.spatial_random = (getattr(args, "spatial_random", 1.0)
                               if spatial_random is None else spatial_random)
        self.use_context = bool(getattr(args, "use_context", False))
        self.use_spatial = bool(getattr(args, "use_spatial", False))
        self.ct_sizes = ct_sizes(getattr(args, "ct_base", [32]))
        self.tumor_cases = [i for i, c in enumerate(self.cases)
                            if c["tumor_slices_index"]]
        if not self.cases:
            raise ValueError(f"No cases for mode={mode} in {dataset_dir}")

    # ------------------------------------------------------------------

    def _click_pixel(self, lab_plane: np.ndarray, bb,
                     rng: np.random.RandomState) -> Tuple[int, int]:
        """Random lesion pixel inside the chosen object's bbox (the reference
        samples from the instance pixel list, input_pipeline_iin.py:546-548)."""
        y1, x1, y2, x2 = [int(v) for v in bb]
        ys, xs = np.nonzero(lab_plane[y1:y2, x1:x2])
        if ys.size == 0:  # degenerate bbox: fall back to its center
            return (y1 + y2) // 2, (x1 + x2) // 2
        k = rng.randint(ys.size)
        return y1 + int(ys[k]), x1 + int(xs[k])

    def _instance_mask(self, lab_plane: np.ndarray, y: int, x: int
                       ) -> np.ndarray:
        """Binary mask of the connected lesion component containing the click
        (the reference's `lab == t_id` with instance-coded labels,
        input_pipeline_iin.py:579-580)."""
        labeled, _ = ndi.label(lab_plane > 0,
                               ndi.generate_binary_structure(2, 2))
        tid = labeled[y, x]
        if tid == 0:
            return (lab_plane > 0).astype(np.uint8)
        return (labeled == tid).astype(np.uint8)

    # ------------------------------------------------------------------

    def sample_batch(self, batch_size: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        args = self.args
        h, w = self.target
        target = np.asarray(self.target, np.float32)
        force_tumor = math.ceil(batch_size * self.tumor_percent)

        ci1 = rng.choice(self.tumor_cases or [0], force_tumor, True)
        ci2 = rng.choice(len(self.cases), batch_size - force_tumor, True)
        ci = np.concatenate([ci1, ci2])

        out = {
            "image": np.zeros((batch_size, h, w, self.channel), np.uint16),
            "label": np.zeros((batch_size, h, w), np.uint8),
            "clip": np.zeros((batch_size, 2), np.float32),
            "pad_mask": np.zeros((batch_size, self.channel), np.float32),
            "names": np.zeros((batch_size,), np.int32),
        }
        if self.use_context:
            out["ct_patch"] = np.zeros(
                (batch_size, CT_PATCH, CT_PATCH, len(self.ct_sizes)), np.uint16)
            out["ct_on"] = np.zeros((batch_size,), np.float32)
        if self.use_spatial:
            out["sp_center"] = np.zeros((batch_size, 2), np.float32)
            out["sp_std"] = np.ones((batch_size, 2), np.float32)
            out["sp_on"] = np.zeros((batch_size,), np.float32)

        tumor_counter = 0
        for j, i in enumerate(ci):
            case = self.cases[i]
            size = case["size"]
            pid = case["PID"]
            crop = (target * rng.uniform(*self.zoom, size=2)).astype(np.int32)
            crop = (int(min(crop[0], size[1])), int(min(crop[1], size[2])))

            # slice + click selection (reference :536-551); non-forced draws
            # STILL click a lesion when the random slice happens to contain
            # one (reference :544-548) — this is what keeps the
            # tumor_percent=0 eval_online generator non-degenerate
            t_slices = case["tumor_slices_index"]
            ind = -1
            if tumor_counter < force_tumor and t_slices:
                ind = rng.randint(len(t_slices))
                sid = int(t_slices[ind])
                tumor_counter += 1
            else:
                sid = _randint(rng, 0, size[0] - 1)
                if sid in t_slices:
                    ind = t_slices.index(sid)
            if ind >= 0:
                obj = _randint(rng, 0, len(case["slices"][ind]) - 1)
                lab_plane = np.asarray(self.vols.label(pid)[sid])
                y, x = self._click_pixel(lab_plane, case["slices"][ind][obj],
                                         rng)
                instance = self._instance_mask(lab_plane, y, x)
            else:
                y = _randint(rng, 0, size[1] - 1)
                x = _randint(rng, 0, size[2] - 1)
                instance = None  # background sample: all-zero label (:581-582)

            off_y = min(size[1] - crop[0], max(0, y - crop[0] // 2))
            off_x = min(size[2] - crop[1], max(0, x - crop[1] // 2))

            img, lab, pad = host_window(self.vols.volume(pid), instance, sid,
                                        (off_y, off_x), crop, self.channel,
                                        self.target)
            out["image"][j] = img
            out["label"][j] = lab
            out["pad_mask"][j] = pad
            out["names"][j] = pid
            if getattr(args, "zscore", False):
                out["clip"][j] = (0.0, 1000.0 * IM_SCALE)  # unused by z-score
            else:
                # random window level (reference :586-588)
                out["clip"][j] = (0.0, _randint(rng, 500, 700) * IM_SCALE)

            use_guide = (rng.random_sample() < self.spatial_random) \
                if (self.use_context or self.use_spatial) else False
            guided = use_guide and instance is not None
            if self.use_context and guided:
                vol = self.vols.volume(pid)
                out["ct_patch"][j] = extract_ct_pyramid(
                    np.asarray(vol[sid]), y, x, self.ct_sizes)
                out["ct_on"][j] = 1.0
            if self.use_spatial and guided:
                # click center scaled crop -> target; stddev stays in target
                # pixel units (reference sp_coord, :609-616)
                out["sp_center"][j] = (
                    (y - off_y) / max(crop[0] - 1, 1) * (h - 1),
                    (x - off_x) / max(crop[1] - 1, 1) * (w - 1))
                out["sp_std"][j] = (args.guide_scale, args.guide_scale)
                out["sp_on"][j] = 1.0
        return out
