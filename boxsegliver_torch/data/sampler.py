"""Host-side training sampler: class-balanced case/slice/crop selection
(own numpy copy of boxsegliver_tpu/data/sampler.py:55-446, with the
``-ds`` view DownsampledVolumes / ds_size of :99-114; reference
DataLoader/Liver/input_pipeline_g.py:415-599 ``gen_train_batch``):
tumor%/liver% forced sampling, random zoom crop windows, object-aware crop
offsets, 2.5D slice stacks with zero padding, random window-level, histogram
context with noise, and spatial-guide moments with center/stddev
perturbation and inner-random tumor subsets.

The host only touches metadata and copies a fixed-size uint16 window out of
a memory-mapped volume; the pixel math runs on the device
(data/pipeline._process_batch).  Ragged per-slice tumor lists become
(max_objs)-padded arrays + counts.

Three layouts, as in the JAX package: the host layout (``resize_on_host=
True``: each zoom window resized on the host to the target, the image with
ops/image_ops.resize_linear_u16 — OpenCV's uint16 INTER_LINEAR without
OpenCV — and the label with cv2's nearest index), the device-resize layout
(``window`` + ``crop_hw``) and the index layout (``zidx``, with a
data/device_cache.DeviceVolumeCache).  JAX defaults to the host layout; the
port's training takes the device layout (the default here) and its online
2-D eval the host layout, as JAX's CLI builds it (cli/main.py:366).  Given
the same RandomState, every layout draws exactly what the JAX sampler
draws.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from boxsegliver_torch.data.kfold import (LITS_SEED, read_or_create_k_folds,
                                          train_test_split)
from boxsegliver_torch.data.meta import IM_SCALE, load_meta
from boxsegliver_torch.ops.image_ops import resize_linear_u16, resize_nearest

# Fixed window-level clip in stored uint16 units (reference gen_train_batch:
# input_pipeline_g.py:519-523; stored = (HU + 250) * IM_SCALE)
FIXED_CLIP = (50.0 * IM_SCALE, 500.0 * IM_SCALE)

# Pre-computed per-dimension GLCM train-noise scales — data constants from the
# reference (~1% of each feature's 2.5-97.5 percentile span,
# input_pipeline_g.py:58-69) for the default 96-dim "all" layout; other
# layouts fall back to the table's mean magnitude (see _sample_context).
GLCM_NOISE_SCALE = np.array(
    [0.0004, 0.0008, 0.0005, 0.0008, 0.001, 0.0008, 0.0012, 0.0008, 0.0013,
     0.0014, 0.0015, 0.0014, 0.0013, 0.0016, 0.0013, 0.0017, 0.0019, 0.0016,
     0.0021, 0.0017, 0.0021, 0.0021, 0.0023, 0.0022, 0.0045, 0.0034, 0.0041,
     0.0034, 0.003, 0.0034, 0.0028, 0.0034, 0.0025, 0.0025, 0.0025, 0.0025,
     0.0019, 0.002, 0.0019, 0.0021, 0.0021, 0.002, 0.0021, 0.0021, 0.0023,
     0.0025, 0.0023, 0.0025, 0.0043, 0.0046, 0.0043, 0.0046, 0.0048, 0.0046,
     0.0048, 0.0046, 0.0051, 0.0053, 0.0051, 0.0052, 0.0038, 0.0067, 0.0045,
     0.0069, 0.0087, 0.0067, 0.0093, 0.0069, 0.01, 0.0108, 0.0106, 0.011,
     0.0262, 0.0248, 0.0262, 0.025, 0.024, 0.0248, 0.0243, 0.025, 0.0217,
     0.0207, 0.022, 0.022, 0.1137, 0.1054, 0.1165, 0.1095, 0.1004, 0.1054,
     0.1026, 0.1095, 0.094, 0.0908, 0.0934, 0.0929], np.float32)


def compact_case(meta: Dict, case_dir: Optional[Path] = None) -> Dict:
    """Meta → the per-case dict the reference builds for sampling
    (input_pipeline_g.py:200-246): tumor bboxes/centers/stddevs grouped by
    slice index, organ bbox, size."""
    ft = meta["tumor_slices_from_to"]
    slices, centers, stddevs = [], [], []
    for ind in range(len(meta["tumor_slices_index"])):
        lo, hi = ft[ind], ft[ind + 1]
        slices.append(meta["tumor_slices"][lo:hi])
        centers.append(meta["tumor_slices_centers"][lo:hi])
        stddevs.append(meta["tumor_slices_stddevs"][lo:hi])
    return {
        "PID": meta["PID"],
        "size": meta["size"],
        "bbox": meta["bbox"],
        "tumor_slices_index": meta["tumor_slices_index"],
        "slices": slices,
        "centers": centers,
        "stddevs": stddevs,
        "case_dir": str(case_dir) if case_dir else None,
    }


class CaseVolumes:
    """Lazy memory-mapped access to the npy cache."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._vols: Dict[int, np.ndarray] = {}
        self._labs: Dict[int, np.ndarray] = {}

    def volume(self, pid: int) -> np.ndarray:
        if pid not in self._vols:
            self._vols[pid] = np.load(self.root / f"volume-{pid}" / "volume.npy",
                                      mmap_mode="r")
        return self._vols[pid]

    def label(self, pid: int) -> np.ndarray:
        if pid not in self._labs:
            self._labs[pid] = np.load(
                self.root / f"volume-{pid}" / "segmentation.npy", mmap_mode="r")
        return self._labs[pid]


class DownsampledVolumes(CaseVolumes):
    """2x spatial downsampling view over the npy cache (-ds/--downsampling,
    reference load_data_ds, NF/input_pipeline_g_simply.py:161-204: volumes
    and labels strided [:, ::2, ::2] for fast experiments)."""

    def volume(self, pid: int) -> np.ndarray:
        return super().volume(pid)[:, ::2, ::2]

    def label(self, pid: int) -> np.ndarray:
        return super().label(pid)[:, ::2, ::2]


def ds_size(size, downsampling: bool):
    """Case (depth, height, width) under the optional 2x spatial stride."""
    d, h, w = size
    return (d, (h + 1) // 2, (w + 1) // 2) if downsampling else (d, h, w)


def _randint(rng: np.random.RandomState, a: int, b: int) -> int:
    """Inclusive-range randint (python random.randint semantics)."""
    return int(rng.randint(a, b + 1)) if b >= a else a


def _crop_offset(rng, obj_bb, crop, size_ax) -> int:
    """Object-aware crop offset for one axis (input_pipeline_g.py:480-497).

    obj_bb = (lo, hi) of the object along this axis; crop = crop size; the
    window tries to fully contain the object with a 5-px margin, else crops
    part of it."""
    lo, hi = obj_bb
    rng_l = max(hi + 5 - crop, 0)
    rng_r = min(lo - 5, size_ax - crop)
    if rng_l + 20 < rng_r:
        return _randint(rng, rng_l, rng_r)
    a = max(lo - 20, 0)
    b = min(int(lo * 0.75 + hi * 0.25), size_ax - crop)
    return _randint(rng, min(a, b), max(a, b)) if b >= a else max(b, 0)


def stack_slices(vol: np.ndarray, sid: int, off: Tuple[int, int],
                 crop: Tuple[int, int], out: np.ndarray) -> np.ndarray:
    """Copy the 2.5D stack around slice ``sid`` (slices sid - (C - 1) // 2
    ..., each cut to the ``crop`` window at ``off``) into ``out`` [C, >=
    crop_h, >= crop_w]; slices beyond the z range stay as they are (zero).
    Returns the z pad mask [C] (input_pipeline_g.py:498-515)."""
    ch = out.shape[0]
    lh = (ch - 1) // 2
    pad_mask = np.zeros((ch,), np.float32)
    for k in range(ch):
        z = sid - lh + k
        if 0 <= z < vol.shape[0]:
            out[k, :crop[0], :crop[1]] = vol[z, off[0]:off[0] + crop[0],
                                             off[1]:off[1] + crop[1]]
            pad_mask[k] = 1.0
    return pad_mask


def host_window(vol: np.ndarray, lab_plane: Optional[np.ndarray], sid: int,
                off: Tuple[int, int], crop: Tuple[int, int], ch: int,
                target: Tuple[int, int]):
    """JAX's host layout of one zoom window (data/sampler.py:273-297):
    the [H, W, C] uint16 2.5D stack resized to ``target`` by
    resize_linear_u16 (cv2's INTER_LINEAR), the ``lab_plane`` window by
    cv2's nearest index ([H, W] zeros where it is None), and the z pad mask
    [C]."""
    win = np.zeros((crop[0], crop[1], ch), np.uint16)
    pad_mask = stack_slices(vol, sid, off, crop, np.moveaxis(win, -1, 0))
    img = resize_linear_u16(win, target)
    if lab_plane is None:
        return img, np.zeros(target, np.uint8), pad_mask
    lab = torch.from_numpy(np.array(
        lab_plane[off[0]:off[0] + crop[0], off[1]:off[1] + crop[1]]))
    return img, resize_nearest(lab, target).numpy(), pad_mask


class TrainSampler:
    """Infinite class-balanced batch sampler over prepared cases.

    Ships the fixed max-zoom window + crop scalars for the device-side
    crop_and_resize_2d (or, with ``zbase``, slice indices only); with
    ``resize_on_host=True`` (eval only) the zoom window resized on the
    host to [H, W, C] uint16 and its label to [H, W] (the JAX package's
    default).
    """

    def __init__(self, dataset_dir, args, mode: str = "train",
                 pids: Optional[Sequence[int]] = None, seed: Optional[int] = None,
                 resize_on_host: bool = False,
                 zbase: Optional[Dict[int, Tuple[int, int]]] = None):
        """zbase: {pid: (z_offset, depth)} from a DeviceVolumeCache.  When
        given, the sampler runs in INDEX mode: batches carry only per-sample
        slice indices + crop scalars (no pixels); the device pipeline
        gathers from the cache (pipeline.make_preprocess_fn(cache=...))."""
        if resize_on_host and mode == "train":
            raise NotImplementedError(
                "resize_on_host=True (JAX's OpenCV layout, resized here by "
                "ops/image_ops) serves the online eval (mode='eval'); "
                "training keeps the device-resize layout or --device_cache")
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
        self.vols = CaseVolumes(self.root)
        self.mode = mode
        self.rng = np.random.RandomState(seed)

        self.target = (args.im_height, args.im_width)
        self.channel = args.im_channel
        self.zoom = tuple(args.zoom_scale)
        self.max_crop = (int(math.ceil(self.target[0] * self.zoom[1])),
                         int(math.ceil(self.target[1] * self.zoom[1])))
        self.zbase = zbase
        self.resize_on_host = resize_on_host
        self.use_context = bool(getattr(args, "use_context", False))
        self.use_spatial = bool(getattr(args, "use_spatial", False))
        self.max_objs = int(getattr(args, "max_objs", 8))
        self.context_list = self._parse_context_list(
            getattr(args, "context_list", None))
        # per-case list of (feature name, [z, len]) arrays
        self._context_cache: Dict[int, List[Tuple[str, np.ndarray]]] = {}

        self.tumor_cases = [i for i, c in enumerate(self.cases) if c["slices"]]
        if not self.cases:
            raise ValueError(f"No cases for mode={mode} in {dataset_dir}")
        # NF MRI normalization window (reference NF/input_pipeline_g.py:
        # 464-470: fixed (0, 900), random upper (800, 1000)); z-score makes
        # the clip a no-op placeholder
        self.task = getattr(args, "task", "liver")
        self.nf = self.task.startswith("nf")
        # only_liver (reference Liver/input_pipeline_li.py:250-310): no
        # tumor-centered sampling, liver_percent forcing only, uniform crop
        # offsets, random window always on in training
        self.liver_only = self.task == "only_liver"

    @staticmethod
    def _parse_context_list(raw) -> List[Tuple[str, int]]:
        if not raw:
            return [("hist", 200)]
        return [(raw[i], int(raw[i + 1])) for i in range(0, len(raw), 2)]

    @property
    def context_len(self) -> int:
        return sum(l for _, l in self.context_list)

    def _context_features(self, pid: int):
        """Per-feature arrays [(name, [z, len])]: hist ×hist_scale
        (reference feature_ops.py:20-24), context_mode='train' (GT-based
        histograms)."""
        if pid not in self._context_cache:
            feats = []
            for name, f_len in self.context_list:
                arr = np.load(self.root / "feat" / name / "train" / ("%03d.npy" % pid))
                assert arr.shape[1] == f_len, f"feature length {arr.shape[1]} != {f_len}"
                if name == "hist":
                    arr = arr * self.args.hist_scale
                feats.append((name, arr.astype(np.float32)))
            self._context_cache[pid] = feats
        return self._context_cache[pid]

    def _sample_context(self, pid: int, sid: int,
                        rng: np.random.RandomState) -> np.ndarray:
        """Concatenated context vector for one slice with per-feature train
        noise: hist noise scaled by --hist_noise_scale, GLCM noise by the
        pre-computed per-dimension scales (reference gen_train_batch,
        input_pipeline_g.py:545-565)."""
        parts = []
        for name, arr in self._context_features(pid):
            feat = arr[sid].copy()
            if name == "hist" and getattr(self.args, "hist_noise", False):
                feat += (rng.normal(0.0, 1.0, feat.shape)
                         * self.args.hist_noise_scale).astype(np.float32)
            elif name == "glcm" and getattr(self.args, "glcm_noise", False):
                if feat.size == GLCM_NOISE_SCALE.size:
                    scale = GLCM_NOISE_SCALE
                else:  # non-default GLCM layout: the per-dim table does not
                    # apply; use its mean magnitude uniformly
                    scale = np.float32(GLCM_NOISE_SCALE.mean())
                feat += (rng.normal(0.0, 1.0, feat.shape)
                         * scale).astype(np.float32)
            parts.append(feat)
        return np.concatenate(parts, axis=0)

    def _stack_window(self, pid: int, sid: int, off_y: int, off_x: int,
                      crop: Tuple[int, int]):
        """2.5D channel stack copied into a fixed [C, Hmax, Wmax] buffer
        (zero-padded beyond crop and beyond the z range,
        input_pipeline_g.py:498-515)."""
        win = np.zeros((self.channel,) + self.max_crop, np.uint16)
        pad_mask = stack_slices(self.vols.volume(pid), sid, (off_y, off_x),
                                crop, win)
        lab_win = np.zeros(self.max_crop, np.uint8)
        lab_win[:crop[0], :crop[1]] = self.vols.label(pid)[
            sid, off_y:off_y + crop[0], off_x:off_x + crop[1]]
        return win, lab_win, pad_mask

    def sample_batch(self, batch_size: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Dict[str, np.ndarray]:
        """rng: per-call RandomState for thread-safe parallel sampling
        (each TrainDataset worker passes its own); defaults to self.rng."""
        rng = rng if rng is not None else self.rng
        args = self.args
        target = np.asarray(self.target, np.float32)
        force_tumor = (0 if self.liver_only
                       else math.ceil(batch_size * args.tumor_percent))
        force_liver = math.ceil(batch_size * args.guide_percent)

        ci1 = rng.choice(self.tumor_cases or [0], force_tumor, True)
        ci2 = rng.choice(len(self.cases), batch_size - force_tumor, True)
        ci = np.concatenate([ci1, ci2])

        if self.zbase is not None:
            out = {
                "zidx": np.zeros((batch_size, self.channel), np.int32),
                "lab_z": np.zeros((batch_size,), np.int32),
                "offset": np.zeros((batch_size, 2), np.float32),
                "crop_hw": np.zeros((batch_size, 2), np.float32),
            }
        elif self.resize_on_host:
            out = {
                "image": np.zeros((batch_size,) + self.target
                                  + (self.channel,), np.uint16),
                "label": np.zeros((batch_size,) + self.target, np.uint8),
            }
        else:
            out = {
                "window": np.zeros((batch_size, self.channel) + self.max_crop,
                                   np.uint16),
                "label": np.zeros((batch_size,) + self.max_crop, np.uint8),
                "crop_hw": np.zeros((batch_size, 2), np.float32),
            }
        out.update({
            "clip": np.zeros((batch_size, 2), np.float32),
            "pad_mask": np.zeros((batch_size, self.channel), np.float32),
            "names": np.zeros((batch_size,), np.int32),
        })
        if self.use_context:
            out["context"] = np.zeros((batch_size, self.context_len), np.float32)
        if self.use_spatial:
            out["centers"] = np.zeros((batch_size, self.max_objs, 2), np.float32)
            out["stddevs"] = np.ones((batch_size, self.max_objs, 2), np.float32)
            out["n_objs"] = np.zeros((batch_size,), np.int32)

        liver_counter = tumor_counter = 0
        for j, i in enumerate(ci):
            case = self.cases[i]
            size = case["size"]
            pid = case["PID"]
            crop = (target * rng.uniform(*self.zoom, size=2)).astype(np.int32)
            crop = (int(min(crop[0], size[1])), int(min(crop[1], size[2])))

            ind = -1
            if tumor_counter < force_tumor and case["slices"]:
                ind = rng.randint(len(case["slices"]))
                sid = case["tumor_slices_index"][ind]
                tumor_counter += 1
                liver_counter += 1
                obj_bb = case["slices"][ind][_randint(rng, 0, len(case["slices"][ind]) - 1)]
            elif liver_counter < force_liver:
                sid = _randint(rng, case["bbox"][0], case["bbox"][3] - 1)
                liver_counter += 1
                b = case["bbox"]
                obj_bb = [b[1], b[2], b[4], b[5]]
                if sid in case["tumor_slices_index"]:
                    ind = case["tumor_slices_index"].index(sid)
            else:
                sid = _randint(rng, 0, size[0] - 1)
                obj_bb = [size[1], size[2], 0, 0]  # no object
                if sid in case["tumor_slices_index"]:
                    ind = case["tumor_slices_index"].index(sid)

            if self.liver_only:  # plain uniform offsets (input_pipeline_li.py)
                off_y = _randint(rng, 0, max(size[1] - crop[0], 0))
                off_x = _randint(rng, 0, max(size[2] - crop[1], 0))
            else:
                off_y = _crop_offset(rng, (obj_bb[0], obj_bb[2]), crop[0], size[1])
                off_x = _crop_offset(rng, (obj_bb[1], obj_bb[3]), crop[1], size[2])

            if self.zbase is not None:
                base, depth = self.zbase[pid]
                lh = (self.channel - 1) // 2
                pad = np.zeros((self.channel,), np.float32)
                for k in range(self.channel):
                    z = sid - lh + k
                    inside = 0 <= z < depth
                    out["zidx"][j, k] = base + min(max(z, 0), depth - 1)
                    pad[k] = 1.0 if inside else 0.0
                out["lab_z"][j] = base + sid
                out["offset"][j] = (off_y, off_x)
                out["crop_hw"][j] = crop
            elif self.resize_on_host:
                img, lab, pad = host_window(
                    self.vols.volume(pid), self.vols.label(pid)[sid], sid,
                    (off_y, off_x), crop, self.channel, self.target)
                out["image"][j] = img
                out["label"][j] = lab
            else:
                win, lab, pad = self._stack_window(pid, sid, off_y, off_x, crop)
                out["window"][j] = win
                out["crop_hw"][j] = crop
                out["label"][j] = lab
            out["pad_mask"][j] = pad
            out["names"][j] = pid
            if self.nf:
                if getattr(args, "random_window", False):
                    out["clip"][j] = (0.0, _randint(rng, 800, 1000) * IM_SCALE)
                else:
                    out["clip"][j] = (0.0, 900.0 * IM_SCALE)
            elif getattr(args, "random_window", False) or \
                    (self.liver_only and self.mode == "train"):
                out["clip"][j] = (_randint(rng, 10, 50) * IM_SCALE,
                                  _randint(rng, 500, 540) * IM_SCALE)
            else:
                out["clip"][j] = FIXED_CLIP

            use_sp = rng.random_sample() < getattr(args, "spatial_random", 1.0)
            if self.use_context:
                if use_sp:
                    out["context"][j] = self._sample_context(pid, sid, rng)
            if self.use_spatial and use_sp and ind >= 0:
                centers = np.asarray(case["centers"][ind], np.float32)
                stddevs = np.asarray(case["stddevs"][ind], np.float32)
                inbox = [t for t in range(centers.shape[0])
                         if off_y <= centers[t][0] < off_y + crop[0]
                         and off_x <= centers[t][1] < off_x + crop[1]]
                if getattr(args, "spatial_inner_random", False) and inbox:
                    k = _randint(rng, 1, len(inbox))
                    inbox = [inbox[t] for t in
                             rng.choice(len(inbox), size=k, replace=False)]
                inbox = inbox[:self.max_objs]
                if inbox:
                    c = centers[inbox] - np.array([off_y, off_x], np.float32)
                    s = stddevs[inbox]
                    c = c + s * rng.uniform(-args.center_random_ratio,
                                            args.center_random_ratio, c.shape)
                    s = s * rng.uniform(1.0 / (1 + args.stddev_random_ratio),
                                        1.0 + args.stddev_random_ratio, s.shape)
                    s = np.maximum(s, args.min_std)
                    # scale moments crop → target (render-at-target redesign)
                    scale = target / np.asarray(crop, np.float32)
                    n = len(inbox)
                    out["centers"][j, :n] = c * scale
                    out["stddevs"][j, :n] = np.maximum(s * scale, 1e-3)
                    out["n_objs"][j] = n
        return out
