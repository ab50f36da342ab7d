"""Full-volume eval loading: organ-bbox crop, align-16, CT re-window, the
eval context features and the fixed-shape host slice batches with mirror
TTA (own copy of boxsegliver_tpu/evaluators/eval_loader.py; reference
parse_case_eval + get_dataset_for_eval_image,
DataLoader/Liver/input_pipeline_g.py:849-979) against the npy cache produced
by data/meta.py (HU values reconstructed from the stored uint16 window-clip).
``slice_batches`` resizes with the port's cv2.INTER_LINEAR-equivalent
bilinear resize (ops/image_ops.py) instead of OpenCV.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from boxsegliver_torch.data.meta import GRAY_MIN, IM_SCALE
from boxsegliver_torch.ops.image_ops import resize_bilinear

# Normalization window of the ONLINE pipelines (reference
# input_pipeline_g.py:46-47: GRAY_MIN=-200, GRAY_MAX=250) — intentionally
# narrower than the storage window of extract.py ([-250, 300]); it matches
# the training clip (50*IM_SCALE, 500*IM_SCALE).
W_GRAY_MIN = -200.0
W_GRAY_MAX = 250.0


@dataclass
class EvalCase:
    pid: int
    volume: np.ndarray          # [cz + lhc + rhc, ch, cw] float32 in [0, 1]
    segmentation: Optional[np.ndarray]  # [cz, ch, cw] uint8
    crop: Tuple[int, int, int, int, int, int]  # z1, z2, y1, y2, x1, x2
    oshape: Tuple[int, int, int]
    spacing: Tuple[float, float, float]
    lhc: int
    rhc: int
    meta: Dict = field(default_factory=dict)

    @property
    def depth(self) -> int:
        return self.crop[1] - self.crop[0]


def aligned_bbox(case_meta: Dict, align: int = 16, padding: int = 25,
                 padding_z: int = 0) -> Tuple[int, int, int, int, int, int]:
    """Organ bbox expanded by padding, centered and aligned to `align`
    (reference parse_case_eval, input_pipeline_g.py:853-874)."""
    d, h, w = case_meta["size"]
    bb = case_meta["bbox"]        # [z1, y1, x1, z2+1, y2+1, x2+1]
    z1 = max(bb[0] - padding_z, 0)
    z2 = min(bb[3] + padding_z, d)
    y1 = max(bb[1] - padding, 0)
    x1 = max(bb[2] - padding, 0)
    y2 = min(bb[4] + padding, h)
    x2 = min(bb[5] + padding, w)
    cy = (y1 + y2 - 1) / 2
    cx = (x1 + x2 - 1) / 2
    sz_y = int(math.ceil((y2 - y1) / align)) * align
    sz_x = int(math.ceil((x2 - x1) / align)) * align
    y1 = max(int(cy - (sz_y - 1) / 2), 0)
    x1 = max(int(cx - (sz_x - 1) / 2), 0)
    y2 = min(y1 + sz_y, h)
    x2 = min(x1 + sz_x, w)
    if (y2 - y1) % align != 0 or (x2 - x1) % align != 0:
        y1 = max(y2 - sz_y, 0)
        x1 = max(x2 - sz_x, 0)
    return z1, z2, y1, y2, x1, x2


def parse_case_eval(case_meta: Dict, dataset_dir, im_channel: int = 3,
                    align: int = 16, padding: int = 25, padding_z: int = 0,
                    parse_label: bool = True, norm: str = "window",
                    whole_frame: bool = False) -> EvalCase:
    """Load + crop + normalize one case from the npy cache.

    norm: 'window' — CT re-window to [-200, 250] HU → [0, 1] (Liver,
    input_pipeline_g.py:893); 'nf_clip' — clip(0, 900)/900 (NF,
    NF/input_pipeline_g.py:701); 'nf_zscore' — per-slice nonzero z-score
    (NF/input_pipeline_g.py:703-705).
    whole_frame: skip the organ-bbox crop and evaluate the full frame (the NF
    pipelines have no organ label to crop to, NF/input_pipeline_g.py:691-719).
    """
    root = Path(dataset_dir)
    pid = int(case_meta["PID"])
    if whole_frame:
        d0, h0, w0 = case_meta["size"]
        z1, z2, y1, y2, x1, x2 = 0, d0, 0, h0, 0, w0
    else:
        z1, z2, y1, y2, x1, x2 = aligned_bbox(case_meta, align, padding,
                                              padding_z)
    d = case_meta["size"][0]

    vol_u16 = np.load(root / f"volume-{pid}" / "volume.npy", mmap_mode="r")
    lhc = (im_channel - 1) // 2
    rhc = im_channel - 1 - lhc
    left_pad = max(lhc - z1, 0)
    right_pad = max(z2 + rhc - d, 0)
    crop_z1 = max(0, z1 - lhc)
    crop_z2 = min(d, z2 + rhc)
    vol = np.asarray(vol_u16[crop_z1:crop_z2, y1:y2, x1:x2], np.float32)
    if left_pad or right_pad:
        # channel-edge z padding happens BEFORE normalization with RAW zeros
        # (reference parse_case_eval, input_pipeline_g.py:888-892) — under CT
        # windowing a raw HU-0 slice normalizes to mid-gray (200/450), not 0.
        # Our cache stores (HU - GRAY_MIN) * IM_SCALE, so the pad value is
        # the stored image of HU 0.  Pinned by tests/test_geometry_golden.py.
        pad_val = (0.0 - GRAY_MIN) * IM_SCALE if norm == "window" else 0.0
        vol = np.concatenate([
            np.full((left_pad,) + vol.shape[1:], pad_val, np.float32), vol,
            np.full((right_pad,) + vol.shape[1:], pad_val, np.float32)],
            axis=0)
    if norm == "window":
        # stored = (clip(HU) - GRAY_MIN) * IM_SCALE; re-window to [-200, 250]
        # HU and normalize to [0, 1] (input_pipeline_g.py:893)
        lo = (W_GRAY_MIN - GRAY_MIN) * IM_SCALE
        hi = (W_GRAY_MAX - GRAY_MIN) * IM_SCALE
        vol = (np.clip(vol, lo, hi) - lo) / (hi - lo)
    elif norm == "nf_clip":
        vol = np.clip(vol, 0.0, 900.0 * IM_SCALE) / (900.0 * IM_SCALE)
    elif norm == "nf_zscore":
        # reference-exact NF EVAL z-score (NF/input_pipeline_g.py:699-705):
        # per-slice nonzero statistics applied UNMASKED — background zeros
        # become -mean/std.  This differs from the reference's own TRAIN
        # z-score (utils/image_ops.py:25-33, masked, zeros stay 0); the
        # published NF numbers were produced with this train/eval
        # inconsistency, so output parity requires reproducing it.  Pinned
        # by the NF geometry golden (tools/gen_geometry_golden.py).
        for i in range(vol.shape[0]):
            nz = vol[i] > 0
            if nz.any():
                vol[i] = (vol[i] - vol[i][nz].mean()) / \
                    (vol[i][nz].std() + 1e-8)
    else:
        raise ValueError(f"Unknown norm mode {norm!r}")
    seg = None
    if parse_label:
        lab = np.load(root / f"volume-{pid}" / "segmentation.npy", mmap_mode="r")
        seg = np.asarray(lab[z1:z2, y1:y2, x1:x2], np.uint8)

    return EvalCase(pid=pid, volume=vol, segmentation=seg,
                    crop=(z1, z2, y1, y2, x1, x2),
                    oshape=tuple(case_meta["size"]),
                    spacing=tuple(case_meta["spacing"]),
                    lhc=lhc, rhc=rhc, meta=case_meta)


def _resize_host(arr: np.ndarray, pshape) -> np.ndarray:
    """[Z, h, w] -> [Z, ph, pw] float32 numpy, cv2.INTER_LINEAR semantics."""
    return resize_bilinear(torch.from_numpy(
        np.ascontiguousarray(arr, np.float32)), pshape).numpy()


def slice_batches(case: EvalCase, batch_size: int, pshape: Tuple[int, int],
                  eval_mirror: bool = False, random_flip: int = 3,
                  context: Optional[np.ndarray] = None,
                  sp_guide: Optional[np.ndarray] = None,
                  guide_bg: float = 0.5
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape [bs, ph, pw, C] slice batches over the case's z range,
    batch-padded at the end, with optional mirror-TTA variants
    (reference get_dataset_for_eval_image, input_pipeline_g.py:944-978).

    Each yielded dict carries 'mirror' ∈ {0,1,2,3} and 'pads' on the LAST
    non-mirror batch.  sp_guide, when given, is [cz, ch, cw] float32 aligned
    to the cropped volume — or already at [cz, ph, pw] — and travels through
    the same resize + mirror.  guide_bg fills batch-padding guide slices
    (0.5 Liver convention, 0.0 NF).  The JAX package resizes each slice's
    [ch, cw, C] stack with cv2; the channels resize independently, so the
    port resizes every slice of the volume once instead.
    """
    cz = case.depth
    _, ch, cw = case.volume.shape
    c = case.lhc + case.rhc + 1
    pads = (batch_size - cz % batch_size) % batch_size
    n_batches = (cz + pads) // batch_size
    need_resize = (ch, cw) != tuple(pshape)
    vol = (_resize_host(case.volume, pshape) if need_resize
           else np.asarray(case.volume, np.float32))
    guide = None
    if sp_guide is not None:
        guide = np.asarray(sp_guide, np.float32)
        if need_resize and guide.shape[1:] != tuple(pshape):
            guide = _resize_host(guide, pshape)

    for b in range(n_batches):
        images = np.zeros((batch_size,) + tuple(pshape) + (c,), np.float32)
        guides = (np.full((batch_size,) + tuple(pshape) + (1,), guide_bg,
                          np.float32)
                  if guide is not None else None)
        for j in range(batch_size):
            z = b * batch_size + j
            if z < cz:
                images[j] = np.transpose(vol[z:z + c], (1, 2, 0))
                if guides is not None:
                    guides[j, ..., 0] = guide[z]
        batch = {"images": images, "names": case.pid, "mirror": 0,
                 "pads": pads if b == n_batches - 1 else 0}
        if context is not None:
            ctx = np.zeros((batch_size, context.shape[1]), np.float32)
            z0 = case.crop[0] + b * batch_size
            valid = min(batch_size, context.shape[0] - z0)
            if valid > 0:
                ctx[:valid] = context[z0:z0 + valid]
            batch["context"] = ctx
        if guides is not None:
            batch["sp_guide"] = guides
        yield dict(batch)
        if eval_mirror:
            variants = []
            if random_flip & 1:
                variants.append((1, lambda a: np.flip(a, axis=2)))
            if random_flip & 2:
                variants.append((2, lambda a: np.flip(a, axis=1)))
            if random_flip & 3 == 3:
                variants.append((3, lambda a: np.flip(np.flip(a, axis=2),
                                                      axis=1)))
            for mid, flip in variants:
                tmp = dict(batch)
                tmp["images"] = np.ascontiguousarray(flip(batch["images"]))
                if guides is not None:
                    tmp["sp_guide"] = np.ascontiguousarray(
                        flip(batch["sp_guide"]))
                tmp["mirror"] = mid
                yield tmp


def load_eval_context(dataset_dir, pid: int, context_list, hist_scale: float
                      ) -> np.ndarray:
    """Eval-mode context features (middle-slice guide histograms,
    reference input_pipeline_g.py:925-936)."""
    root = Path(dataset_dir)
    feats = []
    for name, f_len in context_list:
        arr = np.load(root / "feat" / name / "eval" / ("%03d.npy" % pid))
        assert arr.shape[1] == f_len
        if name == "hist":
            arr = arr * hist_scale
        feats.append(arr.astype(np.float32))
    return np.concatenate(feats, axis=1)
