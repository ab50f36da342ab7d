"""Guide propagation for interactive full-volume evaluation (port of
boxsegliver_tpu/interactive/propagation.py; reference EvalImage3DLoader,
DataLoader/Liver/input_pipeline_g.py:1179-1513).

A user prior (an ellipse on each tumor's middle slice and its z-range,
prior.json) seeds Gaussian spatial guides; the volume is swept Forward then
Backward slice by slice; after each slice the prediction is filtered
(objects without a matching guide are false positives: guide peak under
threshold, or no monotone-ascent line from the object's guide peak to a
guide center) and the surviving objects' robust moments become the next
slice's guides; tumors leaving their user-declared z-range are terminated.

``GuidePropagationLoader`` is the reference-shaped per-slice loop: the
evaluator's host fallback when a case overflows the device sweep's caps
(interactive/device_sweep.py), when guides are dumped (``--save_sp_guide``)
or under ``--device_sweep off``.  The case is resized once on the model's
device and each slice's guide is rendered there by kernel B1
(ops/kernels.gaussian_guide_batch, one launch per slice and direction, the
``* eval_discount / 2 + GUIDE_BG`` epilogue fused), where the JAX loop
renders it with numpy; the filter (scipy labeling, Wu-line ascent, robust
moments) stays on the host, as in the JAX package.  B1 computes the
exponent as diff²·(0.5/σ²), numpy as 0.5·(diff/σ)²: the guides agree within
1e-6 (tests/test_torch_host_loop.py).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

from boxsegliver_torch.evaluators.eval_loader import EvalCase
from boxsegliver_torch.ops import array_kits
from boxsegliver_torch.ops.image_ops import resize_bilinear
from boxsegliver_torch.ops.kernels import gaussian_guide_batch

GUIDE_BG = 0.5


def mirror_variants(random_flip: int, eval_mirror: bool) -> List[Tuple[int, ...]]:
    """Flip-axis sets for TTA: axis 1 = height, axis 2 = width (of NHWC)."""
    out: List[Tuple[int, ...]] = [()]
    if eval_mirror:
        if random_flip & 1:
            out.append((2,))
        if random_flip & 2:
            out.append((1,))
        if random_flip & 3 == 3:
            out.append((1, 2))
    return out


def _flip(x: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    """Flip an unbatched [h, w, ...] slice along NHWC ``axes`` (1 = height,
    2 = width)."""
    return x.flip([a - 1 for a in axes]) if axes else x


class GuidePropagationLoader:
    """One case's interactive sweep state (see module docstring); tensors
    live on ``device``, the filter state on the host."""

    def __init__(self, case: EvalCase, prior_case: Dict[str, List[Dict]],
                 args, context: Optional[np.ndarray] = None, device="cpu"):
        self.case = case
        self.args = args
        self.device = torch.device(device)
        self.pshape = (args.im_height, args.im_width)
        self.min_std = float(getattr(args, "min_std", 2.0))
        self.eval_discount = float(getattr(args, "eval_discount", 0.85))
        self.filter_thresh = 0.15 + GUIDE_BG
        self.flips = mirror_variants(getattr(args, "random_flip", 3),
                                     getattr(args, "eval_mirror", False))
        self.context = (None if context is None else
                        torch.from_numpy(np.asarray(context, np.float32))
                        .to(self.device))
        self.prior = prior_case or {}
        self.disc = ndi.generate_binary_structure(2, connectivity=1)

        # resize the whole cropped volume (with channel padding) once:
        # [cz + lhc + rhc, ph, pw] on the device, cv2.INTER_LINEAR semantics
        vol = torch.from_numpy(np.ascontiguousarray(case.volume, np.float32))
        self.pvol = resize_bilinear(vol.to(self.device), self.pshape)
        self.channels = case.lhc + case.rhc + 1

        self.direction = "Forward"
        self.last_info: List[Dict] = []
        self.curr_info: List[Dict] = []
        self._last_guide: Optional[torch.Tensor] = None
        self._last_pred: Optional[np.ndarray] = None
        self.sid = None
        self.sp_guides: List[torch.Tensor] = []

    # ------------------------------------------------------------------
    # slice feature assembly
    # ------------------------------------------------------------------

    def _render(self) -> torch.Tensor:
        """This slice's guide [ph, pw] from ``curr_info`` by kernel B1:
        discount / 2 · max of the objects' Gaussians + GUIDE_BG (a flat
        GUIDE_BG when there is no object)."""
        n = len(self.curr_info)
        moments = np.zeros((2, 1, n, 2), np.float32)
        for k, o in enumerate(self.curr_info):
            moments[0, 0, k] = o["center"]
            moments[1, 0, k] = np.maximum(o["stddev"], self.min_std)
        moments = torch.from_numpy(moments).to(self.device)
        valid = torch.ones((1, n), dtype=torch.bool, device=self.device)
        return gaussian_guide_batch(
            moments[0], moments[1], valid, height=self.pshape[0],
            width=self.pshape[1], scale=self.eval_discount / 2.0,
            offset=GUIDE_BG)[0, ..., 0]

    def slice_features(self, idx: int) -> Dict[str, torch.Tensor]:
        """[n_mirror, ph, pw, c] image stack + guide for cropped slice idx."""
        case = self.case
        self.sid = idx + case.crop[0]
        img = self.pvol[idx:idx + self.channels].permute(1, 2, 0)  # [ph, pw, c]

        # merge user prior at this slice with propagated guides
        self.curr_info = []
        user = self.prior.get(str(self.sid), [])
        z1, _, y1, _, x1, _ = case.crop
        ch, cw = case.volume.shape[1:]
        for obj in copy.deepcopy(user):
            if np.min(obj["stddev"]) > self.min_std:
                obj["center"] = [
                    int((obj["center"][0] - y1) / ch * self.pshape[0]),
                    int((obj["center"][1] - x1) / cw * self.pshape[1])]
                self.curr_info.append(obj)
        self.curr_info.extend(self.last_info)
        self._last_guide = self._render()
        self.sp_guides.append(self._last_guide)

        guide = self._last_guide[..., None]
        feats = {"images": torch.stack([_flip(img, a) for a in self.flips]),
                 "sp_guide": torch.stack([_flip(guide, a)
                                          for a in self.flips])}
        if self.context is not None:
            feats["context"] = self.context[self.sid][None].repeat(
                len(self.flips), 1)
        return feats

    def merge_mirrors(self, probs) -> np.ndarray:
        """Flip back + average the [n_mirror, ph, pw, nc] TTA probs; returns
        the host array [ph, pw, nc] float32."""
        if not isinstance(probs, torch.Tensor):
            probs = torch.from_numpy(np.asarray(probs, np.float32))
        probs = probs.float().to(self.device)
        acc = torch.zeros(probs.shape[1:], dtype=torch.float32,
                          device=self.device)
        for i, axes in enumerate(self.flips):
            acc = acc + _flip(probs[i], axes)
        return (acc / len(self.flips)).cpu().numpy()

    # ------------------------------------------------------------------
    # sweeps
    # ------------------------------------------------------------------

    def sweep(self, direction: str) -> Iterator[int]:
        """Yield cropped-slice indices in sweep order, resetting state."""
        self.direction = direction
        self.last_info = []
        self._last_pred = None
        self.sp_guides = []
        idxs = range(self.case.depth)
        return iter(idxs if direction == "Forward" else reversed(idxs))

    def save_guides(self, save_dir):
        """Dump this sweep's propagated guide volume as
        guide-{F|B}-<pid>.nii.gz, rescaled to the original frame with
        GUIDE_BG padding (reference --save_sp_guide,
        input_pipeline_g.py:1478-1496; values stored ×255 int16)."""
        from boxsegliver_torch.data import nii as nii_kits

        if not self.sp_guides:
            return None
        case = self.case
        vol = torch.stack(self.sp_guides)                     # [cz, ph, pw]
        if self.direction == "Backward":
            vol = vol.flip(0)
        z1, z2, y1, y2, x1, x2 = case.crop
        ch, cw = y2 - y1, x2 - x1
        vol = resize_bilinear(vol, (ch, cw))
        arr = (vol * 255).cpu().numpy().astype(np.int16)
        d, h, w = case.oshape
        arr = np.pad(arr, ((z1, d - z2), (y1, h - y2), (x1, w - x2)),
                     mode="constant",
                     constant_values=np.int16(GUIDE_BG * 255))
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        out_path = save_dir / f"guide-{self.direction[0]}-{case.pid}.nii.gz"
        nii_kits.write_nii(arr, out_path, zooms=case.spacing)
        return out_path

    @property
    def forward(self) -> bool:
        return self.direction == "Forward"

    # ------------------------------------------------------------------
    # prediction write-back (the core state machine)
    # ------------------------------------------------------------------

    def set_last_pred(self, new_pred: np.ndarray) -> np.ndarray:
        """Filter the binary [ph, pw] prediction against current guides and
        compute next-slice guide moments (reference last_pred.setter,
        input_pipeline_g.py:1249-1330).  Returns the FILTERED prediction
        (kept objects only) to be stored as this slice's output."""
        self.last_info = []
        if new_pred is None or new_pred.max() == 0:
            self._last_pred = None
            return np.zeros(self.pshape, np.uint8)
        assert self._last_guide is not None
        guide = self._last_guide.cpu().numpy()
        new_pred = new_pred.astype(np.uint8).copy()
        kept = new_pred.copy()

        labeled, n_objs = ndi.label(new_pred, self.disc)
        for i, slicer in enumerate(ndi.find_objects(labeled)):
            obj = (labeled == i + 1)[slicer]
            masked_guide = obj * guide[slicer]
            # 1. no guide support → false positive
            if masked_guide.max() < self.filter_thresh:
                kept[slicer][obj] = 0
                continue
            # 2. match object to a guide: its guide-peak must be a center or
            #    connect to the nearest center by a monotone ascent line
            peak = np.asarray(np.unravel_index(masked_guide.argmax(),
                                               masked_guide.shape))
            peak[0] += slicer[0].start
            peak[1] += slicer[1].start
            found = -1
            for j, o in enumerate(self.curr_info):
                if np.all(peak == o["center"]):
                    found = j
                    break
            if found < 0:
                dists = np.sum([(peak - o["center"]) ** 2
                                for o in self.curr_info], axis=1)
                for j in np.argsort(dists):
                    ctr = self.curr_info[j]["center"]
                    if tuple(peak) == tuple(ctr) or array_kits.ascent_line(
                            guide, peak[1], peak[0], ctr[1], ctr[0]):
                        found = j
                        break
            if found < 0:
                # reference raises here; be permissive: treat as FP
                kept[slicer][obj] = 0
                continue
            # 3. z-range termination: remove finished tumors from the
            #    propagation state (the OUTPUT volume keeps the raw probs;
            #    reference input_pipeline_g.py:1316-1321)
            zr = self.curr_info[found]["z"]
            if (self.forward and self.sid >= zr[1]) or \
                    (not self.forward and self.sid <= zr[0]):
                kept[slicer][obj] = 0
                continue
            # 4. propagate moments to the next slice
            ctr, std = array_kits.compute_robust_moments(
                obj, indexing="ij", min_std=self.min_std)
            ctr = [int(ctr[0] + slicer[0].start), int(ctr[1] + slicer[1].start)]
            self.last_info.append({"z": list(zr), "center": ctr,
                                   "stddev": list(std)})
        self._last_pred = kept
        return kept
