"""nf2 / IIN per-lesion patch evaluation: loader, mirror TTA and volume
reassembly (port of boxsegliver_tpu/evaluators/iin_eval.py; reference
DataLoader/NF/input_pipeline_iin.py:698-864 ``get_dataset_for_eval`` and
evaluators/evaluator_nf.py:470-575 ``_predict_case_v2``).

For every lesion of every slice: crop an expanded bbox (at least the target
size, centre-clamped), normalize it, build the one-lesion Gaussian guide
and the multi-scale image-patch context, predict the patch batch (one
forward a batch, mirror TTA inside it), and max / min-merge the patch
probabilities into a full-frame volume (foreground max, background min,
background initialized to 1).  The JAX module's docstring lists where it
deviates from the reference; the port keeps its choices.

The guides are kernel B1's: each patch's guide is JAX's
``create_gaussian_distribution_v2`` at the box's source size (the lesion's
centres, stddev ``--guide_scale``), then resized to the target.  A batch's
guides are ONE launch of B1 on the predictor's device over the batch's
largest box (rows = patches, K = the most centres of a patch); a row's
top-left [cy, cx] is its guide at its own source size, as each pixel's
value depends on its coordinates only.  JAX's OpenCV resizes are
ops/image_ops.resize_linear_f32.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

from boxsegliver_torch.data.meta import IM_SCALE
from boxsegliver_torch.data.sampler import CaseVolumes, compact_case
from boxsegliver_torch.models.layers import CT_PATCH, ct_sizes
from boxsegliver_torch.ops.image_ops import resize_linear_f32
from boxsegliver_torch.ops.kernels import gaussian_guide_batch

logger = logging.getLogger("boxsegliver")

NF_EVAL_CLIP = 600.0   # raw gray units (reference input_pipeline_iin.py:809)
NF_INFER_CLIP = 850.0  # the infer path's window (reference :929)
_DISC2 = ndi.generate_binary_structure(2, 2)
_DISC3 = ndi.generate_binary_structure(3, 2)


def load_case_arrays(meta: Dict, dataset_dir, filter_size: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(raw uint16 volume, binary uint8 label) with 3D lesions smaller than
    filter_size zeroed (reference get_dataset_for_eval, :719-727)."""
    vols = CaseVolumes(Path(dataset_dir))
    volume = np.asarray(vols.volume(meta["PID"]))
    lab3d = np.asarray(vols.label(meta["PID"])).copy()
    if filter_size > 0:
        labeled, n = ndi.label(lab3d > 0, _DISC3)
        areas = np.bincount(labeled.ravel(), minlength=n + 1)
        small = np.flatnonzero(areas[1:] < filter_size) + 1
        if small.size:
            lab3d[np.isin(labeled, small)] = 0
    return volume, np.clip(lab3d, 0, 1).astype(np.uint8)


def lesion_centers(lab_plane: np.ndarray, center, bb) -> np.ndarray:
    """Click centres for one per-slice lesion: the meta centre when it lies
    on the lesion, else the medians of the lesion's connected parts inside
    the bbox, else the lesion pixel nearest the centre."""
    h, w = lab_plane.shape
    cy = int(min(max(round(center[0]), 0), h - 1))
    cx = int(min(max(round(center[1]), 0), w - 1))
    if lab_plane[cy, cx]:
        return np.array([[cy, cx]], np.float32)
    y1, x1, y2, x2 = [int(v) for v in bb]
    patch = lab_plane[y1:y2, x1:x2] > 0
    labeled, n = ndi.label(patch, _DISC2)
    if n > 1:
        pts = []
        for i in range(1, n + 1):
            yy, xx = np.nonzero(labeled == i)
            pts.append((np.median(yy) + y1, np.median(xx) + x1))
        return np.asarray(pts, np.float32)
    ys, xs = np.nonzero(patch)
    if ys.size == 0:
        return np.array([[cy, cx]], np.float32)
    k = np.argmin((ys + y1 - cy) ** 2 + (xs + x1 - cx) ** 2)
    return np.array([[ys[k] + y1, xs[k] + x1]], np.float32)


def expand_bbox(bb, size: Tuple[int, int], target: Tuple[int, int],
                expand: int = 5) -> Tuple[int, int, int, int]:
    """Expand the lesion bbox, then grow each side to at least the target
    size with centre clamping (reference :776-794); a frame smaller than the
    target clamps the window to the frame."""
    h, w = size
    th, tw = target
    y1, x1, y2, x2 = [int(v) for v in bb]
    y1, x1 = max(y1 - expand, 0), max(x1 - expand, 0)
    y2, x2 = min(y2 + expand, h), min(x2 + expand, w)
    if y2 - y1 < th:
        lo, hi = th // 2, th - th // 2
        yc = (y1 + y2 - 1) // 2
        yc = min(h - hi, max(lo, yc))
        y1, y2 = max(yc - lo, 0), min(yc + hi, h)
    if x2 - x1 < tw:
        lo, hi = tw // 2, tw - tw // 2
        xc = (x1 + x2 - 1) // 2
        xc = min(w - hi, max(lo, xc))
        x1, x2 = max(xc - lo, 0), min(xc + hi, w)
    return y1, x1, y2, x2


def _normalize(img: np.ndarray, zscore: bool) -> np.ndarray:
    """Plain (unmasked) z-score or the fixed eval window clip(0, 600)
    (reference :805-809)."""
    img = img.astype(np.float32)
    if zscore:
        return (img - img.mean()) / (img.std() + 1e-8)
    hi = NF_EVAL_CLIP * IM_SCALE
    return np.clip(img, 0.0, hi) / hi


def _context_pyramid(img_norm: np.ndarray, centers: np.ndarray,
                     sizes, channel: int) -> np.ndarray:
    """[32, 32, n_scales] float32 pyramid of the normalized crop's middle
    channel around the most central click, z-scored over the pyramid
    (reference :819-836; the eval context is re-normalized, the train
    context is not — JAX keeps that for output parity)."""
    mid = np.median(centers, axis=0)
    idx = int(np.argmin(np.sum((centers - mid) ** 2, axis=1)))
    yy, xx = centers[idx].astype(np.int32)
    cy, cx = img_norm.shape[:2]
    plane = img_norm[:, :, channel // 2]
    patches = []
    for s in sizes:
        s = min(int(s), cy, cx)
        oy = min(cy - s, max(0, int(yy) - s // 2))
        ox = min(cx - s, max(0, int(xx) - s // 2))
        patch = np.ascontiguousarray(plane[oy:oy + s, ox:ox + s])
        if s != CT_PATCH:
            patch = resize_linear_f32(patch, (CT_PATCH, CT_PATCH))
        patches.append(patch)
    ct = np.stack(patches, axis=-1)
    return (ct - ct.mean()) / (ct.std() + 1e-8)


def render_guides(centers: List[np.ndarray], sizes: List[Tuple[int, int]],
                  stddev: float, target: Tuple[int, int],
                  device="cpu") -> List[np.ndarray]:
    """The [th, tw] guide of each patch — create_gaussian_distribution_v2
    of its centres at its source size (cy, cx), resized to ``target`` — all
    from ONE launch of kernel B1 on ``device`` over the largest size."""
    k = max(len(c) for c in centers)
    n = len(centers)
    c = np.zeros((n, k, 2), np.float32)
    valid = np.zeros((n, k), bool)
    for i, ci in enumerate(centers):
        c[i, :len(ci)] = ci
        valid[i, :len(ci)] = True
    s = np.full((n, k, 2), stddev, np.float32)
    hmax = max(h for h, _ in sizes)
    wmax = max(w for _, w in sizes)
    grid = gaussian_guide_batch(
        torch.from_numpy(c).to(device), torch.from_numpy(s).to(device),
        torch.from_numpy(valid).to(device), height=hmax,
        width=wmax)[..., 0].cpu().numpy()
    return [resize_linear_f32(np.ascontiguousarray(grid[i, :h, :w]), target)
            for i, (h, w) in enumerate(sizes)]


class IinPatchLoader:
    """Per-case patch-batch generator for one NF case (task nf2); guides on
    ``device`` by kernel B1, one launch a batch."""

    def __init__(self, meta: Dict, dataset_dir, args, device="cpu"):
        self.meta = meta
        self.args = args
        self.device = device
        self.case = compact_case(meta)
        self.volume, self.lab3d = load_case_arrays(
            meta, dataset_dir, int(getattr(args, "filter_size", 0)))
        self.target = (args.im_height, args.im_width)
        self.channel = args.im_channel
        self.zscore = bool(getattr(args, "zscore", False))
        self.use_context = bool(getattr(args, "use_context", False))
        self.use_spatial = bool(getattr(args, "use_spatial", False))
        self.ct_sizes = ct_sizes(getattr(args, "ct_base", [32]))
        self.guide_scale = float(getattr(args, "guide_scale", 5.0))
        fs = int(getattr(args, "filter_size", 0))
        # per-slice lesions, small ones dropped (reference parse(), :141-150)
        self.items: List[Tuple[int, np.ndarray, np.ndarray]] = []
        ft = meta["tumor_slices_from_to"]
        for ind, sid in enumerate(self.case["tumor_slices_index"]):
            for k, bb in enumerate(self.case["slices"][ind]):
                if fs > 0 and meta["tumor_slices_areas"][ft[ind] + k] <= fs:
                    continue
                self.items.append((int(sid), np.asarray(bb, np.float32),
                                   np.asarray(self.case["centers"][ind][k],
                                              np.float32)))

    def _patch_features(self, sid: int, bb, center):
        """One lesion patch without its guide: the normalized 2.5D stack
        resized to target, the context, the click centres in the crop, and
        the stitch-back bbox."""
        d, h, w = self.volume.shape
        y1, x1, y2, x2 = expand_bbox(bb, (h, w), self.target)
        cy, cx = y2 - y1, x2 - x1
        lh = (self.channel - 1) // 2
        stack = np.zeros((cy, cx, self.channel), np.float32)
        for k in range(self.channel):
            z = sid - lh + k
            if 0 <= z < d:
                stack[..., k] = self.volume[z, y1:y2, x1:x2]
        img = _normalize(stack, self.zscore)
        centers = lesion_centers(self.lab3d[sid], center, bb) \
            - np.array([y1, x1], np.float32)
        feats: Dict[str, np.ndarray] = {}
        if self.use_context:
            feats["context"] = _context_pyramid(img, centers, self.ct_sizes,
                                                self.channel)
        feats["images"] = resize_linear_f32(img, self.target)
        return feats, centers, (y1, x1, y2, x2)

    def _batch(self, items, batch_size: int) -> Dict[str, np.ndarray]:
        th, tw = self.target
        buf = {"images": np.zeros((batch_size, th, tw, self.channel),
                                  np.float32),
               "sid": np.full((batch_size,), -1, np.int32),
               "bb": np.full((batch_size, 4), -1, np.int32),
               "pads": batch_size - len(items)}
        if self.use_spatial:
            buf["sp_guide"] = np.zeros((batch_size, th, tw, 1), np.float32)
        if self.use_context:
            buf["context"] = np.zeros(
                (batch_size, CT_PATCH, CT_PATCH, len(self.ct_sizes)),
                np.float32)
        rows = [self._patch_features(*it) for it in items]
        for i, ((sid, _, _), (feats, _, bbe)) in enumerate(zip(items, rows)):
            for k, v in feats.items():
                buf[k][i] = v
            buf["sid"][i] = sid
            buf["bb"][i] = bbe
        if self.use_spatial:
            guides = render_guides(
                [c for _, c, _ in rows],
                [(b[2] - b[0], b[3] - b[1]) for _, _, b in rows],
                self.guide_scale, self.target, self.device)
            for i, g in enumerate(guides):
                buf["sp_guide"][i, ..., 0] = g
        return buf

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-shape [bs, ...] feature batches with sid / bb / pads; the
        rows of a final partial batch past ``bs - pads`` are zero."""
        for i in range(0, len(self.items), batch_size):
            yield self._batch(self.items[i:i + batch_size], batch_size)


def mirror_axes(random_flip: int) -> List[tuple]:
    """TTA flip-axes variants for a --random_flip bitmask (NHWC batches)."""
    variants = []
    if random_flip & 1:
        variants.append((2,))
    if random_flip & 2:
        variants.append((1,))
    if random_flip & 3 == 3:
        variants.append((1, 2))
    return variants


def make_patch_predict(model: torch.nn.Module, device, random_flip: int = 0,
                       mirror: bool = False) -> Callable:
    """Patch forward of a feature batch (host arrays or tensors; other keys
    ignored) → softmax probabilities [bs, h, w, nc] (float32, on
    ``device``).  With ``mirror``: every flip variant of ``random_flip``
    (images, guide and context flipped together, as training flips them)
    in ONE forward of the stacked batch, flipped back and averaged in JAX's
    order (make_patch_predict_tta; JAX's host loop predict_batch_tta gives
    the same average)."""
    variants = [()] + (mirror_axes(random_flip) if mirror else [])
    div = float(len(variants))
    model = model.to(device).eval()

    @torch.inference_mode()
    def predict(feats):
        feats = {k: torch.as_tensor(v, device=device).float()
                 for k, v in feats.items()
                 if k in ("images", "sp_guide", "context")}
        bs = feats["images"].shape[0]
        big = {k: torch.cat([v.flip(a) if a else v for a in variants])
               for k, v in feats.items()}
        probs = torch.softmax(model(big).float(), dim=-1)
        acc = None
        for i, a in enumerate(variants):
            p = probs[i * bs:(i + 1) * bs]
            p = (p.flip(a) if a else p) / div
            acc = p if acc is None else acc + p
        return acc

    predict.device = torch.device(device)
    return predict


def infer_patch_features(meta: Dict, dataset_dir, args,
                         pos: Tuple[int, int, int],
                         device="cpu") -> Dict[str, np.ndarray]:
    """One user-position patch (reference get_image_patch,
    input_pipeline_iin.py:867-963): bbox = target // 2 around (y, x) with
    the min-size centre clamp, the guide at the click (B1, one launch), the
    context pyramid, batch 1, the infer window clip(0, 850)."""
    vols = CaseVolumes(Path(dataset_dir))
    volume = np.asarray(vols.volume(int(meta["PID"])))
    d, h, w = volume.shape
    si, y, x = [int(v) for v in pos]
    th, tw = args.im_height, args.im_width
    expand = th // 2
    bb = (max(y - expand, 0), max(x - expand, 0),
          min(y + expand, h), min(x + expand, w))
    y1, x1, y2, x2 = expand_bbox(bb, (h, w), (th, tw), expand=0)
    cy, cx = y2 - y1, x2 - x1
    lh = (args.im_channel - 1) // 2
    stack = np.zeros((cy, cx, args.im_channel), np.float32)
    for k in range(args.im_channel):
        z = si - lh + k
        if 0 <= z < d:
            stack[..., k] = volume[z, y1:y2, x1:x2]
    if getattr(args, "zscore", False):
        img = (stack - stack.mean()) / (stack.std() + 1e-8)
    else:
        hi = NF_INFER_CLIP * IM_SCALE
        img = np.clip(stack, 0.0, hi) / hi

    centers = np.array([[y - y1, x - x1]], np.float32)
    feats: Dict[str, np.ndarray] = {"bb": np.array([[y1, x1, y2, x2]],
                                                   np.int32)}
    if getattr(args, "use_spatial", False):
        sp = render_guides([centers], [(cy, cx)], float(args.guide_scale),
                           (th, tw), device)[0]
        feats["sp_guide"] = sp[None, :, :, None]
    if getattr(args, "use_context", False):
        feats["context"] = _context_pyramid(
            img, centers, ct_sizes(getattr(args, "ct_base", [32])),
            args.im_channel)[None]
    feats["images"] = resize_linear_f32(img, (th, tw))[None]
    return feats


def run_patch_infer(predict_fn: Callable, meta: Dict, dataset_dir, args
                    ) -> Path:
    """Infer one patch at --pos of --case_id and write the npz the
    reference writes (evaluator_nf._infer_patch, evaluator_nf.py:421-468)
    to ``model_dir/infer/``."""
    feats = infer_patch_features(meta, dataset_dir, args, tuple(args.pos),
                                 device=getattr(predict_fn, "device", "cpu"))
    model_in = {k: v for k, v in feats.items() if k != "bb"}
    prob = predict_fn(model_in).cpu().numpy()
    save_path = Path(args.model_dir) / "infer"
    save_path.mkdir(parents=True, exist_ok=True)
    save_dict = {"prob": prob[0], "img": feats["images"][0],
                 "bb": feats["bb"][0]}
    if "context" in feats:
        save_dict["ct"] = feats["context"][0]
    if "sp_guide" in feats:
        save_dict["sp"] = feats["sp_guide"][0]
    out = save_path / ("infer-volume-{}-Pos-{}-{}-{}.npz".format(
        int(meta["PID"]), *args.pos))
    np.savez_compressed(out, **save_dict)
    logger.info("Write to %s", out)
    return out


def merge_patch_probs(logits3d: np.ndarray, probs: np.ndarray,
                      sids: np.ndarray, bbs: np.ndarray, pads: int):
    """Stitch patch probabilities into the full-frame volume: foreground
    max-merge, background min-merge (reference _predict_case_v2,
    evaluator_nf.py:491-554)."""
    n = probs.shape[0] - int(pads)
    for i in range(n):
        y1, x1, y2, x2 = [int(v) for v in bbs[i]]
        im = probs[i]
        if im.shape[:2] != (y2 - y1, x2 - x1):
            im = resize_linear_f32(im, (y2 - y1, x2 - x1))
        si = int(sids[i])
        logits3d[si, y1:y2, x1:x2, 1:] = np.maximum(
            logits3d[si, y1:y2, x1:x2, 1:], im[:, :, 1:])
        logits3d[si, y1:y2, x1:x2, 0] = np.minimum(
            logits3d[si, y1:y2, x1:x2, 0], im[:, :, 0])
