"""Device-side batch processing + prefetching train dataset (port of
boxsegliver_tpu/data/pipeline.py:27-303; reference
DataLoader/Liver/input_pipeline_g.py:347-412 ``data_processing_train`` and
:696-768 ``get_dataset_for_train``).

The host sampler (data/sampler.py) emits fixed-shape uint16 windows (or
slice indices into a data/device_cache.DeviceVolumeCache) and scalars; one
batched function does crop-resize / window-normalize / Gaussian-guide render
/ noise / joint flips (and, for the NF pipelines, the nonzero z-score and
gamma) on the device.  JAX's per-sample ``vmap`` is a written
out batch dimension here, and the guide render is kernel B1
(ops/kernels.gaussian_guide_batch), one launch per batch.  A background
thread pool keeps a prefetch queue of raw host batches.

Randomness: the augmentation's draws come in as tensors (``draws``, see
ops/image_ops.draw_augment); the trainer fills them from its seeded
torch.Generator, and the tests inject the draws JAX makes.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from boxsegliver_torch.data.device_cache import widen
from boxsegliver_torch.ops import image_ops
from boxsegliver_torch.ops.kernels import gaussian_guide_batch
from boxsegliver_torch.parallel.mesh import rank_draws

def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """Raw numpy batch -> tensors on ``device``; uint16 windows travel as
    their int16 view (see data/device_cache.widen)."""
    out = {}
    for k, v in batch.items():
        if v.dtype == np.uint16:
            v = v.view(np.int16)
        out[k] = torch.from_numpy(v).to(device, non_blocking=True)
    return out


def _process_one(window, label, crop_hw, *, im_h: int, im_w: int):
    """Device-resize layout: window [bs, C, Hm, Wm] (int16 view) + label
    [bs, Hm, Wm] + crop_hw [bs, 2] -> image [bs, im_h, im_w, C] float32
    and label [bs, im_h, im_w]."""
    img = widen(window).permute(0, 2, 3, 1).float()
    zero = torch.zeros_like(crop_hw[:, 0])
    return image_ops.crop_and_resize_2d(img, label, zero, zero, crop_hw[:, 0],
                                        crop_hw[:, 1], im_h, im_w)


def _process_one_cached(zidx, lab_z, offset, crop_hw, pad_mask, vol_cache,
                        lab_cache, *, im_h: int, im_w: int):
    """Index layout: gather the 2.5D slice windows from the device cache by
    absolute z index, then crop/resize; channels outside the case's z range
    were gathered from the clamped edge slice and are zeroed (the
    zero-pad semantics; normalize maps 0 -> 0)."""
    img = widen(vol_cache[zidx.long()]).permute(0, 2, 3, 1).float()
    lab = lab_cache[lab_z.long()]
    img, lab = image_ops.crop_and_resize_2d(
        img, lab, offset[:, 0], offset[:, 1], crop_hw[:, 0], crop_hw[:, 1],
        im_h, im_w)
    return img * pad_mask[:, None, None, :], lab


def _augment_tail(img, lab, clip, pad_mask, draws, centers, stddevs, n_objs,
                  context, *, im_h: int, im_w: int, noise_scale: float,
                  random_flip: int, use_spatial: bool, min_std: float,
                  zscore: bool = False, use_gamma: bool = False,
                  gamma_range: tuple = (0.7, 1.5), guide_bg: float = 0.5,
                  label_mode: str = "none"):
    """Shared augmentation: normalize (window-level clip, or the nonzero
    z-score of the NF pipelines), guide render (B1), gamma, noise, joint
    flips of image and guide (reference data_processing_train,
    input_pipeline_g.py:347-412; NF z-score / gamma options
    NF/input_pipeline_g.py:295-373).  guide_bg is the guide's background
    (0.5, the Liver remap to [0.5, 1]; 0 for NF's raw Gaussians);
    label_mode 'liver01' merges tumor into liver (only_liver), 'tumor' keeps
    the tumor class only."""
    lab = lab.long()
    if label_mode == "liver01":
        lab = torch.clamp(lab, 0, 1)
    elif label_mode == "tumor":
        lab = (lab == 2).long()

    if zscore:
        img = image_ops.zscore(img)
    else:
        lo = clip[:, 0, None, None, None]
        hi = clip[:, 1, None, None, None]
        img = (torch.clamp(img, lo, hi) - lo) / (hi - lo)

    feats = {}
    if use_spatial:
        valid = (torch.arange(centers.shape[1], device=centers.device)[None]
                 < n_objs[:, None])
        feats["sp_guide"] = gaussian_guide_batch(
            centers.float().contiguous(),
            torch.clamp_min(stddevs.float(), min_std).contiguous(),
            valid.contiguous(), height=im_h, width=im_w,
            scale=1.0 - guide_bg, offset=guide_bg)
    if context is not None:
        feats["context"] = context

    if use_gamma:
        img = image_ops.augment_gamma(img, gamma_range, draws["gamma"],
                                      retain_stats=True, p_per_sample=0.3)
    if noise_scale > 0:
        img = image_ops.random_noise(img, noise_scale, draws["noise"])
        img = img * pad_mask[:, None, None, :]  # no noise in padded z slices

    if random_flip:
        if use_spatial:
            c = img.shape[-1]
            joint = torch.cat([img, feats["sp_guide"]], dim=-1)
            joint, lab = image_ops.random_flip(joint, lab, draws["flip"],
                                               flip=random_flip)
            img, feats["sp_guide"] = joint[..., :c], joint[..., c:]
        else:
            img, lab = image_ops.random_flip(img, lab, draws["flip"],
                                             flip=random_flip)
    feats["images"] = img
    return feats, lab


def _process_batch(batch: Dict[str, torch.Tensor], draws: Optional[Dict],
                   *, im_h: int, im_w: int, noise_scale: float,
                   random_flip: int, use_spatial: bool, min_std: float,
                   cache=None, **norm_kw):
    """Whole-batch processing: (features dict, labels [bs, h, w] int64).

    Three input layouts (data/sampler.TrainSampler): host-resized images,
    device-resize pixel windows, or slice indices into ``cache``.
    ``draws`` holds the augmentation's random draws
    (ops/image_ops.draw_augment); it may be None when noise, gamma and
    flips are off."""
    bs = batch["names"].shape[0]
    dev = batch["names"].device
    centers = batch.get("centers", torch.full((bs, 1, 2), -1.0, device=dev))
    stddevs = batch.get("stddevs", torch.ones((bs, 1, 2), device=dev))
    n_objs = batch.get("n_objs", torch.zeros((bs,), dtype=torch.int32,
                                             device=dev))
    if "zidx" in batch:
        img, lab = _process_one_cached(
            batch["zidx"], batch["lab_z"], batch["offset"], batch["crop_hw"],
            batch["pad_mask"], cache.volume, cache.label, im_h=im_h,
            im_w=im_w)
    elif "image" in batch:          # host layout: resized on the host
        img, lab = widen(batch["image"]).float(), batch["label"]
    else:
        img, lab = _process_one(batch["window"], batch["label"],
                                batch["crop_hw"], im_h=im_h, im_w=im_w)
    feats, labels = _augment_tail(
        img, lab, batch["clip"], batch["pad_mask"], draws, centers, stddevs,
        n_objs, batch.get("context"), im_h=im_h, im_w=im_w,
        noise_scale=noise_scale, random_flip=random_flip,
        use_spatial=use_spatial, min_std=min_std, **norm_kw)
    feats["names"] = batch["names"]
    return feats, labels


_TASK_LABEL_MODES = {"only_liver": "liver01", "tumor": "tumor"}


def norm_statics(args) -> Dict:
    """Modality/task-dependent statics for _process_batch: z-score + gamma
    options, the guide background (0.5 Liver remap vs 0.0 NF raw Gaussian)
    and the task's label mapping."""
    task = getattr(args, "task", "liver")
    return dict(zscore=bool(getattr(args, "zscore", False)),
                use_gamma=bool(getattr(args, "gamma", False)),
                gamma_range=tuple(getattr(args, "gamma_range", (0.7, 1.5))),
                guide_bg=0.0 if task.startswith("nf") else 0.5,
                label_mode=_TASK_LABEL_MODES.get(task, "none"))


def make_preprocess_fn(args, cache=None, group=None):
    """(device batch, generator) -> (features, labels): the train step's
    augmentation, its draws taken from ``generator``.  Under a ``group``
    (parallel.Group) the batch holds the rank's rows of the global batch:
    the draws are made for the global batch, from the generator every rank
    shares, and the rank keeps its rows (B1 renders only those)."""
    statics = norm_statics(args)
    kw = dict(im_h=args.im_height, im_w=args.im_width,
              noise_scale=float(args.noise_scale),
              random_flip=int(args.random_flip),
              use_spatial=bool(getattr(args, "use_spatial", False)),
              min_std=float(getattr(args, "min_std", 2.0)))

    def fn(batch, generator):
        bs = batch["names"].shape[0] * (group.size if group else 1)
        draws = rank_draws(image_ops.draw_augment(
            generator, (bs, kw["im_h"], kw["im_w"], args.im_channel),
            noise=kw["noise_scale"] > 0, device=batch["names"].device,
            gamma=statics["use_gamma"]), group)
        return _process_batch(batch, draws, cache=cache, **kw, **statics)
    return fn


class TrainDataset:
    """Prefetching iterator of raw host batches (replaces tf.data
    prefetch(AUTOTUNE), reference input_pipeline_g.py:756-766).

    Worker threads run ``sampler.sample_batch`` concurrently, each with its
    own ``np.random.RandomState([seed & 0x7FFFFFFF, 0xB0D5E6, wid])``, as the
    JAX package seeds them: one worker yields the JAX package's batches.
    The trainer uploads each batch and runs the device augmentation
    (make_preprocess_fn) inside its step."""

    def __init__(self, sampler, args, seed: int = 0, prefetch: int = 4,
                 workers: Optional[int] = None):
        self.sampler = sampler
        self.batch_size = args.batch_size
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = []
        n_workers = (workers if workers is not None
                     else getattr(args, "host_workers", 2))
        for wid in range(max(1, n_workers)):
            rng = np.random.RandomState([seed & 0x7FFFFFFF, 0xB0D5E6, wid])
            t = threading.Thread(target=self._worker, args=(rng,), daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, rng):
        while not self._stop.is_set():
            batch = self.sampler.sample_batch(self.batch_size, rng=rng)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        # drain so workers blocked on put() can exit
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)
