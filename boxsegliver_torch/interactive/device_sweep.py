"""Device-resident interactive guided eval: both Forward/Backward
guide-propagation sweeps of one case, batched, on the GPU (port of
boxsegliver_tpu/interactive/device_sweep.py:48-330).

Each slice's spatial guide is rendered from the PREVIOUS slice's filtered
prediction, so a sweep is sequential.  The JAX package compiles it into one
``lax.scan``; here it is a Python loop over slices whose body stays on the
card: guide render (kernel B1, with the ``* discount / 2 + GUIDE_BG``
epilogue fused) → mirror-TTA GUNet forward → CC labeling → FP filtering →
robust moments (ops/labeling.py).  The carry is the propagated object state
(fixed K slots: center / stddev / z-range / valid).  Both directions are
independent until the final max-merge and run as one batch of 2, as the
JAX ``vmap`` does, so every step runs 2 x n_mirrors images through the net.
The case uploads once and the merged probability volume comes back once.

Same semantics as the JAX sweep, including its two documented tie-breaks
(candidate guides at exactly equal distance are tried in slot order; the
Wu-line pixel chain is evaluated in closed-form float32).  Slices with more
than ``max_objects`` predicted components report an overflow; the
evaluator then falls back to the per-slice host loop
(interactive/propagation.py), which calls the predictor itself
(``__call__``) on each slice's mirror stack.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from boxsegliver_torch.evaluators.device_eval import _resize_stack
from boxsegliver_torch.evaluators.eval_loader import EvalCase
from boxsegliver_torch.interactive.propagation import GUIDE_BG, mirror_variants
from boxsegliver_torch.ops.kernels import gaussian_guide_batch
from boxsegliver_torch.ops.labeling import (label_components, object_moments,
                                            ordered_seeds, wu_ascent)

_STD_BUCKETS = (4, 8, 16, 32)
_DEPTH_BUCKETS = (32, 64, 96, 128, 192, 256)


def _bucket(n: int, buckets=_STD_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class GuidedSweepPredictor:
    """predict_fn for EvaluateVolume.run_g: ``.sweep_case`` runs one case's
    double sweep on ``device``."""

    def __init__(self, model: torch.nn.Module, args, num_classes: int,
                 tumor_id: int, device="cuda"):
        self.args = args
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.pshape = (int(args.im_height), int(args.im_width))
        self.min_std = float(getattr(args, "min_std", 2.0))
        self.eval_discount = float(getattr(args, "eval_discount", 0.85))
        self.num_classes = int(num_classes)
        self.tumor_id = int(tumor_id)
        self.max_objects = int(getattr(args, "sweep_max_objects", 16) or 16)
        self.flips = tuple(mirror_variants(
            int(getattr(args, "random_flip", 3)),
            bool(getattr(args, "eval_mirror", False))))
        self.steps = 0      # sweep steps run (each renders one guide batch)

    @torch.inference_mode()
    def __call__(self, feats) -> torch.Tensor:
        """Softmax probabilities [n, ph, pw, nc] (float32, on the device) of
        one feature batch: the host loop's per-slice mirror stack (JAX
        device_sweep.py:90); host arrays are uploaded first."""
        feats = {k: torch.as_tensor(v, device=self.device)
                 for k, v in feats.items()}
        return torch.softmax(self.model(feats).float(), dim=-1)

    # ------------------------------------------------------------------
    # host-side per-case precompute
    # ------------------------------------------------------------------

    def _user_prior_arrays(self, case: EvalCase, prior_case: Dict,
                           d_pad: int, mu: int):
        """Per-cropped-slice padded user-prior arrays, applying the host
        loader's filter + coordinate transform (propagation.py:93-101 of
        the JAX package)."""
        ph, pw = self.pshape
        z1 = case.crop[0]
        y1, x1 = case.crop[2], case.crop[4]
        ch, cw = case.volume.shape[1:]
        centers = np.zeros((d_pad, mu, 2), np.int32)
        stds = np.full((d_pad, mu, 2), -1.0, np.float32)
        zr = np.zeros((d_pad, mu, 2), np.int32)
        valid = np.zeros((d_pad, mu), bool)
        overflow = False
        for sid_str, objs in (prior_case or {}).items():
            idx = int(sid_str) - z1
            if not 0 <= idx < case.depth:
                continue
            k = 0
            for obj in objs:
                if np.min(obj["stddev"]) <= self.min_std:
                    continue
                if k >= mu:
                    overflow = True
                    break
                centers[idx, k] = [int((obj["center"][0] - y1) / ch * ph),
                                   int((obj["center"][1] - x1) / cw * pw)]
                stds[idx, k] = obj["stddev"]
                zr[idx, k] = obj["z"]
                valid[idx, k] = True
                k += 1
        return centers, stds, zr, valid, overflow

    # ------------------------------------------------------------------
    # the double sweep
    # ------------------------------------------------------------------

    def _forward_tta(self, images: torch.Tensor, guide: torch.Tensor,
                     ctx: Optional[torch.Tensor]) -> torch.Tensor:
        """images [B, ph, pw, c]; guide [B, ph, pw] -> mirror-averaged
        softmax probs [B, ph, pw, nc].  All mirrors of all B samples run as
        one forward; sample b of mirror f sits at row f * B + b."""
        n = len(self.flips)
        ims = [images.flip(axes) if axes else images for axes in self.flips]
        gds = [guide.flip(axes) if axes else guide for axes in self.flips]
        feats = {"images": torch.cat(ims), "sp_guide": torch.cat(gds)[..., None]}
        if ctx is not None:
            feats["context"] = ctx.repeat(n, 1)
        logits = self.model(feats)
        probs = torch.softmax(logits.float(), dim=-1)
        probs = probs.reshape((n, images.shape[0]) + probs.shape[1:])
        acc = torch.zeros_like(probs[0])
        for i, axes in enumerate(self.flips):
            acc = acc + (probs[i].flip(axes) if axes else probs[i])
        return acc / n

    def _sweep(self, vol, ctx_rows, user, sid0: int, cz: int, d_pad: int,
               channels: int):
        """Both sweeps as one batch of 2: returns (merged probs [d_pad, ph,
        pw, nc], max object count over the real slices)."""
        dev = self.device
        ph, pw = self.pshape
        k_obj = self.max_objects
        sentinel = ph * pw
        thresh = 0.15 + GUIDE_BG
        u_center, u_std, u_zr, u_valid = user

        fwd_order = torch.arange(d_pad, device=dev)
        orders = torch.stack([fwd_order, fwd_order.flip(0)])      # [2, d_pad]
        fwd_sweep = torch.tensor([True, False], device=dev)
        p_valid = torch.zeros((2, k_obj), dtype=torch.bool, device=dev)
        p_center = torch.zeros((2, k_obj, 2), dtype=torch.int32, device=dev)
        p_std = torch.full((2, k_obj, 2), -1.0, device=dev)
        p_zr = torch.zeros((2, k_obj, 2), dtype=torch.int32, device=dev)
        probs_out = torch.empty((2, d_pad, ph, pw, self.num_classes),
                                device=dev)
        n_objs_out = torch.empty((2, d_pad), dtype=torch.int32, device=dev)

        for t in range(d_pad):
            idx = orders[:, t]
            sid = idx + sid0
            centers = torch.cat([u_center[idx], p_center], 1).float()  # [2, M, 2]
            stds = torch.clamp_min(torch.cat([u_std[idx], p_std], 1),
                                   self.min_std)
            zrs = torch.cat([u_zr[idx], p_zr], 1)
            valid = torch.cat([u_valid[idx], p_valid], 1)

            guide = gaussian_guide_batch(
                centers, stds, valid, height=ph, width=pw,
                scale=self.eval_discount / 2.0, offset=GUIDE_BG)[..., 0]
            self.steps += 1

            images = torch.stack([vol[i:i + channels]
                                  for i in (t, d_pad - 1 - t)])
            images = images.permute(0, 2, 3, 1)
            ctx = ctx_rows[idx] if ctx_rows is not None else None
            probs = self._forward_tta(images, guide, ctx)

            pred = torch.argmax(probs, dim=-1) == self.tumor_id
            labels = label_components(pred)
            seeds, n_objs = ordered_seeds(labels, k_obj)           # [2, K]
            obj_valid = seeds < sentinel
            obj = ((labels[:, None] == seeds[:, :, None, None])
                   & obj_valid[:, :, None, None])                  # [2, K, h, w]

            masked = torch.where(obj, guide[:, None], -1.0).reshape(
                2, k_obj, -1)
            support = masked.amax(dim=-1) >= thresh
            flat_peak = torch.argmax(masked, dim=-1)
            peak = torch.stack([flat_peak // pw, flat_peak % pw], dim=-1)

            ic = centers.to(torch.int32)
            exact = (valid[:, None]
                     & (peak[:, :, None, 0] == ic[:, None, :, 0])
                     & (peak[:, :, None, 1] == ic[:, None, :, 1]))  # [2, K, M]
            any_exact = exact.any(dim=-1)
            j_exact = torch.argmax(exact.to(torch.uint8), dim=-1)

            diff = peak[:, :, None].float() - centers[:, None]
            dist = torch.where(valid[:, None], (diff ** 2).sum(-1),
                               float("inf"))
            order = torch.argsort(dist, dim=-1, stable=True)
            asc = wu_ascent(guide, peak, ic)
            cand = torch.gather(valid[:, None] & asc, -1, order)
            has_cand = cand.any(dim=-1)
            j_near = torch.gather(
                order, -1,
                torch.argmax(cand.to(torch.uint8), dim=-1, keepdim=True))[..., 0]

            found = torch.where(any_exact, j_exact, j_near)
            found_ok = any_exact | has_cand
            zr_f = torch.gather(zrs, 1, found[..., None].expand(-1, -1, 2))
            sid_c = sid[:, None]
            zfail = torch.where(fwd_sweep[:, None], sid_c >= zr_f[..., 1],
                                sid_c <= zr_f[..., 0])
            p_valid = obj_valid & support & found_ok & ~zfail

            m_center, p_std = object_moments(obj, min_std=self.min_std)
            p_center = m_center.to(torch.int32)
            p_zr = zr_f
            probs_out[:, t] = probs
            n_objs_out[:, t] = n_objs

        merged = torch.maximum(probs_out[0], probs_out[1].flip(0))
        # overflow only counts REAL slices: z-padding slices see a flat
        # GUIDE_BG guide, so every object there fails the support threshold
        # and cannot enter the propagation state
        n_objs_out = torch.where(orders < cz, n_objs_out, 0)
        return merged, int(n_objs_out.max())

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def sweep_case(self, case: EvalCase, prior_case: Dict,
                   context: Optional[np.ndarray] = None
                   ) -> Tuple[Optional[np.ndarray], int]:
        """Merged Forward/Backward probability volume [cz, ph, pw, nc] for
        one case, or (None, n_objs) when an object/prior count overflowed
        the static caps."""
        dev = self.device
        cz = case.depth
        channels = case.lhc + case.rhc + 1
        d_pad = max(_bucket(cz, _DEPTH_BUCKETS), cz)
        mu_needed = max((sum(1 for o in objs
                             if np.min(o["stddev"]) > self.min_std)
                         for objs in (prior_case or {}).values()), default=0)
        mu = _bucket(max(mu_needed, 1))

        *user, overflow = self._user_prior_arrays(case, prior_case, d_pad, mu)
        if overflow:
            return None, -1
        user = tuple(torch.from_numpy(u).to(dev) for u in user)

        vol = _resize_stack(np.asarray(case.volume), self.pshape, dev)
        z_extra = d_pad + channels - 1 - vol.shape[0]
        if z_extra > 0:
            vol = torch.cat([vol, vol.new_zeros((z_extra,) + vol.shape[1:])])

        ctx_rows = None
        if context is not None:
            z0 = case.crop[0]
            rows = np.zeros((d_pad, context.shape[1]), np.float32)
            valid_rows = max(0, min(cz, context.shape[0] - z0))
            if valid_rows:
                rows[:valid_rows] = context[z0:z0 + valid_rows]
            ctx_rows = torch.from_numpy(rows).to(dev)

        merged, n_max = self._sweep(vol, ctx_rows, user, int(case.crop[0]),
                                    cz, d_pad, channels)
        if n_max > self.max_objects:
            return None, n_max
        return merged[:cz].cpu().numpy(), n_max
