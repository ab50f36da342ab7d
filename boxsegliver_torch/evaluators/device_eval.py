"""Device-resident whole-case 2D evaluation (port of
boxsegliver_tpu/evaluators/device_eval.py:30-201).

The case uploads ONCE and is resized on the device with the
cv2.INTER_LINEAR-equivalent bilinear resize (ops/image_ops.py; the JAX
package resizes it on the host with cv2); then each slice batch forms its
2.5D channel stacks by a gather on the device, runs all mirror variants as
one batch-stacked forward and averages the flipped-back softmax
probabilities in float32.  Only the mirror-averaged probabilities come back
to the host.  Same math as the host route (evaluators/eval_loader
.slice_batches + EvaluateVolume.predict_case), in another order.

The JAX package pads the case's z axis to a multiple of 64 so that case
depth does not retrace its jit; the port has nothing to retrace and does
not pad.  Rows of the last batch past the case's depth gather the clipped
last slice instead of padding zeros; they are cut off, and eval-mode norms
are per sample, so the kept rows equal the JAX ones.

A per-slice guide (``sp_guide``, [cz, h, w]: a host array, or a tensor that
run_sp's B1 launch left on the device) is fed as the fg channel; a model
that takes a two-channel click guide (models.guide_channels: UNetInter, or
any model of the nf_inter task) gets a zero bg channel beside it, the
[fg, bg] layout it was trained on.  JAX feeds the one channel only, which
its flax model refuses when it was built for two.

Under a data-parallel ``group`` (JAX's ``mesh=``, device_eval.py:50-87)
--batch_size stays the global slice batch and must divide the group: each
rank uploads the whole case (JAX replicates it), runs its rows of every
slice batch (all mirror variants in one forward) and rank 0 gathers the
probabilities and returns the volume; the other ranks return None.  The
plain per-batch forward splits the batch the same way and gives every
rank the whole batch's probabilities.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from boxsegliver_torch.evaluators.eval_loader import EvalCase
from boxsegliver_torch.interactive.propagation import mirror_variants
from boxsegliver_torch.models import guide_channels
from boxsegliver_torch.ops.image_ops import resize_bilinear
from boxsegliver_torch.parallel.mesh import per_device_batch_size


def _resize_stack(arr: np.ndarray, pshape, device="cpu") -> torch.Tensor:
    """[Z, h, w] -> [Z, ph, pw] float32 on ``device``, bilinear (cv2
    INTER_LINEAR semantics)."""
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
    return resize_bilinear(x, pshape).contiguous()


class DeviceSlicePredictor:
    """predict_fn for EvaluateVolume: ``.device_case(case, context,
    sp_guide)``, which EvaluateVolume prefers over the host slice-batch
    route, and ``__call__(features)``, the plain per-batch forward."""

    def __init__(self, model: torch.nn.Module, args, device="cuda",
                 group=None):
        self.args = args
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.pshape = (int(args.im_height), int(args.im_width))
        self.bs = int(args.batch_size)
        self.group = group
        self.local_bs = (self.bs if group is None
                         else per_device_batch_size(self.bs, group.size))
        self.flips = tuple(mirror_variants(
            int(getattr(args, "random_flip", 3)),
            bool(getattr(args, "eval_mirror", False))))
        self.guide_channels = guide_channels(args)

    @torch.inference_mode()
    def __call__(self, feats) -> torch.Tensor:
        """Softmax probabilities [bs, h, w, nc] (float32, on the device) of
        one feature batch; host arrays are uploaded first."""
        feats = {k: torch.as_tensor(v, device=self.device)
                 for k, v in feats.items() if k != "names"}
        if self.group is None:
            return torch.softmax(self.model(feats).float(), dim=-1)
        local = self.group.take_rows(feats)
        probs = torch.softmax(self.model(local).float(), dim=-1)
        return self.group.gather_rows(probs.contiguous())

    def _forward(self, vol: torch.Tensor, guide: Optional[torch.Tensor],
                 ctx: Optional[torch.Tensor], z0: int, c: int) -> torch.Tensor:
        """Mirror-averaged probabilities [b, ph, pw, nc] of this rank's
        rows z0 + r·b .. z0 + (r + 1)·b − 1 of the slice batch at z0 (b the
        rows a rank; vol: [cz + c − 1, ph, pw])."""
        bs = self.local_bs
        z0 = z0 + (0 if self.group is None else self.group.rank * bs)
        rows = torch.arange(z0, z0 + bs, device=self.device)
        zs = torch.clamp(rows, max=vol.shape[0] - c)
        idx = zs[:, None] + torch.arange(c, device=self.device)[None]
        feats = {"images": vol[idx].permute(0, 2, 3, 1)}   # [bs, ph, pw, c]
        if guide is not None:
            g = guide[torch.clamp(rows, max=guide.shape[0] - 1)][..., None]
            if self.guide_channels > 1:
                g = torch.cat([g, g.new_zeros(g.shape[:-1] + (
                    self.guide_channels - 1,))], dim=-1)
            feats["sp_guide"] = g
        if ctx is not None:
            feats["context"] = ctx[torch.clamp(rows, max=ctx.shape[0] - 1)]
        big = {}
        for k, v in feats.items():
            if k == "context":
                big[k] = v.repeat(len(self.flips), 1)
            else:
                big[k] = torch.cat([v.flip(axes) if axes else v
                                    for axes in self.flips])
        probs = torch.softmax(self.model(big).float(), dim=-1)
        acc = 0.0
        for i, axes in enumerate(self.flips):
            p = probs[i * bs:(i + 1) * bs]
            acc = acc + (p.flip(axes) if axes else p) / len(self.flips)
        return acc

    @torch.inference_mode()
    def device_case(self, case: EvalCase,
                    context: Optional[np.ndarray] = None,
                    sp_guide=None) -> Optional[np.ndarray]:
        """Mirror-averaged softmax volume [cz, ph, pw, nc] for one case —
        the device-resident equivalent of EvaluateVolume.predict_case
        (under a group: on rank 0, None elsewhere)."""
        c = case.lhc + case.rhc + 1
        cz = case.depth
        vol = _resize_stack(np.asarray(case.volume), self.pshape, self.device)
        guide = ctx = None
        if isinstance(sp_guide, torch.Tensor):
            guide = resize_bilinear(sp_guide.to(self.device),
                                    self.pshape).contiguous()
        elif sp_guide is not None:
            guide = _resize_stack(np.asarray(sp_guide), self.pshape,
                                  self.device)
        if context is not None:
            # per-cropped-slice rows, like slice_batches' absolute-z mapping
            z0 = case.crop[0]
            rows = np.zeros((cz, context.shape[1]), np.float32)
            valid = max(0, min(cz, context.shape[0] - z0))
            if valid:
                rows[:valid] = context[z0:z0 + valid]
            ctx = torch.from_numpy(rows).to(self.device)
        chunks = [self._forward(vol, guide, ctx, b0, c)
                  for b0 in range(0, cz, self.bs)]
        if self.group is None:
            return torch.cat(chunks)[:cz].cpu().numpy()
        # [batches, b, ...] of this rank's rows, to rank 0
        parts = self.group.gather_to_chief(torch.stack(chunks).cpu().numpy())
        if parts is None:
            return None
        # batch j holds rank 0's rows, then rank 1's, ...
        whole = np.concatenate(parts, axis=1)
        return whole.reshape((-1,) + whole.shape[2:])[:cz]
