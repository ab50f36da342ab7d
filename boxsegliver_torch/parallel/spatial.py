"""Spatial sharding: one image or volume split over the ranks of a group
along one spatial axis (counterpart of XLA's SPMD partitioning of the JAX
package's sharded evals: the height-sharded TTA forward of
interactive/device_sweep.py:60-67,170-177 and the depth-sharded UNet3D eval
of evaluators/volume3d.py:82-91).

XLA partitions every operation of the model for a sharded axis.  The port
writes that out for the operations GUNet and UNet3D use, on the rank's
block of the axis (``Group.block``: whole multiples of the network's total
stride, so pooling and strides stay aligned):

- SAME convolutions exchange a halo with the neighbouring ranks and pad the
  sharded axis with it (``Group.halo``); a strided one takes its pads from
  the global size (``layers.same_pads``), so its block must start on a
  multiple of the stride;
- pools and transpose convolutions stay local (blocks are aligned; only
  the last rank's block may be ragged, and its edge is the global edge);
- instance norm sums its planes' partial statistics over the ranks
  (``ops/kernels.instance_norm_stats_split``: kernel B2s, one all-reduce,
  then kernel B2y for the full-affine + ReLU blocks or the plain affine of
  ``Norm``);
- spatial means (``--use_se``), ``image_gradients``' dy and the
  whole-volume z-score reduce or exchange over the ranks as well.

``sharded(model, group)`` points the layers of ``model`` at one
``SpatialShard`` for the duration of a forward; outside it the model runs
unsharded exactly as before.  Inference only, as in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F

from boxsegliver_torch.models import layers
from boxsegliver_torch.models.layers import same_pads
from boxsegliver_torch.ops.kernels import instance_norm_stats_split


class SpatialShard:
    """This rank's block over ``group`` of the first spatial axis of the
    NCHW / NCDHW activations (H for GUNet, D for UNet3D)."""

    dim = 2

    def __init__(self, group):
        self.group = group

    @property
    def last(self) -> bool:
        return self.group.rank == self.group.size - 1

    def global_size(self, local: int, device) -> int:
        """The sharded axis's global size: the blocks' sizes summed."""
        t = torch.full((1,), float(local), dtype=torch.float64, device=device)
        return int(self.group.all_reduce_(t).item())

    def pad_for_conv(self, x: torch.Tensor, kernel: int, stride: int,
                     dilation: int = 1) -> torch.Tensor:
        """``x`` padded along the sharded axis for a SAME conv of
        ``kernel`` / ``stride`` / ``dilation`` with no padding on that
        axis: the global pads before the first and after the last block,
        the neighbours' rows between blocks."""
        size = x.shape[self.dim]
        k_eff = (kernel - 1) * dilation + 1
        if stride == 1:
            p0, p1 = same_pads(size, kernel, 1, dilation)  # size-free
            return self.group.halo(x, self.dim, p0, p1)
        if not self.last and size % stride:
            raise ValueError(f"a block of {size} rows is not a multiple of "
                             f"the conv's stride {stride}")
        p0, p1 = same_pads(self.global_size(size, x.device), kernel, stride,
                            dilation)
        return self.group.halo(x, self.dim, p0, max(k_eff - stride - p0, 0),
                               last_hi=p1)

    def conv(self, x: torch.Tensor, weight: torch.Tensor, bias,
             stride: Sequence[int], dilation: Sequence[int]) -> torch.Tensor:
        """A SAME conv (2-D or 3-D) of this rank's block: the sharded axis
        padded by ``pad_for_conv``, the others by ``same_pads``."""
        nd = x.ndim - 2
        pads = []
        for a in range(nd):
            k, s, d = weight.shape[2 + a], stride[a], dilation[a]
            if 2 + a == self.dim:
                x = self.pad_for_conv(x, k, s, d)
                pads.append((0, 0))
            else:
                pads.append(same_pads(x.shape[2 + a], k, s, d))
        if any(p for pair in pads for p in pair):
            x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        conv = F.conv2d if nd == 2 else F.conv3d
        return conv(x, weight, bias, stride=tuple(stride),
                    dilation=tuple(dilation))

    def instance_norm(self, x: torch.Tensor, weight, bias,
                      eps: float) -> torch.Tensor:
        """``layers.Norm``'s instance norm of planes split over the ranks:
        the statistics of instance_norm_stats_split, then Norm's own
        float32 arithmetic."""
        mean, rstd = instance_norm_stats_split(x, self.group, eps)
        view = tuple(x.shape[:2]) + (1,) * (x.ndim - 2)
        mul = rstd.view(view)
        cview = (1, -1) + (1,) * (x.ndim - 2)
        if weight is not None:
            mul = mul * weight.view(cview)
        y = (x.float() - mean.view(view)) * mul
        if bias is not None:
            y = y + bias.view(cview)
        return y.to(x.dtype)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every spatial axis of [N, C, *S] (``--use_se``'s
        squeeze), from float32 local sums all-reduced in float64 with the
        element count; in x's dtype."""
        dims = tuple(range(2, x.ndim))
        local = x.float().sum(dim=dims).double().reshape(-1)
        count = torch.full((1,), float(x[0, 0].numel()), dtype=torch.float64,
                           device=x.device)
        buf = self.group.all_reduce_(torch.cat([local, count]))
        return (buf[:-1] / buf[-1]).view(x.shape[:2]).to(x.dtype)

    def image_gradients(self, images: torch.Tensor):
        """``layers.image_gradients`` of NHWC images sharded over H (tensor
        axis 1): dy takes the next rank's first row, and only the last
        rank's last row is zero."""
        ext = self.group.halo(images, 1, 0, 1)
        dy = ext[:, 1:] - ext[:, :-1]
        if self.last:
            dy = torch.cat([dy[:, :-1], torch.zeros_like(dy[:, :1])], dim=1)
        dx = torch.cat([images[:, :, 1:] - images[:, :, :-1],
                        torch.zeros_like(images[:, :, :1])], dim=2)
        return dy, dx

    def zscore(self, img: torch.Tensor) -> torch.Tensor:
        """``ops/image_ops.zscore`` of a batch of one sample whose voxels
        are split over the ranks: (count, Σx) over the non-zero region
        all-reduced, then the centred Σ(x − mean)² (float32 local sums,
        float64 all-reduces)."""
        region = (img > 0).float()
        buf = torch.stack([region.sum(), (img * region).sum()]).double()
        buf = self.group.all_reduce_(buf)
        cnt = torch.clamp_min(buf[0], 1.0)
        mean = (buf[1] / cnt).float()
        sq = (torch.square(img - mean) * region).sum().double().reshape(1)
        var = (self.group.all_reduce_(sq)[0] / cnt).float()
        return (img - region * mean) / (region * torch.sqrt(var) + 1e-8)


_SHARDABLE = (layers.Conv, layers.Conv3, layers.Norm, layers.ConvNormAct)


def shard_modules(model: torch.nn.Module):
    """The modules of ``model`` that take a ``spatial`` shard: its convs,
    norms and conv-norm-act blocks, and the model itself, but none under
    GUNet's ``context`` subnet (it reads a vector or the nf2 patch pyramid,
    which stay whole on every rank)."""
    mods = [model]
    for name, m in model.named_modules():
        if name.split(".")[0] == "context":
            continue
        if isinstance(m, _SHARDABLE):
            mods.append(m)
    return mods


@contextlib.contextmanager
def sharded(model: torch.nn.Module, group):
    """``model``'s forward on this rank's block of the first spatial axis
    of its NC* activations for the duration of the block; without a group
    of more than one rank it changes nothing."""
    if group is None or group.size == 1:
        yield model
        return
    mods = shard_modules(model)
    shard = SpatialShard(group)
    for m in mods:
        m.spatial = shard
    try:
        yield model
    finally:
        for m in mods:
            m.spatial = None
