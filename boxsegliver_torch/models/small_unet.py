"""SmallUNet: a three-level UNet from a kernel / stride table with a dilated
bridge (port of boxsegliver_tpu/models/small_unet.py:36-116, the unpacked
path; reference NetworksV2/SmallUNet.py:28-120).  Input = concat(images,
sp_guide).

Downsampling is by stride-2 convs (no pools; XLA's SAME padding), the
bridge and the first decoder stage run dilated (rate 2) at 1/8 resolution,
the up stages are bias-free transpose convs.  Every conv block is conv +
norm + ReLU, so under instance norm all 19 run kernel B2.  NHWC at the
boundary, NCHW inside; modules carry the flax names (``conv_e1_conv1``,
``bridge_conv2``, ``conv_d2_up``, ``logits``).  ``lane_pack`` is accepted
and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from boxsegliver_torch.models.layers import (Conv, ConvNormAct, UpConv,
                                             flax_init_)

# reference SmallUNet.py:31-57 (config[3]): (out, stride, dilation)
_CONFIG3 = {
    "conv_e0": [(64, 1, 1), (64, 1, 1)],
    "conv_e1": [(128, 2, 1), (128, 1, 1)],
    "conv_e2": [(256, 2, 1), (256, 1, 1)],
    "conv_e3": [(512, 2, 1), (512, 1, 1)],
    "bridge": [(1024, 1, 2), (1024, 1, 2)],
    "conv_d3": [(512, 1, 2), (512, 1, 1), (512, 1, 1)],
    "conv_d2": [("up", 256), (256, 1, 1), (256, 1, 1)],
    "conv_d1": [("up", 128), (128, 1, 1), (128, 1, 1)],
    "conv_d0": [("up", 64), (64, 1, 1), (64, 1, 1)],
}


class SmallUNet(nn.Module):

    def __init__(self, num_classes: int = 2, init_channel_factor: float = 1.0,
                 num_pool_layers: int = 3, normalizer: str = "instance_norm",
                 without_norm: bool = False, weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None, lane_pack: bool = False,
                 in_channels: int = 3, guide_channels: int = 2):
        super().__init__()
        if num_pool_layers != 3:
            raise ValueError("SmallUNet only defines num_pool_layers=3 "
                             "(reference SmallUNet.py:31)")
        self.weight_init = weight_init
        self.dtype = dtype
        norm = None if without_norm else normalizer
        cin = in_channels + guide_channels
        skip = {}
        for block, layers in _CONFIG3.items():
            for k, spec in enumerate(layers):
                out = round(spec[1] * init_channel_factor) if spec[0] == "up" \
                    else round(spec[0] * init_channel_factor)
                if spec[0] == "up":
                    self.add_module(f"{block}_up",
                                    UpConv(cin, out, use_bias=False))
                    cin = out + skip[block.replace("d", "e")]
                else:
                    _, stride, dil = spec
                    self.add_module(f"{block}_conv{k + 1}", ConvNormAct(
                        cin, out, normalizer=norm, strides=stride,
                        dilation=dil))
                    cin = out
            skip[block] = cin
        self.logits = Conv(cin, num_classes, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from a seeded generator (layers.flax_init_)."""
        return flax_init_(self, self.weight_init, generator)

    def forward(self, inputs, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the trainer's calling convention;
        the model draws nothing."""
        dt = self.dtype or torch.float32
        images = inputs["images"]
        x = torch.cat([images, inputs["sp_guide"].to(images.dtype)], dim=-1)
        x = x.to(dt).permute(0, 3, 1, 2)
        skips = {}
        for block, layers in _CONFIG3.items():
            for k, spec in enumerate(layers):
                if spec[0] == "up":
                    x = self._modules[f"{block}_up"](x)
                    x = torch.cat([skips[block.replace("d", "e")], x], dim=1)
                else:
                    x = self._modules[f"{block}_conv{k + 1}"](x, train=train)
            if block.startswith("conv_e") or block == "bridge":
                skips[block] = x
        return self.logits(x).float().permute(0, 2, 3, 1)
