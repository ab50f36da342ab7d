"""InterUNet: a two-stream encoder — images + click guide, and images (+ the
Sobel edges of the middle channel under ``img_grad``) — merged at the
bottleneck, with a decoder that concatenates the skips of both streams
(port of boxsegliver_tpu/models/inter_unet.py:37-149, the unpacked path;
reference NetworksV2/InterUNet.py:28-170).

Downsampling is by stride-2 convs (XLA's SAME padding), the merge and the
first decoder stage run dilated (rate 2) at 1/8 resolution, the up stages
are bias-free transpose convs.  Every conv block is conv + norm + ReLU, so
under instance norm all 25 run kernel B2.  Input and output are NHWC
(``{"images", "sp_guide"}`` -> float32 logits); NCHW inside.  Modules carry
the flax names (``image_e0_conv1``, ``inter_e1_conv2``, ``merge_e3_conv3``,
``conv_d2_up``, ``logits``), so the weight bridge maps them by rule.
``lane_pack`` (a TPU layout of the same math) is accepted and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from boxsegliver_torch.models.layers import (Conv, ConvNormAct, UpConv,
                                             flax_init_, sobel_edges)

# reference InterUNet.py:28-67 (config[3]): (out, stride, dilation)
_STREAM = {
    "e0": [(32, 1, 1), (32, 1, 1)],
    "e1": [(64, 2, 1), (64, 1, 1)],
    "e2": [(128, 2, 1), (128, 1, 1)],
}
_MERGE = [(512, 2, 1), (512, 1, 1), (1024, 1, 2), (1024, 1, 2)]
_DECODER = {
    "conv_d3": [(512, 1, 2), (512, 1, 1), (512, 1, 1)],
    "conv_d2": [("up", 256), (256, 1, 1), (256, 1, 1)],
    "conv_d1": [("up", 128), (128, 1, 1), (128, 1, 1)],
    "conv_d0": [("up", 64), (64, 1, 1), (64, 1, 1)],
}


class InterUNet(nn.Module):

    def __init__(self, num_classes: int = 2, init_channel_factor: float = 1.0,
                 num_pool_layers: int = 3, img_grad: bool = False,
                 normalizer: str = "instance_norm", without_norm: bool = False,
                 weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None, lane_pack: bool = False,
                 in_channels: int = 3, guide_channels: int = 2):
        super().__init__()
        if num_pool_layers != 3:
            raise ValueError("InterUNet only defines num_pool_layers=3 "
                             "(reference InterUNet.py:28)")
        self.img_grad = img_grad
        self.weight_init = weight_init
        self.dtype = dtype
        norm = None if without_norm else normalizer

        def width(out):
            return round(out * init_channel_factor)

        skip = {}
        for prefix, cin in (("image", in_channels + guide_channels),
                            ("inter", in_channels + (2 if img_grad else 0))):
            for key, layers in _STREAM.items():
                for k, (out, stride, dil) in enumerate(layers):
                    self.add_module(f"{prefix}_{key}_conv{k + 1}", ConvNormAct(
                        cin, width(out), normalizer=norm, strides=stride,
                        dilation=dil))
                    cin = width(out)
                skip[key] = cin
        cin = 2 * skip["e2"]
        for k, (out, stride, dil) in enumerate(_MERGE):
            self.add_module(f"merge_e3_conv{k + 1}", ConvNormAct(
                cin, width(out), normalizer=norm, strides=stride,
                dilation=dil))
            cin = width(out)
        for block, layers in _DECODER.items():
            for k, spec in enumerate(layers):
                if spec[0] == "up":
                    self.add_module(f"{block}_up", UpConv(
                        cin, width(spec[1]), use_bias=False))
                    cin = width(spec[1]) + 2 * skip[block.replace("conv_d",
                                                                  "e")]
                else:
                    out, stride, dil = spec
                    self.add_module(f"{block}_conv{k + 1}", ConvNormAct(
                        cin, width(out), normalizer=norm, strides=stride,
                        dilation=dil))
                    cin = width(out)
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
        y = images
        if self.img_grad:
            s = images.shape[-1] // 2
            sob = sobel_edges(images[..., s:s + 1].float())
            y = torch.cat([y, sob.to(y.dtype)], dim=-1)
        x = x.to(dt).permute(0, 3, 1, 2)
        y = y.to(dt).permute(0, 3, 1, 2)
        skips = {}
        for prefix in ("image", "inter"):
            v = x if prefix == "image" else y
            for key, layers in _STREAM.items():
                for k in range(len(layers)):
                    v = self._modules[f"{prefix}_{key}_conv{k + 1}"](
                        v, train=train)
                skips[prefix, key] = v
        z = torch.cat([skips["image", "e2"], skips["inter", "e2"]], dim=1)
        for k in range(len(_MERGE)):
            z = self._modules[f"merge_e3_conv{k + 1}"](z, train=train)
        for block, layers in _DECODER.items():
            for k, spec in enumerate(layers):
                if spec[0] == "up":
                    key = block.replace("conv_d", "e")
                    z = self._modules[f"{block}_up"](z)
                    z = torch.cat([z, skips["image", key],
                                   skips["inter", key]], dim=1)
                else:
                    z = self._modules[f"{block}_conv{k + 1}"](z, train=train)
        return self.logits(z).float().permute(0, 2, 3, 1)
