"""Classic 2D UNet (port of boxsegliver_tpu/models/unet.py:24-110, the
unpacked path; reference NetworksV2/UNet.py:29-177).

Encoder: ``num_down_samples`` stages of [conv3x3 + norm + ReLU] x 2 + a
VALID 2x2 max pool, channels doubling from ``init_channels``; bridge: two
convs; decoder: 2x2 stride-2 transpose conv (ReLU, no norm), concat
``[skip, up]``, two convs; a final 1x1 conv to ``num_classes`` with no norm
or activation.  ``img_grad`` concatenates the image gradients to the input
(reference UNet.py:69-73).

Input and output are NHWC (``{"images"}`` or the image tensor → float32
logits [bs, h, w, num_classes]), as in the JAX package; NCHW inside.
Modules are named after the flax tree (``Encode{i}_conv{j}``,
``Bridge_conv{j}``, ``Decode{i}_up``, ``Decode{i}_conv{j}``,
``AdjustChannels``) so the weight bridge maps it by rule.  ``lane_pack``
(the JAX package's width-packed TPU layout, the same math and parameter
tree) is accepted and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from boxsegliver_torch.models.layers import (Conv, ConvNormAct, UpConv,
                                             flax_init_, image_gradients,
                                             max_pool2x2)


class UNet(nn.Module):

    def __init__(self, num_classes: int = 2, init_channels: int = 64,
                 num_down_samples: int = 4, normalizer: str = "batch_norm",
                 without_norm: bool = False, img_grad: bool = False,
                 weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None, lane_pack: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.num_down_samples = num_down_samples
        self.img_grad = img_grad
        self.weight_init = weight_init
        self.dtype = dtype
        norm = None if without_norm else normalizer
        cin = in_channels * (3 if img_grad else 1)
        ch = init_channels
        for i in range(num_down_samples):
            for j in range(2):
                self.add_module(f"Encode{i + 1}_conv{j + 1}",
                                ConvNormAct(cin, ch, normalizer=norm))
                cin = ch
            ch *= 2
        for j in range(2):
            self.add_module(f"Bridge_conv{j + 1}",
                            ConvNormAct(cin, ch, normalizer=norm))
            cin = ch
        for i in reversed(range(num_down_samples)):
            ch //= 2
            self.add_module(f"Decode{i + 1}_up", UpConv(cin, cin // 2))
            self.add_module(f"Decode{i + 1}_conv1",
                            ConvNormAct(ch + cin // 2, ch, normalizer=norm))
            self.add_module(f"Decode{i + 1}_conv2",
                            ConvNormAct(ch, ch, normalizer=norm))
            cin = ch
        self.AdjustChannels = Conv(cin, num_classes, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from a seeded generator (layers.flax_init_)."""
        return flax_init_(self, self.weight_init, generator)

    def forward(self, inputs, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the trainer's calling convention;
        the UNet draws nothing."""
        images = inputs["images"] if isinstance(inputs, dict) else inputs
        if self.img_grad:
            dy, dx = image_gradients(images)
            images = torch.cat([images, dy, dx], dim=-1)
        x = images.to(self.dtype or torch.float32).permute(0, 3, 1, 2)
        skips = []
        for i in range(self.num_down_samples):
            for j in range(2):
                x = self._modules[f"Encode{i + 1}_conv{j + 1}"](x, train=train)
            skips.append(x)
            x = max_pool2x2(x)
        for j in range(2):
            x = self._modules[f"Bridge_conv{j + 1}"](x, train=train)
        for i in reversed(range(self.num_down_samples)):
            x = self._modules[f"Decode{i + 1}_up"](x)
            x = torch.cat([skips[i], x], dim=1)
            for j in range(2):
                x = self._modules[f"Decode{i + 1}_conv{j + 1}"](x, train=train)
        logits = self.AdjustChannels(x)
        return logits.float().permute(0, 2, 3, 1)
