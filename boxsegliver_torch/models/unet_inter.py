"""UNetInter: a UNet with the interactive guide concatenated to the input,
or with ``mid_cat`` to the first stage's output (port of
boxsegliver_tpu/models/unet_inter.py, the unpacked path; reference
NetworksV2/UNetInter.py:31-240).

Encoder: ``num_down_samples + 1`` stages of [conv3x3 + norm + ReLU] x 2,
channels doubling from ``init_channels``, a SAME 2x2 max pool between
stages; decoder: 2x2 stride-2 transpose conv (ReLU, no norm), concat
``[skip, up]``, two convs; a final 1x1 conv to ``num_classes``.  Every norm
has a full affine, so under instance norm each of the 18 conv blocks of
UNetInter.yml runs kernel B2.  ``img_grad`` concatenates the image
gradients to the images (before the guide).

Input and output are NHWC (``{"images", "sp_guide"}`` → float32 logits
[bs, h, w, num_classes]); NCHW inside.  Modules are named after the flax
tree (``Encode{i}_conv{j}``, ``up{i}``, ``up_conv{i}_{j}``,
``AdjustChannels``), so the weight bridge maps them by rule.  The JAX
package's ``lane_pack`` (a TPU layout of the same math and parameter tree)
is accepted and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from boxsegliver_torch.models.layers import (Conv, ConvNormAct, UpConv,
                                             flax_init_, image_gradients,
                                             max_pool2x2)


class UNetInter(nn.Module):

    def __init__(self, num_classes: int = 2, init_channels: int = 64,
                 num_down_samples: int = 4, normalizer: str = "instance_norm",
                 without_norm: bool = False, mid_cat: bool = False,
                 img_grad: bool = False, weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None, lane_pack: bool = False,
                 in_channels: int = 3, guide_channels: int = 2):
        super().__init__()
        self.num_down_samples = num_down_samples
        self.mid_cat = mid_cat
        self.img_grad = img_grad
        self.weight_init = weight_init
        self.dtype = dtype
        norm = None if without_norm else normalizer
        cin = in_channels * (3 if img_grad else 1)
        if not mid_cat:
            cin += guide_channels
        for i in range(num_down_samples + 1):
            ch = init_channels * 2 ** i
            for j in range(2):
                self.add_module(f"Encode{i + 1}_conv{j + 1}",
                                ConvNormAct(cin, ch, normalizer=norm))
                cin = ch
            if mid_cat and i == 0:
                cin += guide_channels
        for i in reversed(range(num_down_samples)):
            ch = init_channels * 2 ** i
            self.add_module(f"up{i + 1}", UpConv(cin, cin // 2))
            self.add_module(f"up_conv{i + 1}_1",
                            ConvNormAct(ch + cin // 2, ch, normalizer=norm))
            self.add_module(f"up_conv{i + 1}_2",
                            ConvNormAct(ch, ch, normalizer=norm))
            cin = ch
        self.AdjustChannels = Conv(cin, num_classes, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from a seeded generator (layers.flax_init_)."""
        return flax_init_(self, self.weight_init, generator)

    def forward(self, inputs, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the trainer's calling convention;
        the model draws nothing."""
        dt = self.dtype or torch.float32
        images = inputs["images"]
        guide = inputs["sp_guide"].to(dt).permute(0, 3, 1, 2)
        if self.img_grad:
            dy, dx = image_gradients(images)
            images = torch.cat([images, dy, dx], dim=-1)
        x = images.to(dt).permute(0, 3, 1, 2)
        if not self.mid_cat:
            x = torch.cat([x, guide], dim=1)
        n = self.num_down_samples
        skips = []
        for i in range(n + 1):
            for j in range(2):
                x = self._modules[f"Encode{i + 1}_conv{j + 1}"](x, train=train)
            skips.append(x)
            if self.mid_cat and i == 0:
                x = torch.cat([x, guide], dim=1)
            if i < n:
                x = max_pool2x2(x, padding="SAME")
        for i in reversed(range(n)):
            x = self._modules[f"up{i + 1}"](x)
            x = torch.cat([skips[i], x], dim=1)
            for j in range(2):
                x = self._modules[f"up_conv{i + 1}_{j + 1}"](x, train=train)
        logits = self.AdjustChannels(x)
        return logits.float().permute(0, 2, 3, 1)
