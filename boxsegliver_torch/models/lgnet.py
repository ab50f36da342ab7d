"""LGNet: an explicit five-stage UNet with additive spatial-guide modulation
at chosen encoder AND decoder layers (port of
boxsegliver_tpu/models/lgnet.py:26-148, the unpacked path; reference
NetworksV2/LGNet.py:31-210).

``mod_layers = [[encoder layers], [decoder layers]]``; each modulated layer
has its own 1x1 conv (leaky ReLU, no norm) over an avg-pooled guide pyramid
(``spatial_e{l+1}``, ``spatial_d{l+1}``).  Encoder stage: conv1 + norm +
ReLU, conv2 + norm, + guide, ReLU; decoder stage: up, concat, conv1 + norm,
+ guide, ReLU, conv2 + norm + ReLU.  The conv1 / conv2 blocks that end in
ReLU run kernel B2 under instance norm (9 a forward); the blocks whose norm
is followed by the guide sum stay on the plain instance norm (the guide
comes between norm and ReLU).  NHWC at the boundary, NCHW inside; modules
carry the flax names.  ``lane_pack`` is accepted and ignored.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from boxsegliver_torch.models.layers import (Conv, ConvNormAct, UpConv,
                                             avg_pool_same, flax_init_,
                                             image_gradients, max_pool2x2)

_LAYER_C = (64, 128, 256, 512, 1024)


class LGNet(nn.Module):

    def __init__(self, num_classes: int = 2,
                 mod_layers: Sequence[Sequence[int]] = ((0, 1), (0, 1)),
                 use_spatial: bool = True, normalizer: str = "instance_norm",
                 without_norm: bool = False, img_grad: bool = False,
                 weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None, lane_pack: bool = False,
                 in_channels: int = 3, guide_channels: int = 1):
        super().__init__()
        self.mod_layers = tuple(tuple(int(v) for v in m) for m in mod_layers)
        self.use_spatial = use_spatial
        self.img_grad = img_grad
        self.weight_init = weight_init
        self.dtype = dtype
        norm = None if without_norm else normalizer
        if use_spatial:
            for tag, layers in zip("ed", self.mod_layers):
                for ell in layers:
                    self.add_module(f"spatial_{tag}{ell + 1}", Conv(
                        guide_channels, _LAYER_C[ell], 1))
        cin = in_channels * (3 if img_grad else 1)
        for i, ch in enumerate(_LAYER_C):
            self.add_module(f"conv_e{i}_conv1",
                            ConvNormAct(cin, ch, normalizer=norm))
            self.add_module(f"conv_e{i}_conv2",
                            ConvNormAct(ch, ch, normalizer=norm, act=False))
            cin = ch
        for i in reversed(range(4)):
            ch = _LAYER_C[i]
            self.add_module(f"conv_d{i}_up", UpConv(cin, ch))
            self.add_module(f"conv_d{i}_conv1",
                            ConvNormAct(2 * ch, ch, normalizer=norm, act=False))
            self.add_module(f"conv_d{i}_conv2",
                            ConvNormAct(ch, ch, normalizer=norm))
            cin = ch
        self.logits = Conv(cin, num_classes, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from a seeded generator (layers.flax_init_)."""
        return flax_init_(self, self.weight_init, generator)

    def _pyramid(self, guide: torch.Tensor, layers, tag: str):
        """One 1x1 conv + leaky ReLU per modulated layer over the guide,
        avg-pooled by 2^(l - previous l) between layers (LGNet.py:31-54)."""
        out, prev = {}, 0
        for ell in layers:
            if ell > 0:
                guide = avg_pool_same(guide, 2 ** (ell - prev))
            v = self._modules[f"spatial_{tag}{ell + 1}"](guide)
            # flax's leaky_relu: slope 1 at 0 (torch's takes 0.01 there)
            out[ell] = torch.where(v >= 0, v, 0.01 * v)
            prev = ell
        return out

    def forward(self, inputs, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the trainer's calling convention;
        the model draws nothing."""
        dt = self.dtype or torch.float32
        images = inputs["images"]
        enc = dec = {}
        if self.use_spatial:
            gs = inputs["sp_guide"].to(dt).permute(0, 3, 1, 2)
            enc = self._pyramid(gs, self.mod_layers[0], "e")
            dec = self._pyramid(gs, self.mod_layers[1], "d")
        if self.img_grad:
            dy, dx = image_gradients(images)
            images = torch.cat([images, dy, dx], dim=-1)
        x = images.to(dt).permute(0, 3, 1, 2)
        skips = []
        for i in range(5):
            x = self._modules[f"conv_e{i}_conv1"](x, train=train)
            x = self._modules[f"conv_e{i}_conv2"](x, train=train)
            x = F.relu(x + enc[i] if i in enc else x)
            skips.append(x)
            if i < 4:
                x = max_pool2x2(x, padding="SAME")
        for i in reversed(range(4)):
            x = self._modules[f"conv_d{i}_up"](x)
            x = torch.cat([skips[i], x], dim=1)
            x = self._modules[f"conv_d{i}_conv1"](x, train=train)
            x = F.relu(x + dec[i] if i in dec else x)
            x = self._modules[f"conv_d{i}_conv2"](x, train=train)
        return self.logits(x).float().permute(0, 2, 3, 1)
