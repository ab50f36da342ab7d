"""UNet3D: the nnUNet-style anisotropic 3-D UNet with per-block kernel and
stride tables (port of boxsegliver_tpu/models/unet3d.py:24-173, the
unpacked path; reference NetworksV2/UNet3D.py:28-187).

Downsampling is by strided convs; the early stages use (1, 3, 3) kernels,
so thick-slice z context mixes only once the maps are coarse.  Channels
double per stage up to ``max_channels``.  The decoder's transpose convs are
bias-free and return each stage to its encoder's channel count, then
concatenate ``[skip, up]``; a 1x1x1 conv gives the logits.  With
``use_spatial`` the click guide ``sp_guide`` is concatenated to the input
(UNet3D.py:143-144).

Input and output are NDHWC (``{"images", "sp_guide"}`` → float32 logits
[bs, d, h, w, num_classes]), NCDHW inside.  Modules are named after the flax
tree (``{block}_conv{k}``, ``{block}_up``, ``logits``) so the weight bridge
maps it by rule.  Every full-affine instance norm + ReLU runs kernel B2 with
planes of D·H·W.  ``lane_pack`` (the JAX package's width-packed TPU layout,
models/packed3d.py: the same math and parameter tree) is accepted and
ignored; ``img_grad`` is accepted and unused, as in the JAX module.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from boxsegliver_torch.models.layers import (Conv3, ConvNormAct, UpConv3,
                                             flax_init_)

# reference UNet3D.py:31-91: per-block (kernel, stride) tables
_CFG = {
    4: {
        "conv_e0": [((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1))],
        "conv_e1": [((1, 3, 3), (1, 2, 2)), ((1, 3, 3), (1, 1, 1))],
        "conv_e2": [((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))],
        "conv_e3": [((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))],
        "bridge": [((3, 3, 3), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))],
        "conv_d3": [("up", (2, 2, 2), (2, 2, 2)),
                    ((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 1, 1))],
        "conv_d2": [("up", (1, 2, 2), (1, 2, 2)),
                    ((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 1, 1))],
        "conv_d1": [("up", (1, 2, 2), (1, 2, 2)),
                    ((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1))],
        "conv_d0": [("up", (1, 2, 2), (1, 2, 2)),
                    ((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1))],
    },
    5: {
        "conv_e0": [((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1))],
        "conv_e1": [((1, 3, 3), (1, 2, 2)), ((1, 3, 3), (1, 1, 1))],
        "conv_e2": [((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))],
        "conv_e3": [((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))],
        "conv_e4": [((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))],
        "bridge": [((3, 3, 3), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))],
        "conv_d4": [("up", (2, 2, 2), (2, 2, 2)),
                    ((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 1, 1))],
        "conv_d3": [("up", (1, 2, 2), (1, 2, 2)),
                    ((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 1, 1))],
        "conv_d2": [("up", (1, 2, 2), (1, 2, 2)),
                    ((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 1, 1))],
        "conv_d1": [("up", (1, 2, 2), (1, 2, 2)),
                    ((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1))],
        "conv_d0": [("up", (1, 2, 2), (1, 2, 2)),
                    ((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1))],
    },
}


class UNet3D(nn.Module):

    def __init__(self, num_classes: int = 2, init_channels: int = 30,
                 num_pool_layers: int = 4, max_channels: int = 320,
                 use_spatial: bool = False, img_grad: bool = False,
                 normalizer: str = "instance_norm",
                 without_norm: bool = False, weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None, lane_pack: bool = False,
                 in_channels: int = 1, sp_channels: int = 2):
        super().__init__()
        self.use_spatial = use_spatial
        self.weight_init = weight_init
        self.dtype = dtype
        self.cfg = _CFG[num_pool_layers]
        norm = None if without_norm else normalizer
        cin = in_channels + (sp_channels if use_spatial else 0)
        c = init_channels
        enc_channels = {}
        for block, layers in self.cfg.items():
            if block.startswith("conv_e") or block == "bridge":
                for k, (kernel, stride) in enumerate(layers):
                    self.add_module(f"{block}_conv{k + 1}", ConvNormAct(
                        cin, c, kernel, normalizer=norm, strides=stride))
                    cin = c
                enc_channels[block] = c
                c = min(c * 2, max_channels)
                continue
            for k, spec in enumerate(layers):
                if spec[0] == "up":
                    c = enc_channels[block.replace("d", "e")]
                    self.add_module(f"{block}_up", UpConv3(cin, c, spec[1]))
                    cin = 2 * c
                else:
                    kernel, stride = spec
                    self.add_module(f"{block}_conv{k}", ConvNormAct(
                        cin, c, kernel, normalizer=norm, strides=stride))
                    cin = c
        self.logits = Conv3(cin, num_classes, (1, 1, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from a seeded generator (layers.flax_init_)."""
        return flax_init_(self, self.weight_init, generator)

    def forward(self, inputs, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the trainer's calling convention;
        UNet3D draws nothing."""
        x = inputs["images"] if isinstance(inputs, dict) else inputs
        if self.use_spatial:
            x = torch.cat([x, inputs["sp_guide"].to(x.dtype)], dim=-1)
        x = x.to(self.dtype or torch.float32).permute(0, 4, 1, 2, 3)
        skips = {}
        for block, layers in self.cfg.items():
            if block.startswith("conv_e") or block == "bridge":
                for k in range(len(layers)):
                    x = self._modules[f"{block}_conv{k + 1}"](x, train=train)
                skips[block] = x
                continue
            for k, spec in enumerate(layers):
                if spec[0] == "up":
                    x = self._modules[f"{block}_up"](x)
                    x = torch.cat([skips[block.replace("d", "e")], x], dim=1)
                else:
                    x = self._modules[f"{block}_conv{k}"](x, train=train)
        return self.logits(x).float().permute(0, 2, 3, 4, 1)
