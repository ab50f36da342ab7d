"""DenseUNet: the DenseNet-161-backboned UNet of ``003_denseunet.sh`` (port
of boxsegliver_tpu/models/dense_unet.py; reference NetworksV2/DenseUNet.py).

- encoder: a 7x7 stride-2 SAME stem (XLA's (2, 3) padding at an even size)
  + BN + ReLU, a 3x3 stride-2 SAME max pool (−inf padding), three dense
  blocks each closed by a transition (BN-ReLU-1x1 conv compressing by
  ``compression``, SAME 2x2 average pool with zero padding counted), and a
  fourth dense block + BN + ReLU.  A dense block concatenates
  ``nb_layers[k]`` bottlenecks BN-ReLU-1x1(4g)-BN-ReLU-3x3(g) onto its
  input.  ``dropout`` (``--dropout``) follows every encoder conv.
- decoder: nearest 2x upsampling with additive skips and conv3x3 + BN +
  ReLU refinement; its widths are the skips' channels (768 / 384 / 96 at
  the DenseNet-161 widths), then 96 and 64 at full resolution, a
  Dropout(0.3) in train mode whatever ``--dropout`` says (reference
  DenseUNet.py:116), BN + ReLU and the 1x1 ``AdjustChannels``.
- batch norm everywhere (no hand-written kernel runs): the encoder's with
  momentum 0.999 and eps 1e-5, the decoder's (``bn_up*``) with eps 1e-3.
- convs have no bias; encoder kernels follow ``weight_init``, decoder
  kernels a truncated normal(0.01).

Modules carry JAX's FLAT names (``conv1``, ``conv1_bn``,
``conv{stage}_{branch}_x1``, ``conv{stage}_blk``, ``line0``, ``conv_up0``,
``bn_up0``, ..., ``AdjustChannels``), so the weight bridge and the
DenseNet-161 ``.h5`` import (utils/h5_import.py) map them by name.  Input
``{"images": [bs, h, w, c]}`` (NHWC) → float32 logits [bs, h, w,
num_classes]; NCHW inside.  ``forward(inputs, train=True, generator=g)``
is train mode: batch statistics and their running update, dropout masks
from ``g``.

Host spans (utils/trace.py, recorded only under a running profiler and
never inside a CUDA-graph capture): ``boxseg.dense.stem`` (conv1, its
batch norm, the pool), ``.block2`` .. ``.block5`` (the bottlenecks; block
5's closing batch norm), ``.transition2`` .. ``.transition4`` and
``.decoder`` (``line0`` to ``AdjustChannels``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from boxsegliver_torch.models.layers import (BatchNorm, Conv, avg_pool_same,
                                             dropout, init_kernel_,
                                             max_pool3x3_same, upsample2x)
from boxsegliver_torch.utils.trace import span

ENCODER_BN = dict(momentum=0.999, eps=1e-5)
DECODER_BN = dict(momentum=0.999, eps=1e-3)
# the unconditional dropout before bn_up4 (reference DenseUNet.py:116)
UP4_DROPOUT = 0.3
_OFF = contextlib.nullcontext()


def _stage_span(name: str, x: torch.Tensor):
    """``utils.trace.span(name)`` around a stage of the forward, or nothing
    while x's CUDA stream captures a graph: a replay shows no host span."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return _OFF
    return span(name)


class DenseUNet(nn.Module):

    def __init__(self, num_classes: int = 3, stem_channels: int = 96,
                 growth_rate: int = 48,
                 nb_layers: Sequence[int] = (6, 12, 36, 24),
                 compression: float = 0.5, dropout: Optional[float] = 0.0,
                 weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3):
        super().__init__()
        if len(nb_layers) != 4:
            raise ValueError(
                "DenseUNet's decoder is fixed at 4 dense blocks / 5 skip "
                f"levels (reference DenseUNet.py:96-118); got nb_layers="
                f"{tuple(nb_layers)}")
        self.nb_layers = tuple(int(n) for n in nb_layers)
        self.growth_rate = growth_rate
        self.dropout = float(dropout or 0.0)
        self.weight_init = weight_init
        self.dtype = dtype
        self.decoder = ["line0"] + [f"conv_up{i}" for i in range(5)] + [
            "AdjustChannels"]

        self.conv1 = Conv(in_channels, stem_channels, 7, bias=False, stride=2)
        self.conv1_bn = BatchNorm(stem_channels, **ENCODER_BN)
        c = stem_channels
        skips = [c]
        g = growth_rate
        for k, n in enumerate(self.nb_layers):
            stage = k + 2
            for b in range(1, n + 1):
                base = f"conv{stage}_{b}"
                self.add_module(base + "_x1_bn", BatchNorm(c, **ENCODER_BN))
                self.add_module(base + "_x1", Conv(c, 4 * g, 1, bias=False))
                self.add_module(base + "_x2_bn",
                                BatchNorm(4 * g, **ENCODER_BN))
                self.add_module(base + "_x2", Conv(4 * g, g, 3, bias=False))
                c += g
            self.add_module(f"conv{stage}_blk_bn",
                            BatchNorm(c, **ENCODER_BN))
            skips.append(c)
            if k < 3:
                cout = int(c * compression)
                self.add_module(f"conv{stage}_blk",
                                Conv(c, cout, 1, bias=False))
                c = cout
        # decoder: refinement widths equal the next skip's channels
        self.line0 = Conv(skips[3], skips[4], 1, bias=False)
        widths = [skips[4], skips[2], skips[1], skips[0], 96, 64]
        for i in range(5):
            self.add_module(f"conv_up{i}",
                            Conv(widths[i], widths[i + 1], 3, bias=False))
            self.add_module(f"bn_up{i}",
                            BatchNorm(widths[i + 1], **DECODER_BN))
        self.AdjustChannels = Conv(64, num_classes, 1, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from a seeded generator: encoder kernels per
        ``weight_init``, decoder kernels truncated normal(0.01), batch-norm
        scales one, offsets and running means zero, running variances
        one."""
        with torch.no_grad():
            for name, mod in self.named_children():
                if isinstance(mod, Conv):
                    init_kernel_(mod.weight, "trunc_norm" if name in
                                 self.decoder else self.weight_init,
                                 generator)
                elif isinstance(mod, BatchNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
        return self

    def _bn(self, x, name, train):
        return F.relu(self._modules[name](x, train=train))

    def _drop(self, x, train, generator):
        return dropout(x, self.dropout, train, generator)

    def forward(self, inputs: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = inputs["images"] if isinstance(inputs, dict) else inputs
        x = x.to(self.dtype or torch.float32).permute(0, 3, 1, 2)
        m = self._modules

        box = []
        with _stage_span("boxseg.dense.stem", x):
            x = self._bn(self.conv1(x), "conv1_bn", train)
            box.append(x)                                   # H/2
            x = max_pool3x3_same(x)
        for k, n in enumerate(self.nb_layers):
            stage = k + 2
            with _stage_span(f"boxseg.dense.block{stage}", x):
                for b in range(1, n + 1):
                    base = f"conv{stage}_{b}"
                    y = self._bn(x, base + "_x1_bn", train)
                    y = self._drop(m[base + "_x1"](y), train, generator)
                    y = self._bn(y, base + "_x2_bn", train)
                    y = self._drop(m[base + "_x2"](y), train, generator)
                    x = torch.cat([x, y], dim=1)
                if k == 3:
                    x = self._bn(x, f"conv{stage}_blk_bn", train)
            box.append(x)                       # H/4 .. H/16, then H/32
            if k < 3:
                with _stage_span(f"boxseg.dense.transition{stage}", x):
                    x = self._bn(x, f"conv{stage}_blk_bn", train)
                    x = self._drop(m[f"conv{stage}_blk"](x), train,
                                   generator)
                    x = avg_pool_same(x)

        with _stage_span("boxseg.dense.decoder", x):
            x = self.line0(box[3]) + upsample2x(x)
            x = self._bn(self.conv_up0(x), "bn_up0", train)
            for i, skip in ((1, box[2]), (2, box[1]), (3, box[0])):
                x = skip + upsample2x(x)
                x = self._bn(m[f"conv_up{i}"](x), f"bn_up{i}", train)
            x = self.conv_up4(upsample2x(x))
            x = dropout(x, UP4_DROPOUT, train, generator)
            x = self._bn(x, "bn_up4", train)
            logits = self.AdjustChannels(x)
        return logits.float().permute(0, 2, 3, 1)
