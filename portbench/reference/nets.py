"""Plain float32 forms of the two benchmarked networks, written from the
frozen configuration (``portbench/configs/<config>.json``, key ``model``).

GUNet (GUNet.yml: fc histogram context, 1x1 spatial-guide convs, instance
norm, modulated levels ``mod_layers``) and UNet3D (UNet3D.yml: the
anisotropic kernel and stride tables).  Every operation is a plain PyTorch
call in float32; no kernel, cache or batching of the program is used.
Parameter names follow the published flax trees as the program names them
(``Encode1_conv1``, ``up_conv1_1.conv``, ``conv_e0_conv1.norm``, ...), so the
benchmark's seeded weights load into both sides by name.

``quant`` selects the control: with ``"fp8"`` every convolution and dense
layer takes its input and weight rounded to float8 e4m3 (per-tensor scale
to the format's largest value, straight-through in the backward).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

IN_EPS = 1e-6
FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, in t's dtype;
    the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


class Ops:
    """The arithmetic both networks use, float32, with the control's
    rounding on the operands of every conv and dense layer."""

    def __init__(self, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.quant = quant

    def _q(self, *ts):
        if self.quant is None:
            return ts
        return tuple(None if t is None else fp8_round(t) for t in ts)

    def conv2d(self, x, w, b=None):
        x, w = self._q(x, w)
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def conv3d(self, x, w, stride):
        """SAME 3-D conv; a strided axis pads its odd voxel after the end."""
        x, w = self._q(x, w)
        pads = []
        for a in reversed(range(3)):
            size, k, s = x.shape[2 + a], w.shape[2 + a], stride[a]
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv3d(F.pad(x, pads), w, stride=tuple(stride))

    def up2d(self, x, w, b):
        x, w = self._q(x, w)
        return F.relu(F.conv_transpose2d(x, w, b, stride=2))

    def up3d(self, x, w):
        x, w = self._q(x, w)
        return F.relu(F.conv_transpose3d(x, w, stride=tuple(w.shape[2:])))

    def dense(self, x, w, b):
        x, w = self._q(x, w)
        return F.linear(x, w, b)


def instance_norm(x, weight=None, bias=None, eps=IN_EPS):
    """Per-(sample, channel) statistics over the spatial axes, variance
    E[x²] − E[x]² clipped at 0, then the optional affine."""
    dims = tuple(range(2, x.ndim))
    view = (1, -1) + (1,) * (x.ndim - 2)
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp_min((x * x).mean(dim=dims, keepdim=True) - mean * mean,
                          0.0)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.view(view)
    if bias is not None:
        y = y + bias.view(view)
    return y


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


class _Norm(nn.Module):
    def __init__(self, ch, bias=True, scale=True):
        super().__init__()
        self.weight = _param(ch) if scale else None
        self.bias = _param(ch) if bias else None


class _ConvNorm(nn.Module):
    """conv (no bias) + full-affine instance norm + ReLU."""

    def __init__(self, cin, cout, kernel):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = _param(cout, cin, *kernel)
        self.norm = _Norm(cout)


class RefGUNet(nn.Module):
    """GUNet with the fc context and the 1x1 spatial-guide convs."""

    def __init__(self, m: Dict, num_classes: int, in_channels: int,
                 context_length: int, sp_channels: int = 1):
        super().__init__()
        c0, n = int(m["init_channels"]), int(m["num_down_samples"])
        self.c0, self.n = c0, n
        self.mod = tuple(m["mod_layers"])
        self.with_center = bool(m["norm_with_center"])
        self.with_scale = bool(m["norm_with_scale"])
        self.side_dropout = float(m.get("side_dropout", 0.0))
        fc = list(m["context_fc_channels"])
        n_mod = c0 * sum(2 ** i for i in range(n + 1) if i in self.mod) * 2
        self.context = nn.Module()
        cin = context_length
        for k, ch in enumerate(fc + [n_mod]):
            layer = nn.Module()
            layer.weight, layer.bias = _param(ch, cin), _param(ch)
            self.context.add_module(f"Dense_{k}", layer)
            cin = ch
        self.n_dense = len(fc) + 1
        for i in range(n + 1):
            if i in self.mod:
                layer = nn.Module()
                layer.weight = _param(c0 * 2 ** (i + 1), sp_channels, 1, 1)
                layer.bias = _param(c0 * 2 ** (i + 1))
                self.add_module(f"spatial_conv{i + 1}", layer)
        cin = in_channels
        for i in range(n + 1):
            ch = c0 * 2 ** i
            for j in range(2):
                name = f"Encode{i + 1}_conv{j + 1}"
                conv = nn.Module()
                conv.weight = _param(ch, cin, 3, 3)
                self.add_module(name, conv)
                if i in self.mod:
                    norm = _Norm(ch, self.with_center, self.with_scale)
                else:
                    norm = _Norm(ch)
                self.add_module(name + "_norm", norm)
                cin = ch
        for i in reversed(range(n)):
            ch = c0 * 2 ** i
            up = nn.Module()
            up.weight, up.bias = _param(2 * ch, ch, 2, 2), _param(ch)
            self.add_module(f"up{i + 1}", up)
            self.add_module(f"up_conv{i + 1}_1", _ConvNorm(2 * ch, ch, (3, 3)))
            self.add_module(f"up_conv{i + 1}_2", _ConvNorm(ch, ch, (3, 3)))
        head = nn.Module()
        head.weight, head.bias = _param(num_classes, c0, 1, 1), _param(
            num_classes)
        self.AdjustChannels = head

    def forward(self, feats: Dict[str, torch.Tensor], ops: Ops,
                gen: Optional[torch.Generator] = None):
        """Logits [bs, h, w, classes]; with ``gen`` (training) the context
        subnet's hidden layers drop units at ``side_dropout``, their keep
        masks uniform(0, 1) < 1 − rate drawn from ``gen``."""
        m = self._modules
        ctx = feats["context"].float()
        keep = 1.0 - self.side_dropout
        for k in range(self.n_dense):
            d = self.context._modules[f"Dense_{k}"]
            ctx = ops.dense(ctx, d.weight, d.bias)
            if k < self.n_dense - 1:
                ctx = F.relu(ctx)
                if gen is not None and keep < 1.0:
                    u = torch.rand(ctx.shape, generator=gen,
                                   device=ctx.device)
                    ctx = torch.where(u < keep, ctx / keep, 0.0)
        gs = feats["sp_guide"].float().permute(0, 3, 1, 2)
        sp = {}
        for i in range(self.n + 1):
            if i in self.mod:
                s = m[f"spatial_conv{i + 1}"]
                sp[i] = ops.conv2d(gs, s.weight, s.bias)
            if i < self.n:
                gs = F.avg_pool2d(gs, 2, 2)
        x = feats["images"].float().permute(0, 3, 1, 2)
        off, skips = 0, []
        for i in range(self.n + 1):
            ch = self.c0 * 2 ** i
            for j in range(2):
                name = f"Encode{i + 1}_conv{j + 1}"
                x = ops.conv2d(x, m[name].weight)
                norm = m[name + "_norm"]
                x = instance_norm(x, norm.weight, norm.bias)
                if i in self.mod:
                    x = x * ctx[:, off:off + ch, None, None]
                    off += ch
                    x = x + sp[i][:, ch * j:ch * (j + 1)]
                x = F.relu(x)
            skips.append(x)
            if i < self.n:
                x = F.max_pool2d(x, 2, 2)
        for i in reversed(range(self.n)):
            up = m[f"up{i + 1}"]
            x = torch.cat([skips[i], ops.up2d(x, up.weight, up.bias)], dim=1)
            for k in (1, 2):
                blk = m[f"up_conv{i + 1}_{k}"]
                x = F.relu(instance_norm(ops.conv2d(x, blk.conv.weight),
                                         blk.norm.weight, blk.norm.bias))
        h = self.AdjustChannels
        return ops.conv2d(x, h.weight, h.bias).permute(0, 2, 3, 1)


# UNet3D.yml with num_pool_layers 4: per block (kernel, stride), or
# ("up", kernel) for a transpose conv whose stride is its kernel
UNET3D_BLOCKS = {
    "conv_e0": [((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1))],
    "conv_e1": [((1, 3, 3), (1, 2, 2)), ((1, 3, 3), (1, 1, 1))],
    "conv_e2": [((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))],
    "conv_e3": [((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))],
    "bridge": [((3, 3, 3), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))],
    "conv_d3": [("up", (2, 2, 2)), ((3, 3, 3), (1, 1, 1)),
                ((3, 3, 3), (1, 1, 1))],
    "conv_d2": [("up", (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
                ((3, 3, 3), (1, 1, 1))],
    "conv_d1": [("up", (1, 2, 2)), ((1, 3, 3), (1, 1, 1)),
                ((1, 3, 3), (1, 1, 1))],
    "conv_d0": [("up", (1, 2, 2)), ((1, 3, 3), (1, 1, 1)),
                ((1, 3, 3), (1, 1, 1))],
}


def unet3d_layers(m: Dict, in_channels: int):
    """[(kind, name, cin, cout, kernel, stride)] of UNet3D in forward order;
    kind is "conv" (conv + instance norm + ReLU), "up" (transpose conv +
    ReLU, then the skip concatenation) or "logits"."""
    if int(m["num_pool_layers"]) != 4:
        raise ValueError("the reference carries UNet3D.yml's 4 pool layers")
    out, enc = [], {}
    cin, c = in_channels, int(m["init_channels"])
    cmax = int(m["max_channels"])
    for block, specs in UNET3D_BLOCKS.items():
        if not block.startswith("conv_d"):
            for k, (kernel, stride) in enumerate(specs):
                out.append(("conv", f"{block}_conv{k + 1}", cin, c, kernel,
                            stride))
                cin = c
            enc[block] = c
            c = min(2 * c, cmax)
            continue
        for k, spec in enumerate(specs):
            if spec[0] == "up":
                c = enc[block.replace("d", "e")]
                out.append(("up", f"{block}_up", cin, c, spec[1], spec[1]))
                cin = 2 * c
            else:
                out.append(("conv", f"{block}_conv{k}", cin, c, spec[0],
                            spec[1]))
                cin = c
    return out


class RefUNet3D(nn.Module):
    def __init__(self, m: Dict, num_classes: int, in_channels: int = 1):
        super().__init__()
        self.layers = unet3d_layers(m, in_channels)
        cin = in_channels
        for kind, name, cin, cout, kernel, _ in self.layers:
            if kind == "conv":
                self.add_module(name, _ConvNorm(cin, cout, kernel))
            else:
                up = nn.Module()
                up.weight = _param(cin, cout, *kernel)
                self.add_module(name, up)
            cin = cout
        head = nn.Module()
        head.weight, head.bias = _param(num_classes, cin, 1, 1, 1), _param(
            num_classes)
        self.logits = head

    def forward(self, feats: Dict[str, torch.Tensor], ops: Ops, gen=None):
        """Logits [bs, d, h, w, classes]; UNet3D draws nothing."""
        m = self._modules
        x = feats["images"].float().permute(0, 4, 1, 2, 3)
        skips = {}
        for kind, name, _, _, _, stride in self.layers:
            block = name.rsplit("_", 1)[0]
            if kind == "up":
                x = ops.up3d(x, m[name].weight)
                x = torch.cat([skips[block.replace("d", "e")], x], dim=1)
                continue
            blk = m[name]
            x = F.relu(instance_norm(ops.conv3d(x, blk.conv.weight, stride),
                                     blk.norm.weight, blk.norm.bias))
            if not block.startswith("conv_d"):
                skips[block] = x
        h = self.logits
        y = ops.conv3d(x, h.weight, (1, 1, 1)) + h.bias.view(1, -1, 1, 1, 1)
        return y.permute(0, 2, 3, 4, 1)


def build(config: Dict) -> nn.Module:
    """The reference network of a configuration file's ``model`` entry,
    parameters uninitialised (portbench.weights fills them)."""
    m = config["model"]
    arch = m["arch"]
    if arch == "GUNet":
        return RefGUNet(m, int(m["num_classes"]), int(m["in_channels"]),
                        int(m["context_length"]), int(m.get("sp_channels", 1)))
    if arch == "UNet3D":
        return RefUNet3D(m, int(m["num_classes"]), int(m["in_channels"]))
    raise ValueError(f"no reference for {arch}")


def fan_in(name: str, shape: Sequence[int]) -> int:
    """Inputs feeding one output of a weight: a transpose conv whose stride
    is its kernel (``up<i>``, ``<block>_up``) takes one tap of each input
    channel."""
    mod = name.rsplit(".", 1)[0]
    if re.fullmatch(r"up\d+", mod) or mod.endswith("_up"):
        return int(shape[0])
    return int(math.prod(shape[1:]))
