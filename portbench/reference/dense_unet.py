"""Plain float32 DenseUNet of a configuration's widths (``model``: stem,
growth, dense blocks, compression, dropout), its seeded weights, the
device preprocess of its liver slices and its train step.  Nothing here
imports the program.

The network follows ``NetworksV2/DenseUNet.py`` (the 2-D branch of
H-DenseUNet, Li et al., arXiv:1709.07330, on a DenseNet-161 encoder, Huang
et al., arXiv:1608.06993):

- stem: 7x7 stride-2 conv with TF's SAME padding ((2, 3) at an even size),
  batch norm, ReLU; a 3x3 stride-2 max pool, SAME with −inf ((0, 1));
- dense block k: ``nb_layers[k]`` bottlenecks BN-ReLU-1x1 conv (4g)-dropout-
  BN-ReLU-3x3 conv (g)-dropout, each output concatenated onto the block's
  input; blocks 2-4 close with a transition BN-ReLU-1x1 conv (× compression)-
  dropout and a 2x2 SAME average pool (zero padding counted in every
  window's divisor), the last block with BN-ReLU;
- decoder: ``line0`` (1x1) of block 4's output plus block 5's upsampled;
  ``conv_up0`` (3x3)-BN-ReLU; three times: the next skip plus the nearest
  2x upsampling, ``conv_up<i>``-BN-ReLU; then upsample, ``conv_up4``, a
  Dropout(0.3) in train mode whatever ``dropout`` is, ``bn_up4``, ReLU and
  the 1x1 ``AdjustChannels``;
- no conv has a bias; the encoder's batch norms take eps 1e-5, the
  decoder's (``bn_up*``) 1e-3, all momentum 0.999.

Train mode (a generator given): batch norm normalizes with the batch's
mean and biased variance and moves its running statistics as flax does,
ra ← m·ra + (1 − m)·batch; every dropout keeps a unit where
``torch.rand(NCHW shape, generator) < 1 − rate`` and scales it by
1 / (1 − rate), its masks drawn in the forward's order.  Eval mode
normalizes with the running statistics and drops nothing.

Departures from the published description: H-DenseUNet's Keras code pads
the stem by (3, 3) and the pool by (1, 1) with zeros, and its decoder's
convs take Keras's default bias; here, as in ``NetworksV2`` and the
program, padding is TF's SAME and no conv has a bias.  The running
variance is the biased one (flax's rule; TF's and Keras's keep the
unbiased).  Dropout masks are torch's uniforms, not TF's.  The arithmetic
is float32, the configuration's compute dtype bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import nets
from portbench.reference.train import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                       crop_resize, flip_2d, weighted_ce)

ENCODER_EPS, DECODER_EPS, MOMENTUM = 1e-5, 1e-3, 0.999
UP4_DROPOUT = 0.3


def same_pads(size: int, kernel: int, stride: int):
    """TF's SAME padding of one axis: (before, after), the odd one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    ph = same_pads(x.shape[-2], kernel, stride)
    pw = same_pads(x.shape[-1], kernel, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class Ops(nets.Ops):
    """The reference's arithmetic (``quant`` as ``nets.Ops``), with the
    stem's strided SAME conv."""

    def conv2d_stride2(self, x, w):
        x, w = self._q(x, w)
        return F.conv2d(_pad_same(x, w.shape[-1], 2), w, stride=2)


def upsample2x(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class BatchNorm(nn.Module):
    """Scale, offset and running statistics of one batch norm."""

    def __init__(self, ch: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x, train: bool):
        view = (1, -1, 1, 1)
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean.view(view)) ** 2).mean(dim=(0, 2, 3))
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
                self.running_var.mul_(MOMENTUM).add_((1 - MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return ((x - mean.view(view)) * torch.rsqrt(var.view(view) + self.eps)
                * self.weight.view(view) + self.bias.view(view))


class Conv(nn.Module):
    """A bias-free conv kernel [cout, cin, k, k]."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))


def widths(m: Dict):
    """(channels after each dense block [block 2 .. 5], the channels of the
    five skips [stem, blocks 2-4 before their transitions, block 5])."""
    c, g = int(m["stem_channels"]), int(m["growth_rate"])
    ends, skips = [], [c]
    for k, n in enumerate(m["nb_layers"]):
        c += int(n) * g
        ends.append(c)
        skips.append(c)
        if k < 3:
            c = int(c * float(m["compression"]))
    return ends, skips


def decoder_widths(skips: Sequence[int]) -> List[int]:
    """Input and output channels of conv_up0 .. conv_up4: the skips' own,
    then 96 and 64 at full resolution."""
    return [skips[4], skips[2], skips[1], skips[0], 96, 64]


class RefDenseUNet(nn.Module):
    """Modules named as the program's ``state_dict`` names them."""

    def __init__(self, m: Dict):
        super().__init__()
        if len(m["nb_layers"]) != 4:
            raise ValueError("DenseUNet has 4 dense blocks")
        self.nb_layers = tuple(int(n) for n in m["nb_layers"])
        self.rate = float(m["dropout"])
        c, g = int(m["stem_channels"]), int(m["growth_rate"])
        self.conv1 = Conv(int(m["in_channels"]), c, 7)
        self.conv1_bn = BatchNorm(c, ENCODER_EPS)
        _, skips = widths(m)
        for k, n in enumerate(self.nb_layers):
            stage = k + 2
            for b in range(1, n + 1):
                base = f"conv{stage}_{b}"
                self.add_module(base + "_x1_bn", BatchNorm(c, ENCODER_EPS))
                self.add_module(base + "_x1", Conv(c, 4 * g, 1))
                self.add_module(base + "_x2_bn",
                                BatchNorm(4 * g, ENCODER_EPS))
                self.add_module(base + "_x2", Conv(4 * g, g, 3))
                c += g
            self.add_module(f"conv{stage}_blk_bn", BatchNorm(c, ENCODER_EPS))
            if k < 3:
                cout = int(c * float(m["compression"]))
                self.add_module(f"conv{stage}_blk", Conv(c, cout, 1))
                c = cout
        self.line0 = Conv(skips[3], skips[4], 1)
        dec = decoder_widths(skips)
        for i in range(5):
            self.add_module(f"conv_up{i}", Conv(dec[i], dec[i + 1], 3))
            self.add_module(f"bn_up{i}", BatchNorm(dec[i + 1], DECODER_EPS))
        self.AdjustChannels = Conv(64, int(m["num_classes"]), 1)

    def forward(self, feats: Dict[str, torch.Tensor], ops: nets.Ops,
                gen=None):
        """Logits [bs, h, w, classes]; train mode where ``gen`` is given
        (the dropout masks drawn from it)."""
        m, train = self._modules, gen is not None

        def bn_relu(x, name):
            return F.relu(m[name](x, train))

        def drop(x, rate):
            if not train or rate <= 0:
                return x
            keep = torch.rand(x.shape, generator=gen, device=x.device) \
                < 1.0 - rate
            return torch.where(keep, x / (1.0 - rate), 0.0)

        x = feats["images"].float().permute(0, 3, 1, 2)
        x = bn_relu(ops.conv2d_stride2(x, self.conv1.weight), "conv1_bn")
        box = [x]
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for k, n in enumerate(self.nb_layers):
            stage = k + 2
            for b in range(1, n + 1):
                base = f"conv{stage}_{b}"
                y = bn_relu(x, base + "_x1_bn")
                y = drop(ops.conv2d(y, m[base + "_x1"].weight), self.rate)
                y = bn_relu(y, base + "_x2_bn")
                y = drop(ops.conv2d(y, m[base + "_x2"].weight), self.rate)
                x = torch.cat([x, y], dim=1)
            if k < 3:
                box.append(x)
                x = bn_relu(x, f"conv{stage}_blk_bn")
                x = drop(ops.conv2d(x, m[f"conv{stage}_blk"].weight),
                         self.rate)
                x = F.avg_pool2d(_pad_same(x, 2, 2), 2, 2)
        x = bn_relu(x, "conv5_blk_bn")
        x = ops.conv2d(box[3], self.line0.weight) + upsample2x(x)
        x = bn_relu(ops.conv2d(x, self.conv_up0.weight), "bn_up0")
        for i, skip in ((1, box[2]), (2, box[1]), (3, box[0])):
            x = skip + upsample2x(x)
            x = bn_relu(ops.conv2d(x, m[f"conv_up{i}"].weight), f"bn_up{i}")
        x = ops.conv2d(upsample2x(x), self.conv_up4.weight)
        x = bn_relu(drop(x, UP4_DROPOUT), "bn_up4")
        return ops.conv2d(x, self.AdjustChannels.weight).permute(0, 2, 3, 1)


def build(config: Dict) -> RefDenseUNet:
    """The reference network of a configuration file, parameters
    uninitialised (``make_weights`` fills them)."""
    return RefDenseUNet(config["model"])


def decayed(net: nn.Module) -> List[str]:
    """The leaves L2 decays, as the JAX package's ``l2_regularization``
    picks them: every conv kernel, no batch-norm scale or offset."""
    convs = {n for n, mod in net.named_modules() if isinstance(mod, Conv)}
    return [n for n, _ in net.named_parameters()
            if n.rsplit(".", 1)[0] in convs]


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``}, the program's ``state_dict``
    names: ``portbench.weights.make``'s rule (every leaf a slice of one
    standard-normal draw in parameter order; a conv kernel ·√(2 / fan-in),
    a batch norm's scale 1 + 0.1·n, its offset 0.1·n), the norms found by
    module type; running means 0 and running variances 1."""
    net = build(config)
    spec = [(n, tuple(p.shape)) for n, p in net.named_parameters()]
    total = sum(math.prod(s) for _, s in spec)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    flat = torch.randn(total, generator=gen, device=device)
    norms = {n for n, mod in net.named_modules() if isinstance(mod, BatchNorm)}
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            t = t * math.sqrt(2.0 / math.prod(shape[1:]))
        elif name.endswith(".weight") and name.rsplit(".", 1)[0] in norms:
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.contiguous()
    for name, buf in net.named_buffers():
        out[name] = (torch.zeros if name.endswith("running_mean")
                     else torch.ones)(buf.shape, device=device)
    return out


def preprocess(raw: Dict[str, np.ndarray], vol, lab_stack, gen,
               flags: Dict, device):
    """(features, labels) of one raw index-layout batch without guide or
    context: the flip coins [bs, 3] and the noise [bs, h, w, c] drawn from
    ``gen`` in that order, the 2.5D gather, crop-resize, zeroed padded
    slices, the HU window, the noise, the joint flips."""
    t = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in raw.items()}
    bs = t["zidx"].shape[0]
    h, w, c = flags["im_height"], flags["im_width"], flags["im_channel"]
    coins = torch.rand((bs, 3), generator=gen, device=device)
    noise = torch.rand((bs, h, w, c), generator=gen, device=device) * 2 - 1
    img = vol[t["zidx"].long()].permute(0, 2, 3, 1).float()
    lab = lab_stack[t["lab_z"].long()]
    img, lab = crop_resize(img, lab, t["offset"][:, 0], t["offset"][:, 1],
                           t["crop_hw"][:, 0], t["crop_hw"][:, 1], h, w)
    pad = t["pad_mask"].float()[:, None, None, :]
    lo = t["clip"][:, 0, None, None, None].float()
    hi = t["clip"][:, 1, None, None, None].float()
    img = (torch.clamp(img * pad, lo, hi) - lo) / (hi - lo)
    img = (img + noise * abs(flags["noise_scale"])) * pad
    img, lab = flip_2d(img, lab.long(), coins, flags["random_flip"])
    return {"images": img}, lab


class RefDenseTrainer:
    """Steps the reference network from the seeded weights: the weighted
    cross entropy, the L2 term over ``decayed``, Adam (β2 0.99)."""

    def __init__(self, config: Dict, state: Dict[str, torch.Tensor], device,
                 quant=None, fault=None):
        """``quant``: the control's precision (``nets.Ops``); ``fault``
        "half_batch" plants a step that leaves out half of each batch and
        takes the mean over the rest."""
        if fault not in (None, "half_batch"):
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        self.net = build(config).to(device)
        self.net.load_state_dict(state, strict=True)
        self.flags = config["settings"]
        self.names = [n for n, _ in self.net.named_parameters()]
        self.params = [p for _, p in self.net.named_parameters()]
        self.decayed = set(decayed(self.net))
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.ops = Ops(quant)
        self.wd = float(self.flags["weight_decay_rate"])
        self.lr = max(float(self.flags["learning_rate"]),
                      float(self.flags["lr_end"]))

    def step(self, feats, labels, gen):
        """One train step, its dropout drawn from ``gen``; returns (total
        loss, the gradients as Adam got them)."""
        logits = self.net(feats, self.ops, gen)
        if self.fault == "half_batch":
            half = labels.shape[0] // 2
            logits, labels = logits[:half], labels[:half]
        loss = weighted_ce(logits, labels, self.flags["loss_numeric_w"])
        grads = list(torch.autograd.grad(loss, self.params))
        total = loss.detach()
        with torch.no_grad():
            dec = [i for i, n in enumerate(self.names) if n in self.decayed]
            if self.wd > 0:
                total = total + 0.5 * self.wd * sum(
                    (self.params[i] ** 2).sum() for i in dec)
                for i in dec:
                    grads[i] = grads[i] + self.wd * self.params[i]
            self.count += 1
            c1 = float(np.float32(1) - np.float32(ADAM_B1) ** self.count)
            c2 = float(np.float32(1) - np.float32(ADAM_B2) ** self.count)
            for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
                m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))
        return float(total), grads
