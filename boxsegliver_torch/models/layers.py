"""Shared building blocks of the UNet model family (port of
boxsegliver_tpu/models/layers.py:38-84,126-164,206-305,337-362).

Conventions carried over from the flax modules:
- modules take and return NCHW tensors (NCDHW for the 3-D forms ``Conv3``
  and ``UpConv3`` of UNet3D); the models convert from and to the NHWC
  (NDHWC) layout of the public boundary;
- compute dtype: the model casts its inputs to the compute dtype once, every
  conv / dense casts its float32 parameters to the input's dtype, norm
  statistics are computed in float32 (flax ``_compute_stats``) and the
  normalized output is cast back;
- padding is SAME: a stride-1 conv pads (k - 1)·d / 2 each side; a strided
  conv pads as XLA does (the odd pixel after the end), and the pools pad the
  ragged edge;
- parameters are named so that the weight bridge (models/weights.py) maps
  flax's ``params``/``batch_stats`` trees onto ``state_dict`` keys by rule.

Train mode (``train=True``): dropout draws its keep masks from an explicit
``torch.Generator`` (flax semantics: keep with probability 1 − rate, kept
units scaled by 1 / (1 − rate)); batch norm normalizes with the batch
statistics and moves its running statistics as flax ``nn.BatchNorm`` with
``mutable=["batch_stats"]`` does (``Norm``).  The instance-norm + ReLU pair
with a full affine runs through kernel B2 (ops/kernels.InstanceNormReLU) in
train and eval mode alike.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from boxsegliver_torch.ops.kernels import instance_norm_relu
from boxsegliver_torch.parallel.mesh import RankGenerator

# flax nn.BatchNorm(momentum=0.99): ra <- 0.99 * ra + 0.01 * batch statistic
BN_MOMENTUM = 0.99
# slim's batch-norm eps of the Norm wrapper; instance norm's (tf.contrib)
BN_EPS = 1e-3
IN_EPS = 1e-6


def dropout_apply(x: torch.Tensor, keep: torch.Tensor,
                  keep_prob: float) -> torch.Tensor:
    """flax nn.Dropout with a given keep mask: kept units / keep_prob, the
    rest 0."""
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``; the keep mask is
    uniform(0, 1) < 1 − rate from ``generator`` (on x's device).  A
    parallel.mesh.RankGenerator draws the global batch's uniforms and
    keeps the rank's rows."""
    if not train or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    if isinstance(generator, RankGenerator):
        u = generator.rand_rows(x.shape, x.device)
    else:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    return dropout_apply(x, u < keep_prob, keep_prob)


def init_kernel_(weight: torch.Tensor, weight_init: str = "xavier",
                 generator: Optional[torch.Generator] = None):
    """flax initializers: glorot_uniform ('xavier') or truncated
    normal(0.01) cut at 2 std ('trunc_norm') (reference base.py:137-151)."""
    if weight_init == "xavier":
        return nn.init.xavier_uniform_(weight, generator=generator)
    if weight_init == "trunc_norm":
        return nn.init.trunc_normal_(weight, std=0.01, a=-0.02, b=0.02,
                                     generator=generator)
    raise ValueError("Not supported weight initializer: " + weight_init)


def flax_init_(model: nn.Module, weight_init: str = "xavier",
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """flax's initializers over ``model``'s modules, in module order, from a
    seeded generator: conv and transpose-conv kernels per ``weight_init``,
    biases zero, norm scales one, batch-norm running mean zero and running
    variance one."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, Conv3, UpConv)):
                init_kernel_(mod.weight, weight_init, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Norm):
                if mod.weight is not None:
                    mod.weight.fill_(1.0)
                if mod.bias is not None:
                    mod.bias.zero_()
                if mod.normalizer == "batch_norm":
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
    return model


def he_normal_(weight: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None):
    """flax he_normal: truncated normal, variance 2/fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def same_pads(size: int, kernel: int, stride: int = 1,
              dilation: int = 1):
    """XLA's SAME padding along one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """SAME conv (odd kernels, optional stride and dilation) computing in
    the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 bias: bool = True, stride: int = 1, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=(kernel // 2) * dilation if stride == 1
                         else 0, dilation=dilation, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.stride[0] > 1:
            k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
            ph = same_pads(x.shape[-2], k, s, d)
            pw = same_pads(x.shape[-1], k, s, d)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        padding=self.padding, dilation=self.dilation)


class Conv3(nn.Conv3d):
    """SAME 3-D conv with per-axis kernel and stride tuples (flax ``nn.Conv``
    on NDHWC, here on NCDHW), computing in the input's dtype; a strided
    axis pads as XLA does (the odd voxel after the end)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int] = (3, 3, 3), bias: bool = True,
                 stride: Sequence[int] = (1, 1, 1)):
        super().__init__(in_channels, out_channels, tuple(kernel),
                         stride=tuple(stride), padding=0, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        pads = [same_pads(x.shape[2 + a], k, s) for a, (k, s) in
                enumerate(zip(self.kernel_size, self.stride))]
        if any(p for pair in pads for p in pair):
            x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        return F.conv3d(x, self.weight.to(x.dtype), b, stride=self.stride)


class Conv1(nn.Conv1d):
    """SAME 1-D conv (odd kernel, stride 1) with a bias, computing in the
    input's dtype (flax ``nn.Conv(ch, (k,))`` on [N, L, C], here on
    [N, C, L])."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__(in_channels, out_channels, kernel,
                         padding=kernel // 2)

    def forward(self, x):
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


class Dense(nn.Linear):
    """nn.Dense: a linear layer computing in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def max_pool2x2(x: torch.Tensor, padding: str = "VALID") -> torch.Tensor:
    """2x2 stride-2 max pool; SAME keeps the ragged last row/column."""
    return F.max_pool2d(x, 2, 2, ceil_mode=padding == "SAME")


def max_pool3x3_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool((3, 3), strides=(2, 2), padding="SAME")``: XLA
    pads with −inf as ``same_pads`` says ((0, 1) at an even size, (1, 1) at
    an odd one)."""
    ph, pw = same_pads(x.shape[-2], 3, 2), same_pads(x.shape[-1], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NCHW by exact pixel duplication (JAX
    dense_unet._upsample2x, two ``jnp.repeat``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_same(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """flax ``nn.avg_pool((k, k), strides=(k, k), padding="SAME")``: XLA's
    SAME pads zeros (the odd one after the end), counted in every window's
    k² divisor — torch's ceil_mode would divide edge windows by their
    in-bounds size instead."""
    ph = same_pads(x.shape[-2], k, k)
    pw = same_pads(x.shape[-1], k, k)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.avg_pool2d(x, k, k)


class Norm(nn.Module):
    """Normalizer selected by name with optional affine params.

    Works on NCHW and NCDHW alike.  batch_norm: eps 1e-3 and momentum
    0.99 (slim defaults; ``eps`` and ``momentum`` set others, as DenseUNet's
    encoder does).  Eval mode normalizes with the running statistics; train
    mode with the batch's statistics over (N, *spatial), computed in float32
    from the input's dtype, and then moves the running statistics once per
    forward as flax does: ra ← m·ra + (1 − m)·batch, with the BIASED batch
    variance (torch's own running update would store the unbiased one, so
    the batch norm itself runs without running statistics and the update is
    made here, outside autograd).  instance_norm: per-(sample, channel)
    statistics over the spatial axes, eps 1e-6, variance E[x²] − E[x]²
    clipped at 0 (flax's fast variance).  Both
    normalize in float32, ``(x − mean)·rsqrt(var + eps)·scale + bias``, and
    cast back to the input's dtype.  A norm without scale or bias has no
    such parameter.
    """

    def __init__(self, normalizer: str, channels: int, use_bias: bool = True,
                 use_scale: bool = True, momentum: float = BN_MOMENTUM,
                 eps: Optional[float] = None):
        super().__init__()
        if normalizer not in ("batch_norm", "instance_norm"):
            raise ValueError("Not supported normalization function: "
                             + normalizer)
        self.normalizer = normalizer
        if eps is None:
            eps = BN_EPS if normalizer == "batch_norm" else IN_EPS
        self.eps = eps
        self.momentum = momentum
        self.group = None          # a parallel.Group: see sync_batch_norm
        self.weight = nn.Parameter(torch.ones(channels)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None
        if normalizer == "batch_norm":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        if self.normalizer == "batch_norm" and train:
            return self._batch_norm_train(x)
        xf = x.float()
        view = (1, -1) + (1,) * (x.ndim - 2)
        if self.normalizer == "instance_norm":
            dims = tuple(range(2, x.ndim))
            mean = xf.mean(dim=dims, keepdim=True)
            var = torch.clamp_min(
                (xf * xf).mean(dim=dims, keepdim=True) - mean * mean, 0.0)
        else:
            mean = self.running_mean.view(view)
            var = self.running_var.view(view)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.view(view)
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias.view(view)
        return y.to(x.dtype)

    def _batch_norm_train(self, x):
        """Batch statistics in float32 (one fused pass each way, mixed
        bf16 / float32 on both devices), then the flax running update from
        the saved mean and inverse deviation: var = invstd⁻² − eps,
        recovered in float64.  Under a group of more than one rank
        (``sync_batch_norm``) the statistics are the global batch's, as
        JAX's over a sharded batch axis (trainer.py:12-15)."""
        group = self.group
        if group is not None and group.size > 1:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps, group)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            if group is None or group.size == 1:
                var = (invstd.double().pow(-2) - self.eps).clamp_min(
                    0.0).float()
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return y


class _SyncBatchNorm(torch.autograd.Function):
    """Batch norm over the global batch of a group: the per-channel sum and
    sum of squares and the count are summed (float64) over the ranks in one
    all-reduce, x is normalized with the global mean and biased variance in
    float32; backward sums Σdy and Σdy·x̂ (float64) over the ranks in one
    all-reduce.  Returns (y, mean, biased var) — the last two for the
    running update."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = [0] + list(range(2, x.ndim))
        view = (1, -1) + (1,) * (x.ndim - 2)
        xd = x.double()
        count = torch.full((1, x.shape[1]), float(x.numel() // x.shape[1]),
                           dtype=torch.float64, device=x.device)
        stats = torch.cat([xd.sum(dims)[None], (xd * xd).sum(dims)[None],
                           count])
        group.all_reduce_(stats)
        n = stats[2]
        mean = stats[0] / n
        var = (stats[1] / n - mean * mean).clamp_min(0.0)
        mean, var = mean.float(), var.float()
        invstd = torch.rsqrt(var + eps)
        xhat = (x.float() - mean.view(view)) * invstd.view(view)
        y = xhat
        if weight is not None:
            y = y * weight.view(view)
        if bias is not None:
            y = y + bias.view(view)
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight, n = ctx.saved_tensors
        dims = [0] + list(range(2, dy.ndim))
        view = (1, -1) + (1,) * (dy.ndim - 2)
        dyf = dy.float()
        local = torch.stack([dyf.sum(dims, dtype=torch.float64),
                             (dyf * xhat).sum(dims, dtype=torch.float64)])
        dweight = local[1].float() if ctx.needs_input_grad[1] else None
        dbias = local[0].float() if ctx.needs_input_grad[2] else None
        sums = (ctx.group.all_reduce_(local) / n).float()
        scale = invstd if weight is None else invstd * weight
        dx = scale.view(view) * (dyf - sums[0].view(view)
                                 - xhat * sums[1].view(view))
        return dx.to(dy.dtype), dweight, dbias, None, None


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Point every batch norm of ``model`` at ``group`` (a
    parallel.Group): in train mode its statistics become the global
    batch's.  None restores the local statistics."""
    for m in model.modules():
        if isinstance(m, Norm) and m.normalizer == "batch_norm":
            m.group = group
    return model


class BatchNorm(Norm):
    """flax ``nn.BatchNorm`` called directly by a model under its own name
    (DenseUNet's ``conv1_bn``, ``bn_up0``, ...): a batch ``Norm`` with a
    full affine whose flax leaves sit at that name, with no ``Norm``
    wrapper's ``BatchNorm_0`` level (models/weights.flax_names)."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__("batch_norm", channels, momentum=momentum, eps=eps)


def fused_pair(norm: Optional["Norm"], act: bool) -> bool:
    """Whether norm + ReLU is kernel B2's function: instance norm with a
    full affine, followed by ReLU."""
    return (act and norm is not None and norm.normalizer == "instance_norm"
            and norm.weight is not None and norm.bias is not None)


class ConvNormAct(nn.Module):
    """slim.conv2d equivalent: conv + (norm) + ReLU; the conv has a bias
    iff there is no normalizer.  A full-affine instance norm + ReLU runs
    through kernel B2.  A kernel tuple of three makes the 3-D form (Conv3,
    with ``strides`` a tuple too), whose B2 planes are D·H·W."""

    def __init__(self, in_channels: int, features: int, kernel=3,
                 normalizer: Optional[str] = "batch_norm",
                 norm_bias: bool = True, norm_scale: bool = True,
                 act: bool = True, use_bias: Optional[bool] = None,
                 strides: int = 1, dilation: int = 1):
        super().__init__()
        if use_bias is None:
            use_bias = normalizer is None
        if isinstance(kernel, (tuple, list)):
            self.conv = Conv3(in_channels, features, kernel, bias=use_bias,
                              stride=strides)
        else:
            self.conv = Conv(in_channels, features, kernel, bias=use_bias,
                             stride=strides, dilation=dilation)
        self.norm = (Norm(normalizer, features, norm_bias, norm_scale)
                     if normalizer is not None else None)
        self.act = act

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if fused_pair(self.norm, self.act):
            return instance_norm_relu(x, self.norm.weight, self.norm.bias)
        if self.norm is not None:
            x = self.norm(x, train=train)
        return F.relu(x) if self.act else x


class UpConv(nn.Module):
    """slim.conv2d_transpose equivalent: 2x2 stride-2 transpose conv + ReLU,
    no norm, with or without a bias.  ``weight`` is torch's [in, out, 2, 2]
    layout; the bridge flips flax's taps (flax output phase (p, q) uses tap
    (1-p, 1-q))."""

    def __init__(self, in_channels: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv_transpose2d(x, self.weight.to(x.dtype), b, stride=2)
        return F.relu(x)


class UpConv3(UpConv):
    """The 3-D transpose conv of UNet3D: ``kernel`` = ``strides`` per axis
    ((2, 2, 2) or (1, 2, 2)), bias-free in UNet3D, + ReLU.  ``weight`` is
    torch's [in, out, kd, kh, kw]; the bridge flips flax's taps along every
    spatial axis (a size-1 axis flips to itself)."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Sequence[int] = (2, 2, 2), use_bias: bool = False):
        nn.Module.__init__(self)
        self.weight = nn.Parameter(torch.empty(in_channels, features,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv_transpose3d(x, self.weight.to(x.dtype), b,
                               stride=self.weight.shape[2:])
        return F.relu(x)


class ChannelAffine(nn.Module):
    """Learnable channel-wise affine x * gamma + beta
    (reference Backbone/slim_nets.py:152-212)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return (x * self.gamma.to(x.dtype).view(1, -1, 1, 1)
                + self.beta.to(x.dtype).view(1, -1, 1, 1))


class MLP(nn.Module):
    """slim_nets.mlp: hidden Dense + ReLU (+ dropout) layers and a final
    linear Dense (reference Backbone/slim_nets.py:34-57).  Layers are named
    Dense_k as flax auto-names them."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 use_dropout: bool = False, keep_prob: float = 0.5):
        super().__init__()
        self.n_layers = len(out_channels)
        self.rate = 1.0 - keep_prob if use_dropout else 0.0
        for k, ch in enumerate(out_channels):
            self.add_module(f"Dense_{k}", Dense(in_features, ch))
            in_features = ch

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        for k in range(self.n_layers):
            x = self._modules[f"Dense_{k}"](x)
            if k < self.n_layers - 1:
                x = dropout(F.relu(x), self.rate, train, generator)
        return x


# convs per stage of the 1-D VGG contexts (reference slim_nets.py:60-149);
# vgg16C adds a 1x1 conv to each of its last three stages
VGG_REPS = {"vgg16B": (2, 2, 2, 2, 2), "vgg16C": (2, 2, 2, 2, 2),
            "vgg16D": (2, 2, 3, 3, 3)}
VGG_MULTS = (1, 2, 4, 8, 8)


class VGG1D(nn.Module):
    """1-D VGG16-{B,C,D} over a context vector (port of
    boxsegliver_tpu/models/layers.py:270-305): five stages of SAME k = 3
    convs with bias and ReLU (vgg16C: one k = 1 conv more in each of the
    last three), each closed by flax's SAME 1-D max pool 2 (the odd last
    element pooled alone, as −inf padding gives); the features flattened in
    flax's (length, channel) order; then the MLP, whose final Dense starts
    at zeros kernel and ones bias (reference GUNet.py:73-74).  Input
    [bs, L] (flax's [bs, L, 1]); modules named as flax auto-names them:
    ``Conv_0`` .. ``Conv_k`` and ``MLP_0``."""

    def __init__(self, variant: str, first_layer_channel: int, length: int,
                 out_channels: Sequence[int], use_dropout: bool = False,
                 keep_prob: float = 0.5):
        super().__init__()
        self.plan = []                       # (conv name, pool after it)
        cin = 1
        for stage, (rep, mult) in enumerate(zip(VGG_REPS[variant],
                                                VGG_MULTS)):
            ch = first_layer_channel * mult
            kernels = [3] * rep + ([1] if variant == "vgg16C" and stage >= 2
                                   else [])
            for j, k in enumerate(kernels):
                name = f"Conv_{len(self.plan)}"
                self.add_module(name, Conv1(cin, ch, k))
                self.plan.append((name, j == len(kernels) - 1))
                cin = ch
            length = -(-length // 2)
        self.MLP_0 = MLP(length * cin, out_channels, use_dropout, keep_prob)

    def reset_final_(self):
        """The final Dense's flax init: zeros kernel, ones bias."""
        last = self.MLP_0._modules[f"Dense_{self.MLP_0.n_layers - 1}"]
        with torch.no_grad():
            last.weight.zero_()
            last.bias.fill_(1.0)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x[:, None, :]
        for name, pool in self.plan:
            x = F.relu(self._modules[name](x))
            if pool:
                x = F.max_pool1d(x, 2, 2, ceil_mode=True)
        x = x.permute(0, 2, 1).reshape(x.shape[0], -1)
        return self.MLP_0(x, train=train, generator=generator)


# the nf2 context pyramid: CT_PATCH x CT_PATCH patches of the ct_sizes
# scales around the click (reference input_pipeline_iin.py:273, 597-598)
CT_PATCH = 32


def ct_sizes(ct_base: Sequence[int]) -> Tuple[int, int, int]:
    """--ct_base: one value s -> (s, 2s, 4s), or three explicit sizes
    (reference input_pipeline_iin.py:597-598)."""
    cb = list(ct_base)
    if len(cb) == 3:
        return tuple(int(s) for s in cb)
    if len(cb) != 1:
        raise ValueError(f"--ct_base takes 1 or 3 values, got {cb}")
    return int(cb[0]), int(cb[0]) * 2, int(cb[0]) * 4


class PatchCNN(nn.Module):
    """2-D conv encoder over the nf2 context pyramids [bs, 32, 32, n_scales]
    (NHWC, port of boxsegliver_tpu/models/layers.py:308-333): three
    conv-conv-pool stages (SAME 3x3 convs with bias and ReLU, flax's SAME
    2x2 max pool; 32 -> 4), the global mean, then the MLP of the fc context
    (he_normal final init).  Modules are named as flax auto-names them:
    ``Conv_0`` .. ``Conv_5`` and ``MLP_0``."""

    def __init__(self, in_channels: int, first_layer_channel: int,
                 out_channels: Sequence[int], use_dropout: bool = False,
                 keep_prob: float = 0.5):
        super().__init__()
        cin = in_channels
        for k in range(6):
            ch = first_layer_channel * (1, 2, 4)[k // 2]
            self.add_module(f"Conv_{k}", Conv(cin, ch, 3))
            cin = ch
        self.MLP_0 = MLP(cin, out_channels, use_dropout, keep_prob)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.permute(0, 3, 1, 2)
        for k in range(6):
            x = F.relu(self._modules[f"Conv_{k}"](x))
            if k % 2:
                x = max_pool2x2(x, padding="SAME")
        return self.MLP_0(x.mean(dim=(2, 3)), train=train,
                          generator=generator)


def image_gradients(images: torch.Tensor):
    """tf.image.image_gradients for NHWC batches: dy[:, i] = x[:, i + 1] −
    x[:, i] with a zero last row, dx likewise along W (the ``--img_grad``
    inputs)."""
    dy = torch.cat([images[:, 1:] - images[:, :-1],
                    torch.zeros_like(images[:, :1])], dim=1)
    dx = torch.cat([images[:, :, 1:] - images[:, :, :-1],
                    torch.zeros_like(images[:, :, :1])], dim=2)
    return dy, dx


def sobel_edges(images: torch.Tensor) -> torch.Tensor:
    """tf.image.sobel_edges of a one-channel NHWC batch -> [bs, h, w, 2]
    (dy, dx), REFLECT padding as TF."""
    ky = torch.tensor([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]],
                      dtype=images.dtype, device=images.device)
    kern = torch.stack([ky, ky.T])[:, None]              # [2, 1, 3, 3]
    x = F.pad(images.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(x, kern).permute(0, 2, 3, 1)
