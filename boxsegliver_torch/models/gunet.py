"""G-Net (GUNet): guided UNet with density (histogram-context) and spatial
(Gaussian-prior) modulation (port of boxsegliver_tpu/models/gunet.py:76-271;
reference NetworksV2/GUNet.py:31-488).

- context subnet: MLP [*context_fc_channels, n_modulator_param] over the
  histogram vector, or a 1-D VGG (``context_model`` vgg16B / C / D,
  layers.VGG1D); its output holds the per-channel gammas of every
  modulated encoder conv, or with ``use_se`` a context_fc_channels[-1]
  feature per modulated conv for its squeeze-excitation (JAX
  gunet.py:200-213): the spatial mean of the conv's normalized output and
  that feature through Dense((ch + cfl) // 4) + ReLU and Dense(ch) +
  sigmoid (``{name}_se1`` / ``{name}_se2``) give the gammas.
- spatial subnet: per-scale 1x1 convs over a SAME avg-pooled guide pyramid
  (count-include-pad); emits additive per-pixel params.
- encoder: modulated block = conv3x3 → norm (affine set by the
  norm_with_center / norm_with_scale flags) → x * gamma → x + sp →
  optional channel affine → ReLU; unmodulated blocks use a full-affine norm.
- decoder: standard UNet decoder; final 1x1 conv; logits in float32.

Input and output are NHWC (``{"images", "context", "sp_guide"}`` → logits
[bs, h, w, num_classes]), as in the JAX package; inside, the activations are
[N, C, H, W] tensors laid out channels-last (NCHW under a spatial shard).
``forward(inputs, train=True, generator=g)`` is train mode: ``--dropout``
after the first norm of each encoder level and ``side_dropout`` on the
context MLP's hidden layers draw their masks from ``g``.  Every
instance-norm + ReLU pair with a full affine (the decoder, and the
unmodulated encoder levels when ``dropout`` is 0) runs through kernel B2;
each modulated block whose norm → ·γ → +s → ReLU has nothing between them
(``_b3_block``: instance norm, no dropout there in train mode, no
after-affine, no squeeze-excitation) runs through kernel B3, the spatial
conv then giving each block its half as a tensor of its own.
``img_grad`` concatenates the image gradients to the images (JAX
gunet.py:135-137).  ``context_model="conv"`` (nf2 / IIN) reads a rank-4
context, the image-patch pyramid [bs, 32, 32, context_channels], with
layers.PatchCNN.

Under ``parallel.spatial.sharded`` (the height-sharded sweep, inference
only) the images and the guide hold this rank's rows (a block of whole
multiples of ``spatial_unit`` = 2^num_down_samples rows) and the context
stays whole: the convs exchange halos, the norms, kernel B2, B3's split
form and the SE mean sum their statistics over the ranks, ``img_grad``'s
dy takes the next
rank's first row, and the pools and transpose convs stay local.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from boxsegliver_torch.models.layers import (MLP, VGG_REPS, VGG1D,
                                             ChannelAffine, Conv, Conv1,
                                             ConvNormAct, Dense, Norm,
                                             PatchCNN, UpConv,
                                             avg_pool_same, dropout,
                                             fused_pair, he_normal_,
                                             image_gradients, init_kernel_,
                                             max_pool2x2, norm_relu)
from boxsegliver_torch.ops.kernels import (modnorm_relu_split,
                                           modulated_norm_relu)


class GUNet(nn.Module):

    spatial = None      # a parallel.spatial.SpatialShard while sharded

    def __init__(self, num_classes: int = 3, init_channels: int = 64,
                 num_down_samples: int = 4,
                 mod_layers: Sequence[int] = (1, 2, 3, 4),
                 context_fc_channels: Sequence[int] = (256,),
                 context_model: str = "fc",
                 context_conv_init_channels: int = 16,
                 norm_with_center: bool = False, norm_with_scale: bool = False,
                 after_affine: bool = False, use_context: bool = False,
                 use_spatial: bool = False, use_se: bool = False,
                 guide_channel: int = 1, side_dropout: float = 0.0,
                 dropout: Optional[float] = 0.0,
                 normalizer: str = "instance_norm", without_norm: bool = False,
                 fix: bool = False, img_grad: bool = False,
                 weight_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None,
                 in_channels: int = 3, context_length: int = 200,
                 context_channels: int = 3, sp_channels: int = 1):
        super().__init__()
        if use_context and context_model not in ("fc", "conv", *VGG_REPS):
            raise ValueError("Not supported context model")
        self.num_classes = num_classes
        self.init_channels = init_channels
        self.num_down_samples = num_down_samples
        self.mod_layers = tuple(mod_layers)
        self.use_context = use_context
        self.use_spatial = use_spatial
        self.after_affine = after_affine
        self.without_norm = without_norm
        self.weight_init = weight_init
        self.img_grad = img_grad
        self.dtype = dtype
        self.dropout = float(dropout or 0.0)
        self.use_se = use_se
        self.se_features = int(context_fc_channels[-1])

        n = num_down_samples
        levels = range(n + 1)
        if use_context:
            if use_se:
                n_mod = self.se_features * sum(
                    1 for i in levels if i in self.mod_layers) * 2
            else:
                n_mod = init_channels * sum(2 ** i for i in levels
                                            if i in self.mod_layers) * 2
            channels = list(context_fc_channels) + [n_mod]
            if context_model == "conv":
                self.context = PatchCNN(context_channels,
                                        context_conv_init_channels, channels,
                                        use_dropout=side_dropout > 0,
                                        keep_prob=1.0 - side_dropout)
            elif context_model in VGG_REPS:
                self.context = VGG1D(context_model,
                                     context_conv_init_channels,
                                     context_length, channels,
                                     use_dropout=side_dropout > 0,
                                     keep_prob=1.0 - side_dropout)
            else:
                self.context = MLP(context_length, channels,
                                   use_dropout=side_dropout > 0,
                                   keep_prob=1.0 - side_dropout)
        if use_spatial:
            for i in levels:
                if i not in self.mod_layers:
                    continue
                feats = init_channels * 2 ** (i + 1)
                if fix:
                    layer = ConvNormAct(sp_channels, feats, kernel=1,
                                        normalizer=None if without_norm
                                        else normalizer)
                else:
                    layer = Conv(sp_channels, feats, kernel=1)
                self.add_module(f"spatial_conv{i + 1}", layer)

        cin = in_channels * (3 if img_grad else 1)
        for i in levels:
            ch = init_channels * 2 ** i
            modulated = (use_context or use_spatial) and i in self.mod_layers
            for j in range(2):
                name = f"Encode{i + 1}_conv{j + 1}"
                self.add_module(name, Conv(cin, ch, 3, bias=without_norm))
                if not without_norm:
                    if modulated:
                        nb = norm_with_center and not after_affine
                        ns = norm_with_scale and not after_affine
                    else:
                        nb = ns = True
                    self.add_module(name + "_norm",
                                    Norm(normalizer, ch, use_bias=nb,
                                         use_scale=ns))
                if use_context and use_se and modulated:
                    hidden = (ch + self.se_features) // 4
                    self.add_module(name + "_se1",
                                    Dense(ch + self.se_features, hidden))
                    self.add_module(name + "_se2", Dense(hidden, ch))
                if after_affine:
                    self.add_module(name + "_affine", ChannelAffine(ch))
                cin = ch

        norm = None if without_norm else normalizer
        for i in reversed(range(n)):
            ch = init_channels * 2 ** i
            self.add_module(f"up{i + 1}", UpConv(2 * ch, ch))
            self.add_module(f"up_conv{i + 1}_1",
                            ConvNormAct(2 * ch, ch, normalizer=norm))
            self.add_module(f"up_conv{i + 1}_2",
                            ConvNormAct(ch, ch, normalizer=norm))
        self.AdjustChannels = Conv(init_channels, num_classes, 1)
        self._channels_last()

    def _channels_last(self):
        """The conv and transpose-conv kernels channels-last, as the
        activations are (``_layout``): cuDNN takes them with no copy, and
        their gradients come back in the parameters' own layout, so the
        optimizer's multi-tensor updates stay on their fast path."""
        return self.to(memory_format=torch.channels_last)

    # ------------------------------------------------------------------

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from a seeded generator: kernels per
        ``weight_init``, the context subnet's last layer he_normal (the VGG
        contexts': zeros kernel, ones bias), biases zero, norm scales /
        affine gammas one.  The kernels are drawn laid out contiguous, so that
        a seed gives every layout the same values."""
        self.to(memory_format=torch.contiguous_format)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Conv, Conv1, Dense, UpConv)):
                    init_kernel_(mod.weight, self.weight_init, generator)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, Norm):
                    if mod.weight is not None:
                        mod.weight.fill_(1.0)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, ChannelAffine):
                    mod.gamma.fill_(1.0)
                    mod.beta.zero_()
            if self.use_context and isinstance(self.context, VGG1D):
                self.context.reset_final_()
            elif self.use_context:
                mlp = getattr(self.context, "MLP_0", self.context)
                last = mlp._modules[f"Dense_{mlp.n_layers - 1}"]
                he_normal_(last.weight, last.in_features, generator)
        return self._channels_last()

    @property
    def spatial_unit(self) -> int:
        """The total stride along H (and W): a height shard's rows come in
        whole multiples of it."""
        return 2 ** self.num_down_samples

    def _layer(self, name: str) -> nn.Module:
        return self._modules[name]

    def _layout(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, H, W] channels-last where unsharded: every conv, pool,
        ``cat``, B2 and B3 keeps that layout to the logits (B2 and B3 on
        their NHWC plans), so cuDNN's NHWC convolutions take and give it
        with no transposes.  Under a spatial shard x as it comes."""
        if self.spatial is not None:
            return x
        return x.contiguous(memory_format=torch.channels_last)

    def _b3_block(self, norm: Optional[Norm], j: int, train: bool) -> bool:
        """Whether modulated block ``j`` of a level is kernel B3's function:
        an instance norm, no dropout between it and the modulation, no
        after-affine and no squeeze-excitation; γ and s may each be absent.
        Under a spatial shard it takes B3's split form, which rounds once
        as B3 does, so that the sharded forward is the unsharded one."""
        return (norm is not None and norm.normalizer == "instance_norm"
                and not self.after_affine
                and not (self.use_context and self.use_se)
                and not (j == 0 and train and self.dropout))

    def forward(self, inputs: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype or torch.float32
        n = self.num_down_samples

        context_params = None
        if self.use_context:
            context_params = self.context(inputs["context"].to(dt),
                                          train=train, generator=generator)

        spatial_params = [None] * (n + 1)
        if self.use_spatial:
            gs = self._layout(inputs["sp_guide"].to(dt).permute(0, 3, 1, 2))
            for i in range(n + 1):
                if i in self.mod_layers:
                    layer = self._layer(f"spatial_conv{i + 1}")
                    if isinstance(layer, Conv) and self.spatial is None:
                        # a half of its own for each block: its gradient
                        # is the block's ds, with no copy of the whole
                        half = layer.out_channels // 2
                        spatial_params[i] = [layer(gs, rows=(k * half,
                                                             (k + 1) * half))
                                             for k in range(2)]
                    else:
                        sp = (layer(gs, train=train)
                              if isinstance(layer, ConvNormAct) else layer(gs))
                        spatial_params[i] = sp.chunk(2, dim=1)
                if i < n:
                    gs = avg_pool_same(gs)

        images = inputs["images"]
        if self.img_grad:
            dy, dx = (image_gradients(images) if self.spatial is None
                      else self.spatial.image_gradients(images))
            images = torch.cat([images, dy, dx], dim=-1)
        x = self._layout(images.to(dt).permute(0, 3, 1, 2))
        density_mod_id = 0
        skips = []
        for i in range(n + 1):
            ch = self.init_channels * 2 ** i
            modulated = i in self.mod_layers
            plain_level = not (modulated and (self.use_context
                                              or self.use_spatial))
            for j in range(2):
                name = f"Encode{i + 1}_conv{j + 1}"
                x = self._layer(name)(x)
                norm = (None if self.without_norm
                        else self._layer(name + "_norm"))
                if (plain_level and not (self.dropout or self.after_affine)
                        and fused_pair(norm, True)):
                    # an unmodulated level: norm + ReLU is kernel B2's
                    # function
                    x = norm_relu(x, norm, self.spatial)
                    continue
                if not plain_level and self._b3_block(norm, j, train):
                    # norm · γ + s → ReLU is kernel B3's function (its
                    # split form under a spatial shard)
                    gamma = sp = None
                    if self.use_context:
                        gamma = context_params[:, density_mod_id:
                                               density_mod_id + ch]
                        density_mod_id += ch
                    if self.use_spatial:
                        sp = spatial_params[i][j]
                    if self.spatial is None:
                        x = modulated_norm_relu(x, gamma, sp, norm.weight,
                                                norm.bias, norm.eps)
                    else:
                        x = modnorm_relu_split(x, gamma, sp, norm.weight,
                                               norm.bias, self.spatial.group,
                                               norm.eps)
                    continue
                if norm is not None:
                    x = norm(x, train=train)
                if j == 0:
                    x = dropout(x, self.dropout, train, generator)
                if self.use_context and modulated and self.use_se:
                    cfl = self.se_features
                    feat = context_params[:, density_mod_id:
                                          density_mod_id + cfl]
                    squeeze = (x.mean(dim=(2, 3)) if self.spatial is None
                               else self.spatial.mean(x))
                    se = torch.cat([squeeze, feat], dim=1)
                    se = F.relu(self._layer(name + "_se1")(se))
                    gamma = torch.sigmoid(self._layer(name + "_se2")(se))
                    x = x * gamma[:, :, None, None]
                    density_mod_id += cfl
                elif self.use_context and modulated:
                    gamma = context_params[:, density_mod_id:density_mod_id + ch]
                    x = x * gamma[:, :, None, None]
                    density_mod_id += ch
                if self.use_spatial and modulated:
                    x = x + spatial_params[i][j]
                if self.after_affine:
                    x = self._layer(name + "_affine")(x)
                x = F.relu(x)
            skips.append(x)
            if i < n:
                x = max_pool2x2(x, padding="SAME")

        for i in reversed(range(n)):
            x = self._layer(f"up{i + 1}")(x)
            x = torch.cat([skips[i], x], dim=1)
            x = self._layer(f"up_conv{i + 1}_1")(x, train=train)
            x = self._layer(f"up_conv{i + 1}_2")(x, train=train)
        logits = self.AdjustChannels(x)
        return logits.float().permute(0, 2, 3, 1)
