"""Work a configuration needs, counted from its frozen widths and the input
shapes, never from the program's modules: forward multiply-adds of every
conv, transpose conv and dense layer (2 FLOP each; a training step is
3 forwards), and the bytes of the instance-norm + ReLU planes that kernel
B2 computes (forward: x read, y written; backward: g and x read, dx
written; each once, at the compute dtype).

The peaks are NVIDIA's H100 SXM data sheet's: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

from portbench.reference.nets import unet3d_layers

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def gunet_layers(m: Dict, in_channels: int, context_length: int,
                 num_classes: int, sp_channels: int, h: int, w: int):
    """(macs per sample, [(channels, pixels) of each fused plane]) of
    GUNet at h x w: the fused planes are the norm + ReLU pairs with a full
    affine (the encoder's unmodulated levels and every decoder conv)."""
    c0, n = int(m["init_channels"]), int(m["num_down_samples"])
    mod = set(m["mod_layers"])
    fc = list(m["context_fc_channels"])
    n_mod = c0 * sum(2 ** i for i in range(n + 1) if i in mod) * 2
    macs, planes = 0, []
    cin = context_length
    for ch in fc + [n_mod]:
        macs += cin * ch
        cin = ch
    cin = in_channels
    for i in range(n + 1):
        px = (h >> i) * (w >> i)
        ch = c0 * 2 ** i
        if i in mod:
            macs += px * sp_channels * 2 * ch
        for _ in range(2):
            macs += px * cin * ch * 9
            if i not in mod:
                planes.append((ch, px))
            cin = ch
    for i in reversed(range(n)):
        px = (h >> i) * (w >> i)
        ch = c0 * 2 ** i
        macs += px * 2 * ch * ch                       # 2x2 transpose
        macs += px * 2 * ch * ch * 9 + px * ch * ch * 9
        planes += [(ch, px), (ch, px)]
    macs += h * w * c0 * num_classes
    return macs, planes


def unet3d_work(m: Dict, in_channels: int, num_classes: int,
                patch: Sequence[int]):
    """(macs per sample, [(channels, voxels) of each fused plane]) of
    UNet3D on a d x h x w patch (SAME convs: a strided axis gives
    ceil(size / stride))."""
    size = tuple(patch)
    macs, planes, cin = 0, [], in_channels
    for kind, name, cin, cout, kernel, stride in unet3d_layers(m,
                                                                in_channels):
        if kind == "up":
            size = tuple(s * k for s, k in zip(size, kernel))
            macs += math.prod(size) * cin * cout
            continue
        size = tuple(-(-s // st) for s, st in zip(size, stride))
        vox = math.prod(size)
        macs += vox * cin * cout * math.prod(kernel)
        planes.append((cout, vox))
        cin = cout
    macs += math.prod(size) * cin * num_classes
    return macs, planes


def work(config: Dict, shape: Sequence[int]):
    """(forward macs per sample, fused planes) of ``config`` at the input
    ``shape`` (h, w for GUNet; d, h, w for UNet3D)."""
    m = config["model"]
    if m["arch"] == "GUNet":
        return gunet_layers(m, int(m["in_channels"]),
                            int(m["context_length"]), int(m["num_classes"]),
                            int(m.get("sp_channels", 1)), *shape)
    if m["arch"] == "UNet3D":
        return unet3d_work(m, int(m["in_channels"]), int(m["num_classes"]),
                           shape)
    raise ValueError(f"no count for {m['arch']}")


def train_flops_per_sample(config: Dict, shape: Sequence[int]) -> float:
    return 3 * 2 * work(config, shape)[0]


def b2_min_seconds(config: Dict, shape: Sequence[int], batch: int,
                   train: bool) -> float:
    """The least time of one step's (or forward's) fused planes at the
    HBM rate: forward 2 tensors, backward 3, at the compute dtype."""
    dt = DTYPE_BYTES[config["settings"]["compute_dtype"]]
    elems = batch * sum(c * p for c, p in work(config, shape)[1])
    return elems * dt * (5 if train else 2) / HBM_BYTES_PER_S


def input_shape(config: Dict) -> List[int]:
    s = config["settings"]
    if config["model"]["arch"] == "UNet3D":
        return [s["im_depth"], s["im_height"], s["im_width"]]
    return [s["im_height"], s["im_width"]]
