"""Seeded weights of a configuration, made on the device in one draw.

Names and shapes come from the reference network (``reference.nets``), in
its parameter order.  Every leaf is a slice of one standard-normal draw of
a ``torch.Generator`` on the card: a conv, dense or transpose-conv kernel
scaled by √(2 / fan-in) (He), a norm's scale 1 + 0.1·n, every bias and a
norm's offset 0.1·n.  The same seed gives the same weights to the program
and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import nets


def make(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``}."""
    spec = [(n, tuple(p.shape)) for n, p in
            nets.build(config).named_parameters()]
    total = sum(math.prod(s) for _, s in spec)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            t = t * math.sqrt(2.0 / nets.fan_in(name, shape))
        elif "norm" in name and name.endswith(".weight"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.contiguous()
    return out


def liver_margin(w: Dict[str, torch.Tensor], scale: float, margin: float
                 ) -> Dict[str, torch.Tensor]:
    """``w`` with the head's kernel (``AdjustChannels``) scaled by
    ``scale`` and its bias ``margin`` logits on class 1 (Liver), 0 on the
    others: every voxel's argmax is Liver, so no predicted tumour enters a
    guided sweep's state and no case overflows into its host loop."""
    w = dict(w)
    w["AdjustChannels.weight"] = w["AdjustChannels.weight"] * scale
    bias = torch.zeros_like(w["AdjustChannels.bias"])
    bias[1] = margin
    w["AdjustChannels.bias"] = bias
    return w
