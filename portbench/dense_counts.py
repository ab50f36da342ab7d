"""Work of DenseUNet counted from its configuration's widths and the input
shape, never from the program's modules (portbench.reference.dense_unet
gives the widths): the forward multiply-adds of every conv (2 FLOP each; a
train step is 3 forwards), and the least bytes of the batch-norm + ReLU
planes (forward: x read, y written; backward: g and x read, dx written;
each once, at the compute dtype: 10 B an element a train step in bf16).

Also what a trace's batch-norm planes cost: the device kernels whose name
holds ``batch_norm`` (PyTorch's native batch norm, forward and backward)
or ``bnrelu`` (the name a hand-written batch norm + ReLU must carry to be
counted here).  Peaks: portbench.flops.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from portbench.flops import DTYPE_BYTES, HBM_BYTES_PER_S
from portbench.reference.dense_unet import decoder_widths, widths

NORM_TOKENS = ("batch_norm", "bnrelu")


def work(config: Dict, shape: Sequence[int]
         ) -> Tuple[int, List[Tuple[int, int]]]:
    """(forward multiply-adds per sample, [(channels, pixels) of each
    batch-norm plane]) of DenseUNet at h x w (multiples of 32)."""
    m = config["model"]
    h, w = shape
    g, n_layers = int(m["growth_rate"]), [int(n) for n in m["nb_layers"]]
    _, skips = widths(m)

    def px(level):                 # pixels at h / 2**level
        return (h >> level) * (w >> level)

    c = int(m["stem_channels"])
    macs = px(1) * int(m["in_channels"]) * c * 49
    planes = [(c, px(1))]
    for k, n in enumerate(n_layers):
        p = px(k + 2)
        for _ in range(n):
            macs += p * (c * 4 * g + 4 * g * g * 9)
            planes += [(c, p), (4 * g, p)]
            c += g
        planes.append((c, p))
        if k < 3:
            cout = int(c * float(m["compression"]))
            macs += p * c * cout
            c = cout
    macs += px(4) * skips[3] * skips[4]                        # line0
    dec = decoder_widths(skips)
    for i in range(5):
        p = px(4 - i)
        macs += p * dec[i] * dec[i + 1] * 9
        planes.append((dec[i + 1], p))
    macs += px(0) * 64 * int(m["num_classes"])                 # AdjustChannels
    return macs, planes


def train_flops_per_sample(config: Dict, shape: Sequence[int]) -> float:
    return 3 * 2 * work(config, shape)[0]


def norm_min_seconds(config: Dict, shape: Sequence[int], batch: int) -> float:
    """The least time of one train step's batch-norm + ReLU planes at the
    HBM rate: forward 2 tensors, backward 3, at the compute dtype."""
    dt = DTYPE_BYTES[config["settings"]["compute_dtype"]]
    elems = batch * sum(c * p for c, p in work(config, shape)[1])
    return elems * dt * 5 / HBM_BYTES_PER_S


def is_norm_kernel(name: str) -> bool:
    n = name.lower()
    return any(t in n for t in NORM_TOKENS)


def norm_seconds(records: Dict) -> float:
    """Device seconds of the batch-norm kernels in a trace's records."""
    return sum(v for n, _, v in records["kernels"] if is_norm_kernel(n))
