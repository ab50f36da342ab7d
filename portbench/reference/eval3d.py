"""Plain float32 whole-volume UNet3D inference and the per-case Dice, for
judging the program's predictions: the raw volume z-scored over its
non-zero voxels, zero-padded to multiples of (2, 16, 16), one forward,
cropped back.  Nothing here imports the program."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import nets
from portbench.reference.train import zscore

ALIGN = (2, 16, 16)


@torch.no_grad()
def volume_logits(net, volume: np.ndarray, device, ops=None) -> torch.Tensor:
    """Logits [d, h, w, classes] of one raw volume [d, h, w]."""
    x = torch.from_numpy(volume.astype(np.int32)).to(device).float()
    pads = [(-s) % m for s, m in zip(x.shape, ALIGN)]
    x = torch.nn.functional.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
    x = zscore(x[None])[..., None]
    y = net({"images": x}, ops or nets.Ops())[0]
    d, h, w = volume.shape
    return y[:d, :h, :w]


def logit_gap(logits: torch.Tensor, pred: np.ndarray) -> float:
    """The widest gap by which the logit of the class ``pred`` chose lies
    below the reference's best logit, over all voxels."""
    p = torch.from_numpy(pred.astype(np.int64)).to(logits.device)
    chosen = torch.gather(logits, -1, p[..., None])[..., 0]
    return float((logits.amax(-1) - chosen).max())


def dice(pred: np.ndarray, label: np.ndarray, cls: int) -> float:
    a, b = pred == cls, label == cls
    total = int(a.sum()) + int(b.sum())
    return 2.0 * int((a & b).sum()) / total if total else 0.0


def case_metrics(pred: np.ndarray, label: np.ndarray, classes) -> Dict:
    """{"<class>/Dice"} of one case, classes in label order from 1."""
    return {f"{c}/Dice": dice(pred, label, i + 1)
            for i, c in enumerate(classes)}
