"""Plain float32 train steps of the two benchmarked configurations, from the
raw host batches the program was handed, the seeded weights and the files
of the data set: the device preprocess (the 2.5D gather from the stacked
training volumes, crop-resize, HU window, the Gaussian guide, noise, joint
flips; or the 3-D patch z-score and flips), the forward, the weighted
cross entropy with the L2 term, the backward and Adam.

The augmentation's random draws are made again from a generator on the
card seeded as the program seeds its own (``--seed``), in the program's
order: per step the flip coins [bs, 3], then (2-D, with noise) the noise
field [bs, h, w, c].  Nothing here imports the program.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import nets

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-8


# -- 2-D liver preprocess ---------------------------------------------------

def train_pids(dataset_dir: Path, test_fold: int) -> List[int]:
    """Training cases in k_folds.txt order: every fold but ``test_fold``."""
    folds = []
    for line in (Path(dataset_dir) / "k_folds.txt").read_text().splitlines():
        if ":" in line:
            folds.append([int(p) for p in line.split(":", 1)[1].split()])
    return [p for i, f in enumerate(folds) if i != test_fold for p in f]


def stacked_volumes(dataset_dir: Path, pids: Sequence[int], device):
    """The training volumes (uint16 values as int32) and labels stacked
    along z, in ``pids`` order."""
    root = Path(dataset_dir)
    vols = [np.load(root / f"volume-{p}" / "volume.npy") for p in pids]
    labs = [np.load(root / f"volume-{p}" / "segmentation.npy") for p in pids]
    vol = torch.from_numpy(np.concatenate(vols).astype(np.int32)).to(device)
    lab = torch.from_numpy(np.concatenate(labs)).to(device)
    return vol, lab


def _grid(out: int, size: torch.Tensor, start: torch.Tensor):
    dst = torch.arange(out, dtype=torch.float32, device=size.device)
    return ((dst[None] + 0.5) * (size.float()[:, None] / out) - 0.5
            + start.float()[:, None])


def _take(x, rows, cols):
    """x [bs, H, W, ...] at rows [bs, oh] x cols [bs, ow]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, rows[:, :, None], cols[:, None, :]]


def crop_resize(img, lab, y0, x0, ch, cw, oh, ow):
    """Bilinear (half-pixel grid, edge clamped) resize of each crop of img
    [bs, H, W, C]; the label by nearest sampling with round-half-even."""
    ys, xs = _grid(oh, ch, y0), _grid(ow, cw, x0)
    h, w = img.shape[1], img.shape[2]
    fy0 = torch.clamp(torch.floor(ys), 0, h - 1)
    fx0 = torch.clamp(torch.floor(xs), 0, w - 1)
    fy1 = torch.clamp(fy0 + 1, 0, h - 1)
    fx1 = torch.clamp(fx0 + 1, 0, w - 1)
    wy = torch.clamp(ys - fy0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - fx0, 0.0, 1.0)[:, None, :, None]
    r0, r1, c0, c1 = fy0.long(), fy1.long(), fx0.long(), fx1.long()
    out = (_take(img, r0, c0) * (1 - wy) * (1 - wx)
           + _take(img, r0, c1) * (1 - wy) * wx
           + _take(img, r1, c0) * wy * (1 - wx)
           + _take(img, r1, c1) * wy * wx)
    yi = torch.clamp(torch.round(ys), 0, h - 1).long()
    xi = torch.clamp(torch.round(xs), 0, w - 1).long()
    return out, _take(lab, yi, xi)


def gaussian_guide(centers, stddevs, valid, h, w, scale, offset):
    """max over valid objects of exp(−½((r−cy)²/sy² + (c−cx)²/sx²)),
    clipped to [0, 1], then ·scale + offset: [bs, h, w, 1]."""
    dev = centers.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    c, s = centers.float(), stddevs.float()
    iy = 0.5 / torch.clamp_min(s[..., 0] ** 2, 1e-12)
    ix = 0.5 / torch.clamp_min(s[..., 1] ** 2, 1e-12)
    ey = (rows[None, None] - c[..., 0, None]) ** 2 * iy[..., None]
    ex = (cols[None, None] - c[..., 1, None]) ** 2 * ix[..., None]
    g = torch.exp(-(ey[..., :, None] + ex[..., None, :]))
    g = torch.where(valid[..., None, None], g, 0.0)
    g = g.amax(dim=1) if g.shape[1] else torch.zeros(
        (g.shape[0], h, w), device=dev)
    return (torch.clamp(g, 0.0, 1.0) * scale + offset)[..., None]


def flip_2d(img, lab, coins, flip):
    for bit, col, axis in ((1, 0, 2), (2, 1, 1)):
        if flip & bit:
            c = coins[:, col] >= 0.5
            img = torch.where(c[:, None, None, None], img.flip(axis), img)
            lab = torch.where(c[:, None, None], lab.flip(axis), lab)
    return img, lab


def preprocess_liver(raw: Dict[str, np.ndarray], vol, lab_stack, gen,
                     flags: Dict, device):
    """(features, labels) of one raw index-layout batch."""
    t = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in raw.items()}
    bs = t["zidx"].shape[0]
    h, w, c = flags["im_height"], flags["im_width"], flags["im_channel"]
    coins = torch.rand((bs, 3), generator=gen, device=device)
    noise = torch.rand((bs, h, w, c), generator=gen, device=device) * 2 - 1
    img = vol[t["zidx"].long()].permute(0, 2, 3, 1).float()
    lab = lab_stack[t["lab_z"].long()]
    img, lab = crop_resize(img, lab, t["offset"][:, 0], t["offset"][:, 1],
                           t["crop_hw"][:, 0], t["crop_hw"][:, 1], h, w)
    pad = t["pad_mask"].float()
    img = img * pad[:, None, None, :]
    lo = t["clip"][:, 0, None, None, None].float()
    hi = t["clip"][:, 1, None, None, None].float()
    img = (torch.clamp(img, lo, hi) - lo) / (hi - lo)
    valid = (torch.arange(t["centers"].shape[1], device=device)[None]
             < t["n_objs"][:, None])
    guide = gaussian_guide(t["centers"], torch.clamp_min(
        t["stddevs"].float(), flags["min_std"]), valid, h, w, 0.5, 0.5)
    img = (img + noise * abs(flags["noise_scale"])) * pad[:, None, None, :]
    joint = torch.cat([img, guide], dim=-1)
    joint, lab = flip_2d(joint, lab.long(), coins, flags["random_flip"])
    return {"images": joint[..., :c], "sp_guide": joint[..., c:],
            "context": t["context"].float()}, lab


# -- 3-D patch preprocess ---------------------------------------------------

def zscore(img):
    """Per-sample z-score over the non-zero voxels; zeros stay 0."""
    dims = tuple(range(1, img.ndim))
    region = (img > 0).float()
    cnt = torch.clamp_min(region.sum(dim=dims, keepdim=True), 1.0)
    mean = (img * region).sum(dim=dims, keepdim=True) / cnt
    var = ((img - mean) ** 2 * region).sum(dim=dims, keepdim=True) / cnt
    return (img - region * mean) / (region * torch.sqrt(var) + 1e-8)


def preprocess_patch(raw: Dict[str, np.ndarray], gen, flags: Dict, device):
    patch = torch.from_numpy(raw["patch"].astype(np.int32)).to(device)
    lab = torch.from_numpy(raw["label"]).to(device).long()
    coins = torch.rand((patch.shape[0], 3), generator=gen, device=device)
    img = zscore(patch.float())[..., None]
    for bit, col, axis in ((1, 0, 3), (2, 1, 2), (4, 2, 1)):
        if flags["random_flip"] & bit:
            c = coins[:, col] >= 0.5
            img = torch.where(c[:, None, None, None, None], img.flip(axis),
                              img)
            lab = torch.where(c[:, None, None, None], lab.flip(axis), lab)
    return {"images": img}, lab


# -- loss, L2, Adam ---------------------------------------------------------

def weighted_ce(logits, labels, class_w: Sequence[float]):
    """Cross entropy weighted per pixel by its class's weight, the weights
    normalized to sum to each sample's pixel count, over the count of
    non-zero weights."""
    logits = logits.float()
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    w = torch.tensor(class_w, dtype=torch.float32, device=logits.device)[
        labels]
    axes = tuple(range(1, labels.ndim))
    w = w / w.sum(dim=axes, keepdim=True) * math.prod(labels.shape[1:])
    return (w * ce).sum() / torch.clamp_min((w != 0).float().sum(), 1.0)


def decayed(name: str) -> bool:
    """L2 decays conv, dense and transpose-conv kernels and their biases,
    never a norm's scale or offset."""
    return "norm" not in name


class RefTrainer:
    """Steps the reference network from the seeded weights."""

    def __init__(self, config: Dict, weights: Dict[str, torch.Tensor],
                 device, quant=None, fault=None):
        """``quant``: the control's precision (reference.nets.Ops);
        ``fault``: "half_batch" plants the fault of a step that leaves out
        half of each batch and takes the mean over the rest."""
        if fault not in (None, "half_batch"):
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        self.net = nets.build(config).to(device)
        self.net.load_state_dict(weights, strict=True)
        self.flags = config["settings"]
        self.names = [n for n, _ in self.net.named_parameters()]
        self.params = [p for _, p in self.net.named_parameters()]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.ops = nets.Ops(quant)
        self.wd = float(self.flags["weight_decay_rate"])
        self.lr = max(float(self.flags["learning_rate"]),
                      float(self.flags["lr_end"]))

    def step(self, feats, labels, gen):
        """One step (the context's dropout drawn from ``gen``); returns
        (total loss, the gradients as Adam got them)."""
        logits = self.net(feats, self.ops, gen)
        if self.fault == "half_batch":
            half = labels.shape[0] // 2
            logits, labels = logits[:half], labels[:half]
        loss = weighted_ce(logits, labels, self.flags["loss_numeric_w"])
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        total = loss.detach()
        with torch.no_grad():
            dec = [i for i, n in enumerate(self.names) if decayed(n)]
            if self.wd > 0 and dec:
                sq = sum((self.params[i] ** 2).sum() for i in dec)
                total = total + 0.5 * self.wd * sq
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
