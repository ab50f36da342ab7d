"""The memory layout of the models' activations on the CPU: an unsharded
GUNet keeps them channels-last from the input to the logits, forward and
backward, with no copy the size of an activation that changes the layout
(B2 and B3 take channels-last operands), while a spatially sharded GUNet
hands contiguous NCHW planes to the split kernels; the other 2-D models
follow their channels-last input the same way, and UNet3D hands B2
contiguous NCDHW planes."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from boxsegliver_torch.models import MODEL_CONFIGS, build_model
from boxsegliver_torch.models import gunet as gunet_mod
from boxsegliver_torch.ops import kernels
from boxsegliver_torch.parallel.mesh import Group
from boxsegliver_torch.parallel.spatial import SpatialShard, shard_modules

torch.set_num_threads(2)

_COPIES = ("copy_", "clone", "_to_copy")
# B2-fwd through its operators, the NCHW plans' and the NHWC's, and B3-fwd
# through its one, the NHWC plans'
_FORWARDS = ("in_relu_fwd", "in_relu_fwd_nhwc_op", "modnorm_relu_fwd_nhwc_op")


def _channels_inner(t: torch.Tensor) -> bool:
    """Whether t [N, C, H, W] keeps its channels innermost (channels-last,
    or a channel slice of a channels-last tensor)."""
    return t.shape[1] > 1 and t.stride(1) == 1


class _LayoutCopies(TorchDispatchMode):
    """Records every copy or clone of an activation (a rank-4 tensor of
    ``batch`` samples and at least ``min_numel`` elements) whose result
    keeps its channels elsewhere than its source did."""

    def __init__(self, batch, min_numel):
        super().__init__()
        self.batch = batch
        self.min_numel = min_numel
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _COPIES:
            src, dst = (args[1], args[0]) if name == "copy_" else (args[0],
                                                                   out)
            if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                    and src.dim() == 4 and src.shape[0] == self.batch
                    and src.numel() >= self.min_numel
                    and _channels_inner(src) != _channels_inner(dst)):
                self.seen.append((name, tuple(src.shape), src.stride(),
                                  dst.stride()))
        return out


def _gunet(**flags):
    kw = dict(MODEL_CONFIGS["GUNet_TINY.yml"], use_context=True,
              use_spatial=True, normalizer="instance_norm", in_channels=3,
              context_length=16)
    kw.update(flags)
    model = build_model("GUNet", model_kwargs=kw, num_classes=3)
    return model.reset_parameters(torch.Generator().manual_seed(0))


def _feats(bs=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    feats = {"images": rng.normal(size=(bs, size, size, 3)),
             "sp_guide": rng.uniform(0.5, 1.0, (bs, size, size, 1)),
             "context": rng.normal(size=(bs, 16))}
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in feats.items()}


def _record(monkeypatch, module, name, seen, what=_channels_inner):
    """Wrap module.name to record ``what`` of its first operand (by default
    whether it keeps its channels innermost)."""
    fn = getattr(module, name)

    def wrapped(x, *args, **kwargs):
        seen.append(what(x))
        return fn(x, *args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("flags", [{}, {"norm_with_center": False,
                                        "norm_with_scale": True}],
                         ids=["gunet_yml", "gunet_sp_yml"])
def test_unsharded_gunet_step_changes_no_layout(monkeypatch, flags):
    """A GUNet_TINY training step: every B2 and B3 forward takes
    channels-last x, the logits come back NHWC-contiguous, and no copy the
    size of an activation changes the layout, forward or backward."""
    model = _gunet(**flags)
    feats = _feats()
    seen = []
    for name in _FORWARDS:
        _record(monkeypatch, kernels, name, seen)
    mode = _LayoutCopies(batch=2, min_numel=2 * 8 * 16 * 16)
    with mode:
        logits = model(feats, train=True)
        logits.square().mean().backward()
    assert logits.is_contiguous() and logits.shape == (2, 32, 32, 3)
    assert len(seen) == 6 + 4 and all(seen)     # 6 B2 and 4 B3 blocks
    assert mode.seen == []
    assert all(p.grad is not None for p in model.parameters())


class _OneRank(Group):
    """A group of this process alone: a spatial shard of one block."""

    def __init__(self):
        self.pg = self.host_pg = None
        self.rank, self.size, self.backend = 0, 1, "gloo"

    def all_reduce_(self, t):
        return t


def test_sharded_gunet_hands_nchw_to_the_split_kernels(monkeypatch):
    """Under a spatial shard (one rank's block) the forward keeps today's
    path: B2y and B3's split form take contiguous NCHW planes, the
    unsharded B2 / B3 never run, and the logits are the unsharded model's."""
    model = _gunet()
    feats = _feats(seed=1)
    with torch.no_grad():
        want = model(feats)
    b2y, b3, whole = [], [], []
    _record(monkeypatch, kernels, "in_relu_fwd_apply", b2y,
            torch.Tensor.is_contiguous)
    _record(monkeypatch, gunet_mod, "modnorm_relu_split", b3)
    for name in _FORWARDS:
        _record(monkeypatch, kernels, name, whole)
    shard = SpatialShard(_OneRank())
    mods = shard_modules(model)
    for m in mods:
        m.spatial = shard
    try:
        with torch.no_grad():
            got = model(feats)
    finally:
        for m in mods:
            m.spatial = None
    assert len(b2y) == 6 and all(b2y) and len(b3) == 4 and whole == []
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,kw,inputs,nhwc", [
    ("UNet", dict(init_channels=4, num_down_samples=2,
                  normalizer="instance_norm"),
     {"images": (2, 32, 32, 3)}, True),
    ("UNet", dict(init_channels=4, num_down_samples=2,
                  normalizer="instance_norm", in_channels=1),
     {"images": (2, 32, 32, 1)}, True),
    ("UNet3D", dict(init_channels=4, max_channels=16, num_pool_layers=4),
     {"images": (1, 4, 32, 32, 1)}, False),
], ids=["unet", "unet_one_channel", "unet3d"])
def test_models_hand_b2_their_layout(monkeypatch, name, kw, inputs, nhwc):
    """The strides choose B2's plans for every model: UNet (instance norm)
    follows the channels-last view its input permute makes, with no copy
    that changes the layout, as GUNet does (the NHWC plans); UNet3D keeps
    NCDHW (B2 takes its contiguous planes, the NCHW plans)."""
    model = build_model(name, model_kwargs=kw, num_classes=3)
    rng = np.random.default_rng(2)
    feats = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for k, s in inputs.items()}
    layouts = []
    for op in _FORWARDS[:2]:
        _record(monkeypatch, kernels, op, layouts,
                lambda x, op=op: (op, x.is_contiguous()))
    mode = _LayoutCopies(batch=feats["images"].shape[0], min_numel=1)
    with mode:
        model(feats, train=True).square().mean().backward()
    want = ("in_relu_fwd_nhwc_op", False) if nhwc else ("in_relu_fwd", True)
    assert layouts and set(layouts) == {want}
    if nhwc:
        assert mode.seen == []
