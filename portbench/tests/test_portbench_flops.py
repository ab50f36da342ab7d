"""The benchmark's frozen work counts (portbench.flops, from the
configuration files' widths) equal what hooks on the program's own modules
count at a small input size: the forward multiply-adds of every conv,
transpose conv and dense layer, and the planes that kernel B2 normalizes."""

import json
import math
from pathlib import Path

import pytest
import torch

from portbench import flops

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _program_model(cfg):
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.models import build_model, get_model_params

    args = cli.get_args([cfg["task"], "--mode", "train", *cfg["flags"],
                         "--compute_dtype", "float32"])
    p = get_model_params(args)
    return build_model(p["model"], args=args, model_kwargs=p["model_kwargs"],
                       dtype=torch.float32)


def _hooked_counts(model, feats, monkeypatch):
    from boxsegliver_torch.models import gunet, layers

    macs, planes = [0], []

    def hook(mod, inp, out):
        per = out.numel() // out.shape[0]
        if isinstance(mod, (layers.UpConv,)):
            macs[0] += per * mod.weight.shape[0]
        elif isinstance(mod, torch.nn.Linear):
            macs[0] += per * mod.in_features
        else:
            macs[0] += per * mod.weight.shape[1] * math.prod(
                mod.weight.shape[2:])

    orig = layers.norm_relu

    def record(x, norm, spatial=None):
        planes.append((x.shape[1], math.prod(x.shape[2:])))
        return orig(x, norm, spatial)

    monkeypatch.setattr(layers, "norm_relu", record)
    monkeypatch.setattr(gunet, "norm_relu", record)
    kinds = (layers.Conv, layers.Conv3, layers.UpConv, torch.nn.Linear)
    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, kinds)]
    with torch.no_grad():
        model(feats)
    for h in hs:
        h.remove()
    return macs[0], sorted(planes)


@pytest.mark.parametrize("name,shape", [("gnet_sp", (32, 32)),
                                        ("unet3d", (10, 32, 32))])
def test_frozen_counts_match_program_hooks(name, shape, monkeypatch):
    cfg = _config(name)
    model = _program_model(cfg).eval()
    m = cfg["model"]
    if m["arch"] == "GUNet":
        h, w = shape
        feats = {"images": torch.randn(1, h, w, m["in_channels"]),
                 "sp_guide": torch.rand(1, h, w, 1),
                 "context": torch.rand(1, m["context_length"])}
    else:
        feats = {"images": torch.randn(1, *shape, m["in_channels"])}
    macs, planes = _hooked_counts(model, feats, monkeypatch)
    want_macs, want_planes = flops.work(cfg, shape)
    assert macs == want_macs
    assert planes == sorted(want_planes)


def test_full_size_counts():
    """The counts at the cells' sizes, as PERF.md quotes them."""
    g = _config("gnet_sp")
    u = _config("unet3d")
    assert flops.train_flops_per_sample(g, (256, 256)) == pytest.approx(
        3 * 2 * flops.work(g, (256, 256))[0])
    assert flops.work(u, (10, 256, 256))[0] / 1e9 == pytest.approx(199, rel=0.01)
    assert flops.b2_min_seconds(u, (10, 256, 256), 4, True) > 0
