"""GUNet of the port against the flax GUNet through the weight bridge, at
small widths on the CPU in float32 (tolerance 1e-4: the same float32 math,
summed in another order), plus the bridge's key rules, weight files and
the port's copies of the model configs."""

import argparse
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.models import load_model_config as jload_config
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_key_to_torch,
                                              flax_to_state_dict, load_weights)

torch.set_num_threads(2)

_CFG_DIR = Path(__file__).resolve().parents[1] / "boxsegliver_tpu" / \
    "configs" / "models"
_TINY = {"init_channels": 6, "num_down_samples": 2, "mod_layers": (1, 2),
         "context_fc_channels": (8,)}

CASES = {
    # GUNet.yml flags: norm_with_center, the 002_gnet_sp model
    "gunet_yml": dict(norm_with_center=True, norm_with_scale=False,
                      use_context=True, use_spatial=True,
                      normalizer="instance_norm"),
    # GUNet_SP.yml flags: norm_with_scale
    "gunet_sp_yml": dict(norm_with_center=False, norm_with_scale=True,
                         use_context=True, use_spatial=True,
                         normalizer="instance_norm"),
    "batch_norm_eval": dict(norm_with_center=True, use_context=True,
                            use_spatial=True, normalizer="batch_norm"),
    "after_affine_bn": dict(after_affine=True, use_context=True,
                            use_spatial=True, normalizer="batch_norm"),
    "spatial_only_fix": dict(use_spatial=True, fix=True,
                             normalizer="instance_norm"),
    "context_only_no_norm": dict(use_context=True, without_norm=True,
                                 mod_layers=(0, 2)),
    "plain_unet_trunk": dict(normalizer="batch_norm", init_channels=8,
                             mod_layers=()),
}


def _feats(rng, bs=2, size=64, ctx_len=16):
    return {"images": rng.normal(size=(bs, size, size, 3)).astype(np.float32),
            "sp_guide": rng.uniform(0.5, 1.0, (bs, size, size, 1)
                                    ).astype(np.float32),
            "context": rng.normal(size=(bs, ctx_len)).astype(np.float32)}


def _flax_variables(kw, feats, rng):
    """flax init, then every norm / affine leaf and running stat randomized
    so the bridge's placement of each one matters."""
    model = jbuild("GUNet", model_kwargs=kw, num_classes=3)
    variables = model.init(jax.random.PRNGKey(0), feats)
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables)), sep="/")
    for key, val in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("bias", "beta", "scale", "gamma", "mean"):
            flat[key] = rng.normal(0, 0.5, val.shape).astype(np.float32)
        elif leaf == "var":
            flat[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
    return model, flat


def _port(kw):
    return tbuild("GUNet", model_kwargs=dict(kw, in_channels=3,
                                             context_length=16),
                  num_classes=3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax(case):
    kw = dict(_TINY, **CASES[case])
    rng = np.random.default_rng(len(case))
    feats = _feats(rng)
    jmodel, flat = _flax_variables(kw, feats, rng)
    ref = np.asarray(jmodel.apply(
        traverse_util.unflatten_dict(flat, sep="/"), feats, train=False))
    model = _port(kw)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in feats.items()})
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size", [40, 36])
def test_forward_matches_flax_ragged_pyramid(size):
    """Sizes whose guide pyramid has an odd level: flax's SAME avg_pool
    counts the zero padding, SAME max pool keeps the ragged edge."""
    kw = dict(_TINY, **CASES["gunet_yml"], num_down_samples=1,
              mod_layers=(0, 1))
    rng = np.random.default_rng(size)
    feats = _feats(rng, size=size)
    feats["sp_guide"][:, :1] = 1.0
    jmodel, flat = _flax_variables(kw, feats, rng)
    ref = np.asarray(jmodel.apply(
        traverse_util.unflatten_dict(flat, sep="/"), feats, train=False))
    model = _port(kw)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_weight_files(tmp_path, suffix):
    kw = dict(_TINY, **CASES["batch_norm_eval"])
    rng = np.random.default_rng(3)
    feats = _feats(rng, size=32)
    jmodel, flat = _flax_variables(kw, feats, rng)
    path = tmp_path / ("w" + suffix)
    if suffix == ".npz":
        np.savez(path, **flat)
    else:
        torch.save(flax_to_state_dict(flat), path)
    model = load_weights(_port(kw), path)
    ref = np.asarray(jmodel.apply(
        traverse_util.unflatten_dict(flat, sep="/"), feats, train=False))
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        load_weights(model, tmp_path / "w.ckpt")


@pytest.mark.parametrize("key,want", [
    ("params/Encode1_conv1/kernel", "Encode1_conv1.weight"),
    ("params/Encode2_conv1_norm/InstanceNorm_0/scale",
     "Encode2_conv1_norm.weight"),
    ("batch_stats/up_conv1_1/Norm_0/BatchNorm_0/var",
     "up_conv1_1.norm.running_var"),
    ("params/up_conv2_2/Conv_0/kernel", "up_conv2_2.conv.weight"),
    ("params/up1/ConvTranspose_0/bias", "up1.bias"),
    ("params/context/Dense_1/kernel", "context.Dense_1.weight"),
    ("params/Encode3_conv2_affine/gamma", "Encode3_conv2_affine.gamma"),
])
def test_bridge_key_rules(key, want):
    assert flax_key_to_torch(key) == want


def test_transpose_conv_taps_are_flipped():
    """flax ConvTranspose output phase (p, q) reads tap (1-p, 1-q)."""
    kernel = np.arange(2 * 2 * 1 * 1, dtype=np.float32).reshape(2, 2, 1, 1)
    sd = flax_to_state_dict({"params/up1/ConvTranspose_0/kernel": kernel})
    w = sd["up1.weight"].numpy()
    assert w.shape == (1, 1, 2, 2)
    assert w[0, 0, 0, 0] == kernel[1, 1, 0, 0]
    assert w[0, 0, 0, 1] == kernel[1, 0, 0, 0]


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_configs_equal_yml(name):
    path = _CFG_DIR / name
    if not path.exists():
        path = _CFG_DIR / "ext_config" / name
    with path.open() as f:
        assert MODEL_CONFIGS[name] == yaml.safe_load(f)
    assert jload_config("GUNet", name) == MODEL_CONFIGS[name]


def test_build_model_from_flags():
    """--im_channel and --context_list give the input widths that flax
    infers at init; full-width GUNet.yml has the flagship's widths."""
    args = tconfig.build_parser().parse_args(
        ["--mode", "eval", "--tag", "t", "--model", "GUNet", "--classes",
         "Liver", "Tumor", "--use_context", "--context_list", "hist", "200",
         "--use_spatial", "--normalizer", "instance_norm"])
    model = tbuild("GUNet", args=args, model_kwargs=MODEL_CONFIGS["GUNet.yml"],
                   dtype=torch.bfloat16)
    assert model.Encode1_conv1.weight.shape == (64, 3, 3, 3)
    assert model.context.Dense_0.weight.shape == (256, 200)
    # gammas of the two convs of levels 1-4: 2 * 64 * (2 + 4 + 8 + 16)
    assert model.context.Dense_2.weight.shape[0] == 3840
    assert model.Encode5_conv2.weight.shape[0] == 1024
    assert model.AdjustChannels.weight.shape == (3, 64, 1, 1)
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("kw", [{"use_se": True},
                                {"use_context": True, "context_model": "conv"},
                                {"img_grad": True}])
def test_unported_variants_raise(kw):
    """Each variant raised until its slice ported it, and now builds:
    use_se (the DenseUNet slice) the squeeze-excitation pair of every
    modulated conv (held against JAX in tests/test_torch_gunet_se.py);
    img_grad (the NF slice) a first conv over the images and their two
    gradients (held against JAX in tests/test_torch_inter.py); the conv
    context (the nf2 slice) the PatchCNN over a 3-scale pyramid (held
    against JAX in tests/test_torch_iin_model.py)."""
    if kw == {"use_se": True}:
        model = tbuild("GUNet", model_kwargs=dict(_TINY, use_context=True,
                                                  **kw), num_classes=3)
        # levels 1 and 2 (6 · 2 and 6 · 4 channels), 8 context features
        assert model.context.Dense_1.weight.shape[0] == 8 * 2 * 2
        for level, ch in ((2, 12), (3, 24)):
            se1 = model._modules[f"Encode{level}_conv1_se1"].weight
            se2 = model._modules[f"Encode{level}_conv1_se2"].weight
            assert se1.shape == ((ch + 8) // 4, ch + 8)
            assert se2.shape == (ch, (ch + 8) // 4)
        return
    if kw == {"img_grad": True}:
        model = tbuild("GUNet", model_kwargs=dict(_TINY, **kw), num_classes=3)
        assert model.img_grad and model.Encode1_conv1.weight.shape[1] == 9
        return
    if kw.get("context_model") == "conv":
        model = tbuild("GUNet", model_kwargs=dict(_TINY, **kw), num_classes=3)
        assert model.context.Conv_0.weight.shape[1] == 3


def test_bf16_forward_runs_on_cpu():
    kw = dict(_TINY, **CASES["gunet_yml"])
    model = tbuild("GUNet", model_kwargs=dict(kw, in_channels=3,
                                              context_length=16),
                   num_classes=3, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    feats = _feats(np.random.default_rng(0), size=32)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in feats.items()})
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_parser_defaults_match_jax():
    """The port keeps the JAX flag registry: every shared flag has the same
    default; the port adds --device."""
    from boxsegliver_tpu import config as jconfig

    argv = ["--mode", "eval", "--tag", "t", "--model", "GUNet", "--classes",
            "Liver", "Tumor"]
    j = vars(jconfig.build_parser().parse_args(argv))
    t = vars(tconfig.build_parser().parse_args(argv))
    assert set(t) - set(j) == {"device"}
    assert {k: t[k] for k in j} == j
    assert t["device"] == "cuda"
    assert isinstance(argparse.Namespace(**t), argparse.Namespace)
