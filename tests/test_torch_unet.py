"""The port's UNet against the flax UNet through the weight bridge, at small
widths on the CPU: the eval forward in float32 within 1e-5 and in bf16
within one bf16 rounding step (2^-7) of the logits' scale, the train-mode
forward (1e-5 of the logits' scale: each layer renormalizes with the
statistics of a small batch, which magnifies the convolutions' summation
order) and the new batch statistics (1e-5) against flax
``mutable=["batch_stats"]``, the bridge's round trip (exact),
``image_gradients`` (exact), the L2-decayed set, the init and the model
configs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.models.layers import image_gradients as j_image_gradients
from boxsegliver_tpu.ops import losses as jlosses
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.layers import Norm, image_gradients
from boxsegliver_torch.models.weights import (flax_names, flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.ops import losses as tlosses

torch.set_num_threads(2)

CASES = {
    # UNet_TINY.yml: 8 channels, 2 down-samples
    "tiny_bn": (dict(MODEL_CONFIGS["UNet_TINY.yml"]), 32),
    "tiny_bn_64": (dict(MODEL_CONFIGS["UNet_TINY.yml"]), 64),
    # the full UNet.yml depth at init 4
    "down4_bn": ({"init_channels": 4, "num_down_samples": 4}, 64),
    "tiny_in": (dict(MODEL_CONFIGS["UNet_TINY.yml"],
                     normalizer="instance_norm"), 32),
    "tiny_no_norm": (dict(MODEL_CONFIGS["UNet_TINY.yml"], without_norm=True),
                     32),
    "tiny_img_grad": (dict(MODEL_CONFIGS["UNet_TINY.yml"], img_grad=True), 32),
}


def _images(rng, bs=2, size=32):
    return rng.normal(size=(bs, size, size, 3)).astype(np.float32)


def _flax_variables(kw, images, rng, dtype=None):
    """flax init, then every norm leaf and running statistic randomized so
    the bridge's placement of each one matters."""
    model = jbuild("UNet", model_kwargs=kw, num_classes=3, dtype=dtype)
    variables = model.init(jax.random.PRNGKey(0), images)
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables)), sep="/")
    for key, val in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("bias", "scale", "mean"):
            flat[key] = rng.normal(0, 0.5, val.shape).astype(np.float32)
        elif leaf == "var":
            flat[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
    return model, flat


def _port(kw, dtype=None):
    return tbuild("UNet", model_kwargs=kw, num_classes=3, dtype=dtype)


def _unflat(flat):
    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax(case):
    kw, size = CASES[case]
    rng = np.random.default_rng(len(case))
    images = _images(rng, size=size)
    jmodel, flat = _flax_variables(kw, images, rng)
    ref = np.asarray(jmodel.apply(_unflat(flat), images, train=False))
    model = _port(kw)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model({"images": torch.from_numpy(images)})
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_bf16_forward_matches_flax():
    """bf16 convs round each layer's output once; both packages do, in
    another summation order, so the logits agree to one bf16 rounding step
    (2^-7) of their scale."""
    kw, size = CASES["tiny_bn"]
    rng = np.random.default_rng(11)
    images = _images(rng, size=size)
    jmodel, flat = _flax_variables(kw, images, rng, dtype=jnp.bfloat16)
    ref = np.asarray(jmodel.apply(_unflat(flat), images, train=False))
    model = _port(kw, dtype=torch.bfloat16)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model({"images": torch.from_numpy(images)}).numpy()
    assert out.dtype == np.float32 and ref.dtype == np.float32
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, atol=2.0 ** -7 * scale, rtol=0)


@pytest.mark.parametrize("case", ["tiny_bn", "down4_bn"])
def test_train_forward_and_batch_stats_match_flax(case):
    kw, size = CASES[case]
    rng = np.random.default_rng(3)
    images = _images(rng, bs=3, size=size)
    jmodel, flat = _flax_variables(kw, images, rng)
    variables = _unflat(flat)
    ref, new_vars = jmodel.apply(variables, images, train=True,
                                 mutable=["batch_stats"])
    model = _port(kw)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model({"images": torch.from_numpy(images)}, train=True)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=0)
    want = {f"batch_stats/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(dict(new_vars["batch_stats"]),
                                       sep="/").items()}
    got = {k: v for k, v in state_dict_to_flax(model).items()
           if k.startswith("batch_stats/")}
    assert set(got) == set(want) and want
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_bias", [(True, True), (False, True),
                                        (True, False)])
def test_batch_norm_train_step_matches_flax(dtype, scale_bias):
    """One train-mode batch norm: output (one rounding step of the compute
    dtype), statistics computed in float32 from the bf16 input, the biased
    batch variance in the 0.99 running update (within 1e-5), and the input
    gradient (1e-4 of its scale, plus one bf16 rounding step in bf16)."""
    use_scale, use_bias = scale_bias
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 9, 7, 6)) * 3.0 + 1.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                       use_bias=use_bias, use_scale=use_scale, dtype=jdt)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt))
    params = {k: jnp.asarray(rng.normal(1.0, 0.3, v.shape), jnp.float32)
              for k, v in variables["params"].items()}
    stats = {"mean": jnp.asarray(rng.normal(0, 1, 6), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, 6), jnp.float32)}
    g = rng.normal(size=x.shape).astype(np.float32)

    def f(xx):
        y, new = bn.apply({"params": params, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return (y.astype(jnp.float32) * g).sum(), (y, new)

    (_, (ref, new)), gx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x, jdt))
    norm = Norm("batch_norm", 6, use_bias=use_bias, use_scale=use_scale)
    with torch.no_grad():
        if use_scale:
            norm.weight.copy_(torch.from_numpy(np.asarray(params["scale"])))
        if use_bias:
            norm.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        norm.running_mean.copy_(torch.from_numpy(np.asarray(stats["mean"])))
        norm.running_var.copy_(torch.from_numpy(np.asarray(stats["var"])))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).detach()
    xt.requires_grad_(True)
    y = norm(xt, train=True)
    (y.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    assert y.dtype == tdt
    out = y.detach().float().permute(0, 2, 3, 1).numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    step = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=step)
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               atol=1e-5, rtol=0)
    gref = np.asarray(gx.astype(jnp.float32))
    gout = xt.grad.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(gout, gref, atol=1e-4 * np.abs(gref).max()
                               + (2.0 ** -7 * np.abs(gref).max()
                                  if dtype == "bfloat16" else 0.0), rtol=0)


def test_bridge_round_trip_is_exact():
    """flax params + batch_stats → state_dict → flax, leaf for leaf, the
    transpose-conv taps and the BN mean / var / scale / bias included."""
    kw, size = CASES["down4_bn"]
    rng = np.random.default_rng(7)
    images = _images(rng, size=size)
    _, flat = _flax_variables(kw, images, rng)
    assert any("/Decode1_up/ConvTranspose_0/kernel" in k for k in flat)
    assert any(k.endswith("/BatchNorm_0/var") for k in flat)
    model = _port(kw)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    back = state_dict_to_flax(model)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    names = flax_names(model)
    assert names["Decode2_up.weight"] == \
        "params/Decode2_up/ConvTranspose_0/kernel"
    assert names["Bridge_conv1.norm.running_var"] == \
        "batch_stats/Bridge_conv1/Norm_0/BatchNorm_0/var"
    assert names["AdjustChannels.bias"] == "params/AdjustChannels/bias"


def test_image_gradients_are_exact():
    x = np.random.default_rng(2).normal(size=(2, 9, 7, 3)).astype(np.float32)
    jdy, jdx = j_image_gradients(jnp.asarray(x))
    dy, dx = image_gradients(torch.from_numpy(x))
    np.testing.assert_array_equal(dy.numpy(), np.asarray(jdy))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("bias_decay", [False, True])
def test_decayed_set_matches_jax_l2(bias_decay):
    """decayed_parameters picks what the JAX l2_regularization decays:
    conv, transpose-conv kernels (and biases unless --bias_decay), nothing
    under BatchNorm_0."""
    kw, size = CASES["tiny_bn"]
    rng = np.random.default_rng(4)
    _, flat = _flax_variables(kw, _images(rng, size=size), rng)
    params = {k: v for k, v in flat.items() if k.startswith("params/")}
    want = set()
    for key in params:
        probe = {k[len("params/"):]: (np.ones_like(v) if k == key
                                      else np.zeros_like(v))
                 for k, v in params.items()}
        if float(jlosses.l2_regularization(_unflat(probe), 1.0,
                                           bias_decay)) > 0:
            want.add(key)
    model = _port(kw)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    names = flax_names(model)
    decayed = tlosses.decayed_parameters(model, bias_decay)
    assert {names[n] for n in decayed} == want
    assert not any("norm" in n for n in decayed)


def test_reset_parameters_gives_the_flax_init():
    model = _port(dict(CASES["tiny_bn"][0]))
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(3.0)
        for b in model.buffers():
            b.fill_(3.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    for name, t in model.state_dict().items():
        if name.endswith(("norm.weight", "running_var")):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.endswith(("bias", "running_mean")):
            assert torch.equal(t, torch.zeros_like(t)), name
        else:                                   # xavier kernels
            assert 0 < float(t.abs().max()) < 1.0, name
    again = _port(dict(CASES["tiny_bn"][0])).reset_parameters(
        torch.Generator().manual_seed(0))
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_build_model_from_flags():
    """UNet.yml at full width from the 001_unet flags; the config's runtime
    keys and the flags UNet does not take are dropped."""
    args = tconfig.build_parser().parse_args(
        ["--mode", "train", "--tag", "t", "--model", "UNet", "--classes",
         "Liver", "Tumor", "--im_channel", "3"])
    model = tbuild("UNet", args=args, model_kwargs=MODEL_CONFIGS["UNet.yml"],
                   dtype=torch.bfloat16)
    assert model.Encode1_conv1.conv.weight.shape == (64, 3, 3, 3)
    assert model.Bridge_conv2.conv.weight.shape == (1024, 1024, 3, 3)
    assert model.Decode4_up.weight.shape == (1024, 512, 2, 2)
    assert model.Decode1_conv1.conv.weight.shape == (64, 128, 3, 3)
    assert model.AdjustChannels.weight.shape == (3, 64, 1, 1)
    assert model.Encode3_conv2.norm.normalizer == "batch_norm"
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    jmodel = jbuild("UNet", args=args, model_kwargs=MODEL_CONFIGS["UNet.yml"])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    assert n_params == sum(int(np.prod(v.shape)) for v in
                           jax.tree_util.tree_leaves(shapes["params"]))
