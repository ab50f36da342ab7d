"""Kernel B2's plain PyTorch version (what a CPU tensor runs; the CUDA
kernels are held against it on the card by tests/test_torch_cuda.py and
chip_smoke.py) against the JAX package: its Pallas custom VJP
``fused_instance_norm_relu`` (the backward in interpret mode, as
tests/test_pallas_kernels.py runs it) and autodiff of flax
``Norm('instance_norm')`` + ReLU, the JAX default path.  float32, atol 2e-4
/ rtol 1e-3: the JAX test's own tolerance for the same math summed in
another order.  Also the port's dropout against flax's semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from boxsegliver_tpu.models.layers import Norm as JNorm
from boxsegliver_tpu.ops.pallas_kernels import fused_instance_norm_relu
from boxsegliver_torch.models.layers import (MLP, ConvNormAct, Norm, dropout,
                                             dropout_apply, fused_pair)
from boxsegliver_torch.ops import kernels

TOL = dict(atol=2e-4, rtol=1e-3)
SHAPES = [(2, 24, 16, 8), (1, 7, 9, 1), (3, 5, 13, 4)]   # NHWC


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.2, 1.5, shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    w = (rng.normal(size=c) * 0.3 + 1.0).astype(np.float32)
    b = (rng.normal(size=c) * 0.3).astype(np.float32)
    return x, g, w, b


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _port_grads(x, g, w, b):
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = kernels.instance_norm_relu(xt, wt, bt)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), _nchw(g))
    return _nhwc(y), _nhwc(dx), dw.numpy(), db.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_b2_matches_the_pallas_vjp(shape):
    x, g, w, b = _inputs(shape, seed=sum(shape))
    y_j, vjp = jax.vjp(fused_instance_norm_relu, jnp.asarray(x),
                       jnp.asarray(w), jnp.asarray(b))
    want = (np.asarray(y_j),) + tuple(np.asarray(t)
                                      for t in vjp(jnp.asarray(g)))
    got = _port_grads(x, g, w, b)
    for a, ref, name in zip(got, want, ("y", "dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(a, ref, err_msg=name, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_b2_matches_flax_norm_relu_autodiff(shape):
    x, g, w, b = _inputs(shape, seed=7 + sum(shape))
    norm = JNorm("instance_norm")
    variables = norm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": {"InstanceNorm_0": {"scale": jnp.asarray(w),
                                            "bias": jnp.asarray(b)}}}
    assert jax.tree_util.tree_structure(variables) == \
        jax.tree_util.tree_structure(params)

    def f(x_, p):
        return jax.nn.relu(norm.apply(p, x_))

    y_j, vjp = jax.vjp(f, jnp.asarray(x), params)
    dx_j, dp = vjp(jnp.asarray(g))
    got = _port_grads(x, g, w, b)
    want = (y_j, dx_j, dp["params"]["InstanceNorm_0"]["scale"],
            dp["params"]["InstanceNorm_0"]["bias"])
    for a, ref, name in zip(got, want, ("y", "dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(a, np.asarray(ref), err_msg=name, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_saves_xhat_in_the_input_dtype(dtype):
    x, g, w, b = _inputs((2, 8, 8, 3), seed=1)
    xt = _nchw(x).to(dtype)
    y, xhat, rstd = kernels.in_relu_fwd(xt, torch.from_numpy(w),
                                        torch.from_numpy(b))
    assert y.dtype == xhat.dtype == dtype
    assert rstd.dtype == torch.float32 and rstd.shape == (2, 3)
    xt.requires_grad_(True)
    out = kernels.instance_norm_relu(xt, torch.from_numpy(w),
                                     torch.from_numpy(b))
    (dx,) = torch.autograd.grad(out.float().sum(), (xt,))
    assert dx.dtype == dtype


def test_b2_plain_backward_is_the_written_out_math():
    """in_relu_bwd_plain's gz, s1, s2, dγ = Σ_n s2, dβ = Σ_n s1 against
    torch autodiff of the plain forward."""
    x, g, w, b = _inputs((2, 6, 5, 3), seed=2)
    xt = _nchw(x).double().requires_grad_(True)
    wt = torch.from_numpy(w).double().requires_grad_(True)
    bt = torch.from_numpy(b).double().requires_grad_(True)
    mean = xt.mean(dim=(2, 3), keepdim=True)
    var = ((xt - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    z = (xt - mean) / torch.sqrt(var + 1e-6) * wt.view(1, -1, 1, 1) \
        + bt.view(1, -1, 1, 1)
    want = torch.autograd.grad(torch.relu(z), (xt, wt, bt), _nchw(g).double())
    _, xhat, rstd = kernels.in_relu_fwd_plain(_nchw(x), torch.from_numpy(w),
                                              torch.from_numpy(b))
    got = kernels.in_relu_bwd_plain(_nchw(g), xhat, rstd, torch.from_numpy(w),
                                    torch.from_numpy(b))
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.numpy(), ref.float().numpy(), **TOL)


def test_fused_pair_routes_only_full_affine_instance_norm():
    assert fused_pair(Norm("instance_norm", 4), True)
    assert not fused_pair(Norm("instance_norm", 4), False)
    assert not fused_pair(Norm("instance_norm", 4, use_scale=False), True)
    assert not fused_pair(Norm("batch_norm", 4), True)
    assert not fused_pair(None, True)


def test_conv_norm_act_runs_b2_in_train_and_eval():
    layer = ConvNormAct(3, 4, normalizer="instance_norm")
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    fwd = kernels.in_relu_fwd.launches
    for train in (False, True):
        y = layer(x, train=train)
        ref = torch.relu(layer.norm(layer.conv(x)))
        torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
    # a CPU tensor takes the plain version and does not count as a launch
    assert kernels.in_relu_fwd.launches == fwd


def test_batch_norm_train_mode_raises():
    """Train-mode batch norm is ported (held against flax in
    tests/test_torch_unet.py) and stays out of kernel B2; what still raises
    is a normalizer the JAX package does not know."""
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    norm = Norm("batch_norm", 4)
    fwd = kernels.in_relu_fwd.launches
    y = norm(x, train=True)
    torch.testing.assert_close(
        y, (x - x.mean(dim=(0, 2, 3), keepdim=True))
        * torch.rsqrt(x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
                      + 1e-3).view(1, -1, 1, 1), atol=1e-5, rtol=1e-5)
    assert not torch.equal(norm.running_mean, torch.zeros(4))
    assert kernels.in_relu_fwd.launches == fwd
    with pytest.raises(ValueError, match="group_norm"):
        Norm("group_norm", 4)


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_dropout_matches_flax_semantics(rate):
    """flax nn.Dropout keeps with probability 1 − rate and scales kept units
    by 1 / (1 − rate); with flax's own keep mask the port's dropout_apply
    gives flax's output exactly."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 2.0, (4, 64)).astype(np.float32)
    y_j = np.asarray(fnn.Dropout(rate).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(5)}))
    keep = torch.from_numpy(y_j != 0)
    y = dropout_apply(torch.from_numpy(x), keep, 1.0 - rate)
    np.testing.assert_array_equal(y.numpy(), y_j)
    # the port's own draws: same semantics, deterministic per generator
    xt = torch.from_numpy(x).repeat(64, 1)
    a = dropout(xt, rate, True, torch.Generator().manual_seed(0))
    b = dropout(xt, rate, True, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.02
    torch.testing.assert_close(a[kept], (xt / (1 - rate))[kept])
    assert dropout(xt, rate, False) is xt and dropout(xt, 0.0, True) is xt


def test_mlp_dropout_only_on_hidden_layers_in_train_mode():
    mlp = MLP(6, [16, 16, 5], use_dropout=True, keep_prob=0.5)
    x = torch.randn(3, 6, generator=torch.Generator().manual_seed(1))
    assert torch.equal(mlp(x), mlp(x, train=False))
    a = mlp(x, train=True, generator=torch.Generator().manual_seed(2))
    assert not torch.allclose(a, mlp(x))
    assert MLP(6, [16, 5]).rate == 0.0 and mlp.rate == 0.5
