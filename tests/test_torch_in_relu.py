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
from boxsegliver_tpu.ops.pallas_kernels import (_in_relu_bwd_pallas,
                                                fused_instance_norm_relu)
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
    """in_relu_bwd_plain's dx, and dγ = Σ_n s2, dβ = Σ_n s1 from its s1,
    s2, against torch autodiff of the plain forward."""
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
    dx, s1, s2 = kernels.in_relu_bwd_plain(_nchw(g), xhat,
                                           torch.from_numpy(w),
                                           torch.from_numpy(b), rstd)
    assert s1.shape == s2.shape == (2, 3) and s1.dtype == torch.float32
    for a, ref in zip((dx, s2.sum(dim=0), s1.sum(dim=0)), want):
        np.testing.assert_allclose(a.numpy(), ref.float().numpy(), **TOL)


# [N, C, *S] planes of B2f's plain version: 2-D (NCHW) and 3-D (NCDHW)
BWD_SHAPES = [(2, 3, 6, 5), (1, 4, 9, 7), (2, 3, 2, 5, 4), (1, 2, 3, 4, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_b2f_plain_matches_the_pallas_backward(shape, dtype):
    """in_relu_bwd_plain's (dx, s1, s2), B2f's outputs, against JAX's
    _in_relu_bwd_pallas in interpret mode on the same g, x̂ and rstd (the
    port's plain forward of one x): dx, and dγ = Σ_n s2, dβ = Σ_n s1 against
    its two sums.  An NCDHW plane is JAX's [h, w] plane with h = D·H.  In
    the working dtype, at test_b2_matches_the_pallas_vjp's tolerances: the
    per-element arithmetic is the same, the sums' order is not."""
    rng = np.random.default_rng(sum(shape))
    c = shape[1]
    x = torch.from_numpy(rng.normal(0.2, 1.5, shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=c) * 0.3 + 1.0).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=c) * 0.3).astype(np.float32))
    _, xhat, rstd = kernels.in_relu_fwd_plain(x.to(dtype), w, b)
    dx, s1, s2 = kernels.in_relu_bwd_plain(g, xhat, w, b, rstd)
    assert dx.dtype == dtype and s1.dtype == s2.dtype == torch.float32
    assert s1.shape == s2.shape == shape[:2]

    def nhwc(t):                   # [N, C, *S] -> [N, prod(S[:-1]), W, C]
        a = t.float().numpy()
        a = a.reshape(shape[0], c, -1, shape[-1]).transpose(0, 2, 3, 1)
        return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                     else jnp.float32)

    dx_j, dw_j, db_j = _in_relu_bwd_pallas(
        nhwc(g), nhwc(xhat), jnp.asarray(rstd.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), interpret=True)
    want_dx = np.asarray(dx_j.astype(jnp.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(dx.float().numpy().reshape(want_dx.shape),
                               want_dx, err_msg="dx", **TOL)
    np.testing.assert_allclose(s2.sum(dim=0).numpy(), np.asarray(dw_j),
                               err_msg="dgamma", **TOL)
    np.testing.assert_allclose(s1.sum(dim=0).numpy(), np.asarray(db_j),
                               err_msg="dbeta", **TOL)


def test_b2_backward_on_the_cpu_chains_b2a_and_b2b_plain():
    """The autograd Function's backward on a CPU tensor: B2a's and B2b's
    plain versions, no launch counted; the same numbers as B2f's plain
    version (on the x̂ and rstd of the CPU's forward, the plain version with
    exact statistics)."""
    x, g, w, b = _inputs((2, 8, 8, 3), seed=4)
    before = {n: f.launches for n, f in kernels.KERNELS.items()}
    xt = _nchw(x).requires_grad_(True)
    y = kernels.instance_norm_relu(xt, torch.from_numpy(w),
                                   torch.from_numpy(b))
    (dx,) = torch.autograd.grad(y, (xt,), _nchw(g))
    assert {n: f.launches for n, f in kernels.KERNELS.items()} == before
    _, xhat, rstd = kernels.in_relu_fwd_plain(_nchw(x), torch.from_numpy(w),
                                              torch.from_numpy(b), exact=True)
    want = kernels.in_relu_bwd_plain(_nchw(g), xhat, torch.from_numpy(w),
                                     torch.from_numpy(b), rstd)
    assert torch.equal(dx, want[0])
    got = kernels.instance_norm_relu_bwd(_nchw(g), xhat, torch.from_numpy(w),
                                         torch.from_numpy(b), rstd)
    for a, ref in zip(got, want):
        assert torch.equal(a, ref)


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
