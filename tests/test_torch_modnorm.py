"""Kernel B3's plain PyTorch version (what a CPU tensor runs; the CUDA
kernels are held against it on the card by tests/test_torch_cuda.py)
against the JAX package's modulated block (boxsegliver_tpu/models/
gunet.py:215-232: flax ``Norm('instance_norm')`` → ·γ → +s → ReLU,
differentiated by ``jax.vjp``), and the rule that routes a G-Net block to
B3.  float32 at B2's tolerance (atol 2e-4 / rtol 1e-3: the same math summed
in another order); bfloat16 operands against the float32 math on the same
values, within bf16's rounding (B3 computes in float32 and rounds once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from boxsegliver_tpu.models.layers import Norm as JNorm
from boxsegliver_torch.models import build_model
from boxsegliver_torch.models import gunet as gunet_mod
from boxsegliver_torch.models.layers import Conv
from boxsegliver_torch.ops import kernels

TOL = dict(atol=2e-4, rtol=1e-3)
# GUNet.yml's four modulated levels (128^2 x 128 ... 16^2 x 1024), scaled
# down; NHWC
LEVELS = [(2, 32, 32, 4), (2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 32)]
# (γ, s, the norm's scale, its center): GUNet.yml is (1, 1, 0, 1),
# GUNet_SP.yml (1, 1, 1, 0), GUNet_DE without a spatial guide (1, 0, 0, 1)
OPERANDS = [(1, 1, 0, 1), (1, 1, 1, 0), (1, 1, 1, 1), (1, 0, 0, 1),
            (0, 1, 0, 1), (0, 0, 1, 1), (1, 0, 1, 0), (0, 1, 1, 1),
            (0, 0, 0, 1), (1, 1, 0, 0), (0, 1, 1, 0), (1, 0, 1, 1)]
CASES = [(LEVELS[k % 4],) + ops for k, ops in enumerate(OPERANDS)]


def _inputs(shape, seed, dtype):
    """NHWC x, g, s; γ [N, C]; w, b [C] — each rounded to ``dtype``'s
    values where the port holds it in that dtype (x, g, s; γ comes from
    the context in the compute dtype)."""
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]

    def cast(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).float() \
            .numpy()

    x = cast(rng.normal(0.2, 1.5, shape))
    g = cast(rng.normal(size=shape))
    s = cast(rng.normal(0.0, 0.7, shape))
    gamma = cast(rng.normal(1.0, 0.5, (n, c)))
    w = (rng.normal(size=c) * 0.3 + 1.0).astype(np.float32)
    b = (rng.normal(size=c) * 0.3).astype(np.float32)
    return x, g, s, gamma, w, b


def _jax_block(x, g, s, gamma, w, b, has):
    """y and the VJP of JAX's modulated block in float32 (NHWC)."""
    use_g, use_s, use_w, use_b = has
    norm = JNorm("instance_norm", use_bias=bool(use_b),
                 use_scale=bool(use_w))
    params = {}
    if use_w:
        params["scale"] = jnp.asarray(w)
    if use_b:
        params["bias"] = jnp.asarray(b)

    def f(x_, gm, sp, p):
        y = norm.apply({"params": {"InstanceNorm_0": p}}, x_)
        if use_g:
            y = y * gm[:, None, None, :]
        if use_s:
            y = y + sp
        return fnn.relu(y)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(s),
                     params)
    dx, dgamma, ds, dp = vjp(jnp.asarray(g))
    out = {"y": y, "dx": dx, "dgamma": dgamma, "ds": ds}
    if use_w:
        out["dw"] = dp["scale"]
    if use_b:
        out["db"] = dp["bias"]
    return {k: np.asarray(v) for k, v in out.items()}


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _port_block(x, g, s, gamma, w, b, has, dtype):
    """y and the gradients of ModulatedNormReLU (the CPU's plain path) with
    x, g and s in ``dtype``, as G-Net holds them."""
    use_g, use_s, use_w, use_b = has
    xt = _nchw(x, dtype).requires_grad_(True)
    gt = (torch.from_numpy(gamma).to(dtype).requires_grad_(True)
          if use_g else None)
    st = _nchw(s, dtype).requires_grad_(True) if use_s else None
    wt = torch.from_numpy(w).requires_grad_(True) if use_w else None
    bt = torch.from_numpy(b).requires_grad_(True) if use_b else None
    y = kernels.modulated_norm_relu(xt, gt, st, wt, bt)
    assert y.dtype == dtype
    named = [("dx", xt), ("dgamma", gt), ("ds", st), ("dw", wt), ("db", bt)]
    named = [(k, t) for k, t in named if t is not None]
    grads = torch.autograd.grad(y, [t for _, t in named], _nchw(g, dtype))
    out = {"y": _nhwc(y)}
    for (k, t), d in zip(named, grads):
        assert d.dtype == t.dtype
        out[k] = _nhwc(d) if d.ndim == 4 else d.float().numpy()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,use_g,use_s,use_w,use_b", CASES)
def test_b3_matches_jax_modulated_block(shape, use_g, use_s, use_w, use_b,
                                        dtype):
    has = (use_g, use_s, use_w, use_b)
    ops = _inputs(shape, seed=sum(shape) + 2 * sum(has), dtype=dtype)
    want = _jax_block(*ops, has)
    got = _port_block(*ops, has, dtype)
    named = ("dgamma", "ds", "dw", "db")
    assert set(got) == {"y", "dx"} | {k for k, u in zip(named, has) if u}
    for k, a in got.items():
        ref = want[k]
        if dtype == torch.float32:
            np.testing.assert_allclose(a, ref, err_msg=k, **TOL)
        else:
            # one bf16 rounding of y and dx (ds = g·[y > 0] is exact); x̂
            # saved in bf16 moves dx, and each term of the sums dγ (over a
            # plane) and dw, db (over the batch's planes), by its rounding:
            # a random walk of sqrt(terms) steps of 2^-9
            terms = {"dgamma": shape[1] * shape[2],
                     "dw": np.prod(shape[:3]), "db": np.prod(shape[:3])}
            np.testing.assert_allclose(
                a, ref, err_msg=k, rtol=2 ** -7,
                atol=2e-2 * max(1.0, np.sqrt(terms.get(k, 1)) / 4))


def test_b3_plain_backward_is_autodiff_of_the_plain_forward():
    """modnorm_relu_bwd_plain with ModulatedNormReLU's dγ, dw, db against
    torch autodiff of modnorm_relu_fwd_plain's y, in float64."""
    x, g, s, gamma, w, b = (torch.from_numpy(a).double() for a in
                            _inputs((2, 6, 5, 3), seed=2,
                                    dtype=torch.float32))
    x, g, s = (t.permute(0, 3, 1, 2).contiguous() for t in (x, g, s))
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, s, w, b)]
    y, _, _ = kernels.modnorm_relu_fwd_plain(*leaves)
    want = torch.autograd.grad(y, leaves, g)
    got = torch.autograd.grad(kernels.ModulatedNormReLU.apply(
        *leaves, kernels.IN_EPS), leaves, g)
    for a, ref in zip(got, want):
        torch.testing.assert_close(a, ref, atol=1e-10, rtol=1e-8)
    assert torch.autograd.gradcheck(
        lambda *t: kernels.ModulatedNormReLU.apply(*t, kernels.IN_EPS),
        tuple(leaves))


def test_b3_no_grad_form_gives_y_alone():
    """Under no-grad modulated_norm_relu runs B3-fwd without the planes'
    mean and rstd; y equals the training forward's."""
    x, _, s, gamma, w, b = (torch.from_numpy(a) for a in _inputs(
        (2, 8, 8, 4), seed=5, dtype=torch.bfloat16))
    x, s = _nchw(x.numpy(), torch.bfloat16), _nchw(s.numpy(), torch.bfloat16)
    y, mean, rstd = kernels.modnorm_relu_fwd_nhwc_op(x, gamma, s, w, b,
                                                     train=False)
    assert mean.numel() == rstd.numel() == 0
    y_t, mean_t, rstd_t = kernels.modnorm_relu_fwd_nhwc_op(x, gamma, s, w, b)
    assert mean_t.dtype == rstd_t.dtype == torch.float32
    assert mean_t.shape == rstd_t.shape == (2, 4)
    with torch.no_grad():
        y_m = kernels.modulated_norm_relu(x, gamma, s, w, b)
    assert torch.equal(y, y_t) and torch.equal(y_m, y)
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_takes_any_layout_of_x(dtype):
    """B3 has the NHWC plans alone: a contiguous NCHW x is laid out
    channels-last first, so y and every gradient equal those of the same
    call on x's channels-last copy."""
    x, g, s, gamma, w, b = _inputs((2, 6, 5, 3), seed=7, dtype=dtype)
    x, g, s = _nchw(x, dtype), _nchw(g, dtype), _nchw(s, dtype)
    gamma, w, b = (torch.from_numpy(t) for t in (gamma, w, b))
    outs = []
    for layout in (torch.contiguous_format, torch.channels_last):
        leaves = [t.clone().requires_grad_(True) for t in (gamma, w, b)]
        xl, sl = (t.contiguous(memory_format=layout).requires_grad_(True)
                  for t in (x, s))
        y = kernels.modulated_norm_relu(xl, leaves[0], sl, *leaves[1:])
        outs.append([y] + list(torch.autograd.grad(y, [xl, sl] + leaves, g)))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# which G-Net blocks take B3
# ---------------------------------------------------------------------------

_TINY = {"init_channels": 4, "num_down_samples": 2, "mod_layers": (1, 2),
         "context_fc_channels": (8,), "normalizer": "instance_norm"}


def _feats(size=16, bs=2):
    rng = np.random.default_rng(0)
    return {"images": torch.from_numpy(
                rng.normal(size=(bs, size, size, 3)).astype(np.float32)),
            "sp_guide": torch.from_numpy(
                rng.uniform(0.5, 1.0, (bs, size, size, 1)).astype(
                    np.float32)),
            "context": torch.from_numpy(
                rng.normal(size=(bs, 16)).astype(np.float32))}


def _b3_blocks(monkeypatch, kw, train):
    """B3's calls in one forward (and backward in train mode) of a tiny
    GUNet built with ``kw``."""
    calls = []
    real = gunet_mod.modulated_norm_relu

    def counted(x, gamma, s, weight, bias, eps):
        calls.append((gamma is not None, s is not None, weight is not None,
                      bias is not None))
        return real(x, gamma, s, weight, bias, eps)

    monkeypatch.setattr(gunet_mod, "modulated_norm_relu", counted)
    model = build_model("GUNet", model_kwargs=dict(
        _TINY, in_channels=3, context_length=16, **kw), num_classes=3)
    model.reset_parameters(torch.Generator().manual_seed(0))
    out = model(_feats(), train=train,
                generator=torch.Generator().manual_seed(1))
    if train:
        out.square().mean().backward()
        assert all(p.grad is not None for p in model.parameters())
    return calls


_BOTH = dict(use_context=True, use_spatial=True)


@pytest.mark.parametrize("kw,train,want", [
    # GUNet.yml: γ, s and the norm's center, in train and eval mode
    (dict(_BOTH, norm_with_center=True), True, [(1, 1, 0, 1)] * 4),
    (dict(_BOTH, norm_with_center=True), False, [(1, 1, 0, 1)] * 4),
    # GUNet_SP.yml's scale; GUNet_BOTH.yml's bare norm
    (dict(_BOTH, norm_with_scale=True), True, [(1, 1, 1, 0)] * 4),
    (dict(_BOTH), True, [(1, 1, 0, 0)] * 4),
    # context only (GUNet_DE's launcher), spatial only, spatial with --fix
    (dict(use_context=True, norm_with_center=True), True,
     [(1, 0, 0, 1)] * 4),
    (dict(use_spatial=True), True, [(0, 1, 0, 0)] * 4),
    (dict(use_spatial=True, fix=True), True, [(0, 1, 0, 0)] * 4),
    # dropout sits after the first norm of a level in train mode only
    (dict(_BOTH, dropout=0.5), True, [(1, 1, 0, 0)] * 2),
    (dict(_BOTH, dropout=0.5), False, [(1, 1, 0, 0)] * 4),
    # the plain chain: squeeze-excitation, after-affine, batch norm, no
    # norm
    (dict(_BOTH, use_se=True), True, []),
    (dict(_BOTH, after_affine=True), True, []),
    (dict(_BOTH, normalizer="batch_norm"), True, []),
    (dict(_BOTH, without_norm=True), True, []),
])
def test_b3_engages_by_block_structure(monkeypatch, kw, train, want):
    got = _b3_blocks(monkeypatch, kw, train)
    assert got == [tuple(bool(v) for v in w) for w in want]


class _OneRank:
    """A group of one rank: the all-reduce leaves its buffer as it is."""

    def all_reduce_(self, t):
        return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_blocks_take_b3s_split_form(dtype):
    """Under a spatial shard a modulated block is still B3's function, in
    its split form (the plane sums all-reduced over the ranks, the same
    arithmetic rounded once); over one rank it gives the CPU's B3 y bit for
    bit (both take exact float64 plane sums there; tests/
    test_torch_spatial_ops.py holds it at 2 and 3 ranks)."""
    model = build_model("GUNet", model_kwargs=dict(
        _TINY, in_channels=3, context_length=16, **_BOTH), num_classes=3)
    model.spatial = object()
    assert model._b3_block(model.Encode2_conv1_norm, 0, False)
    x, _, s, gamma, w, b = _inputs((2, 12, 10, 3), seed=9, dtype=dtype)
    x, s = _nchw(x, dtype), _nchw(s, dtype)
    gamma, w, b = (torch.from_numpy(t) for t in (gamma, w, b))
    with torch.no_grad():
        want = kernels.modulated_norm_relu(x, gamma, s, w, b)
        got = kernels.modnorm_relu_split(x, gamma, s, w, b, _OneRank())
    assert got.dtype == dtype and torch.equal(got, want)
    with pytest.raises(RuntimeError, match="inference only"):
        kernels.modnorm_relu_split(x.requires_grad_(True), gamma, s, w, b,
                                   _OneRank())


def test_spatial_conv_rows_are_the_whole_conv_split():
    """Conv(x, rows=(lo, hi)): output channels lo:hi of the whole conv, a
    tensor of their own; the weight's gradient through the two halves is
    the whole's."""
    torch.manual_seed(0)
    conv = Conv(1, 8, kernel=1)
    torch.nn.init.normal_(conv.bias)
    x = torch.randn(2, 1, 6, 5)
    whole = conv(x)
    halves = [conv(x, rows=(0, 4)), conv(x, rows=(4, 8))]
    assert [tuple(h.shape) for h in halves] == [(2, 4, 6, 5)] * 2
    assert all(h.is_contiguous() for h in halves)
    torch.testing.assert_close(torch.cat(halves, dim=1), whole, rtol=0,
                               atol=0)
    g = torch.randn_like(whole)
    want = torch.autograd.grad(whole, (conv.weight, conv.bias), g)
    got = torch.autograd.grad(halves, (conv.weight, conv.bias),
                              list(g.split(4, dim=1)))
    for a, ref in zip(got, want):
        torch.testing.assert_close(a, ref, atol=1e-6, rtol=1e-6)
