"""Tests of the port that need an NVIDIA GPU: the CUDA kernels have no CPU
mode.  They import torch and the port only (no JAX), so on the GPU machine
they run without the repo's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Where torch sees no GPU each test skips itself with the reason."""

import numpy as np
import pytest
import torch

from boxsegliver_torch.ops import kernels
from boxsegliver_torch.ops import labeling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _guide_inputs(k, dev, seed=0):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.uniform(-20, 276, (2, k, 2)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(2, 24, (2, k, 2)).astype(np.float32))
    v = torch.from_numpy(rng.random((2, k)) < 0.5)
    return c.to(dev), s.to(dev), v.to(dev)


@pytest.mark.parametrize("k", [0, 1, 20, 48])
def test_b1_matches_plain_and_counts(dev, k):
    c, s, v = _guide_inputs(k, dev, seed=k)
    before = kernels.gaussian_guide_batch.launches
    out = kernels.gaussian_guide_batch(c, s, v, height=256, width=256,
                                       scale=0.425, offset=0.5)
    ref = kernels.gaussian_guide_batch_plain(c, s, v, height=256, width=256,
                                             scale=0.425, offset=0.5)
    torch.cuda.synchronize()
    assert kernels.gaussian_guide_batch.launches == before + 1
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bs,k,h,w,n_valid", [
    (2, 20, 256, 255, None), (3, 7, 1, 256, None), (2, 5, 1, 1, None),
    (1, 70, 40, 37, None), (2, 150, 64, 64, 150), (2, 20, 256, 256, 0)])
def test_b1_odd_shapes_match_plain(dev, bs, k, h, w, n_valid):
    """W not a multiple of 4 (scalar stores), one row, one pixel, several
    chunks of 64 valid objects, and no valid object at all."""
    rng = np.random.default_rng(k + h)
    c = rng.uniform(-20, max(h, w) + 20, (bs, k, 2)).astype(np.float32)
    s = rng.uniform(2, 24, (bs, k, 2)).astype(np.float32)
    v = (rng.random((bs, k)) < 0.5 if n_valid is None
         else np.arange(k)[None].repeat(bs, 0) < n_valid)
    c, s, v = (torch.from_numpy(a).to(dev) for a in (c, s, v))
    out = kernels.gaussian_guide_batch(c, s, v, height=h, width=w,
                                       scale=0.425, offset=0.5)
    ref = kernels.gaussian_guide_batch_plain(c, s, v, height=h, width=w,
                                             scale=0.425, offset=0.5)
    torch.cuda.synchronize()
    assert out.shape == (bs, h, w, 1)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    if n_valid == 0:
        assert bool((out == 0.5).all())


def test_b1_rejects_what_it_does_not_take(dev):
    c, s, v = _guide_inputs(4, dev)
    with pytest.raises(TypeError):
        kernels.gaussian_guide_batch(c.double(), s, v, height=8, width=8)
    strided = c.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gaussian_guide_batch(strided, s, v, height=8, width=8)
    with pytest.raises(ValueError):
        kernels.gaussian_guide_batch(c, s, v.cpu(), height=8, width=8)


def test_labeling_on_the_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    masks = torch.from_numpy(rng.random((3, 96, 80)) < 0.4)
    lab_cpu = labeling.label_components(masks)
    lab_gpu = labeling.label_components(masks.to(dev)).cpu()
    torch.testing.assert_close(lab_gpu, lab_cpu, atol=0, rtol=0)
    seeds, n = labeling.ordered_seeds(lab_cpu, 8)
    obj = lab_cpu[:, None] == seeds[:, :, None, None]
    c_cpu, s_cpu = labeling.object_moments(obj, min_std=2.0)
    c_gpu, s_gpu = labeling.object_moments(obj.to(dev), min_std=2.0)
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, atol=0, rtol=0)
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# kernel B2: fused instance-norm + ReLU, forward and backward
# ---------------------------------------------------------------------------

def _in_relu_inputs(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = torch.from_numpy(rng.normal(0.3, 2.0, shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(1.0, 0.3, c).astype(np.float32))
    b = torch.from_numpy(rng.normal(0.0, 0.3, c).astype(np.float32))
    return (x.to(dev, dtype), g.to(dev, dtype), w.to(dev), b.to(dev))


# f32 planes: 1-2 ulp of rsqrt and another summation order of the per-plane
# sums; bf16 outputs: one bf16 rounding step (2^-8 relative) of values near 4
_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=3e-2, rtol=1e-2)}


@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 16, 16), torch.float32), ((1, 1, 7, 9), torch.float32),
    ((3, 5, 13, 11), torch.float32), ((2, 16, 64, 64), torch.bfloat16),
    ((1, 3, 5, 7), torch.bfloat16)])
def test_b2_matches_plain_and_counts(dev, shape, dtype):
    x, g, w, b = _in_relu_inputs(shape, dtype, dev)
    n0 = [kernels.in_relu_fwd.launches, kernels.in_relu_bwd_stats.launches,
          kernels.in_relu_bwd_apply.launches]
    y, xh, rstd = kernels.in_relu_fwd(x, w, b)
    y_p, xh_p, rstd_p = kernels.in_relu_fwd_plain(x, w, b)
    s1, s2 = kernels.in_relu_bwd_stats(g, xh_p, w, b)
    s1_p, s2_p = kernels.in_relu_bwd_stats_plain(g, xh_p, w, b)
    dx = kernels.in_relu_bwd_apply(g, xh_p, w, b, rstd_p, s1_p, s2_p)
    dx_p = kernels.in_relu_bwd_apply_plain(g, xh_p, w, b, rstd_p, s1_p, s2_p)
    torch.cuda.synchronize()
    assert [kernels.in_relu_fwd.launches, kernels.in_relu_bwd_stats.launches,
            kernels.in_relu_bwd_apply.launches] == [k + 1 for k in n0]
    assert y.dtype == xh.dtype == dx.dtype == dtype
    assert rstd.dtype == s1.dtype == torch.float32
    tol = _TOL[dtype]
    torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(y.float(), y_p.float(), **tol)
    torch.testing.assert_close(xh.float(), xh_p.float(), **tol)
    hw = shape[2] * shape[3]
    torch.testing.assert_close(s1, s1_p, rtol=1e-4, atol=1e-4 * hw ** 0.5)
    torch.testing.assert_close(s2, s2_p, rtol=1e-4, atol=1e-4 * hw ** 0.5)
    torch.testing.assert_close(dx.float(), dx_p.float(), **tol)


# B2-fwd on each path of its launch plan, one element either side of the
# path boundaries, and at each staged cluster size
_BF, _F = torch.bfloat16, torch.float32
_FWD_PATHS = [
    ((2, 5, 32, 32), _BF, kernels.FWD_WARP),        # 1,024
    ((1, 3, 8, 255), _BF, kernels.FWD_WARP),        # 2,040
    ((1, 3, 8, 256), _BF, kernels.FWD_WARP),        # 2,048: the warp limit
    ((1, 3, 1, 2049), _BF, kernels.FWD_GENERAL),
    ((1, 3, 8, 257), _BF, kernels.FWD_STAGED),      # 2,056
    ((1, 3, 32, 32), _F, kernels.FWD_WARP),         # 1,024
    ((1, 3, 1, 1025), _F, kernels.FWD_GENERAL),
    ((1, 3, 4, 257), _F, kernels.FWD_STAGED),       # 1,028
    ((2, 3, 64, 64), _BF, kernels.FWD_STAGED),      # 8 KiB, one CTA
    ((3, 3, 64, 64), _F, kernels.FWD_STAGED),       # 16 KiB
    ((2, 3, 128, 128), _BF, kernels.FWD_STAGED),    # 32 KiB
    ((1, 3, 128, 256), _BF, kernels.FWD_STAGED),    # 64 KiB, one CTA
    ((1, 3, 128, 258), _BF, kernels.FWD_STAGED),    # cluster 2
    ((2, 3, 256, 256), _BF, kernels.FWD_STAGED),    # cluster 2
    ((1, 2, 256, 256), _F, kernels.FWD_STAGED),     # cluster 4
    ((1, 2, 512, 512), _BF, kernels.FWD_STAGED),    # cluster 8 x 64 KiB
    ((1, 2, 1, 262152), _BF, kernels.FWD_GENERAL),  # over 8 x 64 KiB
    ((1, 2, 512, 512), _F, kernels.FWD_GENERAL)]


@pytest.mark.parametrize("shape,dtype,path", _FWD_PATHS)
def test_b2_fwd_paths_match_plain(dev, shape, dtype, path):
    n, c, h, w = shape
    assert kernels.in_relu_fwd_plan(n * c, h * w, dtype).path == path
    x, _, wt, b = _in_relu_inputs(shape, dtype, dev, seed=h + w)
    y, xh, rstd = kernels.in_relu_fwd(x, wt, b)
    y_p, xh_p, rstd_p = kernels.in_relu_fwd_plain(x, wt, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(y.float(), y_p.float(), **_TOL[dtype])
    torch.testing.assert_close(xh.float(), xh_p.float(), **_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_fwd_unaligned_input(dev, dtype):
    """A contiguous view at an odd element offset takes the general path."""
    x, _, w, b = _in_relu_inputs((2, 4, 32, 32), dtype, dev, seed=5)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    flat[1:] = x.flatten()
    xu = flat[1:].view(x.shape)
    assert xu.is_contiguous() and xu.data_ptr() % 16
    assert kernels.in_relu_fwd_plan(8, 1024, dtype, aligned=False).path \
        == kernels.FWD_GENERAL
    for got, ref in zip(kernels.in_relu_fwd(xu, w, b),
                        kernels.in_relu_fwd_plain(x, w, b)):
        tol = _TOL[dtype] if got.dtype == dtype else dict(rtol=1e-5, atol=0)
        torch.testing.assert_close(got.float(), ref.float(), **tol)


def test_b2_autograd_matches_plain(dev):
    x, g, w, b = _in_relu_inputs((2, 4, 24, 20), torch.float32, dev, seed=3)
    x.requires_grad_(True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    y = kernels.instance_norm_relu(x, w, b)
    dx, dw, db = torch.autograd.grad(y, (x, w, b), g)
    _, xh, rstd = kernels.in_relu_fwd_plain(x.detach(), w.detach(), b.detach())
    dx_p, s1, s2 = kernels.in_relu_bwd_plain(g, xh, w.detach(), b.detach(),
                                             rstd)
    for got, ref in zip((dx, dw, db), (dx_p, s2.sum(dim=0), s1.sum(dim=0))):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_b2_rejects_what_it_does_not_take(dev):
    x, g, w, b = _in_relu_inputs((2, 4, 8, 8), torch.float32, dev)
    with pytest.raises(TypeError):
        kernels.in_relu_fwd(x.half(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.in_relu_fwd(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError):
        kernels.in_relu_fwd(x, w.cpu(), b)
    with pytest.raises(ValueError):
        kernels.in_relu_bwd_stats(g, x.bfloat16(), w, b)


# ---------------------------------------------------------------------------
# the backward on every path of in_relu_bwd_plan: B2f fused warp and fused
# staged (each cluster size), B2a + B2b split; at chip_smoke.b2_check's
# tolerances: dx rounded once to its dtype (float32 1e-5 + 1e-5 relative,
# bf16 2^-7 relative + 1e-5), s1 and s2 float32 sums over the plane (1e-4
# relative + 1e-6 sqrt(hw))
# ---------------------------------------------------------------------------

def _b2_close(got, ref, rel, abs_):
    err = (got.float() - ref.float()).abs()
    bad = err > abs_ + rel * ref.float().abs()
    assert not bool(bad.any()), (int(bad.sum()), float(err.max()))


def _check_bwd(g, xh, w, b, rstd, plan=None):
    """The backward under ``plan`` against in_relu_bwd_plain, twice:
    bit-equal from run to run."""
    dx, s1, s2 = kernels.instance_norm_relu_bwd(g, xh, w, b, rstd, plan)
    dx_p, s1_p, s2_p = kernels.in_relu_bwd_plain(g, xh, w, b, rstd)
    again = kernels.instance_norm_relu_bwd(g, xh, w, b, rstd, plan)
    torch.cuda.synchronize()
    hw = int(np.prod(g.shape[2:]))
    assert dx.dtype == g.dtype and dx.shape == g.shape
    assert s1.dtype == s2.dtype == torch.float32
    rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-5
    _b2_close(dx, dx_p, rel, 1e-5)
    _b2_close(s1, s1_p, 1e-4, 1e-6 * hw ** 0.5)
    _b2_close(s2, s2_p, 1e-4, 1e-6 * hw ** 0.5)
    for a, b_ in zip(again, (dx, s1, s2)):
        assert torch.equal(a, b_)


_W, _S, _X = kernels.FWD_WARP, kernels.FWD_STAGED, kernels.BWD_SPLIT
# (shape, dtype, path, cluster): each fused warp packing, each staged
# cluster size (the 64 KiB target and the 192 KiB fallback), one element
# either side of each boundary, NCDHW planes, and the split path
_BWD_PATHS = [
    ((16, 64, 16, 16), _BF, _W, 1), ((2, 5, 32, 32), _BF, _W, 1),
    ((1, 3, 8, 256), _BF, _W, 1), ((1, 3, 1, 2049), _BF, _X, 1),
    ((1, 3, 8, 257), _BF, _S, 1), ((1, 3, 32, 32), _F, _W, 1),
    ((1, 3, 1, 1025), _F, _X, 1), ((1, 3, 4, 257), _F, _S, 1),
    ((2, 3, 64, 64), _BF, _S, 1), ((1, 3, 128, 128), _BF, _S, 1),
    ((1, 3, 128, 129), _BF, _S, 2), ((2, 3, 256, 256), _BF, _S, 4),
    ((1, 2, 256, 512), _BF, _S, 8), ((1, 2, 256, 256), _F, _S, 8),
    ((1, 2, 10, 128, 128), _BF, _S, 4), ((1, 2, 384, 1024), _BF, _S, 8),
    ((1, 2, 384, 1025), _BF, _X, 1), ((1, 2, 192, 1024), _F, _S, 8),
    ((1, 2, 192, 1025), _F, _X, 1), ((4, 320, 5, 16, 16), _BF, _W, 1),
    ((2, 12, 10, 64, 64), _BF, _S, 4), ((2, 6, 10, 256, 256), _BF, _X, 1),
    ((16, 128, 64, 64), _BF, _S, 1), ((8, 64, 128, 128), _BF, _S, 1),
    ((2, 3, 7, 9), _F, _X, 1), ((1, 4, 5, 3, 33), _BF, _X, 1)]


@pytest.mark.parametrize("shape,dtype,path,cluster", _BWD_PATHS)
def test_b2_bwd_paths_match_plain(dev, shape, dtype, path, cluster):
    n, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    plan = kernels.in_relu_bwd_plan(n * c, hw, dtype)
    assert (plan.path, plan.cluster) == (path, cluster)
    _, g, w, b = _in_relu_inputs(shape, dtype, dev, seed=hw % 97)
    x, _, _, _ = _in_relu_inputs(shape, dtype, dev, seed=hw % 89)
    _, xh, rstd = kernels.in_relu_fwd_plain(x, w, b)
    n0 = {k: kernels.KERNELS[k].launches
          for k in ("in_relu_bwd", "in_relu_bwd_stats", "in_relu_bwd_apply")}
    dx, _, _ = kernels.instance_norm_relu_bwd(g, xh, w, b, rstd)
    fused = int(path != _X)
    assert {k: kernels.KERNELS[k].launches - v for k, v in n0.items()} == {
        "in_relu_bwd": fused, "in_relu_bwd_stats": 1 - fused,
        "in_relu_bwd_apply": 1 - fused}
    _check_bwd(g, xh, w, b, rstd)
    # the split plan and the first design (one CTA a plane) at every shape
    for spread in (True, False):
        _check_bwd(g, xh, w, b, rstd, kernels.in_relu_bwd_split_plan(
            n * c, hw, dtype, True, spread))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_bwd_unaligned_takes_the_split_path(dev, dtype):
    """g at an odd element offset: B2a and B2b on single elements."""
    x, g, w, b = _in_relu_inputs((2, 4, 32, 32), dtype, dev, seed=6)
    _, xh, rstd = kernels.in_relu_fwd_plain(x, w, b)
    flat = torch.empty(g.numel() + 1, dtype=dtype, device=dev)
    flat[1:] = g.flatten()
    gu = flat[1:].view(g.shape)
    assert gu.is_contiguous() and gu.data_ptr() % 16
    n0 = kernels.in_relu_bwd_stats.launches
    got = kernels.instance_norm_relu_bwd(gu, xh, w, b, rstd)
    assert kernels.in_relu_bwd_stats.launches == n0 + 1
    want = kernels.in_relu_bwd_plain(g, xh, w, b, rstd)
    for a, ref in zip(got, want):
        rel = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4
        _b2_close(a, ref, rel, 1e-3)
    _check_bwd(gu, xh, w, b, rstd)


def test_b2_bwd_refuses_a_plan_that_does_not_fit(dev):
    """The C launcher refuses, the wrapper raises: B2f under a split plan,
    a warp plan with too few packs, a staged plan whose shared memory does
    not match the chunk; B2a under splits that do not cover the plane."""
    x, g, w, b = _in_relu_inputs((2, 3, 64, 64), torch.bfloat16, dev)
    _, xh, rstd = kernels.in_relu_fwd_plain(x, w, b)
    plan = kernels.in_relu_bwd_plan(6, 4096, torch.bfloat16)
    bad = [kernels.in_relu_bwd_split_plan(6, 4096, torch.bfloat16),
           plan._replace(path=kernels.FWD_WARP, packs=1),
           plan._replace(smem_bytes=plan.smem_bytes // 2),
           plan._replace(cluster=3, smem_bytes=plan.smem_bytes // 3)]
    for p in bad:
        with pytest.raises(RuntimeError, match="in_relu_bwd launch failed"):
            kernels.in_relu_bwd(g, xh, w, b, rstd, p)
    split = kernels.in_relu_bwd_split_plan(6, 4096, torch.bfloat16)
    with pytest.raises(RuntimeError, match="in_relu_bwd_stats launch failed"):
        kernels.in_relu_bwd_stats(g, xh, w, b, split._replace(chunk=8))
    with pytest.raises(RuntimeError, match="in_relu_bwd_apply launch failed"):
        kernels.in_relu_bwd_apply(g, xh, w, b, rstd, rstd, rstd,
                                  split._replace(apply_ctas=0))


# ---------------------------------------------------------------------------
# kernel B3: G-Net's modulated block, norm -> * gamma -> + s -> ReLU, against
# its plain version at B2's tolerances (y, x_hat and dx rounded once to
# their dtype; a and b float32 plane sums in another order); ds is g_m, a
# masked copy of g, and must be equal
# ---------------------------------------------------------------------------

def _b3_inputs(shape, dtype, dev, seed=0, gamma=True, s=True, weight=False,
               bias=True):
    """x, g and the optional operands of B3; s is the first channel half
    of a [N, 2C, *S] tensor, as GUNet's spatial conv gives it with --fix."""
    rng = np.random.default_rng(seed)
    n, c = shape[:2]
    x, g, w, b = _in_relu_inputs(shape, dtype, dev, seed)
    gm = torch.from_numpy(rng.normal(1.0, 0.5, (n, c)).astype(np.float32))
    wide = (n, 2 * c) + tuple(shape[2:])
    sp = torch.from_numpy(rng.normal(0.0, 1.0, wide).astype(np.float32))
    return (x, g, gm.to(dev) if gamma else None,
            sp.to(dev, dtype)[:, :c] if s else None,
            w if weight else None, b if bias else None)


def _check_b3(x, g, gamma, s, w, b, fwd_plan=None, bwd_plan=None):
    """B3-fwd and B3-bwd against their plain versions, and the backward
    twice: bit-equal from run to run."""
    n0 = {k: kernels.KERNELS[k].launches
          for k in ("modnorm_relu_fwd", "modnorm_relu_bwd")}
    y, xh, rstd = kernels.modnorm_relu_fwd(x, gamma, s, w, b)
    y_p, xh_p, rstd_p = kernels.modnorm_relu_fwd_plain(x, gamma, s, w, b)
    bwd = kernels.modnorm_relu_bwd(g, y_p, xh_p, rstd_p, gamma, w,
                                   plan=bwd_plan)
    again = kernels.modnorm_relu_bwd(g, y_p, xh_p, rstd_p, gamma, w,
                                     plan=bwd_plan)
    ref = kernels.modnorm_relu_bwd_plain(g, y_p, xh_p, rstd_p, gamma, w)
    torch.cuda.synchronize()
    assert {k: kernels.KERNELS[k].launches - v for k, v in n0.items()} == {
        "modnorm_relu_fwd": 1, "modnorm_relu_bwd": 2}
    dtype = x.dtype
    assert y.dtype == xh.dtype == bwd[0].dtype == bwd[1].dtype == dtype
    torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(y.float(), y_p.float(), **_TOL[dtype])
    torch.testing.assert_close(xh.float(), xh_p.float(), **_TOL[dtype])
    hw = int(np.prod(x.shape[2:]))
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    _b2_close(bwd[0], ref[0], rel, 1e-5)
    assert torch.equal(bwd[1], ref[1])
    for got, want in zip(bwd[2:], ref[2:]):
        _b2_close(got, want, 1e-4, 1e-6 * hw ** 0.5)
    for a, b_ in zip(again, bwd):
        assert torch.equal(a, b_)


# GUNet.yml's four modulated levels at batch 8 (the flagship's train step
# and the guided sweep's forward: 2 sweeps x 4 mirrors), bf16
B3_LEVELS = [(8, 128, 128, 128), (8, 256, 64, 64), (8, 512, 32, 32),
             (8, 1024, 16, 16)]


@pytest.mark.parametrize("shape", B3_LEVELS)
def test_b3_at_the_flagship_levels_matches_plain(dev, shape):
    """GUNet.yml's block (context γ, spatial s, center only), then s as a
    tensor of its own (the spatial conv's half for each block)."""
    ops = _b3_inputs(shape, torch.bfloat16, dev, seed=shape[1])
    _check_b3(*ops)
    x, g, gamma, s, w, b = ops
    _check_b3(x, g, gamma, s.contiguous(), w, b)


@pytest.mark.parametrize("gamma,s,weight,bias", [
    (True, True, True, True), (True, False, False, True),
    (False, True, True, False), (False, False, False, False),
    (True, True, True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_optional_operands_match_plain(dev, gamma, s, weight, bias,
                                          dtype):
    _check_b3(*_b3_inputs((3, 16, 32, 32), dtype, dev, seed=11, gamma=gamma,
                          s=s, weight=weight, bias=bias))


# B3-fwd on each path of in_relu_fwd_plan and B3-bwd on each of
# in_relu_bwd_plan, one element either side of the boundaries
_B3_PATHS = [
    ((1, 3, 8, 256), _BF, _W, _W), ((1, 3, 8, 257), _BF, _S, _S),
    ((1, 3, 1, 2049), _BF, kernels.FWD_GENERAL, _X),
    ((1, 3, 32, 32), _F, _W, _W), ((1, 3, 4, 257), _F, _S, _S),
    ((1, 3, 1, 1025), _F, kernels.FWD_GENERAL, _X),
    ((1, 3, 128, 258), _BF, _S, _S), ((2, 3, 256, 256), _BF, _S, _S),
    ((1, 2, 512, 512), _BF, _S, _S), ((1, 2, 256, 256), _F, _S, _S),
    ((1, 2, 384, 1025), _BF, kernels.FWD_GENERAL, _X),
    ((1, 2, 512, 512), _F, kernels.FWD_GENERAL, _X),
    ((2, 3, 7, 9), _F, kernels.FWD_GENERAL, _X),
    ((1, 4, 5, 3, 33), _BF, kernels.FWD_GENERAL, _X)]


@pytest.mark.parametrize("shape,dtype,fwd,bwd", _B3_PATHS)
def test_b3_paths_match_plain(dev, shape, dtype, fwd, bwd):
    n, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    assert kernels.in_relu_fwd_plan(n * c, hw, dtype).path == fwd
    assert kernels.in_relu_bwd_plan(n * c, hw, dtype).path == bwd
    ops = _b3_inputs(shape, dtype, dev, seed=hw % 89, weight=True)
    _check_b3(*ops)
    # the split plan, and the first design (one CTA a plane), everywhere
    for spread in (True, False):
        _check_b3(*ops, bwd_plan=kernels.in_relu_bwd_split_plan(
            n * c, hw, dtype, True, spread))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_unaligned_operands(dev, dtype):
    """x and g at an odd element offset: the general forward and the split
    backward on single elements."""
    x, g, gamma, s, w, b = _b3_inputs((2, 4, 32, 32), dtype, dev, seed=4)

    def odd(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    xu, gu = odd(x), odd(g)
    assert xu.is_contiguous() and xu.data_ptr() % 16
    _check_b3(xu, gu, gamma, s, w, b)


def test_b3_no_grad_writes_y_alone(dev):
    """Under no-grad (the sweep's forward) B3-fwd writes only y, equal to
    the training forward's; modulated_norm_relu takes that form."""
    x, _, gamma, s, w, b = _b3_inputs((8, 256, 64, 64), torch.bfloat16, dev)
    gamma = gamma.bfloat16().float()        # the context's values, in bf16
    y, xh, rstd = kernels.modnorm_relu_fwd(x, gamma, s, w, b, train=False)
    y_t, _, _ = kernels.modnorm_relu_fwd(x, gamma, s, w, b)
    assert xh.numel() == rstd.numel() == 0
    assert torch.equal(y, y_t)
    n0 = kernels.modnorm_relu_fwd.launches
    with torch.no_grad():
        y_m = kernels.modulated_norm_relu(x, gamma.bfloat16(), s, None, b)
    assert kernels.modnorm_relu_fwd.launches == n0 + 1
    assert torch.equal(y_m, y)


def test_b3_autograd_matches_plain(dev):
    """ModulatedNormReLU on the card against the CPU's (plain) Function:
    dx, dγ, ds, dw, db, float32."""
    ops = _b3_inputs((2, 8, 24, 20), torch.float32, dev, seed=3, weight=True)
    x, g = ops[0], ops[1]
    leaves = [t.detach().clone().requires_grad_(True) for t in
              (x, ops[2], ops[3].contiguous(), ops[4], ops[5])]
    y = kernels.modulated_norm_relu(*leaves)
    got = torch.autograd.grad(y, leaves, g)
    cpu = [t.detach().cpu().requires_grad_(True) for t in leaves]
    ref = torch.autograd.grad(kernels.modulated_norm_relu(*cpu), cpu,
                              g.cpu())
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.cpu(), r, atol=1e-4, rtol=1e-4)


def test_b3_refuses_what_it_does_not_take(dev):
    x, g, gamma, s, w, b = _b3_inputs((2, 4, 8, 8), torch.float32, dev)
    y, xh, rstd = kernels.modnorm_relu_fwd_plain(x, gamma, s, w, b)
    with pytest.raises(TypeError):
        kernels.modnorm_relu_fwd(x.half(), gamma, None, w, b)
    with pytest.raises(ValueError):
        kernels.modnorm_relu_fwd(x, gamma.t().contiguous(), s, w, b)
    with pytest.raises(ValueError):
        kernels.modnorm_relu_fwd(x, gamma, s.bfloat16(), w, b)
    plan = kernels.in_relu_bwd_plan(8, 64, torch.float32)
    with pytest.raises(RuntimeError, match="modnorm_relu_bwd launch failed"):
        kernels.modnorm_relu_bwd(g, y, xh, rstd, gamma, w,
                                 plan=plan._replace(packs=0))


def test_gunet_yml_step_launches_b3_per_modulated_block(dev):
    """GUNet.yml (bf16, 64^2, batch 2): a train step launches B3-fwd and
    B3-bwd once for each of its 8 modulated blocks and B2 for its 10 other
    norm + ReLU pairs; a no-grad forward (the sweep's) B3-fwd 8 times."""
    from boxsegliver_torch.models import MODEL_CONFIGS, build_model

    model = build_model("GUNet", model_kwargs=dict(
        MODEL_CONFIGS["GUNet.yml"], use_context=True, use_spatial=True,
        normalizer="instance_norm", in_channels=3, context_length=200),
        num_classes=3, dtype=torch.bfloat16)
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(0)
    feats = {"images": rng.normal(size=(2, 64, 64, 3)),
             "sp_guide": rng.uniform(0.5, 1.0, (2, 64, 64, 1)),
             "context": rng.normal(size=(2, 200))}
    feats = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
             for k, v in feats.items()}
    kernels.reset_launch_counts()
    model(feats, train=True).square().mean().backward()
    torch.cuda.synchronize()
    counts = {n: f.launches for n, f in kernels.KERNELS.items()}
    # GUNet's activations are channels-last: B2 and B3 on their NHWC plans
    assert (counts["modnorm_relu_fwd_nhwc"] == counts["modnorm_relu_bwd_nhwc"]
            == 8)
    assert counts["in_relu_fwd_nhwc"] == counts["in_relu_bwd_nhwc"] == 10
    assert not any(counts[k] for k in (
        "in_relu_fwd", "in_relu_bwd", "in_relu_bwd_stats", "in_relu_bwd_apply",
        "modnorm_relu_fwd", "modnorm_relu_bwd"))
    # the biases of the 8 spatial half convs, 4 transpose convs and the
    # head take their gradients from the channel sums
    assert kernels.channel_sums_nhwc.launches == 13
    grads = [p.grad for p in model.parameters()]
    assert all(g_ is not None and bool(torch.isfinite(g_).all())
               for g_ in grads)
    kernels.reset_launch_counts()
    with torch.no_grad():
        model(feats)
    assert kernels.modnorm_relu_fwd_nhwc.launches == 8
    assert kernels.in_relu_fwd_nhwc.launches == 10
    assert kernels.modnorm_relu_bwd_nhwc.launches == 0
    assert kernels.modnorm_relu_fwd.launches == kernels.in_relu_fwd.launches \
        == 0


# ---------------------------------------------------------------------------
# B2 and B3 on their NHWC plans (channels-last operands, GUNet's), against
# the plain versions at the tolerances above, equal from run to run, and
# within one bf16 rounding of the NCHW plans on the same data
# ---------------------------------------------------------------------------

def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _is_cl(t):
    return t.is_contiguous(memory_format=torch.channels_last)


# G-Net's five levels at batch 8 (GUNet.yml, 256^2, bf16), and ragged
# shapes: rows that no CTA's row groups divide, one sample, 8 channels, a
# tile of 8 channels (24), channels that take one element a thread (30, 3)
NHWC_LEVELS = [(8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64),
               (8, 512, 32, 32), (8, 1024, 16, 16)]
NHWC_SHAPES = ([(s, _BF) for s in NHWC_LEVELS]
               + [((2, 64, 13, 11), _BF), ((1, 128, 33, 31), _BF),
                  ((3, 8, 17, 9), _BF), ((2, 24, 5, 7), _BF),
                  ((2, 30, 9, 10), _BF), ((2, 64, 13, 11), _F),
                  ((1, 3, 16, 16), _F)])


def _nhwc_plans(shape, dtype, arrays, grad=False):
    """The default plan, and the split plan where the default is staged."""
    n, c, h, w = shape
    plans = [None]
    if kernels.in_relu_nhwc_plan(n, c, h * w, dtype, True, arrays,
                                 grad).path == kernels.NHWC_STAGED:
        plans.append(kernels.in_relu_nhwc_split_plan(n, c, h * w, dtype,
                                                     True, grad))
    return plans


def _nhwc_counts():
    return {k: f.launches for k, f in kernels.KERNELS.items()}


@pytest.mark.parametrize("shape,dtype", NHWC_SHAPES)
def test_b2_nhwc_matches_plain(dev, shape, dtype):
    """y, the planes' mean and rstd against the plain version's; the
    backward (x̂ taken from x again, in float32, with the forward's
    statistics) against the plain backward on that x̂."""
    x, g, w, b = _in_relu_inputs(shape, dtype, dev, seed=shape[1])
    y_p, mean_p, rstd_p = kernels.in_relu_fwd_nhwc_plain(x, w, b)
    y_nchw = kernels.in_relu_fwd(x, w, b)[0]
    hw = shape[2] * shape[3]
    tol = _TOL[dtype]
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for fp, bp in zip(_nhwc_plans(shape, dtype, 1),
                      _nhwc_plans(shape, dtype, 2, True)):
        before = _nhwc_counts()
        fwd = [kernels.in_relu_fwd_nhwc(_cl(x), w, b, plan=fp)
               for _ in range(2)]
        y, mean, rstd = fwd[0]
        xh = kernels._xhat(x, mean, rstd)
        dx_p, s1_p, s2_p = kernels.in_relu_bwd_plain(g, xh, w, b, rstd)
        bwd = [kernels.in_relu_bwd_nhwc(_cl(g), _cl(x), mean, w, b, rstd,
                                        plan=bp) for _ in range(2)]
        torch.cuda.synchronize()
        after = _nhwc_counts()
        assert {k: after[k] - before[k] for k in after if after[k] > before[k]
                } == {"in_relu_fwd_nhwc": 2, "in_relu_bwd_nhwc": 2}
        dx, s1, s2 = bwd[0]
        assert _is_cl(y) and _is_cl(dx)
        torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
        torch.testing.assert_close(mean, mean_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(y.float(), y_p.float(), **tol)
        _b2_close(dx, dx_p, rel, 1e-5)
        for got, want in ((s1, s1_p), (s2, s2_p)):
            _b2_close(got, want, 1e-4, 1e-6 * hw ** 0.5)
        for one, two in zip(fwd[0] + bwd[0], fwd[1] + bwd[1]):
            assert torch.equal(one, two)
        torch.testing.assert_close(y.float(), y_nchw.float(), **tol)


@pytest.mark.parametrize("shape,dtype", NHWC_SHAPES)
def test_b3_nhwc_matches_plain(dev, shape, dtype):
    """GUNet.yml's block (context γ, spatial s, center) with s the first
    channel half of a channels-last tensor, read in place; the backward
    against the plain one on the x̂ the forward's statistics give."""
    x, g, gamma, s, w, b = _b3_inputs(shape, dtype, dev, seed=shape[1])
    c = shape[1]
    s_cl = _cl(torch.cat([s, torch.zeros_like(s)], dim=1))[:, :c]
    y_p, mean_p, rstd_p = kernels.modnorm_relu_fwd_nhwc_plain(x, gamma, s, w,
                                                              b)
    y_nchw = kernels.modnorm_relu_fwd(x, gamma, s, w, b)[0]
    hw = shape[2] * shape[3]
    tol = _TOL[dtype]
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for fp, bp in zip(_nhwc_plans(shape, dtype, 2),
                      _nhwc_plans(shape, dtype, 3, True)):
        before = _nhwc_counts()
        fwd = [kernels.modnorm_relu_fwd_nhwc(_cl(x), gamma, s_cl, w, b,
                                             plan=fp) for _ in range(2)]
        y_ng = kernels.modnorm_relu_fwd_nhwc(_cl(x), gamma, s_cl, w, b,
                                             train=False, plan=fp)[0]
        y, mean, rstd = fwd[0]
        xh = kernels._xhat(x, mean, rstd)
        ref = kernels.modnorm_relu_bwd_plain(g, y, xh, rstd, gamma, w)
        bwd = [kernels.modnorm_relu_bwd_nhwc(_cl(g), y, _cl(x), mean, rstd,
                                             gamma, w, plan=bp)
               for _ in range(2)]
        torch.cuda.synchronize()
        after = _nhwc_counts()
        assert {k: after[k] - before[k] for k in after if after[k] > before[k]
                } == {"modnorm_relu_fwd_nhwc": 3, "modnorm_relu_bwd_nhwc": 2}
        dx, ds, a, b_ = bwd[0]
        assert _is_cl(y) and _is_cl(dx) and _is_cl(ds)
        torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
        torch.testing.assert_close(mean, mean_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(y.float(), y_p.float(), **tol)
        assert torch.equal(y_ng, y)
        _b2_close(dx, ref[0], rel, 1e-5)
        assert torch.equal(ds, ref[1])
        for got, want in ((a, ref[2]), (b_, ref[3])):
            _b2_close(got, want, 1e-4, 1e-6 * hw ** 0.5)
        for one, two in zip(fwd[0] + bwd[0], fwd[1] + bwd[1]):
            assert torch.equal(one, two)
        torch.testing.assert_close(y.float(), y_nchw.float(), **tol)


@pytest.mark.parametrize("shape,dtype", [
    ((8, 128, 128, 128), _BF), ((8, 64, 256, 256), _BF),
    ((8, 3, 256, 256), _BF), ((8, 1024, 16, 16), _BF), ((2, 30, 9, 10), _BF),
    ((3, 24, 7, 5), _F)])
def test_channel_sums_nhwc_matches_plain(dev, shape, dtype):
    """A conv bias's gradient from a channels-last one: the channel sums
    against PyTorch's float32 sum, equal from run to run."""
    g = _cl(torch.randn(shape, device=dev).to(dtype))
    n0 = kernels.channel_sums_nhwc.launches
    got = kernels.channel_sums_nhwc(g)
    again = kernels.channel_sums_nhwc(g)
    want = g.float().sum(dim=(0, 2, 3))
    torch.cuda.synchronize()
    assert kernels.channel_sums_nhwc.launches == n0 + 2
    rows = g.numel() // g.shape[1]
    _b2_close(got, want, 1e-4, 1e-5 * rows ** 0.5)
    assert torch.equal(got, again)


def test_b2_and_b3_take_the_plan_of_their_layout(dev):
    """The strides choose: contiguous x takes the NCHW plans, channels-last
    x the NHWC ones (autograd through both agrees), anything else raises."""
    x, g, w, b = _in_relu_inputs((2, 16, 24, 20), torch.float32, dev, seed=4)
    grads = []
    for inp, name in ((x, "in_relu_fwd"), (_cl(x), "in_relu_fwd_nhwc")):
        before = _nhwc_counts()
        leaf = inp.detach().requires_grad_(True)
        out = kernels.instance_norm_relu(leaf, w, b)
        grads.append(torch.autograd.grad(out, leaf, _cl(g))[0])
        after = _nhwc_counts()
        assert after[name] == before[name] + 1
        assert _is_cl(out) == (name == "in_relu_fwd_nhwc")
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)
    gamma = torch.ones((2, 16), device=dev)
    for fn in (lambda t: kernels.in_relu_fwd(t, w, b),
               lambda t: kernels.modnorm_relu_fwd(t, gamma)):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(2, 3))
    with pytest.raises(ValueError, match="one layout"):
        ones = torch.ones((2, 16), device=dev)
        kernels.in_relu_bwd_nhwc(_cl(g), x, ones, w, b, ones)


# ---------------------------------------------------------------------------
# --steps_per_dispatch K > 1: the train step captured in a CUDA graph
# ---------------------------------------------------------------------------

def _graph_trainers(tmp_path, k, *extra):
    """A tiny G-Net trainer on a synthetic set at 64^2, float32 (TF32 off),
    batch 2, and its raw batches; ``k`` steps a dispatch."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.config import resolve_device
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    ds = tmp_path / "ds"
    if not (ds / "meta.json").exists():
        make_synthetic_dataset(ds, n_cases=4, shape=(8, 64, 64), k_split=2,
                               seed=1)
    argv = ["liver", "--mode", "train", "--tag", "t", "--model", "GUNet",
            "--model_config", "GUNet_TINY.yml", "--classes", "Liver",
            "Tumor", "--k_folds", "2", "--test_fold", "0", "--im_height",
            "64", "--im_width", "64", "--normalizer", "instance_norm",
            "--use_context", "--context_list", "hist", "200",
            "--use_spatial", "--min_std", "2", "--batch_size", "2",
            "--compute_dtype", "float32", "--log_step", "2",
            "--data_root", str(tmp_path), "--dataset", "ds",
            "--model_dir", str(tmp_path / f"md{k}"),
            "--steps_per_dispatch", str(k)] + list(extra)
    args = cli.get_args(argv)
    trainer = cli.build_trainer(args, resolve_device("cuda"))
    sampler = TrainSampler(ds, args, seed=3)
    rng = np.random.RandomState(3)
    return trainer, [sampler.sample_batch(2, rng=rng) for _ in range(12)]


def _run(trainer, batches, k):
    out = []
    for i in range(0, len(batches), k):
        out += trainer.train_multi_step(batches[i:i + k])
    return torch.stack([v for _, v, _ in out]).cpu()


def test_graphed_steps_match_eager_steps(dev, tmp_path):
    """Noise, flips and dropout off: 12 steps as 3 dispatches of 4 (3 eager
    warm-up steps, then replays of the two captured variants) against 12
    eager K = 1 steps; loss per step within 1e-4 relative, the parameters
    within 1e-4 in relative L2 norm over all tensors together.  Two eager
    float32 runs of this model on the card are not bit-equal either (its
    float32 reductions may sum in another order from run to run, and Adam
    turns a gradient within round-off of 0 into ±lr): small bias vectors
    differ by up to 2e-3 of their own norm between two eager runs, and by
    as much between a graphed and an eager run.  Each replay adds its
    captured launches of B1, B2 and B3 to their counters: B3-fwd and
    B3-bwd once for each of GUNet_TINY's 4 modulated blocks, B2 for its 6
    other norm + ReLU pairs, all on the NHWC plans (GUNet's activations are
    channels-last)."""
    quiet = ("--noise_scale", "0", "--random_flip", "0", "--side_dropout",
             "0")
    graphed, batches = _graph_trainers(tmp_path, 4, *quiet)
    eager, _ = _graph_trainers(tmp_path, 1, *quiet)
    kernels.reset_launch_counts()
    vals_g = _run(graphed, batches, 4)
    counts = {n: fn.launches for n, fn in kernels.KERNELS.items()}
    vals_e = _run(eager, batches, 1)
    assert len(graphed._graphs) == 2            # metric / no-metric variant
    for n in ("gaussian_guide_batch", "in_relu_fwd_nhwc", "in_relu_bwd_nhwc",
              "modnorm_relu_fwd_nhwc", "modnorm_relu_bwd_nhwc"):
        assert counts[n] > 0 and counts[n] * 2 == kernels.KERNELS[n].launches
        per = {m: c[n] for m, (_, c) in graphed._graphs.items()}
        assert per[True] == per[False] > 0
    assert counts["in_relu_bwd_nhwc"] == counts["in_relu_fwd_nhwc"]
    assert counts["modnorm_relu_fwd_nhwc"] == counts["modnorm_relu_bwd_nhwc"]
    assert (counts["modnorm_relu_fwd_nhwc"] * 6
            == counts["in_relu_fwd_nhwc"] * 4)
    for n in ("in_relu_fwd", "in_relu_bwd", "in_relu_bwd_stats",
              "in_relu_bwd_apply", "modnorm_relu_fwd", "modnorm_relu_bwd"):
        assert kernels.KERNELS[n].launches == 0
    torch.testing.assert_close(vals_g[:, :2], vals_e[:, :2], rtol=1e-4,
                               atol=0)
    pe = eager.model.state_dict()
    pg = graphed.model.state_dict()
    err = torch.cat([(pg[k] - v).flatten() for k, v in pe.items()]).norm()
    ref = torch.cat([v.flatten() for v in pe.values()]).norm()
    assert float(err) <= 1e-4 * float(ref), (float(err), float(ref))


def test_graphed_generator_advances(dev, tmp_path):
    """With noise, flips and dropout on, each replay draws new numbers from
    the registered generator: its state moves with every dispatch, and the
    checkpointed state is the one a resume continues from."""
    graphed, batches = _graph_trainers(tmp_path, 4)
    _run(graphed, batches[:8], 4)               # warm-up, capture, replays
    s0 = graphed.generator.get_state().clone()
    _run(graphed, batches[8:], 4)
    s1 = graphed.generator.get_state()
    assert not torch.equal(s0, s1)
    assert torch.equal(graphed.state()["generator"], s1)


# ---------------------------------------------------------------------------
# the NF slice: B1 and B2 at the nf / nf_inter shapes, the inter step graphed
# ---------------------------------------------------------------------------

def test_b1_at_the_click_guide_shape_matches_plain(dev):
    """The nf_inter train step's one launch: fg and bg click guides of a
    batch of 16 as 32 rows, K = --max_clicks 8, a valid prefix, stddev
    --stddev / rescale per row and axis, no epilogue."""
    rng = np.random.default_rng(19)
    n = rng.integers(0, 9, 32)
    c = torch.from_numpy(rng.uniform(0, 256, (32, 8, 2)).astype(np.float32))
    rescale = rng.uniform(1.0, 1.4, (32, 1, 2)).astype(np.float32)
    s = torch.from_numpy(np.broadcast_to(5.0 / rescale, (32, 8, 2)).copy())
    v = torch.from_numpy(np.arange(8)[None] < n[:, None])
    c, s, v = c.to(dev), s.to(dev), v.to(dev)
    before = kernels.gaussian_guide_batch.launches
    out = kernels.gaussian_guide_batch(c, s, v, height=256, width=256)
    ref = kernels.gaussian_guide_batch_plain(c, s, v, height=256, width=256)
    torch.cuda.synchronize()
    assert kernels.gaussian_guide_batch.launches == before + 1
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    assert bool((out[torch.from_numpy(n == 0).to(dev)] == 0).all())


# the five levels of UNet.yml / UNetInter.yml at batch 16 (bf16)
NF_B2_SHAPES = [(16, 64, 256, 256), (16, 128, 128, 128), (16, 256, 64, 64),
                (16, 512, 32, 32), (16, 1024, 16, 16)]


@pytest.mark.parametrize("shape", NF_B2_SHAPES)
def test_b2_at_the_nf_levels_matches_plain(dev, shape):
    x, g, w, b = _in_relu_inputs(shape, torch.bfloat16, dev)
    y, xh, rstd = kernels.in_relu_fwd(x, w, b)
    y_p, xh_p, rstd_p = kernels.in_relu_fwd_plain(x, w, b)
    s1, s2 = kernels.in_relu_bwd_stats(g, xh_p, w, b)
    s1_p, s2_p = kernels.in_relu_bwd_stats_plain(g, xh_p, w, b)
    dx = kernels.in_relu_bwd_apply(g, xh_p, w, b, rstd_p, s1_p, s2_p)
    dx_p = kernels.in_relu_bwd_apply_plain(g, xh_p, w, b, rstd_p, s1_p, s2_p)
    torch.cuda.synchronize()
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(y.float(), y_p.float(), **tol)
    torch.testing.assert_close(xh.float(), xh_p.float(), **tol)
    hw = shape[2] * shape[3]
    torch.testing.assert_close(s1, s1_p, rtol=1e-4, atol=1e-4 * hw ** 0.5)
    torch.testing.assert_close(s2, s2_p, rtol=1e-4, atol=1e-4 * hw ** 0.5)
    torch.testing.assert_close(dx.float(), dx_p.float(), **tol)


def test_inter_steps_graphed_match_eager(dev, tmp_path):
    """nf_inter (UNetInter_TINY, --local_enhance, float32, TF32 off,
    flips, noise and gamma off): 8 steps as 2 dispatches of 4 against 8
    eager steps; each replay launches B1 once (the click guides) and B2 per
    block (its NHWC plans: the model keeps the channels-last view of its
    input permute), and the losses agree within 1e-4 relative.  With gamma, noise
    and flips on (the 101_unetinter_v10.sh pipeline) the graphed steps run
    and stay finite."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.config import resolve_device
    from boxsegliver_torch.data.sampler_inter import InterSampler
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    ds = tmp_path / "nf"
    make_synthetic_dataset(ds, n_cases=4, shape=(8, 64, 64), k_split=2,
                           modality="nf", seed=1)

    def trainer(k, *extra):
        args = cli.get_args([
            "nf_inter", "--mode", "train", "--tag", "t", "--model",
            "UNetInter", "--model_config", "UNetInter_TINY.yml",
            "--classes", "NF", "--k_folds", "2", "--test_fold", "0",
            "--im_height", "64", "--im_width", "64", "--normalizer",
            "instance_norm", "--use_spatial", "--local_enhance", "--stddev",
            "5", "--batch_size", "2", "--compute_dtype", "float32",
            "--loss_weight_type", "numerical", "--loss_numeric_w", "1", "1",
            "--log_step", "2", "--data_root", str(tmp_path), "--dataset",
            "nf", "--model_dir", str(tmp_path / f"md{k}{len(extra)}"),
            "--steps_per_dispatch", str(k)] + list(extra))
        return args, cli.build_trainer(args, resolve_device("cuda"))

    quiet = ("--noise_scale", "0", "--random_flip", "0", "--no_gamma")
    args, graphed = trainer(4, *quiet)
    _, eager = trainer(1, *quiet)
    sampler = InterSampler(ds, args, seed=3)
    rng = np.random.RandomState(3)
    batches = [sampler.sample_batch(2, rng=rng) for _ in range(8)]
    kernels.reset_launch_counts()
    vals_g = _run(graphed, batches, 4)
    vals_e = _run(eager, batches, 1)
    per = {m: c for m, (_, c) in graphed._graphs.items()}
    assert per and all(c["gaussian_guide_batch"] == 1
                       and c["in_relu_fwd_nhwc"] == c["in_relu_bwd_nhwc"]
                       == 10 and c["in_relu_fwd"] == c["in_relu_bwd"]
                       == c["in_relu_bwd_stats"] == c["in_relu_bwd_apply"]
                       == 0 for c in per.values())
    torch.testing.assert_close(vals_g[:, :2], vals_e[:, :2], rtol=1e-4,
                               atol=0)
    _, noisy = trainer(4, "--noise_scale", "0.05", "--random_flip", "3")
    assert bool(torch.isfinite(_run(noisy, batches, 4)).all())


# ---------------------------------------------------------------------------
# serving: B2-fwd as the registered operator, the export bundle on the card
# ---------------------------------------------------------------------------

def test_b2_fwd_operator_launches_the_kernel(dev):
    """torch.ops.boxseg.in_relu_fwd on CUDA tensors is the kernel (counted)
    and agrees with the plain version; on CPU tensors it is the plain
    version (not counted)."""
    x, _, w, b = _in_relu_inputs((2, 8, 32, 32), torch.bfloat16, dev, seed=9)
    n0 = kernels.in_relu_fwd.launches
    got = torch.ops.boxseg.in_relu_fwd(x, w, b, kernels.IN_EPS)
    ref = kernels.in_relu_fwd_plain(x, w, b)
    torch.cuda.synchronize()
    assert kernels.in_relu_fwd.launches == n0 + 1
    for g, r in zip(got, ref):
        tol = (_TOL[torch.bfloat16] if g.dtype == torch.bfloat16
               else dict(rtol=1e-5, atol=0))
        torch.testing.assert_close(g.float(), r.float(), **tol)
    cpu = torch.ops.boxseg.in_relu_fwd(x.cpu(), w.cpu(), b.cpu(),
                                       kernels.IN_EPS)
    assert kernels.in_relu_fwd.launches == n0 + 1
    torch.testing.assert_close(cpu[0].float(), ref[0].float().cpu(),
                               **_TOL[torch.bfloat16])


def test_export_on_the_card_serves_on_cpu_and_card(dev, tmp_path):
    """A GUNet_TINY bundle exported with the card as the device (64^2,
    float32, TF32 off; traced on the CPU) serves on the CPU and on the card
    within 1e-4; on the card each request launches B2-fwd once per
    full-affine pair of the forward (6) and B3-fwd once per modulated block
    (4), on their NHWC plans (the exported graph keeps GUNet's channels-last
    activations)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.cli.export import load_exported

    argv = ["liver", "--mode", "export", "--tag", "t", "--model", "GUNet",
            "--model_config", "GUNet_TINY.yml", "--classes", "Liver",
            "Tumor", "--im_height", "64", "--im_width", "64",
            "--normalizer", "instance_norm", "--use_context",
            "--context_list", "hist", "200", "--use_spatial",
            "--batch_size", "2", "--compute_dtype", "float32",
            "--model_dir", str(tmp_path / "md")]
    bundle = cli.main(argv)
    rng = np.random.default_rng(0)
    feats = {"images": rng.random((2, 64, 64, 3), dtype=np.float32),
             "sp_guide": rng.uniform(0.25, 0.75, (2, 64, 64, 1)).astype(
                 np.float32),
             "context": rng.random((2, 200), dtype=np.float32)}
    on_cpu, _ = load_exported(bundle, "cpu")
    on_card, sig = load_exported(bundle, "cuda")
    assert sig["model"] == "GUNet"
    n0 = kernels.in_relu_fwd_nhwc.launches
    m0 = kernels.modnorm_relu_fwd_nhwc.launches
    card = on_card(feats)
    torch.cuda.synchronize()
    assert card.device.type == "cuda"
    assert kernels.in_relu_fwd_nhwc.launches == n0 + 6
    assert kernels.modnorm_relu_fwd_nhwc.launches == m0 + 4
    torch.testing.assert_close(card.cpu(), on_cpu(feats), atol=1e-4, rtol=0)


@pytest.mark.parametrize("k", [1, 40])
def test_annotate_preview_on_the_card_matches_plain(dev, k):
    """The annotator's guide preview at 512^2 is one B1 launch on the card;
    it agrees with the plain version on the CPU (float 1e-6, uint8 within
    one level)."""
    from boxsegliver_torch.cli.annotate import guide_preview

    rng = np.random.default_rng(k)
    objs = [{"center": rng.uniform(0, 512, 2).round(3).tolist(),
             "stddev": rng.uniform(0.5, 30, 2).round(3).tolist()}
            for _ in range(k)]
    n0 = kernels.gaussian_guide_batch.launches
    guide, preview = guide_preview(objs, (512, 512), dev)
    assert kernels.gaussian_guide_batch.launches == n0 + 1
    plain, plain8 = guide_preview(objs, (512, 512), "cpu")
    assert guide.shape == (512, 512) and preview.dtype == np.uint8
    assert np.abs(guide - plain).max() <= 1e-6
    assert np.abs(preview.astype(np.int32) - plain8).max() <= 1


def test_annotate_predict_on_the_card_matches_cpu(dev, tmp_path):
    """The annotator's live Predict (GUNet_TINY, 64^2, float32, TF32 off,
    the dataset's prior as the user's interactions) on the card launches B1
    and B2-fwd and agrees with the same app on the CPU: probabilities within
    1e-4, equal class maps and metrics.  The head's bias gives Liver a
    margin, so no tumor is predicted and no argmax tie steers the sweep."""
    import json

    from boxsegliver_torch.cli import annotate
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    ds = tmp_path / "ds"
    make_synthetic_dataset(ds, n_cases=2, shape=(8, 64, 64), k_split=2,
                           seed=1)
    argv = ["liver", "--mode", "eval", "--tag", "t", "--model", "GUNet",
            "--model_config", "GUNet_TINY.yml", "--classes", "Liver",
            "Tumor", "--im_height", "64", "--im_width", "64",
            "--normalizer", "instance_norm", "--use_spatial",
            "--compute_dtype", "float32", "--eval_mirror", "--random_flip",
            "3", "--model_dir", str(tmp_path / "md")]
    model = cli._build_model(cli.get_args(argv + ["--device", "cpu"]))
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.AdjustChannels.weight.mul_(1e-3)
        model.AdjustChannels.bias.copy_(torch.tensor([0.0, 8.0, 0.0]))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    argv += ["--ckpt_path", str(tmp_path / "w.pt")]
    meta = load_meta(ds)[0]
    pid = int(meta["PID"])
    prior = json.loads((ds / "prior.json").read_text())[str(pid)]
    assert prior
    out = {}
    for d in ("cuda", "cpu"):
        app = annotate.AnnotateApp(ds, interactions_file=tmp_path / f"{d}.j",
                                   device=d, model_argv=argv)
        app.interactions = {str(pid): prior}
        n1 = kernels.gaussian_guide_batch.launches
        n2 = kernels.in_relu_fwd_nhwc.launches
        metrics = app.predict_case(pid)["metrics"]
        if d == "cuda":
            torch.cuda.synchronize()
            assert kernels.gaussian_guide_batch.launches > n1
            assert kernels.in_relu_fwd_nhwc.launches > n2
        evaluator, predictor = app._predictor
        _, probs = evaluator.predict_case_g(predictor, meta, prior)
        out[d] = (probs, app._live[pid], metrics)
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= 1e-4
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2] == out["cpu"][2]


# ---------------------------------------------------------------------------
# G1: the geodesic raster scan
# ---------------------------------------------------------------------------

def _geo_inputs(n, h, w, seed, corners=False, none=False):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy((rng.normal(size=(n, h, w)) * 2.0).astype(
        np.float32))
    seeds = torch.from_numpy(rng.random((n, h, w)) > 0.995)
    seeds[:, (h - 1) // 2, (w - 1) // 2] = True
    if corners:
        seeds[:] = False
        seeds[:, 0, 0] = seeds[:, -1, -1] = True
    if none:
        seeds[0] = False
    return img, seeds


@pytest.mark.parametrize("n,h,w,corners,none", [
    (64, 128, 128, False, True), (3, 127, 129, False, False),
    (2, 1, 77, False, False), (2, 77, 1, False, False),
    (2, 40, 300, True, False), (2, 16, 1024, False, False),
    (4, 256, 256, False, False), (2, 48, 257, False, False)],
    ids=["refiner", "odd", "one_row", "one_column", "corners", "wide",
         "refiner_512", "block_plan_edge"])
def test_g1_matches_plain_and_counts(dev, n, h, w, corners, none):
    """Relative 1e-5 of the finite field (the min-plus scan's
    reassociation), +inf at the same pixels, one count a launch."""
    from boxsegliver_torch.ops.geodesic import geodesic2d

    img, seeds = _geo_inputs(n, h, w, h + w, corners, none)
    before = kernels.geodesic2d_batch.launches
    out = kernels.geodesic2d_batch(img.to(dev), seeds.to(dev)).cpu()
    assert kernels.geodesic2d_batch.launches == before + 1
    ref = geodesic2d(img, seeds)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), fin)
    if none:
        assert not fin[0].any()
    scale = max(1.0, float(ref[fin].abs().max()))
    torch.testing.assert_close(out[fin], ref[fin], rtol=0, atol=1e-5 * scale)


def test_g1_rejects_what_it_does_not_take(dev):
    img = torch.zeros((2, 8, 8), device=dev)
    seeds = torch.ones((2, 8, 8), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        kernels.geodesic2d_batch(img.double(), seeds)
    with pytest.raises(ValueError):
        kernels.geodesic2d_batch(img, seeds[:1])
    with pytest.raises(ValueError):
        kernels.geodesic2d_batch(torch.zeros((1, 4, 1025), device=dev),
                                 torch.ones((1, 4, 1025), dtype=torch.bool,
                                            device=dev))
    with pytest.raises(ValueError):
        kernels.geodesic2d_batch(img.transpose(1, 2), seeds)


def test_device_refiner_on_the_card_matches_cpu(dev):
    """DeviceRefiner2D in float32 on the card against the CPU, every guide
    kind, on a small UNetInter fit (on the CPU) to blob slices so that its
    margins are clear: equal clicks, Dice within 1e-4; one B1 (gaussian)
    or G1 (geodesic) launch a round."""
    from boxsegliver_torch.interactive.device_refine import DeviceRefiner2D
    from boxsegliver_torch.interactive.refine import render_click_guides
    from boxsegliver_torch.models import build_model

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :64]
    labs = np.stack([(yy - 20 - 3 * i) ** 2 + (xx - 30 + 2 * i) ** 2
                     < 40 + 10 * i for i in range(5)])
    ims = (labs[..., None] * 1.5 + rng.normal(size=(5, 64, 64, 3)) * 0.3
           ).astype(np.float32)
    model = build_model("UNetInter", model_kwargs={
        "init_channels": 4, "num_down_samples": 2,
        "normalizer": "instance_norm"}, num_classes=2, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    guides = torch.stack([render_click_guides(
        (64, 64), [tuple(int(v) for v in np.argwhere(lab).mean(0))], [])
        for lab in labs]).permute(0, 2, 3, 1)
    feats = {"images": torch.from_numpy(ims), "sp_guide": guides}
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    for _ in range(100):
        opt.zero_grad()
        torch.nn.functional.cross_entropy(
            model(feats).permute(0, 3, 1, 2),
            torch.from_numpy(labs).long()).backward()
        opt.step()
    model.eval()
    for kind in ("gaussian", "euclidean", "geodesic"):
        kw = dict(max_iters=4, guide_kind=kind, dice_thresh=0.97)
        cpu = DeviceRefiner2D(model, device="cpu", **kw).refine_case(ims,
                                                                     labs)
        kernels.reset_launch_counts()
        refiner = DeviceRefiner2D(model, device=dev, **kw)
        gpu = refiner.refine_case(ims, labs)
        rounds = {"gaussian": kernels.gaussian_guide_batch.launches,
                  "geodesic": kernels.geodesic2d_batch.launches}
        if kind in rounds:
            assert rounds[kind] == refiner.rounds >= 1
        assert gpu["clicks"] == cpu["clicks"]
        assert abs(gpu["Dice"] - cpu["Dice"]) <= 1e-4
        model.cpu()


# B2 over NCDHW planes of D·H·W (UNet3D): the train step's level 2 at
# batch 4 (staged plan: 5·64² bf16 = 40 KiB) and the whole-volume eval's
# level 0 (general plan: one CTA a plane of 24·256² elements)
B2_3D_SHAPES = [((4, 120, 5, 64, 64), kernels.FWD_STAGED),
                ((1, 30, 24, 256, 256), kernels.FWD_GENERAL)]


@pytest.mark.parametrize("shape,path", B2_3D_SHAPES)
def test_b2_at_ncdhw_planes_matches_plain(dev, shape, path):
    n, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    assert kernels.in_relu_fwd_plan(n * c, hw, torch.bfloat16).path == path
    x, g, w, b = _in_relu_inputs(shape, torch.bfloat16, dev, seed=c)
    n0 = [kernels.in_relu_fwd.launches, kernels.in_relu_bwd_stats.launches,
          kernels.in_relu_bwd_apply.launches]
    y, xh, rstd = kernels.in_relu_fwd(x, w, b)
    y_p, xh_p, rstd_p = kernels.in_relu_fwd_plain(x, w, b)
    s1, s2 = kernels.in_relu_bwd_stats(g, xh_p, w, b)
    s1_p, s2_p = kernels.in_relu_bwd_stats_plain(g, xh_p, w, b)
    dx = kernels.in_relu_bwd_apply(g, xh_p, w, b, rstd_p, s1_p, s2_p)
    dx_p = kernels.in_relu_bwd_apply_plain(g, xh_p, w, b, rstd_p, s1_p, s2_p)
    torch.cuda.synchronize()
    assert [kernels.in_relu_fwd.launches, kernels.in_relu_bwd_stats.launches,
            kernels.in_relu_bwd_apply.launches] == [k + 1 for k in n0]
    assert y.shape == dx.shape == shape and rstd.shape == (n, c)
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(y.float(), y_p.float(), **tol)
    torch.testing.assert_close(xh.float(), xh_p.float(), **tol)
    torch.testing.assert_close(s1, s1_p, rtol=1e-4, atol=1e-4 * hw ** 0.5)
    torch.testing.assert_close(s2, s2_p, rtol=1e-4, atol=1e-4 * hw ** 0.5)
    torch.testing.assert_close(dx.float(), dx_p.float(), **tol)


# B2 split around a collective: B2s (partial sums, one CTA or several a
# plane), B2y (apply), on a rank's part of planes and on odd / unaligned
# parts (the scalar path)
SPLIT_SHAPES = [((8, 64, 128, 256), torch.bfloat16),
                ((1, 30, 12, 256, 256), torch.bfloat16),
                ((8, 1024, 8, 16), torch.bfloat16),
                ((2, 3, 7, 9), torch.float32), ((1, 4, 5, 3, 33), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", SPLIT_SHAPES)
def test_split_b2_matches_plain_and_counts(dev, shape, dtype):
    x, _, w, b = _in_relu_inputs(shape, dtype, dev, seed=len(shape))
    hw = int(np.prod(shape[2:]))
    n0 = [kernels.in_relu_fwd_partial.launches,
          kernels.in_relu_fwd_apply.launches]
    part = kernels.in_relu_fwd_partial(x)
    part_p = kernels.in_relu_fwd_partial_plain(x)
    mean = (part_p[..., 0] / hw).contiguous()
    var = torch.clamp_min(part_p[..., 1] / hw - mean * mean, 0.0)
    rstd = torch.rsqrt(var + kernels.IN_EPS).contiguous()
    y = kernels.in_relu_fwd_apply(x, mean, rstd, w, b)
    y_p = kernels.in_relu_fwd_apply_plain(x, mean, rstd, w, b)
    torch.cuda.synchronize()
    assert [kernels.in_relu_fwd_partial.launches,
            kernels.in_relu_fwd_apply.launches] == [k + 1 for k in n0]
    assert part.shape == shape[:2] + (2,) and y.dtype == dtype
    torch.testing.assert_close(part, part_p, rtol=1e-4, atol=1e-4 * hw ** 0.5)
    torch.testing.assert_close(y.float(), y_p.float(), **_TOL[dtype])
    # deterministic: the splits are added in a fixed order
    assert torch.equal(kernels.in_relu_fwd_partial(x), part)


def test_split_b2_unaligned_part(dev):
    x, _, w, b = _in_relu_inputs((2, 3, 16, 16), torch.bfloat16, dev)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    flat[1:] = x.flatten()
    xu = flat[1:].view(x.shape)
    part = kernels.in_relu_fwd_partial(xu)
    torch.testing.assert_close(part, kernels.in_relu_fwd_partial_plain(x),
                               rtol=1e-4, atol=1e-3)
    mean = torch.zeros(2, 3, device=dev)
    rstd = torch.ones(2, 3, device=dev)
    torch.testing.assert_close(
        kernels.in_relu_fwd_apply(xu, mean, rstd, w, b).float(),
        kernels.in_relu_fwd_apply_plain(x, mean, rstd, w, b).float(),
        **_TOL[torch.bfloat16])
