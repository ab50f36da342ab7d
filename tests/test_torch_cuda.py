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
    want = kernels.in_relu_bwd_plain(g, xh, rstd, w.detach(), b.detach())
    for got, ref in zip((dx, dw, db), want):
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
    captured launches of B1 and B2 to their counters."""
    quiet = ("--noise_scale", "0", "--random_flip", "0", "--side_dropout",
             "0")
    graphed, batches = _graph_trainers(tmp_path, 4, *quiet)
    eager, _ = _graph_trainers(tmp_path, 1, *quiet)
    kernels.reset_launch_counts()
    vals_g = _run(graphed, batches, 4)
    counts = {n: fn.launches for n, fn in kernels.KERNELS.items()}
    vals_e = _run(eager, batches, 1)
    assert len(graphed._graphs) == 2            # metric / no-metric variant
    for n in ("gaussian_guide_batch", "in_relu_fwd", "in_relu_bwd_stats",
              "in_relu_bwd_apply"):
        assert counts[n] > 0 and counts[n] * 2 == kernels.KERNELS[n].launches
        per = {m: c[n] for m, (_, c) in graphed._graphs.items()}
        assert per[True] == per[False] > 0
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
    block, and the losses agree within 1e-4 relative.  With gamma, noise
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
                       and c["in_relu_fwd"] == c["in_relu_bwd_stats"]
                       == c["in_relu_bwd_apply"] == 10 for c in per.values())
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
    """A GUNet_TINY bundle exported on the card (64^2, float32, TF32 off)
    serves on the CPU and on the card within 1e-4; on the card each request
    launches B2-fwd once per full-affine pair of the forward (6)."""
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
    n0 = kernels.in_relu_fwd.launches
    card = on_card(feats)
    torch.cuda.synchronize()
    assert card.device.type == "cuda"
    assert kernels.in_relu_fwd.launches == n0 + 6
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
        n2 = kernels.in_relu_fwd.launches
        metrics = app.predict_case(pid)["metrics"]
        if d == "cuda":
            torch.cuda.synchronize()
            assert kernels.gaussian_guide_batch.launches > n1
            assert kernels.in_relu_fwd.launches > n2
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
