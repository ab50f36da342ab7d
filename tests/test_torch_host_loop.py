"""The port's per-slice host propagation loop (run_g's fallback) against the
JAX package on the CPU, on the fitted tiny GUNet and synthetic dataset of
tests/test_torch_sweep.py.  Tolerances: the port's host loop against the
JAX host loop 1e-4 (float32 forwards in another summation order, B1's
plain render for numpy's, the bilinear case resize for cv2's); against the
port's own device sweep 2e-4, as tests/test_device_sweep.py holds the JAX
pair; run_g per-case metrics 1e-3; the Wu line and the ascent test exact;
B1's plain render against create_gaussian_distribution_v2 1e-6 (the
exponent in another rounding order); the dumped guide volumes within one
int16 step (×255, truncated)."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.data.meta import load_meta
from boxsegliver_tpu.data.nii import read_nii as j_read_nii
from boxsegliver_tpu.data.synthetic import make_synthetic_dataset
from boxsegliver_tpu.evaluators.eval_loader import parse_case_eval
from boxsegliver_tpu.evaluators.volume import EvaluateVolume
from boxsegliver_tpu.interactive.device_sweep import GuidedSweepPredictor
from boxsegliver_tpu.models import build_model
from boxsegliver_tpu.ops import array_kits
from boxsegliver_tpu.train.trainer import TrainState
from boxsegliver_torch.cli import main as t_cli
from boxsegliver_torch.data import nii as t_nii
from boxsegliver_torch.evaluators import eval_loader as t_loader
from boxsegliver_torch.evaluators import volume as t_volume
from boxsegliver_torch.interactive import device_sweep as t_sweep
from boxsegliver_torch.models import build_model as t_build_model
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.ops import array_kits as t_kits
from boxsegliver_torch.ops import kernels

torch.set_num_threads(2)

_KW = {"init_channels": 4, "num_down_samples": 2, "mod_layers": (1, 2),
       "use_spatial": True, "normalizer": "instance_norm"}


def _args(model_dir, **kw):
    ns = argparse.Namespace(
        im_height=64, im_width=64, im_channel=3, batch_size=4,
        eval_mirror=True, random_flip=3, metrics_eval=["Dice", "VOE", "RVD"],
        primary_metric=None, secondary_metric=None, task="liver",
        use_context=False, use_spatial=True, hist_scale=20.0,
        eval_num=-1, eval_skip_num=0, min_std=2.0, eval_discount=0.85,
        save_sp_guide=False, real_sp=None, sweep_max_objects=8,
        pred_type="pred", save_path="pred", model_dir=str(model_dir))
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_loop") / "ds"
    make_synthetic_dataset(root, n_cases=2, shape=(11, 96, 96), k_split=2,
                           seed=7)
    return root


@pytest.fixture(scope="module")
def fitted(ds):
    """Tiny spatial GUNet Adam-fitted on case 0 (60 steps), in both
    packages: (JAX predictor, port model)."""
    import cv2

    case = parse_case_eval(load_meta(ds)[0], ds, im_channel=3)
    model = build_model("GUNet", model_kwargs=_KW, num_classes=3)
    feats = {"images": np.zeros((1, 64, 64, 3), np.float32),
             "sp_guide": np.zeros((1, 64, 64, 1), np.float32)}
    params = model.init(jax.random.PRNGKey(1), feats)["params"]
    vol = np.stack([cv2.resize(s, (64, 64), interpolation=cv2.INTER_LINEAR)
                    for s in case.volume.astype(np.float32)])
    seg = np.stack([cv2.resize(s, (64, 64), interpolation=cv2.INTER_NEAREST)
                    for s in case.segmentation])
    cz = case.depth
    guides = np.full((cz, 64, 64, 1), 0.5, np.float32)
    for i in range(cz):
        if (seg[i] == 2).any():
            c, s = array_kits.compute_robust_moments(seg[i] == 2, min_std=2.0)
            g = array_kits.create_gaussian_distribution_v2((64, 64), [c], [s])
            guides[i, ..., 0] = g * 0.85 / 2 + 0.5
    batch = {"images": np.stack([vol[i:i + 3].transpose(1, 2, 0)
                                 for i in range(cz)]), "sp_guide": guides}
    tx = optax.adam(3e-3)
    opt_state = tx.init(params)

    @jax.jit
    def fit_step(params, opt_state):
        def loss_fn(p):
            logits = model.apply({"params": p}, batch)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, seg.astype(np.int32)).mean()

        grads = jax.grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(60):
        params, opt_state = fit_step(params, opt_state)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    jax_pred = GuidedSweepPredictor(model, state, _args("."), num_classes=3,
                                    tumor_id=2)
    t_model = t_build_model("GUNet", model_kwargs=dict(_KW, in_channels=3),
                            num_classes=3)
    flat = traverse_util.flatten_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params)}, sep="/")
    t_model.load_state_dict(flax_to_state_dict(flat), strict=True)
    return jax_pred, t_model


def _t_pred(t_model, args):
    return t_sweep.GuidedSweepPredictor(t_model, args, num_classes=3,
                                        tumor_id=2, device="cpu")


@pytest.mark.parametrize("mirror", [False, True])
def test_host_loop_matches_jax_host_loop(ds, tmp_path, fitted, mirror):
    jax_pred, t_model = fitted
    args = _args(tmp_path / "m", eval_mirror=mirror)
    j_ev = EvaluateVolume(args, ds, ["Liver", "Tumor"])
    t_ev = t_volume.EvaluateVolume(args, ds, ["Liver", "Tumor"])
    prior = json.loads((ds / "prior.json").read_text())
    t_pred = _t_pred(t_model, args)
    for meta in load_meta(ds):
        case = parse_case_eval(meta, ds, im_channel=3)
        t_case = t_loader.parse_case_eval(meta, ds, im_channel=3)
        pc = prior[str(case.pid)]
        ref = j_ev._sweep_case_host(jax_pred, case, pc, None, tumor_id=2)
        out = t_ev._sweep_case_host(t_pred, t_case, pc, None, tumor_id=2)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
        assert (out.argmax(-1) == 2).sum() > 0


def test_host_loop_matches_device_sweep(ds, tmp_path, fitted):
    _, t_model = fitted
    args = _args(tmp_path / "d")
    t_ev = t_volume.EvaluateVolume(args, ds, ["Liver", "Tumor"])
    prior = json.loads((ds / "prior.json").read_text())
    t_pred = _t_pred(t_model, args)
    for meta in load_meta(ds):
        case = t_loader.parse_case_eval(meta, ds, im_channel=3)
        pc = prior[str(case.pid)]
        kernels.reset_launch_counts()
        host = t_ev._sweep_case_host(t_pred.__call__, case, pc, None,
                                     tumor_id=2)
        dev, n_max = t_pred.sweep_case(case, pc, None)
        assert dev is not None and 0 <= n_max <= args.sweep_max_objects
        np.testing.assert_allclose(host, dev, atol=2e-4, rtol=2e-4)
    # on the CPU the guide render takes B1's plain version: no launch
    assert kernels.gaussian_guide_batch.launches == 0


def test_run_g_overflow_falls_back_like_jax(ds, tmp_path, fitted):
    """A one-object cap overflows both packages' sweeps; both finish the
    cases through their host loops with the same metrics."""
    jax_pred, t_model = fitted
    metas = load_meta(ds)
    prior = json.loads((ds / "prior.json").read_text())
    j_args = _args(tmp_path / "j", sweep_max_objects=1)
    t_args = _args(tmp_path / "t", sweep_max_objects=1)
    t_pred = _t_pred(t_model, t_args)
    case = t_loader.parse_case_eval(metas[0], ds, im_channel=3)
    assert t_pred.sweep_case(case, prior[str(case.pid)], None)[0] is None
    jax_pred.max_objects = 1
    try:
        ref = EvaluateVolume(j_args, ds, ["Liver", "Tumor"]).run_g(
            jax_pred, metas, prior=prior)
    finally:
        jax_pred.max_objects = 8
    out = t_volume.EvaluateVolume(t_args, ds, ["Liver", "Tumor"]).run_g(
        t_pred, metas, prior=prior)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=1e-3, err_msg=k)
    assert ref["Tumor/Dice"] > 0.0


def test_wu_line_and_ascent_match_jax():
    rng = np.random.default_rng(0)
    img = rng.random((40, 40)).astype(np.float32)
    ramp = np.add.outer(np.arange(40.0), np.arange(40.0)).astype(np.float32)
    for _ in range(300):
        x0, y0, x1, y1 = (int(v) for v in rng.integers(0, 40, 4))
        if (x0, y0) == (x1, y1):
            continue
        assert t_kits.xiaolinwu_line(x0, y0, x1, y1) == \
            array_kits.xiaolinwu_line(x0, y0, x1, y1)
        for im in (img, ramp):
            assert t_kits.ascent_line(im, x0, y0, x1, y1) == \
                array_kits.ascent_line(im, x0, y0, x1, y1)
    with pytest.raises(ValueError):
        t_kits.xiaolinwu_line(3, 4, 3, 4)


@pytest.mark.parametrize("n_obj", [0, 1, 5])
def test_b1_plain_render_matches_numpy(n_obj):
    """The port's copy of create_gaussian_distribution_v2 equals the JAX
    package's; B1's plain version with the host loop's epilogue (scale
    discount / 2, offset GUIDE_BG) equals the JAX loop's numpy render
    within 1e-6."""
    rng = np.random.default_rng(n_obj)
    shape = (48, 56)
    centers = rng.integers(-5, 60, (n_obj, 2)).astype(np.float32)
    stds = np.maximum(rng.uniform(0.5, 12.0, (n_obj, 2)), 2.0).astype(
        np.float32)
    if n_obj:
        ref = array_kits.create_gaussian_distribution_v2(shape, centers, stds)
        np.testing.assert_array_equal(
            t_kits.create_gaussian_distribution_v2(shape, centers, stds), ref)
        ref = ref * 0.85 / 2 + 0.5
    else:
        ref = np.full(shape, 0.5, np.float32)
    got = kernels.gaussian_guide_batch_plain(
        torch.from_numpy(centers)[None], torch.from_numpy(stds)[None],
        torch.ones((1, n_obj), dtype=torch.bool), height=shape[0],
        width=shape[1], scale=0.85 / 2, offset=0.5)[0, ..., 0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_save_sp_guide_volumes_match_jax(ds, tmp_path, fitted):
    """--save_sp_guide routes run_g through the host loop, which writes
    guide-{F,B}-<pid>.nii.gz at the original case shape."""
    jax_pred, t_model = fitted
    metas = load_meta(ds)[:1]
    prior = json.loads((ds / "prior.json").read_text())
    j_args = _args(tmp_path / "j", save_sp_guide=True)
    t_args = _args(tmp_path / "t", save_sp_guide=True)
    EvaluateVolume(j_args, ds, ["Liver", "Tumor"]).run_g(jax_pred, metas,
                                                          prior=prior)
    t_volume.EvaluateVolume(t_args, ds, ["Liver", "Tumor"]).run_g(
        _t_pred(t_model, t_args), metas, prior=prior)
    pid = metas[0]["PID"]
    for d in "FB":
        name = f"sp_guide/guide-{d}-{pid}.nii.gz"
        _, want = j_read_nii(tmp_path / "j" / name)
        _, got = t_nii.read_nii(tmp_path / "t" / name)
        assert got.shape == want.shape == tuple(metas[0]["size"])
        assert got.dtype == want.dtype
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        assert want.max() > 127             # real guides were propagated


def test_cli_device_sweep_off_matches_on(ds, tmp_path, fitted):
    """--device_sweep off runs run_g's host loop through the CLI; its
    metrics equal the device sweep's within 1e-3."""
    _, t_model = fitted
    torch.save(t_model.state_dict(), tmp_path / "w.pt")
    from boxsegliver_torch import models
    argv = ["liver", "--mode", "eval", "--tag", "t", "--model", "GUNet",
            "--model_config", "tiny_host_loop.yml", "--classes", "Liver",
            "Tumor", "--use_spatial", "--normalizer", "instance_norm",
            "--device", "cpu", "--compute_dtype", "float32",
            "--im_height", "64", "--im_width", "64", "--eval_mirror",
            "--data_root", str(ds.parent), "--dataset", ds.name,
            "--k_folds", "2", "--test_fold", "0", "--metrics_eval", "Dice",
            "VOE", "--ckpt_path", str(tmp_path / "w.pt")]
    models.MODEL_CONFIGS["tiny_host_loop.yml"] = dict(_KW)
    try:
        on = t_cli.main(argv + ["--model_dir", str(tmp_path / "on")])
        off = t_cli.main(argv + ["--model_dir", str(tmp_path / "off"),
                                 "--device_sweep", "off"])
    finally:
        models.MODEL_CONFIGS.pop("tiny_host_loop.yml")
    assert set(on) == set(off)
    for k in on:
        np.testing.assert_allclose(off[k], on[k], atol=1e-3, err_msg=k)
