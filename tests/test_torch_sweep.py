"""The port's guided eval slice against the JAX package on the CPU:
GuidedSweepPredictor.sweep_case and EvaluateVolume.run_g of both packages
on the same fitted tiny GUNet and synthetic dataset (the setup of
tests/test_device_sweep.py).  Tolerances: merged probabilities 1e-4 (float32
forward, summation order differs), equal max object counts, per-case
metrics 1e-4."""

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
from boxsegliver_tpu.data.synthetic import make_synthetic_dataset
from boxsegliver_tpu.evaluators.eval_loader import parse_case_eval
from boxsegliver_tpu.evaluators.volume import EvaluateVolume
from boxsegliver_tpu.interactive.device_sweep import GuidedSweepPredictor
from boxsegliver_tpu.models import build_model
from boxsegliver_tpu.ops import array_kits
from boxsegliver_tpu.train.trainer import TrainState
from boxsegliver_torch.evaluators import eval_loader as t_loader
from boxsegliver_torch.evaluators import volume as t_volume
from boxsegliver_torch.interactive import device_sweep as t_sweep
from boxsegliver_torch.models import build_model as t_build_model
from boxsegliver_torch.models.weights import flax_to_state_dict

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
    root = tmp_path_factory.mktemp("torch_sweep") / "ds"
    make_synthetic_dataset(root, n_cases=2, shape=(11, 96, 96), k_split=2,
                           seed=7)
    return root


@pytest.fixture(scope="module")
def fitted(ds):
    """Tiny spatial GUNet Adam-fitted on case 0 so predictions are blobby
    objects (a random init speckles hundreds of components per slice)."""
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


def test_sweep_case_matches_jax(ds, tmp_path, fitted):
    jax_pred, t_model = fitted
    args = _args(tmp_path / "m")
    prior = json.loads((ds / "prior.json").read_text())
    t_pred = t_sweep.GuidedSweepPredictor(t_model, args, num_classes=3,
                                          tumor_id=2, device="cpu")
    for meta in load_meta(ds):
        case = parse_case_eval(meta, ds, im_channel=3)
        t_case = t_loader.parse_case_eval(meta, ds, im_channel=3)
        pc = prior[str(case.pid)]
        ref, n_ref = jax_pred.sweep_case(case, pc, None)
        out, n_out = t_pred.sweep_case(t_case, pc, None)
        assert ref is not None and out is not None
        assert n_out == n_ref
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
        # the propagation really segments tumors on this case
        assert (out.argmax(-1) == 2).sum() > 0


def test_run_g_matches_jax(ds, tmp_path, fitted):
    jax_pred, t_model = fitted
    metas = load_meta(ds)
    ref = EvaluateVolume(_args(tmp_path / "j"), ds,
                         ["Liver", "Tumor"]).run_g(jax_pred, metas)
    t_pred = t_sweep.GuidedSweepPredictor(t_model, _args(tmp_path / "t"),
                                          num_classes=3, tumor_id=2,
                                          device="cpu")
    out = t_volume.EvaluateVolume(_args(tmp_path / "t"), ds,
                                  ["Liver", "Tumor"]).run_g(t_pred, metas)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)
    assert ref["Tumor/Dice"] > 0.0


def test_sweep_overflow_raises(ds, tmp_path, fitted):
    """The sweep reports an overflow (None) instead of truncating the object
    state; the evaluator then finishes the case through the host loop, as
    the JAX evaluator does (tests/test_torch_host_loop.py holds the two
    against each other)."""
    _, t_model = fitted
    args = _args(tmp_path / "o", sweep_max_objects=1)
    t_pred = t_sweep.GuidedSweepPredictor(t_model, args, num_classes=3,
                                          tumor_id=2, device="cpu")
    ev = t_volume.EvaluateVolume(args, ds, ["Liver", "Tumor"])
    meta = load_meta(ds)[0]
    prior = json.loads((ds / "prior.json").read_text())
    t_case = t_loader.parse_case_eval(meta, ds, im_channel=3)
    probs, n_max = t_pred.sweep_case(t_case, prior[str(meta["PID"])], None)
    assert probs is None and n_max > 1
    res = ev.run_g(t_pred, [meta], prior=prior)
    assert res and all(np.isfinite(v) for v in res.values())
