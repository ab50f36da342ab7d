"""run_g's height-sharded device sweep on the CPU: the port's
``GuidedSweepPredictor(group=...)`` with 2 gloo ranks (spawned processes
that import no JAX, tests/test_torch_dist_workers.sweep_rank) against the
JAX package's ``GuidedSweepPredictor(mesh=make_mesh(2))`` on the
conftest's fake CPU devices, on the setup of
tests/test_device_sweep.py:214-239 (a tiny spatial GUNet fitted by JAX at
64² so that its tumors are blobs, mirror TTA, the dataset's prior):

- merged probability volumes within 1e-4, equal ``n_max``, every rank's
  volumes, counts and steps equal to rank 0's;
- ``EvaluateVolume.run_g``'s per-case metrics and results within 1e-6;
- a second tiny GUNet with ``use_se`` (the SE's spatial mean over the
  ranks) and ``img_grad`` (dy's row from the next rank) and a context,
  against JAX's mesh sweep.

JAX's bilinear resizes are the port's for these comparisons (as in
tests/test_torch_dist_eval.py), so that they see the sweeps alone."""

import argparse
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.data.meta import load_meta
from boxsegliver_tpu.evaluators import device_eval as j_device_eval
from boxsegliver_tpu.evaluators.eval_loader import parse_case_eval
from boxsegliver_tpu.evaluators.volume import EvaluateVolume
from boxsegliver_tpu.interactive.device_sweep import GuidedSweepPredictor
from boxsegliver_tpu.models import build_model
from boxsegliver_tpu.ops import array_kits
from boxsegliver_tpu.parallel import make_mesh
from boxsegliver_tpu.train.trainer import TrainState
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.evaluators import device_eval as t_device_eval
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.ops.image_ops import resize_bilinear
from boxsegliver_torch.parallel import launch
from test_torch_dist_workers import sweep_rank

torch.set_num_threads(2)

KW = {"init_channels": 4, "num_down_samples": 2, "mod_layers": (1, 2),
      "use_spatial": True, "normalizer": "instance_norm"}
SE_KW = dict(KW, use_context=True, context_fc_channels=(8,), use_se=True,
             img_grad=True)
CTX = 16


def _args(model_dir, **kw):
    ns = dict(
        im_height=64, im_width=64, im_channel=3, batch_size=4,
        eval_mirror=True, random_flip=3, metrics_eval=["Dice", "VOE", "RVD"],
        primary_metric=None, secondary_metric=None, task="liver",
        use_context=False, use_spatial=True, hist_scale=20.0,
        eval_num=-1, eval_skip_num=0, min_std=2.0, eval_discount=0.85,
        save_sp_guide=False, real_sp=None, sweep_max_objects=8,
        pred_type="pred", save_path="pred", model_dir=str(model_dir))
    ns.update(kw)
    return ns


@pytest.fixture
def same_resize(monkeypatch):
    """JAX's bilinear resizes replaced by the port's."""
    real = cv2.resize

    def resize(img, dsize, interpolation=None):
        if interpolation == cv2.INTER_LINEAR:
            t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
            if t.ndim == 3:
                t = t.permute(2, 0, 1)
            out = resize_bilinear(t, (dsize[1], dsize[0]))
            if out.ndim == 3:
                out = out.permute(1, 2, 0)
                if out.shape[-1] == 1:
                    out = out[..., 0]
            return out.numpy()
        return real(img, dsize, interpolation=interpolation)

    monkeypatch.setattr(cv2, "resize", resize)
    monkeypatch.setattr(
        j_device_eval, "_resize_stack",
        lambda arr, pshape: t_device_eval._resize_stack(arr, pshape).numpy())


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_sweep") / "ds"
    make_synthetic_dataset(root, n_cases=2, shape=(11, 96, 96), k_split=2,
                           seed=7)
    return root


def _contexts(ds):
    rng = np.random.RandomState(5)
    return {int(m["PID"]): rng.rand(16, CTX).astype(np.float32)
            for m in load_meta(ds)}


def _fit(ds, kw, contexts=None, steps=60):
    """A tiny GUNet of ``kw`` Adam-fitted by JAX on case 0 (tests/
    test_device_sweep.py's fit): the JAX model and state, and the port's
    state_dict of the same weights."""
    case = parse_case_eval(load_meta(ds)[0], ds, im_channel=3)
    model = build_model("GUNet", model_kwargs=kw, num_classes=3)
    feats = {"images": np.zeros((1, 64, 64, 3), np.float32),
             "sp_guide": np.zeros((1, 64, 64, 1), np.float32)}
    if contexts is not None:
        feats["context"] = np.zeros((1, CTX), np.float32)
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
    if contexts is not None:
        batch["context"] = contexts[case.pid][:cz]
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

    for _ in range(steps):
        params, opt_state = fit_step(params, opt_state)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    flat = traverse_util.flatten_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params)}, sep="/")
    return model, state, flax_to_state_dict(flat)


def test_sharded_sweep_and_run_g_match_jax_mesh(ds, same_resize, tmp_path):
    model, state, tstate = _fit(ds, KW)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    args = argparse.Namespace(**_args(tmp_path / "j"))
    jpred = GuidedSweepPredictor(model, state, args, num_classes=3,
                                 tumor_id=2, mesh=make_mesh(2))
    prior = json.loads((ds / "prior.json").read_text())
    metas = load_meta(ds)
    want = [jpred.sweep_case(parse_case_eval(m, ds, im_channel=3),
                             prior[str(m["PID"])], None) for m in metas]
    jev = EvaluateVolume(args, ds, ["Liver", "Tumor"])
    want_res = jev.run_g(jpred, metas)

    got = launch(sweep_rank, 2, "cpu", {
        "args": _args(tmp_path / "t"), "kw": dict(KW, in_channels=3),
        "state": tstate, "ds": ds, "prior": prior})
    assert got["spread"] == 0.0
    for vol, n_max, (wvol, wn) in zip(got["vols"], got["counts"], want):
        assert wvol is not None and vol is not None
        assert n_max == wn
        np.testing.assert_allclose(vol, wvol, atol=1e-4, rtol=0)
    assert (got["vols"][0].argmax(-1) == 2).any()   # tumors propagate
    assert set(got["results"]) == set(want_res)
    for k in want_res:
        np.testing.assert_allclose(got["results"][k], want_res[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    per_case = {k: list(v) for k, v in jev._metric_values.items()}
    assert set(per_case) == set(got["per_case"])
    for k, v in per_case.items():
        np.testing.assert_allclose(got["per_case"][k], v, atol=1e-6, rtol=0,
                                   err_msg=k)
    assert want_res["Tumor/Dice"] > 0.0
    assert (tmp_path / "t" / "eval_results_3d.txt").exists()


def test_sharded_sweep_se_img_grad_matches_jax_mesh(ds, same_resize,
                                                    tmp_path):
    contexts = _contexts(ds)
    model, state, tstate = _fit(ds, SE_KW, contexts, steps=40)
    # a cap of 32 objects a slice: this briefly fitted model speckles more
    # components than the flagship's 8
    args = argparse.Namespace(**_args(tmp_path / "j", use_context=True,
                                      sweep_max_objects=32))
    jpred = GuidedSweepPredictor(model, state, args, num_classes=3,
                                 tumor_id=2, mesh=make_mesh(2))
    prior = json.loads((ds / "prior.json").read_text())
    want = [jpred.sweep_case(parse_case_eval(m, ds, im_channel=3),
                             prior[str(m["PID"])], contexts[int(m["PID"])])
            for m in load_meta(ds)]
    got = launch(sweep_rank, 2, "cpu", {
        "args": _args(tmp_path / "t", use_context=True,
                      sweep_max_objects=32),
        "kw": dict(SE_KW, in_channels=3, context_length=CTX),
        "state": tstate, "ds": ds, "prior": prior, "contexts": contexts,
        "run_g": False})
    assert got["spread"] == 0.0
    for vol, n_max, (wvol, wn) in zip(got["vols"], got["counts"], want):
        assert n_max == wn
        assert wvol is not None and vol is not None
        np.testing.assert_allclose(vol, wvol, atol=1e-4, rtol=0)
