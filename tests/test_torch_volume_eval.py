"""The port's unguided whole-volume eval against the JAX package's on the
CPU, with the same weights (a UNet_TINY with batch norm, fitted on the
port for 60 Adam steps so that its predictions are blobs, carried to flax by
the weight bridge) on a synthetic LiTS-like set:

- ``slice_batches``: equal to the JAX one (exact where no resize is needed
  or where both resize with the same bilinear function; within 1e-4 of
  cv2's resize otherwise, the port's documented bilinear tolerance);
- ``DeviceSlicePredictor.device_case`` against the JAX one, mirrors on and
  off, a depth that is not a multiple of the batch: 1e-5;
- ``EvaluateVolume.run``: per-case Dice / VOE / RVD and the G*Dice totals
  equal to 1e-6; the host (slice-batch) and device routes of
  ``predict_case`` agree (probabilities 1e-5, metrics 1e-6);
- ``predict_case_patches`` and ``make_inline_eval_fn`` against JAX.

Where the JAX package resizes with cv2.INTER_LINEAR, the tests that need
equal inputs give it the port's bilinear resize (held against cv2 in
tests/test_torch_resize.py), so the comparison sees the evaluators alone."""

import argparse
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.data.meta import load_meta
from boxsegliver_tpu.evaluators import device_eval as j_device_eval
from boxsegliver_tpu.evaluators import eval_loader as j_loader
from boxsegliver_tpu.evaluators import volume as j_volume
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.train.trainer import TrainState
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.evaluators import device_eval as t_device_eval
from boxsegliver_torch.evaluators import eval_loader as t_loader
from boxsegliver_torch.evaluators import volume as t_volume
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import state_dict_to_flax
from boxsegliver_torch.ops.image_ops import resize_bilinear, resize_nearest

torch.set_num_threads(2)
KW = dict(MODEL_CONFIGS["UNet_TINY.yml"])


def _args(model_dir, **kw):
    ns = argparse.Namespace(
        im_height=64, im_width=64, im_channel=3, batch_size=4,
        eval_mirror=True, random_flip=3, metrics_eval=["Dice", "VOE", "RVD"],
        primary_metric=None, secondary_metric=None, task="liver",
        use_context=False, use_spatial=False, hist_scale=20.0, eval_num=-1,
        eval_skip_num=0, eval_in_patches=False, pred_type="pred",
        save_path="pred", model_dir=str(model_dir))
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _port_bilinear(img, dsize, interpolation=None):
    """cv2.resize's signature over the port's bilinear resize (channels
    last; one channel comes back squeezed, as cv2 returns it)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if t.ndim == 3:
        t = t.permute(2, 0, 1)
    out = resize_bilinear(t, (dsize[1], dsize[0]))
    if out.ndim == 3:
        out = out.permute(1, 2, 0)
        if out.shape[-1] == 1:
            out = out[..., 0]
    return out.numpy()


@pytest.fixture
def same_resize(monkeypatch):
    """The JAX package's bilinear resizes replaced by the port's."""
    real = cv2.resize

    def resize(img, dsize, interpolation=None):
        if interpolation == cv2.INTER_LINEAR:
            return _port_bilinear(img, dsize)
        return real(img, dsize, interpolation=interpolation)

    monkeypatch.setattr(cv2, "resize", resize)
    monkeypatch.setattr(
        j_device_eval, "_resize_stack",
        lambda arr, pshape: t_device_eval._resize_stack(arr, pshape).numpy())


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("volume_eval") / "ds"
    make_synthetic_dataset(root, n_cases=2, shape=(11, 96, 96), k_split=2,
                           seed=7)
    return root


@pytest.fixture(scope="module")
def fitted(ds):
    """UNet_TINY (batch norm) fitted on case 0 at 64^2; returns the port
    model and the JAX (model, state) with the same variables."""
    case = t_loader.parse_case_eval(load_meta(ds)[0], ds, im_channel=3)
    vol = t_device_eval._resize_stack(case.volume, (64, 64))
    seg = resize_nearest(torch.from_numpy(np.array(case.segmentation)),
                         (64, 64)).long()
    images = torch.stack([vol[z:z + 3].permute(1, 2, 0)
                          for z in range(case.depth)])
    model = tbuild("UNet", model_kwargs=KW, num_classes=3,
                   dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    for _ in range(60):
        logits = model({"images": images}, train=True)
        loss = torch.nn.functional.cross_entropy(logits.permute(0, 3, 1, 2),
                                                 seg)
        opt.zero_grad()
        loss.backward()
        opt.step()
    model.eval()
    flat = state_dict_to_flax(model)
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    jmodel = jbuild("UNet", model_kwargs=KW, num_classes=3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                       batch_stats=tree["batch_stats"], opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    return model, jmodel, state


def _cases(ds):
    return [(j_loader.parse_case_eval(m, ds, im_channel=3),
             t_loader.parse_case_eval(m, ds, im_channel=3))
            for m in load_meta(ds)]


# ---------------------------------------------------------------------------
# slice_batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resize", ["none", "cv2", "same"])
@pytest.mark.parametrize("mirror", [False, True])
def test_slice_batches_match_jax(ds, request, resize, mirror):
    if resize == "same":
        request.getfixturevalue("same_resize")
    jcase, tcase = _cases(ds)[0]
    pshape = tuple(jcase.volume.shape[1:]) if resize == "none" else (64, 48)
    rng = np.random.default_rng(1)
    context = rng.normal(size=(jcase.oshape[0], 5)).astype(np.float32)
    guide = rng.uniform(0, 1, (jcase.depth,) + jcase.volume.shape[1:]
                        ).astype(np.float32)
    kw = dict(eval_mirror=mirror, random_flip=3, context=context,
              sp_guide=guide, guide_bg=0.5)
    want = list(j_loader.slice_batches(jcase, 4, pshape, **kw))
    got = list(t_loader.slice_batches(tcase, 4, pshape, **kw))
    assert len(got) == len(want) == (jcase.depth + 3) // 4 * (
        4 if mirror else 1)
    atol = 1e-4 if resize == "cv2" else 0.0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0,
                                           err_msg=k)
            else:
                assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# DeviceSlicePredictor.device_case
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mirror", [False, True])
def test_device_case_matches_jax(ds, fitted, same_resize, tmp_path, mirror):
    model, jmodel, state = fitted
    args = _args(tmp_path, eval_mirror=mirror)
    jpred = j_device_eval.DeviceSlicePredictor(jmodel, state, args)
    tpred = t_device_eval.DeviceSlicePredictor(model, args, device="cpu")
    assert len(tpred.flips) == (4 if mirror else 1)
    for jcase, tcase in _cases(ds):
        assert jcase.depth % args.batch_size            # a clipped batch
        want = jpred.device_case(jcase)
        got = tpred.device_case(tcase)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape == (jcase.depth, 64, 64, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        # the plain per-batch forward
        feats = {"images": np.transpose(tcase.volume[:3], (1, 2, 0))[None]}
        feats["images"] = _port_bilinear(feats["images"][0],
                                         (64, 64))[None].copy()
        np.testing.assert_allclose(tpred(feats).numpy(),
                                   np.asarray(jpred(feats)), atol=1e-5)


# ---------------------------------------------------------------------------
# EvaluateVolume.run
# ---------------------------------------------------------------------------

def _per_case(ev):
    return {k: list(v) for k, v in ev._metric_values.items()}


def test_run_matches_jax(ds, fitted, same_resize, tmp_path):
    model, jmodel, state = fitted
    metas = load_meta(ds)
    jargs, targs = _args(tmp_path / "j"), _args(tmp_path / "t")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jev = j_volume.EvaluateVolume(jargs, ds, ["Background", "Liver", "Tumor"])
    want = jev.run(j_device_eval.DeviceSlicePredictor(jmodel, state, jargs),
                   metas)
    tev = t_volume.EvaluateVolume(targs, ds, ["Background", "Liver", "Tumor"])
    got = tev.run(t_device_eval.DeviceSlicePredictor(model, targs, "cpu"),
                  metas)
    assert set(got) == set(want)
    assert {"GLiverDice", "GTumorDice", "Tumor/VOE", "Liver/RVD"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    pj, pt = _per_case(jev), _per_case(tev)
    assert set(pj) == set(pt) and all(len(v) == 2 for v in pt.values())
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert 0.5 < got["Liver/Dice"] <= 1.0 and got["Tumor/Dice"] > 0.0


def test_host_and_device_routes_agree(ds, fitted, tmp_path):
    """predict_case through the plain predict_fn (host slice batches, each
    mirror its own forward) and through device_case (one upload, mirrors
    batch-stacked) give the same probabilities and the same metrics."""
    model, _, _ = fitted
    args = _args(tmp_path)
    dev = t_device_eval.DeviceSlicePredictor(model, args, "cpu")
    plain = lambda feats: dev(feats)                       # noqa: E731
    ev = t_volume.EvaluateVolume(args, ds, ["Background", "Liver", "Tumor"])
    for _, tcase in _cases(ds):
        np.testing.assert_allclose(ev.predict_case(plain, tcase),
                                   ev.predict_case(dev, tcase), atol=1e-5,
                                   rtol=0)
    metas = load_meta(ds)
    a = ev.run(plain, metas)
    b = ev.run(dev, metas)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)


def test_patches_and_inline_eval_match_jax(ds, fitted, tmp_path):
    """--eval_in_patches (48^2 tiles of the 96^2 crops, no resize) and the
    trainer-driven inline eval (host slice batches through predict)."""
    model, jmodel, state = fitted
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    jpredict = jax.jit(lambda f: jax.nn.softmax(
        jmodel.apply(variables, f, train=False), axis=-1))
    tpredict = t_device_eval.DeviceSlicePredictor(model, _args(tmp_path),
                                                  "cpu").__call__
    metas = load_meta(ds)
    for name, extra in (("patches", dict(eval_in_patches=True, im_height=48,
                                         im_width=48, eval_mirror=False)),
                        ("inline", dict(im_height=96, im_width=96))):
        jargs = _args(tmp_path / ("j" + name), **extra)
        targs = _args(tmp_path / ("t" + name), **extra)
        jev = j_volume.EvaluateVolume(jargs, ds, ["Background", "Liver",
                                                  "Tumor"])
        tev = t_volume.EvaluateVolume(targs, ds, ["Background", "Liver",
                                                  "Tumor"])
        if name == "patches":
            want = jev.run(lambda f: jpredict(f), metas)
            got = tev.run(tpredict, metas)
        else:
            want = j_volume.make_inline_eval_fn(jev, metas, max_cases=1)(
                types.SimpleNamespace(predict=jpredict))
            got = t_volume.make_inline_eval_fn(tev, metas, max_cases=1)(
                types.SimpleNamespace(predict=tpredict))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                       err_msg=f"{name} {k}")
