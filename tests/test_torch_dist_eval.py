"""The port's data-parallel evals on the CPU (gloo; ranks are spawned
processes that import no JAX, tests/test_torch_dist_workers.py) against
the JAX package's mesh versions on the conftest's fake CPU devices:

- ``DeviceSlicePredictor`` with a 2-rank group against JAX's
  ``mesh=make_mesh(2)`` (UNet_TINY with batch norm, fitted so that its
  predictions are blobs; mirrors on, a depth that is not a multiple of the
  batch): rank 0's probabilities within 1e-4, ``EvaluateVolume.run``'s
  per-case metrics and totals within 1e-6;
- ``DeviceRefiner2D`` with a 2-rank group against JAX's mesh refiner
  (a small UNetInter fitted by JAX; a case of 9 lesion slices, whose
  bucket of 16 splits 8 + 8): equal clicks, Dice within 1e-5, for
  gaussian (kernel B1's function) and geodesic (G1's) guides; both ranks
  run the same rounds;
- the refiner's bucket rule (a multiple of the group) and its refusal of
  a mesh that is not a parallel.Group."""

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
from boxsegliver_tpu.interactive import refine as jrefine
from boxsegliver_tpu.interactive.device_refine import \
    DeviceRefiner2D as JRefiner2D
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.parallel import make_mesh
from boxsegliver_tpu.train.trainer import TrainState
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.evaluators import device_eval as t_device_eval
from boxsegliver_torch.evaluators import eval_loader as t_loader
from boxsegliver_torch.interactive.device_refine import (DeviceRefiner2D,
                                                         slice_bucket)
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.ops.image_ops import resize_bilinear, resize_nearest
from boxsegliver_torch.parallel import launch
from test_torch_dist_workers import CLASSES, eval_rank, refine_rank

torch.set_num_threads(2)
KW = dict(MODEL_CONFIGS["UNet_TINY.yml"])


def _args(model_dir):
    return dict(im_height=64, im_width=64, im_channel=3, batch_size=4,
                eval_mirror=True, random_flip=3,
                metrics_eval=["Dice", "VOE", "RVD"], primary_metric=None,
                secondary_metric=None, task="liver", use_context=False,
                use_spatial=False, hist_scale=20.0, eval_num=-1,
                eval_skip_num=0, eval_in_patches=False, pred_type="pred",
                save_path="pred", model_dir=str(model_dir))


@pytest.fixture
def same_resize(monkeypatch):
    """The JAX package's bilinear resizes replaced by the port's (as
    tests/test_torch_volume_eval.py: the comparison sees the evaluators
    alone)."""
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
    root = tmp_path_factory.mktemp("dist_eval") / "ds"
    make_synthetic_dataset(root, n_cases=2, shape=(11, 96, 96), k_split=2,
                           seed=7)
    return root


@pytest.fixture(scope="module")
def fitted(ds):
    """UNet_TINY (batch norm) fitted on case 0 at 64² by the port; the JAX
    (model, state) with the same variables."""
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
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in state_dict_to_flax(model).items()},
        sep="/")
    jmodel = jbuild("UNet", model_kwargs=KW, num_classes=3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                       batch_stats=tree["batch_stats"], opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    return model, jmodel, state


def test_device_eval_matches_jax_mesh(ds, fitted, same_resize, tmp_path):
    model, jmodel, state = fitted
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jargs = argparse.Namespace(**_args(tmp_path / "j"))
    jpred = j_device_eval.DeviceSlicePredictor(jmodel, state, jargs,
                                               mesh=make_mesh(2))
    assert jpred.mesh is not None
    metas = load_meta(ds)
    want_probs = [jpred.device_case(j_loader.parse_case_eval(m, ds,
                                                             im_channel=3))
                  for m in metas]
    assert all(p.shape[0] % jargs.batch_size for p in want_probs)
    jev = j_volume.EvaluateVolume(jargs, ds, CLASSES)
    want = jev.run(jpred, metas)

    got = launch(eval_rank, 2, "cpu", {
        "args": _args(tmp_path / "t"), "kw": KW, "ds": ds,
        "state": model.state_dict()})
    for g, w in zip(got["probs"], want_probs):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert set(got["results"]) == set(want)
    for k in want:
        np.testing.assert_allclose(got["results"][k], want[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    pj = {k: list(v) for k, v in jev._metric_values.items()}
    assert set(pj) == set(got["per_case"])
    for k in pj:
        assert len(got["per_case"][k]) == 2
        np.testing.assert_allclose(got["per_case"][k], pj[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    assert 0.5 < want["Liver/Dice"] <= 1.0
    assert (tmp_path / "t" / "eval_results_3d.txt").exists()


# ---------------------------------------------------------------------------
# the 2-D refiner over a group
# ---------------------------------------------------------------------------

TINY = {"init_channels": 4, "num_down_samples": 2}


def _blob(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)


@pytest.fixture(scope="module")
def inter():
    """A tiny UNetInter (two guide channels) fit by JAX on blob slices, so
    that it responds to its guides; 9 lesion slices and 2 empty ones."""
    import optax

    rng = np.random.RandomState(3)
    h = w = 48
    labs, ims = [], []
    for i in range(11):
        lab = (_blob(h, w, 10 + 3 * i, 12 + 2 * i, 4 + (i % 3))
               if i not in (4, 8) else np.zeros((h, w), np.uint8))
        labs.append(lab)
        ims.append(lab * 1.5 + rng.randn(h, w) * 0.35)
    labs = np.asarray(labs)
    ims = np.asarray(ims, np.float32)[..., None]
    model = jbuild("UNetInter", model_kwargs=dict(TINY), num_classes=2)
    params = model.init(jax.random.PRNGKey(0), {
        "images": ims[:1], "sp_guide": np.zeros((1, h, w, 2), np.float32)},
        train=False)["params"]
    guides = np.zeros((11, h, w, 2), np.float32)
    for i in range(11):
        ys, xs = np.where(labs[i])
        if len(ys):
            guides[i, ..., 0] = jrefine.render_click_guide(
                (h, w), [(int(ys.mean()), int(xs.mean()))], 5.0)
    batch = {"images": ims, "sp_guide": guides}
    tx = optax.adam(3e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o):
        def loss(p):
            logits = model.apply({"params": p}, batch, train=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labs.astype(np.int32)).mean()
        up, o = tx.update(jax.grad(loss)(p), o, p)
        return optax.apply_updates(p, up), o

    for _ in range(60):
        params, opt = step(params, opt)
    flat = {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(params), sep="/").items()}
    return model, params, flax_to_state_dict(flat), ims, labs


def test_refiner_matches_jax_mesh(inter):
    jmodel, params, tstate, ims, labs = inter
    kw = dict(dice_thresh=0.85, max_iters=5, stddev=5.0, guide_channel=2)
    state = types.SimpleNamespace(params=params, batch_stats=None)
    kinds = ("gaussian", "geodesic")
    want = {kind: JRefiner2D(jmodel, state, mesh=make_mesh(2),
                             guide_kind=kind, **kw).refine_case(ims, labs)
            for kind in kinds}
    got = launch(refine_rank, 2, "cpu", {
        "kw": dict(TINY, in_channels=1, guide_channels=2), "state": tstate,
        "kinds": kinds, "kw_refine": kw, "images": ims, "labels": labs})
    for kind in kinds:
        g, w = got[kind], want[kind]
        assert g["slices"] == w["slices"] == 9
        assert g["clicks"] == w["clicks"], kind
        np.testing.assert_allclose(g["Dice"], w["Dice"], atol=1e-5,
                                   err_msg=kind)
        assert len(set(g["rounds"])) == 1 and g["rounds"][0] >= 1
    # one process over the same slices: the same clicks and Dice
    model = tbuild("UNetInter", model_kwargs=dict(TINY, in_channels=1,
                                                  guide_channels=2),
                   num_classes=2, dtype=torch.float32)
    model.load_state_dict(tstate, strict=True)
    one = DeviceRefiner2D(model.eval(), device="cpu", guide_kind="gaussian",
                          **kw).refine_case(ims, labs)
    assert one["clicks"] == got["gaussian"]["clicks"]
    np.testing.assert_allclose(one["Dice"], got["gaussian"]["Dice"],
                               atol=1e-6)


@pytest.mark.parametrize("s,ranks,want", [(9, 1, 16), (9, 2, 16), (9, 3, 18),
                                          (300, 1, 300), (300, 8, 304)])
def test_refiner_bucket_divides_the_group(s, ranks, want):
    assert slice_bucket(s, ranks) == want


def test_refiner_mesh_must_be_a_group():
    model = tbuild("UNetInter", model_kwargs=dict(TINY, in_channels=1,
                                                  guide_channels=2),
                   num_classes=2, dtype=torch.float32)
    with pytest.raises(TypeError, match="parallel.Group"):
        DeviceRefiner2D(model, device="cpu", mesh=object())
