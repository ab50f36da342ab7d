"""The port's 2-D click-refinement eval against the JAX package's on the CPU:

- ``ops/labeling.largest_error_click`` (the erosion core by a distance
  transform) on blob / error masks, batched: coords, is_fg and has_error
  equal JAX's (and the host scipy placement);
- ``ops/guides.moments_from_mask`` within 1e-6;
- the geodesic eval guide (C++ scan + a numpy copy of OpenCV's float32
  bilinear) against JAX's (cv2) within 1e-5 relative;
- ``interactive_eval_2d`` on a tiny UNetInter fit by JAX (bridged float32
  weights), for each guide kind and ``--guide_channel`` 1 and 2: equal
  clicks, Dice within 1e-6;
- ``DeviceRefiner2D`` against the port's host loop and JAX's refiner: equal
  clicks, Dice within 1e-5 (geodesic: 1e-4, the guides differ by float
  reassociation);
- ``cli/interactive_eval`` end to end on a tiny synthetic NF set, host loop
  and refiner, against JAX's CLI: equal ``eval_results_inter.txt`` keys and
  means within 1e-6."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.interactive import refine as jrefine
from boxsegliver_tpu.interactive.device_refine import \
    DeviceRefiner2D as JRefiner
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.ops import guides as jguides
from boxsegliver_tpu.ops.labeling import largest_error_click as jclick
from boxsegliver_torch.cli import interactive_eval as tcli
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.interactive import refine as trefine
from boxsegliver_torch.interactive.clicks import next_click_from_error
from boxsegliver_torch.interactive.device_refine import DeviceRefiner2D
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.ops.guides import moments_from_mask
from boxsegliver_torch.ops.labeling import largest_error_click

torch.set_num_threads(2)
TINY = {"init_channels": 4, "num_down_samples": 2}


def _blob(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _error_masks(n=10, h=48, w=40):
    preds, labs = [], []
    for seed in range(n):
        rng = np.random.RandomState(seed)
        lab = _blob(h, w, 14, 25, 7) | _blob(h, w, 34, 12, 4)
        pred = _blob(h, w, 14, 23, 6) | (rng.rand(h, w) > 0.995 - 0.004 * seed)
        if seed == 3:
            pred = lab.copy()                          # no error
        if seed == 4:                                  # a band: odd core
            lab = np.zeros_like(lab)
            lab[:, :3] = True
            pred = np.zeros_like(lab)
        if seed == 5:                                  # all lesion
            lab = np.ones_like(lab)
            pred = np.zeros_like(lab)
        if seed == 6:                                  # ring: fallback
            lab = _blob(h, w, 24, 20, 12) & ~_blob(h, w, 24, 20, 8)
            pred = np.zeros_like(lab)
        preds.append(pred)
        labs.append(lab)
    return np.stack(preds), np.stack(labs)


# ---------------------------------------------------------------------------
# click placement and moments
# ---------------------------------------------------------------------------

def test_largest_error_click_matches_jax_and_host():
    pred, lab = _error_masks()
    coords, fg, has = largest_error_click(torch.from_numpy(pred),
                                          torch.from_numpy(lab))
    jc, jf, jh = jax.jit(jax.vmap(jclick))(jnp.asarray(pred),
                                            jnp.asarray(lab))
    np.testing.assert_array_equal(has.numpy(), np.asarray(jh))
    assert not has[3] and has.sum() == len(pred) - 1
    h = has.numpy()
    np.testing.assert_array_equal(coords.numpy()[h], np.asarray(jc)[h])
    np.testing.assert_array_equal(fg.numpy()[h], np.asarray(jf)[h])
    for i in np.flatnonzero(h):
        hc, hf = next_click_from_error(pred[i].astype(np.uint8),
                                       lab[i].astype(np.uint8))
        assert tuple(coords[i].tolist()) == hc and bool(fg[i]) == hf
    # leading dims are kept
    c2, f2, h2 = largest_error_click(torch.from_numpy(pred[:6]).reshape(
        2, 3, 48, 40), torch.from_numpy(lab[:6]).reshape(2, 3, 48, 40))
    assert c2.shape == (2, 3, 2) and f2.shape == h2.shape == (2, 3)
    np.testing.assert_array_equal(c2.reshape(6, 2).numpy()[h[:6]],
                                  coords.numpy()[:6][h[:6]])


@pytest.mark.parametrize("case", ["blob", "ring", "empty", "min_std"])
def test_moments_from_mask_matches_jax(case):
    mask = {"blob": _blob(30, 26, 10, 15, 6),
            "ring": _blob(30, 26, 14, 12, 9) & ~_blob(30, 26, 14, 12, 5),
            "empty": np.zeros((8, 8), bool),
            "min_std": _blob(20, 20, 9, 9, 1)}[case]
    min_std = 2.0 if case == "min_std" else 0.0
    c, s = moments_from_mask(torch.from_numpy(mask), min_std=min_std)
    jc, js = jguides.moments_from_mask(jnp.asarray(mask), min_std=min_std)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("shape", [(48, 40), (33, 27)])
def test_geodesic_eval_guide_matches_jax(shape):
    rng = np.random.RandomState(1)
    img = rng.randn(*shape).astype(np.float32)
    for clicks in ([], [(5, 7)], [(5, 7), (30, 20), (shape[0] - 1, 0)]):
        got = trefine.render_geodesic_eval_guide(img, clicks)
        want = jrefine.render_geodesic_eval_guide(img, clicks)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    got = trefine.render_geodesic_guide(img, [(3, 4)])
    np.testing.assert_allclose(got, jrefine.render_geodesic_guide(
        img, [(3, 4)]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["gaussian", "euclidean"])
def test_click_guide_matches_jax(kind):
    clicks = [(3, 4), (20, 11), (40, 30)]
    got = trefine.render_click_guide((48, 40), clicks, 5.0, kind)
    want = jrefine.render_click_guide((48, 40), clicks, 5.0, kind)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    empty = trefine.render_click_guides((48, 40), [], clicks, 5.0, kind)
    assert not empty[0].any() and empty[1].any()


# ---------------------------------------------------------------------------
# the host loop and the device refiner on a tiny fitted UNetInter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 1], ids=["gc2", "gc1"])
def fitted(request):
    """A tiny UNetInter fit by JAX on blob slices so that it responds to
    its guides (a random net ignores them), and its bridged port twin."""
    import optax

    gc = request.param
    rng = np.random.RandomState(3)
    h = w = 48
    labs, ims = [], []
    for i in range(6):
        lab = _blob(h, w, 10 + 4 * i, 12 + 3 * i, 4 + (i % 3))
        labs.append(lab)
        ims.append(lab * 1.5 + rng.randn(h, w) * 0.35)
    labs = np.asarray(labs)
    ims = np.asarray(ims, np.float32)[..., None]
    model = jbuild("UNetInter", model_kwargs=dict(TINY), num_classes=2)
    variables = model.init(jax.random.PRNGKey(0), {
        "images": ims[:1], "sp_guide": np.zeros((1, h, w, gc), np.float32)},
        train=False)
    params = variables["params"]
    guides = np.zeros((6, h, w, gc), np.float32)
    for i in range(6):
        ys, xs = np.where(labs[i])
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

    for _ in range(80):
        params, opt = step(params, opt)
    flat = {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(params), sep="/").items()}
    tmodel = tbuild("UNetInter", model_kwargs=dict(TINY, in_channels=1,
                                                   guide_channels=gc),
                    num_classes=2, dtype=torch.float32)
    tmodel.load_state_dict(flax_to_state_dict(flat), strict=True)
    tmodel.eval()

    def jpredict(feats):
        return jax.nn.softmax(model.apply({"params": params}, feats,
                                          train=False), -1)

    return gc, model, params, jpredict, tmodel, ims, labs


KINDS = ["gaussian", "euclidean", "geodesic"]


@pytest.mark.parametrize("kind", KINDS)
def test_host_loop_matches_jax(fitted, kind):
    gc, _, _, jpredict, tmodel, ims, labs = fitted
    kw = dict(dice_thresh=0.85, max_iters=5, stddev=5.0, guide_kind=kind,
              guide_channel=gc)
    want = jrefine.interactive_eval_2d(jpredict, ims, labs.astype(np.uint8),
                                       **kw)
    got = trefine.interactive_eval_2d(tcli.make_predict(tmodel), ims,
                                      labs.astype(np.uint8), **kw)
    assert got["slices"] == want["slices"] == 6
    assert got["clicks"] == want["clicks"]
    np.testing.assert_allclose(got["Dice"], want["Dice"], atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_device_refiner_matches_host_loop_and_jax(fitted, kind):
    gc, jmodel, params, jpredict, tmodel, ims, labs = fitted
    kw = dict(dice_thresh=0.85, max_iters=5, stddev=5.0, guide_kind=kind,
              guide_channel=gc)
    host = trefine.interactive_eval_2d(tcli.make_predict(tmodel), ims,
                                       labs.astype(np.uint8), **kw)
    dev = DeviceRefiner2D(tmodel, device="cpu", **kw).refine_case(ims, labs)
    from boxsegliver_tpu.train.trainer import TrainState
    from flax.core import FrozenDict
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=FrozenDict(), opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    want = JRefiner(jmodel, state, **kw).refine_case(ims, labs)
    tol = 1e-4 if kind == "geodesic" else 1e-5
    for other in (host, want):
        assert dev["slices"] == other["slices"]
        assert dev["clicks"] == other["clicks"]
        np.testing.assert_allclose(dev["Dice"], other["Dice"], atol=tol)


def test_device_refiner_without_lesions_and_guards(fitted):
    _, _, _, _, tmodel, ims, labs = fitted
    res = DeviceRefiner2D(tmodel, device="cpu").refine_case(
        ims, np.zeros_like(labs))
    assert res == {"Dice": 1.0, "clicks": 0.0, "slices": 0.0}
    with pytest.raises(ValueError):
        DeviceRefiner2D(tmodel, device="cpu", guide_kind="nope")
    with pytest.raises(TypeError, match="parallel.Group"):
        DeviceRefiner2D(tmodel, device="cpu", mesh=object())


# ---------------------------------------------------------------------------
# cli/interactive_eval against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nf_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("refine_cli") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(6, 48, 40), k_split=2,
                           modality="nf", seed=2)
    return root


def _argv(root, model_dir, *extra):
    return ["--mode", "eval", "--tag", "t_refine", "--model", "UNetInter",
            "--model_config", "UNetInter_TINY.yml", "--loss_numeric_w", "1",
            "1", "--use_spatial", "--local_enhance", "--stddev", "5.",
            "--classes", "NF", "--test_fold", "0", "--k_folds", "2",
            "--im_height", "48", "--im_width", "40", "--im_channel", "3",
            "--normalizer", "instance_norm", "--batch_size", "1",
            "--dim", "2", "--task", "nf_inter", "--dataset", "synthetic",
            "--data_root", str(root.parent), "--model_dir", str(model_dir),
            "--compute_dtype", "float32", "--max_iters", "4",
            "--num_replicas", "1", *extra]


@pytest.mark.parametrize("extra", [
    ["--device_refine", "off"],
    ["--device_refine", "on", "--guide_kind", "euclidean",
     "--guide_channel", "1"],
    ["--device_refine", "off", "--guide_kind", "geodesic"],
    ["--device_refine", "auto"],
    ["--device_refine", "on", "--num_replicas", "2", "--batch_size", "2"]],
    ids=["host_gaussian", "refiner_euclidean_gc1", "host_geodesic",
         "auto_gaussian", "refiner_gaussian_two_ranks"])
def test_cli_matches_jax(nf_set, tmp_path, extra):
    from boxsegliver_tpu.cli import interactive_eval as jcli
    from boxsegliver_tpu.cli.main import build_trainer

    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jargs = jcli.build_parser().parse_args(_argv(nf_set, jdir, *extra))
    from boxsegliver_tpu import config as jconfig
    jconfig.fill_default_args(jargs)
    trainer = build_trainer(jargs, nf_set)        # JAX's seeded init
    flat = {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(trainer.state.params), sep="/").items()}
    trainer.ckpt.close()
    tdir.mkdir()
    torch.save(flax_to_state_dict(flat), tdir / "w.pt")
    want = jcli.main(_argv(nf_set, jdir, *extra))
    got = tcli.main(_argv(nf_set, tdir, *extra, "--device", "cpu",
                          "--ckpt_path", str(tdir / "w.pt")))
    assert sorted(got) == sorted(want) == ["Dice", "clicks", "sec_per_case",
                                          "slices"]
    for k in ("Dice", "clicks", "slices"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    saved = json.loads((tdir / "eval_results_inter.txt").read_text())
    assert saved == got and want["slices"] > 0


def test_cli_refuses_3d_and_replicas(nf_set, tmp_path):
    """--dim 3 is ported (tests/test_torch_inter3d.py): it now gets as far
    as the weights, and the empty model_dir names --ckpt_path.  So do two
    replicas (ported: the refiner's two ranks start and reach the weights;
    the rank's error is raised here as it was raised there)."""
    with pytest.raises(FileNotFoundError, match="--ckpt_path"):
        tcli.main(_argv(nf_set, tmp_path, "--device", "cpu", "--dim", "3"))
    with pytest.raises(FileNotFoundError, match="--ckpt_path"):
        tcli.main(_argv(nf_set, tmp_path, "--device", "cpu",
                        "--num_replicas", "2"))


def test_auto_rule_and_slice_stacks():
    """auto takes the device refiner at every size (the card measured it
    faster than the host loop at 128^2 and 256^2); off takes the host
    loop."""
    from boxsegliver_torch.interactive.device_refine import DeviceRefiner2D

    for size, mode in (("512", "auto"), ("128", "auto"), ("512", "on")):
        args = tcli.build_parser().parse_args(
            ["--mode", "eval", "--tag", "t", "--model", "UNetInter",
             "--classes", "NF", "--im_height", size, "--im_width", size,
             "--device_refine", mode])
        assert isinstance(tcli.build_refiner(args, torch.nn.Identity(),
                                             "cpu"), DeviceRefiner2D)
    args.device_refine = "off"
    assert tcli.build_refiner(args, torch.nn.Identity(), "cpu") is None
    vol = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    st = tcli.slice_stacks(vol, 3)
    assert st.shape == (4, 3, 2, 3)
    from boxsegliver_tpu.ops.array_kits import zscore
    want = zscore(np.transpose(np.stack([vol[0], vol[0], vol[1]]),
                               (1, 2, 0)))
    np.testing.assert_array_equal(st[0], want)
    assert Path(tcli.__file__).name == "interactive_eval.py"
