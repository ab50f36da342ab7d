"""The port's 3-D click path, cascade and hybrid eval against the JAX
package on the CPU:

- ``label_components_3d`` and ``largest_error_click_3d`` on random and
  twisted volumes, batched: labels, coords, is_fg and has_error equal
  JAX's ``label_components`` / ``largest_error_click`` at rank 3 and the
  host scipy placement ``next_click_from_error``;
- ``interactive_eval_3d`` (the host loop) on a tiny UNet3D fit by JAX to
  follow its guides (bridged float32 weights), guide channels 1 and 2, TTA
  off and on: equal clicks, Dice within 1e-6; with the GT cascade channel
  on a stub model;
- ``DeviceRefiner3D`` against the port's host loop and JAX's refiner: equal
  clicks, Dice within 1e-6;
- the cascade channels (exact, EDT 1e-6), ``CascadeClick2D`` (its click
  guides by B1's plain version) and ``Cascade2D`` on a bridged tiny
  UNetInter: equal masks and channels;
- ``cli/hybrid_eval``: ``filter_tiny_nf`` equal, ``run_hybrid_eval``
  per-case results within 1e-6 with and without the frozen-2-D cascade;
- ``cli/interactive_eval --dim 3`` end to end against JAX's CLI on the
  same seeded weights."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from scipy import ndimage as ndi

import boxsegliver_tpu.models as jmodels
from boxsegliver_tpu.interactive import cascade as jcascade
from boxsegliver_tpu.interactive import refine as jrefine
from boxsegliver_tpu.interactive.device_refine import \
    DeviceRefiner3D as JRefiner3D
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.ops.labeling import label_components as jlabel
from boxsegliver_tpu.ops.labeling import largest_error_click as jclick
from boxsegliver_torch import models as tmodels
from boxsegliver_torch.cli import hybrid_eval as thybrid
from boxsegliver_torch.cli import interactive_eval as tcli
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.interactive import cascade as tcascade
from boxsegliver_torch.interactive import refine as trefine
from boxsegliver_torch.interactive.clicks import next_click_from_error
from boxsegliver_torch.interactive.device_refine import DeviceRefiner3D
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.ops.labeling import (label_components_3d,
                                            largest_error_click_3d)

torch.set_num_threads(2)
TINY3D = {"init_channels": 4, "max_channels": 16, "num_pool_layers": 4}
TINY2D = {"init_channels": 4, "num_down_samples": 2}


def _flat(params):
    return {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(params), sep="/").items()}


def _ball(shape, c, r):
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    return ((zz - c[0]) * 3) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 \
        <= r * r


def _spiral(shape):
    """A one-voxel-wide serpentine through every slice, each slice's run
    mirrored top to bottom: one twisted component that takes the fixpoint
    many passes."""
    d, h, w = shape
    m = np.zeros(shape, bool)
    rows = list(range(1, h - 1, 2))
    for i, r in enumerate(rows):
        m[:, r, 1:w - 1] = True
        if i < len(rows) - 1:
            m[:, r + 1, w - 2 if i % 2 == 0 else 1] = True
    m[1::2] = m[1::2, ::-1]
    return m


def _volumes(n=12, shape=(6, 20, 18)):
    out = []
    for seed in range(n):
        rng = np.random.RandomState(seed)
        lab = _ball(shape, (2, 6, 6), 5) | _ball(shape, (4, 14, 12), 4)
        pred = _ball(shape, (2, 7, 5), 4) | (rng.rand(*shape) > 0.99)
        if seed == 3:
            pred = lab.copy()                          # no error
        if seed == 4:
            lab, pred = _spiral(shape), np.zeros(shape, bool)
        if seed == 5:                                  # a shell: fallback
            lab = _ball(shape, (3, 10, 9), 9) & ~_ball(shape, (3, 10, 9), 6)
            pred = np.zeros(shape, bool)
        if seed >= 8:
            lab = rng.rand(*shape) < 0.4
            pred = rng.rand(*shape) < 0.3
        out.append((pred, lab))
    return out


def test_label_components_3d_matches_jax():
    jfn = jax.jit(jlabel)
    for pred, lab in _volumes():
        err = pred ^ lab
        want = np.asarray(jfn(jnp.asarray(err)))
        got = label_components_3d(torch.from_numpy(err)).numpy()
        np.testing.assert_array_equal(got, want)
    assert ndi.label(_spiral((6, 20, 18)))[1] == 1


def test_largest_error_click_3d_matches_jax_and_host():
    vols = _volumes()
    preds = torch.from_numpy(np.stack([p for p, _ in vols]))
    labs = torch.from_numpy(np.stack([lab for _, lab in vols]))
    coords, fg, has = largest_error_click_3d(preds.reshape(3, 4, 6, 20, 18),
                                             labs.reshape(3, 4, 6, 20, 18))
    coords, fg, has = (coords.reshape(12, 3), fg.reshape(12),
                       has.reshape(12))
    jfn = jax.jit(jclick)
    for i, (pred, lab) in enumerate(vols):
        jc, jf, jh = jfn(jnp.asarray(pred), jnp.asarray(lab))
        assert bool(has[i]) == bool(jh)
        host, host_fg = next_click_from_error(pred, lab)
        if not bool(jh):
            assert host is None
            continue
        assert tuple(coords[i].tolist()) == tuple(np.asarray(jc).tolist())
        assert bool(fg[i]) == bool(jf)
        assert tuple(coords[i].tolist()) == host and bool(fg[i]) == host_fg


# ---------------------------------------------------------------------------
# the host loop and the device refiner on a tiny fitted UNet3D
# ---------------------------------------------------------------------------

SHAPE = (4, 32, 32)


def _render(shape, pts, gc):
    fg = jrefine.render_click_guide(shape, pts, 5.0)
    return (np.stack([fg, np.zeros_like(fg)], -1) if gc == 2
            else fg[..., None])


@pytest.fixture(scope="module", params=[2, 1], ids=["gc2", "gc1"])
def fitted3d(request):
    """A tiny UNet3D fit by JAX on ball volumes, each guided by a click at
    one ball, so that it follows its guides, and its bridged twin."""
    import optax

    gc = request.param
    rng = np.random.RandomState(1)
    labs, ims, guides = [], [], []
    for i in range(6):
        a = _ball(SHAPE, (1 + i % 2, 8 + 2 * i, 9 + i), 6)
        b = _ball(SHAPE, (2, 24 - i, 22 - 2 * i), 5)
        lab = a if i % 2 else a | b
        labs.append(lab)
        ims.append((a | b) * 1.5 + rng.randn(*SHAPE) * 0.3)
        guides.append(_render(SHAPE, [(1 + i % 2, 8 + 2 * i, 9 + i)], gc))
    labs = np.asarray(labs)
    batch = {"images": np.asarray(ims, np.float32)[..., None],
             "sp_guide": np.asarray(guides, np.float32)}
    model = jbuild("UNet3D", model_kwargs=dict(TINY3D, use_spatial=True),
                   num_classes=2)
    params = model.init(jax.random.PRNGKey(0), batch)["params"]
    tx = optax.adam(1e-2)
    opt = tx.init(params)

    @jax.jit
    def step(p, o):
        def loss(p):
            logits = model.apply({"params": p}, batch)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labs.astype(np.int32)).mean()
        up, o = tx.update(jax.grad(loss)(p), o, p)
        return optax.apply_updates(p, up), o

    for _ in range(40):
        params, opt = step(params, opt)
    tmodel = tbuild("UNet3D", model_kwargs=dict(TINY3D, use_spatial=True,
                                                in_channels=1,
                                                sp_channels=gc),
                    num_classes=2, dtype=torch.float32)
    tmodel.load_state_dict(flax_to_state_dict(_flat(params)), strict=True)
    tmodel.eval()

    def jpredict(feats):
        return jax.nn.softmax(model.apply({"params": params}, feats), -1)

    vol = batch["images"][0, ..., 0]
    return gc, model, params, jpredict, tmodel, vol, labs[0]


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_host_loop_3d_matches_jax(fitted3d, tta):
    gc, _, _, jpredict, tmodel, vol, lab = fitted3d
    kw = dict(dice_thresh=0.95, max_iters=4, stddev=5.0, tta=tta,
              guide_channel=gc, valid_shape=(4, 30, 31))
    want = jrefine.interactive_eval_3d(jpredict, vol, lab.astype(np.uint8),
                                       **kw)
    got = trefine.interactive_eval_3d(tcli.make_predict(tmodel), vol,
                                      lab.astype(np.uint8), **kw)
    assert got["clicks"] == want["clicks"] >= 1
    np.testing.assert_allclose(got["Dice"], want["Dice"], atol=1e-6)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_device_refiner_3d_matches_host_loop_and_jax(fitted3d, tta):
    from boxsegliver_tpu.train.trainer import TrainState
    from flax.core import FrozenDict

    gc, jmodel, params, _, tmodel, vol, lab = fitted3d
    kw = dict(dice_thresh=0.95, max_iters=4, stddev=5.0, tta=tta,
              guide_channel=gc)
    host = trefine.interactive_eval_3d(tcli.make_predict(tmodel), vol,
                                       lab.astype(np.uint8),
                                       valid_shape=(4, 30, 31), **kw)
    refiner = DeviceRefiner3D(tmodel, device="cpu", **kw)
    dev = refiner.refine_case(vol, lab, valid_shape=(4, 30, 31))
    assert refiner.rounds == int(dev["clicks"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=FrozenDict(), opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    want = JRefiner3D(jmodel, state, **kw).refine_case(
        vol, lab, valid_shape=(4, 30, 31))
    for other in (host, want):
        assert dev["clicks"] == other["clicks"]
        np.testing.assert_allclose(dev["Dice"], other["Dice"], atol=1e-6)
    # no lesion: no click, the empty prediction's Dice
    empty = refiner.refine_case(vol, np.zeros_like(lab))
    assert empty == JRefiner3D(jmodel, state, **kw).refine_case(
        vol, np.zeros_like(lab))


def test_host_loop_3d_with_the_gt_cascade_channel():
    """--use_cascade on a stub model whose foreground is the cascade
    channel plus the fg guide: JAX's and the port's loops click alike."""
    lab = _ball(SHAPE, (1, 12, 12), 7) | _ball(SHAPE, (3, 24, 22), 4)
    vol = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)

    def jstub(feats):
        score = feats["images"][..., 1] * 2.0 + feats["sp_guide"][..., 0] \
            - 0.9
        return np.stack([-score, score], -1)

    def tstub(feats):
        score = feats["images"][..., 1] * 2.0 + feats["sp_guide"][..., 0] \
            - 0.9
        return torch.stack([-score, score], -1)

    for binary in (True, False):
        kw = dict(dice_thresh=0.99, max_iters=4, stddev=3.0,
                  use_cascade=True, cascade_binary=binary, guide_channel=2)
        want = jrefine.interactive_eval_3d(jstub, vol, lab.astype(np.uint8),
                                           **kw)
        got = trefine.interactive_eval_3d(tstub, vol, lab.astype(np.uint8),
                                          **kw)
        assert got["clicks"] == want["clicks"] >= 2
        np.testing.assert_allclose(got["Dice"], want["Dice"], atol=1e-6)


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------

def test_cascade_channels_match_jax():
    rng = np.random.RandomState(2)
    masks = ndi.binary_opening(rng.rand(5, 30, 28) > 0.55)
    np.testing.assert_array_equal(tcascade.inner_boundaries(masks[2]),
                                  jcascade.inner_boundaries(masks[2]))
    np.testing.assert_allclose(
        tcascade.edt_cascade_channel(masks.astype(np.uint8), [1, 3]),
        jcascade.edt_cascade_channel(masks.astype(np.uint8), [1, 3]),
        atol=1e-6)
    pts = np.array([[3, 4, 5], [1, 2, 2], [-1, -1, -1]], np.float32)
    for binary in (True, False):
        np.testing.assert_allclose(
            tcascade.gt_cascade_channel(masks, pts, binary=binary),
            jcascade.gt_cascade_channel(masks, pts, binary=binary),
            atol=1e-6)
    empty = -np.ones((2, 3), np.float32)
    assert not tcascade.gt_cascade_channel(masks, empty).any()


def _unetinter(seed=0, h=48, w=48, c=3):
    """A seeded tiny UNetInter (norm offsets randomized) in both packages."""
    jmodel = jbuild("UNetInter", model_kwargs=dict(TINY2D), num_classes=2)
    feats = {"images": np.zeros((1, h, w, c), np.float32),
             "sp_guide": np.zeros((1, h, w, 2), np.float32)}
    params = jmodel.init(jax.random.PRNGKey(seed), feats)["params"]
    flat = _flat(params)
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("/bias"):
            flat[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    params = traverse_util.unflatten_dict(
        {k[len("params/"):]: v for k, v in flat.items()}, sep="/")
    tmodel = tbuild("UNetInter", model_kwargs=dict(TINY2D, in_channels=c,
                                                   guide_channels=2),
                    num_classes=2, dtype=torch.float32).eval()
    tmodel.load_state_dict(flax_to_state_dict(flat), strict=True)

    def jpredict(feats):
        if "sp_guide" not in feats:
            feats = dict(feats, sp_guide=np.zeros(
                feats["images"].shape[:-1] + (2,), np.float32))
        return jax.nn.softmax(jmodel.apply({"params": params}, feats), -1)

    def tpredict(feats):
        if "sp_guide" not in feats:
            x = feats["images"]
            feats = dict(feats, sp_guide=torch.zeros(x.shape[:-1] + (2,)))
        with torch.no_grad():
            return torch.softmax(tmodel(feats), -1)

    return jpredict, tpredict, flat, params


def test_cascade_click2d_matches_jax():
    jpredict, tpredict, _, _ = _unetinter()
    rng = np.random.RandomState(4)
    patch = (rng.rand(5, 40, 36) * 800).astype(np.uint16)
    fg = np.array([[1, 10, 12], [1, 20, 20], [3, 30, 8], [-1, -1, -1]],
                  np.float32)
    bg = np.array([[1, 35, 30], [-1, -1, -1]], np.float32)
    j = jcascade.CascadeClick2D(jpredict, 48, 48, im_channel=3)
    t = tcascade.CascadeClick2D(tpredict, 48, 48, im_channel=3)
    for binary in (True, False):
        want = j.extra_channel_from_clicks(patch, fg, bg, binary=binary)
        got = t.extra_channel_from_clicks(patch, fg, bg, binary=binary)
        np.testing.assert_allclose(got, want, atol=1e-6)
    mask, zs = t.pred_from_clicks(patch, fg, bg)
    assert list(zs) == [1, 3] and mask.any()
    assert not t.extra_channel_from_clicks(patch, -np.ones((1, 3)),
                                           bg).any()


def test_cascade2d_matches_jax():
    jpredict, tpredict, _, _ = _unetinter(seed=1)
    vol = np.random.RandomState(5).randn(5, 48, 48).astype(np.float32)
    for mode in ("binary", "edt"):
        j = jcascade.Cascade2D(jpredict, batch_size=2, im_channel=3,
                               channel_mode=mode, tau=25.0)
        t = tcascade.Cascade2D(tpredict, batch_size=2, im_channel=3,
                               channel_mode=mode, tau=25.0)
        np.testing.assert_allclose(t.extra_channel(vol),
                                   j.extra_channel(vol), atol=1e-6)


# ---------------------------------------------------------------------------
# hybrid eval and the 3-D click eval CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("inter3d") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(5, 40, 40), k_split=2,
                           modality="nf", seed=4)
    return root


def _hybrid_argv(root, md, *extra):
    return ["nf_3d", "--mode", "eval", "--tag", "h", "--model", "UNet3D",
            "--classes", "NF", "--test_fold", "0", "--k_folds", "2",
            "--im_height", "48", "--im_width", "48", "--im_channel", "3",
            "--normalizer", "instance_norm", "--batch_size", "2",
            "--compute_dtype", "float32", "--data_root", str(root.parent),
            "--dataset", root.name, "--model_dir", str(md), *extra]


def test_filter_tiny_nf_matches_jax(nf_root):
    from boxsegliver_tpu.cli.hybrid_eval import filter_tiny_nf

    rng = np.random.RandomState(0)
    mask = (rng.rand(6, 30, 30) > 0.8).astype(np.uint8)
    mask[2, 5:12, 5:12] = 1
    np.testing.assert_array_equal(thybrid.filter_tiny_nf(mask),
                                  filter_tiny_nf(mask))


@pytest.mark.parametrize("cascade", [False, True], ids=["plain", "cascade"])
def test_hybrid_eval_matches_jax(nf_root, tmp_path, monkeypatch, cascade):
    import orbax.checkpoint as ocp

    from boxsegliver_tpu.cli import hybrid_eval as jhybrid
    from boxsegliver_tpu.cli import main as jcli

    extra = []
    if cascade:
        _, _, flat2d, params2d = _unetinter(seed=2)
        ocp.StandardCheckpointer().save((tmp_path / "j2d").resolve(),
                                        {"params": params2d})
        np.savez(tmp_path / "t2d.npz", **flat2d)
        for mod in (jmodels, tmodels):
            orig = mod.load_model_config
            monkeypatch.setattr(mod, "load_model_config",
                                lambda m, c=None, _o=orig: (
                                    dict(TINY2D) if m == "UNetInter"
                                    else _o(m, c)))
        extra = ["--use_cascade", "--eval_mirror"]
    ja = jcli.get_args(_hybrid_argv(nf_root, tmp_path / "jm", *extra))
    ta = cli.get_args(_hybrid_argv(nf_root, tmp_path / "tm", *extra)
                      + ["--device", "cpu"])
    if cascade:
        ja.ckpt_2d = str(tmp_path / "j2d")
        ta.ckpt_2d = str(tmp_path / "t2d.npz")
    ja.num_replicas = 1
    cin = 2 if cascade else 1
    feats = {"images": np.zeros((1, 6, 48, 48, cin), np.float32)}
    jmodel = jbuild("UNet3D", model_kwargs=TINY3D, num_classes=2)
    params = jmodel.init(jax.random.PRNGKey(3), feats)["params"]
    tmodel = tbuild("UNet3D", model_kwargs=dict(TINY3D, in_channels=cin),
                    num_classes=2).eval()
    tmodel.load_state_dict(flax_to_state_dict(_flat(params)), strict=True)

    def jpredict(f):
        return jax.nn.softmax(jmodel.apply({"params": params}, f), -1)

    want = jhybrid.run_hybrid_eval(
        ja, nf_root, trainer=types.SimpleNamespace(predict=jpredict))
    got = thybrid.run_hybrid_eval(ta, nf_root, model=tmodel,
                                  device=torch.device("cpu"))
    assert sorted(got) == sorted(want) and "GlobalDice" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def _ie_argv(root, md, *extra):
    return ["--mode", "eval", "--tag", "t_ie3", "--model", "UNet3D",
            "--use_spatial", "--local_enhance", "--classes", "NF",
            "--test_fold", "0", "--k_folds", "2", "--im_height", "48",
            "--im_width", "48", "--im_channel", "1", "--normalizer",
            "instance_norm", "--batch_size", "1", "--dim", "3", "--task",
            "nf", "--dataset", "synthetic", "--data_root", str(root.parent),
            "--model_dir", str(md), "--compute_dtype", "float32",
            "--max_iters", "3", "--dice_thresh", "0.99", "--num_replicas",
            "1", *extra]


@pytest.mark.parametrize("extra", [["--device_refine", "off"],
                                   ["--device_refine", "on", "--tta"]],
                         ids=["host_loop", "refiner_tta"])
def test_cli_dim3_matches_jax(nf_root, tmp_path, monkeypatch, extra):
    from boxsegliver_tpu import config as jconfig
    from boxsegliver_tpu.cli import interactive_eval as jie
    from boxsegliver_tpu.cli.main import build_trainer

    for mod in (jmodels, tmodels):
        orig = mod.load_model_config
        monkeypatch.setattr(mod, "load_model_config", lambda m, c=None,
                            _o=orig: dict(TINY3D) if m == "UNet3D"
                            else _o(m, c))
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jargs = jie.build_parser().parse_args(_ie_argv(nf_root, jdir, *extra))
    jconfig.fill_default_args(jargs)
    trainer = build_trainer(jargs, nf_root)           # JAX's seeded init
    flat = _flat(trainer.state.params)
    trainer.ckpt.close()
    tdir.mkdir()
    torch.save(flax_to_state_dict(flat), tdir / "w.pt")
    want = jie.main(_ie_argv(nf_root, jdir, *extra))
    got = tcli.main(_ie_argv(nf_root, tdir, *extra, "--device", "cpu",
                             "--ckpt_path", str(tdir / "w.pt")))
    assert sorted(got) == sorted(want) == ["Dice", "clicks", "sec_per_case"]
    for k in ("Dice", "clicks"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert json.loads((tdir / "eval_results_inter.txt").read_text()) == got
