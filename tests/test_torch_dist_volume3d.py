"""The depth-sharded whole-volume 3-D eval (``--z_shards``) on the CPU: the
port's ``make_volume_predict(group=..., z_axis_shards=2)`` with 2 gloo
ranks (spawned processes that import no JAX,
tests/test_torch_dist_workers.volume3d_rank) against the JAX package's
``make_volume_predict(mesh=make_mesh(2), z_axis_shards=2)`` on the
conftest's fake CPU devices, on a small UNet3D with 4 pools (seeded init,
norm offsets randomized so the logits have margins), both forms:
``ret="pred", in_zscore=True`` and ``ret="prob"`` on a host-normalized
volume, each with the blank click guides of ``--use_spatial``:

- probabilities within 1e-4; the argmax equal wherever the top two
  probabilities differ by more than 1e-4; every rank's output equal to
  rank 0's;
- ``EvaluateVolume3D.run``'s results and per-case metrics within 1e-6;
- a padded depth that z_shards does not divide: JAX's ``device_put``
  refuses it with ValueError, and so does the port (3 ranks, depth 8),
  while depth 6 runs on both;
- a padded depth that z_shards divides but that holds fewer whole
  multiples of ``spatial_unit`` than there are ranks (2 ranks, depth 2):
  JAX runs it, and so does the port (every rank runs the case
  unsharded), at the bars above."""

import types

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import main as jcli
from boxsegliver_tpu.data.meta import load_meta
from boxsegliver_tpu.evaluators import volume3d as jvol3d
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.parallel import make_mesh
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.ops.image_ops import zscore
from boxsegliver_torch.parallel import launch
from test_torch_dist_workers import volume3d_rank

torch.set_num_threads(2)
TINY = {"init_channels": 4, "max_channels": 16, "num_pool_layers": 4,
        "use_spatial": True}
FORMS = {"pred": dict(ret="pred", in_zscore=True, blank_guide_channels=2),
         "prob": dict(ret="prob", in_zscore=False, blank_guide_channels=2)}


@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist3d") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(6, 48, 48), k_split=2,
                           modality="nf", seed=2)
    return root


def _argv(root, md):
    return ["nf_3d", "--mode", "eval", "--tag", "t3d", "--model", "UNet3D",
            "--classes", "NF", "--test_fold", "0", "--k_folds", "2",
            "--im_height", "48", "--im_width", "48", "--im_channel", "1",
            "--im_depth", "-1", "--normalizer", "instance_norm",
            "--evaluator", "Volume", "--use_spatial", "--data_root",
            str(root.parent), "--dataset", root.name, "--model_dir", str(md),
            "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def bridged():
    """A JAX UNet3D with its seeded init, norm offsets randomized, and the
    port's state_dict of the same weights."""
    feats = {"images": np.zeros((1, 4, 48, 48, 1), np.float32),
             "sp_guide": np.zeros((1, 4, 48, 48, 2), np.float32)}
    jmodel = jbuild("UNet3D", model_kwargs=TINY, num_classes=2)
    variables = jmodel.init(jax.random.PRNGKey(0), feats)
    rng = np.random.default_rng(0)
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables)), sep="/")
    for k, v in flat.items():
        if k.endswith("/bias") or k.endswith("/scale"):
            flat[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    params = traverse_util.unflatten_dict(flat, sep="/")["params"]
    state = types.SimpleNamespace(params=params, batch_stats=None)
    return jmodel, state, flax_to_state_dict(flat)


def _volumes(root, n):
    """The first ``n`` cases' padded volumes [1, d, h, w, 1]: raw (the
    in-graph z-score's input) and host-normalized."""
    raw, norm = [], []
    for m in load_meta(root)[:n]:
        v = np.load(root / f"volume-{m['PID']}" / "volume.npy")
        v = v.astype(np.float32)[None, ..., None]
        raw.append(v)
        norm.append(zscore(torch.from_numpy(v)).numpy())
    return raw, norm


def test_z_sharded_volume_predict_matches_jax_mesh(nf_root, bridged,
                                                   tmp_path):
    jmodel, state, tstate = bridged
    raw, norm = _volumes(nf_root, 2)
    inputs = {"pred": raw, "prob": norm}
    want = {}
    for name, form in FORMS.items():
        jp = jvol3d.make_volume_predict(jmodel, state, make_mesh(2), 2,
                                        **form)
        want[name] = [np.asarray(jp({"images": v})) for v in inputs[name]]
    ja = jcli.get_args(_argv(nf_root, tmp_path / "j"))
    metas = load_meta(nf_root)
    want_res, want_pc = {}, {}
    for name, form in FORMS.items():
        jp = jvol3d.make_volume_predict(jmodel, state, make_mesh(2), 2,
                                        **form)
        ev = jvol3d.EvaluateVolume3D(ja, nf_root, ["Background", "NF"])
        want_res[name] = ev.run(jp, metas)
        want_pc[name] = {k: list(v) for k, v in ev._metric_values.items()}

    ta = cli.get_args(_argv(nf_root, tmp_path / "t") + ["--device", "cpu"])
    kw = dict(TINY, in_channels=1, sp_channels=2)
    got = {}
    for name in FORMS:
        got[name] = launch(volume3d_rank, 2, "cpu", {
            "args": vars(ta), "kw": kw, "state": tstate,
            "forms": {name: FORMS[name]}, "volumes": inputs[name],
            "ds": nf_root})
    prob = got["prob"]["outputs"]["prob"]
    for g, w in zip(prob, want["prob"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    for g, p in zip(got["pred"]["outputs"]["pred"], want["pred"]):
        assert g.dtype == np.uint8 and g.shape == p.shape
        assert (g == p).mean() > 0.99
    # the argmax of the raw volumes' forward wherever its top two are
    # apart: the prob form's forward of the same z-scored volume
    for g, w in zip(got["pred"]["outputs"]["pred"], want["prob"]):
        top2 = np.sort(w, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > 1e-4
        np.testing.assert_array_equal(g[sure], w.argmax(-1)[sure])
    for name in FORMS:
        assert got[name]["spread"] == 0.0
        res, pc = got[name]["results"][name], got[name]["per_case"][name]
        assert set(res) == set(want_res[name]) and "NF/Dice" in res
        for k, v in want_res[name].items():
            np.testing.assert_allclose(res[k], v, atol=1e-6, err_msg=k)
        assert set(pc) == set(want_pc[name])
        for k, v in want_pc[name].items():
            np.testing.assert_allclose(pc[k], v, atol=1e-6, err_msg=k)


def test_z_shards_refuse_a_depth_they_do_not_divide(nf_root, bridged,
                                                   tmp_path):
    jmodel, state, tstate = bridged
    rng = np.random.RandomState(1)
    vols = [rng.rand(1, d, 48, 48, 1).astype(np.float32) * 100
            for d in (6, 8)]
    jp = jvol3d.make_volume_predict(jmodel, state, make_mesh(3), 3,
                                    **FORMS["pred"])
    want = np.asarray(jp({"images": vols[0]}))
    with pytest.raises(ValueError, match="divisible by 3"):
        jp({"images": vols[1]})
    got = launch(volume3d_rank, 3, "cpu", {
        "args": {}, "kw": dict(TINY, in_channels=1, sp_channels=2),
        "state": tstate, "forms": {"pred": FORMS["pred"]}, "volumes": vols})
    ok, refused = got["outputs"]["pred"]
    assert got["spread"] == 0.0
    np.testing.assert_array_equal(ok, want)
    assert isinstance(refused, str) and "not divisible by z_shards=3" in \
        refused


@pytest.fixture(scope="module")
def shallow_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist3d_shallow") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(2, 48, 48), k_split=2,
                           modality="nf", seed=3)
    return root


def test_z_shards_run_a_depth_under_one_unit_a_rank(shallow_root, bridged,
                                                    tmp_path):
    """Depth 2 over 2 ranks: JAX's mesh shards it a plane a rank; the
    port's blocks come in whole multiples of spatial_unit (2), so each
    rank runs the whole case, the same forward."""
    jmodel, state, tstate = bridged
    raw, norm = _volumes(shallow_root, 2)
    assert all(v.shape[1] == 2 for v in raw)
    inputs = {"pred": raw, "prob": norm}
    ja = jcli.get_args(_argv(shallow_root, tmp_path / "j"))
    metas = load_meta(shallow_root)
    want, want_res, want_pc = {}, {}, {}
    for name, form in FORMS.items():
        jp = jvol3d.make_volume_predict(jmodel, state, make_mesh(2), 2,
                                        **form)
        want[name] = [np.asarray(jp({"images": v})) for v in inputs[name]]
        ev = jvol3d.EvaluateVolume3D(ja, shallow_root, ["Background", "NF"])
        want_res[name] = ev.run(jp, metas)
        want_pc[name] = {k: list(v) for k, v in ev._metric_values.items()}

    ta = cli.get_args(_argv(shallow_root, tmp_path / "t")
                      + ["--device", "cpu"])
    got = launch(volume3d_rank, 2, "cpu", {
        "args": vars(ta), "kw": dict(TINY, in_channels=1, sp_channels=2),
        "state": tstate, "forms": FORMS, "volumes": None,
        "inputs": inputs, "ds": shallow_root})
    assert got["spread"] == 0.0
    for g, w in zip(got["outputs"]["prob"], want["prob"]):
        assert not isinstance(g, str), g
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    for g, w in zip(got["outputs"]["pred"], want["prob"]):
        assert not isinstance(g, str), g
        top2 = np.sort(w, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > 1e-4
        np.testing.assert_array_equal(g[sure], w.argmax(-1)[sure])
    for name in FORMS:
        res, pc = got["results"][name], got["per_case"][name]
        assert set(res) == set(want_res[name]) and "NF/Dice" in res
        for k, v in want_res[name].items():
            np.testing.assert_allclose(res[k], v, atol=1e-6, err_msg=k)
        assert set(pc) == set(want_pc[name])
        for k, v in want_pc[name].items():
            np.testing.assert_allclose(pc[k], v, atol=1e-6, err_msg=k)
