"""The nf2 / IIN per-lesion patch eval, infer and export of the port
against the JAX package on the CPU, on bridged GUNet_IIN_TINY weights:

- the helpers (expand_bbox, lesion_centers, _normalize, _context_pyramid)
  equal to JAX's (the pyramid within 1e-5: OpenCV's float resize may fuse a
  product, a few ulp);
- the guides: B1's plain version over the batch's largest box, cropped and
  resized, against the port's numpy create_gaussian_distribution_v2 and
  JAX's OpenCV path (1e-6);
- IinPatchLoader batches against JAX's (features 1e-5, sid / bb / pads
  equal);
- ``EvaluateVolume.run_patch`` with and without mirror TTA: per-case
  metrics 1e-6, the merged probability volume of one case 1e-5;
- ``infer_patch_features`` / ``run_patch_infer``: the npz's keys and arrays
  (1e-5);
- the nf2 export: the bundle against JAX's bundle on the same weights
  (1e-5) and the signature equal;
- ``nf2 --mode train`` then ``--mode eval | infer | export`` through
  cli.main on ``--device cpu``."""

import json
import types

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import main as jcli
from boxsegliver_tpu.cli.export import export_model as jexport_model
from boxsegliver_tpu.cli.export import load_exported as jload_exported
from boxsegliver_tpu.evaluators import iin_eval as jie
from boxsegliver_tpu.evaluators.volume import EvaluateVolume as JEval
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.ops import array_kits as jkits
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.cli.export import export_model, load_exported
from boxsegliver_torch.data.meta import load_meta
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.evaluators import iin_eval as tie
from boxsegliver_torch.evaluators.volume import EvaluateVolume
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.ops import array_kits as tkits
from boxsegliver_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(2)
SIZE = 48


@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("iin_eval") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(10, 80, 72), k_split=2,
                           modality="nf", seed=7)
    return root


def _argv(root, md, mode="eval", *extra):
    return ["nf2", "--mode", mode, "--tag", "t_iin", "--model", "GUNet",
            "--model_config", "GUNet_IIN_TINY.yml", "--classes", "NF",
            "--im_height", str(SIZE), "--im_width", str(SIZE),
            "--im_channel", "3", "--batch_size", "3", "--use_context",
            "--ct_base", "32", "--use_spatial", "--spatial_random", "1.0",
            "--guide_scale", "5", "--min_std", "2", "--zscore",
            "--normalizer", "instance_norm", "--random_flip", "3",
            "--test_fold", "0", "--k_folds", "2", "--compute_dtype",
            "float32", "--metrics_eval", "Dice", "VOE", "RVD",
            "--primary_metric", "NF/Dice", "--data_root", str(root.parent),
            "--dataset", root.name, "--model_dir", str(md)] + list(extra)


def _both(root, md, mode="eval", *extra):
    argv = _argv(root, md, mode, *extra)
    ja = jcli.get_args(argv)
    ja.num_replicas = 1
    return ja, cli.get_args(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def weights(nf_root):
    """(flax module, flat params, params tree): a seeded GUNet_IIN_TINY init
    with its biases spread, so that the patches predict both classes."""
    ja, _ = _both(nf_root, nf_root.parent / "w")
    feats = {k: np.asarray(v) for k, v in
             jcli.build_feature_template(ja).items()}
    jmodel = jbuild("GUNet", args=ja,
                    model_kwargs=MODEL_CONFIGS["GUNet_IIN_TINY.yml"])
    variables = jmodel.init(jax.random.PRNGKey(4), feats, train=False)
    flat = {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(variables["params"]), sep="/").items()}
    rng = np.random.default_rng(4)
    for k in flat:
        if k.endswith("/bias"):
            flat[k] = rng.normal(0, 0.3, flat[k].shape).astype(np.float32)
    params = traverse_util.unflatten_dict(
        {k[len("params/"):]: v for k, v in flat.items()}, sep="/")
    return jmodel, flat, params


def _port_model(args, flat):
    model = cli._build_model(args)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    return model.eval()


def _jpredict(jmodel, params):
    def predict(f):
        f = {k: v for k, v in f.items() if k != "names"}
        return jax.nn.softmax(jmodel.apply({"params": params}, f), -1)
    return predict


# ---------------------------------------------------------------------------
# helpers and guides
# ---------------------------------------------------------------------------

def test_helpers_match_jax(nf_root):
    for bb, size, target in (((3, 4, 9, 20), (80, 72), (48, 48)),
                             ((70, 60, 79, 71), (80, 72), (48, 48)),
                             ((0, 0, 60, 70), (80, 72), (32, 40)),
                             ((5, 5, 10, 10), (30, 30), (48, 48))):
        assert tie.expand_bbox(bb, size, target) == \
            jie.expand_bbox(bb, size, target)
    rng = np.random.RandomState(0)
    plane = np.zeros((40, 40), np.uint8)
    plane[5:12, 5:12] = 1
    plane[20:30, 25:33] = 1
    for center, bb in (((8, 8), (5, 5, 12, 12)), ((15, 15), (5, 5, 30, 33)),
                       ((2, 2), (5, 5, 12, 12)), ((38, 1), (35, 0, 40, 3))):
        np.testing.assert_array_equal(
            tie.lesion_centers(plane, center, bb),
            jie.lesion_centers(plane, center, bb))
    img = rng.randint(0, 5000, (50, 60, 3)).astype(np.float32)
    for z in (True, False):
        np.testing.assert_allclose(tie._normalize(img, z),
                                   jie._normalize(img, z), rtol=1e-6)
    norm = tie._normalize(img, True)
    centers = np.array([[10, 12], [30, 40], [25, 20]], np.float32)
    for sizes in ((32, 64, 128), (16, 24, 40)):
        np.testing.assert_allclose(
            tie._context_pyramid(norm, centers, sizes, 3),
            jie._context_pyramid(norm, centers, sizes, 3), atol=1e-5)


def test_b1_guides_match_numpy_and_jax():
    import cv2

    rng = np.random.RandomState(3)
    sizes = [(48, 48), (61, 50), (48, 77), (90, 64)]
    centers = [rng.uniform(0, s[0] - 1, (n, 2)).astype(np.float32)
               for s, n in zip(sizes, (1, 3, 2, 1))]
    got = tie.render_guides(centers, sizes, 5.0, (SIZE, SIZE))
    for c, s, g in zip(centers, sizes, got):
        stds = np.full(c.shape, 5.0, np.float32)
        ours = tkits.create_gaussian_distribution_v2(s, c, stds)
        ref = jkits.create_gaussian_distribution_v2(s, c, stds)
        np.testing.assert_allclose(ours, ref, atol=1e-7)
        if s != (SIZE, SIZE):
            ref = cv2.resize(ref, (SIZE, SIZE),
                             interpolation=cv2.INTER_LINEAR)
        assert g.shape == (SIZE, SIZE)
        np.testing.assert_allclose(g, ref, atol=1e-6)


def test_patch_loader_batches_match_jax(nf_root, tmp_path):
    ja, ta = _both(nf_root, tmp_path)
    metas = cli._test_metas(ta, nf_root)
    n_items = 0
    for meta in metas:
        jl = jie.IinPatchLoader(meta, nf_root, ja)
        tl = tie.IinPatchLoader(meta, nf_root, ta)
        assert tl.items and len(tl.items) == len(jl.items)
        n_items += len(tl.items)
        jb, tb = list(jl.batches(3)), list(tl.batches(3))
        assert len(jb) == len(tb)
        for j, t in zip(jb, tb):
            assert sorted(j) == sorted(t)
            assert j["pads"] == t["pads"]
            for k in ("sid", "bb"):
                np.testing.assert_array_equal(t[k], j[k])
            for k in ("images", "sp_guide", "context"):
                np.testing.assert_allclose(t[k], j[k], atol=1e-5, err_msg=k)
    assert n_items > 3


# ---------------------------------------------------------------------------
# run_patch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mirror", [False, True], ids=["plain", "mirror"])
def test_run_patch_matches_jax(nf_root, tmp_path, weights, mirror):
    jmodel, flat, params = weights
    extra = ["--eval_mirror"] if mirror else []
    ja, ta = _both(nf_root, tmp_path, "eval", *extra)
    model = _port_model(ta, flat)
    if mirror:
        jp = jie.make_patch_predict_tta(
            jmodel, types.SimpleNamespace(params=params, batch_stats=None),
            3)
    else:
        jp = _jpredict(jmodel, params)
    tp = tie.make_patch_predict(model, "cpu", 3, mirror=mirror)
    metas = cli._test_metas(ta, nf_root)
    jev = JEval(ja, nf_root, ["Background", "NF"])
    tev = EvaluateVolume(ta, nf_root, ["Background", "NF"])
    want = jev.run_patch(jp, metas)
    got = tev.run_patch(tp, metas)
    assert sorted(got) == sorted(want) and "NF/Dice" in got
    assert 0.0 < got["NF/Dice"] < 1.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert sorted(tev._metric_values) == sorted(jev._metric_values)
    for k, v in jev._metric_values.items():         # case by case
        np.testing.assert_allclose(tev._metric_values[k], v, atol=1e-6,
                                   err_msg=k)
    # the merged probability volume of the first case
    meta = metas[0]
    jl = jie.IinPatchLoader(meta, nf_root, ja)
    tl = tie.IinPatchLoader(meta, nf_root, ta)
    vols = []
    for loader, mod, pred in ((jl, jie, jp), (tl, tie, tp)):
        d, h, w = loader.volume.shape
        vol = np.zeros((d, h, w, 2), np.float32)
        vol[..., 0] = 1.0
        for b in loader.batches(3):
            probs = (jie.predict_batch_tta(pred, b, jev.mirror_div, 3)
                     if mod is jie else pred(b).numpy())
            mod.merge_patch_probs(vol, probs, b["sid"], b["bb"], b["pads"])
        vols.append(vol)
    np.testing.assert_allclose(vols[1], vols[0], atol=1e-5)
    assert (vols[1][..., 0] < 1).any() and vols[1][..., 1].max() > 0.1


def test_infer_patch_matches_jax(nf_root, tmp_path, weights):
    jmodel, flat, params = weights
    ja, ta = _both(nf_root, tmp_path / "j", "infer")
    _, ta = _both(nf_root, tmp_path / "t", "infer")
    meta = load_meta(nf_root)[1]
    for pos in ((4, 30, 30), (0, 3, 70), (9, 79, 0)):
        want = jie.infer_patch_features(meta, nf_root, ja, pos)
        got = tie.infer_patch_features(meta, nf_root, ta, pos)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["bb"], want["bb"])
        for k in ("images", "sp_guide", "context"):
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)
    ja.pos = ta.pos = [4, 30, 30]
    jout = jie.run_patch_infer(_jpredict(jmodel, params), meta, nf_root, ja)
    tout = tie.run_patch_infer(
        tie.make_patch_predict(_port_model(ta, flat), "cpu"), meta,
        nf_root, ta)
    assert tout.name == jout.name == "infer-volume-1-Pos-4-30-30.npz"
    with np.load(jout) as j, np.load(tout) as t:
        assert sorted(t.files) == sorted(j.files) == ["bb", "ct", "img",
                                                      "prob", "sp"]
        for k in j.files:
            np.testing.assert_allclose(t[k], j[k], atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_nf2_export_matches_jax_bundle(nf_root, tmp_path):
    ja, _ = _both(nf_root, tmp_path / "m", "export")
    jdir = jexport_model(ja, nf_root, out_dir=tmp_path / "jax")
    trainer = jcli.build_trainer(ja, nf_root)
    flat = {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(jax.tree_util.tree_map(
                np.asarray, dict(trainer.state.params)), sep="/").items()}
    trainer.ckpt.close()
    ckpt = tmp_path / "bridged.pt"
    torch.save({"model": flax_to_state_dict(flat)}, ckpt)
    _, ta = _both(nf_root, tmp_path / "m", "export", "--ckpt_path",
                  str(ckpt))
    pdir = export_model(ta, out_dir=tmp_path / "port")
    assert (json.loads((pdir / "signature.json").read_text())
            == json.loads((jdir / "signature.json").read_text()))
    sig = json.loads((pdir / "signature.json").read_text())
    assert sig["inputs"]["context"] == [[3, 32, 32, 3], "float32"]
    jserve, _ = jload_exported(jdir)
    serve, _ = load_exported(pdir, "cpu")
    rng = np.random.RandomState(2)
    feats = {k: rng.rand(*shape).astype(dtype)
             for k, (shape, dtype) in sig["inputs"].items()}
    want = np.asarray(jserve(feats))
    got = serve(feats).numpy()
    assert got.shape == want.shape == (3, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    program = torch.export.load(pdir / "model.pt2")
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and n.target in (torch.ops.boxseg.in_relu_fwd.default,
                              torch.ops.boxseg.in_relu_nhwc_fwd.default)]
    assert len(nodes) == 6        # level 0 (2) and the decoder (4)


# ---------------------------------------------------------------------------
# the nf2 CLI
# ---------------------------------------------------------------------------

def test_nf2_cli_trains_evaluates_infers_and_exports(nf_root, tmp_path):
    md = tmp_path / "md"
    train = (_argv(nf_root, md, "train")[:-6]
             + ["--data_root", str(nf_root.parent), "--dataset",
                nf_root.name, "--model_dir", str(md), "--device", "cpu",
                "--noise_scale", "0.1", "--gamma", "--zoom_scale", "1.0",
                "1.25", "--num_of_total_steps", "4", "--batches_per_epoch",
                "2", "--eval_per_epoch", "--save_best", "--host_workers",
                "1", "--eval_num_batches_per_epoch", "2", "--log_step", "2"])
    trainer = cli.main(train)
    assert trainer.global_step == 4
    assert CheckpointManager(md).has_best()
    ev = _argv(nf_root, md, "eval") + ["--device", "cpu"]
    res = cli.main(ev + ["--eval_mirror"])
    assert {"NF/Dice", "NF/VOE", "NF/RVD", "GNFDice"} <= set(res)
    assert json.loads((md / "eval_results_3d.txt").read_text()).keys() == \
        res.keys()
    out = cli.main(_argv(nf_root, md, "infer") + [
        "--device", "cpu", "--case_id", "1", "--pos", "3", "40", "30"])
    with np.load(out["infer_path"]) as f:
        assert f["prob"].shape == (SIZE, SIZE, 2)
    with pytest.raises(SystemExit, match="--pos"):
        cli.main(_argv(nf_root, md, "infer") + ["--device", "cpu",
                                               "--case_id", "1"])
    # infer without --case_id: run_patch saves each test case's class map
    cli.main(_argv(nf_root, md, "infer") + ["--device", "cpu"])
    pids = [m["PID"] for m in cli._test_metas(cli.get_args(ev), nf_root)]
    assert sorted(p.name for p in (md / "prediction").iterdir()) == sorted(
        f"predict-{p}.nii.gz" for p in pids)
    bundle = cli.main(_argv(nf_root, md, "export") + ["--device", "cpu"])
    serve, sig = load_exported(bundle, "cpu")
    assert sorted(sig["inputs"]) == ["context", "images", "sp_guide"]
