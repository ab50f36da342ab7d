"""The 3-D checkpoint sweep of the port (cli/eval_all_ckpt.sweep with
``--model UNet3D``) against JAX's ``is_3d`` branch (boxsegliver_tpu/cli/
eval_all_ckpt.py:36-57): every ``ckpt_best/<tag>`` scored by
``EvaluateVolume3D.run`` over the test fold with blank click guides, on
bridged tiny-UNet3D weights (one seeded init a tag, norm offsets
randomized); per-case metrics within 1e-6 of JAX's rows (the bar of
tests/test_torch_volume3d.py); eval_sweep.txt holds one JSON line a tag."""

import json
import types

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import main as jcli
from boxsegliver_tpu.evaluators import volume3d as jvol3d
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_torch import models as tmodels
from boxsegliver_torch.cli import eval_all_ckpt
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(2)
TINY = {"init_channels": 4, "max_channels": 16, "num_pool_layers": 4}


@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep3d") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(6, 48, 48), k_split=2,
                           modality="nf", seed=2)
    return root


def _argv(root, md, *extra):
    return ["nf_3d", "--mode", "eval", "--tag", "t3d", "--model", "UNet3D",
            "--classes", "NF", "--test_fold", "0", "--k_folds", "2",
            "--im_height", "48", "--im_width", "48", "--im_channel", "1",
            "--im_depth", "-1", "--batch_size", "1", "--primary_metric",
            "NF/Dice", "--normalizer", "instance_norm", "--evaluator",
            "Volume", "--data_root", str(root.parent), "--dataset",
            root.name, "--model_dir", str(md), "--compute_dtype", "float32",
            "--metrics_eval", "Dice", "VOE", "RVD"] + list(extra)


def _weights(kw, feats, seed):
    jmodel = jbuild("UNet3D", model_kwargs=kw, num_classes=2)
    variables = jmodel.init(jax.random.PRNGKey(seed), feats)
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables)), sep="/")
    for k, v in flat.items():
        if k.endswith("/bias") or k.endswith("/scale"):
            flat[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    return jmodel, flat


@pytest.mark.parametrize("spatial", [False, True])
def test_sweep3d_rows_match_jax(nf_root, tmp_path, monkeypatch, spatial):
    orig = tmodels.load_model_config
    monkeypatch.setattr(tmodels, "load_model_config", lambda m, c=None: (
        dict(TINY) if (c or m + ".yml") == "UNet3D.yml" else orig(m, c)))
    md = tmp_path / "md"
    extra = ["--use_spatial"] if spatial else []
    argv = _argv(nf_root, md, *extra)
    ja, ta = jcli.get_args(argv), cli.get_args(argv + ["--device", "cpu"])
    kw = dict(TINY, use_spatial=spatial)
    feats = {"images": np.zeros((1, 4, 48, 48, 1), np.float32)}
    if spatial:
        feats["sp_guide"] = np.zeros((1, 4, 48, 48, 2), np.float32)
    ckpt = CheckpointManager(md)
    want = {}
    metas = cli._test_metas(ta, nf_root)
    for seed, tag in ((0, "best"), (1, "best_2"), (2, "best_4")):
        jmodel, flat = _weights(kw, feats, seed)
        ckpt.save_best({"model": flax_to_state_dict(flat)}, tag=tag)
        state = types.SimpleNamespace(params=traverse_util.unflatten_dict(
            flat, sep="/")["params"], batch_stats=None)
        jp = jvol3d.make_volume_predict(jmodel, state, ret="prob",
                                        blank_guide_channels=2 if spatial
                                        else 0)
        ev = jvol3d.EvaluateVolume3D(ja, nf_root, ["Background", "NF"])
        # JAX's sweep: ev.run(lambda f: trainer.predict(_with_blank_guide(
        # args, f)), eval_metas, cascade=None)
        want[tag] = ev.run(lambda f: jp(jcli._with_blank_guide(ja, f)),
                           metas, cascade=None)
    rows = eval_all_ckpt.sweep(ta, nf_root, torch.device("cpu"))
    assert [r["ckpt"] for r in rows] == sorted(want)
    for row in rows:
        w = want[row["ckpt"]]
        assert sorted(k for k in row if k != "ckpt") == sorted(w)
        for k in w:
            np.testing.assert_allclose(row[k], w[k], atol=1e-6,
                                       err_msg=f"{row['ckpt']} {k}")
    lines = (md / "eval_sweep.txt").read_text().splitlines()
    assert [json.loads(l)["ckpt"] for l in lines] == sorted(want)
    # the tags score differently: each restored its own weights
    assert len({round(r["NF/Dice"], 9) for r in rows}) > 1 or \
        len({round(r["NF/VOE"], 9) for r in rows}) > 1


def test_sweep3d_through_main(nf_root, tmp_path, monkeypatch):
    orig = tmodels.load_model_config
    monkeypatch.setattr(tmodels, "load_model_config", lambda m, c=None: (
        dict(TINY) if (c or m + ".yml") == "UNet3D.yml" else orig(m, c)))
    md = tmp_path / "md"
    feats = {"images": np.zeros((1, 4, 48, 48, 1), np.float32)}
    _, flat = _weights(TINY, feats, 3)
    CheckpointManager(md).save_best({"model": flax_to_state_dict(flat)})
    rows = eval_all_ckpt.main(_argv(nf_root, md, "--device", "cpu"))
    assert [r["ckpt"] for r in rows] == ["best"]
    assert {"NF/Dice", "GNFDice"} <= set(rows[0])
