"""The port's own copies of the JAX package's host modules give the same
results: synthetic dataset bytes, metadata, features and prior; eval case
loading; 3D metrics and global-Dice bookkeeping; k-folds; the CLI's
device rule and its not-yet-ported branches."""

import json

import numpy as np
import pytest
import torch

from boxsegliver_tpu.data.meta import load_meta as j_load_meta
from boxsegliver_tpu.data.synthetic import make_synthetic_dataset as j_make
from boxsegliver_tpu.evaluators import eval_loader as j_loader
from boxsegliver_tpu.evaluators.base import EvaluateBase as JBase
from boxsegliver_tpu.evaluators.volume import EvaluateVolume as JEval
from boxsegliver_tpu.ops import array_kits as j_kits
from boxsegliver_tpu.ops.metrics import ConfusionMatrix as JConf
from boxsegliver_tpu.ops.metrics3d import metric_3d as j_metric_3d
from boxsegliver_torch import config as t_config
from boxsegliver_torch.cli import main as t_cli
from boxsegliver_torch.data import kfold as t_kfold
from boxsegliver_torch.data.synthetic import make_synthetic_dataset as t_make
from boxsegliver_torch.evaluators import eval_loader as t_loader
from boxsegliver_torch.evaluators.base import EvaluateBase as TBase
from boxsegliver_torch.evaluators.volume import EvaluateVolume as TEval
from boxsegliver_torch.ops import array_kits as t_kits
from boxsegliver_torch.ops.metrics import ConfusionMatrix as TConf
from boxsegliver_torch.ops.metrics3d import metric_3d as t_metric_3d


@pytest.fixture(scope="module")
def two_datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    kw = dict(n_cases=3, shape=(10, 48, 48), k_split=3, seed=11)
    return j_make(root / "jax", **kw), t_make(root / "torch", **kw)


def test_synthetic_dataset_is_identical(two_datasets):
    jroot, troot = two_datasets
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(troot) for p in troot.rglob("*")
                           if p.is_file())
    for rel in files:
        if rel.suffix == ".npy":
            np.testing.assert_array_equal(np.load(troot / rel),
                                          np.load(jroot / rel))
        else:
            assert (troot / rel).read_bytes() == (jroot / rel).read_bytes(), rel


@pytest.mark.parametrize("im_channel", [1, 3, 5])
def test_parse_case_eval_matches(two_datasets, im_channel):
    jroot, troot = two_datasets
    for meta in j_load_meta(jroot):
        a = j_loader.parse_case_eval(meta, jroot, im_channel=im_channel)
        b = t_loader.parse_case_eval(meta, troot, im_channel=im_channel)
        assert (a.crop, a.oshape, a.spacing, a.lhc, a.rhc) == \
            (b.crop, b.oshape, b.spacing, b.lhc, b.rhc)
        np.testing.assert_array_equal(a.volume, b.volume)
        np.testing.assert_array_equal(a.segmentation, b.segmentation)
        np.testing.assert_array_equal(
            j_loader.load_eval_context(jroot, a.pid, [("hist", 200)], 20.0),
            t_loader.load_eval_context(troot, b.pid, [("hist", 200)], 20.0))


def test_metrics_and_postprocess_match(two_datasets, tmp_path):
    import argparse

    rng = np.random.default_rng(0)
    a = rng.random((6, 20, 20)) > 0.6
    b = rng.random((6, 20, 20)) > 0.5
    req = ["Dice", "VOE", "RVD", "ASSD", "RMSD", "MSD"]
    assert t_metric_3d(a, b, required=req, sampling=(2.0, 0.8, 0.8)) == \
        j_metric_3d(a, b, required=req, sampling=(2.0, 0.8, 0.8))
    tc, jc = TConf(a, b), JConf(a, b)
    assert (tc.get_matrix(), tc.global_dice, tc.global_voe, tc.global_rvd) \
        == (jc.get_matrix(), jc.global_dice, jc.global_voe, jc.global_rvd)
    c, s = t_kits.compute_robust_moments(a[0], min_std=2.0)
    rc, rs = j_kits.compute_robust_moments(a[0], min_std=2.0)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(s, rs)

    args = argparse.Namespace(metrics_eval=["Dice", "VOE", "RVD"],
                              primary_metric="Tumor/Dice", task="liver",
                              model_dir=str(tmp_path))
    jroot, troot = two_datasets
    je = JEval(args, jroot, ["Background", "Liver", "Tumor"])
    te = TEval(args, troot, ["Background", "Liver", "Tumor"])
    meta = j_load_meta(jroot)[0]
    case = j_loader.parse_case_eval(meta, jroot, im_channel=3)
    probs = rng.random((case.depth, 32, 32, 3)).astype(np.float32)
    acc_j = {f"{c}_{k}": 0 for c in ("Liver", "Tumor")
             for k in ("tp", "fp", "fn")}
    acc_t = dict(acc_j)
    assert te.evaluate_case(case, probs, acc_t) == \
        je.evaluate_case(case, probs, acc_j)
    assert acc_t == acc_j
    np.testing.assert_array_equal(te.full_class_map(case, probs),
                                  je.full_class_map(case, probs))


def test_base_compare_matches():
    t = TBase(["Background", "Liver", "Tumor"], ["Dice"], "Tumor/Dice",
              "Liver/Dice")
    j = JBase(["Background", "Liver", "Tumor"], ["Dice"], "Tumor/Dice",
              "Liver/Dice")
    pairs = [({"Tumor/Dice": 0.5, "Liver/Dice": 0.9},
              {"Tumor/Dice": 0.5, "Liver/Dice": 0.8}),
             ({"Tumor/Dice": 0.4}, {"Tumor/Dice": 0.5}),
             ({"Tumor/Dice": 0.6}, {})]
    for cand, best in pairs:
        assert t.compare(cand, best, 1e-3) == j.compare(cand, best, 1e-3)


def test_kfold_copy_is_the_reference_split(tmp_path):
    from boxsegliver_tpu.data import kfold as j_kfold

    items = list(range(131))
    assert t_kfold.random_split_k_fold(items, 5, 1357) == \
        j_kfold.random_split_k_fold(items, 5, 1357)


def test_cuda_device_is_never_silently_dropped(monkeypatch):
    assert t_config.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_config.resolve_device("cuda")


@pytest.mark.parametrize("extra,what", [
    # multi-GPU training and eval are ported (tests/test_torch_dist_*.py):
    # the train case now meets JAX's batch contract, the unguided eval the
    # empty model_dir inside its two ranks; run_g over replicas names 4b
    (["--mode", "train", "--num_replicas", "2"], "--mode train"),
    (["--mode", "export", "--model", "DenseUNet", "--model_config",
      "DenseUNet_tiny.yml", "--im_height", "64", "--im_width", "64"],
     "--mode export"),
    (["--mode", "eval", "--eval_no_sp", "--num_replicas", "2"], "unguided"),
    (["--mode", "eval", "--device_sweep", "off"], "host loop"),
    # eval restores from --model_dir now; an empty one names --ckpt_path
    (["--mode", "eval"], "--ckpt_path"),
    (["--mode", "eval", "--num_replicas", "2"], "item 4b"),
])
def test_cli_unported_branches_raise(tmp_path, two_datasets, extra, what):
    _, troot = two_datasets
    argv = ["liver", "--tag", "t", "--model", "GUNet", "--classes", "Liver",
            "Tumor", "--use_spatial", "--device", "cpu",
            "--data_root", str(troot.parent), "--dataset", troot.name,
            "--model_dir", str(tmp_path)] + extra
    if what == "host loop":
        # the host loop is ported: --device_sweep off now gets as far as the
        # weights, and the empty model_dir names --ckpt_path
        what = "--ckpt_path"
    if what == "--mode train":
        # a global batch of 3 does not divide 2 ranks: JAX's error, raised
        # before any rank starts
        with pytest.raises(ValueError, match="try --batch_size=2"):
            t_cli.main(argv + ["--batch_size", "3"])
        return
    if what == "unguided":
        # the two ranks start and reach the weights: the empty model_dir
        # names --ckpt_path, raised here as the rank raised it
        what = "--ckpt_path"
    if what == "--mode export":
        # export is ported, and since the DenseUNet slice every config is
        # carried: DenseUNet_tiny.yml exports its seeded init
        out = t_cli.main(argv)
        sig = json.loads((out / "signature.json").read_text())
        assert sig["model"] == "DenseUNet"
        assert sig["inputs"]["images"][0][1:] == [64, 64, 3]
        return
    error = FileNotFoundError if what == "--ckpt_path" else NotImplementedError
    with pytest.raises(error, match=what):
        t_cli.main(argv)


def test_cli_eval_and_infer_on_cpu(tmp_path, two_datasets, monkeypatch):
    """--mode eval scores the test fold through run_g; --mode infer writes
    one NIfTI class map per case at the original case shape."""
    from boxsegliver_torch import models
    from boxsegliver_torch.data import nii

    _, troot = two_datasets
    tiny = {"init_channels": 4, "num_down_samples": 2, "mod_layers": [1, 2]}
    monkeypatch.setitem(models.MODEL_CONFIGS, "tiny.yml", tiny)
    argv = ["liver", "--tag", "t", "--model", "GUNet", "--model_config",
            "tiny.yml", "--classes", "Liver", "Tumor", "--use_spatial",
            "--device", "cpu", "--compute_dtype", "float32",
            "--im_height", "32", "--im_width", "32", "--eval_mirror",
            "--data_root", str(troot.parent), "--dataset", troot.name,
            "--k_folds", "3", "--test_fold", "1",
            "--ckpt_path", str(tmp_path / "w.pt"),
            "--model_dir", str(tmp_path)]
    model = models.build_model("GUNet",
                               args=t_cli.get_args(argv + ["--mode", "eval"]),
                               model_kwargs=tiny)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():                  # Liver everywhere: no overflow
        model.AdjustChannels.weight.mul_(1e-3)
        model.AdjustChannels.bias.copy_(torch.tensor([0.0, 8.0, 0.0]))
    torch.save(model.state_dict(), tmp_path / "w.pt")

    res = t_cli.main(argv + ["--mode", "eval"])
    assert res["Tumor/Dice"] == 0.0 and 0.0 < res["Liver/Dice"] <= 1.0
    assert json.loads((tmp_path / "eval_results_3d.txt").read_text()) == \
        pytest.approx(res)
    t_cli.main(argv + ["--mode", "infer", "--save_path", "pred"])
    saved = sorted((tmp_path / "pred").glob("predict-*.nii.gz"))
    assert saved
    meta = {m["PID"]: m for m in j_load_meta(troot)}
    for p in saved:
        pid = int(p.name.split("-")[1].split(".")[0])
        _, arr = nii.read_nii(p)
        assert arr.shape == tuple(meta[pid]["size"])
        assert set(np.unique(arr)) <= {0, 1}
