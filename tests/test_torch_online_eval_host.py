"""The port's online 2-D eval (cli/main._make_online_eval) against the JAX
CLI's own eval: ``TrainSampler(ds, args, mode="eval")`` with its DEFAULT
host layout (each zoom window resized on the host, OpenCV's uint16
INTER_LINEAR for the image and INTER_NEAREST for the label, JAX
cli/main.py:366).  The port resizes with ops/image_ops.resize_linear_u16
and cv2's nearest index, without OpenCV.

- batches: every index field and the labels array-equal; images within one
  uint16 level of OpenCV (OpenCV's vector code may sum a rounding tie in
  another order), the share of values off printed under ``-s``;
- metrics on the same seeded weights within 1e-4 (the bar of
  tests/test_torch_train_cli.py::test_online_eval_matches_jax, which holds
  the device layout).
Before the port had the host layout, its eval read other pixels."""

import functools
import types

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.data import pipeline as jpipe
from boxsegliver_tpu.data.sampler import TrainSampler as JSampler
from boxsegliver_tpu.evaluators.online2d import OnlineEval2D as JOnline
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data.sampler import TrainSampler
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models.weights import flax_to_state_dict

torch.set_num_threads(2)

COMMON = ["--test_fold", "0", "--k_folds", "2", "--im_height", "48",
          "--im_width", "48", "--im_channel", "3", "--random_flip", "3",
          "--dataset", "ds", "--batch_size", "2", "--device", "cpu",
          "--compute_dtype", "float32", "--use_global_dice",
          "--metrics_eval", "Dice", "VOE", "RVD", "--mode", "train",
          "--tag", "t"]
CASES = {
    "liver_gunet": ["liver", "--model", "GUNet", "--model_config",
                    "GUNet_TINY.yml", "--classes", "Liver", "Tumor",
                    "--normalizer", "instance_norm", "--use_context",
                    "--context_list", "hist", "200", "--use_spatial",
                    "--min_std", "2", "--zoom_scale", "1.0", "1.5"],
    "nf_unet": ["nf", "--model", "UNet", "--model_config", "UNet_TINY.yml",
                "--classes", "NF", "--normalizer", "instance_norm",
                "--zscore", "--zoom_scale", "0.8", "1.3"],
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("online_host")
    make_synthetic_dataset(root / "ds", n_cases=4, shape=(8, 48, 48),
                           k_split=2, seed=1)
    make_synthetic_dataset(root / "nfds", n_cases=4, shape=(8, 48, 48),
                           k_split=2, seed=2, modality="nf")
    return root


def _args(root, case):
    argv = CASES[case] + COMMON + ["--data_root", str(root), "--model_dir",
                                   str(root / f"md_{case}")]
    args = cli.get_args(argv)
    ds = root / ("nfds" if case.startswith("nf") else "ds")
    return args, ds


def _jeval(args, ds, n):
    kw = dict(im_h=48, im_w=48, noise_scale=0.0, random_flip=0,
              use_spatial=bool(args.use_spatial), min_std=2.0)
    statics = jpipe.norm_statics(args)
    statics["use_gamma"] = False
    return JOnline(JSampler(ds, args, mode="eval"), args,
                   functools.partial(jpipe._process_batch, **kw, **statics),
                   ["Background"] + list(args.classes), num_batches=n,
                   use_global_dice=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_batches_match_jax_host_layout(root, case):
    args, ds = _args(root, case)
    jeval = _jeval(args, ds, 4)
    teval = cli._make_online_eval(args, ds, num_batches=4)
    off = total = 0
    for jb, tb in zip(jeval.batches, teval.batches):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            if k == "image":
                continue
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        diff = np.abs(tb["image"].astype(np.int64)
                      - jb["image"].astype(np.int64))
        assert diff.max() <= 1
        off += int((diff > 0).sum())
        total += diff.size
    print(f"\n{case}: {off} of {total} uint16 values one level off "
          f"OpenCV ({100.0 * off / total:.4f} %)")


def test_host_layout_sampler_draws_like_jax(root):
    args, ds = _args(root, "liver_gunet")
    for seed in (3, 4, 5):
        jb = JSampler(ds, args, mode="eval", seed=seed).sample_batch(3)
        tb = TrainSampler(ds, args, mode="eval", seed=seed,
                          resize_on_host=True).sample_batch(3)
        assert sorted(jb) == sorted(tb)
        np.testing.assert_array_equal(tb["label"], jb["label"])
        np.testing.assert_array_equal(tb["names"], jb["names"])
        assert np.abs(tb["image"].astype(np.int64)
                      - jb["image"].astype(np.int64)).max() <= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_online_eval_metrics_match_jax_host_layout(root, case):
    args, ds = _args(root, case)
    jeval = _jeval(args, ds, 3)
    teval = cli._make_online_eval(args, ds, num_batches=3)
    model_cfg = MODEL_CONFIGS[args.model_config]
    jmodel = jbuild(args.model, args=args, model_kwargs=model_cfg)
    feats = {k: jax.numpy.asarray(v[:1]) for k, v in jeval.batches[0].items()}
    fj = jax.jit(jeval.process_fn)(feats, jax.random.PRNGKey(0))[0]
    fj.pop("names")
    variables = jmodel.init(jax.random.PRNGKey(2), fj)
    rng = np.random.default_rng(0)
    flat = {}
    for coll, tree in variables.items():
        for k, v in traverse_util.flatten_dict(
                jax.tree_util.tree_map(np.asarray, dict(tree)),
                sep="/").items():
            noise = rng.normal(0, 0.05, v.shape) if coll == "params" else 0
            flat[f"{coll}/{k}"] = (v + noise).astype(np.float32)
    jvars = {coll: traverse_util.unflatten_dict(
        {k[len(coll) + 1:]: v for k, v in flat.items()
         if k.startswith(coll + "/")}, sep="/") for coll in variables}

    def jpredict(f):
        f = {k: v for k, v in f.items() if k != "names"}
        return jax.nn.softmax(jmodel.apply(jvars, f), axis=-1)

    want = jeval(types.SimpleNamespace(predict=jpredict, global_step=0,
                                       summary=None))
    model = cli._build_model(args)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    model.eval()
    trainer = types.SimpleNamespace(
        predict=lambda f: torch.softmax(model(f), dim=-1), device="cpu",
        global_step=0, summary=None)
    with torch.no_grad():
        got = teval(trainer)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
