"""The port's 3-D data path and evaluator against the JAX package on the
CPU: ``Sampler3D`` batches byte-equal for one seed (plain, click points, the
GT cascade channel, the -ds view); the device preprocess of
``data/pipeline3d.py`` against JAX ``process_train_batch_3d`` with flips and
gamma off and with JAX's draws fed to the random branches (images and
guides 1e-5 of their scale, labels exact); ``EvaluateVolume3D`` per-case
metrics equal to JAX's (1e-6) on bridged tiny UNet3D weights — the whole
volume (device z-score and argmax, and the host-normalized path) and the
sliding window (on the device and on the host); and ``nf_3d --mode train |
eval | export`` through the port's CLI on a tiny synthetic NF set: the
201_unet_v1.sh flags with --eval_per_epoch, a resume, both evals, the
bundle against the eager model and against the flax forward it replaces."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import main as jcli
from boxsegliver_tpu.data import pipeline3d as jpipe3d
from boxsegliver_tpu.data.sampler3d import Sampler3D as JSampler3D
from boxsegliver_tpu.evaluators import volume3d as jvol3d
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_torch import models as tmodels
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.cli.export import load_exported
from boxsegliver_torch.data import pipeline3d as tpipe3d
from boxsegliver_torch.data.pipeline import batch_to_device
from boxsegliver_torch.data.sampler3d import Sampler3D
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.evaluators import volume3d as tvol3d
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.train.checkpoint import CheckpointManager, load_state

torch.set_num_threads(2)
TINY = {"init_channels": 4, "max_channels": 16, "num_pool_layers": 4}


@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("nf3d") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(6, 48, 48), k_split=2,
                           modality="nf", seed=2)
    return root


def _common(root, md):
    """201_unet_v1.sh's COMMON flags at the test's size."""
    return ["--tag", "t3d", "--model", "UNet3D", "--classes", "NF",
            "--test_fold", "0", "--k_folds", "2", "--im_height", "48",
            "--im_width", "48", "--im_channel", "1", "--primary_metric",
            "NF/Dice", "--loss_weight_type", "numerical", "--loss_numeric_w",
            "1", "1", "--weight_decay_rate", "0.00003", "--learning_policy",
            "plateau", "--learning_rate", "0.0003", "--lr_end", "0.0000005",
            "--lr_decay_rate", "0.2", "--normalizer", "instance_norm",
            "--evaluator", "Volume", "--summary_prefix", "nf",
            "--data_root", str(root.parent), "--dataset", root.name,
            "--model_dir", str(md), "--compute_dtype", "float32"]


def _train_argv(root, md, *extra):
    return (["nf_3d", "--mode", "train"] + _common(root, md)
            + ["--im_depth", "4", "--random_flip", "7", "--batch_size", "2",
               "--tumor_percent", "0.75", "--log_step", "2"] + list(extra))


# ---------------------------------------------------------------------------
# Sampler3D and the device preprocess
# ---------------------------------------------------------------------------

SAMPLER_CASES = {
    "plain": [],
    "clicks": ["--use_spatial", "--local_enhance"],
    "gt_cascade": ["--use_cascade", "--cascade_binary"],
    "gt_cascade_edt": ["--use_cascade", "--use_spatial"],
    "downsampled": ["-ds", "--im_height", "24", "--im_width", "24"],
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler3d_batches_are_byte_equal(nf_root, tmp_path, case):
    argv = _train_argv(nf_root, tmp_path, *SAMPLER_CASES[case])
    ja, ta = jcli.get_args(argv), cli.get_args(argv + ["--device", "cpu"])
    assert ja.task == ta.task == "nf"
    got = Sampler3D(nf_root, ta, seed=5).sample_batch(
        4, rng=np.random.RandomState(9))
    want = JSampler3D(nf_root, ja, seed=5).sample_batch(
        4, rng=np.random.RandomState(9))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    if "--use_cascade" in argv:
        assert got["cascade"].any()


def _jax_draws(key, bs):
    """JAX _process_one_3d's draws: per-sample key → (k_flip, k_gamma);
    one coin per flip axis (width, height, depth) and augment_gamma's coin
    and two uniforms, all in [0, 1)."""
    coins, gam = [], []
    for k in jax.random.split(key, bs):
        k_flip, k_gamma = jax.random.split(k)
        coins.append([float(jax.random.uniform(f, ()))
                      for f in jax.random.split(k_flip, 3)])
        gam.append([float(jax.random.uniform(g, ()))
                    for g in jax.random.split(k_gamma, 3)])
    return {"flip": torch.tensor(coins, dtype=torch.float32),
            "gamma": torch.tensor(gam, dtype=torch.float32)}


PIPE_CASES = {
    "no_flips_no_gamma": ["--random_flip", "0"],
    "flips7_gamma": ["--gamma"],
    "gaussian_guides_gc2": ["--use_spatial", "--local_enhance", "--gamma"],
    "euclidean_guides_gc1": ["--use_spatial", "--guide_channel", "1"],
    "cascade_and_guides": ["--use_cascade", "--use_spatial",
                           "--local_enhance", "--gamma"],
}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipeline3d_matches_jax(nf_root, tmp_path, monkeypatch, case):
    argv = _train_argv(nf_root, tmp_path, *PIPE_CASES[case])
    ja, ta = jcli.get_args(argv), cli.get_args(argv + ["--device", "cpu"])
    batch = JSampler3D(nf_root, ja, seed=5).sample_batch(
        4, rng=np.random.RandomState(3))
    key = jax.random.PRNGKey(17)
    fj, lj = jax.jit(jpipe3d.make_preprocess_fn_3d(ja))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = _jax_draws(key, 4)
    monkeypatch.setattr(tpipe3d, "draw_augment_3d", lambda *a, **k: draws)
    ft, lt = tpipe3d.make_preprocess_fn_3d(ta)(
        batch_to_device(batch, "cpu"), torch.Generator())
    assert sorted(ft) == sorted(fj)
    for k in ("images", "sp_guide"):
        if k in fj:
            want = np.asarray(fj[k])
            scale = max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(ft[k].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ft["names"].numpy(), batch["names"])
    if ta.random_flip:
        assert (draws["flip"] >= 0.5).any()


# ---------------------------------------------------------------------------
# EvaluateVolume3D on bridged weights
# ---------------------------------------------------------------------------

def _bridged(kw, feats, seed=0):
    """A JAX UNet3D with its seeded init (norm offsets randomized) and the
    port's UNet3D carrying the same weights."""
    jmodel = jbuild("UNet3D", model_kwargs=kw, num_classes=2)
    variables = jmodel.init(jax.random.PRNGKey(seed), feats)
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables)), sep="/")
    for k, v in flat.items():
        if k.endswith("/bias") or k.endswith("/scale"):
            flat[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    params = traverse_util.unflatten_dict(flat, sep="/")["params"]
    state = types.SimpleNamespace(params=params, batch_stats=None)
    model = tbuild("UNet3D", model_kwargs=dict(kw, in_channels=feats[
        "images"].shape[-1], sp_channels=2), num_classes=2)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    return jmodel, state, model.eval()


EVAL_CASES = {
    # (im_depth, port predict kind, JAX predict kind)
    "whole_fast": (-1, "fast"),
    "whole_prob": (-1, "prob"),
    "sliding_device": (4, "sliding"),
    "sliding_host": (4, "host_sliding"),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_volume3d_matches_jax(nf_root, tmp_path, case):
    depth, kind = EVAL_CASES[case]
    argv = (["nf_3d", "--mode", "eval"] + _common(nf_root, tmp_path)
            + ["--im_depth", str(depth), "--batch_size", "1",
               "--use_spatial"])
    ja, ta = jcli.get_args(argv), cli.get_args(argv + ["--device", "cpu"])
    feats = {"images": np.zeros((1, 4, 48, 48, 1), np.float32),
             "sp_guide": np.zeros((1, 4, 48, 48, 2), np.float32)}
    jmodel, state, model = _bridged(dict(TINY, use_spatial=True), feats)
    patch = (4, 48, 48)
    if kind == "fast":
        jp = jvol3d.make_volume_predict(jmodel, state, ret="pred",
                                        in_zscore=True,
                                        blank_guide_channels=2)
        tp = tvol3d.make_volume_predict(model, "cpu", ret="pred",
                                        in_zscore=True,
                                        blank_guide_channels=2)
    elif kind == "sliding":
        jp = jvol3d.make_sliding_predict(jmodel, state, patch, 2,
                                         in_zscore=True,
                                         blank_guide_channels=2)
        tp = tvol3d.make_sliding_predict(model, "cpu", patch, 2,
                                         in_zscore=True,
                                         blank_guide_channels=2)
    else:                           # prob-mode whole volume or host tiles
        jp = jvol3d.make_volume_predict(jmodel, state, ret="prob",
                                        blank_guide_channels=2)
        tp = tvol3d.make_volume_predict(model, "cpu", ret="prob",
                                        blank_guide_channels=2)
    metas = cli._test_metas(ta, nf_root)
    want = jvol3d.EvaluateVolume3D(ja, nf_root, ["Background", "NF"]).run(
        jp, metas)
    ev = tvol3d.EvaluateVolume3D(ta, nf_root, ["Background", "NF"])
    got = ev.run(tp, metas)
    assert sorted(got) == sorted(want) and "NF/Dice" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    # the per-case prediction of the first case, voxel for voxel
    vol = np.load(nf_root / f"volume-{metas[0]['PID']}" / "volume.npy")
    pj = jvol3d.EvaluateVolume3D(ja, nf_root, ["Background", "NF"]
                                 ).predict_case(jp, vol)
    pt = ev.predict_case(tp, vol)
    pj = pj if pj.dtype == np.uint8 else pj.argmax(-1)
    pt = pt if pt.dtype == np.uint8 else pt.argmax(-1)
    assert pt.shape == vol.shape
    np.testing.assert_array_equal(pt, pj)


def test_tile_starts_and_padding_match_jax():
    for size, patch, step in ((24, 10, 5), (6, 4, 2), (48, 48, 24),
                              (17, 8, 4)):
        assert tvol3d._tile_starts(size, patch, step) == \
            jvol3d._tile_starts(size, patch, step)
    vol = np.arange(5 * 7 * 9, dtype=np.float32).reshape(5, 7, 9, 1)
    for a, b in zip(tvol3d.pad_to_multiple(vol, (2, 16, 16)),
                    jvol3d.pad_to_multiple(vol, (2, 16, 16))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# nf_3d through the CLI
# ---------------------------------------------------------------------------

def test_nf_3d_cli_trains_evaluates_and_exports(nf_root, tmp_path,
                                                monkeypatch):
    orig = tmodels.load_model_config
    monkeypatch.setattr(tmodels, "load_model_config", lambda m, c=None: (
        dict(TINY) if (c or m + ".yml") == "UNet3D.yml" else orig(m, c)))
    md = tmp_path / "md"
    flags = ["--device", "cpu", "--host_workers", "1", "--batches_per_epoch",
             "2", "--eval_per_epoch", "--save_best", "--save_ckpt_steps",
             "2"]
    trainer = cli.main(_train_argv(nf_root, md, "--num_of_total_steps", "2",
                                   *flags))
    assert trainer.global_step == 2
    ckpt = CheckpointManager(md)
    assert ckpt.has_best() and ckpt.latest_path() is not None
    first = load_state(ckpt.latest_path())["model"]
    trainer = cli.main(_train_argv(nf_root, md, "--num_of_total_steps", "4",
                                   *flags))
    assert trainer.global_step == 4                      # resumed at 2
    assert any(not torch.equal(first[k], v) for k, v in
               trainer.model.state_dict().items())
    with pytest.raises(SystemExit):                       # nf_3d → UNet3D
        cli.get_args(["nf_3d", "--mode", "train", "--tag", "t", "--model",
                      "UNet", "--classes", "NF"])

    ev = ["nf_3d", "--mode", "eval"] + _common(nf_root, md) + [
        "--batch_size", "1", "--device", "cpu"]
    whole = cli.main(ev + ["--im_depth", "-1"])
    sliding = cli.main(ev + ["--im_depth", "4"])
    for res in (whole, sliding):
        assert set(res) >= {"NF/Dice", "GNFDice"}
        assert 0.0 <= res["NF/Dice"] <= 1.0

    out = cli.main(["nf_3d", "--mode", "export"] + _common(nf_root, md) + [
        "--im_depth", "4", "--batch_size", "1", "--device", "cpu"])
    serve, sig = load_exported(out, device="cpu")
    assert sig["inputs"] == {"images": [[1, 4, 48, 48, 1], "float32"]}
    assert sig["model"] == "UNet3D" and sig["classes"] == ["Background", "NF"]
    x = np.random.default_rng(0).normal(size=(1, 4, 48, 48, 1)).astype(
        np.float32)
    got = serve({"images": x}).numpy()
    model = cli.build_model_from_args(cli.get_args(ev + ["--im_depth", "4"]),
                                      torch.device("cpu"))
    with torch.no_grad():
        eager = torch.softmax(model({"images": torch.from_numpy(x)}),
                              dim=-1).numpy()
    np.testing.assert_allclose(got, eager, atol=1e-6)
    # the flax forward on the bridged weights: JAX's serve function minus
    # its resize, which refuses a rank-5 volume (cli/export.Serve)
    flat = state_dict_to_flax(model)
    jmodel = jbuild("UNet3D", model_kwargs=TINY, num_classes=2)
    logits = jmodel.apply(traverse_util.unflatten_dict(flat, sep="/"),
                          {"images": x}, train=False)
    np.testing.assert_allclose(got, np.asarray(jax.nn.softmax(logits, -1)),
                               atol=1e-5)
