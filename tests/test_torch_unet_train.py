"""The port's UNet / batch-norm training against the JAX package's on the
CPU: one whole train step against JAX ``make_train_step`` (UNet_TINY with
batch norm and with instance norm, and GUNet_TINY with batch norm; float32,
numerical loss weights, L2 1e-3, plateau learning rate): total and data
loss within 1e-5 relative, gradients within 1e-4, parameters and running
statistics after 3 Momentum steps within 1e-5 (an Adam step is
lr·g/(|g| + eps): a gradient element within round-off of 0 moves by ±lr in
either package, so the parameter check uses Momentum, whose update is the
gradient's arithmetic; Adam itself is held against optax in
tests/test_torch_train.py); the unguided, context-free preprocess at the
``001_unet.sh`` and ``bench.py`` flags (with and without the device cache)
against JAX ``make_preprocess_fn`` with JAX's draws (images within 1e-5,
labels exact); and the ``001_unet.sh`` CLI on a tiny set with --device cpu:
train with the inline --eval_3d eval, resume, --mode eval, eval_all_ckpt."""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu import config as jconfig
from boxsegliver_tpu.data import pipeline as jpipe
from boxsegliver_tpu.data.sampler import TrainSampler as JSampler
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import create_train_state
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.train.trainer import make_train_step
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.cli import eval_all_ckpt
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data import pipeline as tpipe
from boxsegliver_torch.data.device_cache import DeviceVolumeCache, widen
from boxsegliver_torch.data.sampler import TrainSampler
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.train.checkpoint import (CheckpointManager, load_state,
                                                warm_start)
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)
CLASSES = ["Background", "Liver", "Tumor"]
STEP_FLAGS = ["--mode", "train", "--tag", "t", "--classes", "Liver", "Tumor",
              "--compute_dtype", "float32", "--loss_weight_type",
              "numerical", "--loss_numeric_w", "0.2", "0.4", "4.4",
              "--weight_decay_rate", "0.001", "--learning_policy", "plateau",
              "--learning_rate", "0.001", "--lr_end", "0.0000005",
              "--log_step", "1", "--optimizer", "Momentum"]
STEP_CASES = {
    "unet_batch_norm": ("UNet", "UNet_TINY.yml", ["--normalizer",
                                                  "batch_norm"]),
    "unet_instance_norm": ("UNet", "UNet_TINY.yml", ["--normalizer",
                                                     "instance_norm"]),
    "gunet_batch_norm": ("GUNet", "GUNet_TINY.yml",
                         ["--normalizer", "batch_norm", "--use_context",
                          "--context_list", "hist", "16", "--use_spatial",
                          "--side_dropout", "0"]),
}


def _args(argv):
    parser = jconfig.build_parser()
    a = parser.parse_args(argv)
    jconfig.check_args(a, parser)
    t = tconfig.build_parser().parse_args(argv)
    tconfig.check_args(t, parser)
    return a, t


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.tree_util.tree_map(
                np.asarray, dict(tree)), sep="/").items()}


# ---------------------------------------------------------------------------
# one whole train step against JAX make_train_step
# ---------------------------------------------------------------------------

def _away_from_kinks(params):
    """The flax init with every norm offset and transpose-conv bias at 3, so
    that the ReLUs' inputs sit away from 0.  The two packages' float32
    forwards differ by ~1e-6 (summation order); a pre-activation within that
    of 0 passes its gradient in one package and blocks it in the other, and
    a few such pixels in ~10^5 move whole kernels' gradients by percents."""
    flat = traverse_util.flatten_dict(dict(params), sep="/")
    for k, v in flat.items():
        if k.endswith(("Norm_0/bias", "ConvTranspose_0/bias")):
            flat[k] = jnp.full_like(v, 3.0)
    return traverse_util.unflatten_dict(flat, sep="/")

@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(tmp_path, case):
    model_name, config, extra = STEP_CASES[case]
    ja, ta = _args(STEP_FLAGS + ["--model", model_name] + extra
                   + ["--model_dir", str(tmp_path)])
    kw = MODEL_CONFIGS[config]
    rng = np.random.default_rng(0)
    feats = {"images": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)}
    if model_name == "GUNet":
        feats["sp_guide"] = rng.uniform(0.5, 1.0, (2, 32, 32, 1)
                                        ).astype(np.float32)
        feats["context"] = rng.normal(size=(2, 16)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 32, 32)).astype(np.int32)

    jmodel = jbuild(model_name, args=ja, model_kwargs=kw, dtype=jnp.float32)
    solver = Solver(ja)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    state = state.replace(params=_away_from_kinks(state.params))
    flat0 = _flat(state.params, "params")
    if state.batch_stats:
        flat0.update(_flat(state.batch_stats, "batch_stats"))
    assert bool(state.batch_stats) == ("batch_norm" in case)

    model = tbuild(model_name, args=ta, model_kwargs=kw, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)
    ft = {k: torch.from_numpy(v) for k, v in feats.items()}
    lt = torch.from_numpy(labels).long()
    trainer = Trainer(model, ta, CLASSES, "cpu",
                      preprocess_fn=lambda batch, gen: (ft, lt))

    # gradients of the total loss, mapped through the bridge's layouts
    jloss = jmake_loss_fn(ja, CLASSES)
    key = jax.random.PRNGKey(1)

    def total(p):
        variables = {"params": p}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
            logits, _ = jmodel.apply(variables, feats, train=True,
                                     rngs={"dropout": key},
                                     mutable=["batch_stats"])
        else:
            logits = jmodel.apply(variables, feats, train=True,
                                  rngs={"dropout": key})
        return jloss(logits, labels, p)

    (jt, jd), jg = jax.value_and_grad(total, has_aux=True)(state.params)
    grads, tt, td, _ = trainer.gradients(ft, lt)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    tg = state_dict_to_flax(model, dict(zip(trainer.param_names, grads)))
    jgf = _flat(jg, "params")
    assert set(tg) == set(jgf)
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    # the gradient check ran one train-mode forward: start the steps from
    # the same running statistics as JAX
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)

    step_fn = jax.jit(make_train_step(jmodel, solver, ja, CLASSES))
    raw = {"names": np.zeros((2,), np.int32)}
    for _ in range(3):
        state, jm = step_fn(state, feats, labels, key)
        vals, lr = trainer.train_step(raw)
        np.testing.assert_allclose(float(vals[0]), float(jm["total_loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(lr, float(jm["learning_rate"]), rtol=1e-7)
    assert trainer.global_step == 3
    got = state_dict_to_flax(model)
    want = _flat(state.params, "params")
    if state.batch_stats:
        want.update(_flat(state.batch_stats, "batch_stats"))
        moved = [k for k in want if k.startswith("batch_stats/")
                 and not np.allclose(want[k], flat0[k])]
        assert moved                      # three steps moved the statistics
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
    # predict normalizes with the running statistics (eval mode)
    with torch.no_grad():
        probs = trainer.predict(feats)
        ref = torch.softmax(model(ft, train=False), dim=-1)
    assert torch.equal(probs, ref)


# ---------------------------------------------------------------------------
# the unguided, context-free preprocess
# ---------------------------------------------------------------------------

UNET_TRAIN = ["liver", "--mode", "train", "--tag", "t", "--model", "UNet",
              "--classes", "Liver", "Tumor", "--test_fold", "0", "--k_folds",
              "2", "--im_height", "48", "--im_width", "40", "--im_channel",
              "3", "--random_flip", "3", "--batch_size", "4"]


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("unet_train") / "ds"
    make_synthetic_dataset(root, n_cases=4, shape=(8, 48, 48), k_split=2,
                           seed=2)
    return root


def _jax_draws(key, bs, shape):
    """The draws JAX makes inside _process_batch: per-sample key → (noise,
    flip, gamma) keys; noise uniform(-1, 1) of the image shape; one coin per
    flip axis."""
    noise, coins = [], []
    for k in jax.random.split(key, bs):
        k_noise, k_flip, _ = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.uniform(
            k_noise, shape, minval=-1.0, maxval=1.0)))
        coins.append([float(jax.random.uniform(f, ()))
                      for f in jax.random.split(k_flip, 3)])
    return {"noise": torch.from_numpy(np.stack(noise)),
            "flip": torch.tensor(coins, dtype=torch.float32)}


@pytest.mark.parametrize("noise", ["0.05", "0.1"])       # 001_unet, bench.py
@pytest.mark.parametrize("layout", ["window", "device_cache"])
def test_unguided_preprocess_matches_jax(ds, monkeypatch, noise, layout):
    args = cli.get_args(UNET_TRAIN + ["--noise_scale", noise, "--data_root",
                                      str(ds.parent), "--dataset", ds.name,
                                      "--model_dir", str(ds / "md")])
    assert not args.use_spatial and not args.use_context
    cache = jcache = zbase = None
    if layout == "device_cache":
        train_pids, _ = cli._split_pids(args, ds)
        cache = DeviceVolumeCache(ds, [int(p) for p in train_pids], "cpu")
        zbase = cache.zbase
        jcache = types.SimpleNamespace(
            volume=jnp.asarray(widen(cache.volume).numpy().astype(np.uint16)),
            label=jnp.asarray(cache.label.numpy()))
    kw = dict(mode="train", seed=5, zbase=zbase)
    batch = TrainSampler(ds, args, **kw).sample_batch(
        4, rng=np.random.RandomState(3))
    jbatch = JSampler(ds, args, resize_on_host=False, **kw).sample_batch(
        4, rng=np.random.RandomState(3))
    assert sorted(batch) == sorted(jbatch)
    assert "context" not in batch and "centers" not in batch
    key = jax.random.PRNGKey(9)
    fj, lj = jax.jit(jpipe.make_preprocess_fn(args, cache=jcache))(
        {k: jnp.asarray(v) for k, v in jbatch.items()}, key)
    draws = _jax_draws(key, 4, (48, 40, 3))
    monkeypatch.setattr(tpipe.image_ops, "draw_augment",
                        lambda *a, **k: draws)
    ft, lt = tpipe.make_preprocess_fn(args, cache=cache)(
        tpipe.batch_to_device(batch, "cpu"), torch.Generator())
    assert sorted(ft) == sorted(fj) == ["images", "names"]
    assert ft["images"].shape == (4, 48, 40, 3) and lt.dtype == torch.int64
    np.testing.assert_allclose(ft["images"].numpy(), np.asarray(fj["images"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


# ---------------------------------------------------------------------------
# the 001_unet.sh CLI on the CPU
# ---------------------------------------------------------------------------

# run_scripts/template/001_unet.sh train flags at a tiny size
CLI_TRAIN = ["liver", "--mode", "train", "--tag", "001_unet", "--model",
             "UNet", "--classes", "Liver", "Tumor", "--test_fold", "0",
             "--k_folds", "2", "--im_height", "48", "--im_width", "48",
             "--im_channel", "3", "--random_flip", "3", "--num_replicas",
             "0", "--dataset", "ds", "--noise_scale", "0.05",
             "--primary_metric", "Tumor/Dice", "--secondary_metric",
             "Liver/Dice", "--loss_weight_type", "numerical",
             "--loss_numeric_w", "0.2", "0.4", "4.4", "--batches_per_epoch",
             "3", "--batch_size", "2", "--weight_decay_rate", "0.000001",
             "--learning_policy", "plateau", "--learning_rate", "0.001",
             "--lr_end", "0.0000005", "--lr_decay_rate", "0.2",
             "--eval_num_batches_per_epoch", "2", "--eval_per_epoch",
             "--evaluator", "Volume", "--save_best", "--device", "cpu",
             "--model_config", "UNet_TINY.yml", "--log_step", "2",
             "--host_workers", "1", "--eval_3d", "--eval_num", "1"]


def test_unet_cli_trains_resumes_and_evaluates_on_cpu(ds):
    root = ds.parent
    md = root / "cli_md"
    common = ["--data_root", str(root), "--model_dir", str(md)]
    trainer = cli.main(CLI_TRAIN + common + ["--num_of_total_steps", "6",
                                             "--device_cache"])
    assert trainer.global_step == 6
    state = load_state(md / "ckpt" / "6" / "state.pt")
    bn = "Encode1_conv1.norm.running_var"
    assert bn in state["model"]
    assert not torch.equal(state["model"][bn], torch.ones_like(
        state["model"][bn]))                      # the statistics moved
    assert (md / "ckpt_best" / "best" / "state.pt").exists()
    best = json.loads((md / "best_result").read_text())
    assert best["global_step"] in (3, 6)
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    evals = {ln["step"] for ln in lines
             if ln["tag"] == "001_unet/eval/Liver/Dice"}
    assert evals == {3, 6}                        # the inline volume eval
    assert all(np.isfinite(ln["value"]) for ln in lines)

    # resume restores the running statistics with the weights
    again = cli.main(CLI_TRAIN + common + ["--num_of_total_steps", "7",
                                           "--eval_per_epoch"])
    assert again.global_step == 7
    assert CheckpointManager(md).steps() == [7]
    # --warm_start_from carries them too
    fresh = cli._build_model(cli.get_args(CLI_TRAIN + common))
    assert warm_start(fresh, md / "ckpt" / "7" / "state.pt") == \
        len(fresh.state_dict())
    assert torch.equal(fresh.state_dict()[bn], again.model.state_dict()[bn])

    # --mode eval (001_unet.sh eval flags): the unguided whole-volume eval
    ev = ["liver", "--mode", "eval", "--tag", "001_unet", "--model", "UNet",
          "--classes", "Liver", "Tumor", "--test_fold", "0", "--k_folds", "2",
          "--im_height", "48", "--im_width", "48", "--im_channel", "3",
          "--random_flip", "3", "--num_replicas", "0", "--dataset", "ds",
          "--metrics_eval", "Dice", "VOE", "RVD", "--primary_metric",
          "Tumor/Dice", "--batch_size", "8", "--evaluator", "Volume",
          "--device", "cpu", "--model_config", "UNet_TINY.yml",
          "--eval_final"] + common
    res = cli.main(ev)
    assert {"Liver/Dice", "Liver/VOE", "Liver/RVD", "Tumor/Dice",
            "GLiverDice", "GTumorDice"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())
    assert json.loads((md / "eval_results_3d.txt").read_text()) == \
        pytest.approx(res)
    model = cli.build_model_from_args(cli.get_args(ev), torch.device("cpu"))
    for k, v in again.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    # the checkpoint sweep over ckpt_best/<tag>
    rows = eval_all_ckpt.main(ev)
    assert [r["ckpt"] for r in rows] == ["best"]
    assert "Tumor/Dice" in rows[0]
    assert (md / "eval_sweep.txt").read_text().count("\n") == 1


def test_gunet_batch_norm_trains_through_the_same_norm(ds):
    """GUNet with --normalizer batch_norm: the encoder's modulated norms and
    the decoder's ConvNormAct run train-mode batch norm, no extra code."""
    args = cli.get_args(
        ["liver", "--mode", "train", "--tag", "g", "--model", "GUNet",
         "--classes", "Liver", "Tumor", "--model_config", "GUNet_TINY.yml",
         "--normalizer", "batch_norm", "--use_spatial", "--device", "cpu",
         "--model_dir", str(ds.parent / "g_md")])
    trainer = cli.build_trainer(args, torch.device("cpu"))
    feats = {"images": torch.rand(2, 32, 32, 3),
             "sp_guide": torch.rand(2, 32, 32, 1)}
    labels = torch.randint(0, 3, (2, 32, 32))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()
              if "running" in k}
    assert before
    grads, total, _, _ = trainer.gradients(feats, labels)
    assert np.isfinite(float(total))
    moved = [k for k, v in trainer.model.state_dict().items()
             if k in before and not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    assert functools.reduce(lambda a, g: a + float(g.abs().sum()), grads,
                            0.0) > 0
