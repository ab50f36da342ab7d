"""DenseUNet of the port (``003_denseunet.sh``) against the JAX package's on
the CPU, with the same numpy-seeded inputs and the same flax variables
carried across by the weight bridge:

- the forward of DenseUNet_tiny.yml at 64² and batch 2 in eval mode (the
  stem pads (2, 3), the max pool (0, 1)): logits within 1e-5;
- one train step against JAX ``make_train_step`` at the ``003_denseunet.sh``
  loss flags (numerical weights 0.2 0.4 4.4, L2 1e-6) and ``--dropout
  0.2``: total and data loss within 1e-5 relative, gradients within 1e-4,
  parameters and running statistics after 3 Momentum steps within 1e-5.
  The two packages draw different dropout masks, and the decoder's 0.3
  dropout cannot be switched off, so the test records flax's keep masks
  (``jax.random.bernoulli`` wrapped for one eager apply per step key) and
  feeds them to the port's ``layers.dropout_apply``, patched here only;
- the full ``DenseUNet.yml`` state_dict: keys and shapes equal to the bridge
  of JAX's ``jax.eval_shape`` tree;
- the L2 term over exactly JAX's decayed leaves;
- the ``.h5`` DenseNet-161 import against JAX ``load_densenet161_h5`` plus
  the bridge, array for array, with and without ``skip_batch_stats``; a
  shape mismatch raises; without h5py the import names it;
- the ``003_denseunet.sh`` CLI with --device cpu at a tiny size: train 2
  steps, ``--mode eval`` (summary and per-case metrics within 1e-6 of
  JAX's ``EvaluateVolume.run`` on the same weights), ``eval_all_ckpt``,
  ``--mode export`` served against the eager model, and a 1-step train
  from ``--load_weights <file>.h5`` that starts from the imported tensors.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu import config as jconfig
from boxsegliver_tpu.data.meta import load_meta
from boxsegliver_tpu.evaluators import device_eval as j_device_eval
from boxsegliver_tpu.evaluators import volume as j_volume
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.models.dense_unet import _upsample2x
from boxsegliver_tpu.ops.losses import l2_regularization as jl2
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import (TrainState, create_train_state,
                                           make_train_step)
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.utils.h5_import import load_densenet161_h5 as jload_h5
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.cli import eval_all_ckpt
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.cli.export import load_exported
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.evaluators import device_eval as t_device_eval
from boxsegliver_torch.evaluators import volume as t_volume
from boxsegliver_torch.models import MODEL_CONFIGS, load_model_config
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models import layers
from boxsegliver_torch.models.weights import (flax_key_to_torch,
                                              flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.ops.losses import decayed_parameters, l2_regularization
from boxsegliver_torch.train.trainer import Trainer
from boxsegliver_torch.utils.h5_import import load_densenet161_h5
from tests.test_dense_unet import _write_fake_h5

torch.set_num_threads(2)
CLASSES = ["Background", "Liver", "Tumor"]
TINY = MODEL_CONFIGS["DenseUNet_tiny.yml"]


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(tree)), sep="/").items()}


def _tree(flat):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _port(kw=TINY, dtype=torch.float32):
    return tbuild("DenseUNet", model_kwargs=kw, num_classes=3, dtype=dtype)


def _jax_variables(rng, size=64):
    """flax init of DenseUNet_tiny, its running statistics randomized."""
    jmodel = jbuild("DenseUNet", model_kwargs=TINY, num_classes=3)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)), train=False)
    flat = _flat(variables)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return jmodel, flat


def test_registered_and_carried():
    assert load_model_config("DenseUNet") == MODEL_CONFIGS["DenseUNet.yml"]
    model = _port()
    assert type(model).__name__ == "DenseUNet"
    assert model.conv1.weight.shape == (8, 3, 7, 7)
    assert model.conv1_bn.momentum == 0.999 and model.conv1_bn.eps == 1e-5
    assert model.bn_up0.eps == 1e-3
    with pytest.raises(ValueError, match="4 dense blocks"):
        _port(dict(TINY, nb_layers=[2, 2, 2]))


def test_forward_matches_jax():
    rng = np.random.default_rng(0)
    jmodel, flat = _jax_variables(rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(_tree(flat), jnp.asarray(x), train=False))
    model = _port()
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    assert state_dict_to_flax(model).keys() == flat.keys()
    with torch.no_grad():
        out = model({"images": torch.from_numpy(x)})
    assert out.dtype == torch.float32 and out.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [64, 63])
def test_pool_and_upsample_match_flax(size):
    """The stem's 3x3 stride-2 SAME max pool (−inf pad (0, 1) at even sizes,
    (1, 1) at odd ones) and the nearest 2x upsampling."""
    import flax.linen as nn

    x = np.random.default_rng(size).normal(
        size=(2, size, size - 2, 5)).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    got = layers.max_pool3x3_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    up = layers.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(_upsample2x(jnp.asarray(x))))


def test_full_width_state_dict_matches_eval_shape():
    """DenseUNet.yml (DenseNet-161: stem 96, growth 48, blocks 6/12/36/24,
    compression 0.5): every tensor of the port at the bridged key and shape
    of JAX's abstract init; the decoder widths 768 / 384 / 96."""
    jmodel = jbuild("DenseUNet", model_kwargs=MODEL_CONFIGS["DenseUNet.yml"],
                    num_classes=3)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), train=False))
    flat = traverse_util.flatten_dict(dict(shapes), sep="/")
    model = _port(MODEL_CONFIGS["DenseUNet.yml"])
    state = model.state_dict()
    want = {}
    for k, v in flat.items():
        shape = tuple(v.shape)
        if k.endswith("/kernel"):
            shape = shape[-1:] + shape[-2:-1] + shape[:-2]   # HWIO -> OIHW
        want[flax_key_to_torch(k)] = shape
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert state["line0.weight"].shape == (2208, 2112, 1, 1)
    assert [state[f"conv_up{i}.weight"].shape[0] for i in range(5)] == \
        [768, 384, 96, 96, 64]
    # the stem, 2 x 78 bottlenecks and 4 block ends
    assert len([k for k in state if k.endswith("_bn.running_var")]) == 161


def test_l2_term_decays_jax_leaves():
    """decayed_parameters picks, through the bridge's flax names, exactly
    the leaves JAX's l2_regularization sums: every conv kernel, no batch
    norm leaf."""
    rng = np.random.default_rng(1)
    _, flat = _jax_variables(rng)
    model = _port()
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    params = dict(model.named_parameters())
    names = decayed_parameters(model)
    assert names and all(not n.split(".")[0].endswith("_bn")
                         and "bn_up" not in n for n in names)
    assert len(names) == len([k for k in flat if k.endswith("/kernel")])
    with torch.no_grad():
        got = float(l2_regularization([params[n] for n in names], 1.0))
    want = float(jl2(_tree(flat)["params"], 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step against JAX make_train_step, flax's dropout masks injected
# ---------------------------------------------------------------------------

STEP_FLAGS = ["--mode", "train", "--tag", "t", "--model", "DenseUNet",
              "--model_config", "DenseUNet_tiny.yml", "--classes", "Liver",
              "Tumor", "--compute_dtype", "float32", "--loss_weight_type",
              "numerical", "--loss_numeric_w", "0.2", "0.4", "4.4",
              "--weight_decay_rate", "0.000001", "--dropout", "0.2",
              "--learning_policy", "plateau", "--learning_rate", "0.001",
              "--lr_end", "0.0000005", "--lr_decay_rate", "0.2",
              "--log_step", "1", "--optimizer", "Momentum"]


def _flax_masks(jmodel, variables, feats, key):
    """flax's keep masks (NHWC) of one train-mode apply with dropout key
    ``key``, in call order: the masks depend on the key and the module
    path only, so the jitted step draws the same."""
    masks = []
    real = jax.random.bernoulli

    def record(*a, **k):
        m = real(*a, **k)
        masks.append(np.asarray(m))
        return m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", record)
        jmodel.apply(variables, feats, train=True, rngs={"dropout": key},
                     mutable=["batch_stats"])
    return masks


class _MaskFeed:
    """``layers.dropout_apply`` with the next recorded flax mask in place of
    the port's own draw."""

    def __init__(self, real):
        self.real, self.queue = real, []

    def __call__(self, x, keep, keep_prob):
        mask = torch.from_numpy(np.array(self.queue.pop(0))).permute(
            0, 3, 1, 2)
        assert mask.shape == x.shape
        return self.real(x, mask, keep_prob)


def _args(argv):
    parser = jconfig.build_parser()
    a = parser.parse_args(argv)
    jconfig.check_args(a, parser)
    t = tconfig.build_parser().parse_args(argv)
    tconfig.check_args(t, parser)
    return a, t


def _away_from_kinks(flat):
    """Every batch-norm offset at 3: the ReLUs' inputs sit away from 0, where
    the packages' ~1e-6 float32 differences would flip a gradient."""
    return {k: np.full_like(v, 3.0) if k.startswith("params/")
            and k.endswith("/bias") and "bn" in k else v
            for k, v in flat.items()}


def test_train_step_matches_jax(tmp_path, monkeypatch):
    ja, ta = _args(STEP_FLAGS + ["--model_dir", str(tmp_path)])
    rng = np.random.default_rng(2)
    feats = {"images": rng.normal(size=(2, 64, 64, 3)).astype(np.float32)}
    labels = rng.integers(0, 3, (2, 64, 64)).astype(np.int32)

    jmodel = jbuild("DenseUNet", args=ja, model_kwargs=TINY,
                    dtype=jnp.float32)
    assert jmodel.dropout == 0.2
    solver = Solver(ja)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    flat0 = _away_from_kinks(_flat({"params": state.params,
                                    "batch_stats": state.batch_stats}))
    tree0 = _tree(flat0)
    state = state.replace(params=tree0["params"],
                          batch_stats=tree0["batch_stats"])
    keys = [jax.random.PRNGKey(10 + i) for i in range(4)]
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    feed = _MaskFeed(layers.dropout_apply)
    for k in keys:
        feed.queue += _flax_masks(jmodel, variables, feats, k)
    # 8 bottlenecks x 2 + 3 transitions at --dropout 0.2, and the 0.3
    assert len(feed.queue) == 4 * 20
    monkeypatch.setattr(layers, "dropout_apply", feed)

    model = tbuild("DenseUNet", args=ta, model_kwargs=TINY,
                   dtype=torch.float32)
    assert model.dropout == 0.2
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)
    ft = {"images": torch.from_numpy(feats["images"])}
    lt = torch.from_numpy(labels).long()
    trainer = Trainer(model, ta, CLASSES, "cpu",
                      preprocess_fn=lambda batch, gen: (ft, lt))

    jloss = jmake_loss_fn(ja, CLASSES)

    def total(p):
        logits, _ = jmodel.apply({"params": p,
                                  "batch_stats": state.batch_stats}, feats,
                                 train=True, rngs={"dropout": keys[0]},
                                 mutable=["batch_stats"])
        return jloss(logits, labels, p)

    (jt, jd), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
        state.params)
    grads, tt, td, _ = trainer.gradients(ft, lt)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    tg = state_dict_to_flax(model, dict(zip(trainer.param_names, grads)))
    jgf = {f"params/{k}": v for k, v in _flat(jg).items()}
    assert set(tg) == set(jgf)
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    # the gradient check ran one train-mode forward: start the steps from
    # the same running statistics as JAX
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)

    step_fn = jax.jit(make_train_step(jmodel, solver, ja, CLASSES))
    raw = {"names": np.zeros((2,), np.int32)}
    for k in keys[1:]:
        state, jm = step_fn(state, feats, labels, k)
        vals, lr = trainer.train_step(raw)
        np.testing.assert_allclose(float(vals[0]), float(jm["total_loss"]),
                                   rtol=1e-5)
    assert not feed.queue
    got = state_dict_to_flax(model)
    want = _flat({"params": state.params, "batch_stats": state.batch_stats})
    moved = [k for k in want if k.startswith("batch_stats/")
             and not np.allclose(want[k], flat0[k])]
    assert len(moved) == len([k for k in want
                              if k.startswith("batch_stats/")])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the DenseNet-161 .h5 import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip_batch_stats", [False, True])
def test_h5_import_matches_jax(tmp_path, skip_batch_stats):
    rng = np.random.default_rng(3)
    _, flat = _jax_variables(rng)
    tree = _tree(flat)
    path = tmp_path / "densenet_tiny.h5"
    _write_fake_h5(str(path), tree["params"], tree["batch_stats"])
    want, n_want = jload_h5(tree, str(path),
                            skip_batch_stats=skip_batch_stats)
    want = _flat(want)
    model = _port()
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    n = load_densenet161_h5(model, path, skip_batch_stats=skip_batch_stats)
    assert n == n_want > 0
    got = state_dict_to_flax(model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    changed = {k for k in want if not np.array_equal(want[k], flat[k])}
    assert "params/conv1/kernel" in changed
    assert not any(k.split("/")[1].startswith(("conv_up", "line0", "bn_up",
                                               "Adjust")) for k in changed)
    assert any(k.startswith("batch_stats/") for k in changed) == \
        (not skip_batch_stats)


def test_h5_shape_mismatch_raises(tmp_path):
    import h5py

    path = tmp_path / "bad.h5"
    with h5py.File(str(path), "w") as f:
        f.create_group("conv1").create_dataset(
            "conv1_W", data=np.zeros((3, 3, 3, 8)))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_densenet161_h5(_port(), path)


def test_h5_import_without_h5py_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        load_densenet161_h5(_port(), tmp_path / "x.h5")


# ---------------------------------------------------------------------------
# the 003_denseunet.sh CLI on the CPU
# ---------------------------------------------------------------------------

COMMON = ["--tag", "003_denseunet", "--model", "DenseUNet", "--model_config",
          "DenseUNet_tiny.yml", "--classes", "Liver", "Tumor", "--test_fold",
          "0", "--k_folds", "2", "--im_height", "64", "--im_width", "64",
          "--im_channel", "3", "--random_flip", "3", "--num_replicas", "0",
          "--dataset", "ds", "--device", "cpu", "--compute_dtype", "float32"]
# run_scripts/template/003_denseunet.sh train and eval flags, tiny sizes
TRAIN = ["liver", "--mode", "train"] + COMMON + [
    "--noise_scale", "0.05", "--primary_metric", "Tumor/Dice",
    "--secondary_metric", "Liver/Dice", "--loss_weight_type", "numerical",
    "--loss_numeric_w", "0.2", "0.4", "4.4", "--batches_per_epoch", "2",
    "--batch_size", "2", "--dropout", "0.2", "--weight_decay_rate",
    "0.000001", "--learning_policy", "plateau", "--learning_rate", "0.001",
    "--lr_end", "0.0000005", "--lr_decay_rate", "0.2",
    "--eval_num_batches_per_epoch", "2", "--eval_per_epoch", "--evaluator",
    "Volume", "--save_best", "--log_step", "1", "--host_workers", "1"]
EVAL = ["liver", "--mode", "eval"] + COMMON + [
    "--metrics_eval", "Dice", "VOE", "RVD", "--primary_metric", "Tumor/Dice",
    "--batch_size", "8", "--evaluator", "Volume"]


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense_unet") / "ds"
    make_synthetic_dataset(root, n_cases=4, shape=(8, 64, 64), k_split=2,
                           seed=4)
    return root


def _per_case(ev):
    return {k: list(v) for k, v in ev._metric_values.items()}


def test_cli_trains_evaluates_sweeps_and_exports(ds, tmp_path):
    md = tmp_path / "md"
    common = ["--data_root", str(ds.parent), "--model_dir", str(md)]
    trainer = cli.main(TRAIN + common + ["--num_of_total_steps", "2"])
    assert trainer.global_step == 2
    assert (md / "ckpt_best" / "best" / "state.pt").exists()
    state = trainer.model.state_dict()
    assert not torch.equal(state["conv1_bn.running_var"],
                           torch.ones_like(state["conv1_bn.running_var"]))

    res = cli.main(EVAL + common)
    assert {"Liver/Dice", "Liver/VOE", "Liver/RVD", "Tumor/Dice",
            "GLiverDice", "GTumorDice"} <= set(res)
    assert json.loads((md / "eval_results_3d.txt").read_text()) == \
        pytest.approx(res)

    # JAX's EvaluateVolume.run on the same weights
    targs = cli.get_args(EVAL + common)
    model = cli.build_model_from_args(targs, torch.device("cpu"))
    flat = state_dict_to_flax(model)
    jparser = jconfig.build_parser()
    jargs = jparser.parse_args([a for a in EVAL[1:] + common
                                if a not in ("--device", "cpu")])
    jconfig.check_args(jargs, jparser)
    jconfig.fill_default_args(jargs)
    jargs.task = "liver"
    jargs.model_dir = str(tmp_path / "j")
    (tmp_path / "j").mkdir()
    tree = _tree(flat)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                        batch_stats=tree["batch_stats"], opt_state=(),
                        lr_scale=jnp.ones((), jnp.float32))
    jmodel = jbuild("DenseUNet", args=jargs, model_kwargs=TINY,
                    dtype=jnp.float32)
    metas = cli._test_metas(targs, ds)
    assert metas and len(metas) < len(load_meta(ds))
    jev = j_volume.EvaluateVolume(jargs, ds, CLASSES)
    want = jev.run(j_device_eval.DeviceSlicePredictor(jmodel, jstate, jargs),
                   metas)
    targs.model_dir = str(tmp_path / "t")
    (tmp_path / "t").mkdir()
    tev = t_volume.EvaluateVolume(targs, ds, CLASSES)
    got = tev.run(t_device_eval.DeviceSlicePredictor(model, targs, "cpu"),
                  metas)
    assert set(got) == set(want) == set(res)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(res[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    pj, pt = _per_case(jev), _per_case(tev)
    assert set(pj) == set(pt) and all(len(v) == len(metas)
                                      for v in pt.values())
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], atol=1e-6, rtol=0,
                                   err_msg=k)

    rows = eval_all_ckpt.main(EVAL + common)
    assert [r["ckpt"] for r in rows] == ["best"]
    assert "Tumor/Dice" in rows[0]

    out = cli.main(["liver", "--mode", "export"] + COMMON + common)
    serve, sig = load_exported(out, "cpu")
    assert sig["model"] == "DenseUNet"
    assert list(sig["inputs"]) == ["images"]
    x = np.random.default_rng(5).normal(size=sig["inputs"]["images"][0]
                                        ).astype(np.float32)
    with torch.no_grad():
        eager = torch.softmax(model({"images": torch.from_numpy(x)}), -1)
    np.testing.assert_allclose(serve({"images": x}).numpy(), eager.numpy(),
                               atol=1e-5, rtol=0)


def test_cli_warm_starts_from_h5(ds, tmp_path, monkeypatch):
    """--load_weights <file>.h5: the 1-step run starts from the imported
    encoder tensors (a periodic checkpoint would win: Trainer.restore)."""
    md = tmp_path / "md"
    argv = TRAIN + ["--data_root", str(ds.parent), "--model_dir", str(md),
                    "--num_of_total_steps", "1", "--save_best"]
    seeded = cli._build_model(cli.get_args(argv))
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    tree = traverse_util.unflatten_dict(state_dict_to_flax(seeded), sep="/")
    h5 = tmp_path / "densenet_tiny.h5"
    _write_fake_h5(str(h5), tree["params"], tree["batch_stats"])
    started = {}
    real = Trainer.restore

    def spy(self):
        step = real(self)
        started.update({k: v.clone()
                        for k, v in self.model.state_dict().items()})
        return step

    monkeypatch.setattr(Trainer, "restore", spy)
    trainer = cli.main(argv + ["--load_weights", str(h5)])
    assert trainer.global_step == 1
    import h5py
    with h5py.File(str(h5), "r") as f:
        np.testing.assert_array_equal(
            started["conv1.weight"].numpy(),
            np.asarray(f["conv1"]["conv1_W"], np.float32).transpose(
                3, 2, 0, 1))
        np.testing.assert_array_equal(
            started["conv2_1_x1_bn.bias"].numpy(),
            np.asarray(f["conv2_1_x1_scale"]["conv2_1_x1_scale_beta"],
                       np.float32))
        np.testing.assert_array_equal(
            started["conv1_bn.running_var"].numpy(),
            np.asarray(f["conv1_bn"]["conv1_bn_running_std"], np.float32))
    args = cli.get_args(argv)
    fresh = cli._build_model(args)
    fresh.reset_parameters(torch.Generator().manual_seed(int(args.seed)))
    assert torch.equal(started["conv_up0.weight"],
                       fresh.state_dict()["conv_up0.weight"])
