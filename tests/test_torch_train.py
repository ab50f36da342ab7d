"""The port's train step against the JAX package's on the CPU: losses
(within 1e-6 relative), the L2 term and its decayed set (equal), the
learning-rate policies and optimizers against optax (within 1e-6), the host
hooks, and one whole train step of a small GUNet (init_channels 4, 2
down-samples, 64², batch 2, float32, context and spatial on, side dropout 0
because the two frameworks draw different masks) with the weights carried
across by the bridge: total and data loss within 1e-5 relative, gradients
within 1e-4, parameters after 3 steps within 1e-5."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu import config as jconfig
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.ops import losses as jlosses
from boxsegliver_tpu.train import hooks as jhooks
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.solver import make_lr_fn as jmake_lr_fn
from boxsegliver_tpu.train.trainer import create_train_state
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.train.trainer import make_train_step
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_names, flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.ops import losses as tlosses
from boxsegliver_torch.train import hooks as thooks
from boxsegliver_torch.train.solver import Optimizer, make_lr_fn
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)
CLASSES = ["Background", "Liver", "Tumor"]
TINY = {"init_channels": 4, "num_down_samples": 2, "mod_layers": [1, 2],
        "context_fc_channels": [8], "norm_with_center": True,
        "norm_with_scale": False}
BASE = ["--mode", "train", "--tag", "t", "--model", "GUNet", "--classes",
        "Liver", "Tumor", "--normalizer", "instance_norm", "--use_context",
        "--context_list", "hist", "16", "--use_spatial", "--side_dropout",
        "0", "--compute_dtype", "float32", "--loss_weight_type",
        "numerical", "--loss_numeric_w", "0.2", "0.4", "4.4",
        "--weight_decay_rate", "0.001", "--learning_policy", "plateau",
        "--learning_rate", "0.001", "--lr_end", "0.0000005", "--log_step",
        "1"]


def _args(extra=(), model_dir="md"):
    argv = BASE + list(extra) + ["--model_dir", str(model_dir)]
    parser = jconfig.build_parser()
    a = parser.parse_args(argv)
    jconfig.check_args(a, parser)
    t = tconfig.build_parser().parse_args(argv)
    tconfig.check_args(t, parser)
    return a, t


def _batch(seed=0, bs=2, size=64):
    rng = np.random.default_rng(seed)
    feats = {"images": rng.normal(size=(bs, size, size, 3)).astype(np.float32),
             "sp_guide": rng.uniform(0.5, 1.0, (bs, size, size, 1)
                                     ).astype(np.float32),
             "context": rng.normal(size=(bs, 16)).astype(np.float32)}
    labels = rng.integers(0, 3, (bs, size, size)).astype(np.int32)
    return feats, labels


def _flat(tree, prefix="params"):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.tree_util.tree_map(
                np.asarray, dict(tree)), sep="/").items()}


# ---------------------------------------------------------------------------
# losses and L2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_type", ["xentropy", "xentropy+dice", "dice"])
@pytest.mark.parametrize("w_type", ["numerical", "none"])
def test_losses_match_jax(loss_type, w_type):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (3, 16, 12, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (3, 16, 12)).astype(np.int32)
    kw = {"numeric_w": [0.2, 0.4, 4.4]} if w_type == "numerical" else {}
    want = float(jlosses.make_loss_fn(loss_type, w_type, **kw)(
        jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tlosses.make_loss_fn(loss_type, w_type, **kw)(
        torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("w_type", ["proportion", "boundary"])
def test_other_weight_types_raise(w_type):
    """The other weight types are ported (their loss matches JAX within
    1e-6 relative); an unknown one raises, as in the JAX package."""
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (3, 16, 12, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (3, 16, 12)).astype(np.int32)
    kw = {"proportion_decay": 1000.0} if w_type == "proportion" else {}
    want = float(jlosses.make_loss_fn("xentropy", w_type, **kw)(
        jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tlosses.make_loss_fn("xentropy", w_type, **kw)(
        torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="weight type"):
        tlosses.make_loss_fn("xentropy", w_type + "_unknown")


@pytest.mark.parametrize("bias_decay", [False, True])
def test_l2_value_and_decayed_set_match_jax(bias_decay):
    ja, ta = _args()
    feats, _ = _batch(size=32)
    jmodel = jbuild("GUNet", args=ja, model_kwargs=TINY, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), feats)["params"]
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
    flat = _flat(params)
    # JAX's decayed set: the leaves whose l2 term is nonzero on their own
    want = set()
    for key in flat:
        probe = {k: (np.ones_like(v) if k == key else np.zeros_like(v))
                 for k, v in flat.items()}
        tree = traverse_util.unflatten_dict(
            {k[len("params/"):]: v for k, v in probe.items()}, sep="/")
        if float(jlosses.l2_regularization(tree, 1.0, bias_decay)) > 0:
            want.add(key)
    model = tbuild("GUNet", args=ta, model_kwargs=TINY)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    names = flax_names(model)
    decayed = tlosses.decayed_parameters(model, bias_decay)
    assert {names[n] for n in decayed} == want
    with torch.no_grad():
        got = tlosses.l2_regularization(
            [dict(model.named_parameters())[n] for n in decayed], 1e-3)
    np.testing.assert_allclose(
        float(got), float(jlosses.l2_regularization(params, 1e-3, bias_decay)),
        rtol=1e-6)


def test_state_dict_to_flax_inverts_the_bridge():
    ja, ta = _args()
    feats, _ = _batch(size=32)
    jmodel = jbuild("GUNet", args=ja, model_kwargs=TINY, dtype=jnp.float32)
    flat = _flat(jmodel.init(jax.random.PRNGKey(3), feats)["params"])
    model = tbuild("GUNet", args=ta, model_kwargs=TINY)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    back = state_dict_to_flax(model)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# learning rate and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--learning_policy", "period_step", "--lr_decay_step", "3",
     "--lr_decay_rate", "0.5"],
    ["--learning_policy", "custom_step", "--lr_decay_boundaries", "2", "5",
     "--lr_custom_values", "0.01", "0.001", "0.0001"],
    ["--learning_policy", "poly", "--num_of_total_steps", "7"],
    ["--learning_policy", "plateau"],
    ["--learning_policy", "poly", "--num_of_total_steps", "7", "--lr_warm_up",
     "--slow_start_step", "3"]])
def test_lr_policies_match_jax(extra):
    ja, ta = _args(extra)
    jfn, tfn = jmake_lr_fn(ja), make_lr_fn(ta)
    for step in range(9):
        for scale in (1.0, 0.2, 1e-4):
            np.testing.assert_allclose(tfn(step, scale),
                                       float(jfn(step, scale)), rtol=1e-6)


@pytest.mark.parametrize("opt", ["Adam", "Momentum", "AdamW"])
def test_optimizer_and_plateau_lr_match_optax(opt):
    ja, ta = _args(["--optimizer", opt])
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10 ** -i
              for k, s in shapes.items()} for i in range(5)]
    scales = [1.0, 1.0, 0.2, 0.04, 1e-4]         # the last one hits lr_end
    solver = Solver(ja)
    tx = solver.make_transform()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = [torch.from_numpy(p0[k].copy()) for k in shapes]
    optim = Optimizer(ta, tp)
    lr_fn = make_lr_fn(ta)
    for step, (g, scale) in enumerate(zip(grads, scales)):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        lr = solver.lr_fn(step, scale)
        jp = {k: jp[k] + upd[k] * lr for k in jp}
        optim.step([torch.from_numpy(g[k]) for k in shapes],
                   lr_fn(step, scale))
    for t, k in zip(tp, shapes):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6,
                                   rtol=1e-6)


def test_unported_optimizer_options_raise():
    """--opt_moment_dtype bfloat16 is ported (its moments rest in bf16,
    tests/test_torch_train_flags.py holds it against JAX); a moment dtype
    the JAX package does not take raises."""
    _, ta = _args(["--opt_moment_dtype", "bfloat16"])
    optim = Optimizer(ta, [torch.zeros(2)])
    assert optim.state["mu"][0].dtype == optim.state["nu"][0].dtype == \
        torch.bfloat16
    ta.opt_moment_dtype = "float16"
    with pytest.raises(ValueError, match="opt_moment_dtype"):
        Optimizer(ta, [torch.zeros(2)])


# ---------------------------------------------------------------------------
# host hooks (numpy copies)
# ---------------------------------------------------------------------------

def test_plateau_and_best_keeper_copies_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    losses = np.concatenate([np.linspace(2, 1, 20), 1 + rng.normal(0, 1e-4,
                                                                  60)])
    kw = dict(lr_patience=2, tr_patience=4, every_n_steps=3, decay_rate=0.5,
              min_lr_scale=0.01, min_delta=0.05)
    jp = jhooks.ReduceLROnPlateau(tmp_path / "j", **kw)
    tp = thooks.ReduceLROnPlateau(tmp_path / "t", **kw)
    for step, loss in enumerate(losses, 1):
        assert tp.step(step, loss, 1e-3) == jp.step(step, loss, 1e-3)
        assert tp.should_stop() == jp.should_stop()
    assert tp.lr_scale < 1.0
    assert json.loads((tmp_path / "t" / "lr_schedule").read_text()) == \
        json.loads((tmp_path / "j" / "lr_schedule").read_text())
    for cls_j, cls_t in ((jhooks.BestKeeper, thooks.BestKeeper),
                         (jhooks.BestKeeperMA, thooks.BestKeeperMA)):
        bj = cls_j(tmp_path / "bj", "Tumor/Dice", "Liver/Dice")
        bt = cls_t(tmp_path / "bt", "Tumor/Dice", "Liver/Dice")
        for step in range(1, 6):
            res = {"Tumor/Dice": float(rng.random()),
                   "Liver/Dice": float(rng.random())}
            assert bt.update(step, res) == bj.update(step, res)
        for f in (tmp_path / "bj").iterdir():
            assert (tmp_path / "bt" / f.name).read_text() == f.read_text()


# ---------------------------------------------------------------------------
# one whole train step against JAX make_train_step
# ---------------------------------------------------------------------------

def test_train_step_matches_jax(tmp_path):
    ja, ta = _args(model_dir=tmp_path)
    feats, labels = _batch()
    jmodel = jbuild("GUNet", args=ja, model_kwargs=TINY, dtype=jnp.float32)
    solver = Solver(ja)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    flat0 = _flat(state.params)

    model = tbuild("GUNet", args=ta, model_kwargs=TINY, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)
    ft = {k: torch.from_numpy(v) for k, v in feats.items()}
    lt = torch.from_numpy(labels).long()
    trainer = Trainer(model, ta, CLASSES, "cpu",
                      preprocess_fn=lambda batch, gen: (ft, lt))

    # gradients of the total loss, mapped through the bridge's layouts
    jloss = jmake_loss_fn(ja, CLASSES)
    key = jax.random.PRNGKey(1)

    def total(p):
        logits = jmodel.apply({"params": p}, feats, train=True,
                              rngs={"dropout": key})
        return jloss(logits, labels, p)

    (jt, jd), jg = jax.value_and_grad(total, has_aux=True)(state.params)
    grads, tt, td, _ = trainer.gradients(ft, lt)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    tg = state_dict_to_flax(model, dict(zip(trainer.param_names, grads)))
    jgf = _flat(jg)
    assert set(tg) == set(jgf)
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)

    step_fn = jax.jit(make_train_step(jmodel, solver, ja, CLASSES))
    raw = {"names": np.zeros((2,), np.int32)}
    for i in range(3):
        state, jm = step_fn(state, feats, labels, key)
        vals, lr = trainer.train_step(raw)
        np.testing.assert_allclose(float(vals[0]), float(jm["total_loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(lr, float(jm["learning_rate"]), rtol=1e-7)
    assert trainer.global_step == 3
    got = state_dict_to_flax(model)
    for k, v in _flat(state.params).items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("extra", [["--num_replicas", "2"],
                                   ["--steps_per_dispatch", "2"]])
def test_unported_trainer_flags_raise(tmp_path, extra):
    """The trainer's refusals.  Data parallelism is ported (the CLI starts
    the ranks; tests/test_torch_dist_*.py): a trainer given a group that
    --batch_size does not divide raises JAX's per_device_batch_size error
    before anything else.  K > 1 needs the device preprocess (the JAX
    trainer raises the same way without its fused preprocess)."""
    import types

    from boxsegliver_tpu.parallel.mesh import per_device_batch_size

    _, ta = _args(extra, model_dir=tmp_path)
    model = tbuild("GUNet", args=ta, model_kwargs=TINY)
    if "--num_replicas" in extra:
        group = types.SimpleNamespace(size=3, rank=0, chief=True,
                                      backend="gloo")
        with pytest.raises(ValueError) as want:
            per_device_batch_size(ta.batch_size, group.size)
        with pytest.raises(ValueError) as got:
            Trainer(model, ta, CLASSES, "cpu", group=group)
        assert str(got.value) == str(want.value)
        return
    with pytest.raises(ValueError, match="preprocess"):
        Trainer(model, ta, CLASSES, "cpu")


def test_nan_loss_aborts_from_the_drained_window(tmp_path):
    _, ta = _args(model_dir=tmp_path)
    model = tbuild("GUNet", args=ta, model_kwargs=TINY)
    trainer = Trainer(model, ta, CLASSES, "cpu")
    row = torch.tensor([1.0, 1.0, 0.0, 0.0])
    trainer._drain([(1, row, 1e-3), (2, row, 1e-3)])
    assert trainer.loss_meter.count == 0       # log_step 1 resets the meter
    with pytest.raises(FloatingPointError, match="step 4"):
        trainer._drain([(3, row, 1e-3),
                        (4, torch.tensor([float("nan"), 1.0, 0.0, 0.0]),
                         1e-3)])
