"""The remaining train flags of the port against the JAX package on the CPU:
``--opt_moment_dtype bfloat16`` (Adam and AdamW against
``scale_by_adam_lowp``: moments within one bf16 ulp, updates within 1e-6
relative plus 1e-6 — the bias corrections are float32 powers computed by
numpy and by XLA), the loss weight types ``proportion`` / ``boundary`` /
``examples`` (``compute_weights`` within 1e-6 relative plus 1e-6: each
sample's weights are normalized by a float32 sum that the two packages take
in another order), ``binary_dilation2d`` and
``distance_transform_cityblock`` (exact: the closed-form min-plus scan
against JAX's lax.scan), and ``--weights_scope`` (the same tensors
restored as JAX ``warm_start(scope_map=…)``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.ops import image_ops as jimage
from boxsegliver_tpu.ops import losses as jlosses
from boxsegliver_tpu.train.checkpoint import warm_start as jwarm_start
from boxsegliver_tpu.train.solver import scale_by_adam_lowp
from boxsegliver_tpu.train.trainer import TrainState
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.ops import image_ops as timage
from boxsegliver_torch.ops import losses as tlosses
from boxsegliver_torch.train.checkpoint import warm_start
from boxsegliver_torch.train.solver import Optimizer

torch.set_num_threads(2)
SHAPES = {"a": (64, 33), "b": (257,), "c": (5, 7, 9)}


def _opt_args(optimizer):
    import types
    return types.SimpleNamespace(optimizer=optimizer, weight_decay_rate=1e-2,
                                 opt_moment_dtype="bfloat16")


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_bf16_moment_adam_matches_scale_by_adam_lowp(optimizer):
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tx = scale_by_adam_lowp()
    if optimizer == "AdamW":
        tx = optax.chain(tx, optax.add_decayed_weights(1e-2))
    st = tx.init(jp)
    optim = Optimizer(_opt_args(optimizer),
                      [torch.from_numpy(p0[k].copy()) for k in SHAPES])
    for step in range(3):
        g = {k: (rng.normal(size=s) * 10.0 ** -step).astype(np.float32)
             for k, s in SHAPES.items()}
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        sched = torch.from_numpy(optim.schedule(1e-3))
        got = optim.direction([torch.from_numpy(g[k]) for k in SHAPES], sched)
        adam = st[0] if optimizer == "AdamW" else st
        for i, k in enumerate(SHAPES):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(upd[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            for name in ("mu", "nu"):
                mine = optim.state[name][i]
                assert mine.dtype == torch.bfloat16
                ulps = np.abs(_bf16_bits(mine)
                              - _bf16_bits(getattr(adam, name)[k]))
                assert ulps.max() <= 1, (name, k, step)


def test_bf16_moments_ride_the_checkpoint():
    optim = Optimizer(_opt_args("Adam"), [torch.ones(4)])
    optim.step([torch.full((4,), 0.5)], 1e-3)
    state = optim.state_dict()
    assert state["state"]["mu"][0].dtype == torch.bfloat16
    again = Optimizer(_opt_args("Adam"), [torch.ones(4)])
    again.load_state_dict(state)
    assert again.count == 1
    for k in ("mu", "nu"):
        assert torch.equal(again.state[k][0], optim.state[k][0])


@pytest.mark.parametrize("w_type", ["proportion", "boundary", "examples"])
def test_compute_weights_match_jax(w_type):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, (4, 8, 8)).astype(np.int32)
    labels[1] = 0                                # one class only
    labels[2, 2:6, 1:5] = 2                      # a block with a boundary
    kw = {"proportion": {"proportion_decay": 1000.0}, "boundary": {},
          "examples": {"examples_w": [0.5, 1.0, 2.0, 4.0]}}[w_type]
    want = np.asarray(jlosses.compute_weights(
        w_type, jax.nn.one_hot(labels, 3), **kw))
    tkw = {k: torch.tensor(v) if k == "examples_w" else v
           for k, v in kw.items()}
    got = tlosses.compute_weights(w_type, torch.from_numpy(labels), 3, **tkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_distance_transform_and_dilation_are_exact():
    rng = np.random.default_rng(4)
    masks = (rng.random((3, 31, 17)) > 0.03).astype(np.float32)
    masks[2] = 1.0                               # no zero: JAX's `big`
    want = np.stack([np.asarray(jimage.distance_transform_cityblock(
        jnp.asarray(m))) for m in masks])
    got = timage.distance_transform_cityblock(torch.from_numpy(masks),
                                              axes=(1, 2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        timage.distance_transform_cityblock(torch.from_numpy(masks[0])),
        want[0])
    x = (rng.random((2, 3, 20, 22)) > 0.8).astype(np.float32)
    for connection in (1, 2):
        np.testing.assert_array_equal(
            timage.binary_dilation2d(torch.from_numpy(x), connection, 2),
            np.asarray(jimage.binary_dilation2d(jnp.asarray(x), connection,
                                                2)))


def _flat(params):
    return {f"params/{k}": np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(params)), sep="/").items()}


@pytest.mark.parametrize("scope", [None, "Head=AdjustChannels"])
def test_weights_scope_restores_what_jax_restores(tmp_path, scope):
    """A source checkpoint whose head scope is named ``Head``: with the
    rename both packages restore it into AdjustChannels, without it both
    keep the fresh head; every other tensor is restored."""
    argv = ["liver", "--mode", "train", "--tag", "t", "--model", "GUNet",
            "--model_config", "GUNet_TINY.yml", "--classes", "Liver",
            "Tumor", "--use_spatial", "--normalizer", "instance_norm",
            "--im_height", "32", "--im_width",
            "32", "--device", "cpu", "--model_dir", str(tmp_path / "md")]
    args = cli.get_args(argv)
    jmodel = jbuild("GUNet", args=args,
                    model_kwargs=MODEL_CONFIGS["GUNet_TINY.yml"])
    feats = {"images": np.zeros((1, 32, 32, 3), np.float32),
             "sp_guide": np.zeros((1, 32, 32, 1), np.float32)}
    target = jmodel.init(jax.random.PRNGKey(0), feats)["params"]
    source = dict(jmodel.init(jax.random.PRNGKey(1), feats)["params"])
    source["Head"] = source.pop("AdjustChannels")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "src", {"params": source}, force=True)
    ckptr.wait_until_finished()
    np.savez(tmp_path / "src.npz", **_flat(source))

    scope_map = dict([scope.split("=")]) if scope else None
    state = TrainState(step=jnp.zeros((), jnp.int32), params=target,
                       batch_stats={}, opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    want = _flat(jwarm_start(state, tmp_path / "src", scope_map).params)

    model = cli._build_model(args)
    model.load_state_dict(flax_to_state_dict(_flat(target)), strict=True)
    n = warm_start(model, tmp_path / "src.npz", scope_map=scope_map)
    assert n == len(want) - (0 if scope else 2)
    got = state_dict_to_flax(model)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    head = "params/AdjustChannels/kernel"
    src_head = _flat(source)["params/Head/kernel"]
    assert np.array_equal(got[head], src_head) == bool(scope)

    # the trainer applies it on the --load_weights path
    extra = ["--load_weights", str(tmp_path / "src.npz")]
    if scope:
        extra += ["--weights_scope", scope]
    trainer = cli.build_trainer(cli.get_args(argv + extra), "cpu")
    assert trainer.restore() == 0
    again = state_dict_to_flax(trainer.model)
    assert np.array_equal(again[head], src_head) == bool(scope)
    trainer.summary.close()
