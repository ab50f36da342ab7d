"""GUNet's ``--use_se`` modulation and its 1-D VGG contexts (vgg16B / C / D)
against the JAX package's on the CPU in float32, with the same
numpy-seeded inputs and flax variables carried across by the weight bridge:

- ``use_se`` at GUNet_TINY.yml with --use_context --use_spatial and
  instance norm: the forward within 1e-5; one train step against JAX
  ``make_train_step`` (side dropout 0): total and data loss within 1e-5
  relative, gradients within 1e-4, parameters after 3 Momentum steps within
  1e-5 (Adam's sign-like update on round-off gradients is held against
  optax elsewhere, tests/test_torch_train.py);
- ``layers.VGG1D`` alone, and inside GUNet as its context, for each
  variant: forward within 1e-5 at a context length of 20, whose pools meet
  odd lengths (20 → 10 → 5 → 3 → 2 → 1), the final Dense's zeros / ones
  init (both packages give it) randomized with the other biases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu import config as jconfig
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.models.layers import VGG1D as JVGG1D
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import create_train_state
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.train.trainer import make_train_step
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.layers import VGG1D
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)
CLASSES = ["Background", "Liver", "Tumor"]
TINY = MODEL_CONFIGS["GUNet_TINY.yml"]
SE = dict(TINY, use_context=True, use_spatial=True, use_se=True,
          normalizer="instance_norm")
VARIANTS = ("vgg16B", "vgg16C", "vgg16D")


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(tree)), sep="/").items()}


def _randomized(flat, rng):
    """Norm, bias and affine leaves, and the kernels flax starts at zeros
    (the VGG context's final Dense), drawn anew, so the bridge's placement
    of each one matters."""
    out = {}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("bias", "scale", "mean") or (leaf == "kernel"
                                                 and not v.any()):
            out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
        elif leaf == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def _feats(rng, ctx_len=16, size=32):
    return {"images": rng.normal(size=(2, size, size, 3)).astype(np.float32),
            "sp_guide": rng.uniform(0.5, 1.0, (2, size, size, 1)
                                    ).astype(np.float32),
            "context": rng.normal(size=(2, ctx_len)).astype(np.float32)}


def _port_gunet(kw, ctx_len):
    return tbuild("GUNet", model_kwargs=dict(kw, in_channels=3,
                                             context_length=ctx_len),
                  num_classes=3, dtype=torch.float32)


def _forward_pair(kw, feats, rng):
    jmodel = jbuild("GUNet", model_kwargs=kw, num_classes=3)
    flat = _randomized(_flat(jmodel.init(jax.random.PRNGKey(0), feats)), rng)
    ref = np.asarray(jmodel.apply(traverse_util.unflatten_dict(
        flat, sep="/"), feats, train=False))
    model = _port_gunet(kw, feats["context"].shape[1])
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    assert state_dict_to_flax(model).keys() == flat.keys()
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in feats.items()})
    return out.numpy(), ref


def test_se_forward_matches_jax():
    rng = np.random.default_rng(0)
    out, ref = _forward_pair(SE, _feats(rng), rng)
    assert out.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_se_context_width_and_layers():
    """use_se: the context emits context_fc_channels[-1] features per
    modulated conv (16 x 2 levels x 2 convs), and each modulated conv has
    its squeeze-excitation pair Dense((ch + 16) // 4), Dense(ch)."""
    model = _port_gunet(SE, 16)
    assert model.context.Dense_2.weight.shape == (16 * 2 * 2, 16)
    for level, ch in ((2, 16), (3, 32)):
        for j in (1, 2):
            name = f"Encode{level}_conv{j}"
            hidden = (ch + 16) // 4
            assert model._modules[name + "_se1"].weight.shape == \
                (hidden, ch + 16)
            assert model._modules[name + "_se2"].weight.shape == (ch, hidden)
    assert not hasattr(model, "Encode1_conv1_se1")


# ---------------------------------------------------------------------------
# the use_se train step against JAX make_train_step
# ---------------------------------------------------------------------------

STEP_FLAGS = ["--mode", "train", "--tag", "t", "--model", "GUNet",
              "--model_config", "GUNet_TINY.yml", "--classes", "Liver",
              "Tumor", "--compute_dtype", "float32", "--normalizer",
              "instance_norm", "--use_context", "--context_list", "hist",
              "16", "--use_spatial", "--use_se", "--side_dropout", "0",
              "--loss_weight_type", "numerical", "--loss_numeric_w", "0.2",
              "0.4", "4.4", "--weight_decay_rate", "0.001",
              "--learning_policy", "plateau", "--learning_rate", "0.001",
              "--lr_end", "0.0000005", "--log_step", "1", "--optimizer",
              "Momentum"]


def _away_from_kinks(params):
    """Norm offsets and transpose-conv biases at 3: the ReLUs' inputs sit
    away from 0, where the packages' ~1e-6 float32 differences would flip a
    gradient."""
    flat = traverse_util.flatten_dict(dict(params), sep="/")
    for k, v in flat.items():
        if k.endswith(("Norm_0/bias", "ConvTranspose_0/bias")):
            flat[k] = jnp.full_like(v, 3.0)
    return traverse_util.unflatten_dict(flat, sep="/")


def test_se_train_step_matches_jax(tmp_path):
    argv = STEP_FLAGS + ["--model_dir", str(tmp_path)]
    jparser = jconfig.build_parser()
    ja = jparser.parse_args(argv)
    jconfig.check_args(ja, jparser)
    ta = tconfig.build_parser().parse_args(argv)
    tconfig.check_args(ta, jparser)
    rng = np.random.default_rng(1)
    feats = _feats(rng)
    labels = rng.integers(0, 3, (2, 32, 32)).astype(np.int32)

    jmodel = jbuild("GUNet", args=ja, model_kwargs=TINY, dtype=jnp.float32)
    assert jmodel.use_se and jmodel.side_dropout == 0
    solver = Solver(ja)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    state = state.replace(params=_away_from_kinks(state.params))
    flat0 = {f"params/{k}": v for k, v in _flat(state.params).items()}

    model = tbuild("GUNet", args=ta, model_kwargs=TINY, dtype=torch.float32)
    assert model.use_se
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)
    ft = {k: torch.from_numpy(v) for k, v in feats.items()}
    lt = torch.from_numpy(labels).long()
    trainer = Trainer(model, ta, CLASSES, "cpu",
                      preprocess_fn=lambda batch, gen: (ft, lt))

    jloss = jmake_loss_fn(ja, CLASSES)
    key = jax.random.PRNGKey(1)

    def total(p):
        return jloss(jmodel.apply({"params": p}, feats, train=True,
                                  rngs={"dropout": key}), labels, p)

    (jt, jd), jg = jax.value_and_grad(total, has_aux=True)(state.params)
    grads, tt, td, _ = trainer.gradients(ft, lt)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    tg = state_dict_to_flax(model, dict(zip(trainer.param_names, grads)))
    jgf = {f"params/{k}": v for k, v in _flat(jg).items()}
    assert set(tg) == set(jgf)
    assert any("_se1/" in k for k in jgf)
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)

    step_fn = jax.jit(make_train_step(jmodel, solver, ja, CLASSES))
    raw = {"names": np.zeros((2,), np.int32)}
    for _ in range(3):
        state, jm = step_fn(state, feats, labels, key)
        vals, _ = trainer.train_step(raw)
        np.testing.assert_allclose(float(vals[0]), float(jm["total_loss"]),
                                   rtol=1e-5)
    got = state_dict_to_flax(model)
    want = {f"params/{k}": v for k, v in _flat(state.params).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the 1-D VGG contexts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_vgg1d_matches_flax(variant):
    rng = np.random.default_rng(len(variant) + ord(variant[-1]))
    x = rng.normal(size=(3, 20)).astype(np.float32)
    jmod = JVGG1D(variant, 4, (8, 6))
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[..., None]))
    model = VGG1D(variant, 4, 20, (8, 6))
    # the flax init of the final Dense (zeros, ones) is the port's
    model.reset_final_()
    init = np.asarray(jmod.apply(variables, jnp.asarray(x[..., None])))
    np.testing.assert_array_equal(init, np.ones((3, 6), np.float32))
    flat = _randomized(_flat(variables), rng)
    state = flax_to_state_dict({"params/context/" + k[len("params/"):]: v
                                for k, v in flat.items()})
    model.load_state_dict({k[len("context."):]: v for k, v in state.items()},
                          strict=True)
    n_convs = {"vgg16B": 10, "vgg16C": 13, "vgg16D": 13}[variant]
    assert len(model.plan) == n_convs
    assert sum(pool for _, pool in model.plan) == 5
    # 20 -> 10 -> 5 -> 3 -> 2 -> 1 positions of 32 channels
    assert model.MLP_0.Dense_0.weight.shape == (8, 1 * 32)
    ref = np.asarray(jmod.apply(traverse_util.unflatten_dict(flat, sep="/"),
                                jnp.asarray(x[..., None])))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_vgg1d_flattens_length_major():
    """flax flattens [bs, L, C] as (length, channel): at a context length
    whose last pool leaves 2 positions, the first Dense's rows interleave
    the channels of the two positions."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 40)).astype(np.float32)        # ... -> 3 -> 2
    jmod = JVGG1D("vgg16B", 2, (5,))
    flat = _randomized(_flat(jmod.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x[..., None]))), rng)
    model = VGG1D("vgg16B", 2, 40, (5,))
    assert model.MLP_0.Dense_0.weight.shape == (5, 2 * 16)
    state = flax_to_state_dict({"params/context/" + k[len("params/"):]: v
                                for k, v in flat.items()})
    model.load_state_dict({k[len("context."):]: v for k, v in state.items()},
                          strict=True)
    ref = np.asarray(jmod.apply(traverse_util.unflatten_dict(flat, sep="/"),
                                jnp.asarray(x[..., None])))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_gunet_vgg_context_matches_jax(variant):
    kw = dict(TINY, use_context=True, use_spatial=True,
              normalizer="instance_norm", context_model=variant,
              context_conv_init_channels=4)
    rng = np.random.default_rng(ord(variant[-1]))
    out, ref = _forward_pair(kw, _feats(rng, ctx_len=20), rng)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_gunet_vgg_context_starts_as_identity_modulation():
    """The seeded init: the VGG context's final Dense is zeros / ones, so
    every density gamma starts at 1 (reference GUNet.py:73-74)."""
    model = _port_gunet(dict(TINY, use_context=True, context_model="vgg16D",
                             context_conv_init_channels=4), 20)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        gammas = model.context(torch.randn(2, 20))
    assert torch.equal(gammas, torch.ones_like(gammas))
