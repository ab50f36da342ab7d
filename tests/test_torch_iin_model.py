"""GUNet with the nf2 ``conv`` context (layers.PatchCNN) against the JAX
package on the CPU, on bridged weights:

- PatchCNN alone and GUNet_IIN_TINY (conv context + spatial guide) forward
  within 1e-5; the flax <-> torch bridge maps every PatchCNN tensor both
  ways (flax auto-names them ``context/Conv_k``, ``context/MLP_0``);
- GUNet_IIN.yml at full width: every parameter's shape equal to flax's;
  B2 carries its unmodulated level and its decoder (10 fused pairs);
- one GUNet_IIN_TINY train step on an IIN batch against JAX
  ``make_train_step`` (side dropout 0: the packages draw other masks):
  loss 1e-5 relative, gradients 1e-4, parameters after 3 Momentum steps
  1e-5 (the bar of tests/test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import main as jcli
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.models.layers import PatchCNN as JPatchCNN
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import create_train_state
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.train.trainer import make_train_step
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data import pipeline_iin as tpipe
from boxsegliver_torch.data import sampler_iin as tsamp
from boxsegliver_torch.data.pipeline import batch_to_device
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.layers import PatchCNN
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)


def _flat(variables):
    return {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(variables["params"]), sep="/").items()}


@pytest.mark.parametrize("n_scales", [1, 3])
def test_patch_cnn_matches_flax(n_scales):
    rng = np.random.default_rng(n_scales)
    x = rng.normal(size=(3, 32, 32, n_scales)).astype(np.float32)
    jm = JPatchCNN(4, [16, 16, 40])
    variables = jm.init(jax.random.PRNGKey(0), x)
    flat = _flat(variables)
    flat = {k.replace("params/", "params/context/"): v
            for k, v in flat.items()}
    model = torch.nn.Module()
    model.context = PatchCNN(n_scales, 4, [16, 16, 40])
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    assert set(state_dict_to_flax(model)) == set(flat)
    want = np.asarray(jm.apply(variables, x))
    with torch.no_grad():
        got = model.context(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _iin_kw(config):
    return dict(MODEL_CONFIGS[config], normalizer="instance_norm",
                use_context=True, use_spatial=True)


@pytest.mark.parametrize("size", [(48, 48), (40, 56)])
def test_gunet_iin_tiny_forward_matches_jax(size):
    kw = _iin_kw("GUNet_IIN_TINY.yml")
    rng = np.random.default_rng(2)
    feats = {"images": rng.normal(size=(2,) + size + (3,)).astype(np.float32),
             "sp_guide": rng.uniform(0, 1, (2,) + size + (1,)
                                     ).astype(np.float32),
             "context": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)}
    jmodel = jbuild("GUNet", model_kwargs=kw, num_classes=2)
    variables = jmodel.init(jax.random.PRNGKey(0), feats, train=False)
    flat = _flat(variables)
    # norm offsets away from 0, so that the output depends on them
    r = np.random.default_rng(5)
    for k in flat:
        if k.endswith("/bias"):
            flat[k] = r.normal(0, 0.3, flat[k].shape).astype(np.float32)
    model = tbuild("GUNet", model_kwargs=kw, num_classes=2,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    assert set(state_dict_to_flax(model)) == set(flat)
    assert any(k.startswith("params/context/Conv_0/") for k in flat)
    params = traverse_util.unflatten_dict(
        {k[len("params/"):]: v for k, v in flat.items()}, sep="/")
    want = np.asarray(jmodel.apply({"params": params}, feats, train=False))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_gunet_iin_full_width_shapes_match_flax():
    args = cli.get_args(["nf2", "--mode", "train", "--tag", "t", "--model",
                         "GUNet", "--model_config", "GUNet_IIN.yml",
                         "--classes", "NF", "--use_context", "--ct_base",
                         "32", "--use_spatial", "--normalizer",
                         "instance_norm", "--device", "cpu"])
    model = cli._build_model(args)
    feats = {"images": np.zeros((1, 32, 32, 3), np.float32),
             "sp_guide": np.zeros((1, 32, 32, 1), np.float32),
             "context": np.zeros((1, 32, 32, 3), np.float32)}
    jmodel = jbuild("GUNet", model_kwargs=_iin_kw("GUNet_IIN.yml"),
                    num_classes=2)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                feats, train=False))
    want = {f"params/{k}": tuple(v.shape) for k, v in traverse_util
            .flatten_dict(dict(shapes["params"]), sep="/").items()}
    got = {k: v.shape for k, v in state_dict_to_flax(model).items()}
    assert got == want
    # gammas of levels 1-4 (2 convs each): 2 * 64 * (2 + 4 + 8 + 16)
    assert model.context.MLP_0.Dense_2.weight.shape == (3840, 256)
    assert model.context.Conv_0.weight.shape == (16, 3, 3, 3)
    fused = [n for n, m in model.named_modules()
             if type(m).__name__ == "ConvNormAct" and m.norm is not None]
    assert len(fused) == 8                       # the decoder
    assert model.Encode1_conv1_norm.weight is not None   # level 0: B2


@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("iin_model") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(12, 64, 64), k_split=2,
                           modality="nf", seed=5)
    return root


def _away_from_kinks(params):
    """Norm offsets and transpose-conv biases at 3, so that ReLU inputs sit
    away from 0 (the packages' float32 forwards differ by ~1e-6)."""
    flat = traverse_util.flatten_dict(dict(params), sep="/")
    for k, v in flat.items():
        if k.endswith(("Norm_0/bias", "_norm/InstanceNorm_0/bias",
                       "ConvTranspose_0/bias")):
            flat[k] = jnp.full_like(v, 3.0)
    return traverse_util.unflatten_dict(flat, sep="/")


def test_iin_train_step_matches_jax(nf_root, tmp_path):
    argv = ["nf2", "--mode", "train", "--tag", "t", "--model", "GUNet",
            "--model_config", "GUNet_IIN_TINY.yml", "--classes", "NF",
            "--im_height", "48", "--im_width", "48", "--im_channel", "3",
            "--use_context", "--ct_base", "32", "--use_spatial",
            "--guide_scale", "5", "--zscore", "--normalizer",
            "instance_norm", "--side_dropout", "0", "--test_fold", "0",
            "--k_folds", "2",
            "--compute_dtype", "float32", "--weight_decay_rate", "0.001",
            "--learning_rate", "0.001", "--optimizer", "Momentum",
            "--log_step", "1", "--data_root", str(nf_root.parent),
            "--dataset", nf_root.name, "--model_dir", str(tmp_path / "md")]
    ja, args = jcli.get_args(argv), cli.get_args(argv + ["--device", "cpu"])
    raw = tsamp.IinSampler(nf_root, args, seed=6, tumor_percent=1.0
                           ).sample_batch(4)
    ft, lt = tpipe.make_iin_preprocess_fn(args, train=False)(
        batch_to_device(raw, "cpu"), None)
    feats = {k: ft[k][:2].numpy() for k in ("images", "sp_guide", "context")}
    labels = lt[:2].numpy().astype(np.int32)
    assert labels.any() and feats["sp_guide"].max() > 0.9
    classes = ["Background", "NF"]
    kw = MODEL_CONFIGS["GUNet_IIN_TINY.yml"]
    jmodel = jbuild("GUNet", args=ja, model_kwargs=kw, dtype=jnp.float32)
    solver = Solver(ja)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    state = state.replace(params=_away_from_kinks(state.params))
    flat0 = {f"params/{k}": np.asarray(v) for k, v in traverse_util
             .flatten_dict(dict(state.params), sep="/").items()}
    model = tbuild("GUNet", args=args, model_kwargs=kw, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)
    fts = {k: torch.from_numpy(v) for k, v in feats.items()}
    ltt = torch.from_numpy(labels).long()
    trainer = Trainer(model, args, classes, "cpu",
                      preprocess_fn=lambda batch, gen: (fts, ltt))

    jloss = jmake_loss_fn(ja, classes)
    (jt, jd), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(jmodel.apply({"params": p}, feats, train=True),
                        labels, p), has_aux=True))(state.params)
    grads, tt, td, _ = trainer.gradients(fts, ltt)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    tg = state_dict_to_flax(model, dict(zip(trainer.param_names, grads)))
    jgf = {f"params/{k}": np.asarray(v) for k, v in traverse_util
           .flatten_dict(dict(jg), sep="/").items()}
    assert set(tg) == set(jgf)
    assert any(np.abs(v).max() > 0 for k, v in jgf.items()
               if "/context/" in k)
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    step_fn = jax.jit(make_train_step(jmodel, solver, ja, classes))
    key = jax.random.PRNGKey(1)
    for _ in range(3):
        state, jm = step_fn(state, feats, labels, key)
        vals, _ = trainer.train_step({"names": raw["names"]})
        np.testing.assert_allclose(float(vals[0]), float(jm["total_loss"]),
                                   rtol=1e-5)
    want = {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(state.params), sep="/").items()}
    got = state_dict_to_flax(model)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
    trainer.summary.close()
