"""The port's UNet3D against the flax UNet3D through the weight bridge, at
small widths on the CPU (init_channels 4, max_channels 16): the eval
forward at 4 and 5 pools, with and without the click guide, with instance
norm, batch norm and no norm, in float32 within 1e-5 of the logits' scale;
the rank-5 bridge both ways (exact); one whole train step of the
``201_unet_v1.sh`` flags against JAX ``make_train_step`` (loss 1e-5
relative, gradients 1e-4, parameters after one step 1e-5 — a Momentum
step: the first Adam step is lr·g/(|g| + eps), so a gradient element
within round-off of 0 moves by up to ±lr in either package, as
tests/test_torch_unet_train.py explains; Adam itself is held against optax
in tests/test_torch_train.py); kernel B2's
plain version at rank 5 against flax ``Norm('instance_norm')`` + ReLU
(autodiff, the JAX default path for rank-5 inputs; float32, the tolerance
of tests/test_torch_in_relu.py) and its autograd Function against
torch.autograd.gradcheck in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu import config as jconfig
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.models import load_model_config as jload_config
from boxsegliver_tpu.models.layers import Norm as JNorm
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import create_train_state
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.train.trainer import make_train_step
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.ops import kernels
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)
TINY = {"init_channels": 4, "max_channels": 16}
CLASSES = ["Background", "NF"]

FORWARD_CASES = {
    "pool4_in": (dict(TINY, num_pool_layers=4), False, "instance_norm", 32),
    "pool4_in_spatial": (dict(TINY, num_pool_layers=4), True,
                         "instance_norm", 32),
    "pool4_bn": (dict(TINY, num_pool_layers=4), False, "batch_norm", 32),
    "pool4_no_norm": (dict(TINY, num_pool_layers=4, without_norm=True),
                      True, "instance_norm", 32),
    "pool5_in": (dict(TINY, num_pool_layers=5), False, "instance_norm", 64),
    "pool5_bn_spatial": (dict(TINY, num_pool_layers=5), True, "batch_norm",
                         64),
}


def _feats(rng, spatial, size, depth=4, bs=2):
    feats = {"images": rng.normal(size=(bs, depth, size, size, 1)
                                  ).astype(np.float32)}
    if spatial:
        feats["sp_guide"] = rng.uniform(0, 1, (bs, depth, size, size, 2)
                                        ).astype(np.float32)
    return feats


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.tree_util.tree_map(
                np.asarray, dict(tree)), sep="/").items()}


def _randomized(variables, rng):
    """flax init with every norm leaf and running statistic randomized, so
    the bridge's placement of each one matters."""
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables)), sep="/")
    for key, val in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("bias", "scale", "mean"):
            flat[key] = rng.normal(0, 0.5, val.shape).astype(np.float32)
        elif leaf == "var":
            flat[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
    return flat


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_flax(case):
    kw, spatial, norm, size = FORWARD_CASES[case]
    kw = dict(kw, use_spatial=spatial, normalizer=norm)
    rng = np.random.default_rng(len(case))
    feats = _feats(rng, spatial, size)
    jmodel = jbuild("UNet3D", model_kwargs=kw, num_classes=2)
    flat = _randomized(jmodel.init(jax.random.PRNGKey(0), feats), rng)
    ref = np.asarray(jmodel.apply(traverse_util.unflatten_dict(flat, sep="/"),
                                  feats, train=False))
    model = tbuild("UNet3D", model_kwargs=dict(kw, in_channels=1,
                                                 sp_channels=2),
                   num_classes=2)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in feats.items()},
                    train=False).numpy()
    assert got.shape == ref.shape == feats["images"].shape[:4] + (2,)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_bridge_round_trips_rank5_kernels():
    """flax → torch → flax is exact; a conv kernel [kd, kh, kw, in, out]
    lands as [out, in, kd, kh, kw], a transpose-conv kernel as [in, out,
    kd, kh, kw] with every spatial axis flipped (the (1, 2, 2) taps'
    depth axis of one onto itself)."""
    rng = np.random.default_rng(0)
    kw = dict(TINY, num_pool_layers=4, use_spatial=True)
    feats = _feats(rng, True, 32)
    flat = _randomized(jbuild("UNet3D", model_kwargs=kw, num_classes=2)
                       .init(jax.random.PRNGKey(1), feats), rng)
    state = flax_to_state_dict(flat)
    model = tbuild("UNet3D", model_kwargs=dict(kw, in_channels=1,
                                                 sp_channels=2),
                   num_classes=2)
    model.load_state_dict(state, strict=True)
    back = state_dict_to_flax(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    conv = flat["params/conv_e2_conv1/Conv_0/kernel"]
    np.testing.assert_array_equal(
        state["conv_e2_conv1.conv.weight"].numpy(),
        conv.transpose(4, 3, 0, 1, 2))
    for up, taps in (("conv_d3", (2, 2, 2)), ("conv_d2", (1, 2, 2))):
        k = flat[f"params/{up}_up/ConvTranspose_0/kernel"]
        assert k.shape[:3] == taps
        np.testing.assert_array_equal(
            state[f"{up}_up.weight"].numpy(),
            k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))


def test_unet3d_config_is_carried_and_built_from_the_flags():
    """UNet3D.yml moved to the ported side: carried as the JAX file says,
    and built with JAX's 3-D template widths (one image channel, two with
    --use_cascade; --guide_channel guide channels under --use_spatial)."""
    assert MODEL_CONFIGS["UNet3D.yml"] == jload_config("UNet3D")
    parser = tconfig.build_parser()
    for extra, cin in (([], 1), (["--use_cascade"], 2),
                       (["--use_spatial", "--guide_channel", "1"], 2),
                       (["--use_spatial", "--use_cascade"], 4)):
        args = parser.parse_args(["--mode", "train", "--tag", "t",
                                  "--model", "UNet3D", "--classes", "NF",
                                  "--im_channel", "3"] + extra)
        model = tbuild("UNet3D", args=args, model_kwargs=dict(TINY))
        assert model.conv_e0_conv1.conv.weight.shape[1] == cin
        assert model.logits.weight.shape[0] == 2


# ---------------------------------------------------------------------------
# one train step against JAX make_train_step
# ---------------------------------------------------------------------------

STEP_FLAGS = ["--mode", "train", "--tag", "t", "--model", "UNet3D",
              "--classes", "NF", "--compute_dtype", "float32",
              "--loss_weight_type", "numerical", "--loss_numeric_w", "1", "1",
              "--weight_decay_rate", "0.00003", "--learning_policy",
              "plateau", "--learning_rate", "0.0003", "--lr_end",
              "0.0000005", "--lr_decay_rate", "0.2", "--log_step", "1",
              "--im_depth", "4", "--im_height", "32", "--im_width", "32",
              "--optimizer", "Momentum"]


def _away_from_kinks(params):
    """Norm offsets at 3 so the ReLUs' inputs sit away from 0 (see
    tests/test_torch_unet_train.py: a pre-activation within the packages'
    ~1e-6 of 0 passes its gradient in one and blocks it in the other)."""
    flat = traverse_util.flatten_dict(dict(params), sep="/")
    for k, v in flat.items():
        if k.endswith("Norm_0/bias") or k.endswith("BatchNorm_0/bias"):
            flat[k] = jnp.full_like(v, 3.0)
    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.mark.parametrize("norm", ["instance_norm", "batch_norm"])
def test_train_step_matches_jax(tmp_path, norm):
    argv = STEP_FLAGS + ["--normalizer", norm, "--model_dir", str(tmp_path)]
    jparser = jconfig.build_parser()
    ja = jparser.parse_args(argv)
    jconfig.check_args(ja, jparser)
    ta = tconfig.build_parser().parse_args(argv)
    kw = dict(TINY, num_pool_layers=4)
    rng = np.random.default_rng(1)
    feats = _feats(rng, False, 32)
    labels = rng.integers(0, 2, (2, 4, 32, 32)).astype(np.int32)
    jmodel = jbuild("UNet3D", args=ja, model_kwargs=kw, dtype=jnp.float32)
    solver = Solver(ja)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    state = state.replace(params=_away_from_kinks(state.params))
    flat0 = _flat(state.params, "params")
    if state.batch_stats:
        flat0.update(_flat(state.batch_stats, "batch_stats"))
    assert bool(state.batch_stats) == (norm == "batch_norm")

    model = tbuild("UNet3D", args=ta, model_kwargs=kw, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)
    ft = {k: torch.from_numpy(v) for k, v in feats.items()}
    lt = torch.from_numpy(labels).long()
    trainer = Trainer(model, ta, CLASSES, "cpu",
                      preprocess_fn=lambda batch, gen: (ft, lt))

    jloss = jmake_loss_fn(ja, CLASSES)
    key = jax.random.PRNGKey(1)

    def total(p):
        variables = {"params": p}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
            logits, _ = jmodel.apply(variables, feats, train=True,
                                     mutable=["batch_stats"])
        else:
            logits = jmodel.apply(variables, feats, train=True)
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
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)

    step_fn = jax.jit(make_train_step(jmodel, solver, ja, CLASSES))
    state, jm = step_fn(state, feats, labels, key)
    vals, lr = trainer.train_step({"names": np.zeros((2,), np.int32)})
    np.testing.assert_allclose(float(vals[0]), float(jm["total_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(lr, float(jm["learning_rate"]), rtol=1e-7)
    got = state_dict_to_flax(model)
    want = _flat(state.params, "params")
    if state.batch_stats:
        want.update(_flat(state.batch_stats, "batch_stats"))
    assert set(got) == set(want)
    moved = [k for k in want if not np.array_equal(want[k], flat0[k])]
    assert len(moved) > len(want) // 2          # the step moved them
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# kernel B2's plain version at rank 5
# ---------------------------------------------------------------------------

B2_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 5), (1, 4, 6, 5, 1)],
                         ids=["b2_c5", "b1_c1"])                # NDHWC
def test_b2_rank5_matches_flax_norm_relu_autodiff(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.2, 1.5, shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    w = (rng.normal(size=c) * 0.3 + 1.0).astype(np.float32)
    b = (rng.normal(size=c) * 0.3).astype(np.float32)
    norm = JNorm("instance_norm")
    params = {"params": {"InstanceNorm_0": {"scale": jnp.asarray(w),
                                            "bias": jnp.asarray(b)}}}

    def f(x_, p):
        return jax.nn.relu(norm.apply(p, x_))

    y_j, vjp = jax.vjp(f, jnp.asarray(x), params)
    dx_j, dp = vjp(jnp.asarray(g))

    def ncdhw(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 4, 1, 2, 3)))

    xt = ncdhw(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = kernels.instance_norm_relu(xt, wt, bt)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), ncdhw(g))
    want = (y_j, dx_j, dp["params"]["InstanceNorm_0"]["scale"],
            dp["params"]["InstanceNorm_0"]["bias"])
    got = (y.detach().numpy().transpose(0, 2, 3, 4, 1),
           dx.numpy().transpose(0, 2, 3, 4, 1), dw.numpy(), db.numpy())
    for a, ref, name in zip(got, want, ("y", "dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(a, np.asarray(ref), err_msg=name,
                                   **B2_TOL)


def test_b2_function_passes_gradcheck_in_float64_at_rank5():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 3, 4, 5), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = (torch.rand(3, generator=gen, dtype=torch.float64) + 0.5
         ).requires_grad_(True)
    b = (torch.randn(3, generator=gen, dtype=torch.float64) * 0.3
         ).requires_grad_(True)
    assert torch.autograd.gradcheck(kernels.InstanceNormReLU.apply,
                                    (x, w, b))


def test_b2_wrappers_take_any_plane_rank():
    """The plain versions normalize each (n, c) plane of [N, C, *S] whatever
    its rank: NCDHW equals the same data seen as NCHW planes of D·H by W,
    and the CUDA operand check takes rank >= 3 only."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, 4, 5, 6), generator=gen)
    w = torch.rand(3, generator=gen) + 0.5
    b = torch.randn(3, generator=gen)
    y5, xh5, r5 = kernels.in_relu_fwd_plain(x, w, b)
    y4, xh4, r4 = kernels.in_relu_fwd_plain(x.reshape(2, 3, 20, 6), w, b)
    torch.testing.assert_close(y5.reshape(y4.shape), y4)
    torch.testing.assert_close(r5, r4)
    g = torch.randn(x.shape, generator=gen)
    s5 = kernels.in_relu_bwd_stats_plain(g, xh5, w, b)
    s4 = kernels.in_relu_bwd_stats_plain(g.reshape(y4.shape), xh4, w, b)
    for a, c in zip(s5, s4):
        torch.testing.assert_close(a, c)
    dx5 = kernels.in_relu_bwd_apply_plain(g, xh5, w, b, r5, *s5)
    dx4 = kernels.in_relu_bwd_apply_plain(g.reshape(y4.shape), xh4, w, b,
                                          r4, *s4)
    torch.testing.assert_close(dx5.reshape(dx4.shape), dx4)
    kernels._check_in_relu("t", x, (), w, b)
    with pytest.raises(ValueError, match=r"\[N, C, \*S\]"):
        kernels._check_in_relu("t", x[0, 0, 0], (), w, b)
