"""The click models the port added for the interactive path, the
``--geodesic`` training guides and the click-guided export, against the JAX
package on the CPU:

- InterUNet (plain and ``--img_grad``, whose Sobel edges are new in the
  port), SmallUNet and LGNet (LGNet.yml and LGNet_v3.yml, with and without
  ``--img_grad``) forward on bridged weights within 1e-5 of the logits'
  scale; the bridge maps every flax leaf; the number of conv blocks that run
  kernel B2 (instance norm + ReLU) per forward;
- the building blocks: stride-2 SAME convs and k x k SAME average pools on
  odd sizes, sobel_edges;
- one nf_inter train step of each model against JAX make_train_step: loss
  1e-5 relative, gradients 1e-4, parameters after 3 Momentum steps 1e-5
  (PERF.md §2's train-step row); the L2 term at LGNet_v3's largest
  kernel against float64 and JAX within 1e-6;
- ``--geodesic`` InterSampler batches against JAX's: the geodesic maps
  within one resize rounding (the port's numpy copy of OpenCV's float32
  bilinear), everything else as without it; the pipeline's features;
- ``--mode export`` of UNetInter and InterUNet (nf_inter, zero click guides
  of --guide_channel channels) against JAX's eager serve function within
  1e-5."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from boxsegliver_tpu.cli import main as jmain
from boxsegliver_tpu.data import pipeline_inter as jpi
from boxsegliver_tpu.data import sampler_inter as jsi
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.models import load_model_config as jload_config
from boxsegliver_tpu.models.layers import sobel_edges as jsobel
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import create_train_state
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.train.trainer import make_train_step
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.cli.export import export_model, load_exported
from boxsegliver_torch.data import pipeline_inter as tpi
from boxsegliver_torch.data import sampler_inter as tsi
from boxsegliver_torch.data.pipeline import batch_to_device
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.layers import Conv, avg_pool_same, sobel_edges
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)
SMALL = {"init_channel_factor": 0.125}
CASES = {
    "interunet": ("InterUNet", SMALL, 2),
    "interunet_img_grad": ("InterUNet", dict(SMALL, img_grad=True), 2),
    "smallunet": ("SmallUNet", SMALL, 2),
    "smallunet_gc1": ("SmallUNet", SMALL, 1),
    "lgnet": ("LGNet", MODEL_CONFIGS["LGNet.yml"], 1),
    "lgnet_v3_img_grad": ("LGNet", dict(MODEL_CONFIGS["LGNet_v3.yml"],
                                        img_grad=True), 2),
}
# conv blocks that end in instance norm + ReLU: kernel B2's calls a forward
B2_BLOCKS = {"InterUNet": 25, "SmallUNet": 19, "LGNet": 9}


def _flat(tree, prefix="params"):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(tree), sep="/").items()}


def _feats(gc, hw=(32, 32), bs=2, seed=1):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(bs,) + hw + (3,)).astype(np.float32),
            "sp_guide": rng.uniform(0, 1, (bs,) + hw + (gc,)
                                    ).astype(np.float32)}


def _twins(name, kw, gc, feats, args=None):
    kw = dict(kw, normalizer="instance_norm", use_spatial=True)
    jmodel = jbuild(name, args=args, model_kwargs=kw, num_classes=2,
                    dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), feats, train=False)
    model = tbuild(name, args=args, model_kwargs=dict(kw, guide_channels=gc),
                   num_classes=2, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(_flat(variables["params"])),
                          strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    name, kw, gc = CASES[case]
    feats = _feats(gc, (32, 48) if name != "LGNet" else (32, 32))
    jmodel, variables, model = _twins(name, kw, gc, feats)
    assert set(state_dict_to_flax(model)) == set(_flat(variables["params"]))
    n_b2 = sum(1 for m in model.modules() if type(m).__name__ ==
               "ConvNormAct" and m.norm is not None and m.act)
    assert n_b2 == B2_BLOCKS[name]
    want = np.asarray(jmodel.apply(variables, feats, train=False))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_configs_leave_the_unported_list():
    for name in ("InterUNet.yml", "SmallUNet.yml", "LGNet.yml",
                 "LGNet_v3.yml"):
        assert MODEL_CONFIGS[name] == jload_config("GUNet", name)
    args = cli.get_args(["nf_inter", "--mode", "train", "--tag", "t",
                         "--model", "InterUNet", "--classes", "NF",
                         "--img_grad", "--device", "cpu", "--model_dir",
                         "md"])
    model = cli._build_model(args)
    assert type(model).__name__ == "InterUNet" and model.img_grad
    assert model.image_e0_conv1.conv.weight.shape[1] == 3 + 2
    assert model.inter_e0_conv1.conv.weight.shape[1] == 3 + 2
    args = cli.get_args(["nf_inter", "--mode", "train", "--tag", "t",
                         "--model", "LGNet", "--model_config", "LGNet_v3.yml",
                         "--classes", "NF", "--use_spatial", "--device",
                         "cpu", "--model_dir", "md"])
    model = cli._build_model(args)
    assert model.mod_layers == ((1,), (2,))
    assert model.spatial_e2.weight.shape[1] == 2      # --guide_channel


@pytest.mark.parametrize("size", [(9, 7), (8, 6)])
def test_strided_conv_and_pools_match_flax(size):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2,) + size + (3,)).astype(np.float32)
    for stride, dil in ((2, 1), (1, 2)):
        conv = nn.Conv(4, (3, 3), strides=(stride, stride),
                       kernel_dilation=(dil, dil), padding="SAME")
        v = conv.init(jax.random.PRNGKey(1), x)
        want = np.asarray(conv.apply(v, x))
        tconv = Conv(3, 4, 3, stride=stride, dilation=dil)
        tconv.load_state_dict({k.split(".")[-1]: t for k, t in
                               flax_to_state_dict(_flat(v["params"],
                                                        "params/c")).items()})
        with torch.no_grad():
            got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-5)
    for k in (2, 4):
        want = np.asarray(nn.avg_pool(x, (k, k), strides=(k, k),
                                      padding="SAME"))
        got = avg_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), k)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-6)
    want = np.asarray(jsobel(jnp.asarray(x[..., :1])))
    got = sobel_edges(torch.from_numpy(x[..., :1])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("inter_models") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(10, 80, 72), k_split=2,
                           modality="nf", seed=4)
    return root


def _args(root, model_dir, *extra, model="UNetInter",
          config="UNetInter_TINY.yml", hw=("48", "40"), bs=6):
    return cli.get_args([
        "nf_inter", "--mode", "train", "--tag", "t_inter", "--model", model,
        "--model_config", config, "--classes", "NF", "--batch_size", str(bs),
        "--im_height", hw[0], "--im_width", hw[1], "--im_channel", "3",
        "--test_fold", "0", "--k_folds", "2", "--tumor_percent", "0.5",
        "--zoom_scale", "1.0", "1.3", "--noise_scale", "0.05",
        "--random_flip", "3", "--normalizer", "instance_norm",
        "--loss_weight_type", "numerical", "--loss_numeric_w", "1", "1",
        "--model_dir", str(model_dir), "--data_root", str(Path(root).parent),
        "--dataset", Path(root).name, "--device", "cpu", *extra])


def _away_from_kinks(params):
    """Norm offsets, up-conv biases and the LGNet guide convs' biases at 3,
    so that ReLU inputs sit away from 0 (the packages' float32 forwards
    differ by ~1e-6; a pre-activation within that of 0 passes its gradient
    in one and blocks it in the other)."""
    flat = traverse_util.flatten_dict(dict(params), sep="/")
    for k, v in flat.items():
        if k.endswith(("Norm_0/bias", "ConvTranspose_0/bias")) or (
                k.startswith("spatial_") and k.endswith("/bias")):
            flat[k] = jnp.full_like(v, 3.0)
    return traverse_util.unflatten_dict(flat, sep="/")


TRAIN_CASES = {
    "105_interunet_v1": ("InterUNet", "InterUNet.yml",
                         dict(SMALL, img_grad=True), ["--img_grad"]),
    "104_small_v3": ("SmallUNet", "SmallUNet.yml", SMALL, []),
    "lgnet": ("LGNet", "LGNet.yml", MODEL_CONFIGS["LGNet.yml"], []),
    "103_lgnet_v3": ("LGNet", "LGNet_v3.yml", MODEL_CONFIGS["LGNet_v3.yml"],
                     []),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(nf_root, tmp_path, case):
    name, config, kw, extra = TRAIN_CASES[case]
    args = _args(nf_root, tmp_path / "md", "--use_spatial", "--compute_dtype",
                 "float32", "--weight_decay_rate", "0.001",
                 "--learning_policy", "plateau", "--learning_rate", "0.001",
                 "--log_step", "1", "--optimizer", "Momentum", *extra,
                 model=name, config=config)
    gc = int(args.guide_channel)
    feats = _feats(gc, (32, 32), bs=2, seed=3)
    yy, xx = np.mgrid[:32, :32]
    labels = np.stack([(yy - 12) ** 2 + (xx - 15) ** 2 < 30,
                       (yy - 20) ** 2 + (xx - 9) ** 2 < 50]).astype(np.int32)
    classes = ["Background", "NF"]
    kw = dict(kw)
    jmodel = jbuild(name, args=args, model_kwargs=kw, dtype=jnp.float32)
    solver = Solver(args)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    state = state.replace(params=_away_from_kinks(state.params))
    model = tbuild(name, args=args, model_kwargs=kw, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(_flat(state.params)),
                          strict=True)
    fts = {k: torch.from_numpy(v) for k, v in feats.items()}
    ltt = torch.from_numpy(labels).long()
    trainer = Trainer(model, args, classes, "cpu",
                      preprocess_fn=lambda batch, gen: (fts, ltt))
    jloss = jmake_loss_fn(args, classes)
    (jt, jd), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(jmodel.apply({"params": p}, feats, train=True),
                        labels, p), has_aux=True))(state.params)
    grads, tt, td, _ = trainer.gradients(fts, ltt)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    tg = state_dict_to_flax(model, dict(zip(trainer.param_names, grads)))
    jgf = _flat(jg)
    assert set(tg) == set(jgf)
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    step_fn = jax.jit(make_train_step(jmodel, solver, args, classes))
    for _ in range(3):
        state, jm = step_fn(state, feats, labels, jax.random.PRNGKey(1))
        vals, _ = trainer.train_step({"names": np.zeros(2, np.int32)})
        np.testing.assert_allclose(float(vals[0]), float(jm["total_loss"]),
                                   rtol=1e-5)
    got = state_dict_to_flax(model)
    for k, v in _flat(state.params).items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
    trainer.summary.close()


def test_l2_regularization_matches_jax_at_lgnet_v3_sizes():
    """The L2 term over a kernel of LGNet_v3's largest size (9.4M elements)
    and a few small ones: within 1e-6 relative of float64 and of JAX's
    (ROADMAP C4: a sequential float32 norm fell outside 1e-5 here)."""
    from boxsegliver_tpu.ops import losses as jlosses
    from boxsegliver_torch.ops import losses as tlosses

    rng = np.random.default_rng(9)
    shapes = [(3, 3, 1024, 1024), (3, 3, 64, 32), (1, 1, 32, 2), (2,)]
    ws = [(rng.normal(size=s) * 0.02).astype(np.float32) for s in shapes]
    want = 0.5 * 1e-3 * sum(float(np.sum(w.astype(np.float64) ** 2))
                            for w in ws)
    got = float(tlosses.l2_regularization(
        [torch.from_numpy(w) for w in ws], 1e-3))
    tree = {f"conv{i}": {"kernel": jnp.asarray(w)} for i, w in enumerate(ws)}
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, float(jlosses.l2_regularization(tree, 1e-3)), rtol=1e-6)


# ---------------------------------------------------------------------------
# --geodesic
# ---------------------------------------------------------------------------

def test_geodesic_sampler_matches_jax(nf_root, tmp_path):
    args = _args(nf_root, tmp_path / "m", "--geodesic")
    for mode, seed in (("train", 3), ("eval", None)):
        js = jsi.InterSampler(nf_root, args, mode=mode, seed=seed,
                              max_clicks=args.max_clicks)
        ts = tsi.InterSampler(nf_root, args, mode=mode, seed=seed,
                              max_clicks=args.max_clicks)
        for _ in range(2):
            a, b = ts.sample_batch(6), js.sample_batch(6)
            assert sorted(a) == sorted(b)
            for k in a:
                if k in ("image", "fg_gd", "bg_gd"):
                    continue
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert int(np.abs(a["image"].astype(np.int64)
                              - b["image"].astype(np.int64)).max()) <= 1
            same = (a["image"] == b["image"]).all(axis=(1, 2, 3))
            for k in ("fg_gd", "bg_gd"):
                assert a[k].dtype == np.float32
                np.testing.assert_allclose(
                    a[k][same], b[k][same], rtol=1e-5,
                    atol=1e-5 * max(1.0, float(np.abs(b[k]).max())))
            assert a["fg_gd"].any() and a["bg_gd"].any()


@pytest.mark.parametrize("gc", ["1", "2"])
def test_geodesic_pipeline_matches_jax(nf_root, tmp_path, gc):
    args = _args(nf_root, tmp_path, "--geodesic", "--guide_channel", gc)
    batch = tsi.InterSampler(nf_root, args, seed=2).sample_batch(6)
    fj, lj = jax.jit(jpi.make_inter_preprocess_fn(args, train=False))(
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    ft, lt = tpi.make_inter_preprocess_fn(args, train=False)(
        batch_to_device(batch, "cpu"), None)
    assert ft["sp_guide"].shape == (6, 48, 40, int(gc))
    for k in ("images", "sp_guide"):
        want = np.asarray(fj[k])
        np.testing.assert_allclose(ft[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


# ---------------------------------------------------------------------------
# the click-guided export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,config,gc", [
    ("UNetInter", "UNetInter_TINY.yml", "2"), ("InterUNet", "tiny", "1")])
def test_click_export_matches_jax_serve(nf_root, tmp_path, monkeypatch,
                                        model, config, gc):
    from boxsegliver_torch import models as tmodels
    if config == "tiny":
        monkeypatch.setitem(tmodels.MODEL_CONFIGS, "tiny.yml", SMALL)
        config = "tiny.yml"
    argv = ["nf_inter", "--mode", "export", "--tag", "texp", "--model",
            model, "--model_config", config, "--classes", "NF",
            "--batch_size", "2", "--im_height", "32", "--im_width", "32",
            "--im_channel", "3", "--guide_channel", gc, "--normalizer",
            "instance_norm", "--compute_dtype", "float32", "--test_fold",
            "0", "--k_folds", "2", "--model_dir", str(tmp_path / "m"),
            "--data_root", str(nf_root.parent), "--dataset", nf_root.name]
    args = cli.get_args(argv + ["--device", "cpu"])
    kw = dict(SMALL if config == "tiny.yml" else MODEL_CONFIGS[config])
    jmodel = jbuild(model, args=args, model_kwargs=kw, dtype=jnp.float32)
    feats = {"images": np.zeros((2, 32, 32, 3), np.float32),
             "sp_guide": np.zeros((2, 32, 32, int(gc)), np.float32)}
    variables = jmodel.init(jax.random.PRNGKey(2), feats, train=False)
    torch.save({"model": flax_to_state_dict(_flat(variables["params"]))},
               tmp_path / "w.pt")
    args = cli.get_args(argv + ["--device", "cpu", "--ckpt_path",
                                str(tmp_path / "w.pt")])
    out = export_model(args, out_dir=tmp_path / "bundle")
    serve, signature = load_exported(out, device="cpu")
    assert signature["inputs"]["sp_guide"] == [[2, 32, 32, int(gc)],
                                               "float32"]
    rng = np.random.RandomState(0)
    req = {"images": rng.randn(2, 32, 32, 3).astype(np.float32),
           "sp_guide": rng.rand(2, 32, 32, int(gc)).astype(np.float32)}
    want = np.asarray(jax.nn.softmax(jmodel.apply(variables, req,
                                                  train=False), -1))
    got = serve(req).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert jmain.build_feature_template(jmain.get_args(argv))[
        "sp_guide"].shape == (2, 32, 32, int(gc))
