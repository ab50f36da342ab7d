"""The port's data-parallel training on the CPU (gloo): ranks are spawned
processes that import no JAX (tests/test_torch_dist_workers.py); the JAX
side runs here on the conftest's fake CPU devices.

- A 2-rank step of UNet_TINY with batch norm (sync batch norm) and of
  GUNet_TINY with instance norm (float32, features given, no draws)
  against JAX ``Trainer(num_replicas=2)``: total and data loss within 1e-5
  relative, the global batch's gradients within 1e-4 (JAX's
  value_and_grad over the same batch: the mesh changes no arithmetic),
  parameters and running statistics after 3 Momentum steps within 1e-5,
  every rank holding the same parameters.
- World-size invariance: N ranks (2 and 4) equal one process over the same
  global batch with the draws on (noise, flips, dropout; the preprocess of
  data/pipeline.py): step values 1e-5 relative, parameters and running
  statistics 1e-5.
- The group's contracts: JAX's per_device_batch_size and make_mesh errors,
  the device rule on the card, a gloo collective refused inside a CUDA
  graph capture, the rank rows of a batch and of its draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu import config as jconfig
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.parallel import make_mesh
from boxsegliver_tpu.parallel import mesh as jmesh
from boxsegliver_tpu.train.trainer import Trainer as JTrainer
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.parallel import launch, mesh as tmesh
from test_torch_dist_workers import CLASSES, train_rank

torch.set_num_threads(2)
FLAGS = ["--mode", "train", "--tag", "t", "--classes", "Liver", "Tumor",
         "--compute_dtype", "float32", "--loss_weight_type", "numerical",
         "--loss_numeric_w", "0.2", "0.4", "4.4", "--weight_decay_rate",
         "0.001", "--learning_policy", "plateau", "--learning_rate", "0.001",
         "--lr_end", "0.0000005", "--log_step", "1", "--optimizer",
         "Momentum", "--batch_size", "4"]
CASES = {
    "unet_batch_norm": ("UNet", "UNet_TINY.yml", ["--normalizer",
                                                  "batch_norm"]),
    "gunet_instance_norm": ("GUNet", "GUNet_TINY.yml",
                            ["--normalizer", "instance_norm",
                             "--use_context", "--context_list", "hist", "16",
                             "--use_spatial", "--side_dropout", "0"]),
}


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.tree_util.tree_map(
                np.asarray, dict(tree)), sep="/").items()}


def _away_from_kinks(params):
    """Norm offsets and transpose-conv biases at 3: the ReLUs' inputs sit
    away from 0, where the packages' ~1e-6 forward differences would flip
    a gradient (as tests/test_torch_unet_train.py)."""
    flat = traverse_util.flatten_dict(dict(params), sep="/")
    for k, v in flat.items():
        if k.endswith(("Norm_0/bias", "ConvTranspose_0/bias")):
            flat[k] = jnp.full_like(v, 3.0)
    return traverse_util.unflatten_dict(flat, sep="/")


def _features(model_name, bs=4, size=32, seed=0):
    rng = np.random.default_rng(seed)
    feats = {"images": rng.normal(size=(bs, size, size, 3)).astype(
        np.float32)}
    if model_name == "GUNet":
        feats["sp_guide"] = rng.uniform(0.5, 1.0, (bs, size, size, 1)
                                        ).astype(np.float32)
        feats["context"] = rng.normal(size=(bs, 16)).astype(np.float32)
    labels = rng.integers(0, 3, (bs, size, size)).astype(np.int32)
    return feats, labels


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_jax_mesh(tmp_path, case):
    model_name, config, extra = CASES[case]
    argv = FLAGS + ["--model", model_name] + extra + ["--model_dir",
                                                     str(tmp_path / "j")]
    parser = jconfig.build_parser()
    ja = parser.parse_args(argv)
    jconfig.check_args(ja, parser)
    kw = MODEL_CONFIGS[config]
    feats, labels = _features(model_name)

    jmodel = jbuild(model_name, args=ja, model_kwargs=kw, dtype=jnp.float32)
    jt = JTrainer(jmodel, ja, CLASSES, sample_features=feats,
                  num_replicas=2)
    assert jt.mesh.size == 2
    rep = jmesh.replicated_sharding(jt.mesh)
    jt.state = jax.device_put(jt.state.replace(
        params=_away_from_kinks(jt.state.params)), rep)
    flat0 = _flat(jt.state.params, "params")
    if jt.state.batch_stats:
        flat0.update(_flat(jt.state.batch_stats, "batch_stats"))
    assert bool(jt.state.batch_stats) == ("batch_norm" in case)

    # the global batch's gradients (a sharded batch changes no arithmetic)
    jloss = jmake_loss_fn(ja, CLASSES)
    key = jax.random.PRNGKey(1)

    def total(p):
        variables = {"params": p}
        if jt.state.batch_stats:
            variables["batch_stats"] = jt.state.batch_stats
            logits, _ = jmodel.apply(variables, feats, train=True,
                                     rngs={"dropout": key},
                                     mutable=["batch_stats"])
        else:
            logits = jmodel.apply(variables, feats, train=True,
                                  rngs={"dropout": key})
        return jloss(logits, labels, p)

    (want_t, want_d), jg = jax.value_and_grad(total, has_aux=True)(
        jt.state.params)
    jvals = [jt.train_step(feats, labels) for _ in range(3)]
    jt.ckpt.close()

    targv = argv[:-1] + [str(tmp_path / "t")]
    got = launch(train_rank, 2, "cpu", {
        "argv": targv, "model": model_name, "kw": kw, "steps": 3,
        "state": flax_to_state_dict(flat0), "feats": feats,
        "labels": labels})
    np.testing.assert_allclose(got["total"], float(want_t), rtol=1e-5)
    np.testing.assert_allclose(got["data"], float(want_d), rtol=1e-5)
    ta = tconfig.build_parser().parse_args(targv)
    model = tbuild(model_name, args=ta, model_kwargs=kw, dtype=torch.float32)
    tg = state_dict_to_flax(model, {k: torch.from_numpy(v)
                                    for k, v in got["grads"].items()})
    jgf = _flat(jg, "params")
    assert set(tg) == set(jgf)
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    for step, m in enumerate(jvals):
        np.testing.assert_allclose(got["values"][step, 0],
                                   float(m["total_loss"]), rtol=1e-5)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in got["state"].items()})
    have = state_dict_to_flax(model)
    want = _flat(jt.state.params, "params")
    if jt.state.batch_stats:
        want.update(_flat(jt.state.batch_stats, "batch_stats"))
        assert any(k.startswith("batch_stats/")
                   and not np.allclose(want[k], flat0[k]) for k in want)
    assert set(have) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, atol=1e-5, rtol=0, err_msg=k)
    assert got["spread"] == 0.0


# ---------------------------------------------------------------------------
# N ranks against one process, with the draws on
# ---------------------------------------------------------------------------

INVARIANCE = {
    "unet_batch_norm": ("UNet", "UNet_TINY.yml", ["--normalizer",
                                                  "batch_norm"]),
    "gunet_dropout": ("GUNet", "GUNet_TINY.yml",
                      ["--normalizer", "instance_norm", "--use_context",
                       "--context_list", "hist", "16", "--use_spatial",
                       "--side_dropout", "0.3"]),
}


def _raw_batch(spatial, bs=8, size=32, seed=4):
    """A global host-layout raw batch (data/sampler.TrainSampler's resized
    layout), with spatial guides and context for G-Net."""
    rng = np.random.default_rng(seed)
    raw = {"image": rng.integers(0, 400, (bs, size, size, 3)).astype(
                np.uint16),
            "label": rng.integers(0, 3, (bs, size, size)).astype(np.uint8),
            "clip": np.tile(np.asarray([[50.0, 300.0]], np.float32),
                            (bs, 1)),
            "pad_mask": np.ones((bs, 3), np.float32),
            "names": np.arange(bs, dtype=np.int32),
            "centers": rng.uniform(4, size - 4, (bs, 2, 2)).astype(
                np.float32),
            "stddevs": rng.uniform(2, 6, (bs, 2, 2)).astype(np.float32),
            "n_objs": rng.integers(0, 3, (bs,)).astype(np.int32),
            "context": rng.normal(size=(bs, 16)).astype(np.float32)}
    if not spatial:
        for k in ("centers", "stddevs", "n_objs", "context"):
            raw.pop(k)
    return raw


@pytest.mark.parametrize("case,ranks", [("unet_batch_norm", 2),
                                        ("unet_batch_norm", 4),
                                        ("gunet_dropout", 2)])
def test_ranks_equal_one_process(tmp_path, case, ranks):
    model_name, config, extra = INVARIANCE[case]
    argv = (FLAGS + ["--model", model_name, "--im_height", "32",
                     "--im_width", "32", "--noise_scale", "0.05",
                     "--random_flip", "3", "--batch_size", "8"] + extra
            + ["--model_dir", str(tmp_path / "one")])
    kw = MODEL_CONFIGS[config]
    ta = tconfig.build_parser().parse_args(argv)
    model = tbuild(model_name, args=ta, model_kwargs=kw, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    spec = {"argv": argv, "model": model_name, "kw": kw, "steps": 3,
            "state": model.state_dict(),
            "raw": _raw_batch(model_name == "GUNet")}
    one = train_rank(None, spec)
    spec["argv"] = argv[:-1] + [str(tmp_path / "group")]
    got = launch(train_rank, ranks, "cpu", spec)
    np.testing.assert_allclose(got["values"], one["values"], rtol=1e-5,
                               atol=1e-7)
    moved = 0
    for k, v in one["state"].items():
        np.testing.assert_allclose(got["state"][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)
        moved += not np.allclose(v, spec["state"][k].numpy())
    assert moved and got["spread"] == 0.0


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,replicas", [(17, 8), (6, 4), (16, 8)])
def test_per_device_batch_size_matches_jax(batch, replicas):
    try:
        want = jmesh.per_device_batch_size(batch, replicas)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.per_device_batch_size(batch, replicas)
        assert str(got.value) == str(e)
    else:
        assert tmesh.per_device_batch_size(batch, replicas) == want


def test_too_many_replicas_raise_as_jax():
    n = len(jax.devices())
    with pytest.raises(ValueError) as want:
        make_mesh(n + 1)
    with pytest.raises(ValueError) as got:
        tmesh.resolve_replicas(tmesh.device_count("cpu") + 1, "cpu")
    assert str(want.value).startswith("Requested ")
    assert str(got.value) == (f"Requested {tmesh.device_count('cpu') + 1} "
                              f"replicas but only "
                              f"{tmesh.device_count('cpu')} devices")
    # 0: one process on the CPU (every visible GPU on the card)
    assert tmesh.resolve_replicas(0, "cpu") == 1
    assert tmesh.resolve_replicas(3, "cpu") == 3


def test_replicas_on_the_card_and_no_silent_fallback(monkeypatch):
    """0 replicas on the card take every visible GPU; more than they raise
    JAX's error; a gloo collective asked to run inside a CUDA graph capture
    raises (under gloo the trainer runs K > 1 steps eagerly instead)."""
    import types

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.resolve_replicas(0, "cuda") == 4
    assert tmesh.resolve_replicas(2, "cuda") == 2
    with pytest.raises(ValueError, match="Requested 5 replicas but only 4 "
                                         "devices"):
        tmesh.resolve_replicas(5, "cuda")
    group = tmesh.Group.__new__(tmesh.Group)
    group.backend = "gloo"
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        group.all_reduce_(types.SimpleNamespace(is_cuda=True))


def test_rank_rows_and_draws():
    """Rank r of N keeps rows [r·b, (r+1)·b) of a global batch and of its
    draws (made for the global batch)."""
    import types

    group = types.SimpleNamespace(size=4, rank=2)
    group.rows = lambda n: tmesh.Group.rows(group, n)
    draws = {"flip": torch.arange(24.).reshape(8, 3),
             "noise": torch.arange(8.)}
    got = tmesh.rank_draws(draws, group)
    assert torch.equal(got["flip"], draws["flip"][4:6])
    assert torch.equal(got["noise"], torch.tensor([4., 5.]))
    assert tmesh.rank_draws(draws, None) is draws
    with pytest.raises(ValueError, match="try --batch_size=4"):
        group.rows(6)
