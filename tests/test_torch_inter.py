"""The port's nf_inter click-simulation path against the JAX package's on the
CPU:

- ``interactive/clicks``: inter_simulation (every strategy, fg and bg,
  with and without the negatives patch) and next_click_from_error give
  array-equal clicks from the same RandomState;
- ``InterSampler`` batches (fg / fp / random crops, zoom, clicks, ``-ds``,
  ``--fp_sample`` with ``--fp_version 1|2``, the fixed eval batches):
  clicks, counts, rescale, labels, pad masks and names equal; images (the
  host bilinear resize of uint16 windows, OpenCV in JAX, numpy in the port)
  within one uint16 level, the pixels off counted and printed;
- ``build_neg_cache`` (one prediction dir and the union of two): equal
  caches;
- ``pipeline_inter``: features within 1e-5 for guide_channel 1 and 2, with
  and without --local_enhance, train (JAX's draws injected) and eval;
- UNetInter (plain, --mid_cat, --img_grad) and GUNet --img_grad forward on
  bridged weights within 1e-4;
- an nf_inter UNetInter_TINY train step against JAX make_train_step: loss
  1e-5 relative, gradients 1e-4, parameters after 3 Momentum steps 1e-5;
- the ``101_unetinter_v10.sh`` and ``103_grad.sh`` CLIs on a tiny set with
  --device cpu: train with the online eval, then ``nf_inter --mode eval``
  (eval_results_2d.txt) — JAX's
  test_nf_inter_end_to_end_train_and_online_eval on the port."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.data import pipeline_inter as jpi
from boxsegliver_tpu.data import sampler_inter as jsi
from boxsegliver_tpu.interactive import clicks as jclicks
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import create_train_state
from boxsegliver_tpu.train.trainer import make_loss_fn as jmake_loss_fn
from boxsegliver_tpu.train.trainer import make_train_step
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data import pipeline_inter as tpi
from boxsegliver_torch.data import sampler_inter as tsi
from boxsegliver_torch.data.pipeline import batch_to_device
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.interactive import clicks as tclicks
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)
BS = 6


@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("inter_torch") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(10, 80, 72), k_split=2,
                           modality="nf", seed=4)
    return root


def _args(root, model_dir, *extra, model="UNetInter",
          config="UNetInter_TINY.yml"):
    return cli.get_args([
        "nf_inter", "--mode", "train", "--tag", "t_inter", "--model", model,
        "--model_config", config, "--classes", "NF", "--batch_size", str(BS),
        "--im_height", "48", "--im_width", "40", "--im_channel", "3",
        "--test_fold", "0", "--k_folds", "2", "--tumor_percent", "0.5",
        "--zoom_scale", "1.0", "1.3", "--noise_scale", "0.05",
        "--random_flip", "3", "--normalizer", "instance_norm",
        "--loss_weight_type", "numerical", "--loss_numeric_w", "1", "1",
        "--model_dir", str(model_dir), "--data_root", str(Path(root).parent),
        "--dataset", Path(root).name, "--device", "cpu", *extra])


# ---------------------------------------------------------------------------
# clicks
# ---------------------------------------------------------------------------

def _masks(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:60, :70]
    out = []
    for _ in range(4):
        cy, cx = rng.uniform(10, 50), rng.uniform(10, 60)
        r = rng.uniform(2, 14)
        out.append(((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(
            np.uint8))
    out.append(np.zeros((60, 70), np.uint8))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clicks_are_array_equal(seed):
    rng_mask = np.random.default_rng(seed + 10)
    n = 0
    for mask in _masks(seed):
        neg = (rng_mask.random(mask.shape) < 0.01).astype(np.uint8)
        cases = [dict(bg=False, strategy=0, margin=3, step=10, N=5)] + [
            dict(bg=True, strategy=s, margin=3, step=10, N=5, d=40)
            for s in (0, 1, 3)] + [
            dict(bg=True, strategy=4, margin=3, step=10, N=5, d=40,
                 neg_patch=neg),
            dict(bg=False, strategy=0, random=False, N=3)]
        for kw in cases:
            m = (1 - mask).astype(np.uint8) if kw["bg"] else mask
            if not m.any():
                continue
            a = jclicks.inter_simulation(m, rng=np.random.RandomState(seed),
                                         **kw)
            b = tclicks.inter_simulation(m, rng=np.random.RandomState(seed),
                                         **kw)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            n += len(a)
    assert n >= 10
    pred = _masks(seed)[0]
    label = _masks(seed)[1]
    for p, lab in ((pred, label), (label, label), (pred[None], label[None])):
        assert jclicks.next_click_from_error(p, lab) == \
            tclicks.next_click_from_error(p, lab)


# ---------------------------------------------------------------------------
# InterSampler
# ---------------------------------------------------------------------------

def _predictions(root, out, shift=0):
    """Saved predictions with false positives beside the lesions."""
    out.mkdir(parents=True, exist_ok=True)
    for m in json.loads((root / "meta.json").read_text()):
        lab = np.load(root / f"volume-{m['PID']}" / "segmentation.npy")
        pred = (lab > 0).astype(np.uint8)
        pred[:, 4 + shift:12 + shift, 4:13] = 1
        pred[2:5, 60:66, 30 + shift:37 + shift] = 1
        np.savez_compressed(out / f"predict-{m['PID']}.npz", pred)


def _compare_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "image":
            continue
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    diff = np.abs(a["image"].astype(np.int64) - b["image"].astype(np.int64))
    assert a["image"].dtype == b["image"].dtype == np.uint16
    assert int(diff.max()) <= 1
    return int((diff > 0).sum()), diff.size


@pytest.mark.parametrize("extra", [
    [], ["-ds"], ["--fp_sample"], ["--fp_sample", "--fp_version", "2"],
    ["--sample_neg", "0.3", "--fp_sample"]],
    ids=["plain", "ds", "fp_sample", "fp_version2", "sample_neg"])
def test_sampler_batches_match_jax(nf_root, tmp_path, capsys, extra):
    if "--fp_sample" in extra:
        dirs = [tmp_path / "p1"] + ([tmp_path / "p2"]
                                    if "2" in extra else [])
        for i, d in enumerate(dirs):
            _predictions(nf_root, d, shift=3 * i)
        jsi.build_neg_cache(dirs, nf_root)
    args = _args(nf_root, tmp_path / "m", *extra)
    off = total = 0
    for mode, seed in (("train", 3), ("train", 8), ("eval", None)):
        js = jsi.InterSampler(nf_root, args, mode=mode, seed=seed,
                              max_clicks=args.max_clicks)
        ts = tsi.InterSampler(nf_root, args, mode=mode, seed=seed,
                              max_clicks=args.max_clicks)
        for _ in range(2):
            o, t = _compare_batches(ts.sample_batch(BS), js.sample_batch(BS))
            off, total = off + o, total + t
    b = ts.sample_batch(BS)
    assert b["image"].shape == (BS, 48, 40, 3) and b["n_fg"].max() > 0
    with capsys.disabled():
        print(f"\n  InterSampler {extra}: {off} of {total} image values one "
              "uint16 level off OpenCV's bilinear resize, none further")
    assert off <= total // 1000


def test_geodesic_raises_naming_its_item(nf_root, tmp_path):
    """--geodesic raised NotImplementedError naming its ROADMAP item until
    the click-eval slice ported it; now the sampler's batches carry the fg
    and bg geodesic maps (held against JAX's in
    tests/test_torch_inter_models.py)."""
    args = _args(nf_root, tmp_path, "--geodesic")
    batch = tsi.InterSampler(nf_root, args, seed=1).sample_batch(BS)
    for k in ("fg_gd", "bg_gd"):
        assert batch[k].shape == (BS, 48, 40) and batch[k].dtype == np.float32
        assert np.isfinite(batch[k]).all() and batch[k].min() >= 0
    assert (batch["fg_gd"].reshape(BS, -1).any(axis=1)
            == (batch["n_fg"] > 0)).all()


@pytest.mark.parametrize("n_dirs", [1, 2])
def test_neg_cache_matches_jax(nf_root, tmp_path, n_dirs):
    dirs = [tmp_path / f"p{i}" for i in range(n_dirs)]
    for i, d in enumerate(dirs):
        _predictions(nf_root, d, shift=4 * i)
    jroot, troot = tmp_path / "j", tmp_path / "t"
    for r in (jroot, troot):
        r.mkdir()
        for m in json.loads((nf_root / "meta.json").read_text()):
            (r / f"volume-{m['PID']}").mkdir()
            (r / f"volume-{m['PID']}" / "segmentation.npy").write_bytes(
                (nf_root / f"volume-{m['PID']}" /
                 "segmentation.npy").read_bytes())
    want = jsi.build_neg_cache(dirs, jroot, min_size=5)
    got = tsi.build_neg_cache(dirs, troot, min_size=5)
    sub = "neg" if n_dirs == 1 else "neg_v2"
    assert [p.relative_to(troot) for p in got] == \
        [p.relative_to(jroot) for p in want]
    assert all(p.parent.name == sub for p in got) and got
    for a, b in zip(got, want):
        assert a.read_bytes() == b.read_bytes()
    assert any(np.load(p).any() for p in got)


# ---------------------------------------------------------------------------
# pipeline_inter
# ---------------------------------------------------------------------------

def _jax_inter_draws(key, bs, shape):
    """JAX _process_one_inter's draws: per-sample key → (flip, gamma,
    noise)."""
    noise, coins, gam = [], [], []
    for k in jax.random.split(key, bs):
        k_flip, k_gamma, k_noise = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.uniform(
            k_noise, shape, minval=-1.0, maxval=1.0)))
        coins.append([float(jax.random.uniform(f, ()))
                      for f in jax.random.split(k_flip, 3)])
        gam.append([float(jax.random.uniform(g, ()))
                    for g in jax.random.split(k_gamma, 3)])
    return {"noise": torch.from_numpy(np.stack(noise)),
            "flip": torch.tensor(coins, dtype=torch.float32),
            "gamma": torch.tensor(gam, dtype=torch.float32)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("local_enhance", [True, False],
                         ids=["gaussian", "euclidean"])
@pytest.mark.parametrize("gc", ["1", "2"])
def test_pipeline_inter_matches_jax(nf_root, tmp_path, monkeypatch, train,
                                    local_enhance, gc):
    extra = ["--guide_channel", gc, "--stddev", "5"]
    if local_enhance:
        extra.append("--local_enhance")
    args = _args(nf_root, tmp_path, *extra)
    batch = tsi.InterSampler(nf_root, args, seed=2).sample_batch(BS)
    assert batch["n_fg"].min() == 0 < batch["n_fg"].max()
    key = jax.random.PRNGKey(5)
    fj, lj = jax.jit(jpi.make_inter_preprocess_fn(args, train=train))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = _jax_inter_draws(key, BS, (48, 40, 3))
    monkeypatch.setattr(tpi.image_ops, "draw_augment", lambda *a, **k: draws)
    ft, lt = tpi.make_inter_preprocess_fn(args, train=train)(
        batch_to_device(batch, "cpu"), torch.Generator())
    assert sorted(ft) == sorted(fj) == ["images", "names", "sp_guide"]
    assert ft["sp_guide"].shape == (BS, 48, 40, int(gc))
    img, want = ft["images"].numpy(), np.asarray(fj["images"])
    np.testing.assert_allclose(img, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if not train:
        assert np.array_equal(img == 0, want == 0)
    g, gw = ft["sp_guide"].numpy(), np.asarray(fj["sp_guide"])
    np.testing.assert_allclose(g, gw, rtol=1e-5, atol=1e-5 * max(
        1.0, np.abs(gw).max()))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


# ---------------------------------------------------------------------------
# models: UNetInter and GUNet --img_grad
# ---------------------------------------------------------------------------

FORWARD_CASES = {
    "unetinter": ("UNetInter", "UNetInter_TINY.yml", {}),
    "unetinter_mid_cat": ("UNetInter", "UNetInter_TINY.yml",
                          {"mid_cat": True}),
    "unetinter_img_grad": ("UNetInter", "UNetInter_TINY.yml",
                           {"img_grad": True}),
    "gunet_img_grad": ("GUNet", "GUNet_TINY.yml",
                       {"img_grad": True, "use_spatial": True}),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_jax(case):
    name, config, kw = FORWARD_CASES[case]
    kw = dict(MODEL_CONFIGS[config], normalizer="instance_norm", **kw)
    rng = np.random.default_rng(1)
    gc = 2 if name == "UNetInter" else 1
    feats = {"images": rng.normal(size=(2, 32, 24, 3)).astype(np.float32),
             "sp_guide": rng.uniform(0, 1, (2, 32, 24, gc)
                                     ).astype(np.float32)}
    jmodel = jbuild(name, model_kwargs=kw, num_classes=2)
    variables = jmodel.init(jax.random.PRNGKey(0), feats, train=False)
    flat = {f"params/{k}": np.asarray(v) for k, v in traverse_util
            .flatten_dict(dict(variables["params"]), sep="/").items()}
    model = tbuild(name, model_kwargs=kw, num_classes=2, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    assert set(state_dict_to_flax(model)) == set(flat)
    n_b2 = sum(1 for m in model.modules()
               if type(m).__name__ == "ConvNormAct" and m.norm is not None)
    if name == "UNetInter":
        assert n_b2 == 2 * 3 + 2 * 2          # 18 at UNetInter.yml's depth
    want = np.asarray(jmodel.apply(variables, feats, train=False))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# one nf_inter train step against JAX make_train_step
# ---------------------------------------------------------------------------

def _away_from_kinks(params):
    """Every norm offset and transpose-conv bias at 3, so that the ReLUs'
    inputs sit away from 0 (the two packages' float32 forwards differ by
    ~1e-6; a pre-activation within that of 0 passes its gradient in one
    package and blocks it in the other)."""
    flat = traverse_util.flatten_dict(dict(params), sep="/")
    for k, v in flat.items():
        if k.endswith(("Norm_0/bias", "ConvTranspose_0/bias")):
            flat[k] = jnp.full_like(v, 3.0)
    return traverse_util.unflatten_dict(flat, sep="/")


def test_inter_train_step_matches_jax(nf_root, tmp_path):
    args = _args(nf_root, tmp_path / "md", "--local_enhance", "--stddev",
                 "5", "--compute_dtype", "float32", "--weight_decay_rate",
                 "0.001", "--learning_policy", "plateau", "--learning_rate",
                 "0.001", "--log_step", "1", "--optimizer", "Momentum")
    raw = tsi.InterSampler(nf_root, args, seed=6).sample_batch(BS)
    ft, lt = tpi.make_inter_preprocess_fn(args, train=False)(
        batch_to_device(raw, "cpu"), None)
    feats = {k: ft[k][:2].numpy() for k in ("images", "sp_guide")}
    labels = lt[:2].numpy().astype(np.int32)
    classes = ["Background", "NF"]
    kw = MODEL_CONFIGS["UNetInter_TINY.yml"]
    jmodel = jbuild("UNetInter", args=args, model_kwargs=kw,
                    dtype=jnp.float32)
    solver = Solver(args)
    state = create_train_state(jmodel, solver, feats, jax.random.PRNGKey(0))
    state = state.replace(params=_away_from_kinks(state.params))
    flat0 = {f"params/{k}": np.asarray(v) for k, v in traverse_util
             .flatten_dict(dict(state.params), sep="/").items()}
    model = tbuild("UNetInter", args=args, model_kwargs=kw,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(flat0), strict=True)
    fts = {k: torch.from_numpy(v) for k, v in feats.items()}
    ltt = torch.from_numpy(labels).long()
    trainer = Trainer(model, args, classes, "cpu",
                      preprocess_fn=lambda batch, gen: (fts, ltt))

    jloss = jmake_loss_fn(args, classes)
    key = jax.random.PRNGKey(1)
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
    for k in jgf:
        np.testing.assert_allclose(tg[k], jgf[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    step_fn = jax.jit(make_train_step(jmodel, solver, args, classes))
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


# ---------------------------------------------------------------------------
# the nf_inter CLI on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ("UNetInter", "UNetInter_TINY.yml", ["--local_enhance", "--stddev", "5",
                                         "--fp_sample", "-ds"]),
    ("GUNet", "GUNet_TINY.yml", ["--local_enhance", "--stddev", "3",
                                 "--img_grad"]),
    ("UNetInter", "UNetInter_TINY.yml", ["--mid_cat", "--guide_channel",
                                         "1"])],
    ids=["101_unetinter_v10", "103_grad", "euclidean_mid_cat"])
def test_nf_inter_cli_trains_and_evaluates_on_cpu(nf_root, tmp_path, flags):
    model, config, extra = flags
    if "--fp_sample" in extra:
        _predictions(nf_root, tmp_path / "pred")
        from boxsegliver_torch.cli import prepare
        prepare.main(["negcache", "--dst", str(nf_root), "--pred_dir",
                      str(tmp_path / "pred")])
        assert (nf_root / "neg").is_dir()
    base = ["--model", model, "--model_config", config, "--use_spatial",
            "--tag", "t_inter", "--classes", "NF", "--batch_size", "4",
            "--im_height", "32", "--im_width", "32", "--im_channel", "3",
            "--test_fold", "0", "--k_folds", "2", "--normalizer",
            "instance_norm", "--loss_weight_type", "numerical",
            "--loss_numeric_w", "1", "1", "--data_root",
            str(nf_root.parent), "--dataset", nf_root.name, "--model_dir",
            str(tmp_path / "md"), "--device", "cpu", "--host_workers", "1",
            "--eval_num_batches_per_epoch", "2"] + extra
    trainer = cli.main(["nf_inter", "--mode", "train"] + base + [
        "--num_of_total_steps", "4", "--batches_per_epoch", "2",
        "--log_step", "2", "--eval_per_epoch", "--primary_metric",
        "NF/Dice", "--save_best", "--device_cache"])
    assert trainer.global_step == 4
    assert (tmp_path / "md" / "ckpt_best" / "best" / "state.pt").exists()
    lines = [json.loads(ln) for ln in (tmp_path / "md" / "summaries" /
                                       "metrics.jsonl").read_text()
             .splitlines()]
    loss = [ln["value"] for ln in lines if ln["tag"] == "t_inter/loss"]
    assert loss and all(np.isfinite(loss))
    assert {ln["step"] for ln in lines
            if ln["tag"] == "t_inter/eval/NF/Dice"} == {2, 4}
    for _ in range(2):
        res = cli.main(["nf_inter", "--mode", "eval"] + base)
        assert set(res) == {"NF/Dice"} and 0.0 <= res["NF/Dice"] <= 1.0
    rows = (tmp_path / "md" / "eval_results_2d.txt").read_text().splitlines()
    assert [json.loads(r) for r in rows] == [{"results": res}] * 2
