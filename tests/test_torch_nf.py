"""The port's NF task against the JAX package's on the CPU:

- the synthetic NF cache (easy and hard) written by both packages from the
  same seed: every file byte-equal, and the CLI's ``synthetic_nf``;
- the nonzero z-score and gamma of ``data/pipeline._process_batch`` on the
  sampler's window layout with JAX's draws injected (noise, flips, the
  gamma coin and uniforms; NF guides on a zero background): images within
  1e-5 relative, exact zeros where JAX has them, labels exact;
- ``EvaluateVolume.run_sp`` on bridged weights (a UNetInter_TINY with a
  one-channel guide and a GUNet_TINY with a spatial guide, each fitted for
  a few Adam steps so that it predicts blobs): per-case metrics within
  1e-6; its guides, drawn by kernel B1's plain version, against JAX's
  ``create_gaussian_distribution_v2`` renders within 1e-6;
- the ``101_unet_v2.sh``-style CLI on a tiny set with ``--device cpu``:
  train with the online eval, eval, and ``--use_spatial`` eval through
  ``run_sp`` (JAX's test_nf_task_end_to_end on the port)."""

import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import main as jcli
from boxsegliver_tpu.data import pipeline as jpipe
from boxsegliver_tpu.data.sampler import TrainSampler as JSampler
from boxsegliver_tpu.data.synthetic import \
    make_synthetic_dataset as j_make_synthetic
from boxsegliver_tpu.evaluators import device_eval as j_device_eval
from boxsegliver_tpu.evaluators import volume as j_volume
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.ops import array_kits as j_array_kits
from boxsegliver_tpu.train.trainer import TrainState
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data import pipeline as tpipe
from boxsegliver_torch.data.meta import load_meta
from boxsegliver_torch.data.sampler import TrainSampler
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.evaluators import device_eval as t_device_eval
from boxsegliver_torch.evaluators import eval_loader as t_loader
from boxsegliver_torch.evaluators import volume as t_volume
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models import build_model as tbuild
from boxsegliver_torch.models.weights import state_dict_to_flax
from boxsegliver_torch.ops.image_ops import resize_bilinear, resize_nearest

torch.set_num_threads(2)


def _tree_bytes(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("variant", ["easy", "hard"])
def test_synthetic_nf_cache_is_byte_equal(tmp_path, variant):
    kw = dict(n_cases=3, shape=(6, 40, 36), seed=5, k_split=3, modality="nf",
              variant=variant)
    j_make_synthetic(tmp_path / "j", **kw)
    make_synthetic_dataset(tmp_path / "t", **kw)
    want, got = _tree_bytes(tmp_path / "j"), _tree_bytes(tmp_path / "t")
    assert sorted(got) == sorted(want)
    assert {"meta.json", "k_folds.txt", "prior.json",
            "volume-0/volume.npy", "volume-0/segmentation.npy"} <= set(got)
    assert any(k.startswith("feat/hist/") for k in got)
    for k in want:
        assert got[k] == want[k], k


def test_cli_writes_the_synthetic_nf_set(tmp_path, monkeypatch):
    """resolve_dataset_dir writes JAX's ``synthetic_nf`` (4 cases of 24 x
    256^2, NF modality) for an nf task whose dataset is ``synthetic``
    (get_args maps a --dataset synthetic of the nf tasks to NF, so a caller
    sets it after parsing, as both packages' tests do); the generator is
    cut to a smaller shape here (the shapes are the generator's argument,
    not the CLI's logic)."""
    from boxsegliver_tpu.data import synthetic as jsyn
    from boxsegliver_torch.data import synthetic as tsyn

    calls = []
    for mod in (jsyn, tsyn):
        real = mod.make_synthetic_dataset

        def small(root, real=real, **kw):
            calls.append(dict(kw))
            kw["shape"] = (5, 32, 32)
            return real(root, **kw)
        monkeypatch.setattr(mod, "make_synthetic_dataset", small)
    argv = ["nf", "--mode", "train", "--tag", "t", "--model", "UNet",
            "--classes", "NF", "--dataset", "synthetic", "--k_folds", "2"]
    ja = jcli.get_args(argv + ["--data_root", str(tmp_path / "j"),
                               "--model_dir", str(tmp_path / "mj")])
    ta = cli.get_args(argv + ["--data_root", str(tmp_path / "t"),
                              "--model_dir", str(tmp_path / "mt"),
                              "--device", "cpu"])
    assert ja.dataset == ta.dataset == "NF"
    ja.dataset = ta.dataset = "synthetic"
    jroot, troot = jcli.resolve_dataset_dir(ja), cli.resolve_dataset_dir(ta)
    assert troot.name == jroot.name == "synthetic_nf"
    assert calls[0] == calls[1]
    assert calls[1]["modality"] == "nf" and calls[1]["shape"] == (24, 256,
                                                                  256)
    assert _tree_bytes(troot) == _tree_bytes(jroot)
    assert cli.resolve_dataset_dir(ta) == troot          # written once


# ---------------------------------------------------------------------------
# z-score and gamma in the plain pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("nf_torch") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(10, 64, 64), k_split=2,
                           modality="nf", seed=3)
    return root


NF_TRAIN = ["nf", "--mode", "train", "--tag", "t", "--model", "UNet",
            "--model_config", "UNet_TINY.yml", "--classes", "NF",
            "--test_fold", "0", "--k_folds", "2", "--im_height", "48",
            "--im_width", "40", "--im_channel", "3", "--random_flip", "3",
            "--batch_size", "4", "--normalizer", "instance_norm",
            "--loss_weight_type", "numerical", "--loss_numeric_w", "1", "10"]


def _jax_draws(key, bs, shape):
    """JAX _augment_tail's draws: per-sample key → (noise, flip, gamma);
    noise uniform(-1, 1), one coin per flip axis, and augment_gamma's coin
    and two uniforms (k_p, k_lo, k_hi), given here in [0, 1)."""
    noise, coins, gam = [], [], []
    for k in jax.random.split(key, bs):
        k_noise, k_flip, k_gamma = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.uniform(
            k_noise, shape, minval=-1.0, maxval=1.0)))
        coins.append([float(jax.random.uniform(f, ()))
                      for f in jax.random.split(k_flip, 3)])
        gam.append([float(jax.random.uniform(g, ()))
                    for g in jax.random.split(k_gamma, 3)])
    return {"noise": torch.from_numpy(np.stack(noise)),
            "flip": torch.tensor(coins, dtype=torch.float32),
            "gamma": torch.tensor(gam, dtype=torch.float32)}


@pytest.mark.parametrize("extra", [
    ["--zscore", "--gamma", "--noise_scale", "0.05"],
    ["--zscore", "--gamma", "--noise_scale", "0", "--use_spatial",
     "--gamma_range", "0.5", "2.0"],
    ["--gamma", "--noise_scale", "0.1"]],
    ids=["zscore_gamma_noise", "zscore_gamma_guides", "clip_gamma"])
def test_zscore_and_gamma_match_jax(nf_root, monkeypatch, extra):
    args = cli.get_args(NF_TRAIN + extra + [
        "--data_root", str(nf_root.parent), "--dataset", nf_root.name,
        "--model_dir", str(nf_root / "md"), "--device", "cpu"])
    statics = tpipe.norm_statics(args)
    assert statics["use_gamma"] and statics["guide_bg"] == 0.0
    batch = TrainSampler(nf_root, args, seed=1).sample_batch(
        4, rng=np.random.RandomState(2))
    jbatch = JSampler(nf_root, args, seed=1, resize_on_host=False
                      ).sample_batch(4, rng=np.random.RandomState(2))
    assert sorted(batch) == sorted(jbatch)
    key = jax.random.PRNGKey(11)
    fj, lj = jax.jit(jpipe.make_preprocess_fn(args))(
        {k: jnp.asarray(v) for k, v in jbatch.items()}, key)
    draws = _jax_draws(key, 4, (48, 40, 3))
    monkeypatch.setattr(tpipe.image_ops, "draw_augment",
                        lambda *a, **k: draws)
    ft, lt = tpipe.make_preprocess_fn(args)(
        tpipe.batch_to_device(batch, "cpu"), torch.Generator())
    assert sorted(ft) == sorted(fj)
    got, want = ft["images"].numpy(), np.asarray(fj["images"])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    if "--noise_scale" in extra and extra[extra.index("--noise_scale")
                                          + 1] == "0":
        assert np.array_equal(got == 0, want == 0)      # zeros stay zero
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    if "sp_guide" in fj:
        np.testing.assert_allclose(ft["sp_guide"].numpy(),
                                   np.asarray(fj["sp_guide"]), atol=1e-6)
        assert 0.0 <= float(ft["sp_guide"].min()) < 1e-6   # zero background


# ---------------------------------------------------------------------------
# run_sp on bridged weights
# ---------------------------------------------------------------------------

RUN_SP_MODELS = {
    # a click-guided model with a one-channel guide (the JAX package builds
    # UNetInter for the nf task with --guide_channel channels)
    "unetinter": ("UNetInter", dict(MODEL_CONFIGS["UNetInter_TINY.yml"],
                                    normalizer="instance_norm",
                                    guide_channels=1)),
    "gunet": ("GUNet", dict(MODEL_CONFIGS["GUNet_TINY.yml"],
                            normalizer="instance_norm", use_spatial=True)),
}


def _eval_args(root, model_dir, model, *extra):
    return cli.get_args([
        "nf", "--mode", "eval", "--tag", "t", "--model", model,
        "--classes", "NF", "--test_fold", "0", "--k_folds", "2",
        "--im_height", "48", "--im_width", "48", "--im_channel", "3",
        "--batch_size", "4", "--use_spatial", "--guide_channel", "1",
        "--eval_mirror", "--random_flip", "3", "--normalizer",
        "instance_norm", "--metrics_eval", "Dice", "VOE", "RVD",
        "--data_root", str(root.parent), "--dataset", root.name,
        "--model_dir", str(model_dir), "--device", "cpu", *extra])


def _fit(name, kw, root):
    """The port model fitted for 30 Adam steps on a test case's slices at
    48^2 with its sp-point guides, and the JAX model + state carrying the
    same variables through the bridge."""
    model = tbuild(name, model_kwargs=kw, num_classes=2, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    meta = load_meta(root)[0]
    case = t_loader.parse_case_eval(meta, root, im_channel=3, norm="nf_clip",
                                    whole_frame=True)
    vol = t_device_eval._resize_stack(case.volume, (48, 48))
    seg = resize_nearest(torch.from_numpy(np.array(case.segmentation)),
                         (48, 48)).long()
    args = _eval_args(root, root / "fit", name)
    guide = t_volume.EvaluateVolume(args, root, ["NF"]).sp_point_guides(
        meta, case)
    feats = {"images": torch.stack([vol[z:z + 3].permute(1, 2, 0)
                                    for z in range(case.depth)]),
             "sp_guide": guide[..., None]}
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    for _ in range(30):
        logits = model(feats, train=True)
        loss = torch.nn.functional.cross_entropy(logits.permute(0, 3, 1, 2),
                                                 seg.clamp(0, 1))
        opt.zero_grad()
        loss.backward()
        opt.step()
    model.eval()
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in state_dict_to_flax(model).items()},
        sep="/")
    jmodel = jbuild(name, model_kwargs=kw, num_classes=2)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                       batch_stats={}, opt_state=(),
                       lr_scale=jnp.ones((), jnp.float32))
    return model, jmodel, state


@pytest.mark.parametrize("which", sorted(RUN_SP_MODELS))
def test_run_sp_matches_jax(nf_root, tmp_path, monkeypatch, which):
    name, kw = RUN_SP_MODELS[which]
    model, jmodel, state = _fit(name, kw, nf_root)
    # the JAX package resizes the case with cv2: give it the port's
    # bilinear resize so that both evaluators see the same inputs
    monkeypatch.setattr(
        j_device_eval, "_resize_stack",
        lambda arr, pshape: t_device_eval._resize_stack(arr, pshape).numpy())
    real = cv2.resize

    def resize(img, dsize, interpolation=None):
        if interpolation == cv2.INTER_LINEAR:
            t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
            return resize_bilinear(t, (dsize[1], dsize[0])).numpy()
        return real(img, dsize, interpolation=interpolation)
    monkeypatch.setattr(cv2, "resize", resize)
    metas = [m for m in load_meta(nf_root)]
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    jargs = _eval_args(nf_root, tmp_path / "j", name)
    targs = _eval_args(nf_root, tmp_path / "t", name)
    jev = j_volume.EvaluateVolume(jargs, nf_root, ["NF"])
    tev = t_volume.EvaluateVolume(targs, nf_root, ["NF"])
    want = jev.run_sp(j_device_eval.DeviceSlicePredictor(jmodel, state,
                                                         jargs), metas)
    got = tev.run_sp(t_device_eval.DeviceSlicePredictor(model, targs, "cpu"),
                     metas)
    assert set(got) == set(want) >= {"NF/Dice", "NF/VOE", "NF/RVD",
                                     "GNFDice"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    pj = {k: list(v) for k, v in jev._metric_values.items()}
    pt = {k: list(v) for k, v in tev._metric_values.items()}
    assert pj.keys() == pt.keys() and all(len(v) == 4 for v in pt.values())
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert 0.0 < got["NF/Dice"] <= 1.0


@pytest.mark.parametrize("extra", [[], ["--eval_discount", "0.6",
                                        "--guide_scale", "3.5"]])
def test_sp_point_guides_match_jax_renders(nf_root, tmp_path, extra):
    """The guides run_sp feeds: B1 (its plain version on the CPU) against
    JAX's create_gaussian_distribution_v2 per tumor slice · eval_discount,
    zero on the other slices; and --eval_no_sp zeros them."""
    args = _eval_args(nf_root, tmp_path, "UNet", *extra)
    ev = t_volume.EvaluateVolume(args, nf_root, ["NF"])
    worst = 0.0
    for meta in load_meta(nf_root):
        case = t_loader.parse_case_eval(meta, nf_root, im_channel=3,
                                        norm="nf_clip", whole_frame=True)
        got = ev.sp_point_guides(meta, case).numpy()
        want = np.zeros_like(got)
        scale = np.float32(48) / np.asarray(case.oshape[1:], np.float32)
        ft = meta["tumor_slices_from_to"]
        for k, sid in enumerate(meta["tumor_slices_index"]):
            c = np.asarray(meta["tumor_slices_centers"][ft[k]:ft[k + 1]],
                           np.float32) * scale
            s = np.full(c.shape, args.guide_scale, np.float32) * scale
            want[sid] = j_array_kits.create_gaussian_distribution_v2(
                (48, 48), c, s) * args.eval_discount
        assert meta["tumor_slices_index"]
        assert np.array_equal(got == 0, want == 0)
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 1e-6, worst
    no_sp = t_volume.EvaluateVolume(
        _eval_args(nf_root, tmp_path, "UNet", "--eval_no_sp"), nf_root,
        ["NF"])
    assert float(no_sp.sp_point_guides(meta, case).abs().max()) == 0.0


def test_real_sp_guides(nf_root, tmp_path):
    """--real_sp: the case's recorded interactions replace the GT centers
    (one B1 launch over the listed slices)."""
    meta = load_meta(nf_root)[1]
    real = {str(meta["PID"]): {"3": {"centers": [[10.0, 20.0], [40.0, 5.0]],
                                     "stddevs": [[4.0, 4.0], [2.0, 6.0]]},
                               "7": {"centers": [[30.0, 30.0]],
                                     "stddevs": [[5.0, 3.0]]}}}
    path = tmp_path / "real.json"
    path.write_text(json.dumps(real))
    args = _eval_args(nf_root, tmp_path, "UNet", "--real_sp", str(path))
    ev = t_volume.EvaluateVolume(args, nf_root, ["NF"])
    case = t_loader.parse_case_eval(meta, nf_root, im_channel=3,
                                    norm="nf_clip", whole_frame=True)
    got = ev.sp_point_guides(meta, case, real_meta=real).numpy()
    scale = np.float32(48) / np.asarray(case.oshape[1:], np.float32)
    for ssid, g in real[str(meta["PID"])].items():
        want = j_array_kits.create_gaussian_distribution_v2(
            (48, 48), np.asarray(g["centers"], np.float32) * scale,
            np.asarray(g["stddevs"], np.float32) * scale) * 0.85
        np.testing.assert_allclose(got[int(ssid)], want, atol=1e-6)
    others = [z for z in range(case.depth) if z not in (3, 7)]
    assert float(np.abs(got[others]).max()) == 0.0


# ---------------------------------------------------------------------------
# the 101_unet_v2.sh CLI on the CPU
# ---------------------------------------------------------------------------

def test_nf_task_end_to_end_on_cpu(nf_root, tmp_path):
    """101_unet_v2.sh train flags at a tiny size (UNet_TINY, instance norm,
    --zscore --gamma, the online eval, a best checkpoint), then --mode eval
    (run) and --mode eval --use_spatial (run_sp, the guide fed to a model
    that ignores it) on the best checkpoint."""
    common = ["--data_root", str(nf_root.parent), "--dataset", nf_root.name,
              "--model_dir", str(tmp_path / "md"), "--device", "cpu",
              "--host_workers", "1"]
    trainer = cli.main(NF_TRAIN + common + [
        "--zscore", "--gamma", "--noise_scale", "0", "--num_of_total_steps",
        "4", "--batches_per_epoch", "2", "--log_step", "2",
        "--eval_per_epoch", "--eval_num_batches_per_epoch", "2",
        "--primary_metric", "NF/Dice", "--save_best",
        "--weight_decay_rate", "0.00001", "--learning_policy", "plateau"])
    assert trainer.global_step == 4
    assert (tmp_path / "md" / "ckpt_best" / "best" / "state.pt").exists()
    lines = [json.loads(ln) for ln in (tmp_path / "md" / "summaries" /
                                       "metrics.jsonl").read_text()
             .splitlines()]
    evals = {ln["step"] for ln in lines if ln["tag"] == "t/eval/NF/Dice"}
    assert evals == {2, 4}
    ev = ["nf", "--mode", "eval", "--tag", "t", "--model", "UNet",
          "--model_config", "UNet_TINY.yml", "--classes", "NF",
          "--test_fold", "0", "--k_folds", "2", "--im_height", "48",
          "--im_width", "40", "--im_channel", "3", "--normalizer",
          "instance_norm", "--zscore", "--batch_size", "4"] + common
    res = cli.main(ev)
    assert {"NF/Dice", "GNFDice"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())
    res_sp = cli.main(ev + ["--use_spatial"])
    for k in res:                       # UNet takes no guide: same result
        assert res_sp[k] == pytest.approx(res[k], abs=1e-6), k
