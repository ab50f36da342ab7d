"""The nf2 / IIN data path of the port against the JAX package on the CPU:

- ``data/sampler_iin.IinSampler`` batches for 3 seeds (train, the online
  eval's tumor_percent=0 / spatial_random=1, a window-clip run and a
  ``--filter_size`` run): every index field (label, clip, pad mask, names,
  the click's sp_center / sp_std / sp_on, ct_on) array-equal; images and
  context pyramids within one uint16 level of OpenCV (the port resizes with
  ops/image_ops.resize_linear_u16; a rounding tie can land one level off),
  the share of values off printed under ``-s``;
- ``ct_sizes`` and ``extract_ct_pyramid``;
- ``data/pipeline_iin`` train (JAX's draws injected) and eval on one raw
  batch: features and labels within 1e-5 of the values' scale, labels
  exact; the guide of a sample without a click all zeros."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxsegliver_tpu.cli import main as jcli
from boxsegliver_tpu.data import pipeline_iin as jpipe
from boxsegliver_tpu.data import sampler_iin as jsamp
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data import pipeline_iin as tpipe
from boxsegliver_torch.data import sampler_iin as tsamp
from boxsegliver_torch.data.pipeline import batch_to_device
from boxsegliver_torch.data.synthetic import make_synthetic_dataset

torch.set_num_threads(2)
BS = 6


@pytest.fixture(scope="module")
def nf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("iin_data") / "synthetic_nf"
    make_synthetic_dataset(root, n_cases=4, shape=(12, 96, 96), k_split=2,
                           modality="nf", seed=4)
    return root


def _argv(root, *extra):
    return ["nf2", "--mode", "train", "--tag", "t_iin", "--model", "GUNet",
            "--model_config", "GUNet_IIN_TINY.yml", "--classes", "NF",
            "--im_height", "64", "--im_width", "64", "--im_channel", "3",
            "--batch_size", str(BS), "--use_context", "--ct_base", "32",
            "--use_spatial", "--spatial_random", "1.0", "--guide_scale",
            "5", "--test_fold", "0", "--k_folds", "2", "--random_flip", "3",
            "--noise_scale", "0.1", "--zoom_scale", "1.0", "1.25",
            "--data_root", str(root.parent), "--dataset", root.name,
            "--model_dir", str(root.parent / "md")] + list(extra)


def _args(root, *extra):
    argv = _argv(root, *extra)
    return jcli.get_args(argv), cli.get_args(argv + ["--device", "cpu"])


SAMPLER_CASES = {
    "train_zscore": (["--zscore", "--gamma"], {}),
    "train_window": ([], {}),
    "online_eval": (["--zscore"], {"mode": "eval", "tumor_percent": 0.0,
                                   "spatial_random": 1.0}),
    "filter_size": (["--zscore", "--filter_size", "20"], {}),
    "half_guided": (["--zscore", "--spatial_random", "0.5"], {}),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_batches_match_jax(nf_root, case, seed):
    extra, kw = SAMPLER_CASES[case]
    ja, ta = _args(nf_root, *extra)
    want = jsamp.IinSampler(nf_root, ja, seed=seed, **kw).sample_batch(BS)
    got = tsamp.IinSampler(nf_root, ta, seed=seed, **kw).sample_batch(BS)
    assert sorted(got) == sorted(want)
    off = total = 0
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if k in ("image", "ct_patch"):
            d = np.abs(got[k].astype(np.int64) - want[k].astype(np.int64))
            assert d.max() <= 1, k
            off += int((d > 0).sum())
            total += d.size
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["label"].any()
    print(f"\n{case} seed {seed}: {off} of {total} uint16 values one level "
          f"off OpenCV ({100.0 * off / total:.4f} %)")


def test_ct_sizes_and_pyramid_match_jax(nf_root):
    for cb in ([32], [16], [8, 24, 40]):
        assert tsamp.ct_sizes(cb) == jsamp.ct_sizes(cb)
    with pytest.raises(ValueError):
        tsamp.ct_sizes([1, 2])
    rng = np.random.RandomState(0)
    plane = rng.randint(0, 4000, (96, 80)).astype(np.uint16)
    for y, x, sizes in ((5, 7, (32, 64, 128)), (90, 70, (32, 48, 64)),
                        (40, 40, (16, 32, 50))):
        got = tsamp.extract_ct_pyramid(plane, y, x, sizes)
        want = jsamp.extract_ct_pyramid(plane, y, x, sizes)
        assert got.dtype == want.dtype == np.uint16
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _jax_iin_draws(key, bs, shape):
    """JAX _process_one_iin's draws: per-sample key → (k_noise, k_flip,
    k_gamma); normal noise, one coin per flip axis, augment_gamma's coin
    and two uniforms."""
    noise, coins, gam = [], [], []
    for k in jax.random.split(key, bs):
        k_noise, k_flip, k_gamma = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.normal(k_noise, shape,
                                                  dtype=jnp.float32)))
        coins.append([float(jax.random.uniform(f, ()))
                      for f in jax.random.split(k_flip, 3)])
        gam.append([float(jax.random.uniform(g, ()))
                    for g in jax.random.split(k_gamma, 3)])
    return {"noise": torch.from_numpy(np.stack(noise)),
            "flip": torch.tensor(coins, dtype=torch.float32),
            "gamma": torch.tensor(gam, dtype=torch.float32)}


PIPE_CASES = {
    "zscore_gamma": ["--zscore", "--gamma"],
    "window": [],
    "spatial_only": ["--zscore"],
    "half_guided": ["--zscore", "--gamma", "--spatial_random", "0.5"],
}


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipeline_iin_matches_jax(nf_root, monkeypatch, case, train):
    ja, ta = _args(nf_root, *PIPE_CASES[case])
    if case == "spatial_only":          # no context pyramid
        ja.use_context = ta.use_context = False
    batch = tsamp.IinSampler(nf_root, ta, seed=3).sample_batch(BS)
    key = jax.random.PRNGKey(7)
    fj, lj = jax.jit(jpipe.make_iin_preprocess_fn(ja, train=train))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = _jax_iin_draws(key, BS, (64, 64, 3))
    monkeypatch.setattr(tpipe, "draw_iin", lambda *a, **k: draws)
    ft, lt = tpipe.make_iin_preprocess_fn(ta, train=train)(
        batch_to_device(batch, "cpu"), torch.Generator())
    assert sorted(ft) == sorted(fj)
    for k in fj:
        if k == "names":
            np.testing.assert_array_equal(ft[k].numpy(), np.asarray(fj[k]))
            continue
        assert tuple(ft[k].shape) == fj[k].shape, k
        _close(ft[k].numpy(), np.asarray(fj[k]), k)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    off = batch["sp_on"] == 0
    if off.any():
        assert not ft["sp_guide"][torch.from_numpy(off)].any()
    assert (batch["sp_on"] > 0).any()
