"""The port's train input path against the JAX package's, on a small
synthetic LiTS-like set: the numpy sampler copy (exact batches, both the
device-resize and the index layout), the device cache, the crop-resize op
and the batch processing (images within 1e-5, labels exact, guides within
1e-6 — kernel B1's plain version evaluates the Gaussian's exponent in
another rounding order —, context exact), with JAX's noise and flip draws
injected into the port."""

import argparse
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxsegliver_tpu.data import pipeline as jpipe
from boxsegliver_tpu.data.sampler import TrainSampler as JSampler
from boxsegliver_tpu.ops import image_ops as jimage
from boxsegliver_torch import config as tconfig
from boxsegliver_torch.data import pipeline as tpipe
from boxsegliver_torch.data.device_cache import DeviceVolumeCache, widen
from boxsegliver_torch.data.sampler import TrainSampler
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.ops import image_ops

FLAGS = ["--mode", "train", "--tag", "t", "--model", "GUNet", "--classes",
         "Liver", "Tumor", "--test_fold", "0", "--k_folds", "2",
         "--im_height", "48", "--im_width", "40", "--im_channel", "3",
         "--random_flip", "3", "--use_context", "--context_list", "hist",
         "200", "--hist_noise", "--use_spatial", "--spatial_inner_random",
         "--min_std", "2", "--noise_scale", "0.05", "--batch_size", "4"]


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe") / "ds"
    make_synthetic_dataset(root, n_cases=4, shape=(10, 64, 64), k_split=2,
                           seed=3)
    return root


@pytest.fixture(scope="module")
def args(ds):
    a = tconfig.build_parser().parse_args(FLAGS + ["--model_dir",
                                                   str(ds / "md")])
    a.task = "liver"
    return a


def _cache(ds, args, **kw):
    pids = [c["PID"] for c in TrainSampler(ds, args).cases]
    return DeviceVolumeCache(ds, pids, "cpu", **kw)


def _pair(ds, args, zbase=None, mode="train"):
    kw = dict(mode=mode, seed=5)
    j = JSampler(ds, args, resize_on_host=False, zbase=zbase, **kw)
    return j, TrainSampler(ds, args, zbase=zbase, **kw)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout", ["window", "index"])
def test_sampler_copy_gives_the_jax_batches(ds, args, layout):
    zbase = None
    if layout == "index":
        zbase = _cache(ds, args).zbase
    j, t = _pair(ds, args, zbase=zbase)
    for i in range(4):
        r1, r2 = (np.random.RandomState([9, i]) for _ in range(2))
        _same(j.sample_batch(4, rng=r1), t.sample_batch(4, rng=r2))
    _same(j.sample_batch(3), t.sample_batch(3))      # the sampler's own rng


def test_sampler_refuses_the_opencv_layout(ds, args):
    with pytest.raises(NotImplementedError, match="OpenCV"):
        TrainSampler(ds, args, resize_on_host=True)


def test_train_dataset_worker_seeding_matches_jax(ds, args):
    j, t = _pair(ds, args)
    jd = jpipe.TrainDataset(j, args, seed=11, workers=1, raw=True)
    td = tpipe.TrainDataset(t, args, seed=11, workers=1)
    try:
        for _ in range(2):
            _same(next(jd), next(td))
    finally:
        jd.close()
        td.close()


def test_device_cache_keeps_uint16_in_two_bytes(ds):
    cache = DeviceVolumeCache(ds, [0, 1], "cpu")
    vol = np.concatenate([np.load(ds / f"volume-{p}" / "volume.npy")
                          for p in (0, 1)])
    assert cache.volume.dtype == torch.int16
    np.testing.assert_array_equal(widen(cache.volume).numpy(), vol)
    probe = torch.tensor([0, 1, 32767, 32768, 65535], dtype=torch.int32)
    assert torch.equal(widen(probe.to(torch.int16)), probe)
    assert cache.zbase == {0: (0, 10), 1: (10, 10)}
    with pytest.raises(MemoryError):
        DeviceVolumeCache(ds, [0, 1], "cpu", budget_gb=1e-6)


def test_crop_and_resize_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 100, (3, 30, 26, 2)).astype(np.float32)
    lab = rng.integers(0, 3, (3, 30, 26)).astype(np.uint8)
    y0 = np.array([0.0, 3.0, 5.5], np.float32)
    x0 = np.array([0.0, 2.0, 1.25], np.float32)
    ch = np.array([30.0, 17.0, 21.0], np.float32)
    cw = np.array([26.0, 23.0, 9.0], np.float32)
    out, olab = image_ops.crop_and_resize_2d(
        *(torch.from_numpy(a) for a in (img, lab, y0, x0, ch, cw)), 20, 24)
    for i in range(3):
        ri, rl = jimage.crop_and_resize_2d(img[i], lab[i], y0[i], x0[i],
                                           ch[i], cw[i], 20, 24)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ri), atol=1e-4,
                                   rtol=1e-6)
        np.testing.assert_array_equal(olab[i].numpy(), np.asarray(rl))


def _jax_draws(key, bs, shape):
    """The draws jax makes inside _process_batch: per-sample key → (noise,
    flip, gamma) keys; noise uniform(-1, 1) of the image shape; one coin
    per flip axis."""
    noise, coins = [], []
    for k in jax.random.split(key, bs):
        k_noise, k_flip, _ = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.uniform(
            k_noise, shape, minval=-1.0, maxval=1.0)))
        coins.append([float(jax.random.uniform(f, ()))
                      for f in jax.random.split(k_flip, 3)])
    return {"noise": torch.from_numpy(np.stack(noise)),
            "flip": torch.tensor(coins, dtype=torch.float32)}


def _compare(fj, lj, ft, lt):
    np.testing.assert_allclose(ft["images"].numpy(), np.asarray(fj["images"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ft["sp_guide"].numpy(),
                               np.asarray(fj["sp_guide"]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ft["context"].numpy(),
                                  np.asarray(fj["context"]))
    np.testing.assert_array_equal(ft["names"].numpy(), np.asarray(fj["names"]))


@pytest.mark.parametrize("layout", ["window", "index"])
@pytest.mark.parametrize("augment", [False, True])
def test_process_batch_matches_jax(ds, args, layout, augment):
    cache = jcache = None
    if layout == "index":
        cache = _cache(ds, args)
        jcache = types.SimpleNamespace(
            volume=jnp.asarray(widen(cache.volume).numpy().astype(np.uint16)),
            label=jnp.asarray(cache.label.numpy()))
    _, t = _pair(ds, args, zbase=cache.zbase if cache else None)
    batch = t.sample_batch(4, rng=np.random.RandomState(1))
    assert int(batch["n_objs"].sum()) > 0
    kw = dict(im_h=48, im_w=40, noise_scale=0.05 if augment else 0.0,
              random_flip=3 if augment else 0, use_spatial=True, min_std=2.0)
    key = jax.random.PRNGKey(7)
    fj, lj = jax.jit(functools.partial(jpipe._process_batch, cache=jcache,
                                       **kw, **jpipe.norm_statics(args)))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = _jax_draws(key, 4, (48, 40, 3)) if augment else None
    ft, lt = tpipe._process_batch(tpipe.batch_to_device(batch, "cpu"), draws,
                                  cache=cache, **kw,
                                  **tpipe.norm_statics(args))
    assert ft["images"].shape == (4, 48, 40, 3) and lt.dtype == torch.int64
    _compare(fj, lj, ft, lt)


def test_preprocess_fn_draws_from_the_generator(ds, args):
    _, t = _pair(ds, args)
    batch = tpipe.batch_to_device(t.sample_batch(4), "cpu")
    fn = tpipe.make_preprocess_fn(args)
    a = fn(batch, torch.Generator().manual_seed(0))
    b = fn(batch, torch.Generator().manual_seed(0))
    c = fn(batch, torch.Generator().manual_seed(1))
    assert torch.equal(a[0]["images"], b[0]["images"])
    assert not torch.equal(a[0]["images"], c[0]["images"])


def test_nf_normalization_is_not_ported(ds, args):
    """The nonzero z-score (the NF pipelines' normalization) raised until
    the NF slice ported it; it now matches JAX's _process_batch (1e-5
    relative, zeros exact; the gamma and noise draws are held against JAX
    in tests/test_torch_nf.py)."""
    j, t = _pair(ds, args)
    batch = t.sample_batch(2, rng=np.random.RandomState(4))
    jbatch = j.sample_batch(2, rng=np.random.RandomState(4))
    kw = dict(im_h=48, im_w=40, noise_scale=0.0, random_flip=0,
              use_spatial=True, min_std=2.0, zscore=True)
    got, _ = tpipe._process_batch(tpipe.batch_to_device(batch, "cpu"), None,
                                  **kw)
    want, _ = jax.jit(functools.partial(jpipe._process_batch, **kw))(
        {k: jnp.asarray(v) for k, v in jbatch.items()}, jax.random.PRNGKey(0))
    a, b = got["images"].numpy(), np.asarray(want["images"])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    assert np.array_equal(a == 0, b == 0)
    assert isinstance(args, argparse.Namespace)
