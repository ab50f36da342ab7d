"""The port's geodesic distance against the JAX package's on the CPU:

- the host C++ raster scan (the port's own copy, built by csrc/native.py)
  against JAX's ``csrc.geodesic_distance``: bit-equal (same source lines,
  same g++ flags), FLT_MAX at the same unreached pixels;
- the plain PyTorch scan ``ops/geodesic.geodesic2d`` (kernel G1's plain
  version) against JAX's ``ops/geodesic.geodesic2d`` and the C++ scan:
  within 1e-5 of the field's largest finite value (min-plus reassociation),
  +inf exactly where the others have inf / FLT_MAX;
- ``geodesic_guide`` against JAX's; ``ops/kernels.geodesic2d_batch`` on a
  CPU tensor is the plain version; a failed g++ build raises.
The kernel itself runs only on the card: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxsegliver_tpu.csrc import geodesic_distance as jax_cpp
from boxsegliver_tpu.ops import geodesic as jgeo
from boxsegliver_torch.csrc import native
from boxsegliver_torch.ops import geodesic as tgeo
from boxsegliver_torch.ops import kernels

torch.set_num_threads(2)

SHAPES = {"square": (24, 24), "odd": (17, 31), "one_row": (1, 9),
          "one_column": (9, 1)}


def _case(shape, seed, n=3):
    rng = np.random.RandomState(seed)
    img = (rng.randn(n, *shape) * 2.0).astype(np.float32)
    seeds = rng.rand(n, *shape) > 0.97
    seeds[0] = False                                   # no seed: all inf
    seeds[1] = False
    seeds[1, 0, 0] = seeds[1, -1, -1] = True           # corners
    return img, seeds


@pytest.mark.parametrize("lamb", [1.0, 0.5])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_native_scan_equals_jax_cpp(shape, lamb):
    img, seeds = _case(SHAPES[shape], 0)
    for i in range(len(img)):
        got = native.geodesic2d(img[i], seeds[i], lamb, 4)
        want = jax_cpp(img[i], seeds[i].astype(np.uint8), lamb, 4)
        np.testing.assert_array_equal(got, want)
    assert (native.geodesic2d(img[0], seeds[0]) == native.FLT_MAX).all()


def _close(got, want_finite_mask, want):
    assert np.array_equal(np.isfinite(got), want_finite_mask)
    if want_finite_mask.any():
        scale = max(1.0, float(np.abs(want[want_finite_mask]).max()))
        np.testing.assert_allclose(got[want_finite_mask],
                                   want[want_finite_mask], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_scan_matches_jax_and_cpp(shape, iterations):
    img, seeds = _case(SHAPES[shape], 1)
    got = tgeo.geodesic2d(torch.from_numpy(img), torch.from_numpy(seeds),
                          1.0, iterations).numpy()
    for i in range(len(img)):
        want = np.asarray(jgeo.geodesic2d(jnp.asarray(img[i]),
                                          jnp.asarray(seeds[i]), 1.0,
                                          iterations))
        _close(got[i], np.isfinite(want), want)
        cpp = native.geodesic2d(img[i], seeds[i], 1.0, iterations)
        _close(got[i], cpp != native.FLT_MAX, cpp)
    assert np.isinf(got[0]).all()


def test_plain_scan_keeps_leading_dims_and_lambda():
    img, seeds = _case((12, 10), 2, n=4)
    got = tgeo.geodesic2d(torch.from_numpy(img).reshape(2, 2, 12, 10),
                          torch.from_numpy(seeds).reshape(2, 2, 12, 10), 0.3)
    assert got.shape == (2, 2, 12, 10)
    for i in range(4):
        want = native.geodesic2d(img[i], seeds[i], 0.3, 4)
        _close(got.reshape(4, 12, 10)[i].numpy(), want != native.FLT_MAX,
               want)


def test_geodesic_guide_matches_jax():
    img, seeds = _case((20, 18), 3)
    got = tgeo.geodesic_guide(torch.from_numpy(img), torch.from_numpy(seeds),
                              scale=7.0).numpy()
    for i in range(len(img)):
        want = np.asarray(jgeo.geodesic_guide(jnp.asarray(img[i]),
                                              jnp.asarray(seeds[i]),
                                              scale=7.0))
        np.testing.assert_allclose(got[i], want, atol=1e-6)
    assert not got[0].any()


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    img, seeds = _case((16, 21), 4)
    before = kernels.geodesic2d_batch.launches
    got = kernels.geodesic2d_batch(torch.from_numpy(img),
                                   torch.from_numpy(seeds))
    assert kernels.geodesic2d_batch.launches == before
    want = tgeo.geodesic2d(torch.from_numpy(img), torch.from_numpy(seeds))
    assert torch.equal(got, want)
    assert "geodesic2d_batch" in kernels.KERNELS


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "lib_path",
                        lambda: tmp_path / "libboxseg_native-x.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.geodesic2d(np.zeros((4, 4), np.float32),
                          np.ones((4, 4), np.uint8))
    with pytest.raises(ValueError):
        native.geodesic2d(np.zeros((4, 4), np.float32),
                          np.ones((4, 5), np.uint8))
