"""The 3-D geodesic distance of the port against the JAX package's on the
CPU: ``csrc/native.geodesic3d`` (the port's binding of the C++ 26-neighbour
raster scan, with JAX's ``spacing``) and ``interactive/refine.
render_geodesic_guide`` on a [d, h, w] volume, each against JAX's
``csrc.geodesic_distance`` / ``interactive.refine.render_geodesic_guide``
on seeded volumes: within 1e-5 of the largest finite value, FLT_MAX at the
same voxels (the two libraries compile the same source with the same
flags, so the fields come out bit-equal in practice)."""

import numpy as np
import pytest

from boxsegliver_tpu.csrc import geodesic_distance as jax_cpp
from boxsegliver_tpu.interactive import refine as jrefine
from boxsegliver_torch.csrc import native
from boxsegliver_torch.interactive import refine as trefine

SPACINGS = {"iso": (1.0, 1.0, 1.0), "aniso": (2.5, 0.8, 0.8)}


def _volume(seed, shape=(7, 19, 23)):
    rng = np.random.RandomState(seed)
    img = (rng.randn(*shape) * 3.0).astype(np.float32)
    seeds = (rng.rand(*shape) > 0.995).astype(np.uint8)
    seeds[0, 0, 0] = 1
    return img, seeds


def _close(got, want):
    unreached = want == native.FLT_MAX
    np.testing.assert_array_equal(got == native.FLT_MAX, unreached)
    fin = ~unreached
    if not fin.any():
        return
    scale = max(1.0, float(np.abs(want[fin]).max()))
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("spacing", sorted(SPACINGS))
@pytest.mark.parametrize("lamb", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_geodesic3d_matches_jax(seed, lamb, spacing):
    img, seeds = _volume(seed)
    sp = SPACINGS[spacing]
    got = native.geodesic3d(img, seeds, lamb, 4, sp)
    want = jax_cpp(img, seeds, lamb, 4, spacing=sp)
    _close(got, want)


def test_geodesic3d_unreached_is_flt_max():
    img, _ = _volume(2, (3, 5, 6))
    seeds = np.zeros(img.shape, np.uint8)
    got = native.geodesic3d(img, seeds)
    assert (got == native.FLT_MAX).all()
    _close(got, jax_cpp(img, seeds, 1.0, 4))


def test_geodesic3d_rejects_other_ranks():
    with pytest.raises(ValueError, match="geodesic3d"):
        native.geodesic3d(np.zeros((4, 4), np.float32),
                          np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("seed", [0, 3])
def test_render_geodesic_guide_on_a_volume(seed):
    img, _ = _volume(seed, (6, 21, 17))
    rng = np.random.RandomState(seed + 10)
    clicks = [tuple(int(rng.randint(s)) for s in img.shape)
              for _ in range(3)]
    got = trefine.render_geodesic_guide(img, clicks, lamb=1.0, iterations=4,
                                        scale=10.0)
    want = jrefine.render_geodesic_guide(img, clicks, lamb=1.0, iterations=4,
                                         scale=10.0)
    assert got.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the 2-D path is unchanged
    got2 = trefine.render_geodesic_guide(img[2], [c[1:] for c in clicks])
    want2 = jrefine.render_geodesic_guide(img[2], [c[1:] for c in clicks])
    np.testing.assert_allclose(got2, want2, rtol=0, atol=1e-5)
