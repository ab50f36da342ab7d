"""The port's spatially sharded operations (parallel/spatial.py) on the
CPU: each op on the rank blocks of a gloo group of 2 and of 3 ranks
(spawned processes, tests/test_torch_dist_workers.spatial_ops_rank),
gathered whole, against the unsharded port op at 1e-6, and every rank's
gathered result equal to rank 0's:

- SAME convs: 3x3 at stride 1, and at stride 2 at an even and an odd
  global height; UNet3D's (1,3,3), (3,3,3), (1,3,3)/(1,2,2) and its
  bridge, the (3,3,3) conv at stride 2 on the sharded depth;
- both pools on a ragged SAME row, the transpose conv;
- ``image_gradients`` (NHWC, H sharded);
- the split B2 (B2s's plain version, the all-reduce, B2y's) on 2-D and
  3-D planes, ``Norm``'s split instance norm with and without scale, and
  B3's split form (G-Net's modulated block);
- the whole-volume z-score and the spatial mean (``--use_se``);
- the halo exchange itself in float32 and bfloat16;

and the split rule of ``parallel.mesh.split_blocks``, the halo's edge
rows, and B2s's launch plan."""

import numpy as np
import pytest
import torch

from boxsegliver_torch.ops import kernels
from boxsegliver_torch.parallel import launch, split_blocks
from test_torch_dist_workers import spatial_ops_rank

torch.set_num_threads(2)

_rng = np.random.RandomState(0)


def _x(*shape, positive=False):
    x = _rng.randn(*shape).astype(np.float32)
    return np.maximum(x, 0) * 100.0 if positive else x


# key: (op, input, unit of the rank blocks)
CASES = {
    "conv3x3": ("conv3_s1", _x(2, 3, 24, 10), 2),
    "conv3x3_stride2_even": ("conv3_s2", _x(2, 3, 24, 10), 2),
    "conv3x3_stride2_odd": ("conv3_s2", _x(2, 3, 23, 10), 2),
    "conv3d_133": ("conv3_133_s111", _x(1, 2, 8, 6, 7), 2),
    "conv3d_333": ("conv3_333_s111", _x(1, 2, 8, 6, 7), 2),
    "conv3d_133_stride122": ("conv3_133_s122", _x(1, 2, 8, 6, 7), 2),
    "conv3d_bridge": ("conv3_333_s222", _x(1, 2, 12, 6, 7), 2),
    "max_pool_ragged": ("max_pool", _x(2, 3, 23, 9), 2),
    "avg_pool_ragged": ("avg_pool", _x(2, 3, 23, 9), 2),
    "upconv": ("upconv", _x(2, 4, 12, 5), 2),
    "image_gradients": ("image_gradients", _x(2, 24, 10, 3), 2),
    "in_relu_2d": ("in_relu", _x(2, 3, 24, 10), 2),
    "in_relu_3d": ("in_relu", _x(1, 3, 8, 6, 7), 2),
    "norm_center": ("norm_center", _x(2, 3, 24, 10), 2),
    "norm_full": ("norm_full", _x(2, 3, 24, 10), 2),
    "modnorm": ("modnorm", _x(2, 3, 24, 10), 2),
    "zscore": ("zscore", _x(1, 12, 6, 7, 1, positive=True), 2),
    "se_mean": ("mean", _x(2, 3, 24, 10), 2),
    "halo_f32": ("halo", _x(2, 3, 24, 10), 2),
    # 16-bit floats travel as they are over gloo
    "halo_bf16": ("halo_bf16", _x(2, 3, 24, 10), 2),
}


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def sharded(request):
    return launch(spatial_ops_rank, request.param, "cpu", {"cases": CASES})


@pytest.mark.parametrize("key", sorted(CASES))
def test_sharded_op_matches_unsharded(sharded, key):
    whole, part, spread = sharded[key]
    assert part.shape == whole.shape
    np.testing.assert_allclose(part, whole, atol=1e-6, rtol=0, err_msg=key)
    assert spread == 0.0


@pytest.mark.parametrize("size,ranks,unit,want", [
    (256, 2, 16, [(0, 128), (128, 256)]),
    (64, 3, 4, [(0, 24), (24, 44), (44, 64)]),
    (100, 2, 16, [(0, 48), (48, 100)]),          # ragged 4 rows: the last
    (23, 3, 2, [(0, 8), (8, 16), (16, 23)]),
    (24, 1, 2, [(0, 24)]),
    (8, 1, 16, [(0, 8)]),                        # fewer rows than a unit
])
def test_split_blocks(size, ranks, unit, want):
    blocks = split_blocks(size, ranks, unit)
    assert blocks == want
    assert all((b - a) % unit == 0 for a, b in blocks[:-1])


@pytest.mark.parametrize("size,ranks,unit", [(32, 3, 16), (4, 3, 2),
                                             (8, 2, 16)])
def test_split_blocks_refuses_more_ranks_than_units(size, ranks, unit):
    with pytest.raises(ValueError, match="cannot split"):
        split_blocks(size, ranks, unit)


@pytest.mark.parametrize("planes,hw,dtype,want", [
    (30, 12 * 256 * 256, torch.bfloat16, (35, 22472)),
    (512, 128 * 256, torch.bfloat16, (2, 16384)),
    (8192, 16 * 16, torch.bfloat16, (1, 256)),
    (4, 1001, torch.float32, (4, 251)),
])
def test_partial_plan(planes, hw, dtype, want):
    splits, chunk = kernels.in_relu_partial_plan(planes, hw, dtype)
    assert (splits, chunk) == want
    assert (splits - 1) * chunk < hw <= splits * chunk


def test_split_stats_refuse_gradients():
    x = torch.randn(1, 2, 4, 4, requires_grad=True)
    w, b = torch.ones(2), torch.zeros(2)
    with pytest.raises(RuntimeError, match="inference only"):
        kernels.instance_norm_relu_split(x, w, b, group=None)
