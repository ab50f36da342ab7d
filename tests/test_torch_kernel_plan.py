"""The launch plans of kernel B2-fwd (ops/kernels.in_relu_fwd_plan) and of
the backward (in_relu_bwd_plan: B2f's fused paths, or B2a + B2b split), and
B2's and B3's NHWC plans (in_relu_nhwc_plan): which path each shape takes,
that every plan fits the card and covers every element of every plane
exactly once, and that the operands' strides choose between the NCHW and
NHWC plans.  Pure Python: runs on the CPU."""

import numpy as np
import pytest
import torch

from boxsegliver_torch.ops.kernels import (BWD_SPLIT, FWD_GENERAL,
                                           FWD_STAGED, FWD_THREADS, FWD_WARP,
                                           NHWC_SPLIT, NHWC_STAGED,
                                           STATS_TARGET_CTAS, BwdPlan,
                                           FwdPlan, in_relu_bwd_plan,
                                           in_relu_bwd_split_plan,
                                           in_relu_fwd_plan,
                                           in_relu_nhwc_plan,
                                           in_relu_nhwc_split_plan,
                                           in_relu_partial_plan)

SMEM_PER_CTA = 232448          # 227 KB: the most shared memory a CTA may use
STATIC_SMEM = 1024             # the staged kernel's own barrier and sums
MAX_CLUSTER = 8                # the portable thread-block cluster size

BF16, F32 = torch.bfloat16, torch.float32
FLAGSHIP = [(8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64),
            (8, 512, 32, 32)]
# the card-vs-CPU sweep's small GUNet (init 4) and GUNet_TINY (init 8)
EVAL_SMALL = [(8, 4, 64, 64), (8, 8, 32, 32), (8, 16, 16, 16),
              (4, 8, 64, 64), (4, 16, 32, 32), (4, 32, 16, 16)]
EDGE = [((2, 8, 7, 9), F32), ((1, 1, 33, 31), F32), ((1, 3, 64, 64), F32),
        ((3, 1, 5, 3), F32), ((1, 2, 13, 11), BF16), ((2, 64, 32, 32), F32)]
LARGE = [(1, 64, 512, 512), (2, 32, 512, 512)]


def _per_pack(dtype):
    return 16 // (torch.finfo(dtype).bits // 8)


# csrc/in_relu.cu constants
WARPS = FWD_THREADS // 32      # kWarps: planes per CTA on the warp path
BULK_PIECE = 16 * 1024         # kBulkPiece: bytes per cp.async.bulk
MAX_STAGE = 64 * 1024          # kMaxStageBytes


def launcher_accepts(plan, hw, dtype, aligned):
    """launch_fwd's checks: what the C launcher refuses as not fitting."""
    n = _per_pack(dtype)
    vec = aligned and hw % n == 0
    if plan.path == FWD_WARP:
        return vec and plan.packs in (1, 2, 4, 8) and plan.packs * 32 * n >= hw
    if plan.path == FWD_STAGED:
        cs = plan.cluster
        return (vec and 1 <= cs <= MAX_CLUSTER and cs & (cs - 1) == 0
                and hw % (cs * n) == 0
                and plan.smem_bytes == hw // cs * (16 // n)
                and plan.smem_bytes <= MAX_STAGE)
    return plan.path == FWD_GENERAL


def launcher_grid(plan, planes):
    """The grid the C launcher gives each path (launch_warp, launch_staged,
    the general launch)."""
    if plan.path == FWD_WARP:
        return (planes + WARPS - 1) // WARPS
    if plan.path == FWD_STAGED:
        return planes * plan.cluster
    return planes


def strided_writes(hw, base, groups, n, threads, iters=None):
    """Writes to a plane of ``hw`` elements by ``for (i = t; i < groups; i +=
    threads)`` over t < threads (at most ``iters`` turns), each turn a pack
    of ``n`` elements at base + i·n.  Out-of-plane writes lengthen the
    result."""
    turns = -(-groups // threads) if iters is None else iters
    i = (np.arange(threads)[:, None]
         + threads * np.arange(turns)[None, :]).ravel()
    i = i[i < groups]
    idx = (base + i[:, None] * n + np.arange(n)[None, :]).ravel()
    return np.bincount(idx, minlength=hw)


def coverage(plan, planes, hw, dtype, aligned=True):
    """Times each element of each plane is written by the launch the plan
    selects, following the kernels' index arithmetic: block index → plane
    (and warp or cluster rank) → each thread's packs.  Returns the distinct
    per-plane coverages, [k, hw]: a plane no CTA serves shows as a row of
    zeros."""
    n = _per_pack(dtype)
    grid = launcher_grid(plan, planes)
    block = np.arange(grid)
    if plan.path == FWD_WARP:
        # plane = blockIdx.x * kWarps + warp; lane writes j = lane + 32 * i
        plane = (block[:, None] * WARPS + np.arange(WARPS)[None, :]).ravel()
        units = np.bincount(plane[plane < planes], minlength=planes)[:, None]
        writes = [strided_writes(hw, 0, hw // n, n, 32, plan.packs)]
    elif plan.path == FWD_STAGED:
        # rank = blockIdx.x % cs, plane = blockIdx.x / cs; chunk rank of
        # hw / cs elements, each thread striding over its packs
        cs = plan.cluster
        rank, plane = block % cs, block // cs
        units = np.bincount(plane * cs + rank, minlength=planes * cs)
        units = units.reshape(-1, cs)
        chunk = hw // cs
        writes = [strided_writes(hw, r * chunk, chunk // n, n, FWD_THREADS)
                  for r in range(cs)]
        # the bulk copies fill the chunk in 16-byte multiples
        nbytes = chunk * (16 // n)
        pieces = [min(BULK_PIECE, nbytes - off)
                  for off in range(0, nbytes, BULK_PIECE)]
        assert sum(pieces) == nbytes and all(p % 16 == 0 for p in pieces)
    else:
        # one CTA a plane; packs of n when aligned, else one element
        vec = n if aligned and hw % n == 0 else 1
        units = np.bincount(block, minlength=planes)[:, None]
        writes = [strided_writes(hw, 0, hw // vec, vec, FWD_THREADS)]
    assert units.shape[0] == planes              # no CTA past the last plane
    writes = np.stack(writes)
    assert writes.shape[1] == hw                 # no write past the plane
    return np.unique(units, axis=0) @ writes


def check_plan(shape, dtype, aligned=True):
    n, c, h, w = shape
    planes, hw = n * c, h * w
    plan = in_relu_fwd_plan(planes, hw, dtype, aligned)
    assert plan.path in (FWD_GENERAL, FWD_WARP, FWD_STAGED)
    assert launcher_accepts(plan, hw, dtype, aligned)
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.grid == launcher_grid(plan, planes)
    assert plan.grid % plan.cluster == 0
    assert 0 < plan.grid < 2 ** 31
    assert plan.smem_bytes + STATIC_SMEM <= SMEM_PER_CTA
    np.testing.assert_array_equal(coverage(plan, planes, hw, dtype, aligned),
                                  1)
    esize = torch.finfo(dtype).bits // 8
    if plan.path == FWD_WARP:
        assert aligned and hw % _per_pack(dtype) == 0
        assert plan.packs in (1, 2, 4, 8)
        # the fewest packs a lane needs, and no fewer
        assert plan.packs * 32 * _per_pack(dtype) >= hw
        assert plan.packs == 1 or plan.packs * 16 * _per_pack(dtype) < hw
        assert plan.smem_bytes == 0
    if plan.path == FWD_STAGED:
        assert aligned
        # whole 16-byte packs per chunk, the chunk is what the CTA stages
        assert hw % (plan.cluster * _per_pack(dtype)) == 0
        assert plan.smem_bytes == hw // plan.cluster * esize
        assert plan.smem_bytes % 16 == 0
        assert plan.smem_bytes <= 64 * 1024
    return plan


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", FLAGSHIP)
def test_flagship_plans(shape, dtype):
    plan = check_plan(shape, dtype)
    assert plan.path != FWD_GENERAL


@pytest.mark.parametrize("shape,path,cluster", [
    ((8, 64, 256, 256), FWD_STAGED, 2), ((8, 128, 128, 128), FWD_STAGED, 1),
    ((8, 256, 64, 64), FWD_STAGED, 1), ((8, 512, 32, 32), FWD_WARP, 1)])
def test_flagship_bf16_paths(shape, path, cluster):
    plan = check_plan(shape, BF16)
    assert (plan.path, plan.cluster) == (path, cluster)
    if path == FWD_WARP:
        assert plan.packs == 4


@pytest.mark.parametrize("shape", EVAL_SMALL)
def test_eval_small_plans(shape):
    check_plan(shape, F32)
    check_plan(shape, BF16)


@pytest.mark.parametrize("shape,dtype", EDGE)
def test_edge_plans(shape, dtype):
    plan = check_plan(shape, dtype)
    odd = (shape[2] * shape[3]) % _per_pack(dtype) != 0
    assert (plan.path == FWD_GENERAL) == odd


@pytest.mark.parametrize("shape", LARGE)
def test_512_plans(shape):
    bf = check_plan(shape, BF16)
    assert (bf.path, bf.cluster, bf.smem_bytes) == (FWD_STAGED, 8, 65536)
    # 1 MiB f32 planes exceed 8 chunks of 64 KiB: the two-read kernel
    assert check_plan(shape, F32).path == FWD_GENERAL


# (hw, dtype, path) one element either side of each path boundary: the warp
# path's 32 lanes x 8 packs, and 8 staged chunks of 64 KiB
BOUNDARIES = [
    (2048, BF16, FWD_WARP), (2049, BF16, FWD_GENERAL),
    (2056, BF16, FWD_STAGED), (2047, BF16, FWD_GENERAL),
    (2040, BF16, FWD_WARP),
    (1024, F32, FWD_WARP), (1025, F32, FWD_GENERAL), (1028, F32, FWD_STAGED),
    (1020, F32, FWD_WARP),
    (262144, BF16, FWD_STAGED), (262145, BF16, FWD_GENERAL),
    (262152, BF16, FWD_GENERAL), (262143, BF16, FWD_GENERAL),
    (131072, F32, FWD_STAGED), (131073, F32, FWD_GENERAL),
    (131076, F32, FWD_GENERAL),
    (16384, BF16, FWD_STAGED), (16392, BF16, FWD_STAGED),
    (8, BF16, FWD_WARP), (7, BF16, FWD_GENERAL), (1, F32, FWD_GENERAL)]


@pytest.mark.parametrize("hw,dtype,path", BOUNDARIES)
def test_path_boundaries(hw, dtype, path):
    for planes in (1, 7, 8, 9, 1000):
        plan = check_plan((planes, 1, 1, hw), dtype)
        assert plan.path == path


def test_staged_chunk_choice():
    # the fewest chunks of whole packs of at most 64 KiB
    assert in_relu_fwd_plan(1, 32768, BF16).cluster == 1          # 64 KiB
    assert in_relu_fwd_plan(1, 65536, BF16).cluster == 2
    assert in_relu_fwd_plan(1, 65536, F32).cluster == 4
    # 32,784 bf16 (4,098 packs) in two chunks of 32,784 B; 32,776 (4,097
    # packs) splits into no 2, 4 or 8 chunks of whole packs and is too
    # large for one: the general path
    plan = in_relu_fwd_plan(1, 32784, BF16)
    assert (plan.cluster, plan.smem_bytes) == (2, 32784)
    assert in_relu_fwd_plan(1, 32776, BF16).path == FWD_GENERAL


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_unaligned_takes_the_general_path(dtype):
    for shape in FLAGSHIP + [(1, 3, 64, 64)]:
        assert check_plan(shape, dtype, aligned=False).path == FWD_GENERAL


def test_plan_is_cached():
    assert in_relu_fwd_plan(8, 4096, BF16) is in_relu_fwd_plan(8, 4096, BF16)


# ---------------------------------------------------------------------------
# the backward's plan (ops/kernels.in_relu_bwd_plan): B2f fused warp or
# fused staged, or B2a + B2b split over several CTAs a plane
# ---------------------------------------------------------------------------

MAX_BWD_STAGE = 192 * 1024     # kMaxBwdStageBytes
APPLY_PACKS = 4                # B2b's packs a thread on a split plan
NF_SHAPES = [(16, 64, 256, 256), (16, 128, 128, 128), (16, 256, 64, 64),
             (16, 512, 32, 32), (16, 1024, 16, 16)]
UNET3D_SHAPES = [(4, 30, 10, 256, 256), (4, 60, 10, 128, 128),
                 (4, 120, 10, 64, 64), (4, 240, 10, 32, 32),
                 (4, 320, 5, 16, 16)]


def bwd_launcher_accepts(plan, hw, dtype, aligned):
    """launch_bwd's checks for a fused plan, launch_stats' and
    launch_apply's for a split one: what the C launchers refuse."""
    n = _per_pack(dtype)
    vec = aligned and hw % n == 0
    if plan.path == FWD_WARP:
        return vec and plan.packs in (1, 2, 4, 8) and plan.packs * 32 * n >= hw
    if plan.path == FWD_STAGED:
        cs = plan.cluster
        return (vec and 1 <= cs <= MAX_CLUSTER and cs & (cs - 1) == 0
                and hw % (cs * n) == 0
                and plan.smem_bytes == 2 * (hw // cs) * (16 // n)
                and plan.smem_bytes <= MAX_BWD_STAGE)
    return (plan.path == BWD_SPLIT and plan.splits >= 1 and plan.chunk >= 1
            and plan.splits * plan.chunk >= hw
            and (plan.splits - 1) * plan.chunk < hw and plan.apply_ctas >= 1)


def split_coverage(plan, hw, dtype, aligned):
    """(B2a's reads, B2b's writes) of one plane under a split plan,
    following the kernels' index arithmetic: CTA split s reads packs i <
    min(hw − lo, chunk) / N from lo = s·chunk; B2b's CTA x writes packs x·256
    + t, striding by apply_ctas·256."""
    n = _per_pack(dtype)
    vec = n if aligned and hw % n == 0 and plan.chunk % n == 0 else 1
    reads = sum(strided_writes(hw, s * plan.chunk,
                               min(hw - s * plan.chunk, plan.chunk) // vec,
                               vec, FWD_THREADS)
                for s in range(plan.splits))
    vec = n if aligned and hw % n == 0 else 1
    groups = hw // vec
    stride = plan.apply_ctas * FWD_THREADS
    i = (np.arange(stride)[:, None]
         + stride * np.arange(-(-groups // stride))[None, :]).ravel()
    i = i[i < groups]
    idx = (i[:, None] * vec + np.arange(vec)[None, :]).ravel()
    return reads, np.bincount(idx, minlength=hw)


def check_bwd_plan(shape, dtype, aligned=True):
    planes, hw = shape[0] * shape[1], int(np.prod(shape[2:]))
    plan = in_relu_bwd_plan(planes, hw, dtype, aligned)
    assert isinstance(plan, BwdPlan)
    assert bwd_launcher_accepts(plan, hw, dtype, aligned)
    assert 0 < plan.grid < 2 ** 31
    if plan.path == BWD_SPLIT:
        assert (plan.splits, plan.chunk) == in_relu_partial_plan(
            planes, hw, dtype, aligned, STATS_TARGET_CTAS)
        assert plan.grid == plan.splits * planes
        reads, writes = split_coverage(plan, hw, dtype, aligned)
        assert reads.shape == writes.shape == (hw,)
        np.testing.assert_array_equal(reads, 1)
        np.testing.assert_array_equal(writes, 1)
        return plan
    # a fused plan covers a plane as B2-fwd's warp and staged paths do
    fwd = FwdPlan(plan.path, plan.grid, FWD_THREADS // 32, plan.packs,
                  plan.cluster, plan.smem_bytes // 2)
    assert plan.grid == launcher_grid(fwd, planes)
    np.testing.assert_array_equal(coverage(fwd, planes, hw, dtype, aligned),
                                  1)
    assert plan.smem_bytes + STATIC_SMEM <= SMEM_PER_CTA
    assert (plan.splits, plan.chunk, plan.apply_ctas) == (1, hw, 1)
    return plan


# (shape, path, cluster or packs, splits) of every training backward shape
# in bf16: the flagship's, the NF UNet's and UNet3D's levels
BWD_TRAIN = [
    ((8, 64, 256, 256), FWD_STAGED, 4, 1), ((8, 128, 128, 128), FWD_STAGED,
                                            1, 1),
    ((8, 256, 64, 64), FWD_STAGED, 1, 1), ((8, 512, 32, 32), FWD_WARP, 4, 1),
    ((16, 64, 256, 256), FWD_STAGED, 4, 1),
    ((16, 128, 128, 128), FWD_STAGED, 1, 1),
    ((16, 256, 64, 64), FWD_STAGED, 1, 1), ((16, 512, 32, 32), FWD_WARP, 4, 1),
    ((16, 1024, 16, 16), FWD_WARP, 1, 1),
    ((4, 30, 10, 256, 256), BWD_SPLIT, 1, 35),
    ((4, 60, 10, 128, 128), FWD_STAGED, 4, 1),
    ((4, 120, 10, 64, 64), FWD_STAGED, 4, 1),
    ((4, 240, 10, 32, 32), FWD_STAGED, 1, 1),
    ((4, 320, 5, 16, 16), FWD_WARP, 8, 1)]


@pytest.mark.parametrize("shape,path,k,splits", BWD_TRAIN)
def test_bwd_training_shapes(shape, path, k, splits):
    plan = check_bwd_plan(shape, BF16)
    assert plan.path == path and plan.splits == splits
    assert (plan.packs if path == FWD_WARP else plan.cluster) == k
    if path == BWD_SPLIT:                # UNet3D level 0: 120 planes
        assert plan.chunk == 18728 and plan.apply_ctas == 80
        assert plan.grid == 35 * 120


@pytest.mark.parametrize("shape", FLAGSHIP + NF_SHAPES + UNET3D_SHAPES
                         + EVAL_SMALL)
def test_bwd_f32_plans(shape):
    check_bwd_plan(shape, F32)


# (hw, dtype, path) one element either side of each boundary: the warp
# path's 32 lanes x 8 packs, a staged CTA's 64 KiB target of g + x̂, 8
# staged CTAs of 192 KiB, and odd planes
BWD_BOUNDARIES = [
    (2048, BF16, FWD_WARP), (2049, BF16, BWD_SPLIT), (2056, BF16, FWD_STAGED),
    (2040, BF16, FWD_WARP), (2047, BF16, BWD_SPLIT),
    (1024, F32, FWD_WARP), (1025, F32, BWD_SPLIT), (1028, F32, FWD_STAGED),
    (1020, F32, FWD_WARP),
    (16384, BF16, FWD_STAGED), (16385, BF16, BWD_SPLIT),
    (16400, BF16, FWD_STAGED),
    (8192, F32, FWD_STAGED), (8193, F32, BWD_SPLIT), (8200, F32, FWD_STAGED),
    (393216, BF16, FWD_STAGED), (393217, BF16, BWD_SPLIT),
    (393280, BF16, BWD_SPLIT),
    (196608, F32, FWD_STAGED), (196609, F32, BWD_SPLIT),
    (196640, F32, BWD_SPLIT), (655360, BF16, BWD_SPLIT),
    (8, BF16, FWD_WARP), (7, BF16, BWD_SPLIT), (1, F32, BWD_SPLIT)]


@pytest.mark.parametrize("hw,dtype,path", BWD_BOUNDARIES)
def test_bwd_path_boundaries(hw, dtype, path):
    for planes in (1, 7, 8, 9, 1000):
        assert check_bwd_plan((planes, 1, hw), dtype).path == path


def test_bwd_staged_chunk_choice():
    # the fewest CTAs whose g + x̂ chunks fit 64 KiB ...
    assert in_relu_bwd_plan(1, 16384, BF16).cluster == 1          # 64 KiB
    assert in_relu_bwd_plan(1, 32768, BF16).cluster == 2
    assert in_relu_bwd_plan(1, 65536, BF16).cluster == 4
    assert in_relu_bwd_plan(1, 131072, BF16).cluster == 8
    # ... else the fewest up to 192 KiB a CTA
    plan = in_relu_bwd_plan(1, 163840, BF16)
    assert (plan.cluster, plan.smem_bytes) == (4, 163840)
    plan = in_relu_bwd_plan(1, 393216, BF16)
    assert (plan.cluster, plan.smem_bytes) == (8, 196608)
    plan = in_relu_bwd_plan(1, 16400, BF16)     # 2,050 packs: two CTAs
    assert (plan.cluster, plan.smem_bytes) == (2, 32800)
    plan = in_relu_bwd_plan(1, 16392, BF16)     # 2,049 packs: one CTA
    assert (plan.cluster, plan.smem_bytes) == (1, 65568)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_bwd_unaligned_takes_the_split_path(dtype):
    for shape in FLAGSHIP + NF_SHAPES + UNET3D_SHAPES + [(1, 3, 64, 64)]:
        assert check_bwd_plan(shape, dtype, aligned=False).path == BWD_SPLIT


@pytest.mark.parametrize("planes,hw,dtype", [
    (120, 655360, BF16), (120, 655360, F32), (30, 1572864, BF16),
    (8192, 256, BF16), (4, 1001, F32), (3, 262147, BF16), (2, 7, BF16)])
@pytest.mark.parametrize("aligned", [True, False])
def test_split_plans_cover_each_plane_once(planes, hw, dtype, aligned):
    for spread in (True, False):
        plan = in_relu_bwd_split_plan(planes, hw, dtype, aligned, spread)
        assert bwd_launcher_accepts(plan, hw, dtype, aligned)
        reads, writes = split_coverage(plan, hw, dtype, aligned)
        np.testing.assert_array_equal(reads, 1)
        np.testing.assert_array_equal(writes, 1)
        if not spread:            # the first design: one CTA a plane each
            assert (plan.splits, plan.chunk, plan.apply_ctas) == (1, hw, 1)


def test_bwd_plan_is_cached():
    assert in_relu_bwd_plan(8, 4096, BF16) is in_relu_bwd_plan(8, 4096, BF16)


# ---------------------------------------------------------------------------
# the NHWC plans (channels-last operands, G-Net's): which plan each of
# G-Net's shapes takes, that every plan fits the C launcher's checks and
# covers every row once, and the choice of plans by strides
# ---------------------------------------------------------------------------

NHWC_MAX_STAGE = 200 * 1024    # kNhwcMaxStageBytes
NHWC_MAX_TILE = 64             # kNhwcMaxTile
GRID_Y = 65535                 # kMaxGridY


def nhwc_launcher_accepts(plan, n, c, hw, dtype, arrays, aligned=True):
    """nhwc_launch's and nhwc_run's checks: what the C launcher refuses."""
    per = _per_pack(dtype)
    esize = 16 // per
    packs = ((per, 1) if aligned and c % per == 0 else (1,))
    if dtype == BF16 and aligned and c % 4 == 0:
        packs += (4,)                    # 8-byte vectors of bf16
    if plan.pack not in packs:
        return False
    v = plan.v
    if not (1 <= v <= 32 and v & (v - 1) == 0
            and v * plan.pack <= NHWC_MAX_TILE and c % (v * plan.pack) == 0):
        return False
    tiles = c // (v * plan.pack)
    if plan.path == NHWC_STAGED:
        cs = plan.cluster
        return (1 <= cs <= MAX_CLUSTER and cs & (cs - 1) == 0 and hw % cs == 0
                and plan.smem_bytes
                == hw // cs * v * plan.pack * esize * arrays
                and plan.smem_bytes <= NHWC_MAX_STAGE
                and n * tiles * cs < 2 ** 31)
    return (plan.path == NHWC_SPLIT and plan.splits >= 1 and plan.chunk >= 1
            and plan.splits * plan.chunk >= hw
            and (plan.splits - 1) * plan.chunk < hw
            and n <= GRID_Y and tiles <= GRID_Y)


# G-Net's five levels at batch 8 (GUNet.yml, 256^2): B2 forward (x) and
# backward (g, x), B3 forward (x, s) and backward (g, x, y):
# (shape, staged operands, a backward's plan, (path, v, cluster))
NHWC_GNET = [
    ((8, 64, 256, 256), 1, False, (NHWC_SPLIT, 8, 1)),
    ((8, 64, 256, 256), 2, True, (NHWC_SPLIT, 16, 1)),
    ((8, 128, 128, 128), 1, False, (NHWC_STAGED, 4, 8)),
    ((8, 128, 128, 128), 2, True, (NHWC_SPLIT, 16, 1)),
    ((8, 128, 128, 128), 2, False, (NHWC_SPLIT, 8, 1)),
    ((8, 128, 128, 128), 3, True, (NHWC_SPLIT, 16, 1)),
    ((8, 256, 64, 64), 1, False, (NHWC_STAGED, 4, 2)),
    ((8, 256, 64, 64), 2, True, (NHWC_STAGED, 4, 4)),
    ((8, 256, 64, 64), 2, False, (NHWC_STAGED, 4, 4)),
    ((8, 256, 64, 64), 3, True, (NHWC_STAGED, 4, 8)),
    ((8, 512, 32, 32), 1, False, (NHWC_STAGED, 4, 1)),
    ((8, 512, 32, 32), 2, True, (NHWC_STAGED, 4, 1)),
    ((8, 512, 32, 32), 3, True, (NHWC_STAGED, 4, 2)),
    ((8, 1024, 16, 16), 2, False, (NHWC_STAGED, 4, 1)),
    ((8, 1024, 16, 16), 3, True, (NHWC_STAGED, 4, 1))]


@pytest.mark.parametrize("shape,arrays,grad,want", NHWC_GNET)
def test_nhwc_plan_at_gnet_levels(shape, arrays, grad, want):
    """64-byte rows staged on the fewest CTAs within 128 KiB each; the split
    plan's whole 128-byte rows where a (sample, tile) does not fit, in 4
    channels a thread for a backward."""
    n, c, h, w = shape
    plan = in_relu_nhwc_plan(n, c, h * w, BF16, True, arrays, grad)
    assert (plan.path, plan.v, plan.cluster) == want
    assert plan.pack == (4 if plan.path == NHWC_SPLIT and grad else 8)
    assert nhwc_launcher_accepts(plan, n, c, h * w, BF16, arrays)


NHWC_EDGE = [((2, 64, 13, 11), BF16), ((1, 128, 33, 31), BF16),
             ((3, 8, 17, 9), BF16), ((2, 24, 5, 7), BF16),
             ((2, 30, 9, 10), BF16), ((2, 64, 13, 11), F32),
             ((1, 3, 16, 16), F32), ((1, 16, 512, 512), BF16),
             ((4, 30, 10, 256 * 256), BF16), ((2, 1024, 1, 1), F32)]


@pytest.mark.parametrize("shape,dtype", NHWC_EDGE + [
    (s, BF16) for s, _, _, _ in NHWC_GNET])
@pytest.mark.parametrize("aligned", [True, False])
def test_nhwc_plans_fit_and_cover_every_row(shape, dtype, aligned):
    n, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    for arrays, grad in ((1, False), (2, False), (2, True), (3, True)):
        plan = in_relu_nhwc_plan(n, c, hw, dtype, aligned, arrays, grad)
        assert nhwc_launcher_accepts(plan, n, c, hw, dtype, arrays, aligned)
        if not aligned or c % _per_pack(dtype):
            assert plan.pack == 1
        if plan.path == NHWC_STAGED:     # rows of at most 64 bytes
            assert plan.v * plan.pack * (16 // _per_pack(dtype)) <= 64
    for grad in (False, True):
        split = in_relu_nhwc_split_plan(n, c, hw, dtype, aligned, grad)
        assert split.path == NHWC_SPLIT
        assert nhwc_launcher_accepts(split, n, c, hw, dtype, 1, aligned)
    # the chunks tile [0, hw): every row in exactly one chunk
    cover = np.zeros(hw, dtype=np.int64)
    for k in range(split.splits):
        cover[k * split.chunk:min(hw, (k + 1) * split.chunk)] += 1
    assert (cover == 1).all()


def test_nhwc_launcher_refuses_a_plan_that_does_not_fit():
    plan = in_relu_nhwc_plan(8, 256, 4096, BF16)
    for bad in (plan._replace(v=3), plan._replace(cluster=16),
                plan._replace(smem_bytes=plan.smem_bytes + 16),
                plan._replace(pack=4)):
        assert not nhwc_launcher_accepts(bad, 8, 256, 4096, BF16, 1)
    split = in_relu_nhwc_split_plan(8, 64, 65536, BF16)
    assert not nhwc_launcher_accepts(split._replace(splits=split.splits - 1),
                                     8, 64, 65536, BF16, 1)


@pytest.mark.parametrize("make,nhwc", [
    (lambda: torch.empty(2, 16, 8, 8), False),
    (lambda: torch.empty(2, 16, 8, 8).contiguous(
        memory_format=torch.channels_last), True),
    (lambda: torch.empty(2, 8, 8, 16).permute(0, 3, 1, 2), True),
    (lambda: torch.empty(2, 16, 8, 8).transpose(2, 3), False),
    # a channel slice of a channels-last tensor: not dense
    (lambda: torch.empty(2, 32, 8, 8).contiguous(
        memory_format=torch.channels_last)[:, :16], False),
    # both layouts at once: the NCHW plans
    (lambda: torch.empty(2, 1, 8, 8).contiguous(
        memory_format=torch.channels_last), False),
    (lambda: torch.empty(2, 16, 1, 1).contiguous(
        memory_format=torch.channels_last), False),
    # NDHWC: copied contiguous, the NCHW plans (UNet3D's first block)
    (lambda: torch.empty(2, 4, 3, 8, 8).contiguous(
        memory_format=torch.channels_last_3d), False),
    (lambda: torch.empty(2, 16, 8).transpose(1, 2), False)],
    ids=["nchw", "channels_last", "permuted_nhwc", "transposed",
         "channel_slice", "one_channel", "one_pixel", "ndhwc", "rank3"])
def test_the_strides_choose_the_plans(make, nhwc):
    """B2 and B3 take their NHWC plans for a channels-last (not also
    contiguous) operand, their NCHW plans for a contiguous one; each plan's
    operators' fake implementations give what the card's do: y in x's
    layout, then x̂ (boxseg::in_relu_fwd, boxseg::modnorm_relu_fwd) or the
    planes' mean [N, C] (boxseg::in_relu_nhwc_fwd,
    boxseg::modnorm_relu_nhwc_fwd), and rstd."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from boxsegliver_torch.ops import kernels

    x = make()
    assert kernels.is_nhwc(x) == nhwc
    if not (nhwc or x.is_contiguous()):
        return
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        w = torch.ones(x.shape[1])
        ops = torch.ops.boxseg
        b2, b3 = ((ops.in_relu_nhwc_fwd, ops.modnorm_relu_nhwc_fwd) if nhwc
                  else (ops.in_relu_fwd, ops.modnorm_relu_fwd))
        for y, aux, rstd in (b2(fx, w, w, 1e-6),
                             b3(fx, None, None, w, None, 1e-6, True)):
            assert y.stride() == x.stride()
            assert kernels.is_nhwc(y) == nhwc
            assert aux.shape == (x.shape[:2] if nhwc else x.shape)
            assert rstd.shape == x.shape[:2]
