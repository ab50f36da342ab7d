"""The launch plan of kernel B2-fwd (ops/kernels.in_relu_fwd_plan): which
path each shape takes, and that every plan fits the card and covers every
element of every plane exactly once.  Pure Python: runs on the CPU."""

import numpy as np
import pytest
import torch

from boxsegliver_torch.ops.kernels import (FWD_GENERAL, FWD_STAGED,
                                           FWD_THREADS, FWD_WARP,
                                           in_relu_fwd_plan)

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
