"""Kernel G1's order of operations (boxsegliver_torch/csrc/geodesic.cu),
emulated in torch on the CPU and held against JAX's ``ops/geodesic.
geodesic2d`` and the port's plain version.

The kernel solves each row's recurrence d[x] = min(c[x], d[x-1] + w[x]) in
another order than the plain version's doubling: every lane of a warp takes
k contiguous columns and runs them serially (the run's last value formed
again as a balanced tree of the (w, c) pairs), the lanes' (sum of w, last
c) pairs go through a 5-stage Kogge-Stone scan, the block plan folds the
warps' totals in warp order, and each lane fixes its columns up with
d_in + (its prefix sum of w).  The backward pass is the same order on the
mirrored field.  Every float operation below is one of the kernel's, in its
order, so this shows on the CPU that the kernel's rounding stays within
the card check's tolerance: 1e-5 of the field's largest finite value,
+inf at the same pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from boxsegliver_tpu.ops import geodesic as jgeo
from boxsegliver_torch.ops import geodesic as tgeo
from boxsegliver_torch.ops.kernels import GEO_BLOCK, GEO_WARP, geodesic_plan

torch.set_num_threads(2)

INF = float("inf")
LANES = 32
STAGES = 5


def _edges(img, lamb):
    """The edge kernel: [n, h, w, 4] weights to the neighbours at x-1
    (same row), (y-1, x-1), (y-1, x) and (y-1, x+1), +inf where the
    neighbour lies outside; sqrt((1-λ)·l² + λ·ΔI·ΔI) rounded as the
    kernel's step_cost."""
    lam = torch.tensor(lamb, dtype=torch.float32)
    a = torch.tensor(1.0, dtype=torch.float32) - lam

    def cost(l2, d):
        return torch.sqrt(a * l2 + lam * d * d)

    n, h, w = img.shape
    e = torch.full((n, h, w, 4), INF)
    e[:, :, 1:, 0] = cost(1.0, img[:, :, 1:] - img[:, :, :-1])
    e[:, 1:, 1:, 1] = cost(2.0, img[:, 1:, 1:] - img[:, :-1, :-1])
    e[:, 1:, :, 2] = cost(1.0, img[:, 1:] - img[:, :-1])
    e[:, 1:, :-1, 3] = cost(2.0, img[:, 1:, :-1] - img[:, :-1, 1:])
    return e


def _from_lane(v, off):
    """v of the lane ``off`` ranks earlier within each warp (a shuffle:
    lanes without one keep their own); v [n, warps, 32]."""
    return torch.cat([v[..., :off], v[..., :-off]], dim=-1)


def _pass(e, dold, k, warps, front):
    """One raster pass in the kernel's order over e [n, h, w, 4] and dold
    [n, h, w], both in scan order (the backward pass gets the mirrored
    field), with ``front`` padding columns before column 0."""
    n, h, w = dold.shape
    lanes = LANES * warps
    back = lanes * k - w - front
    e = F.pad(e, (0, 0, front, back), value=INF).reshape(n, h, lanes, k, 4)
    dold = F.pad(dold, (front, back), value=INF).reshape(n, h, lanes, k)
    rank = torch.arange(LANES)
    pd = torch.full((n, lanes, k), INF)        # the row above
    pd_prev = torch.full((n, lanes), INF)      # its column before the lane's
    pd_next = torch.full((n, lanes), INF)      # its column after the lane's
    rows = []
    for y in range(h):
        sw, wp, wv, wn = e[:, y].unbind(-1)
        before = torch.cat([pd_prev[..., None], pd[..., :-1]], dim=-1)
        after = torch.cat([pd[..., 1:], pd_next[..., None]], dim=-1)
        c = torch.minimum(torch.minimum(dold[:, y], pd + wv),
                          torch.minimum(before + wp, after + wn))
        cl, t = [c[..., 0]], [sw[..., 0]]
        for j in range(1, k):                  # the lane's serial run
            cl.append(torch.minimum(c[..., j], cl[-1] + sw[..., j]))
            t.append(t[-1] + sw[..., j])
        tw = [sw[..., j] for j in range(k)]    # cl[-1] again, as a tree
        tc = [c[..., j] for j in range(k)]
        while len(tc) > 1:
            pairs = range(0, len(tc) - 1, 2)
            nc = [torch.minimum(tc[i + 1], tc[i] + tw[i + 1]) for i in pairs]
            nw = [tw[i] + tw[i + 1] for i in pairs]
            if len(tc) % 2:
                nc.append(tc[-1])
                nw.append(tw[-1])
            tc, tw = nc, nw
        a = t[-1].reshape(n, warps, LANES)
        b = tc[0].reshape(n, warps, LANES)
        for st in range(STAGES):               # Kogge-Stone over the lanes
            off = 1 << st
            has = rank >= off
            b = torch.where(has, torch.minimum(b, _from_lane(b, off) + a), b)
            a = torch.where(has, _from_lane(a, off) + a, a)
        carry = [torch.full((n,), INF)]        # the warps before, in order
        for q in range(warps - 1):
            carry.append(torch.minimum(b[:, q, -1], carry[-1] + a[:, q, -1]))
        carry = torch.stack(carry, dim=1)[..., None]
        incl = torch.minimum(b, carry + a)     # = b on the warp plan
        d_in = torch.cat([carry, incl[..., :-1]], dim=-1).reshape(n, lanes)
        incl = incl.reshape(n, lanes)
        d = [torch.minimum(cl[j], d_in + t[j]) for j in range(k - 1)]
        pd = torch.stack(d + [incl], dim=-1)
        inf1 = torch.full((n, 1), INF)
        c_next = torch.cat([c[:, 1:, 0], inf1], dim=1)
        w_next = torch.cat([sw[:, 1:, 0], inf1], dim=1)
        pd_prev = d_in
        pd_next = torch.minimum(c_next, incl + w_next)
        rows.append(pd)
    out = torch.stack(rows, dim=1).reshape(n, h, lanes * k)
    return out[:, :, front:front + w]


def emulate_g1(img, seeds, lamb=1.0, iterations=4):
    """G1 on [n, h, w] in the kernel's order under geodesic_plan's lanes."""
    n, h, w = img.shape
    plan = geodesic_plan(w)
    pad = LANES * plan.warps * plan.k - w
    fwd = _edges(img, lamb)
    bwd = _edges(img.flip(-2, -1), lamb)
    dist = torch.where(seeds.bool(), 0.0, INF)
    for _ in range(iterations):
        dist = _pass(fwd, dist, plan.k, plan.warps, 0)
        dist = _pass(bwd, dist.flip(-2, -1), plan.k, plan.warps,
                     pad).flip(-2, -1)
    return dist


def _inputs(n, h, w, seed):
    rng = np.random.default_rng(seed)
    img = (rng.normal(size=(n, h, w)) * 2.0).astype(np.float32)
    seeds = rng.random((n, h, w)) > 0.995
    seeds[:, (h - 1) // 2, (w - 1) // 2] = True
    seeds[0] = False                                   # no seed: all inf
    if n > 2:
        seeds[2] = False
        seeds[2, 0, 0] = seeds[2, -1, -1] = True       # corners
    return img, seeds


def _close(got, want):
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    if fin.any():
        scale = max(1.0, float(np.abs(want[fin]).max()))
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=1e-5 * scale)


SHAPES = {"odd": (3, 127, 129), "w256": (2, 64, 256), "one_row": (2, 1, 77),
          "one_column": (2, 77, 1), "block": (3, 24, 300)}


@pytest.mark.parametrize("lamb", [1.0, 0.5])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_order_matches_jax_and_plain(shape, lamb):
    n, h, w = SHAPES[shape]
    img, seeds = _inputs(n, h, w, h * 1000 + w)
    got = emulate_g1(torch.from_numpy(img), torch.from_numpy(seeds),
                     lamb).numpy()
    assert not np.isfinite(got[0]).any()
    plain = tgeo.geodesic2d(torch.from_numpy(img), torch.from_numpy(seeds),
                            lamb).numpy()
    _close(got, plain)
    for i in range(n):
        want = np.asarray(jgeo.geodesic2d(jnp.asarray(img[i]),
                                          jnp.asarray(seeds[i]), lamb, 4))
        _close(got[i], want)


@pytest.mark.parametrize("w,want", [
    (128, (GEO_WARP, 4, 1)), (256, (GEO_WARP, 8, 1)), (129, (GEO_WARP, 8, 1)),
    (1, (GEO_WARP, 2, 1)), (77, (GEO_WARP, 4, 1)), (64, (GEO_WARP, 2, 1)),
    (257, (GEO_BLOCK, 4, 3)), (1024, (GEO_BLOCK, 4, 8))])
def test_plan(w, want):
    """The warp plan up to w = 256 (k = ceil(w / 32) rounded up to 2, 4 or
    8), the block plan above; every column covered."""
    plan = geodesic_plan(w)
    assert tuple(plan) == want
    assert LANES * plan.warps * plan.k >= w
