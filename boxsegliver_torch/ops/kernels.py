"""Hand-written CUDA kernels of the port and their wrappers (counterpart of
boxsegliver_tpu/ops/pallas_kernels.py).

Every wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream and raises
if the launch failed.  The C functions are bound once, at first use
(``_bind``), and a launch enters the tensor's device only when it is not
already the current one.  A CPU tensor takes the plain PyTorch version beside
it; a CUDA tensor launches the kernel or raises — there is no fall back.
Each wrapper counts its launches in a plain integer attribute
(``gaussian_guide_batch.launches``), so a run can show that its main path
went through the kernel.

Kernels:
- B1 ``gaussian_guide_batch`` — csrc/guide_render.cu, replaces
  pallas_kernels.py:_guide_kernel / gaussian_guide_batch.  At the guided
  sweep's shape (2 x 256 x 256, K <= 48) it writes 512 KiB (~0.16 us at
  3.35 TB/s) and evaluates 2 * 256^2 * K exponentials (~0.24 us at the
  card's exp rate): the launch latency, not bandwidth or arithmetic, bounds
  it.  No single PyTorch call computes this function, so there is no
  library yardstick.
- B2 fused instance-norm + ReLU, csrc/in_relu.cu: ``in_relu_fwd`` (the
  forward of pallas_kernels.fused_instance_norm_relu), ``in_relu_bwd``
  (B2f: the whole VJP in one pass where a plane fits on chip),
  ``in_relu_bwd_stats`` (B2a, replaces _bwd_stats_kernel) and
  ``in_relu_bwd_apply`` (B2b, replaces _bwd_apply_kernel), tied together by
  ``InstanceNormReLU``.  Bandwidth bounds them (source note).  The forward
  takes one of three paths (warp, staged on a thread-block cluster,
  general), chosen from the shape by ``in_relu_fwd_plan``; the backward one
  of three (B2f's fused warp and fused staged, or B2a + B2b split over
  several CTAs a plane), chosen by ``in_relu_bwd_plan``.  The nearest
  PyTorch yardstick is two calls, ``F.relu(F.instance_norm(...))``.
  B2-fwd is the registered operator
  ``torch.ops.boxseg.in_relu_fwd`` (torch.library: CPU implementation the
  plain version; CUDA the kernel, which counts its launches; a fake
  implementation for tracing), so torch.export keeps it as one node of an
  exported model and a loaded program launches the kernel on the card.
- B3 G-Net's modulated block, csrc/in_relu.cu: ``modnorm_relu_fwd`` and
  ``modnorm_relu_bwd``, tied together by ``ModulatedNormReLU``: instance
  norm (the norm's scale and center optional) · the context's γ + the
  spatial term s → ReLU, each of γ and s optional.  Not a TPU kernel: JAX
  leaves the chain to XLA (boxsegliver_tpu/models/gunet.py:215-232).
  Bytes bound it, 16 an element a bf16 training step and 6 under no-grad
  (source note); it is B2's kernels under another epilogue and takes
  B2's plans (``in_relu_fwd_plan``, ``in_relu_bwd_plan``).  B3-fwd is
  the registered operator ``torch.ops.boxseg.modnorm_relu_fwd``, as B2-fwd
  is; under no-grad it writes y alone.  No single PyTorch call computes
  it.
- G1 ``geodesic2d_batch`` — csrc/geodesic.cu: the 2-D geodesic raster scan
  of N fields at once, the device refiner's geodesic click guides.  The
  edge weights are computed once a launch (scratch the wrapper allocates);
  then a chain of 2 * iterations * h dependent row steps a field, each a
  warp's register-resident row: the warp plan (w <= 256) runs one warp a
  field with no block barrier, the block plan (up to w = 1024) one CTA of
  w / 128 warps with one barrier a row, chosen by ``geodesic_plan``.  Not a
  TPU kernel: JAX computes it with XLA (boxsegliver_tpu/ops/geodesic.py:93);
  its plain version is ops/geodesic.geodesic2d.  No single PyTorch call
  computes it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

_MAX_OBJECTS = 2048        # the valid-object index list in shared memory
_MAX_BATCH = 65535         # grid.z

# the C functions of each csrc/ source, bound on first use
_LIBRARY = {"guide_render": "guide_render", "in_relu_fwd": "in_relu",
            "in_relu_bwd": "in_relu", "in_relu_bwd_stats": "in_relu",
            "in_relu_bwd_apply": "in_relu",
            "in_relu_fwd_partial": "in_relu", "in_relu_fwd_apply": "in_relu",
            "modnorm_relu_fwd": "in_relu", "modnorm_relu_bwd": "in_relu",
            "in_relu_nhwc_fwd": "in_relu", "in_relu_nhwc_bwd": "in_relu",
            "modnorm_relu_nhwc_fwd": "in_relu",
            "modnorm_relu_nhwc_bwd": "in_relu",
            "channel_sums_nhwc": "in_relu",
            "geodesic2d_raster": "geodesic"}
_BOUND = {}


def _bind(name):
    from boxsegliver_torch.csrc import build

    fn = _BOUND[name] = getattr(build.load(_LIBRARY[name]), name)
    return fn


def _launch(name, t: torch.Tensor, *args):
    """Call C function ``name`` with ``args`` (tensor pointers as ints) and
    the current stream of ``t``'s device; raise if the launch failed."""
    fn = _BOUND.get(name) or _bind(name)
    if t.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(t.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def gaussian_guide_batch_plain(centers: torch.Tensor, stddevs: torch.Tensor,
                               valid: torch.Tensor, *, height: int, width: int,
                               scale: float = 1.0, offset: float = 0.0
                               ) -> torch.Tensor:
    """Plain PyTorch version of kernel B1, operation for operation:
    ``scale * clip(max_k valid exp(-((r-cy)²·iy + (c-cx)²·ix)), 0, 1) +
    offset`` with iy = 0.5 / max(sy², 1e-12) (likewise ix); 0 where no
    object is valid.  Returns [bs, height, width, 1] float32."""
    dev = centers.device
    bs, k = centers.shape[0], centers.shape[1]
    if k == 0:
        g = torch.zeros((bs, height, width), dtype=torch.float32, device=dev)
    else:
        rows = torch.arange(height, dtype=torch.float32, device=dev)
        cols = torch.arange(width, dtype=torch.float32, device=dev)
        c = centers.float()
        s = stddevs.float()
        iy = 0.5 / torch.clamp_min(s[..., 0] * s[..., 0], 1e-12)
        ix = 0.5 / torch.clamp_min(s[..., 1] * s[..., 1], 1e-12)
        dy = rows[None, None, :] - c[..., 0, None]          # [bs, K, H]
        dx = cols[None, None, :] - c[..., 1, None]          # [bs, K, W]
        ey = (dy * dy) * iy[..., None]
        ex = (dx * dx) * ix[..., None]
        e = ey[..., :, None] + ex[..., None, :]             # [bs, K, H, W]
        g = torch.exp(-e)
        g = torch.where(valid.bool()[..., None, None], g, 0.0).amax(dim=1)
        g = torch.clamp(g, 0.0, 1.0)
    return (g * scale + offset)[..., None]


def _check(centers, stddevs, valid, height, width):
    if centers.device.type != "cuda":
        raise ValueError(f"gaussian_guide_batch: unsupported device "
                         f"{centers.device}")
    for name, t in (("stddevs", stddevs), ("valid", valid)):
        if t.device != centers.device:
            raise ValueError(f"gaussian_guide_batch: {name} on {t.device}, "
                             f"centers on {centers.device}")
    if centers.dtype != torch.float32 or stddevs.dtype != torch.float32:
        raise TypeError("gaussian_guide_batch: centers and stddevs must be "
                        "float32")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("gaussian_guide_batch: valid must be bool or uint8")
    if (centers.ndim != 3 or centers.shape[-1] != 2
            or stddevs.shape != centers.shape
            or tuple(valid.shape) != tuple(centers.shape[:2])):
        raise ValueError("gaussian_guide_batch: expected centers/stddevs "
                         "[bs, K, 2] and valid [bs, K], got "
                         f"{tuple(centers.shape)}, {tuple(stddevs.shape)}, "
                         f"{tuple(valid.shape)}")
    bs, k = centers.shape[:2]
    if k > _MAX_OBJECTS or bs > _MAX_BATCH or height * width >= 2 ** 31:
        raise ValueError(f"gaussian_guide_batch: bs={bs}, K={k}, "
                         f"{height}x{width} exceeds the kernel's limits")
    for name, t in (("centers", centers), ("stddevs", stddevs),
                    ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"gaussian_guide_batch: {name} must be "
                             "contiguous")


def gaussian_guide_batch(centers: torch.Tensor, stddevs: torch.Tensor,
                         valid: torch.Tensor, *, height: int, width: int,
                         scale: float = 1.0, offset: float = 0.0
                         ) -> torch.Tensor:
    """Kernel B1: batched Gaussian guide render with a fused affine
    epilogue.

    centers / stddevs: [bs, K, 2] float32 (ij); valid: [bs, K] bool or
    uint8 — any subset of objects, so the TPU kernel's ``n_objs`` prefix is
    ``arange(K) < n_objs``.  Returns [bs, height, width, 1] float32 equal to
    ``scale * guide + offset``; the guided sweep passes scale =
    discount / 2 and offset = GUIDE_BG."""
    if centers.device.type == "cpu":
        return gaussian_guide_batch_plain(centers, stddevs, valid,
                                          height=height, width=width,
                                          scale=scale, offset=offset)
    _check(centers, stddevs, valid, height, width)
    bs, k = centers.shape[:2]
    out = torch.empty((bs, height, width, 1), dtype=torch.float32,
                      device=centers.device)
    _launch("guide_render", centers, centers.data_ptr(), stddevs.data_ptr(),
            valid.data_ptr(), out.data_ptr(), bs, k, height, width,
            float(scale), float(offset))
    gaussian_guide_batch.launches += 1
    return out


gaussian_guide_batch.launches = 0


# ---------------------------------------------------------------------------
# G1: batched 2-D geodesic raster scan
# ---------------------------------------------------------------------------

GEO_WARP, GEO_BLOCK = 0, 1
_GEO_WARP_KS = (2, 4, 8)   # columns a lane on the warp plan: w <= 256
_GEO_BLOCK_K = 4           # columns a lane holds on the block plan
_MAX_GEO_WIDTH = 1024      # the block plan: at most 8 warps of 128 columns


class GeoPlan(NamedTuple):
    """How G1 covers a row: ``path`` GEO_WARP (one warp a field) or
    GEO_BLOCK (one CTA of ``warps`` warps a field, one barrier a row);
    ``k`` columns a lane.  Either way one CTA a field."""
    path: int
    k: int
    warps: int


def geodesic_plan(w: int) -> GeoPlan:
    """G1's plan for fields of width w.

    warp when a row fits 32 lanes of at most 8 columns (w <= 256): k =
    ceil(w / 32) rounded up to 2, 4 or 8 (the columns past w hold +inf).
    block otherwise (257 <= w <= 1024): ceil(w / 128) warps of 4 columns a
    lane."""
    if w <= 32 * _GEO_WARP_KS[-1]:
        k = next(k for k in _GEO_WARP_KS if 32 * k >= w)
        return GeoPlan(GEO_WARP, k, 1)
    return GeoPlan(GEO_BLOCK, _GEO_BLOCK_K, -(-w // (32 * _GEO_BLOCK_K)))


def geodesic2d_batch(img: torch.Tensor, seeds: torch.Tensor,
                     lamb: float = 1.0, iterations: int = 4) -> torch.Tensor:
    """Kernel G1: geodesic distance of N fields from the nonzero pixels of
    ``seeds`` (img [N, h, w] float32, seeds [N, h, w] bool or uint8, both
    contiguous, w <= 1024) by ``iterations`` forward + backward raster
    passes.  Returns [N, h, w] float32, +inf where no seed is reached.  On
    the CPU: the plain version, ops/geodesic.geodesic2d."""
    if img.device.type == "cpu":
        from boxsegliver_torch.ops.geodesic import geodesic2d
        return geodesic2d(img, seeds, lamb, iterations)
    if img.device.type != "cuda" or seeds.device != img.device:
        raise ValueError(f"geodesic2d_batch: img on {img.device}, seeds on "
                         f"{seeds.device}")
    if img.dtype != torch.float32:
        raise TypeError("geodesic2d_batch: img must be float32")
    if seeds.dtype not in (torch.bool, torch.uint8):
        raise TypeError("geodesic2d_batch: seeds must be bool or uint8")
    if img.ndim != 3 or seeds.shape != img.shape:
        raise ValueError("geodesic2d_batch: expected img and seeds [N, h, w], "
                         f"got {tuple(img.shape)}, {tuple(seeds.shape)}")
    n, h, w = img.shape
    if w > _MAX_GEO_WIDTH or n * h * w >= 2 ** 31:
        raise ValueError(f"geodesic2d_batch: [{n}, {h}, {w}] exceeds the "
                         "kernel's limits (w <= 1024)")
    if not (img.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("geodesic2d_batch: img and seeds must be contiguous")
    out = torch.empty_like(img)
    # the four edge weights of every pixel, computed once a launch
    edges = torch.empty((n, h, w, 4), dtype=torch.float32, device=img.device)
    plan = geodesic_plan(w)
    _launch("geodesic2d_raster", img, img.data_ptr(), seeds.data_ptr(),
            out.data_ptr(), edges.data_ptr(), n, h, w, float(lamb),
            int(iterations), plan.path, plan.k, plan.warps)
    geodesic2d_batch.launches += 1
    return out


geodesic2d_batch.launches = 0


# ---------------------------------------------------------------------------
# B2: fused instance-norm + ReLU over [N, C, *S] (NCHW, NCDHW, ...):
# statistics over each (n, c) plane of hw = prod(S) elements
# ---------------------------------------------------------------------------

IN_EPS = 1e-6                  # tf.contrib instance_norm default
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The accumulation dtype of the plain versions: float32, float64 for
    float64 operands."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _plane_view(t: torch.Tensor, per: torch.Tensor) -> torch.Tensor:
    """``per`` ([C] or [N, C]) shaped to broadcast over the plane axes of
    ``t`` ([N, C, *S])."""
    lead = (1, -1) if per.ndim == 1 else tuple(per.shape)
    return per.reshape(lead + (1,) * (t.ndim - 2))


def _plane_stats(x: torch.Tensor, eps: float, exact: bool = False):
    """(mean, rstd), each [N, C] f32, of B2-fwd's and B3-fwd's plain
    versions: f32 statistics over each (n, c) plane of x [N, C, *S]
    (variance E[x²] − E[x]² clipped at 0, flax's), rstd = rsqrt(var + eps)
    (float64 throughout for a float64 x, which only the CPU takes:
    torch.autograd.gradcheck).  With ``exact`` the statistics come from
    exact float64 sums (_exact_stats) instead of f32 ones."""
    if exact:
        return _exact_stats(x, eps)
    xf = _acc(x)
    dims = tuple(range(2, x.ndim))
    inv_hw = 1.0 / math.prod(x.shape[2:])
    mean = xf.sum(dim=dims) * inv_hw
    var = torch.clamp_min((xf * xf).sum(dim=dims) * inv_hw - mean * mean,
                          0.0)
    return mean, torch.rsqrt(var + eps)


def _xhat(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor):
    """x̂ = (x − mean)·rstd in x's accumulation dtype, mean and rstd [N,
    C]: the forward's, and the NHWC plans' backward's, which takes x̂ from
    x again."""
    return (_acc(x) - _plane_view(x, mean)) * _plane_view(x, rstd)


def _plane_norm(x: torch.Tensor, eps: float, exact: bool = False):
    """(x̂ f32, rstd [N, C] f32) of _plane_stats's statistics."""
    mean, rstd = _plane_stats(x, eps, exact)
    return _xhat(x, mean, rstd), rstd


def _plane_sums(x: torch.Tensor) -> torch.Tensor:
    """[N, C, 2] float64 (Σx, Σx²) over each (n, c) plane of x: exact for
    bf16 and f32 planes of the port's sizes, so the sums of a plane's
    parts are the whole plane's."""
    xd = x.double()
    dims = tuple(range(2, x.ndim))
    return torch.stack([xd.sum(dim=dims), (xd * xd).sum(dim=dims)], dim=-1)


def _stats_of_sums(sums: torch.Tensor, count, eps: float,
                   dtype: torch.dtype):
    """mean and rstd [N, C] in ``dtype`` from plane sums (Σx, Σx²) [N, C,
    2] of ``count`` elements, divided in float64: the variance E[x²] −
    E[x]² clipped at 0 (flax's), rstd = rsqrt(var + eps)."""
    sums = sums.double()
    mean = sums[..., 0] / count
    var = torch.clamp_min(sums[..., 1] / count - mean * mean, 0.0)
    return mean.to(dtype), torch.rsqrt(var.to(dtype) + eps)


def _exact_stats(x: torch.Tensor, eps: float):
    """mean and rstd [N, C] of x's planes as instance_norm_stats_split
    makes them on the CPU from the ranks' parts: _plane_sums, then
    _stats_of_sums."""
    return _stats_of_sums(_plane_sums(x), math.prod(x.shape[2:]), eps,
                          _acc(x).dtype)


def in_relu_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float = IN_EPS,
                      exact: bool = False):
    """Plain PyTorch version of B2-fwd, operation for operation: x̂ and
    rstd of _plane_norm, y = relu(x̂·γ + β).  Returns y and x̂ in x's dtype
    and rstd [N, C] f32 (float64 for a float64 x).  ``exact``: the CPU's
    statistics (_plane_norm)."""
    xhat, rstd = _plane_norm(x, eps, exact)
    z = xhat * _plane_view(x, _acc(weight)) + _plane_view(x, _acc(bias))
    return torch.clamp_min(z, 0.0).to(x.dtype), xhat.to(x.dtype), rstd


def _relu_grad(g, xhat, weight, bias):
    xh = _acc(xhat)
    z = xh * _plane_view(xh, _acc(weight)) + _plane_view(xh, _acc(bias))
    return torch.where(z > 0.0, _acc(g), 0.0), xh


def in_relu_bwd_stats_plain(g, xhat, weight, bias):
    """Plain version of B2a: gz = g·[x̂·γ + β > 0]; s1 = Σ_plane gz,
    s2 = Σ_plane gz·x̂, each [N, C] f32."""
    gz, xh = _relu_grad(g, xhat, weight, bias)
    dims = tuple(range(2, g.ndim))
    return gz.sum(dim=dims), (gz * xh).sum(dim=dims)


def in_relu_bwd_apply_plain(g, xhat, weight, bias, rstd, s1, s2):
    """Plain version of B2b: dx = (γ·rstd)·((gz − s1/HW) − x̂·s2/HW), HW
    the plane's element count, in g's dtype."""
    gz, xh = _relu_grad(g, xhat, weight, bias)
    inv_hw = 1.0 / math.prod(g.shape[2:])
    m1 = _plane_view(g, s1 * inv_hw)
    m2 = _plane_view(g, s2 * inv_hw)
    coef = _plane_view(g, _acc(weight).view(1, -1) * rstd)
    return (coef * ((gz - m1) - xh * m2)).to(g.dtype)


def in_relu_bwd_plain(g, xhat, weight, bias, rstd):
    """Plain version of B2f, the whole backward but its last sums: gz, s1,
    s2, then dx, as B2a and B2b's plain versions compute them.  Returns
    (dx, s1, s2); dγ = Σ_n s2 and dβ = Σ_n s1 (pallas_kernels.py:134-135)."""
    s1, s2 = in_relu_bwd_stats_plain(g, xhat, weight, bias)
    return in_relu_bwd_apply_plain(g, xhat, weight, bias, rstd, s1, s2), s1, s2


def _planes(t: torch.Tensor):
    """(N, C, elements a plane) of t [N, C, *S]."""
    n, c = t.shape[:2]
    return n, c, math.prod(t.shape[2:])


def _check_in_relu(name, act, others, weight, bias):
    if act.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {act.dtype} is not float32 or "
                        "bfloat16")
    if act.ndim < 3:
        raise ValueError(f"{name}: expected [N, C, *S], got "
                         f"{tuple(act.shape)}")
    n, c, hw = _planes(act)
    if n * c >= 2 ** 31 or hw >= 2 ** 31:
        raise ValueError(f"{name}: {tuple(act.shape)} exceeds the kernel's "
                         "limits")
    for t in others:
        if t.shape != act.shape or t.dtype != act.dtype:
            raise ValueError(f"{name}: operands {tuple(t.shape)} {t.dtype} "
                             f"vs {tuple(act.shape)} {act.dtype}")
    for t in (weight, bias):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name}: gamma / beta must be [{c}] float32")
    for t in (act,) + tuple(others) + (weight, bias):
        if t.device != act.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{act.device}")
    _check_layout(name, act, others, (weight, bias))


# The layouts B2 and B3 take: contiguous [N, C, *S] (NCHW, NCDHW), each
# (n, c) plane contiguous, on the NCHW plans; channels-last [N, C, H, W]
# (NHWC), each sample an [H·W, C] slab with C innermost, on the NHWC plans.
# The strides choose: a tensor that is both (C or H·W of 1) is contiguous;
# any other layout (NDHWC among them: UNet3D's first conv, on its
# channels-last input) is copied contiguous first.
_CHANNELS_LAST = {4: torch.channels_last}


def is_nhwc(t: torch.Tensor) -> bool:
    """Whether t [N, C, H, W] is channels-last and not contiguous: B2 and
    B3 take their NHWC plans there, and a conv its kernel channels-last
    (models/layers.kernel_like)."""
    fmt = _CHANNELS_LAST.get(t.ndim)
    return (fmt is not None and not t.is_contiguous()
            and t.is_contiguous(memory_format=fmt))


def _format(t: torch.Tensor) -> torch.memory_format:
    """The memory format of B2's and B3's outputs for operand t."""
    return _CHANNELS_LAST[t.ndim] if is_nhwc(t) else torch.contiguous_format


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t itself in a layout B2 and B3 take, else a contiguous copy."""
    return t if t.is_contiguous() or is_nhwc(t) else t.contiguous()


def _as_layout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t in ``like``'s layout: itself where it is in it already."""
    return t.contiguous(memory_format=_format(like))


def _check_layout(name, act, others, params):
    """``act`` and ``others`` in one layout B2 and B3 take; ``params``
    (None where absent) contiguous."""
    nhwc = is_nhwc(act)
    for t in (act,) + tuple(others):
        if not (is_nhwc(t) if nhwc else t.is_contiguous()):
            raise ValueError(f"{name}: operands must be contiguous or "
                             "channels-last, all in one layout")
    for t in params:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


# B2-fwd launch plan (csrc/in_relu.cu): one of three paths, from the shape,
# the dtype and whether every operand is 16-byte aligned
FWD_GENERAL, FWD_WARP, FWD_STAGED = 0, 1, 2
FWD_THREADS = 256              # threads of every B2-fwd CTA
_WARP_MAX_PACKS = 8            # 16-byte packs a lane holds on the warp path
_STAGE_MAX = 64 * 1024         # shared memory of a staged CTA


class FwdPlan(NamedTuple):
    """How in_relu_fwd covers ``planes`` planes of ``hw`` elements: ``grid``
    CTAs of FWD_THREADS threads.  warp: ``planes_per_cta`` planes a CTA, one
    a warp, ``packs`` 16-byte packs a lane.  staged: ``cluster`` CTAs a
    plane, each holding hw / cluster elements in ``smem_bytes`` of dynamic
    shared memory.  general: one CTA a plane."""
    path: int
    grid: int
    planes_per_cta: int
    packs: int
    cluster: int
    smem_bytes: int


def _lane_packs(groups: int) -> int:
    """The 16-byte packs a lane holds on a warp path (1, 2, 4 or 8): the
    fewest that cover ``groups`` packs with 32 lanes."""
    packs = 1
    while packs * 32 < groups:
        packs *= 2
    return packs


@functools.lru_cache(maxsize=None)
def in_relu_fwd_plan(planes: int, hw: int, dtype: torch.dtype,
                     aligned: bool = True) -> FwdPlan:
    """The B2-fwd path for ``planes`` planes of ``hw`` elements of
    ``dtype``; ``aligned``: x, y and x̂ all start on 16 bytes.

    warp when a plane fits 32 lanes x 8 packs of 16 bytes (2,048 bf16,
    1,024 f32: the 32^2 level); staged when the plane splits into 1, 2, 4 or
    8 chunks of whole packs of at most 64 KiB, the fewest that do (the 64^2
    to 512^2 levels in bf16); general otherwise (odd or unaligned planes,
    512^2 f32).  The limits are where chip_smoke.py phase 7 measures each
    path fastest at the flagship shapes (PERF.md §6)."""
    esize = torch.finfo(dtype).bits // 8
    per_pack = 16 // esize
    if aligned and hw % per_pack == 0:
        groups = hw // per_pack
        if groups <= 32 * _WARP_MAX_PACKS:
            per_cta = FWD_THREADS // 32
            return FwdPlan(FWD_WARP, -(-planes // per_cta), per_cta,
                           _lane_packs(groups), 1, 0)
        for cs in (1, 2, 4, 8):                   # 8: the portable limit
            if (hw % (cs * per_pack) == 0 and hw // cs * esize <= _STAGE_MAX
                    and planes * cs < 2 ** 31):
                return FwdPlan(FWD_STAGED, planes * cs, 1, 0, cs,
                               hw // cs * esize)
    return FwdPlan(FWD_GENERAL, planes, 1, 0, 1, 0)


def _fwd_launch(x, weight, bias, eps, plan=None):
    """Launch B2-fwd on checked CUDA operands under ``plan`` (by default
    in_relu_fwd_plan's for x's shape and alignment); the C launcher refuses
    a plan that does not fit the operands.  Counts nothing: the operator's
    CUDA implementation does."""
    n, c, hw = _planes(x)
    y = torch.empty_like(x)
    xhat = torch.empty_like(x)
    rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    px, py, ph = x.data_ptr(), y.data_ptr(), xhat.data_ptr()
    if plan is None:
        plan = in_relu_fwd_plan(n * c, hw, x.dtype, (px | py | ph) % 16 == 0)
    _launch("in_relu_fwd", x, px, weight.data_ptr(), bias.data_ptr(), py, ph,
            rstd.data_ptr(), n * c, c, hw, float(eps), _DTYPES[x.dtype],
            plan.path, plan.packs, plan.cluster, plan.smem_bytes)
    return y, xhat, rstd


# B2-fwd is the operator boxseg::in_relu_fwd, so torch.export traces it as
# one node (its fake implementation gives the output shapes) and a loaded
# program dispatches it by device: the plain version on the CPU, the kernel
# on the card.  It is registered through torch.library.Library rather than
# the torch.library.custom_op decorator, which wraps each device
# implementation in torch._disable_dynamo: that wrapper imports
# torch._dynamo at the first call (seconds, once a process) and adds host
# time to every call (PERF.md, "The decorator's cost").
_LIB = torch.library.Library("boxseg", "DEF")
_LIB.define("in_relu_fwd(Tensor x, Tensor weight, Tensor bias, float eps) "
            "-> (Tensor, Tensor, Tensor)")


def _in_relu_fwd_cuda(x, weight, bias, eps):
    # an exported graph hands over x in the layout the card produced, which
    # need not be the tracer's: cuDNN returns a channels-last conv output
    # where the traced strides said contiguous, and the trace dropped the
    # caller's .contiguous()
    x = x.contiguous()
    _check_in_relu("in_relu_fwd", x, (), weight, bias)
    out = _fwd_launch(x, weight, bias, eps)
    in_relu_fwd.launches += 1
    return out


def _in_relu_fwd_cpu(x, weight, bias, eps):
    # On the CPU B2-fwd and B3-fwd take their plain versions with exact
    # plane statistics, which instance_norm_stats_split also takes there
    # from the ranks' parts: a spatially sharded forward on the CPU is the
    # unsharded one bit for bit (the card's kernels and split statistics
    # sum in f32)
    return in_relu_fwd_plain(x, weight, bias, eps, exact=True)


_LIB.impl("in_relu_fwd", _in_relu_fwd_cpu, "CPU")
_LIB.impl("in_relu_fwd", _in_relu_fwd_cuda, "CUDA")


@torch.library.register_fake("boxseg::in_relu_fwd", lib=_LIB)
def _in_relu_fwd_fake(x, weight, bias, eps):
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    return y, torch.empty_like(y), x.new_empty(x.shape[:2],
                                               dtype=torch.float32)


def in_relu_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float = IN_EPS):
    """Kernel B2-fwd: (y, x̂, rstd) of relu(instance_norm(x)·γ + β), through
    the operator ``torch.ops.boxseg.in_relu_fwd``.

    x: [N, C, *S] (NCHW, NCDHW, ...) float32 or bfloat16, contiguous;
    each (n, c) plane of prod(S) elements is normalized; weight, bias: [C]
    float32.  y and x̂ come back in x's dtype, rstd as [N, C] float32.
    A channels-last x takes the NHWC plans' operator instead
    (in_relu_fwd_nhwc_op)."""
    # the wrapper keeps the kernel's contract; the operator also takes the
    # channels-last x an exported graph may hand it
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("in_relu_fwd: operands must be contiguous")
    return torch.ops.boxseg.in_relu_fwd.default(x, weight, bias, float(eps))


# the backward's launch plan (csrc/in_relu.cu): B2f's fused warp (FWD_WARP)
# or fused staged (FWD_STAGED) path, or B2a + B2b split over several CTAs a
# plane
BWD_SPLIT = 0
# shared memory of a fused staged CTA: its chunks of g and x̂
_BWD_STAGE_TARGET = 64 * 1024  # the fewest CTAs within this, if any fit,
_BWD_STAGE_MAX = 192 * 1024    # else within this (csrc kMaxBwdStageBytes)
_APPLY_PACKS = 4               # B2b: 16-byte packs a thread of a split plan
# B2a's CTAs in all on a split plan: at UNet3D's [4,30,10,256^2], 4,200 CTAs
# (35 a plane) reach 83 % of bound, 1,080 (9 a plane: one wave of 8 CTAs a
# SM and a tail) 69 % (PERF.md §6)
STATS_TARGET_CTAS = 4096


class BwdPlan(NamedTuple):
    """How the backward covers ``planes`` planes of ``hw`` elements: fused
    (``path`` FWD_WARP or FWD_STAGED, one B2f launch of ``grid`` CTAs, as
    FwdPlan's warp and staged paths; ``smem_bytes`` holds the CTA's hw /
    ``cluster`` elements of g and of x̂) or BWD_SPLIT: B2a on ``splits`` CTAs
    a plane of ``chunk`` elements each (``grid`` = splits · planes; a second
    launch adds them when splits > 1), then B2b on ``apply_ctas`` CTAs a
    plane."""
    path: int
    grid: int
    packs: int
    cluster: int
    smem_bytes: int
    splits: int
    chunk: int
    apply_ctas: int


def in_relu_bwd_split_plan(planes: int, hw: int, dtype: torch.dtype,
                           aligned: bool = True,
                           spread: bool = True) -> BwdPlan:
    """The split plan: B2a's splits and chunk from in_relu_partial_plan
    (about STATS_TARGET_CTAS CTAs in all), B2b's CTAs a plane at
    _APPLY_PACKS packs a thread.  ``spread=False`` gives the first design,
    one CTA a plane for each kernel, kept to be timed beside the others."""
    if not spread:
        return BwdPlan(BWD_SPLIT, planes, 0, 1, 0, 1, hw, 1)
    splits, chunk = in_relu_partial_plan(planes, hw, dtype, aligned,
                                         STATS_TARGET_CTAS)
    per = 16 // (torch.finfo(dtype).bits // 8)
    groups = hw // per if aligned and hw % per == 0 else hw
    apply_ctas = -(-groups // (FWD_THREADS * _APPLY_PACKS))
    return BwdPlan(BWD_SPLIT, splits * planes, 0, 1, 0, splits, chunk,
                   apply_ctas)


@functools.lru_cache(maxsize=None)
def in_relu_bwd_plan(planes: int, hw: int, dtype: torch.dtype,
                     aligned: bool = True) -> BwdPlan:
    """The backward's path for ``planes`` planes of ``hw`` elements of
    ``dtype``; ``aligned``: g and x̂ both start on 16 bytes (dx is the
    wrapper's own).

    fused warp when a plane fits 32 lanes x 8 packs of 16 bytes (2,048
    bf16, 1,024 f32: the 32^2 and 16^2 levels, UNet3D's 5 x 16^2 bridge);
    fused staged when the plane's g and x̂ split into 1, 2, 4 or 8 chunks
    of whole packs: the fewest whose g + x̂ chunks fit _BWD_STAGE_TARGET
    (64 KiB a CTA: the 2-D levels to 256^2 bf16, 128^2 at one CTA, 256^2
    at four), else the fewest up to _BWD_STAGE_MAX (192 KiB a CTA: UNet3D's
    10 x 128^2 at four CTAs of 160 KiB); split otherwise (UNet3D's 10 x
    256^2 level, f32 planes past 8 x 192 KiB, odd or unaligned planes).
    The limits are where chip_smoke.py phase 7 measures each path fastest
    (PERF.md §6)."""
    esize = torch.finfo(dtype).bits // 8
    per_pack = 16 // esize
    if aligned and hw % per_pack == 0:
        groups = hw // per_pack
        if groups <= 32 * _WARP_MAX_PACKS:
            return BwdPlan(FWD_WARP, -(-planes // (FWD_THREADS // 32)),
                           _lane_packs(groups), 1, 0, 1, hw, 1)
        fits = [(cs, 2 * (hw // cs) * esize) for cs in (1, 2, 4, 8)
                if hw % (cs * per_pack) == 0 and planes * cs < 2 ** 31]
        for limit in (_BWD_STAGE_TARGET, _BWD_STAGE_MAX):
            for cs, smem in fits:
                if smem <= limit:
                    return BwdPlan(FWD_STAGED, planes * cs, 0, cs, smem, 1,
                                   hw, 1)
    return in_relu_bwd_split_plan(planes, hw, dtype, aligned)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check_plane_stats(name, g, stats):
    n, c, _ = _planes(g)
    for what, t in stats:
        if (t.dtype != torch.float32 or tuple(t.shape) != (n, c)
                or t.device != g.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous "
                             f"[{n}, {c}] float32 on {g.device}")


def in_relu_bwd(g: torch.Tensor, xhat: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, rstd: torch.Tensor, plan=None):
    """Kernel B2f: the backward in one pass, g and x̂ read once — dx in g's
    dtype and s1 = Σ gz, s2 = Σ gz·x̂ ([N, C] float32), under ``plan``
    (by default in_relu_bwd_plan's).  Only the fused plans run here: the C
    launcher refuses a split plan, or one that does not fit the operands,
    and the wrapper raises."""
    if g.device.type == "cpu":
        return in_relu_bwd_plain(g, xhat, weight, bias, rstd)
    _check_in_relu("in_relu_bwd", g, (xhat,), weight, bias)
    _check_plane_stats("in_relu_bwd", g, (("rstd", rstd),))
    n, c, hw = _planes(g)
    if plan is None:
        plan = in_relu_bwd_plan(n * c, hw, g.dtype, _aligned(g, xhat))
    dx = torch.empty_like(g)
    s1 = torch.empty((n, c), dtype=torch.float32, device=g.device)
    s2 = torch.empty_like(s1)
    _launch("in_relu_bwd", g, g.data_ptr(), xhat.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), s1.data_ptr(), s2.data_ptr(), n * c, c, hw,
            _DTYPES[g.dtype], plan.path, plan.packs, plan.cluster,
            plan.smem_bytes)
    in_relu_bwd.launches += 1
    return dx, s1, s2


def in_relu_bwd_stats(g: torch.Tensor, xhat: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor, plan=None):
    """Kernel B2a: per-(n, c) s1 = Σ gz and s2 = Σ gz·x̂ ([N, C] float32),
    each plane over ``plan.splits`` CTAs of ``plan.chunk`` elements (by
    default in_relu_bwd_split_plan's)."""
    if g.device.type == "cpu":
        return in_relu_bwd_stats_plain(g, xhat, weight, bias)
    _check_in_relu("in_relu_bwd_stats", g, (xhat,), weight, bias)
    n, c, hw = _planes(g)
    if plan is None:
        plan = in_relu_bwd_split_plan(n * c, hw, g.dtype, _aligned(g, xhat))
    s1 = torch.empty((n, c), dtype=torch.float32, device=g.device)
    s2 = torch.empty_like(s1)
    part = (torch.empty((n * c, plan.splits, 2), dtype=torch.float32,
                        device=g.device) if plan.splits > 1 else s1)
    _launch("in_relu_bwd_stats", g, g.data_ptr(), xhat.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), part.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), n * c, c, hw, plan.splits,
            plan.chunk, _DTYPES[g.dtype])
    in_relu_bwd_stats.launches += 1
    return s1, s2


def in_relu_bwd_apply(g: torch.Tensor, xhat: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor,
                      rstd: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                      plan=None):
    """Kernel B2b: dx = (γ·rstd)·((gz − s1/HW) − x̂·s2/HW) in g's dtype, on
    ``plan.apply_ctas`` CTAs a plane (by default in_relu_bwd_split_plan's)."""
    if g.device.type == "cpu":
        return in_relu_bwd_apply_plain(g, xhat, weight, bias, rstd, s1, s2)
    _check_in_relu("in_relu_bwd_apply", g, (xhat,), weight, bias)
    _check_plane_stats("in_relu_bwd_apply", g,
                       (("rstd", rstd), ("s1", s1), ("s2", s2)))
    n, c, hw = _planes(g)
    if plan is None:
        plan = in_relu_bwd_split_plan(n * c, hw, g.dtype, _aligned(g, xhat))
    dx = torch.empty_like(g)
    _launch("in_relu_bwd_apply", g, g.data_ptr(), xhat.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), rstd.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), dx.data_ptr(), n * c, c, hw,
            plan.apply_ctas, _DTYPES[g.dtype])
    in_relu_bwd_apply.launches += 1
    return dx


def instance_norm_relu_bwd(g: torch.Tensor, xhat: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor,
                           rstd: torch.Tensor, plan=None):
    """(dx, s1, s2) of the backward on the path ``plan`` names (by default
    in_relu_bwd_plan's for g's shape and alignment): B2f, or B2a then B2b.
    On the CPU: B2a's and B2b's plain versions."""
    if g.device.type != "cpu" and plan is None:
        n, c, hw = _planes(g)
        plan = in_relu_bwd_plan(n * c, hw, g.dtype, _aligned(g, xhat))
    if g.device.type == "cpu" or plan.path == BWD_SPLIT:
        s1, s2 = in_relu_bwd_stats(g, xhat, weight, bias, plan)
        return (in_relu_bwd_apply(g, xhat, weight, bias, rstd, s1, s2, plan),
                s1, s2)
    return in_relu_bwd(g, xhat, weight, bias, rstd, plan)


in_relu_fwd.launches = 0
in_relu_bwd.launches = 0
in_relu_bwd_stats.launches = 0
in_relu_bwd_apply.launches = 0


class InstanceNormReLU(torch.autograd.Function):
    """relu(instance_norm(x)·γ + β) over [N, C, *S] planes with eps 1e-6
    (channels-last for the 2-D models, NCDHW for UNet3D, NCHW under a
    spatial shard): B2-fwd in ``forward``; in ``backward`` B2f, or B2a and
    B2b (in_relu_bwd_plan), or the NHWC plans, then dγ = Σ_n s2 and dβ =
    Σ_n s1.  Saves x̂ in x's dtype and rstd in float32, and casts the incoming
    gradient to x̂'s dtype, as the JAX custom VJP does
    (pallas_kernels.py:138-160); on the NHWC plans it saves x and the
    planes' mean instead, and the backward takes x̂ from x again, in
    float32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        pdt = torch.float64 if x.dtype == torch.float64 else torch.float32
        weight32 = weight.to(pdt).contiguous()
        bias32 = bias.to(pdt).contiguous()
        x = _dense(x)
        # the NHWC plans keep x and the planes' mean (aux), the NCHW plans x̂
        ctx.nhwc = is_nhwc(x)
        y, aux, rstd = (in_relu_fwd_nhwc_op if ctx.nhwc else in_relu_fwd)(
            x, weight32, bias32)
        ctx.save_for_backward(*((x, aux) if ctx.nhwc else (aux,)), rstd,
                              weight32, bias32)
        ctx.param_dtypes = (weight.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.nhwc:
            x, mean, rstd, weight, bias = ctx.saved_tensors
            dx, s1, s2 = in_relu_bwd_nhwc(_as_layout(g.to(x.dtype), x), x,
                                          mean, weight, bias, rstd)
        else:
            xhat, rstd, weight, bias = ctx.saved_tensors
            dx, s1, s2 = instance_norm_relu_bwd(g.to(xhat.dtype).contiguous(),
                                                xhat, weight, bias, rstd)
        wdt, bdt = ctx.param_dtypes
        return dx, s2.sum(dim=0).to(wdt), s1.sum(dim=0).to(bdt)


def instance_norm_relu(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """relu(instance_norm(x)·γ + β) through kernel B2 ([N, C, *S], eps
    1e-6)."""
    return InstanceNormReLU.apply(x, weight, bias)


# ---------------------------------------------------------------------------
# B2 split around a collective: B2s (partial sums), all-reduce, B2y (apply)
# ---------------------------------------------------------------------------

PARTIAL_TARGET_CTAS = 1024     # B2s: about 8 CTAs of FWD_THREADS a SM


def in_relu_partial_plan(planes: int, hw: int, dtype: torch.dtype,
                         aligned: bool = True,
                         target: int = PARTIAL_TARGET_CTAS):
    """(splits, chunk): B2s (and B2a's split plan) covers each plane of
    ``hw`` elements with ``splits`` CTAs of ``chunk`` elements each (the
    last one ragged), so that about ``target`` CTAs run however few the
    planes (30 at the 3-D eval's level 0), with at least one 16-byte pack a
    thread; a chunk is a whole number of packs when x is ``aligned`` and
    ``hw`` a multiple of the pack."""
    esize = torch.finfo(dtype).bits // 8
    per = 16 // esize if aligned and hw % (16 // esize) == 0 else 1
    groups = -(-hw // per)
    splits = max(1, min(-(-target // max(planes, 1)),
                        -(-groups // FWD_THREADS)))
    chunk = -(-groups // splits) * per
    return -(-hw // chunk), chunk


def in_relu_fwd_partial_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of B2s: [N, C, 2] float32 (Σx, Σx²) over each (n, c)
    plane of x [N, C, *S] (float64 for a float64 x)."""
    xf = _acc(x)
    dims = tuple(range(2, x.ndim))
    return torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)], dim=-1)


def in_relu_fwd_apply_plain(x: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """Plain version of B2y, operation for operation as in_relu_fwd_plain's
    y: relu((x − mean)·rstd·γ + β) in x's dtype; mean, rstd [N, C]."""
    xhat = (_acc(x) - _plane_view(x, _acc(mean))) * _plane_view(x, _acc(rstd))
    z = xhat * _plane_view(x, _acc(weight)) + _plane_view(x, _acc(bias))
    return torch.clamp_min(z, 0.0).to(x.dtype)


def _check_split(name, x):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32 or "
                        "bfloat16")
    if x.ndim < 3:
        raise ValueError(f"{name}: expected [N, C, *S], got "
                         f"{tuple(x.shape)}")
    n, c, hw = _planes(x)
    if n * c >= 2 ** 31 or hw >= 2 ** 31:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the kernel's "
                         "limits")
    if not x.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")


def in_relu_fwd_partial(x: torch.Tensor) -> torch.Tensor:
    """Kernel B2s: [N, C, 2] float32 (Σx, Σx²) over each (n, c) plane of
    this rank's part of x [N, C, *S] (float32 or bfloat16, contiguous)."""
    if x.device.type == "cpu":
        return in_relu_fwd_partial_plain(x)
    _check_split("in_relu_fwd_partial", x)
    n, c, hw = _planes(x)
    splits, chunk = in_relu_partial_plan(n * c, hw, x.dtype,
                                         x.data_ptr() % 16 == 0)
    out = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    part = (torch.empty((n * c, splits, 2), dtype=torch.float32,
                        device=x.device) if splits > 1 else out)
    _launch("in_relu_fwd_partial", x, x.data_ptr(), part.data_ptr(),
            out.data_ptr(), n * c, hw, splits, chunk, _DTYPES[x.dtype])
    in_relu_fwd_partial.launches += 1
    return out


def in_relu_fwd_apply(x: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Kernel B2y: y = relu((x − mean)·rstd·γ + β) in x's dtype from the
    plane statistics mean, rstd ([N, C] float32) and γ, β ([C] float32);
    no x̂ (nothing needs it at inference)."""
    if x.device.type == "cpu":
        return in_relu_fwd_apply_plain(x, mean, rstd, weight, bias)
    _check_split("in_relu_fwd_apply", x)
    n, c, _ = _planes(x)
    for name, t, shape in (("mean", mean, (n, c)), ("rstd", rstd, (n, c)),
                           ("gamma", weight, (c,)), ("beta", bias, (c,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"in_relu_fwd_apply: {name} must be contiguous "
                             f"{list(shape)} float32 on {x.device}")
    y = torch.empty_like(x)
    _launch("in_relu_fwd_apply", x, x.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n * c, c, _planes(x)[2], _DTYPES[x.dtype])
    in_relu_fwd_apply.launches += 1
    return y


in_relu_fwd_partial.launches = 0
in_relu_fwd_apply.launches = 0


def instance_norm_stats_split(x: torch.Tensor, group, eps: float = IN_EPS):
    """Instance-norm statistics of planes split over ``group``'s ranks
    (each holds its part of every plane of x [N, C, *S]): B2s's float32
    partial sums (on the CPU the exact float64 ones of _plane_sums) and the
    element count all-reduced in float64 (as layers._SyncBatchNorm), the
    variance E[x²] − E[x]² clipped at 0, as in_relu_fwd_plain's.  Returns
    mean and rstd = rsqrt(var + eps), each [N, C] float32."""
    part = (_plane_sums(x) if x.device.type == "cpu"
            else in_relu_fwd_partial(x.contiguous()))
    count = torch.full((1,), float(_planes(x)[2]), dtype=torch.float64,
                       device=x.device)
    buf = group.all_reduce_(torch.cat([part.double().reshape(-1), count]))
    return _stats_of_sums(buf[:-1].view(part.shape), buf[-1], eps,
                          torch.float32)


def instance_norm_relu_split(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, group) -> torch.Tensor:
    """relu(instance_norm(x)·γ + β) of planes split over ``group``'s ranks:
    B2s → all-reduce → B2y.  Inference only: it raises where autograd
    would record it (JAX shards spatially only at eval)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("instance_norm_relu_split is inference only: run "
                           "it under torch.no_grad() or inference_mode()")
    mean, rstd = instance_norm_stats_split(x, group)
    return in_relu_fwd_apply(x.contiguous(), mean, rstd,
                             weight.float().contiguous(),
                             bias.float().contiguous())


# ---------------------------------------------------------------------------
# B3: G-Net's modulated block, relu((instance_norm(x)·w + b)·γ + s) over
# [N, C, *S] planes; the norm's scale w and center b ([C]), the context's γ
# ([N, C]) and the spatial term s (like x) each optional
# ---------------------------------------------------------------------------

def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def modnorm_relu_fwd_plain(x: torch.Tensor, gamma=None, s=None, weight=None,
                           bias=None, eps: float = IN_EPS,
                           train: bool = True, exact: bool = False):
    """Plain PyTorch version of B3-fwd, operation for operation: B2-fwd's
    f32 statistics and x̂ (_plane_norm; ``exact``: the CPU's), n = x̂·w +
    b, z = n·γ + s (each term skipped where its operand is None), y =
    relu(z) rounded once to x's dtype.  Returns y and x̂ in x's dtype and
    rstd [N, C] f32 (float64 for a float64 x); with ``train`` False x̂ and
    rstd are empty: nothing at inference needs them."""
    xhat, rstd = _plane_norm(x, eps, exact)
    y = _modnorm_y(x, xhat, gamma, s, weight, bias)
    if not train:
        return y, x.new_empty(0), rstd.new_empty(0)
    return y, xhat.to(x.dtype), rstd


def _modnorm_y(x, xhat, gamma, s, weight, bias):
    """B3's y from the float32 x̂: relu((x̂·w + b)·γ + s), each term
    skipped where its operand is None, rounded once to x's dtype."""
    z = xhat
    if weight is not None:
        z = z * _plane_view(x, _acc(weight))
    if bias is not None:
        z = z + _plane_view(x, _acc(bias))
    if gamma is not None:
        z = z * _plane_view(x, _acc(gamma))
    if s is not None:
        z = z + _acc(s)
    return torch.clamp_min(z, 0.0).to(x.dtype)


def modnorm_relu_bwd_plain(g, y, xhat, rstd, gamma=None, weight=None,
                           want_ds: bool = True):
    """Plain version of B3-bwd: g_m = g·[y > 0]; a = Σ_plane g_m and b =
    Σ_plane g_m·x̂ ([N, C] f32); dx = (γ·w·rstd)·((g_m − a/HW) − x̂·b/HW)
    and ds = g_m (None unless ``want_ds``) in g's dtype.  Returns (dx, ds,
    a, b); ModulatedNormReLU.backward makes dγ, dw and db of a and b."""
    gm = torch.where(y > 0, _acc(g), 0.0)
    xh = _acc(xhat)
    dims = tuple(range(2, g.ndim))
    a, b = gm.sum(dim=dims), (gm * xh).sum(dim=dims)
    inv_hw = 1.0 / math.prod(g.shape[2:])
    coef = rstd
    if gamma is not None and weight is not None:
        coef = (_acc(gamma) * _acc(weight).view(1, -1)) * rstd
    elif gamma is not None or weight is not None:
        k = _acc(gamma) if gamma is not None else _acc(weight).view(1, -1)
        coef = k * rstd
    dx = _plane_view(g, coef) * ((gm - _plane_view(g, a * inv_hw))
                                 - xh * _plane_view(g, b * inv_hw))
    return dx.to(g.dtype), gm.to(g.dtype) if want_ds else None, a, b


def _check_modnorm(name, x, others, gamma, s, weight, bias):
    """B3's operands: x and ``others`` [N, C, *S] float32 or bfloat16 of
    one dtype and one layout B3 takes; s like x (any strides: the launch
    copies what it cannot read in place); γ [N, C], w and b [C] contiguous
    float32; all on x's device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32 or "
                        "bfloat16")
    if x.ndim < 3:
        raise ValueError(f"{name}: expected [N, C, *S], got "
                         f"{tuple(x.shape)}")
    n, c, hw = _planes(x)
    if n * c >= 2 ** 31 or hw >= 2 ** 31:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the kernel's "
                         "limits")
    for t in tuple(others) + (() if s is None else (s,)):
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: operands {tuple(t.shape)} {t.dtype} "
                             f"vs {tuple(x.shape)} {x.dtype}")
    for what, t, shape in (("gamma", gamma, (n, c)), ("weight", weight, (c,)),
                           ("bias", bias, (c,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous "
                             f"{list(shape)} float32")
    for t in (x,) + tuple(others) + (gamma, s, weight, bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x.device}")
    _check_layout(name, x, others, ())


# B3-fwd is the operator boxseg::modnorm_relu_fwd, as B2-fwd is: an exported
# G-Net keeps it as one node that a loaded program dispatches by device
_LIB.define("modnorm_relu_fwd(Tensor x, Tensor? gamma, Tensor? s, "
            "Tensor? weight, Tensor? bias, float eps, bool train) "
            "-> (Tensor, Tensor, Tensor)")


def _modnorm_fwd_launch(x, gamma, s, weight, bias, eps, train, plan=None):
    """Launch B3-fwd on checked CUDA operands under ``plan`` (by default
    in_relu_fwd_plan's for x's shape and the operands' alignment); the C
    launcher refuses a plan that does not fit them.  Counts nothing: the
    operator's CUDA implementation does."""
    if s is not None and s.stride()[1:] != x.stride()[1:]:
        s = s.contiguous()      # B3 reads whole planes, at any sample stride
    n, c, hw = _planes(x)
    y = torch.empty_like(x)
    if train:
        xhat = torch.empty_like(x)
        rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    else:
        xhat, rstd = x.new_empty(0), x.new_empty(0, dtype=torch.float32)
    sbs = 0 if s is None else s.stride(0)
    if plan is None:
        per = 16 // x.element_size()
        aligned = (_aligned(x, y, *([xhat] if train else []),
                            *([] if s is None else [s])) and sbs % per == 0)
        plan = in_relu_fwd_plan(n * c, hw, x.dtype, aligned)
    _launch("modnorm_relu_fwd", x, x.data_ptr(), _ptr(s), sbs, _ptr(gamma),
            _ptr(weight), _ptr(bias), y.data_ptr(),
            xhat.data_ptr() if train else None,
            rstd.data_ptr() if train else None, n * c, c, hw, float(eps),
            _DTYPES[x.dtype], plan.path, plan.packs, plan.cluster,
            plan.smem_bytes)
    return y, xhat, rstd


def _modnorm_relu_fwd_cuda(x, gamma, s, weight, bias, eps, train):
    x = x.contiguous()          # an exported graph's layout (_in_relu_fwd_cuda)
    _check_modnorm("modnorm_relu_fwd", x, (), gamma, s, weight, bias)
    out = _modnorm_fwd_launch(x, gamma, s, weight, bias, eps, train)
    modnorm_relu_fwd.launches += 1
    return out


def _modnorm_relu_fwd_cpu(x, gamma, s, weight, bias, eps, train):
    # exact plane statistics, as _in_relu_fwd_cpu's
    return modnorm_relu_fwd_plain(x, gamma, s, weight, bias, eps, train,
                                  exact=True)


_LIB.impl("modnorm_relu_fwd", _modnorm_relu_fwd_cpu, "CPU")
_LIB.impl("modnorm_relu_fwd", _modnorm_relu_fwd_cuda, "CUDA")


@torch.library.register_fake("boxseg::modnorm_relu_fwd", lib=_LIB)
def _modnorm_relu_fwd_fake(x, gamma, s, weight, bias, eps, train):
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if not train:
        return y, x.new_empty(0), x.new_empty(0, dtype=torch.float32)
    return y, torch.empty_like(y), x.new_empty(x.shape[:2],
                                               dtype=torch.float32)


def modnorm_relu_fwd(x: torch.Tensor, gamma=None, s=None, weight=None,
                     bias=None, eps: float = IN_EPS, train: bool = True):
    """Kernel B3-fwd: (y, x̂, rstd) of relu((instance_norm(x)·w + b)·γ + s),
    through the operator ``torch.ops.boxseg.modnorm_relu_fwd``, on
    in_relu_fwd_plan's paths.

    x: [N, C, *S] float32 or bfloat16, contiguous; γ: [N, C], w and b: [C],
    each float32 and contiguous; s: like x, each plane contiguous (a
    channel slice of a wider tensor is read in place).  Any of γ, s, w and
    b may be None.  y and x̂ come back in x's dtype, rstd [N, C] float32;
    with ``train`` False only y is written (x̂ and rstd are empty).  A
    channels-last x takes the NHWC plans' operator instead
    (modnorm_relu_fwd_nhwc_op)."""
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("modnorm_relu_fwd: operands must be contiguous")
    return torch.ops.boxseg.modnorm_relu_fwd.default(
        x, gamma, s, weight, bias, float(eps), bool(train))


def modnorm_relu_bwd(g: torch.Tensor, y: torch.Tensor, xhat: torch.Tensor,
                     rstd: torch.Tensor, gamma=None, weight=None,
                     want_ds: bool = True, plan=None):
    """Kernel B3-bwd: (dx, ds, a, b) as modnorm_relu_bwd_plain gives them,
    under ``plan`` (by default in_relu_bwd_plan's for g's shape and
    alignment): one fused launch where a plane fits on chip, else the split
    sums, added in order, and an apply pass.  ds is written only with
    ``want_ds``.  The sums' order is fixed: equal from run to run."""
    if g.device.type == "cpu":
        return modnorm_relu_bwd_plain(g, y, xhat, rstd, gamma, weight,
                                      want_ds)
    _check_modnorm("modnorm_relu_bwd", g, (y, xhat), gamma, None, weight,
                   None)
    _check_plane_stats("modnorm_relu_bwd", g, (("rstd", rstd),))
    n, c, hw = _planes(g)
    if plan is None:
        plan = in_relu_bwd_plan(n * c, hw, g.dtype, _aligned(g, y, xhat))
    dx = torch.empty_like(g)
    ds = torch.empty_like(g) if want_ds else None
    a = torch.empty((n, c), dtype=torch.float32, device=g.device)
    b = torch.empty_like(a)
    part = (torch.empty((n * c, plan.splits, 2), dtype=torch.float32,
                        device=g.device)
            if plan.path == BWD_SPLIT and plan.splits > 1 else None)
    _launch("modnorm_relu_bwd", g, g.data_ptr(), y.data_ptr(),
            xhat.data_ptr(), rstd.data_ptr(), _ptr(gamma), _ptr(weight),
            dx.data_ptr(), _ptr(ds), a.data_ptr(), b.data_ptr(), _ptr(part),
            n * c, c, hw, _DTYPES[g.dtype], plan.path, plan.packs,
            plan.cluster, plan.smem_bytes, plan.splits, plan.chunk,
            plan.apply_ctas)
    modnorm_relu_bwd.launches += 1
    return dx, ds, a, b


modnorm_relu_fwd.launches = 0
modnorm_relu_bwd.launches = 0


def _f32_operands(x, *ts):
    pdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return [None if t is None else t.to(pdt).contiguous() for t in ts]


class ModulatedNormReLU(torch.autograd.Function):
    """relu((instance_norm(x)·w + b)·γ + s) over [N, C, *S] planes: B3-fwd
    in ``forward``; in ``backward`` B3-bwd, then dγ = w·b + b_c·a per plane
    and dw = Σ_n γ·b, db = Σ_n γ·a from its plane sums a = Σ g_m and b =
    Σ g_m·x̂.  Saves y (whose sign is the ReLU's mask), x̂ in x's dtype,
    rstd and the float32 γ, w, b (on the NHWC plans x and the planes' mean
    in x̂'s place: the backward takes x̂ from x again); casts the incoming
    gradient to y's dtype and layout."""

    @staticmethod
    def forward(ctx, x, gamma, s, weight, bias, eps):
        ops = _f32_operands(x, gamma, weight, bias)
        x = _dense(x)
        # the NHWC plans keep x and the planes' mean (aux), the NCHW plans x̂
        ctx.nhwc = is_nhwc(x)
        y, aux, rstd = (modnorm_relu_fwd_nhwc_op if ctx.nhwc
                        else modnorm_relu_fwd)(x, ops[0], s, ops[1], ops[2],
                                               eps)
        ctx.save_for_backward(y, *((x, aux) if ctx.nhwc else (aux,)), rstd,
                              *ops)
        ctx.dtypes = [None if t is None else t.dtype
                      for t in (gamma, weight, bias)]
        return y

    @staticmethod
    def backward(ctx, g):
        _, need_g, need_s, need_w, need_b, _ = ctx.needs_input_grad
        if ctx.nhwc:
            y, x, mean, rstd, gamma, weight, bias = ctx.saved_tensors
            dx, ds, a, b = modnorm_relu_bwd_nhwc(
                _as_layout(g.to(y.dtype), y), y, x, mean, rstd, gamma, weight,
                need_s)
        else:
            y, xhat, rstd, gamma, weight, bias = ctx.saved_tensors
            dx, ds, a, b = modnorm_relu_bwd(g.to(y.dtype).contiguous(), y,
                                            xhat, rstd, gamma, weight, need_s)
        gdt, wdt, bdt = ctx.dtypes
        dgamma = dw = db = None
        if need_g:
            dgamma = b if weight is None else b * weight
            if bias is not None:
                dgamma = dgamma + a * bias
            dgamma = dgamma.to(gdt)
        if need_w:
            dw = (b if gamma is None else b * gamma).sum(dim=0).to(wdt)
        if need_b:
            db = (a if gamma is None else a * gamma).sum(dim=0).to(bdt)
        return dx, dgamma, ds, dw, db, None


def modulated_norm_relu(x: torch.Tensor, gamma=None, s=None, weight=None,
                        bias=None, eps: float = IN_EPS) -> torch.Tensor:
    """G-Net's modulated block relu((instance_norm(x)·w + b)·γ + s) through
    kernel B3: x [N, C, *S]; γ [N, C] (the context's slice), s like x (the
    spatial term), w and b [C] (the norm's scale and center), each may be
    None.  Through autograd where an operand needs a gradient, else B3-fwd
    writing y alone."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, s, weight, bias)):
        return ModulatedNormReLU.apply(x, gamma, s, weight, bias, eps)
    ops = _f32_operands(x, gamma, weight, bias)
    x = _dense(x)
    return (modnorm_relu_fwd_nhwc_op if is_nhwc(x) else modnorm_relu_fwd)(
        x, ops[0], s, ops[1], ops[2], eps, train=False)[0]


def modnorm_relu_split(x: torch.Tensor, gamma, s, weight, bias, group,
                       eps: float = IN_EPS) -> torch.Tensor:
    """B3's function of planes split over ``group``'s ranks (each holds its
    part of every plane of x and of s): instance_norm_stats_split's
    statistics, then modnorm_relu_fwd_plain's arithmetic in float32,
    rounded once, so that a sharded forward computes what B3 computes on
    whole planes (on the CPU, where both take exact plane sums, bit for
    bit).  Inference only."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, s, weight, bias)):
        raise RuntimeError("modnorm_relu_split is inference only: run it "
                           "under torch.no_grad() or inference_mode()")
    mean, rstd = instance_norm_stats_split(x, group, eps)
    xhat = (_acc(x) - _plane_view(x, mean)) * _plane_view(x, rstd)
    return _modnorm_y(x, xhat, gamma, s, weight, bias)


# ---------------------------------------------------------------------------
# B2 and B3 over channels-last activations: the NHWC plans (csrc/in_relu.cu)
# ---------------------------------------------------------------------------

NHWC_SPLIT, NHWC_STAGED = 0, 2   # the plans' `path`: C's kPathGeneral, Staged
_NHWC_MAX_TILE = 64              # kNhwcMaxTile: channels a CTA covers
_NHWC_ROW = 64                   # bytes of a tile's row, at most, by choice
_NHWC_MIN_ROW = 32               # and at least, where c allows it
_NHWC_STAGE_MAX = 128 * 1024     # a staged CTA's operands, by choice
_NHWC_ROWS_PER_THREAD = 16       # the split plan's rows a thread a chunk


class NhwcPlan(NamedTuple):
    """How an NHWC launch covers n samples of hw rows and c channels: a
    thread's vector of ``pack`` channels (16 bytes' worth, or 1), ``v``
    vectors a row of a CTA's channel tile; ``path`` NHWC_STAGED: a cluster
    of ``cluster`` CTAs a (sample, tile), each keeping hw / cluster rows of
    its operands in ``smem_bytes`` of shared memory; or NHWC_SPLIT: a sums
    pass over ``splits`` chunks of ``chunk`` rows a sample, the combine pass
    and an apply pass."""
    path: int
    pack: int
    v: int
    cluster: int
    smem_bytes: int
    splits: int
    chunk: int


def _nhwc_pack(c: int, dtype: torch.dtype, aligned: bool) -> int:
    per = 16 // (torch.finfo(dtype).bits // 8)
    return per if aligned and c % per == 0 else 1


def _nhwc_widths(c: int, pack: int):
    """The tile widths (vectors a row) that cover c channels in whole
    tiles of at most _NHWC_MAX_TILE channels, widest first."""
    return [v for v in (32, 16, 8, 4, 2, 1)
            if v * pack <= _NHWC_MAX_TILE and (c // pack) % v == 0]


@functools.lru_cache(maxsize=None)
def in_relu_nhwc_plan(n: int, c: int, hw: int, dtype: torch.dtype,
                      aligned: bool = True, arrays: int = 1,
                      grad: bool = False) -> NhwcPlan:
    """The NHWC plan for n samples of hw rows of c channels of ``dtype``;
    ``aligned``: every operand starts on 16 bytes; ``arrays``: the operands
    a staged CTA keeps (B2: x forward, g and x backward; B3 adds s and y);
    ``grad``: a backward's plan.

    pack: 16 bytes of channels where c allows, else one.  staged when a
    (sample, tile) fits a cluster of 1, 2, 4 or 8 CTAs of at most 128 KiB
    each: tiles of 64-byte rows where c allows (32 bf16 channels; else the
    widest below, not under 32 bytes), on the fewest CTAs; split otherwise
    (G-Net's 256^2 level, and B2's backward and B3 at 128^2, whose second
    read mostly finds the L2).  The limits are where chip_smoke.py phase 7c
    measures the plans fastest at G-Net's shapes (PERF.md §6)."""
    esize = torch.finfo(dtype).bits // 8
    pack = _nhwc_pack(c, dtype, aligned)
    widths = _nhwc_widths(c, pack)
    least = min(_NHWC_MIN_ROW, widths[0] * pack * esize)
    rows = [v for v in widths
            if least <= v * pack * esize <= _NHWC_ROW][:1] or widths[-1:]
    for v in rows:
        for cs in (1, 2, 4, 8):
            smem = hw // cs * v * pack * esize * arrays
            if (hw % cs == 0 and smem <= _NHWC_STAGE_MAX
                    and n * (c // (v * pack)) * cs < 2 ** 31):
                return NhwcPlan(NHWC_STAGED, pack, v, cs, smem, 1, hw)
    return in_relu_nhwc_split_plan(n, c, hw, dtype, aligned, grad)


def in_relu_nhwc_split_plan(n: int, c: int, hw: int, dtype: torch.dtype,
                            aligned: bool = True,
                            grad: bool = False) -> NhwcPlan:
    """The split plan: the widest tile (whole 128-byte rows where c allows)
    and chunks of _NHWC_ROWS_PER_THREAD rows a thread; a backward's
    (``grad``) in bf16 at 4 channels a thread, whose constants then fit the
    registers (10–16 % faster at G-Net's 256² and 128² levels than 8,
    chip_smoke.py phase 7c)."""
    pack = _nhwc_pack(c, dtype, aligned)
    if pack == 8 and grad:
        pack = 4
    v = _nhwc_widths(c, pack)[0]
    chunk = FWD_THREADS // v * _NHWC_ROWS_PER_THREAD
    return NhwcPlan(NHWC_SPLIT, pack, v, 1, 0, -(-hw // chunk), chunk)


def _nhwc_scratch(plan: NhwcPlan, n: int, c: int, dev, fwd: bool):
    """The split plan's scratch: per-chunk partials [n·c, splits, 2] and,
    forward, the combined sums [n·c, 2] (float32); None on a staged plan."""
    if plan.path != NHWC_SPLIT:
        return None, None
    part = torch.empty((n * c, plan.splits, 2), dtype=torch.float32,
                       device=dev)
    tot = (torch.empty((n * c, 2), dtype=torch.float32, device=dev)
           if fwd else None)
    return part, tot


def _nhwc_rows(t: torch.Tensor):
    """(row, sample) strides in elements of t [N, C, *S] where its channels
    lie innermost and its spatial positions evenly apart (a channel slice of
    a channels-last tensor), else None."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        return None
    row = t.stride(-1) if t.shape[-1] > 1 else t.shape[1]
    step = row
    for d in range(t.ndim - 1, 1, -1):
        if t.shape[d] > 1 and t.stride(d) != step:
            return None
        step *= t.shape[d]
    return (row, t.stride(0)) if row >= t.shape[1] else None


def _check_nhwc(name, t):
    if not is_nhwc(t):
        raise ValueError(f"{name}: expected a channels-last [N, C, *S] "
                         f"tensor, got strides {t.stride()}")


def in_relu_fwd_nhwc_plain(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, eps: float = IN_EPS,
                           exact: bool = False):
    """Plain version of B2-fwd's NHWC plans: y as in_relu_fwd_plain gives
    it, and the planes' mean and rstd [N, C] (no x̂: the backward takes it
    from x again, _xhat)."""
    mean, rstd = _plane_stats(x, eps, exact)
    z = _xhat(x, mean, rstd) * _plane_view(x, _acc(weight)) \
        + _plane_view(x, _acc(bias))
    return torch.clamp_min(z, 0.0).to(x.dtype), mean, rstd


def in_relu_fwd_nhwc(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = IN_EPS, plan=None):
    """Kernel B2-fwd's NHWC plans: (y, mean, rstd) for a channels-last x
    (NHWC) under ``plan`` (by default in_relu_nhwc_plan's); y
    channels-last, the planes' mean and rstd [N, C] float32.  No x̂: the
    backward (in_relu_bwd_nhwc) takes it from x again.  On the CPU: the
    plain version."""
    if x.device.type == "cpu":
        return in_relu_fwd_nhwc_plain(x, weight, bias, eps)
    _check_in_relu("in_relu_fwd_nhwc", x, (), weight, bias)
    _check_nhwc("in_relu_fwd_nhwc", x)
    n, c, hw = _planes(x)
    y = torch.empty_like(x, memory_format=_format(x))
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if plan is None:
        plan = in_relu_nhwc_plan(n, c, hw, x.dtype, _aligned(x, y))
    part, tot = _nhwc_scratch(plan, n, c, x.device, True)
    _launch("in_relu_nhwc_fwd", x, x.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            _ptr(part), _ptr(tot), n, c, hw, float(eps), _DTYPES[x.dtype],
            *plan)
    in_relu_fwd_nhwc.launches += 1
    return y, mean, rstd


def in_relu_bwd_nhwc(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor,
                     rstd: torch.Tensor, plan=None):
    """B2's backward on the NHWC plans: (dx, s1, s2) as B2f gives them, from
    channels-last g and the forward's x, mean and rstd (x̂ taken from x
    again, in float32), under ``plan`` (by default
    in_relu_nhwc_plan's, g and x a staged CTA's operands).  On the CPU:
    the plain version."""
    if g.device.type == "cpu":
        return in_relu_bwd_plain(g, _xhat(x, mean, rstd), weight, bias, rstd)
    _check_in_relu("in_relu_bwd_nhwc", g, (x,), weight, bias)
    _check_nhwc("in_relu_bwd_nhwc", g)
    _check_plane_stats("in_relu_bwd_nhwc", g, (("mean", mean),
                                               ("rstd", rstd)))
    n, c, hw = _planes(g)
    dx = torch.empty_like(g, memory_format=_format(g))
    s1 = torch.empty((n, c), dtype=torch.float32, device=g.device)
    s2 = torch.empty_like(s1)
    if plan is None:
        plan = in_relu_nhwc_plan(n, c, hw, g.dtype, _aligned(g, x, dx), 2,
                                 True)
    part, _ = _nhwc_scratch(plan, n, c, g.device, False)
    _launch("in_relu_nhwc_bwd", g, g.data_ptr(), x.data_ptr(),
            mean.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            _ptr(part), n, c, hw, _DTYPES[g.dtype], *plan)
    in_relu_bwd_nhwc.launches += 1
    return dx, s1, s2


def modnorm_relu_fwd_nhwc_plain(x: torch.Tensor, gamma=None, s=None,
                                weight=None, bias=None, eps: float = IN_EPS,
                                train: bool = True, exact: bool = False):
    """Plain version of B3-fwd's NHWC plans: y as modnorm_relu_fwd_plain
    gives it, and the planes' mean and rstd [N, C] (empty with ``train``
    False)."""
    mean, rstd = _plane_stats(x, eps, exact)
    y = _modnorm_y(x, _xhat(x, mean, rstd), gamma, s, weight, bias)
    if not train:
        return y, mean.new_empty(0), rstd.new_empty(0)
    return y, mean, rstd


def modnorm_relu_fwd_nhwc(x: torch.Tensor, gamma=None, s=None, weight=None,
                          bias=None, eps: float = IN_EPS, train: bool = True,
                          plan=None):
    """Kernel B3-fwd's NHWC plans: (y, mean, rstd) for a channels-last x,
    under ``plan`` (by default in_relu_nhwc_plan's: x, and s where given,
    a staged CTA's operands); with ``train`` False y alone (mean and rstd
    empty).  No x̂: the backward takes it from x again.  s is read in place
    where its channels lie innermost with its rows evenly apart, else
    copied channels-last.  On the CPU: the plain version."""
    if x.device.type == "cpu":
        return modnorm_relu_fwd_nhwc_plain(x, gamma, s, weight, bias, eps,
                                           train)
    _check_modnorm("modnorm_relu_fwd_nhwc", x, (), gamma, s, weight, bias)
    _check_nhwc("modnorm_relu_fwd_nhwc", x)
    n, c, hw = _planes(x)
    rows = None if s is None else _nhwc_rows(s)
    if s is not None and rows is None:
        s = s.contiguous(memory_format=_format(x))
        rows = _nhwc_rows(s)
    s_row, s_sample = rows or (0, 0)
    y = torch.empty_like(x, memory_format=_format(x))
    if train:
        mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    else:
        mean = rstd = x.new_empty(0, dtype=torch.float32)
    if plan is None:
        per = 16 // x.element_size()
        aligned = (_aligned(x, y, *([] if s is None else [s]))
                   and s_row % per == 0 and s_sample % per == 0)
        plan = in_relu_nhwc_plan(n, c, hw, x.dtype, aligned,
                                 1 if s is None else 2)
    part, tot = _nhwc_scratch(plan, n, c, x.device, True)
    _launch("modnorm_relu_nhwc_fwd", x, x.data_ptr(), _ptr(s), s_row,
            s_sample, _ptr(gamma), _ptr(weight), _ptr(bias), y.data_ptr(),
            mean.data_ptr() if train else None,
            rstd.data_ptr() if train else None, _ptr(part), _ptr(tot), n, c,
            hw, float(eps), _DTYPES[x.dtype], *plan)
    modnorm_relu_fwd_nhwc.launches += 1
    return y, mean, rstd


def modnorm_relu_bwd_nhwc(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                          mean: torch.Tensor, rstd: torch.Tensor, gamma=None,
                          weight=None, want_ds: bool = True, plan=None):
    """Kernel B3-bwd's NHWC plans: (dx, ds, a, b) as modnorm_relu_bwd gives
    them, from channels-last g and the forward's y, x, mean and rstd (x̂
    taken from x again, in float32), under ``plan``
    (by default in_relu_nhwc_plan's, g, x and y a staged CTA's operands).
    On the CPU: the plain version."""
    if g.device.type == "cpu":
        return modnorm_relu_bwd_plain(g, y, _xhat(x, mean, rstd), rstd, gamma,
                                      weight, want_ds)
    _check_modnorm("modnorm_relu_bwd_nhwc", g, (y, x), gamma, None, weight,
                   None)
    _check_nhwc("modnorm_relu_bwd_nhwc", g)
    _check_plane_stats("modnorm_relu_bwd_nhwc", g, (("mean", mean),
                                                    ("rstd", rstd)))
    n, c, hw = _planes(g)
    dx = torch.empty_like(g, memory_format=_format(g))
    ds = torch.empty_like(dx) if want_ds else None
    a = torch.empty((n, c), dtype=torch.float32, device=g.device)
    b = torch.empty_like(a)
    if plan is None:
        plan = in_relu_nhwc_plan(n, c, hw, g.dtype,
                                 _aligned(g, y, x, dx, *([ds] if want_ds
                                                        else [])), 3, True)
    part, _ = _nhwc_scratch(plan, n, c, g.device, False)
    _launch("modnorm_relu_nhwc_bwd", g, g.data_ptr(), y.data_ptr(),
            x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), _ptr(gamma),
            _ptr(weight), dx.data_ptr(), _ptr(ds), a.data_ptr(), b.data_ptr(),
            _ptr(part), n, c, hw, _DTYPES[g.dtype], *plan)
    modnorm_relu_bwd_nhwc.launches += 1
    return dx, ds, a, b


in_relu_fwd_nhwc.launches = 0
in_relu_bwd_nhwc.launches = 0
modnorm_relu_fwd_nhwc.launches = 0
modnorm_relu_bwd_nhwc.launches = 0


# B2-fwd and B3-fwd on the NHWC plans are operators of their own,
# boxseg::in_relu_nhwc_fwd and boxseg::modnorm_relu_nhwc_fwd, for the reason
# boxseg::in_relu_fwd is one (an exported GUNet keeps each as a node); each
# returns (y channels-last, the planes' mean, rstd), whatever layout an
# exported graph hands it: the card's implementations lay x out
# channels-last first
_LIB.define("in_relu_nhwc_fwd(Tensor x, Tensor weight, Tensor bias, "
            "float eps) -> (Tensor, Tensor, Tensor)")
_LIB.define("modnorm_relu_nhwc_fwd(Tensor x, Tensor? gamma, Tensor? s, "
            "Tensor? weight, Tensor? bias, float eps, bool train) "
            "-> (Tensor, Tensor, Tensor)")


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _nhwc_outputs_like(x, train=True):
    """Empty outputs of the NHWC operators for x: y channels-last, then the
    planes' mean and rstd [N, C] float32 (both empty under no-grad)."""
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = x.new_empty(x.shape[:2] if train else (0,), dtype=torch.float32)
    return y, stats, torch.empty_like(stats)


def _in_relu_nhwc_fwd_cpu(x, weight, bias, eps):
    # exact plane statistics, as _in_relu_fwd_cpu's
    return in_relu_fwd_nhwc_plain(_cl(x), weight, bias, eps, exact=True)


def _in_relu_nhwc_fwd_cuda(x, weight, bias, eps):
    return in_relu_fwd_nhwc(_cl(x), weight, bias, eps)


def _modnorm_relu_nhwc_fwd_cpu(x, gamma, s, weight, bias, eps, train):
    return modnorm_relu_fwd_nhwc_plain(_cl(x), gamma, s, weight, bias, eps,
                                       train, exact=True)


def _modnorm_relu_nhwc_fwd_cuda(x, gamma, s, weight, bias, eps, train):
    return modnorm_relu_fwd_nhwc(_cl(x), gamma, s, weight, bias, eps, train)


_LIB.impl("in_relu_nhwc_fwd", _in_relu_nhwc_fwd_cpu, "CPU")
_LIB.impl("in_relu_nhwc_fwd", _in_relu_nhwc_fwd_cuda, "CUDA")
_LIB.impl("modnorm_relu_nhwc_fwd", _modnorm_relu_nhwc_fwd_cpu, "CPU")
_LIB.impl("modnorm_relu_nhwc_fwd", _modnorm_relu_nhwc_fwd_cuda, "CUDA")


@torch.library.register_fake("boxseg::in_relu_nhwc_fwd", lib=_LIB)
def _in_relu_nhwc_fwd_fake(x, weight, bias, eps):
    return _nhwc_outputs_like(x)


@torch.library.register_fake("boxseg::modnorm_relu_nhwc_fwd", lib=_LIB)
def _modnorm_relu_nhwc_fwd_fake(x, gamma, s, weight, bias, eps, train):
    return _nhwc_outputs_like(x, train)


def in_relu_fwd_nhwc_op(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float = IN_EPS):
    """B2-fwd on the NHWC plans through ``torch.ops.boxseg.in_relu_nhwc_fwd``:
    (y, mean, rstd) for a channels-last x, as in_relu_fwd_nhwc gives them
    (on the CPU the plain version, with exact statistics)."""
    return torch.ops.boxseg.in_relu_nhwc_fwd.default(x, weight, bias,
                                                     float(eps))


def modnorm_relu_fwd_nhwc_op(x: torch.Tensor, gamma=None, s=None,
                             weight=None, bias=None, eps: float = IN_EPS,
                             train: bool = True):
    """B3-fwd on the NHWC plans through
    ``torch.ops.boxseg.modnorm_relu_nhwc_fwd``: (y, mean, rstd) for a
    channels-last x, as modnorm_relu_fwd_nhwc gives them (on the CPU the
    plain version, with exact statistics)."""
    return torch.ops.boxseg.modnorm_relu_nhwc_fwd.default(
        x, gamma, s, weight, bias, float(eps), bool(train))


def channel_sums_nhwc(t: torch.Tensor) -> torch.Tensor:
    """Σ over every axis but the channels of t [N, C, *S], [C] float32:
    the gradient of a conv's bias, where t is the gradient of the conv's
    output.  For a channels-last CUDA t the NHWC split plan's sums pass
    over all N·prod(S) rows (a kernel of its own, channel_sums_nhwc_kernel:
    PyTorch's reduction reads a channels-last tensor at a fraction of the
    card's bandwidth); otherwise, and on the CPU, its plain version,
    PyTorch's float32 sum.  Counts its launches apart from KERNELS: it is
    neither B2 nor B3."""
    if t.device.type != "cuda" or not is_nhwc(t) or t.dtype not in _DTYPES:
        return t.sum(dim=(0,) + tuple(range(2, t.ndim)), dtype=torch.float32)
    n, c, hw = _planes(t)
    rows = n * hw
    if rows >= 2 ** 31:
        raise ValueError(f"channel_sums_nhwc: {tuple(t.shape)} exceeds the "
                         "kernel's limits")
    plan = in_relu_nhwc_split_plan(1, c, rows, t.dtype, _aligned(t))
    part = torch.empty((c, plan.splits, 2), dtype=torch.float32,
                       device=t.device)
    out = torch.empty((c, 2), dtype=torch.float32, device=t.device)
    _launch("channel_sums_nhwc", t, t.data_ptr(), part.data_ptr(),
            out.data_ptr(), c, rows, _DTYPES[t.dtype], plan.pack, plan.v,
            plan.splits, plan.chunk)
    channel_sums_nhwc.launches += 1
    return out[:, 0]


channel_sums_nhwc.launches = 0


# name -> wrapper, for launch-count bookkeeping (the NHWC plans count apart
# from the NCHW ones)
KERNELS = {"gaussian_guide_batch": gaussian_guide_batch,
           "in_relu_fwd": in_relu_fwd,
           "in_relu_bwd": in_relu_bwd,
           "in_relu_bwd_stats": in_relu_bwd_stats,
           "in_relu_bwd_apply": in_relu_bwd_apply,
           "geodesic2d_batch": geodesic2d_batch,
           "in_relu_fwd_partial": in_relu_fwd_partial,
           "in_relu_fwd_apply": in_relu_fwd_apply,
           "modnorm_relu_fwd": modnorm_relu_fwd,
           "modnorm_relu_bwd": modnorm_relu_bwd,
           "in_relu_fwd_nhwc": in_relu_fwd_nhwc,
           "in_relu_bwd_nhwc": in_relu_bwd_nhwc,
           "modnorm_relu_fwd_nhwc": modnorm_relu_fwd_nhwc,
           "modnorm_relu_bwd_nhwc": modnorm_relu_bwd_nhwc}


def reset_launch_counts():
    for fn in list(KERNELS.values()) + [channel_sums_nhwc]:
        fn.launches = 0
