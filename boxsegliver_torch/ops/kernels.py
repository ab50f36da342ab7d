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
  forward of pallas_kernels.fused_instance_norm_relu), ``in_relu_bwd_stats``
  (B2a, replaces _bwd_stats_kernel) and ``in_relu_bwd_apply`` (B2b, replaces
  _bwd_apply_kernel), tied together by ``InstanceNormReLU``.  Bandwidth
  bounds them (source note).  The forward takes one of three paths (warp,
  staged on a thread-block cluster, general), chosen from the shape by
  ``in_relu_fwd_plan``.  The nearest PyTorch yardstick is two calls,
  ``F.relu(F.instance_norm(...))``.  B2-fwd is the registered operator
  ``torch.ops.boxseg.in_relu_fwd`` (torch.library: CPU implementation the
  plain version; CUDA the kernel, which counts its launches; a fake
  implementation for tracing), so torch.export keeps it as one node of an
  exported model and a loaded program launches the kernel on the card.
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
            "in_relu_bwd_stats": "in_relu", "in_relu_bwd_apply": "in_relu",
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


def in_relu_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float = IN_EPS):
    """Plain PyTorch version of B2-fwd, operation for operation: f32
    statistics over each (n, c) plane of x [N, C, *S] (variance E[x²] −
    E[x]² clipped at 0, flax's), rstd = rsqrt(var + eps), x̂ = (x − mean)·
    rstd, y = relu(x̂·γ + β).  Returns y and x̂ in x's dtype and rstd
    [N, C] f32 (float64 throughout for a float64 x, which only the CPU
    takes: torch.autograd.gradcheck)."""
    xf = _acc(x)
    dims = tuple(range(2, x.ndim))
    inv_hw = 1.0 / math.prod(x.shape[2:])
    mean = xf.sum(dim=dims, keepdim=True) * inv_hw
    var = torch.clamp_min((xf * xf).sum(dim=dims, keepdim=True) * inv_hw
                          - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    z = xhat * _plane_view(x, _acc(weight)) + _plane_view(x, _acc(bias))
    return (torch.clamp_min(z, 0.0).to(x.dtype), xhat.to(x.dtype),
            rstd.reshape(x.shape[:2]))


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


def in_relu_bwd_plain(g, xhat, rstd, weight, bias):
    """The whole backward in plain PyTorch: gz, s1, s2, dx, then
    dγ = Σ_n s2 and dβ = Σ_n s1 (pallas_kernels.py:134-135)."""
    s1, s2 = in_relu_bwd_stats_plain(g, xhat, weight, bias)
    dx = in_relu_bwd_apply_plain(g, xhat, weight, bias, rstd, s1, s2)
    return dx, s2.sum(dim=0), s1.sum(dim=0)


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
        if not t.is_contiguous():
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
            packs = 1
            while packs * 32 < groups:
                packs *= 2
            per_cta = FWD_THREADS // 32
            return FwdPlan(FWD_WARP, -(-planes // per_cta), per_cta, packs,
                           1, 0)
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


_LIB.impl("in_relu_fwd", in_relu_fwd_plain, "CPU")
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
    float32.  y and x̂ come back in x's dtype, rstd as [N, C] float32."""
    # the wrapper keeps the kernel's contract; the operator also takes the
    # channels-last x an exported graph may hand it
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("in_relu_fwd: operands must be contiguous")
    return torch.ops.boxseg.in_relu_fwd.default(x, weight, bias, float(eps))


def in_relu_bwd_stats(g: torch.Tensor, xhat: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor):
    """Kernel B2a: per-(n, c) s1 = Σ gz and s2 = Σ gz·x̂ ([N, C] float32)."""
    if g.device.type == "cpu":
        return in_relu_bwd_stats_plain(g, xhat, weight, bias)
    _check_in_relu("in_relu_bwd_stats", g, (xhat,), weight, bias)
    n, c, hw = _planes(g)
    s1 = torch.empty((n, c), dtype=torch.float32, device=g.device)
    s2 = torch.empty_like(s1)
    _launch("in_relu_bwd_stats", g, g.data_ptr(), xhat.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            n * c, c, hw, _DTYPES[g.dtype])
    in_relu_bwd_stats.launches += 1
    return s1, s2


def in_relu_bwd_apply(g: torch.Tensor, xhat: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor,
                      rstd: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor):
    """Kernel B2b: dx = (γ·rstd)·((gz − s1/HW) − x̂·s2/HW) in g's dtype."""
    if g.device.type == "cpu":
        return in_relu_bwd_apply_plain(g, xhat, weight, bias, rstd, s1, s2)
    _check_in_relu("in_relu_bwd_apply", g, (xhat,), weight, bias)
    n, c, hw = _planes(g)
    for name, t in (("rstd", rstd), ("s1", s1), ("s2", s2)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n, c)
                or t.device != g.device or not t.is_contiguous()):
            raise ValueError(f"in_relu_bwd_apply: {name} must be contiguous "
                             f"[{n}, {c}] float32 on {g.device}")
    dx = torch.empty_like(g)
    _launch("in_relu_bwd_apply", g, g.data_ptr(), xhat.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), rstd.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), dx.data_ptr(), n * c, c, hw,
            _DTYPES[g.dtype])
    in_relu_bwd_apply.launches += 1
    return dx


in_relu_fwd.launches = 0
in_relu_bwd_stats.launches = 0
in_relu_bwd_apply.launches = 0


class InstanceNormReLU(torch.autograd.Function):
    """relu(instance_norm(x)·γ + β) over [N, C, *S] planes with eps 1e-6
    (NCHW for the 2-D models, NCDHW for UNet3D): B2-fwd in
    ``forward``; B2a, B2b, then dγ = Σ_n s2 and dβ = Σ_n s1 in ``backward``.
    Saves x̂ in x's dtype and rstd in float32, and casts the incoming
    gradient to x̂'s dtype, as the JAX custom VJP does
    (pallas_kernels.py:138-160)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        pdt = torch.float64 if x.dtype == torch.float64 else torch.float32
        weight32 = weight.to(pdt).contiguous()
        bias32 = bias.to(pdt).contiguous()
        y, xhat, rstd = in_relu_fwd(x.contiguous(), weight32, bias32)
        ctx.save_for_backward(xhat, rstd, weight32, bias32)
        ctx.param_dtypes = (weight.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        xhat, rstd, weight, bias = ctx.saved_tensors
        g = g.to(xhat.dtype).contiguous()
        s1, s2 = in_relu_bwd_stats(g, xhat, weight, bias)
        dx = in_relu_bwd_apply(g, xhat, weight, bias, rstd, s1, s2)
        wdt, bdt = ctx.param_dtypes
        return dx, s2.sum(dim=0).to(wdt), s1.sum(dim=0).to(bdt)


def instance_norm_relu(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """relu(instance_norm(x)·γ + β) through kernel B2 ([N, C, *S], eps
    1e-6)."""
    return InstanceNormReLU.apply(x, weight, bias)


# name -> wrapper, for launch-count bookkeeping
KERNELS = {"gaussian_guide_batch": gaussian_guide_batch,
           "in_relu_fwd": in_relu_fwd,
           "in_relu_bwd_stats": in_relu_bwd_stats,
           "in_relu_bwd_apply": in_relu_bwd_apply,
           "geodesic2d_batch": geodesic2d_batch}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
