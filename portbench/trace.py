"""Reduction of a ``torch.profiler`` trace of the measured window to the
records the per-layer readers take: every device activity (kernels,
copies, sets) as an interval on the host's clock, the window's bounds
from the benchmark's own ``portbench.window`` span, the host's launch
calls, the device's busy time as the union of the intervals (so kernels
that overlap on two streams count once), and the breakdown: the device
operations that took most time and the idle gaps, each named by the
benchmark span and the deepest host operation running at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

# host calls that enqueue work on the device
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")
CONV_TOKENS = ("xmma", "cutlass", "convolve", "gemm", "conv2d", "dgrad",
               "wgrad", "cudnn", "sm90_", "implicit_")


def kernel_class(name: str) -> str:
    """The group of a device operation by its name: the hand-written
    kernels (B1 guide_render, B2 in_relu*, G1 geodesic), convolutions and
    their layout transposes (cuDNN / CUTLASS / gemm), the optimizer's
    multi-tensor kernels, copies and sets, and the rest (elementwise,
    reductions, gathers)."""
    n = name.lower()
    if "in_relu" in n:
        return "b2"
    if "guide_render" in n:
        return "b1"
    if "geodesic" in n:
        return "g1"
    if any(t in n for t in CONV_TOKENS):
        return "conv"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if n.startswith("memcpy") or n.startswith("memset"):
        return "copy"
    return "elementwise"


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, window_span: str = "portbench.window") -> Dict:
    """Records of the profiled window: {"window_s", "busy_s", "kernels":
    [(name, class, seconds)], "host_launches", "breakdown"}; raises
    RuntimeError if the trace holds no device activity."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.name, tr.start, tr.end))
    # a host span (record_function) is mirrored on the device's timeline as
    # an annotation over the work it enqueued: it is no device activity
    host_names = {n for n, _, _ in cpu}
    dev = [d for d in dev if d[0] not in host_names]
    win = [(s, t) for n, s, t in cpu if n == window_span]
    if not win:
        raise RuntimeError(f"no {window_span} span in the trace")
    w0, w1 = win[0]
    dev = [(n, max(s, w0), min(t, w1)) for n, s, t in dev if t > w0 and s < w1]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _merge([(s, t) for _, s, t in dev])
    busy_us = sum(t - s for s, t in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, t in dev:
        by_name[n] += (t - s) * 1e-6
    spans = [(s, t, n) for n, s, t in cpu if n.startswith("portbench.")
             and n != window_span]
    ops = sorted((s, t, n) for n, s, t in cpu if w0 <= s <= w1)
    starts = [s for s, _, _ in ops]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        span = min((t - s, n) for s, t, n in spans + [(w0, w1, "window")]
                   if s <= mid <= t)[1]
        deepest = "idle host"
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, t, n in ops[max(0, i - 400):i]:
            # the innermost running op: the latest start, then the earliest end
            if t >= mid and (best is None or (s, -t) >= best[:2]):
                best = (s, -t, n)
        if best is not None:
            deepest = best[2]
        gaps[f"{span.removeprefix('portbench.')} / {deepest}"] += \
            (g1 - g0) * 1e-6
    launches = sum(1 for n, s, _ in cpu if w0 <= s <= w1
                   and n.startswith(HOST_LAUNCH_CALLS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernels": [(n, kernel_class(n), v) for n, v in by_name.items()],
            "host_launches": launches,
            "breakdown": {"device_ops": [[n, v] for n, v in top],
                          "idle_gaps": [[n, v] for n, v in idle]}}


def class_seconds(records: Dict, cls: str) -> float:
    return sum(v for _, c, v in records["kernels"] if c == cls)
