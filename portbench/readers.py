"""The bodies of the per-layer readers.  Each metric has its own file,
``portbench/metrics/<name>.py``, which takes one of these as its ``read``;
a cell's driver writes the records they read: the trace's reduction
(portbench.trace) and, per unit of work (a train step or an eval case),
``units``, ``b2_min_s_per_unit`` and ``flops_per_unit``, with
``traced_s`` the traced window on the host's clock.  A reader that finds
nothing to read returns None."""

from __future__ import annotations

from portbench.flops import BF16_PEAK_FLOPS
from portbench.trace import class_seconds


def idle_share(rec):
    """Share of the traced window in which no device activity ran:
    1 − (union of the kernel, copy and set intervals) / window."""
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def b2_roofline(rec):
    """Kernel B2's share of its roofline: the least time of the unit's
    instance-norm + ReLU planes at the HBM rate (portbench.flops) over
    the device time of every ``in_relu*`` kernel; nothing where none
    ran."""
    t = class_seconds(rec, "b2")
    if t <= 0:
        return None
    return 100.0 * rec["b2_min_s_per_unit"] * rec["units"] / t


def mfu(rec):
    """The work's share of the card's dense bf16 peak: the configuration's
    analytic FLOPs a unit (portbench.flops) times the units of the traced
    window, over its seconds, over 989 TFLOP/s."""
    rate = rec["flops_per_unit"] * rec["units"] / rec["traced_s"]
    return 100.0 * rate / BF16_PEAK_FLOPS


def ms_per_unit(*classes):
    """Device milliseconds a unit spends in the kernels of ``classes``
    (portbench.trace.kernel_class)."""
    def read(rec):
        return 1e3 * sum(class_seconds(rec, c) for c in classes) \
            / rec["units"]
    return read


def host_launches(rec):
    """Host calls that enqueue device work (kernel, graph, copy and set
    launches), per unit of the traced window."""
    return rec["host_launches"] / rec["units"]


def input_wait_ms(rec):
    """Host milliseconds a unit waited for its raw batch (the benchmark's
    timer around ``next(data)``)."""
    return 1e3 * rec["input_wait_s"] / rec["units"]


def evaluator_ms(rec):
    """Host milliseconds of a whole case outside the predictor: the
    case's wall minus the predictor's, whose calls end with their host
    result."""
    return 1e3 * (rec["case_s"] - rec["predict_s"]) / rec["units"]


def predict_ms_per_slice(rec):
    """Milliseconds of the predictor (its upload, device work and
    download) per volume slice."""
    return 1e3 * rec["predict_s"] / rec["slices"]
