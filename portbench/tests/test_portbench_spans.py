"""The spans' reduction (portbench.spans): self time less the same-thread
spans directly inside, of either kind, with another thread's spans left
out; device-idle time inside each span, clipped to the window; idle gaps
named by the innermost span of either kind; the readings, and none from a
trace without the program's spans or counters."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spans, trace

CPU, GPU = DeviceType.CPU, DeviceType.CUDA
MAIN, WORKER = 1, 2
US = 1e-6


class FakeProf:
    def __init__(self, events):
        self._events = [SimpleNamespace(
            name=n, device_type=d, thread=th,
            time_range=SimpleNamespace(start=s, end=e))
            for n, d, th, s, e in events]

    def events(self):
        return self._events


def _prof():
    """Device busy [120, 280], [450, 550], [690, 720], [950, 1000]; idle
    [0, 120], [280, 450], [550, 690], [720, 950]."""
    return FakeProf([
        ("boxseg.early", CPU, MAIN, -50, 5),           # cut at the window
        ("portbench.window", CPU, MAIN, 0, 1000),
        ("portbench.case", CPU, MAIN, 0, 900),
        ("boxseg.eval.case", CPU, MAIN, 10, 890),
        ("boxseg.sweep.step", CPU, MAIN, 100, 300),
        ("boxseg.sweep.guide", CPU, MAIN, 100, 150),
        ("aten::add", CPU, MAIN, 110, 120),            # an op, not a span
        ("boxseg.sweep.forward", CPU, MAIN, 150, 300),
        ("portbench.predict", CPU, MAIN, 400, 700),
        ("boxseg.sweep.step", CPU, MAIN, 420, 600),
        ("boxseg.eval.score", CPU, MAIN, 760, 880),
        ("boxseg.worker", CPU, WORKER, 0, 1000),       # another thread
        ("portbench.window", GPU, MAIN, 0, 1000),      # a span's annotation
        ("kernel_a", GPU, MAIN, 120, 280),
        ("kernel_b", GPU, MAIN, 450, 550),
        ("kernel_c", GPU, MAIN, 690, 720),
        ("late_kernel", GPU, MAIN, 950, 1100),
    ])


def test_counts_self_and_idle_time():
    s = spans.reduce(_prof())["spans"]
    assert set(s) == {"boxseg.early", "boxseg.eval.case",
                      "boxseg.sweep.step", "boxseg.sweep.guide",
                      "boxseg.sweep.forward", "boxseg.eval.score"}
    step, case = s["boxseg.sweep.step"], s["boxseg.eval.case"]
    assert step["count"] == 2 and case["count"] == 1
    assert step["total_s"] == pytest.approx((200 + 180) * US)
    # the first step is all guide and forward; the second has no child
    assert step["self_s"] == pytest.approx(180 * US)
    # less the spans directly inside: the first step, the benchmark's
    # predict (not the step inside it) and the score
    assert case["self_s"] == pytest.approx((880 - 200 - 300 - 120) * US)
    assert s["boxseg.early"]["total_s"] == pytest.approx(5 * US)
    assert s["boxseg.sweep.guide"]["idle_s"] == pytest.approx(20 * US)
    assert s["boxseg.sweep.forward"]["idle_s"] == pytest.approx(20 * US)
    assert step["idle_s"] == pytest.approx((20 + 20 + 30 + 50) * US)
    assert case["idle_s"] == pytest.approx((110 + 170 + 140 + 170) * US)
    assert s["boxseg.eval.score"]["idle_s"] == pytest.approx(120 * US)
    assert s["boxseg.early"]["idle_s"] == pytest.approx(5 * US)


def test_gaps_are_named_by_the_innermost_span():
    gaps = dict(spans.reduce(_prof())["span_gaps"])
    assert gaps == pytest.approx({"boxseg.eval.case": (120 + 170) * US,
                                  "predict": 140 * US,
                                  "boxseg.eval.score": 230 * US})


def test_the_benchmarks_reduction_reads_the_same_events():
    rec = trace.reduce(_prof())
    assert rec["window_s"] == pytest.approx(1000 * US)
    assert rec["busy_s"] == pytest.approx((160 + 100 + 30 + 50) * US)


def test_readings():
    rec = spans.reduce(_prof())
    rec.update(units=2, input_gets=8, input_starved=2)
    assert spans.readings(rec) == pytest.approx({
        "score_ms_per_case": 1e3 * 120 * US / 2,
        "sweep_host_ms_per_step": 1e3 * 190 * US,
        "input_starved_share": 25.0})


def test_no_readings_without_the_programs_spans_or_counters():
    bare = FakeProf([("portbench.window", CPU, MAIN, 0, 100),
                     ("portbench.dispatch", CPU, MAIN, 0, 90),
                     ("kernel", GPU, MAIN, 10, 20),
                     ("kernel", GPU, MAIN, 85, 90)])
    rec = spans.reduce(bare)
    assert rec["spans"] == {}
    assert rec["span_gaps"] == [["dispatch", pytest.approx(75 * US)],
                                ["window", pytest.approx(10 * US)]]
    rec.update(units=1)
    for name, read in spans.READINGS.items():
        assert read(rec) is None, name
    assert spans.readings(rec) == {}


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        spans.reduce(FakeProf([("boxseg.x", CPU, MAIN, 0, 10)]))
