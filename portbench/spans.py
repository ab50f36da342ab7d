"""The program's own spans (``boxseg.*``: boxsegliver_torch/utils/trace.py)
and input counters in a traced run of a cell, on the device trace's clock.

    python3 -m portbench.spans --workload gnet_sp.eval_g --seed 7

runs the cell as ``python3 -m portbench.run --trace 1`` does (a fixed
number of dispatches or cases under the profiler; the cell's per-layer
metrics and ``correct`` as that run gives them) and prints one JSON line
that adds, from the same trace:

- ``e2e``: the cell's rate over the traced window (the profiler on);
- ``spans``: for each ``boxseg.*`` name on the profiling thread its
  ``count``, ``total_s``, ``self_s`` (the durations less those of the
  same-thread spans directly inside, the program's and the benchmark's)
  and ``idle_s`` (the device-idle time inside its intervals), all clipped
  to the window;
- ``span_gaps``: the window's device-idle time by the innermost span at
  each gap's middle (a ``boxseg.`` span under its full name, a benchmark
  span without its ``portbench.`` prefix, ``window`` outside both);
- ``input_gets`` and ``input_starved``: the train dataset's counters over
  the traced window (training cells);
- ``readings``: the per-layer numbers those give (``READINGS``).

The benchmark's result line does not carry these: its trace reduction
(``portbench/trace.py``) and training driver would have to call
``reduce`` and take the counters.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import importlib
import itertools
import json
import sys
import tempfile
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

from portbench import run, trace

PROGRAM = "boxseg."
BENCH = "portbench."


def reduce(prof, window_span: str = "portbench.window") -> Dict:
    """{"spans": {name: {"count", "total_s", "self_s", "idle_s"}},
    "span_gaps": [[label, seconds]]} of the profiled window; raises
    RuntimeError without the window's span."""
    from torch.autograd import DeviceType

    cpu, dev = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.name, tr.start, tr.end, e.thread))
    host_names = {c[0] for c in cpu}
    win = [c for c in cpu if c[0] == window_span]
    if not win:
        raise RuntimeError(f"no {window_span} span in the trace")
    _, w0, w1, thread = win[0]
    busy = trace._merge([(max(s, w0), min(t, w1)) for n, s, t in dev
                         if n not in host_names and t > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    i_start = [a for a, _ in idle]
    i_end = [b for _, b in idle]
    i_cum = [0.0] + list(itertools.accumulate(b - a for a, b in idle))

    def idle_in(s, t):
        i, j = bisect.bisect_right(i_end, s), bisect.bisect_left(i_start, t)
        if i >= j:
            return 0.0
        return (i_cum[j] - i_cum[i] - max(0.0, s - idle[i][0])
                - max(0.0, idle[j - 1][1] - t))

    # the profiling thread's spans, outer before inner; spans of one thread
    # nest, so each one's parent is the innermost open one where it starts
    spans = sorted(((max(s, w0), min(t, w1), n) for n, s, t, th in cpu
                    if th == thread and n.startswith((PROGRAM, BENCH))
                    and t > w0 and s < w1), key=lambda x: (x[0], -x[1]))
    parent, open_, inner = [], [], [0.0] * len(spans)
    for i, (s, t, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] <= s:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        if open_:
            inner[open_[-1]] += t - s
        open_.append(i)

    out: Dict[str, Dict[str, float]] = {}
    for i, (s, t, n) in enumerate(spans):
        if not n.startswith(PROGRAM):
            continue
        d = out.setdefault(n, {"count": 0, "total_s": 0.0, "self_s": 0.0,
                               "idle_s": 0.0})
        d["count"] += 1
        d["total_s"] += (t - s) * 1e-6
        d["self_s"] += (t - s - inner[i]) * 1e-6
        d["idle_s"] += idle_in(s, t) * 1e-6

    starts = [s for s, _, _ in spans]
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in idle:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        while k >= 0 and spans[k][1] < mid:
            k = parent[k]
        name = spans[k][2] if k >= 0 else window_span
        label = "window" if name == window_span else name.removeprefix(BENCH)
        gaps[label] += (b - a) * 1e-6
    return {"spans": out,
            "span_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])}


def _per_unit_ms(name, key="self_s"):
    def read(rec):
        d = rec["spans"].get(name)
        return None if d is None else 1e3 * d[key] / rec["units"]
    return read


def _trainer_idle_ms(rec):
    """Device-idle milliseconds a step whose innermost span is one of the
    trainer's."""
    ms = [v for k, v in rec["span_gaps"] if k.startswith("boxseg.train.")]
    return 1e3 * sum(ms) / rec["units"] if ms else None


def _input_starved_share(rec):
    gets = rec.get("input_gets")
    return 100.0 * rec["input_starved"] / gets if gets else None


def _sweep_host_ms_per_step(rec):
    d = rec["spans"].get("boxseg.sweep.step")
    return None if d is None else 1e3 * d["total_s"] / d["count"]


def _sweep_idle_share(rec):
    d = rec["spans"].get("boxseg.sweep.case")
    return None if d is None else 100.0 * d["idle_s"] / d["total_s"]


# per-layer readings of the spans and counters; None where the trace holds
# nothing to read (a program without the spans, or a cell without them)
READINGS = {
    "stage_ms_per_step": _per_unit_ms("boxseg.train.stage"),
    "trainer_idle_ms_per_step": _trainer_idle_ms,
    "input_starved_share": _input_starved_share,
    "parse_ms_per_case": _per_unit_ms("boxseg.eval.parse"),
    "postprocess_ms_per_case": _per_unit_ms("boxseg.eval.postprocess"),
    "score_ms_per_case": _per_unit_ms("boxseg.eval.score"),
    "sweep_host_ms_per_step": _sweep_host_ms_per_step,
    "sweep_idle_share": _sweep_idle_share,
}


def readings(rec) -> Dict[str, float]:
    out = {k: fn(rec) for k, fn in READINGS.items()}
    return {k: v for k, v in out.items() if v is not None}


def _input_counts() -> Optional[tuple]:
    """(gets, starved) summed over the live train datasets (the training
    driver keeps its own to itself), or None without one."""
    from boxsegliver_torch.data.pipeline import TrainDataset

    # some of the process's objects warn of their deprecation when looked at
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        found = [o for o in gc.get_objects() if isinstance(o, TrainDataset)]
    if not found:
        return None
    return (sum(getattr(d, "gets", 0) for d in found),
            sum(getattr(d, "starved", 0) for d in found))


class SpanContext(run.Context):
    """The harness's context, whose traced window also yields the spans and
    the input counters."""

    counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def profiler(self):
        before = _input_counts()
        with super().profiler() as prof:
            yield prof
        after = _input_counts()
        if before is not None and after is not None:
            self.counts = {"input_gets": after[0] - before[0],
                           "input_starved": after[1] - before[1]}

    def reduce(self, prof):
        rec = super().reduce(prof)
        rec.update(reduce(prof), **self.counts)
        return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    a = p.parse_args(argv)
    run.set_cache_dirs()
    spec = run.resolve(run.load_bench(), a.workload)
    import torch

    if not torch.cuda.is_available():
        raise run.Refused(f"{a.workload} needs a CUDA device")
    device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = SpanContext(spec, a.seed, 0.0, True, device, Path(tmp))
        out = driver.measure(ctx)
    rec = out["records"]
    _, ok = run.judge(out["compared"], spec["limits"])
    metrics = {m["name"]: run.reader(m["name"])(rec)
               for m in spec["per_layer"]}
    result = {"correct": bool(ok and out["failed"] == 0),
              "device": torch.cuda.get_device_name(0),
              "e2e": out["e2e"], "units": rec["units"],
              "busy_s": rec["busy_s"], "window_s": rec["window_s"],
              "metrics": metrics, "readings": readings(rec),
              **{k: rec[k] for k in ("input_gets", "input_starved")
                 if k in rec},
              "spans": rec["spans"], "span_gaps": rec["span_gaps"],
              "breakdown": rec["breakdown"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except run.Refused as e:
        print(f"portbench.spans: {e}", file=sys.stderr)
        sys.exit(2)
