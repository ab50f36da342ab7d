"""The port's spans and counters on the CPU: ``utils.trace.span`` is the
shared null context with no profiler running and a recorded
``record_function`` under one; the trainer's dispatch, the guided eval's
evaluator and sweep steps and the 3-D evaluator emit their ``boxseg.*``
spans, nested as the profiler sees them; the train dataset counts its
takes and the takes that found its queue empty.  Fixtures are those of
tests/test_torch_sweep.py, tests/test_torch_multistep.py and
tests/test_torch_volume3d.py."""

import argparse
import contextlib
import json
import threading
import time
from collections import Counter

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data.meta import load_meta
from boxsegliver_torch.data.pipeline import TrainDataset
from boxsegliver_torch.evaluators import eval_loader as t_loader
from boxsegliver_torch.evaluators import volume as t_volume
from boxsegliver_torch.evaluators import volume3d as tvol3d
from boxsegliver_torch.interactive import device_sweep as t_sweep
from boxsegliver_torch.utils import trace
from test_torch_multistep import _args as train_args
from test_torch_multistep import _batches, _trainer, root  # noqa: F401
from test_torch_sweep import _args as sweep_args
from test_torch_sweep import ds, fitted  # noqa: F401
from test_torch_volume3d import _common, nf_root  # noqa: F401

STEP_PHASES = ["boxseg.sweep.guide", "boxseg.sweep.forward",
               "boxseg.sweep.label", "boxseg.sweep.match",
               "boxseg.sweep.moments"]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _spans(prof):
    """The profiled ``boxseg.*`` spans, each with its innermost enclosing
    ``boxseg.*`` span (or None), in the order they started."""
    def parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("boxseg."):
            p = p.cpu_parent
        return p

    evs = [e for e in prof.events() if e.name.startswith("boxseg.")]
    return sorted(((e, parent(e)) for e in evs),
                  key=lambda ep: ep[0].time_range.start)


def _names(spans):
    return Counter(e.name for e, _ in spans)


def _parents(spans, name):
    return {p.name if p is not None else None
            for e, p in spans if e.name == name}


def test_span_without_and_under_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    off = trace.span("boxseg.test.off")
    assert isinstance(off, contextlib.nullcontext)
    assert trace.span("boxseg.test.other") is off
    with off:
        pass

    def body():
        assert trace.span("boxseg.test.on") is not off
        with trace.span("boxseg.test.on"):
            torch.ones(2).add_(1)

    spans = _spans(_profiled(body))
    assert _names(spans) == {"boxseg.test.on": 1}


def test_train_dispatch_spans(root, tmp_path):  # noqa: F811
    """On the CPU every step of a dispatch runs eagerly: one stage, K
    steps and one values span per dispatch, nothing captured or
    replayed."""
    args = train_args(root, tmp_path, "--steps_per_dispatch", "4")
    trainer = _trainer(args)
    batches = _batches(root, args, 8)
    spans = _spans(_profiled(lambda: [trainer.train_multi_step(
        batches[i:i + 4]) for i in (0, 4)]))
    assert _names(spans) == {"boxseg.train.stage": 2,
                             "boxseg.train.step": 8,
                             "boxseg.train.values": 2}
    assert all(p is None for _, p in spans)


def _sweep_run(ds, tmp_path, t_model, **kw):  # noqa: F811
    args = sweep_args(tmp_path / "m", **kw)
    pred = t_sweep.GuidedSweepPredictor(t_model, args, num_classes=3,
                                        tumor_id=2, device="cpu")
    ev = t_volume.EvaluateVolume(args, ds, ["Liver", "Tumor"])
    meta = load_meta(ds)[0]
    prior = json.loads((ds / "prior.json").read_text())
    case = t_loader.parse_case_eval(meta, ds, im_channel=3)
    d_pad = max(t_sweep._bucket(case.depth, t_sweep._DEPTH_BUCKETS),
                case.depth)
    out = {}
    prof = _profiled(lambda: out.update(ev.run_g(pred, [meta],
                                                 prior=prior)))
    assert out and all(np.isfinite(v) for v in out.values())
    return _spans(prof), d_pad


def test_run_g_spans_nest(ds, tmp_path, fitted):  # noqa: F811
    spans, d_pad = _sweep_run(ds, tmp_path, fitted[1])
    assert _names(spans) == dict(
        {"boxseg.eval.case": 1, "boxseg.eval.parse": 1,
         "boxseg.sweep.case": 1, "boxseg.sweep.prepare": 1,
         "boxseg.sweep.step": d_pad, "boxseg.sweep.finish": 1,
         "boxseg.eval.postprocess": 1, "boxseg.eval.score": 1},
        **{n: d_pad for n in STEP_PHASES})
    assert _parents(spans, "boxseg.eval.case") == {None}
    for name in ("eval.parse", "sweep.case", "eval.postprocess",
                 "eval.score"):
        assert _parents(spans, f"boxseg.{name}") == {"boxseg.eval.case"}
    for name in ("prepare", "step", "finish"):
        assert _parents(spans, f"boxseg.sweep.{name}") == {
            "boxseg.sweep.case"}
    for step, _ in spans:
        if step.name == "boxseg.sweep.step":
            kids = [e.name for e, p in spans if p is step]
            assert kids == STEP_PHASES
    order = [e.name for e, p in spans
             if p is not None and p.name == "boxseg.eval.case"]
    assert order == ["boxseg.eval.parse", "boxseg.sweep.case",
                     "boxseg.eval.postprocess", "boxseg.eval.score"]


def test_run_g_overflow_spans_the_host_loop(ds, tmp_path,  # noqa: F811
                                            fitted):  # noqa: F811
    spans, _ = _sweep_run(ds, tmp_path, fitted[1], sweep_max_objects=1)
    names = _names(spans)
    assert names["boxseg.eval.host_loop"] == 1
    assert names["boxseg.sweep.case"] == 1
    assert names["boxseg.sweep.finish"] == 1
    assert _parents(spans, "boxseg.eval.host_loop") == {"boxseg.eval.case"}
    order = [e.name for e, p in spans
             if p is not None and p.name == "boxseg.eval.case"]
    assert order == ["boxseg.eval.parse", "boxseg.sweep.case",
                     "boxseg.eval.host_loop", "boxseg.eval.postprocess",
                     "boxseg.eval.score"]


def test_volume3d_run_spans(nf_root, tmp_path):  # noqa: F811
    argv = (["nf_3d", "--mode", "eval"] + _common(nf_root, tmp_path)
            + ["--im_depth", "-1", "--batch_size", "1", "--device", "cpu"])
    args = cli.get_args(argv)
    metas = cli._test_metas(args, nf_root)

    def predict(feats):             # every voxel NF, as a uint8 class map
        return np.ones(feats["images"].shape[:4], np.uint8)

    ev = tvol3d.EvaluateVolume3D(args, nf_root, ["Background", "NF"])
    spans = _spans(_profiled(lambda: ev.run(predict, metas)))
    n = len(metas)
    assert n > 0
    assert _names(spans) == {"boxseg.eval.case": n, "boxseg.eval.parse": n,
                             "boxseg.eval.postprocess": n,
                             "boxseg.eval.score": n}
    for name in ("parse", "postprocess", "score"):
        assert _parents(spans, f"boxseg.eval.{name}") == {"boxseg.eval.case"}


class _HeldSampler:
    """A sampler whose workers wait for ``go`` before their first batch."""

    def __init__(self):
        self.go = threading.Event()

    def sample_batch(self, batch_size, rng):
        self.go.wait()
        return {"x": np.zeros(batch_size, np.float32)}


def test_train_dataset_counts_gets_and_starved_gets():
    sampler = _HeldSampler()
    data = TrainDataset(sampler, argparse.Namespace(batch_size=2),
                        prefetch=2, workers=1)
    try:
        assert (data.gets, data.starved) == (0, 0)
        release = threading.Timer(0.2, sampler.go.set)
        release.start()
        next(data)                  # the queue is empty until released
        release.join(timeout=5.0)
        assert (data.gets, data.starved) == (1, 1)
        deadline = time.monotonic() + 10.0
        while not data._q.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert data._q.full()
        for _ in range(2):
            next(data)
        assert (data.gets, data.starved) == (3, 1)
    finally:
        sampler.go.set()
        data.close()
    assert not any(t.is_alive() for t in data._threads)
