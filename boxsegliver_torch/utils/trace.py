"""Named host spans of the program, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler runs in the process (a ``torch.profiler.profile`` of the
benchmark's traced run, or an operator's own), and one shared null context
otherwise: with nothing tracing, a span costs the check of a flag.  A span
lands in the same kineto trace as the CUDA activity, so an idle gap of the
device can be put down to what the host was doing.  Every name starts
with ``boxseg.``.

A span is opened only on the thread that runs the profiler (a
``record_function`` from a thread started after the profiler was is not
recorded): the samplers' worker threads are measured by counters
(data/pipeline.TrainDataset).  No span sits inside a region a CUDA graph
captures: a replay runs the captured kernels, not the host's spans.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager that records ``name`` under a running profiler,
    and the shared null context otherwise."""
    return torch.profiler.record_function(name) if _profiling() else _OFF
