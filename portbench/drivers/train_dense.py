"""DenseUNet's training traffic: ``drivers/train.py``'s window, feed,
checked steps and comparison (imported from it), with DenseUNet's plain
reference (``portbench.reference.dense_unet``: its network, seeded
weights, preprocess and train step) and counts (``portbench.dense_counts``).

Set-up builds what ``cli.main.train`` builds for ``003_denseunet.sh``: the
data set from the seed, the device cache, ``cli.main.build_trainer`` with
the benchmark's seeded weights (the batch norms' running statistics
included), the host sampler and its feed.  With ``--trace 1`` the driver
also counts the device kernels of the traced window from the profiler's
device events (``records["device_kernels"]``), besides the trace's
reduction and the batch-norm planes' least time a step
(``records["norm_min_s_per_unit"]``).

Besides ``drivers/train.compare``'s numbers (``compare_dense``): the full
dispatch's mean step's relative loss gap, which parts a dispatch of stale
rows where the median step's may not; the batch norms' running
statistics, which the program moves inside its graph replays: the worst
and the median buffer's gap of norms of their change over the full
dispatch, as ``compare``'s leaf gaps; and ``generator_gap``, 0 where the
trainer's registered generator ends the checked steps in the state of the
reference's generator after the same draws (the augmentation's and every
dropout mask's), else 1.

The planted faults of the calibration are ``drivers/train.py``'s: half of
each batch left out; in the full dispatch every step reading its first
batch, or its first random draws, which here are the augmentation's and
every dropout mask of the network; and one of this cell's: the running
statistics frozen through the full dispatch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from portbench.drivers.train import (FULL_FROM, Feed, checked_steps, compare,
                                     leaf_gaps, leaf_norms, program_args,
                                     warm_up, window, worst_leaves)

RUNNING = ("running_mean", "running_var")


def running_stats(model) -> Dict[str, torch.Tensor]:
    """A copy of every batch norm's running statistics, by name."""
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(RUNNING)}


def running_change(model, start) -> Dict[str, float]:
    """Norm of each running statistic's change since ``start``."""
    return {n: float(torch.linalg.vector_norm((b - start[n]).float()))
            for n, b in model.named_buffers() if n in start}


class NotingFeed(Feed):
    """The checked steps' feed: each take, made before the dispatch it
    feeds, also notes the model's running statistics."""

    def __init__(self, data, model):
        super().__init__(data)
        self.model, self.noted = model, []

    def take(self, n: int):
        self.noted.append(running_stats(self.model))
        return super().take(n)


def dense_checked_steps(trainer, data, k: int):
    """``checked_steps``, its readings followed by the running statistics'
    change over the full dispatch and the generator's state after it."""
    feed = NotingFeed(data, trainer.model)
    raws, prog = checked_steps(trainer, feed, k)
    return raws, (*prog, running_change(trainer.model, feed.noted[-1]),
                  trainer.generator.get_state())


def compare_dense(prog, ref) -> Dict[str, float]:
    """``compare``'s numbers, the full dispatch's mean relative loss gap,
    the worst and the median buffer's gap of the running statistics'
    change over the full dispatch, and ``generator_gap`` (0 where the
    generators' states are equal, else 1)."""
    out = compare(prog[:4], ref[:4])
    out["dispatch_loss_mean_gap"] = float(np.mean(
        [abs(a - b) / abs(b) for a, b in zip(prog[0][FULL_FROM:],
                                             ref[0][FULL_FROM:])]))
    names = list(ref[4])
    gaps = leaf_gaps(np.array([prog[4][n] for n in names]),
                     np.array([ref[4][n] for n in names]))
    out["running_change_gap"] = float(gaps.max())
    out["running_change_median_gap"] = float(np.median(gaps))
    out["generator_gap"] = 0.0 if torch.equal(prog[5], ref[5]) else 1.0
    return out


def build(ctx, args):
    """(trainer, feed, dataset dir) as cli.main.train builds them for
    DenseUNet with ``--device_cache``."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.device_cache import DeviceVolumeCache
    from boxsegliver_torch.data.pipeline import TrainDataset
    from boxsegliver_torch.data.sampler import TrainSampler

    from portbench import data as data_mod
    from portbench.reference import dense_unet as ref

    cfg = ctx.config
    ds = data_mod.make_dataset(
        Path(args.data_root) / args.dataset, cfg["data"], ctx.seed,
        ctx.device, train_cases=int(cfg["cases"]["train"]), test_cases=0,
        k_folds=int(args.k_folds), test_fold=int(args.test_fold))
    train_pids, _ = cli._split_pids(args, ds)
    cache = DeviceVolumeCache(ds, [int(p) for p in train_pids], ctx.device,
                              budget_gb=args.device_cache_gb)
    trainer = cli.build_trainer(args, ctx.device, cache=cache)
    trainer.model.load_state_dict(ref.make_weights(cfg, ctx.seed, ctx.device),
                                  strict=True)
    sampler = TrainSampler(ds, args, mode="train", seed=args.seed,
                           zbase=cache.zbase)
    data = TrainDataset(sampler, args, seed=args.seed,
                        workers=int(ctx.traffic["host_workers"]))
    return trainer, data, ds


def reference_readings(ctx, args, ds, raws, quant=None, fault=None):
    """The reference's readings over the same raw batches, as
    ``dense_checked_steps`` gives the program's (float32, TF32 off;
    ``quant`` and the faults as ``drivers/train.reference_readings`` takes
    them, and "running_frozen": the running statistics put back after each
    step of the full dispatch)."""
    from portbench.reference import dense_unet as ref
    from portbench.reference import train as rtrain

    dev = ctx.device
    flags = ctx.config["settings"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = ref.RefDenseTrainer(ctx.config,
                             ref.make_weights(ctx.config, ctx.seed, dev), dev,
                             quant=quant,
                             fault=fault if fault == "half_batch" else None)
    init = [p.detach().clone() for p in tr.params]
    gen = torch.Generator(device=dev).manual_seed(int(args.seed))
    stack = rtrain.stacked_volumes(
        ds, rtrain.train_pids(ds, flags["test_fold"]), dev)
    losses, grad1, change3 = [], None, None
    for i, raw in enumerate(raws):
        if i == FULL_FROM:
            start = [p.detach().clone() for p in tr.params]
            gen_state = gen.get_state()
            running = running_stats(tr.net)
        if i > FULL_FROM and fault == "stale_rows":
            raw = raws[FULL_FROM]
        if i > FULL_FROM and fault == "stale_generator":
            gen.set_state(gen_state)
        feats, labels = ref.preprocess(raw, *stack, gen, flags, dev)
        loss, grads = tr.step(feats, labels, gen)
        if i >= FULL_FROM and fault == "running_frozen":
            with torch.no_grad():
                for n, b in tr.net.named_buffers():
                    if n in running:
                        b.copy_(running[n])
        losses.append(loss)
        if i == 0:
            grad1 = leaf_norms(tr.names, grads)
        if i == FULL_FROM - 1:
            change3 = leaf_norms(tr.names, (p.detach() - q
                                            for p, q in zip(tr.params, init)))
        del grads, feats, labels
    change = leaf_norms(tr.names, (p.detach() - q
                                   for p, q in zip(tr.params, start)))
    return (losses, grad1, change3, change, running_change(tr.net, running),
            gen.get_state())


def device_kernels(prof, window_span: str = "portbench.window") -> int:
    """Device kernels that started inside the traced window: the
    profiler's device events less copies, sets and the host spans' device
    annotations."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    w0, w1 = next((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CPU and e.name == window_span)
    return sum(1 for e in events if e.device_type == DeviceType.CUDA
               and e.name not in host and w0 <= e.time_range.start < w1
               and not e.name.lower().startswith(("memcpy", "memset")))


def measure(ctx) -> Dict:
    """One run of the cell; returns the harness's result parts."""
    args = program_args(ctx)
    trainer, data, ds = build(ctx, args)
    k = int(args.steps_per_dispatch)
    feed = Feed(data)
    try:
        raws, prog = dense_checked_steps(trainer, data, k)
        warm_up(trainer, feed, k)
        ctx.setup_done()
        bs = int(args.batch_size)
        feed.wait = 0.0
        if ctx.trace:
            with ctx.profiler() as prof:
                steps, secs, bad = window(
                    trainer, feed, k,
                    dispatches=int(ctx.traffic["trace_dispatches"]))
            records = ctx.reduce(prof)
            records["device_kernels"] = device_kernels(prof)
            del prof
        else:
            steps, secs, bad = window(trainer, feed, k, seconds=ctx.seconds)
            records = None
        peak = ctx.memory_peak()
    finally:
        data.close()
        if trainer.summary is not None:
            trainer.summary.close()
    del trainer
    ctx.free()
    out = {"attempted": steps, "failed": bad, "memory_peak_bytes": peak,
           "e2e": {ctx.traffic["rate"]: steps * bs / secs}}
    if records is not None:
        from portbench import dense_counts, flops
        shape = flops.input_shape(ctx.config)
        records.update(
            units=steps, traced_s=secs, input_wait_s=feed.wait,
            norm_min_s_per_unit=dense_counts.norm_min_seconds(ctx.config,
                                                              shape, bs),
            flops_per_unit=bs * dense_counts.train_flops_per_sample(
                ctx.config, shape))
        out["records"] = records
    ref = reference_readings(ctx, args, ds, raws)
    out["compared"] = compare_dense(prog, ref)
    return out


def calibrate(ctx, controls: bool) -> Dict[str, Dict]:
    """The program's checked steps against the reference, and with
    ``controls`` the control's (the reference in float8 operands) and the
    planted faults' (``reference_readings``); no window."""
    args = program_args(ctx)
    trainer, data, ds = build(ctx, args)
    try:
        raws, prog = dense_checked_steps(trainer, data,
                                         int(args.steps_per_dispatch))
    finally:
        data.close()
    del trainer
    ctx.free()
    ref = reference_readings(ctx, args, ds, raws)
    rows = {"program": prog}
    if controls:
        rows["control_fp8"] = reference_readings(ctx, args, ds, raws,
                                                 quant="fp8")
        for fault in ("half_batch", "stale_rows", "stale_generator",
                      "running_frozen"):
            rows[f"fault_{fault}"] = reference_readings(ctx, args, ds, raws,
                                                        fault=fault)
    return {k: dict(compare_dense(v, ref), losses=v[0], ref_losses=ref[0],
                    worst=worst_leaves(v, ref)) for k, v in rows.items()}
