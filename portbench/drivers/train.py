"""The training traffic: the program's trainer fed by its own host sampler,
as ``cli.main.train`` builds them, driven for a fixed time in dispatches
of ``steps_per_dispatch`` steps.

Set-up (counted in ``setup_s``): the data set from the seed, the device
cache (where the configuration's flags ask for it), the trainer built by
``cli.main.build_trainer`` with the benchmark's seeded weights, the
sampler and its feed.  The same trainer then runs, through
``Trainer.train_multi_step`` and the feed, the checked steps (a dispatch
of one step, one of two, then one full dispatch of K steps: the trainer
runs its first three steps eagerly by design, so the third dispatch is
the window's own shape, K graph replays where K > 1) and warm-up
dispatches until every step variant the window meets is captured.  The
window is back-to-back dispatches of K steps, closed by one fetch of every
step's values; its rate is samples over the whole window.  The window
drives ``train_multi_step`` alone: the host hooks that ``Trainer.train``
runs on each fetch (loss mean, plateau lr, speed log, summaries) are not
in it.  With ``--trace 1`` a fixed number of dispatches runs under the
profiler instead.

After the window the program's state is freed and the reference
(``portbench.reference.train``) repeats the checked steps in float32
from the same raw batches, weights and seed.  ``compare`` gives, leaves
matched by name: the first step's and the worst step's relative loss gap,
and the worst and the median leaf's gap of norms, each against the larger
of the leaf's reference norm and the median leaf's, of: the first step's
gradient as Adam got it (its first moment / (1 − β1)); the parameters'
change after three steps; and the parameters' change over the full
dispatch of K graph replays, whose steps' median relative loss gap is
compared too.  Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of a change.
``portbench/checks/<workload>.json`` names the numbers compared and their
limits; the others are printed.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

MOMENT_B1 = 0.9
FULL_FROM = 3         # checked steps before the full dispatch


def check_dispatches(k: int):
    """The checked steps as dispatches: 1, 2, then one full dispatch of K
    (steps 4 .. K + 3, after the trainer's three eager steps)."""
    return (1, 2, k)


def program_args(ctx) -> object:
    from boxsegliver_torch.cli import main as cli

    t = ctx.traffic
    argv = [ctx.config["task"], "--mode", "train", *ctx.config["flags"],
            *ctx.config["train_flags"],
            "--model_dir", str(ctx.tmp / "model"),
            "--data_root", str(ctx.tmp / "data"),
            "--seed", str(ctx.program_seed),
            "--steps_per_dispatch", str(t["steps_per_dispatch"]),
            "--host_workers", str(t["host_workers"])]
    return cli.get_args(argv)


def leaf_norms(names, tensors) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in zip(names, tensors)}


def leaf_gaps(prog: np.ndarray, ref: np.ndarray, keep=None) -> np.ndarray:
    """Per kept leaf |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    keep = np.ones(len(ref), bool) if keep is None else keep
    floor = float(np.median(ref[keep]))
    return np.abs(prog[keep] - ref[keep]) / np.maximum(ref[keep], floor)


class Feed:
    """next(data) with the host's wait summed, under a profiler span."""

    def __init__(self, data):
        self.data, self.wait = data, 0.0

    def take(self, n: int) -> List[Dict[str, np.ndarray]]:
        with torch.profiler.record_function("portbench.input"):
            t = time.perf_counter()
            out = [next(self.data) for _ in range(n)]
            self.wait += time.perf_counter() - t
        return out


def build(ctx, args):
    """(trainer, feed, dataset dir, cache) as cli.main.train builds them."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.pipeline import TrainDataset

    from portbench import data as data_mod
    from portbench import weights

    cfg = ctx.config
    ds = data_mod.make_dataset(
        Path(args.data_root) / args.dataset, cfg["data"], ctx.seed,
        ctx.device, train_cases=int(cfg["cases"]["train"]), test_cases=0,
        k_folds=int(args.k_folds), test_fold=int(args.test_fold),
        hist_modes=("train",) if cfg["data"].get("hist") else ())
    cache = None
    if getattr(args, "device_cache", False) and not cli.is_3d(args):
        from boxsegliver_torch.data.device_cache import DeviceVolumeCache
        train_pids, _ = cli._split_pids(args, ds)
        cache = DeviceVolumeCache(ds, [int(p) for p in train_pids],
                                  ctx.device, budget_gb=args.device_cache_gb)
    trainer = cli.build_trainer(args, ctx.device, cache=cache)
    trainer.model.load_state_dict(weights.make(cfg, ctx.seed, ctx.device),
                                  strict=True)
    if cli.is_3d(args):
        from boxsegliver_torch.data.sampler3d import Sampler3D
        sampler = Sampler3D(ds, args, mode="train", seed=args.seed)
    else:
        from boxsegliver_torch.data.sampler import TrainSampler
        sampler = TrainSampler(ds, args, mode="train", seed=args.seed,
                               zbase=cache.zbase if cache else None)
    data = TrainDataset(sampler, args, seed=args.seed,
                        workers=int(ctx.traffic["host_workers"]))
    return trainer, data, ds


def checked_steps(trainer, feed, k: int):
    """The checked steps through the window's call and feed; returns the
    raw batches, the program's losses, and the leaf norms of the first
    gradient, the three-step change and the full dispatch's change."""
    params, names = trainer.params, trainer.param_names
    mu = trainer.optimizer.state["mu"]
    init = [p.detach().clone() for p in params]
    raws, losses, grad1, change3 = [], [], None, None
    for i, n in enumerate(check_dispatches(k)):
        batch = feed.take(n)
        raws += batch
        if i == 2:
            start = [p.detach().clone() for p in params]
        out = trainer.train_multi_step(batch)
        losses += [float(v[0]) for _, v, _ in out]
        if i == 0:
            grad1 = leaf_norms(names, (m.float() / (1.0 - MOMENT_B1)
                                       for m in mu))
        if i == 1:
            change3 = leaf_norms(names, (p.detach() - q
                                         for p, q in zip(params, init)))
    change = leaf_norms(names, (p.detach() - q
                                for p, q in zip(params, start)))
    del init, start
    return raws, (losses, grad1, change3, change)


def warm_up(trainer, feed, k: int):
    """Dispatches of K until every step variant of the window (the train
    metrics' steps included) has run once."""
    every = int(trainer.metrics_every) if trainer.metric_keys else 1
    while trainer.global_step < max(every, 2 * k) + k:
        trainer.train_multi_step(feed.take(k))


def window(trainer, feed, k: int, seconds: float = None, dispatches=None):
    """Back-to-back dispatches until ``seconds`` have passed on the host's
    clock (or ``dispatches`` have run), closed by one fetch; returns
    (steps, seconds, non-finite steps)."""
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" \
        else (lambda: None)
    sync()
    vals, n = [], 0
    with torch.profiler.record_function("portbench.window"):
        t0 = time.perf_counter()
        while True:
            batches = feed.take(k)
            with torch.profiler.record_function("portbench.dispatch"):
                vals += [v for _, v, _ in trainer.train_multi_step(batches)]
            n += 1
            if (dispatches is not None and n >= dispatches) or (
                    seconds is not None
                    and time.perf_counter() - t0 >= seconds):
                break
        with torch.profiler.record_function("portbench.drain"):
            host = torch.stack(vals).cpu()
        dt = time.perf_counter() - t0
    bad = int((~torch.isfinite(host)).any(dim=1).sum())
    return len(vals), dt, bad


def reference_readings(ctx, args, ds, raws, quant=None, fault=None):
    """The reference's readings over the same raw batches, as
    ``checked_steps`` gives the program's (float32, TF32 off; ``quant`` as
    reference.train.RefTrainer takes it; ``fault`` "half_batch" as
    RefTrainer plants it, or, planted in the full dispatch only,
    "stale_rows": every step of it reads the dispatch's first batch, or
    "stale_generator": every step of it draws the dispatch's first step's
    random numbers)."""
    from portbench import weights
    from portbench.reference import train as ref

    dev = ctx.device
    flags = ctx.config["settings"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = ref.RefTrainer(ctx.config, weights.make(ctx.config, ctx.seed, dev),
                        dev, quant=quant,
                        fault=fault if fault == "half_batch" else None)
    init = [p.detach().clone() for p in tr.params]
    gen = torch.Generator(device=dev).manual_seed(int(args.seed))
    stack = None
    if ctx.config["model"]["arch"] == "GUNet":
        stack = ref.stacked_volumes(ds, ref.train_pids(ds, flags["test_fold"]),
                                    dev)
    first = FULL_FROM
    losses, grad1, change3 = [], None, None
    for i, raw in enumerate(raws):
        if i == first:
            start = [p.detach().clone() for p in tr.params]
            gen_state = gen.get_state()
        if i > first and fault == "stale_rows":
            raw = raws[first]
        if i > first and fault == "stale_generator":
            gen.set_state(gen_state)
        if stack is not None:
            feats, labels = ref.preprocess_liver(raw, *stack, gen, flags, dev)
        else:
            feats, labels = ref.preprocess_patch(raw, gen, flags, dev)
        loss, grads = tr.step(feats, labels, gen)
        losses.append(loss)
        if i == 0:
            grad1 = leaf_norms(tr.names, grads)
        if i == first - 1:
            change3 = leaf_norms(tr.names, (p.detach() - q
                                            for p, q in zip(tr.params, init)))
        del grads, feats, labels
    change = leaf_norms(tr.names, (p.detach() - q
                                   for p, q in zip(tr.params, start)))
    return losses, grad1, change3, change


def compare(prog, ref) -> Dict[str, float]:
    """The compared numbers of the program's (or the control's) readings
    against the reference's, leaves matched by name: the first step's and
    the worst step's relative loss gap, the full dispatch's median step's,
    and the worst and the median leaf's gap of the first gradient, the
    three-step change and the full dispatch's change."""
    r_loss, names = ref[0], list(ref[1])
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog[0], r_loss)]
    out = {"loss1_gap": gaps[0], "loss_gap": max(gaps),
           "dispatch_loss_median_gap": float(np.median(gaps[FULL_FROM:]))}
    (pg, rg), (pd, rd), (pc, rc) = (
        (np.array([p[n] for n in names]), np.array([r[n] for n in names]))
        for p, r in zip(prog[1:], ref[1:]))
    moved = rg >= 1e-3 * np.median(rg)
    for key, (p, r, keep) in {"grad1": (pg, rg, None),
                              "change3": (pd, rd, moved),
                              "dispatch_change": (pc, rc, moved)}.items():
        g = leaf_gaps(p, r, keep)
        out[f"{key}_gap"] = float(g.max())
        out[f"{key}_median_gap"] = float(np.median(g))
    return out


def worst_leaves(prog, ref, k: int = 3) -> Dict[str, list]:
    """The k leaves with the widest gap of each leaf reading, for the
    calibration's look."""
    out = {}
    for key, i in (("grad1", 1), ("change3", 2), ("dispatch_change", 3)):
        names = list(ref[i])
        p = np.array([prog[i][n] for n in names])
        r = np.array([ref[i][n] for n in names])
        gaps = leaf_gaps(p, r)
        out[key] = [[names[j], float(gaps[j]), float(r[j])]
                    for j in np.argsort(-gaps)[:k]]
    return out


def measure(ctx) -> Dict:
    """One run of a training cell; returns the harness's result parts."""
    args = program_args(ctx)
    trainer, data, ds = build(ctx, args)
    k = int(args.steps_per_dispatch)
    feed = Feed(data)
    try:
        raws, prog = checked_steps(trainer, feed, k)
        warm_up(trainer, feed, k)
        ctx.setup_done()
        bs = int(args.batch_size)
        feed.wait = 0.0
        if ctx.trace:
            dispatches = int(ctx.traffic["trace_dispatches"])
            with ctx.profiler() as prof:
                steps, secs, bad = window(trainer, feed, k,
                                          dispatches=dispatches)
            records = ctx.reduce(prof)
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
        from portbench import flops
        shape = flops.input_shape(ctx.config)
        records.update(
            units=steps, traced_s=secs, input_wait_s=feed.wait,
            b2_min_s_per_unit=flops.b2_min_seconds(ctx.config, shape, bs,
                                                   True),
            flops_per_unit=bs * flops.train_flops_per_sample(ctx.config,
                                                             shape))
        out["records"] = records
    ref = reference_readings(ctx, args, ds, raws)
    out["compared"] = compare(prog, ref)
    return out


def calibrate(ctx, controls: bool) -> Dict[str, Dict]:
    """The program's checked steps against the reference, and with
    ``controls`` the control's (the reference in float8 operands) and the
    planted faults' (``reference_readings``); no window."""
    args = program_args(ctx)
    trainer, data, ds = build(ctx, args)
    try:
        raws, prog = checked_steps(trainer, Feed(data),
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
        for fault in ("half_batch", "stale_rows", "stale_generator"):
            rows[f"fault_{fault}"] = reference_readings(ctx, args, ds, raws,
                                                        fault=fault)
    return {k: dict(compare(v, ref), losses=v[0], ref_losses=ref[0],
                    worst=worst_leaves(v, ref)) for k, v in rows.items()}
