"""A whole run of each cell, with the look for a chip skipped and the tiny
configuration on the CPU, sees ``correct`` true when the program is sound
(computing in float32) and false when the timed path is broken
underneath: in training, a step that leaves the state unchanged, a step
that leaves out half of the batch and takes the mean over the rest, and
an answer altered where it is produced (the gradients scaled as the
optimizer takes them); in the evals, an answer or a metric altered where
it is produced (and the guided sweep's guides left out, far off a sound
run).  The cells run on
one chip, so no exchange between chips can be left out.  The control, the
reference in float8 operands, fails the cells' limits."""

import tempfile
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.drivers import train as drv
from tiny import _set, bench_with, tiny_config

CPU = torch.device("cpu")


def _spec(name):
    spec = run.resolve(run.load_bench(), f"{name}.train")
    cfg = tiny_config(name)
    cfg["flags"] = _set(cfg["flags"], "--compute_dtype", "float32")
    cfg["settings"]["compute_dtype"] = "float32"
    spec["config"] = cfg
    return spec


def _run(name):
    with tempfile.TemporaryDirectory() as tmp:
        return run.execute(_spec(name), 2 ** 31 + 99, 0.5, False, CPU,
                           Path(tmp))


def _unchanged(monkeypatch):
    from boxsegliver_torch.train import solver
    monkeypatch.setattr(solver.Optimizer, "apply",
                        lambda self, grads, sched: None)


def _half_batch(monkeypatch):
    from boxsegliver_torch.train import trainer
    make = trainer.make_loss_fn

    def halved(args, group=None):
        fn = make(args, group)
        return lambda logits, labels: fn(logits[: len(logits) // 2],
                                         labels[: len(labels) // 2])
    monkeypatch.setattr(trainer, "make_loss_fn", halved)


def _altered_gradient(monkeypatch):
    from boxsegliver_torch.train import solver
    apply = solver.Optimizer.apply

    def scaled(self, grads, sched):
        return apply(self, [g * 1.5 for g in grads], sched)
    monkeypatch.setattr(solver.Optimizer, "apply", scaled)


def _full_dispatch(fault):
    """``fault`` planted in the dispatches of K steps only: the window's
    shape, which the trainer runs as CUDA-graph replays on a card."""
    def plant(monkeypatch):
        from boxsegliver_torch.train import trainer
        multi = trainer.Trainer.train_multi_step

        def faulty(self, batches):
            if len(batches) < self.steps_per_dispatch:
                return multi(self, batches)
            return fault(self, multi, batches)
        monkeypatch.setattr(trainer.Trainer, "train_multi_step", faulty)
    plant.__name__ = fault.__name__
    return plant


def _stale_rows(self, multi, batches):
    return multi(self, [batches[0]] * len(batches))


def _replays_unchanged(self, multi, batches):
    state = [p.detach().clone() for p in self.params]
    out = multi(self, batches)
    with torch.no_grad():
        for p, q in zip(self.params, state):
            p.copy_(q)
    return out


@pytest.mark.parametrize("name", ["gnet_sp", "unet3d"])
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    rate = {"gnet_sp": "train_samples_per_s", "unet3d": "train_patches_per_s"}
    assert set(res["metrics"]) == {rate[name], "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _altered_gradient,
                                   _full_dispatch(_stale_rows),
                                   _full_dispatch(_replays_unchanged)])
@pytest.mark.parametrize("name", ["gnet_sp", "unet3d"])
def test_broken_step_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["gnet_sp", "unet3d"])
def test_control_fails_the_limits(name):
    """The reference computed with float8 operands, put in the program's
    place, reads outside the cell's limits (the chip's readings at the
    cell's size are in PERF.md)."""
    spec = _spec(name)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = run.Context(spec, 4321, 1.0, False, CPU, Path(tmp))
        args = drv.program_args(ctx)
        trainer, data, ds = drv.build(ctx, args)
        raws, _ = drv.checked_steps(trainer, drv.Feed(data),
                                    int(args.steps_per_dispatch))
        data.close()
        ref = drv.reference_readings(ctx, args, ds, raws)
        ctrl = drv.reference_readings(ctx, args, ds, raws, quant="fp8")
    _, ok = run.judge(drv.compare(ctrl, ref), spec["limits"])
    assert not ok


def _eval_spec():
    spec = run.resolve(bench_with("unet3d.eval"), "unet3d.eval")
    spec["config"] = tiny_config("unet3d")
    return spec


def _eval_run():
    with tempfile.TemporaryDirectory() as tmp:
        return run.execute(_eval_spec(), 2 ** 31 + 7, 0.5, False, CPU,
                           Path(tmp))


def _altered_prediction(monkeypatch):
    from boxsegliver_torch.evaluators import volume3d
    make = volume3d.make_volume_predict

    def altered(*a, **k):
        fn = make(*a, **k)

        def predict(feats):
            out = fn(feats).copy()
            out[:, : out.shape[1] // 8] = 1 - out[:, : out.shape[1] // 8]
            return out
        predict.ret, predict.in_zscore = fn.ret, fn.in_zscore
        return predict
    monkeypatch.setattr(volume3d, "make_volume_predict", altered)


def _altered_metric(monkeypatch):
    from boxsegliver_torch.evaluators import volume3d
    metric = volume3d.metric_3d

    def off(*a, **k):
        return {m: v + 0.01 for m, v in metric(*a, **k).items()}
    monkeypatch.setattr(volume3d, "metric_3d", off)


def test_sound_eval_run_is_correct():
    res = _eval_run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"eval_slices_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [_altered_prediction, _altered_metric])
def test_broken_eval_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not _eval_run()["correct"]


def test_eval_control_fails_the_limits():
    from portbench.drivers import eval_volume3d as ev

    spec = _eval_spec()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = run.Context(spec, 4321, 0.0, False, CPU, Path(tmp))
        rows = ev.calibrate(ctx, True)
    _, ok = run.judge(rows["control_fp8"], spec["limits"])
    assert not ok


def _sweep_spec():
    spec = run.resolve(run.load_bench(), "gnet_sp.eval_g")
    cfg = tiny_config("gnet_sp")
    cfg["flags"] = _set(cfg["flags"], "--compute_dtype", "float32")
    cfg["settings"]["compute_dtype"] = "float32"
    cfg["cases"]["test"] = 3
    spec["config"] = cfg
    return spec


def _sweep_run():
    with tempfile.TemporaryDirectory() as tmp:
        return run.execute(_sweep_spec(), 2 ** 31 + 11, 0.5, False, CPU,
                           Path(tmp))


def _altered_sweep(monkeypatch):
    from boxsegliver_torch.interactive import device_sweep
    sweep = device_sweep.GuidedSweepPredictor.sweep_case

    def altered(self, *a, **k):
        out, n = sweep(self, *a, **k)
        out = out.copy()
        out[: max(1, len(out) // 8)] = out[: max(1, len(out) // 8)][
            ..., [2, 1, 0]]
        return out, n
    monkeypatch.setattr(device_sweep.GuidedSweepPredictor, "sweep_case",
                        altered)


def _no_guide(monkeypatch):
    from boxsegliver_torch.interactive import device_sweep
    guide = device_sweep.gaussian_guide_batch

    def flat(centers, stddevs, valid, **k):
        return guide(centers, stddevs, torch.zeros_like(valid), **k)
    monkeypatch.setattr(device_sweep, "gaussian_guide_batch", flat)


def _altered_sweep_metric(monkeypatch):
    from boxsegliver_torch.evaluators import volume
    metric = volume.metric_3d

    def off(*a, **k):
        return {m: v + 0.01 for m, v in metric(*a, **k).items()}
    monkeypatch.setattr(volume, "metric_3d", off)


def test_sound_sweep_run_is_correct():
    res = _sweep_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"eval_slices_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [_altered_sweep, _altered_sweep_metric])
def test_broken_sweep_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not _sweep_run()["correct"]


def test_sweep_without_guides_reads_far_from_sound(monkeypatch):
    """The user's guides left out of the program's sweep move the log-odds
    gap a hundredfold off a sound float32 run's (about 2e-4 here); the
    tiny network's guide convs move its output less than the cell's do,
    whose readings against the limit are in PERF.md §2."""
    _no_guide(monkeypatch)
    assert _sweep_run()["checks"]["sweep_gap"]["value"] > 0.02


def test_sweep_control_fails_the_limits():
    from portbench.drivers import eval_sweep as ev

    spec = _sweep_spec()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = run.Context(spec, 4321, 0.0, False, CPU, Path(tmp))
        rows = ev.calibrate(ctx, True)
    for name in ("control_fp8", "fault_altered_answer", "fault_stale_answer",
                 "fault_no_guide"):
        _, ok = run.judge(rows[name], spec["limits"])
        assert not ok, name
