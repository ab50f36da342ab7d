"""The whole-volume 3-D evaluation traffic: ``EvaluateVolume3D.run`` over
the test cases with the device predictor ``make_volume_predict`` (z-score
and argmax on the device), wired as ``cli.main`` wires ``--im_depth -1``
without a cascade, the cases cycled back to back for a fixed time.

Set-up (counted in ``setup_s``): the test cases from the seed, the model
with the benchmark's seeded weights, the evaluator, and one pass over every
case.  The window runs whole cases (parse, forward, argmax, crop, metrics)
until ``--seconds`` have passed; its rate is the volume slices of the
completed cases over the time from the window's start to the end of the
last case.  With ``--trace 1`` a fixed number of cases runs under the
profiler, the predictor timed apart.

The answers are the per-case predictions and metrics.  The run keeps the
prediction of cases at positions of the window drawn from the seed (all of
them, if fewer complete); after the window the reference
(``portbench.reference.eval3d``) computes each kept case's logits in
float32.  Compared, against the limits of ``portbench/checks/<cell>.json``:
the widest gap by which a voxel's chosen class lies below the reference's
best logit, and the largest difference between the program's per-case Dice
and the Dice the reference counts from the program's own prediction.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

SAMPLE = 4            # kept cases a run


def program_args(ctx):
    from boxsegliver_torch.cli import main as cli

    argv = [ctx.config["task"], "--mode", "eval", *ctx.config["flags"],
            *ctx.config["eval_flags"],
            "--model_dir", str(ctx.tmp / "model"),
            "--data_root", str(ctx.tmp / "data"),
            "--seed", str(ctx.program_seed)]
    return cli.get_args(argv)


class Timed:
    """The predictor, its calls timed to their host result (the predictor
    returns host arrays), keeping the outputs of chosen calls."""

    def __init__(self, fn, keep):
        self.fn, self.keep = fn, set(keep)
        self.calls, self.seconds, self.kept = 0, 0.0, {}
        for k in ("ret", "in_zscore"):
            setattr(self, k, getattr(fn, k))

    def __call__(self, feats):
        with torch.profiler.record_function("portbench.predict"):
            t = time.perf_counter()
            out = self.fn(feats)
            self.seconds += time.perf_counter() - t
        if self.calls in self.keep:        # the padded [d', h', w'] answer
            self.kept[self.calls] = np.array(out[0], copy=True)
        self.calls += 1
        return out


def build(ctx, args):
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.volume3d import (EvaluateVolume3D,
                                                       make_volume_predict)
    from boxsegliver_torch.models import build_model, get_model_params

    from portbench import data as data_mod
    from portbench import weights

    cfg = ctx.config
    ds = data_mod.make_dataset(
        Path(args.data_root) / args.dataset, cfg["data"], ctx.seed,
        ctx.device, train_cases=0, test_cases=int(cfg["cases"]["test"]),
        k_folds=int(args.k_folds), test_fold=int(args.test_fold))
    p = get_model_params(args)
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    model = build_model(p["model"], args=args, model_kwargs=p["model_kwargs"],
                        dtype=dtype)
    model.load_state_dict(weights.make(cfg, ctx.seed, ctx.device),
                          strict=True)
    model = model.to(ctx.device).eval()
    classes = ["Background"] + list(args.classes)
    ev3 = EvaluateVolume3D(args, ds, classes)
    predict = make_volume_predict(model, ctx.device, ret="pred",
                                  in_zscore=True)
    return model, ev3, predict, cli._test_metas(args, ds), ds


def window(ev3, predict, metas, seconds=None, cases=None):
    """Whole cases back to back; returns (per-case results, slices,
    seconds, per-case walls)."""
    results, walls, slices = [], [], 0
    with torch.profiler.record_function("portbench.window"):
        t0 = time.perf_counter()
        while True:
            meta = metas[len(results) % len(metas)]
            t1 = time.perf_counter()
            with torch.profiler.record_function("portbench.case"):
                results.append(ev3.run(predict, [meta]))
            walls.append(time.perf_counter() - t1)
            slices += int(meta["size"][0])
            if (cases is not None and len(results) >= cases) or (
                    seconds is not None
                    and time.perf_counter() - t0 >= seconds):
                break
        dt = time.perf_counter() - t0
    return results, slices, dt, walls


def measure(ctx) -> Dict:
    args = program_args(ctx)
    model, ev3, predict, metas, ds = build(ctx, args)
    window(ev3, predict, metas, cases=len(metas))          # warm-up
    per_case = window(ev3, predict, metas, cases=len(metas))[2] / len(metas)
    ctx.setup_done()
    expected = (int(ctx.traffic["trace_cases"]) if ctx.trace
                else max(1, int(ctx.seconds / per_case)))
    rng = np.random.default_rng([ctx.seed, 0xE7A1])
    keep = sorted(rng.choice(expected, size=min(SAMPLE, expected),
                             replace=False).tolist())
    timed = Timed(predict, keep)
    if ctx.trace:
        with ctx.profiler() as prof:
            results, slices, secs, walls = window(
                ev3, timed, metas, cases=int(ctx.traffic["trace_cases"]))
        records = ctx.reduce(prof)
    else:
        results, slices, secs, walls = window(ev3, timed, metas,
                                              seconds=ctx.seconds)
        records = None
    peak = ctx.memory_peak()
    del model, predict, timed.fn
    ctx.free()
    out = {"attempted": len(results), "failed": 0,
           "memory_peak_bytes": peak,
           "e2e": {"eval_slices_per_s": slices / secs}}
    if records is not None:
        from portbench import flops
        shape = list(metas[0]["size"])
        records.update(
            units=len(results), slices=slices, traced_s=secs,
            predict_s=timed.seconds, case_s=sum(walls),
            b2_min_s_per_unit=flops.b2_min_seconds(ctx.config, shape, 1,
                                                   False),
            flops_per_unit=2 * flops.work(ctx.config, shape)[0])
        out["records"] = records
    ref = Reference(ctx, ds, metas)
    out["compared"] = compare(ref, timed.kept, results, list(args.classes))
    return out


class Reference:
    """The reference's float32 logits of a case, by window position."""

    def __init__(self, ctx, ds, metas):
        from portbench import weights
        from portbench.reference import nets

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.net = nets.build(ctx.config).to(ctx.device)
        self.net.load_state_dict(weights.make(ctx.config, ctx.seed,
                                              ctx.device))
        self.ctx, self.ds, self.metas = ctx, Path(ds), metas

    def case(self, pos: int):
        return self.ds / f"volume-{self.metas[pos % len(self.metas)]['PID']}"

    def logits(self, pos: int, quant=None):
        from portbench.reference import eval3d, nets

        vol = np.load(self.case(pos) / "volume.npy")
        return eval3d.volume_logits(self.net, vol, self.ctx.device,
                                    nets.Ops(quant))


def compare(ref: Reference, preds: Dict[int, np.ndarray], results: List,
            classes) -> Dict[str, float]:
    """The kept cases' widest logit gap, and the largest difference of a
    per-case Dice from the Dice counted from the program's own
    prediction."""
    from portbench.reference import eval3d

    gap, metric = 0.0, 0.0
    for pos, pred in preds.items():
        logits = ref.logits(pos)
        pred = pred[:logits.shape[0], :logits.shape[1], :logits.shape[2]]
        gap = max(gap, eval3d.logit_gap(logits, pred))
        if results is not None:
            lab = np.load(ref.case(pos) / "segmentation.npy")
            want = eval3d.case_metrics(pred, lab, classes)
            metric = max([metric] + [abs(results[pos][k] - v)
                                     for k, v in want.items()])
    return {"logit_gap": gap, "metric_gap": metric}


def calibrate(ctx, controls: bool) -> Dict[str, Dict[str, float]]:
    """The program's readings on every test case once, and with
    ``controls`` the control's (the reference's float8-operand argmax)
    and two planted faults' (an answer altered where it is produced: a
    slab of voxels given the next class; a stale answer: the previous
    case's prediction)."""
    args = program_args(ctx)
    model, ev3, predict, metas, ds = build(ctx, args)
    timed = Timed(predict, range(len(metas)))
    results = window(ev3, timed, metas, cases=len(metas))[0]
    del model, predict, timed.fn
    ctx.free()
    ref = Reference(ctx, ds, metas)
    classes = list(args.classes)
    rows = {"program": compare(ref, timed.kept, results, classes)}
    if controls:
        nc = len(classes) + 1
        ctrl = {p: ref.logits(p, "fp8").argmax(-1).to(torch.uint8)
                .cpu().numpy() for p in timed.kept}
        rows["control_fp8"] = compare(ref, ctrl, None, classes)
        altered = {}
        for p, pred in timed.kept.items():
            a = pred.copy()
            d = int(metas[p % len(metas)]["size"][0])
            a[: d // 8] = (a[: d // 8] + 1) % nc
            altered[p] = a
        rows["fault_altered_answer"] = compare(ref, altered, None, classes)
        stale = {p: timed.kept[(p - 1) % len(metas)] for p in timed.kept}
        rows["fault_stale_answer"] = compare(ref, stale, None, classes)
    return rows
