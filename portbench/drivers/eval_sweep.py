"""The guided whole-volume eval traffic: ``EvaluateVolume.run_g`` with the
device sweep ``GuidedSweepPredictor``, wired as ``cli.main.evaluate``
wires ``002_gnet_sp.sh eval`` (``--use_spatial``, ``--eval_mirror``), the
test cases cycled back to back for a fixed time.

Set-up (counted in ``setup_s``): the test cases, their eval hist features
and the user prior from the seed; the model with the benchmark's seeded
weights, the head made to put every voxel's argmax on Liver
(``weights.liver_margin``, with the traffic's ``head_scale`` and
``liver_margin``), so no predicted tumour enters the sweep's state and no
case overflows into the host loop; the evaluator; one pass over every
case.  The window runs whole cases (parse, both sweeps, merge, argmax,
resize, post-process, metrics) until ``--seconds`` have passed; its rate
is the volume slices of the completed cases over the time from the
window's start to the end of the last case.  A case that fell back to the
host loop, or in which a tumour voxel was predicted, counts as failed.
With ``--trace 1`` a fixed number of cases runs under the profiler, the
sweep timed apart.

The answers are the per-case merged probabilities and metrics.  The run
keeps the probabilities of cases at positions of the window drawn from
the seed; after the window the reference (``portbench.reference.sweep``)
computes each kept case's in float32.  Compared, against the limits of
``portbench/checks/<cell>.json``: the widest gap of a voxel's log-odds of
Tumour against Background (log p_T − log p_B: the liver margin's
logit cancels) relative to the case's widest reference log-odds; the
voxels whose class differs from the reference's; and the largest
difference between the program's per-case metrics and those the
reference counts from the program's own probabilities.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

SAMPLE = 3            # kept cases a run
MIRRORS = 4           # the forwards a slice takes a sweep (--eval_mirror)


def program_args(ctx):
    from boxsegliver_torch.cli import main as cli

    argv = [ctx.config["task"], "--mode", "eval", *ctx.config["flags"],
            *ctx.config["eval_flags"],
            "--model_dir", str(ctx.tmp / "model"),
            "--data_root", str(ctx.tmp / "data"),
            "--seed", str(ctx.program_seed)]
    return cli.get_args(argv)


class Sweep:
    """The predictor, its device sweeps timed to their host result and
    the merged probabilities of chosen calls kept; a call of the predictor
    itself (the host loop's) is counted."""

    def __init__(self, pred, keep=()):
        self.pred, self.keep = pred, set(keep)
        self.device = pred.device
        self.calls, self.seconds, self.kept = 0, 0.0, {}
        self.overflows, self.host_calls = 0, 0

    def __call__(self, feats):
        self.host_calls += 1
        return self.pred(feats)

    def sweep_case(self, case, prior_case, context=None):
        with torch.profiler.record_function("portbench.predict"):
            t = time.perf_counter()
            out, n = self.pred.sweep_case(case, prior_case, context)
            self.seconds += time.perf_counter() - t
        if out is None:
            self.overflows += 1
        elif self.calls in self.keep:
            self.kept[self.calls] = np.array(out, copy=True)
        self.calls += 1
        return out, n


def build(ctx, args):
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.volume import EvaluateVolume
    from boxsegliver_torch.interactive.device_sweep import \
        GuidedSweepPredictor
    from boxsegliver_torch.models import build_model, get_model_params

    from portbench import data as data_mod

    cfg = ctx.config
    ds = data_mod.make_dataset(
        Path(args.data_root) / args.dataset, cfg["data"], ctx.seed,
        ctx.device, train_cases=0, test_cases=int(cfg["cases"]["test"]),
        k_folds=int(args.k_folds), test_fold=int(args.test_fold),
        hist_modes=("eval",), prior=True)
    p = get_model_params(args)
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    model = build_model(p["model"], args=args, model_kwargs=p["model_kwargs"],
                        dtype=dtype)
    model.load_state_dict(model_weights(ctx), strict=True)
    model = model.to(ctx.device).eval()
    evaluator = EvaluateVolume(args, ds, ["Background"] + list(args.classes))
    fg = [c for c in args.classes if c != "Background"]
    tumor_id = fg.index("Tumor") + 1 if "Tumor" in fg else len(fg)
    predictor = GuidedSweepPredictor(model, args, num_classes=len(fg) + 1,
                                     tumor_id=tumor_id, device=ctx.device)
    prior = json.loads((Path(ds) / "prior.json").read_text())
    return model, evaluator, predictor, cli._test_metas(args, ds), ds, prior


def model_weights(ctx) -> Dict[str, torch.Tensor]:
    from portbench import weights

    t = ctx.traffic
    return weights.liver_margin(weights.make(ctx.config, ctx.seed, ctx.device),
                                float(t["head_scale"]),
                                float(t["liver_margin"]))


def window(ev, sweep, metas, prior, seconds=None, cases=None):
    """Whole cases back to back; returns (per-case results, slices,
    seconds, per-case walls)."""
    results, walls, slices = [], [], 0
    with torch.profiler.record_function("portbench.window"):
        t0 = time.perf_counter()
        while True:
            meta = metas[len(results) % len(metas)]
            t1 = time.perf_counter()
            with torch.profiler.record_function("portbench.case"):
                results.append(ev.run_g(sweep, [meta], prior=prior))
            walls.append(time.perf_counter() - t1)
            slices += int(meta["size"][0])
            if (cases is not None and len(results) >= cases) or (
                    seconds is not None
                    and time.perf_counter() - t0 >= seconds):
                break
        dt = time.perf_counter() - t0
    return results, slices, dt, walls


def case_work(ctx, ds, metas, done: int):
    """(forward FLOPs, least B2 seconds) the configured algorithm needs
    for the first ``done`` cases of the window: each of a case's cropped
    slices, in both sweeps, for each mirror (portbench.flops)."""
    from portbench import flops
    from portbench.reference.sweep import aligned_crop

    shape = flops.input_shape(ctx.config)
    macs = flops.work(ctx.config, shape)[0]
    depth = {}
    for m in metas:
        lab = np.load(Path(ds) / f"volume-{m['PID']}" / "segmentation.npy")
        z1, z2 = aligned_crop(lab)[:2]
        depth[int(m["PID"])] = z2 - z1
    images = sum(depth[int(metas[i % len(metas)]["PID"])]
                 for i in range(done)) * 2 * MIRRORS
    return (2.0 * macs * images,
            flops.b2_min_seconds(ctx.config, shape, images, False))


def measure(ctx) -> Dict:
    args = program_args(ctx)
    model, ev, pred, metas, ds, prior = build(ctx, args)
    warm = Sweep(pred)
    t = time.perf_counter()
    window(ev, warm, metas, prior, cases=len(metas))          # warm-up
    per_case = (time.perf_counter() - t) / len(metas)
    ctx.setup_done()
    expected = (int(ctx.traffic["trace_cases"]) if ctx.trace
                else max(1, int(ctx.seconds / per_case)))
    rng = np.random.default_rng([ctx.seed, 0x5EE9])
    keep = sorted(rng.choice(expected, size=min(SAMPLE, expected),
                             replace=False).tolist())
    sweep = Sweep(pred, keep)
    if ctx.trace:
        with ctx.profiler() as prof:
            results, slices, secs, walls = window(
                ev, sweep, metas, prior, cases=int(ctx.traffic["trace_cases"]))
        records = ctx.reduce(prof)
    else:
        results, slices, secs, walls = window(ev, sweep, metas, prior,
                                              seconds=ctx.seconds)
        records = None
    peak = ctx.memory_peak()
    failed_host = warm.overflows + warm.host_calls + sweep.overflows \
        + sweep.host_calls
    del model, pred, warm, sweep.pred
    ctx.free()
    out = {"attempted": len(results), "memory_peak_bytes": peak,
           "e2e": {"eval_slices_per_s": slices / secs}}
    if records is not None:
        fl, b2 = case_work(ctx, ds, metas, len(results))
        records.update(
            units=len(results), slices=slices, traced_s=secs,
            predict_s=sweep.seconds, case_s=sum(walls),
            b2_min_s_per_unit=b2 / len(results),
            flops_per_unit=fl / len(results))
        out["records"] = records
    ref = Reference(ctx, ds, metas, prior)
    out["compared"], tumour = compare(ref, sweep.kept, results,
                                      list(args.classes))
    out["failed"] = min(len(results), failed_host + tumour)
    return out


class Reference:
    """The reference's float32 probabilities of a case, by window
    position."""

    def __init__(self, ctx, ds, metas, prior):
        from portbench.reference import nets

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.net = nets.build(ctx.config).to(ctx.device)
        self.net.load_state_dict(model_weights(ctx))
        self.ctx, self.ds, self.metas, self.prior = ctx, Path(ds), metas, \
            prior

    def case(self, pos: int):
        from portbench.reference import sweep

        pid = int(self.metas[pos % len(self.metas)]["PID"])
        return pid, sweep.load_case(self.ds, pid)

    def probs(self, pos: int, quant=None, guides=True):
        from portbench.reference import nets, sweep

        pid, (vol, lab) = self.case(pos)
        return sweep.case_probs(self.net, vol, lab, self.prior.get(str(pid)),
                                self.ctx.config["settings"], self.ctx.device,
                                nets.Ops(quant), guides=guides)


def compare(ref: Reference, kept: Dict[int, np.ndarray], results, classes):
    """({"sweep_gap", "class_gap", "metric_gap"}, the kept cases in which
    either side predicted a tumour voxel)."""
    from portbench.reference import sweep

    gap, classes_off, metric, tumour = 0.0, 0, 0.0, 0
    for pos, probs in kept.items():
        want, seen = ref.probs(pos)
        got = torch.from_numpy(probs).to(want.device)
        d = min(len(got), len(want))
        qr, qp = sweep.log_odds(want[:d]), sweep.log_odds(got[:d])
        gap = max(gap, float((qp - qr).abs().max() / qr.abs().max()))
        classes_off += int((got[:d].argmax(-1) != want[:d].argmax(-1)).sum()
                           ) + abs(len(got) - len(want)) * int(
                               np.prod(got.shape[1:3]))
        tumour += int(seen or bool((got.argmax(-1) == 2).any()))
        if results is not None:
            _, (_, lab) = ref.case(pos)
            mine = sweep.case_metrics(probs, lab, classes)
            metric = max([metric] + [abs(results[pos][k] - v)
                                     for k, v in mine.items()])
        del want, got, qr, qp
    return {"sweep_gap": gap, "class_gap": float(classes_off),
            "metric_gap": metric}, tumour


def calibrate(ctx, controls: bool) -> Dict[str, Dict[str, float]]:
    """The program's readings on every test case once, and with
    ``controls`` the control's (the reference in float8 operands) and
    three planted faults' (an answer altered where it is produced: a slab
    of slices with the Tumour and Background probabilities swapped; a
    stale answer: the previous case's probabilities; the sweep without
    the user's guides)."""
    args = program_args(ctx)
    model, ev, pred, metas, ds, prior = build(ctx, args)
    sweep = Sweep(pred, range(len(metas)))
    results = window(ev, sweep, metas, prior, cases=len(metas))[0]
    del model, pred, sweep.pred
    ctx.free()
    ref = Reference(ctx, ds, metas, prior)
    classes = list(args.classes)
    rows = {"program": compare(ref, sweep.kept, results, classes)[0]}
    if controls:
        keep = sweep.kept
        rows["control_fp8"] = compare(ref, {
            p: ref.probs(p, "fp8")[0].cpu().numpy() for p in keep},
            None, classes)[0]
        altered = {}
        for p, probs in keep.items():
            a = probs.copy()
            n = max(1, len(a) // 8)
            a[:n] = a[:n][..., [2, 1, 0]]
            altered[p] = a
        rows["fault_altered_answer"] = compare(ref, altered, None,
                                               classes)[0]
        stale = {p: keep[(p - 1) % len(keep)] for p in keep}
        rows["fault_stale_answer"] = compare(ref, stale, None, classes)[0]
        rows["fault_no_guide"] = compare(ref, {
            p: ref.probs(p, guides=False)[0].cpu().numpy() for p in keep},
            None, classes)[0]
    return rows
