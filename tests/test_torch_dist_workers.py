"""Rank processes of the port's data-parallel tests
(tests/test_torch_dist_{train,eval}.py); this module holds no test.
``boxsegliver_torch.parallel.launch`` spawns them; like every process of
the port they import torch and the port only, never JAX.  Each returns
rank 0's results as numpy arrays; ``group=None`` runs the same code as one
process over the global batch."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models import build_model
from boxsegliver_torch.train.trainer import Trainer

CLASSES = ["Background", "Liver", "Tumor"]


def _rank_process(group):
    """Set up a spawned rank: one thread, and no TensorBoard.  The ranks
    read no TensorBoard events; without its import (which pulls TensorFlow
    in where it is installed: seconds a process) the summaries go to
    metrics.jsonl alone (utils/summary.py).  The test process itself
    (group None) is left as it is."""
    if group is not None:
        torch.set_num_threads(1)
        sys.modules.setdefault("torch.utils.tensorboard", None)


def _args(argv):
    parser = tconfig.build_parser()
    args = parser.parse_args(argv)
    tconfig.check_args(args, parser)
    return args


def _same_on_every_rank(group, model) -> float:
    """Largest difference between rank 0's parameters and buffers and any
    other rank's (0.0 without a group)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in
                      model.state_dict().values()]).numpy()
    if group is None:
        return 0.0
    parts = group.gather_to_chief(flat)
    if parts is None:
        return 0.0
    return float(max(np.abs(p - parts[0]).max() for p in parts))


def train_rank(group, spec):
    """Train steps of the port on the rank's rows of a global batch.

    spec: ``argv`` (config flags), ``model`` and ``kw`` (build_model),
    ``state`` (a state_dict to start from), ``steps``; and either ``feats``
    (global features and labels, handed to the step as they are: no draws)
    or ``raw`` (a global raw batch for data/pipeline.make_preprocess_fn,
    whose draws are on).  Returns the gradients and losses of a first
    gradient call (``feats`` only), the step losses, the state_dict after
    the steps and the ranks' largest disagreement."""
    _rank_process(group)
    args = _args(spec["argv"])
    model = build_model(spec["model"], args=args, model_kwargs=spec["kw"],
                        dtype=torch.float32)
    model.load_state_dict(spec["state"], strict=True)
    out = {}
    if "feats" in spec:
        feats = {k: torch.from_numpy(v) for k, v in spec["feats"].items()}
        labels = torch.from_numpy(spec["labels"]).long()
        n = labels.shape[0]
        if group is not None:
            feats, labels = group.take_rows(feats), labels[group.rows(n)]
        trainer = Trainer(model, args, CLASSES, "cpu", group=group,
                          preprocess_fn=lambda batch, gen: (feats, labels))
        grads, total, data, _ = trainer.gradients(feats, labels)
        out["grads"] = {k: g.detach().numpy().copy()
                        for k, g in zip(trainer.param_names, grads)}
        out["total"], out["data"] = float(total), float(data)
        # the gradient call ran a train-mode forward: start the steps from
        # the given running statistics
        model.load_state_dict(spec["state"], strict=True)
        raw = {"names": np.zeros((n,), np.int32)}
    else:
        from boxsegliver_torch.data.pipeline import make_preprocess_fn
        trainer = Trainer(model, args, CLASSES, "cpu", group=group,
                          preprocess_fn=make_preprocess_fn(args,
                                                           group=group))
        raw = spec["raw"]
    losses = []
    for _ in range(spec["steps"]):
        vals, _ = trainer.train_step(raw)
        losses.append(vals.numpy().copy())
    out["values"] = np.stack(losses)
    out["state"] = {k: v.numpy().copy() for k, v in
                    model.state_dict().items()}
    out["spread"] = _same_on_every_rank(group, model)
    return out


def eval_rank(group, spec):
    """``DeviceSlicePredictor.device_case`` of every case, then
    ``EvaluateVolume.run``, of a UNet with the given weights; rank 0's
    probabilities, results and per-case metrics."""
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor
    from boxsegliver_torch.evaluators.eval_loader import parse_case_eval
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    _rank_process(group)
    args = argparse.Namespace(**spec["args"])
    model = build_model("UNet", model_kwargs=spec["kw"], num_classes=3,
                        dtype=torch.float32)
    model.load_state_dict(spec["state"], strict=True)
    pred = DeviceSlicePredictor(model, args, "cpu", group=group)
    metas = load_meta(spec["ds"])
    probs = [pred.device_case(parse_case_eval(m, spec["ds"], im_channel=3))
             for m in metas]
    ev = EvaluateVolume(args, spec["ds"], CLASSES, group=group)
    results = ev.run(pred, metas)
    return {"probs": probs, "results": results,
            "per_case": {k: list(v) for k, v in ev._metric_values.items()}}


def refine_rank(group, spec):
    """``DeviceRefiner2D.refine_case`` of a UNetInter with the given
    weights, per guide kind; the rounds each rank ran."""
    from boxsegliver_torch.interactive.device_refine import DeviceRefiner2D

    _rank_process(group)
    model = build_model("UNetInter", model_kwargs=spec["kw"], num_classes=2,
                        dtype=torch.float32)
    model.load_state_dict(spec["state"], strict=True)
    model.eval()
    out = {}
    for kind in spec["kinds"]:
        refiner = DeviceRefiner2D(model, device="cpu", mesh=group,
                                  guide_kind=kind, **spec["kw_refine"])
        res = refiner.refine_case(spec["images"], spec["labels"])
        rounds = [refiner.rounds]
        if group is not None:
            rounds = group.gather_to_chief(refiner.rounds)
        out[kind] = dict(res, rounds=rounds)
    return out
