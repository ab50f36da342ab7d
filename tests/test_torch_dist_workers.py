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


# ---------------------------------------------------------------------------
# spatial sharding (tests/test_torch_spatial_ops.py)
# ---------------------------------------------------------------------------

def _sharded_case(group, name, x, unit):
    """Op ``name`` of the spatial-ops test on this rank's block of x (NC*,
    sharded along axis 2, or NHWC along axis 1 for ``image_gradients``),
    the rank's result gathered whole, and the unsharded op on the whole
    x.  Weights come from torch.manual_seed(0), the same on every rank."""
    import torch.nn.functional as F

    from boxsegliver_torch.models import layers
    from boxsegliver_torch.ops.image_ops import zscore
    from boxsegliver_torch.ops.kernels import (instance_norm_relu,
                                               instance_norm_relu_split,
                                               modnorm_relu_split,
                                               modulated_norm_relu)
    from boxsegliver_torch.parallel.spatial import SpatialShard

    torch.manual_seed(0)
    if name.endswith("_bf16"):
        x = x.bfloat16()
    dim = 1 if name in ("image_gradients", "zscore") else 2
    shard = SpatialShard(group)
    blk = group.block(x.shape[dim], unit)
    local = x.narrow(dim, blk.start, blk.stop - blk.start).contiguous()
    gather_dim = dim

    def both(whole, sharded):
        return whole(x), sharded(local)

    if name.startswith("conv"):
        # conv<k>_s<s> (2-D) or conv3_<kd><kh><kw>_s<sd><sh><sw> (3-D)
        if x.ndim == 4:
            k, s = (int(v) for v in name[4:].split("_s"))
            mod = layers.Conv(x.shape[1], 5, k, stride=s)
        else:
            ks, ss = name[6:].split("_s")
            mod = layers.Conv3(x.shape[1], 5, tuple(int(c) for c in ks),
                               stride=tuple(int(c) for c in ss))
        torch.nn.init.normal_(mod.bias)
        whole = mod(x)
        mod.spatial = shard
        part = mod(local)
    elif name == "max_pool":
        whole, part = both(lambda t: layers.max_pool2x2(t, "SAME"),
                           lambda t: layers.max_pool2x2(t, "SAME"))
    elif name == "avg_pool":
        whole, part = both(layers.avg_pool_same, layers.avg_pool_same)
    elif name == "upconv":
        mod = layers.UpConv(x.shape[1], 3)
        torch.nn.init.normal_(mod.weight)
        whole, part = both(mod, mod)
    elif name == "image_gradients":
        whole = torch.cat(layers.image_gradients(x), -1)
        part = torch.cat(shard.image_gradients(local), -1)
    elif name == "in_relu":
        w = torch.randn(x.shape[1])
        b = torch.randn(x.shape[1])
        whole = instance_norm_relu(x, w, b)
        part = instance_norm_relu_split(local, w, b, group)
    elif name == "modnorm":
        c = x.shape[1]
        gamma = torch.randn(x.shape[0], c)
        sp = torch.randn_like(x)
        b = torch.randn(c)
        whole = modulated_norm_relu(x, gamma, sp, None, b)
        part = modnorm_relu_split(
            local, gamma, sp.narrow(dim, blk.start, blk.stop - blk.start),
            None, b, group)
    elif name.startswith("norm_"):
        scale = name == "norm_full"
        mod = layers.Norm("instance_norm", x.shape[1], use_bias=True,
                          use_scale=scale)
        torch.nn.init.normal_(mod.bias)
        if scale:
            torch.nn.init.normal_(mod.weight)
        whole = mod(x)
        mod.spatial = shard
        part = mod(local)
    elif name == "zscore":
        whole, part = both(zscore, shard.zscore)
    elif name.startswith("halo"):
        # one row before, two after, zeros past the global edges: every
        # rank's error summed over the ranks
        padded = F.pad(x, (0, 0, 1, 2))
        want = padded[:, :, blk.start:blk.stop + 3]
        err = (group.halo(local, 2, 1, 2).float() - want.float()).abs().max()
        whole = torch.zeros(())
        part = group.all_reduce_(err.reshape(1))[0]
        gather_dim = None
    elif name == "mean":
        whole, part = x.mean(dim=tuple(range(2, x.ndim))), shard.mean(local)
        gather_dim = None
    else:
        raise ValueError(name)
    if gather_dim is not None:
        # the rank's output block: its input block scaled by the op's
        # stride (start exact, the ragged stop rounded up)
        f = whole.shape[gather_dim] / x.shape[dim]
        start = int(blk.start * f)
        buf = torch.zeros_like(whole)
        buf.narrow(gather_dim, start, part.shape[gather_dim]).copy_(part)
        part = group.all_reduce_(buf)
    return whole, part


def spatial_ops_rank(group, spec):
    """Every case of ``spec["cases"]`` ({key: (op, x, unit)}) sharded over
    the group; rank 0's (whole, gathered) pairs and every rank's largest
    difference from rank 0's gathered result."""
    _rank_process(group)
    out = {}
    with torch.no_grad():
        for key, (name, x, unit) in spec["cases"].items():
            whole, part = _sharded_case(group, name, torch.from_numpy(x),
                                        unit)
            ref = group.broadcast_(part.clone())
            spread = float((part - ref).abs().max())
            out[key] = (whole.numpy(), part.numpy(), spread)
    return out


def _same_everywhere(group, arrays):
    """Largest difference between any rank's arrays and rank 0's."""
    if group is None:
        return 0.0
    worst = 0.0
    for a in arrays:
        if a is None:                   # an overflow: every rank's count
            continue
        t = torch.as_tensor(np.ascontiguousarray(a)).double()
        ref = group.broadcast_(t.clone())
        worst = max(worst, float((t - ref).abs().max()))
    return worst


def sweep_rank(group, spec):
    """``GuidedSweepPredictor(group=...).sweep_case`` of every case, then
    ``EvaluateVolume.run_g``, of a GUNet with the given weights: rank 0's
    merged volumes, object counts, results and per-case metrics, and the
    ranks' largest disagreement (volumes, counts and steps)."""
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.eval_loader import parse_case_eval
    from boxsegliver_torch.evaluators.volume import EvaluateVolume
    from boxsegliver_torch.interactive.device_sweep import \
        GuidedSweepPredictor

    _rank_process(group)
    args = argparse.Namespace(**spec["args"])
    model = build_model("GUNet", model_kwargs=spec["kw"], num_classes=3,
                        dtype=torch.float32)
    model.load_state_dict(spec["state"], strict=True)
    pred = GuidedSweepPredictor(model, args, num_classes=3, tumor_id=2,
                                device="cpu", group=group)
    ev = EvaluateVolume(args, spec["ds"], CLASSES, group=group)
    metas = load_meta(spec["ds"])
    vols, counts = [], []
    for m in metas:
        case = parse_case_eval(m, spec["ds"], im_channel=3)
        ctx = spec.get("contexts", {}).get(case.pid)
        vol, n_max = pred.sweep_case(case, spec["prior"][str(case.pid)], ctx)
        vols.append(vol)
        counts.append(n_max)
    out = {"vols": vols, "counts": counts,
           "spread": _same_everywhere(group, vols + [
               np.asarray(counts), np.asarray([pred.steps])])}
    if spec.get("run_g", True):
        out["results"] = ev.run_g(pred, metas)
        out["per_case"] = {k: list(v) for k, v in ev._metric_values.items()}
    return out


def volume3d_rank(group, spec):
    """``make_volume_predict(group, z_axis_shards)`` on every volume of
    ``spec["volumes"]`` (or of ``spec["inputs"][form]``) for each form of
    ``spec["forms"]`` (a refusal as its text), then
    ``EvaluateVolume3D.run`` of each form over ``spec["ds"]``: rank 0's
    outputs, results and per-case metrics, and the ranks' largest
    disagreement."""
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.volume3d import (EvaluateVolume3D,
                                                       make_volume_predict)

    _rank_process(group)
    args = argparse.Namespace(**spec["args"])
    model = build_model("UNet3D", model_kwargs=spec["kw"], num_classes=2,
                        dtype=torch.float32)
    model.load_state_dict(spec["state"], strict=True)
    model.eval()
    shards = 0 if group is None else group.size
    out = {"outputs": {}, "spread": 0.0}
    for name, form in spec["forms"].items():
        predict = make_volume_predict(model, "cpu", group=group,
                                      z_axis_shards=shards, **form)
        outs = []
        vols = (spec["inputs"][name] if spec.get("inputs")
                else spec["volumes"])
        for vol in vols:
            try:
                outs.append(predict({"images": vol}))
            except ValueError as e:
                outs.append(str(e))
        out["outputs"][name] = outs
        out["spread"] = max(out["spread"], _same_everywhere(
            group, [o for o in outs if not isinstance(o, str)]))
    if spec.get("ds") is not None:
        out["results"], out["per_case"] = {}, {}
        for name, form in spec["forms"].items():
            predict = make_volume_predict(model, "cpu", group=group,
                                          z_axis_shards=shards, **form)
            ev = EvaluateVolume3D(args, spec["ds"], ["Background", "NF"],
                                  group=group)
            out["results"][name] = ev.run(predict, load_meta(spec["ds"]))
            out["per_case"][name] = {k: list(v) for k, v in
                                     ev._metric_values.items()}
    return out
