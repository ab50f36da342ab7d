"""Training loop of the port on one GPU (port of
boxsegliver_tpu/train/trainer.py:76-198,215-521; reference
core/estimator.py:490-758, core/models.py:224-281, core/solver.py:221-243).

- One train step: raw host batch in the staging buffers → device
  augmentation (data/pipeline.make_preprocess_fn, guide render = kernel B1)
  → forward in the compute dtype (every full-affine instance-norm + ReLU
  pair = kernel B2; batch norm moves its running statistics once per
  train-mode forward, as flax's ``mutable=["batch_stats"]`` does) → loss
  (ops/losses.py) → backward → L2 term → optimizer update (train/solver.py).
  The running statistics are module buffers: they ride the model's
  state_dict into the checkpoints, resume and warm start.
- A dispatch runs K = ``--steps_per_dispatch`` steps (JAX: a lax.scan over K
  stacked batches, trainer.py:179-198).  Its K raw batches and its K rows
  [lr, c1, c2] (computed on the host in float32, train/solver.py) are
  copied into device buffers — through pinned memory, non-blocking, on the
  card — and each step reads row ``ctr`` of them, a device counter it
  advances.  On CUDA with K > 1 the step is captured once per metric
  variant into a CUDA graph (after warm-up steps on a side stream) and a
  dispatch replays it K times: B1 and B2 run inside the graph.  The
  trainer's generator is registered with each graph, so every replay draws
  fresh noise, flips and dropout masks.  A failed capture or replay
  raises; nothing falls back to eager steps.  On the CPU, and for K = 1,
  the same step runs eagerly.
- The kernels' launch counters count on the host; a replay adds what its
  capture recorded (and the capture itself counts nothing).
- Host spans (utils/trace.py, recorded only under a running profiler):
  ``boxseg.train.stage`` around the staging, its wait on a pinned set's
  event included; ``.replay``, ``.step`` and ``.capture`` around each graph
  replay, eager step and capture; ``.values`` around the values' clone.
  None sits inside ``_step``: a graph captures it once and replays it.
- The L2 term 0.5·wd·Σw² is added to the loss value, and its gradient wd·w
  to the decayed tensors' gradients, without going through autograd.
- Metric tensors stay on the device; every ``fetch_every`` steps (and at an
  epoch boundary or the end) one bulk copy brings the window to the host,
  whose hooks (loss mean, plateau LR, NaN/Inf abort, speed log, summaries)
  replay it step by step in order, as the JAX package's drain does.  Under
  K > 1 the epoch eval is quantized to K, the plateau lr_scale changes
  only between dispatches, and the last steps short of K run as
  single-step dispatches.
- Train metrics (<Class>/<Metric>) are computed on the logging cadence only
  (--metrics_train_steps, 0 = --log_step), zeros otherwise: two captured
  variants of the step, as the JAX package's lax.cond.
- Randomness (augmentation draws, dropout masks) comes from one
  torch.Generator on the device, seeded from --seed and saved in the
  checkpoints.
- ``--load_weights`` with ``--weights_scope "old=new[,…]"`` renames the
  source's top-level scopes before the partial restore (JAX
  trainer.py:335-343).

Data parallel (``group``: a parallel.Group, one rank a process; JAX's
trainer over a mesh, trainer.py:221-263).  A step of N ranks is the step of
one process over the global batch (--batch_size, which must divide N):

- every rank stages its rows [r·b, (r+1)·b) of the same global batch (the
  same seeded sampler stream on every rank), the preprocess draws the
  global batch's noise, flips and gamma from the generator they share and
  keeps the rank's rows, and dropout draws its masks likewise
  (parallel.mesh.RankGenerator);
- batch norm normalizes with the global batch's statistics
  (layers.sync_batch_norm); the loss is the rank's share of the global
  loss (global normalizers, ops/losses.py), so the ranks' gradients sum
  to the global gradient: after backward one all-reduce sums a flat
  float32 buffer (allocated once) holding every gradient and the data
  loss, the gradients are views of it; the L2 term and its gradient are
  added after it, once; the train metrics are global means
  (ops/metrics.build_train_metrics);
- rank 0 writes checkpoints, summaries and sidecars and keeps the
  plateau LR and the best checkpoint; the other ranks wait at a barrier
  after each write, and the plateau's lr_scale and stop flag are
  broadcast from rank 0 at each drain; a restore reads the same file on
  every rank, then rank 0's weights are broadcast;
- ``predict`` runs the rank's rows of a feature batch and gathers the
  probabilities of the whole batch on every rank;
- K > 1: under NCCL the all-reduces are captured in the CUDA graph; a
  gloo collective cannot be captured, so under gloo the K steps of a
  dispatch run eagerly (logged once).

A group of one rank keeps the local batch statistics and loss and runs the
flat all-reduce (the identity): under NCCL, the step graphed with its
collective.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from boxsegliver_torch.models.layers import sync_batch_norm
from boxsegliver_torch.ops import losses as losses_mod
from boxsegliver_torch.ops import metrics as metrics_mod
from boxsegliver_torch.parallel.mesh import (RankGenerator,
                                             per_device_batch_size)
from boxsegliver_torch.train.checkpoint import (CheckpointManager, load_state,
                                                warm_start)
from boxsegliver_torch.train.hooks import (AverageMeter, BestKeeper,
                                           BestKeeperMA, ReduceLROnPlateau,
                                           SpeedLogger)
from boxsegliver_torch.train.solver import Optimizer, make_lr_fn
from boxsegliver_torch.utils.summary import SummaryWriter
from boxsegliver_torch.utils.trace import span

logger = logging.getLogger("boxsegliver")

# eager steps before the first capture of a graphed trainer (PyTorch's
# whole-network capture recipe: lazy library set-up and the staged B2-fwd's
# shared-memory attribute happen outside any capture)
WARMUP_STEPS = 3


def make_loss_fn(args, group=None):
    """Data loss of --loss_type / --loss_weight_type (reference _build_loss,
    NetworksV2/GUNet.py:394-413); under a group the rank's share of the
    global batch's."""
    w_params = {}
    if args.loss_weight_type == "numerical":
        w_params["numeric_w"] = args.loss_numeric_w
    elif args.loss_weight_type == "proportion":
        w_params["proportion_decay"] = args.loss_proportion_decay
    return losses_mod.make_loss_fn(args.loss_type, args.loss_weight_type,
                                   group=group, **w_params)


def warm_start_source(args) -> Tuple[Optional[str], Optional[Dict]]:
    """What a run with no periodic checkpoint starts from (reference
    core/estimator.py:249-253, core/models.py:160-185): (path, scope_map)
    of --warm_start_from, else of --load_weights with the renames of
    --weights_scope "old=new[,…]"; a ``.h5`` --load_weights is the
    DenseNet-161 ImageNet file, taken as it is (checkpoint.warm_start
    imports it; JAX trainer.py:319-333); (None, None) when neither is
    given."""
    src = getattr(args, "warm_start_from", None)
    scope_map = None
    if not src and getattr(args, "load_weights", None):
        src = args.load_weights
        if src.endswith(".h5"):
            return src, None
        raw = getattr(args, "weights_scope", None)
        if raw:  # "old=new[,old2=new2]" top-level scope renames
            scope_map = dict(pair.split("=", 1)
                             for pair in raw.split(",") if "=" in pair)
    if not src:
        return None, None
    return _resolve_load_weights(args, src), scope_map


def _resolve_load_weights(args, spec: str) -> str:
    """An explicit path, or a sibling experiment tag under model_dir's
    parent: its best checkpoint, else its latest periodic one."""
    p = Path(spec)
    if p.exists():
        return str(p)
    sibling = CheckpointManager(Path(args.model_dir).parent / spec)
    version = getattr(args, "load_weights_version", "checkpoint")
    tag = "best" if version == "checkpoint" else version
    if sibling.has_best(tag):
        return str(sibling.best_path(tag))
    if sibling.latest_path() is not None:
        return str(sibling.latest_path())
    raise FileNotFoundError(f"--load_weights {spec!r}: no checkpoint at "
                            f"{p} or {sibling.model_dir}")


class Trainer:
    """Owns the model, optimizer, generator, checkpoints and host hooks
    (the reference CustomEstimator.train loop)."""

    def __init__(self, model: torch.nn.Module, args, classes: Sequence[str],
                 device, preprocess_fn=None, save_ckpt_steps: int = 5000,
                 group=None):
        self.group = group
        self.chief = group is None or group.chief
        if group is not None:
            per_device_batch_size(int(args.batch_size), group.size)
            sync_batch_norm(model, group)
        self.steps_per_dispatch = max(1, int(getattr(args,
                                                     "steps_per_dispatch", 1)))
        if self.steps_per_dispatch > 1 and preprocess_fn is None:
            raise ValueError("--steps_per_dispatch > 1 requires the device "
                             "preprocess (preprocess_fn)")
        self.args = args
        self.classes = list(classes)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.preprocess_fn = preprocess_fn
        seed = int(getattr(args, "seed", 1234))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._model_rng = (self.generator if group is None
                           else RankGenerator(self.generator, group))

        named = list(self.model.named_parameters())
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optimizer = Optimizer(args, self.params)
        self.lr_fn = make_lr_fn(args)
        self.lr_scale = 1.0
        self.data_loss_fn = make_loss_fn(args, group)
        self.weight_decay = float(args.weight_decay_rate)
        self.use_reg = (args.optimizer.lower() != "adamw"
                        and self.weight_decay > 0)
        decayed = set(losses_mod.decayed_parameters(
            self.model, bool(getattr(args, "bias_decay", False))))
        self.decayed_idx = [i for i, n in enumerate(self.param_names)
                            if n in decayed]

        self.metric_names = list(getattr(args, "metrics_train", ["Dice"]))
        every = int(getattr(args, "metrics_train_steps", 0) or 0)
        self.metrics_every = (every if every > 0
                              else max(1, int(getattr(args, "log_step", 1))))
        self.metric_keys = [f"{self.classes[i]}/{m}"
                            for i in range(1, len(self.classes))
                            for m in self.metric_names]
        self._zeros = torch.zeros(len(self.metric_keys), device=self.device)
        self._host_step = 0
        # staging buffers of a dispatch (made at the first one, see _stage)
        # and the captured step variants {metrics: (graph, launches)}
        self._spec = None
        self._graphs: Dict[bool, tuple] = {}
        self._graphed = self.device.type == "cuda" and \
            self.steps_per_dispatch > 1
        if self._graphed and group is not None and group.backend != "nccl":
            self._graphed = False
            logger.info("--steps_per_dispatch %d under a %s group: its "
                        "collectives cannot be captured in a CUDA graph, so "
                        "the %d steps of a dispatch run eagerly",
                        self.steps_per_dispatch, group.backend,
                        self.steps_per_dispatch)
        self._warm = 0
        self._flat = None           # the flat gradient buffer of a group
        self._stop = False          # the plateau's stop (rank 0's, broadcast)

        self.ckpt = CheckpointManager(args.model_dir,
                                      save_interval_steps=save_ckpt_steps)
        self.loss_meter = AverageMeter()
        self.speed = SpeedLogger(log_step=args.log_step)
        self.summary = SummaryWriter(
            Path(args.model_dir) / "summaries",
            prefix=getattr(args, "summary_prefix", "") or "") \
            if self.chief else None
        self.plateau: Optional[ReduceLROnPlateau] = None
        if args.learning_policy == "plateau":
            self.plateau = ReduceLROnPlateau(
                args.model_dir,
                lr_patience=args.lr_patience,
                tr_patience=getattr(args, "tr_patience", 0) or args.lr_patience * 2,
                min_delta=args.min_delta,
                decay_rate=args.lr_decay_rate,
                min_lr_scale=args.lr_end / args.learning_rate)
            self.lr_scale = float(self.plateau.lr_scale)
        self.best_keeper: Optional[BestKeeper] = None
        if self.chief and getattr(args, "save_best", False) and \
                getattr(args, "primary_metric", None):
            if getattr(args, "save_best_ma", False):
                self.best_keeper = BestKeeperMA(
                    args.model_dir, args.primary_metric,
                    getattr(args, "secondary_metric", None),
                    save_interval=getattr(args, "save_interval", 0),
                    ma_alpha=getattr(args, "ma_alpha", 0.9))
            else:
                self.best_keeper = BestKeeper(
                    args.model_dir, args.primary_metric,
                    getattr(args, "secondary_metric", None),
                    save_interval=getattr(args, "save_interval", 0))

    # -- state -------------------------------------------------------------
    def state(self) -> Dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self._host_step, "lr_scale": self.lr_scale,
                "generator": self.generator.get_state()}

    def restore(self) -> int:
        """Resume from the latest periodic checkpoint if present; else warm
        start from --warm_start_from / --load_weights (reference
        core/estimator.py:249-253, core/models.py:160-185)."""
        path = self.ckpt.latest_path()
        if path is not None:
            state = load_state(path)
            self.model.load_state_dict(state["model"], strict=True)
            self.optimizer.load_state_dict(state["optimizer"])
            self.lr_scale = float(state["lr_scale"])
            self.generator.set_state(state["generator"])
            self._host_step = int(state["step"])
        else:
            src, scope_map = warm_start_source(self.args)
            if src:
                n = warm_start(self.model, src, scope_map=scope_map)
                logger.info("Warm started %d tensors from %s (scope_map=%s)",
                            n, src, scope_map)
            self._host_step = 0
        if self.group is not None:
            self.group.broadcast_module(self.model)
        return self._host_step

    @property
    def global_step(self) -> int:
        return self._host_step

    # -- train -------------------------------------------------------------
    def gradients(self, features: Dict[str, torch.Tensor],
                  labels: torch.Tensor):
        """Forward in train mode, loss and backward: (gradients in
        ``self.params`` order, total loss, data loss, logits), the L2 term's
        value and gradient included.  Under a group the rank's rows give
        the global batch's gradients and losses (one all-reduce)."""
        logits = self.model(features, train=True, generator=self._model_rng)
        data_loss = self.data_loss_fn(logits, labels)
        grads = list(torch.autograd.grad(data_loss, self.params,
                                         allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        data_loss = data_loss.detach()
        if self.group is not None:
            grads, data_loss = self._all_reduce(grads, data_loss)
        total = data_loss
        if self.use_reg and self.decayed_idx:
            dec = [self.params[i] for i in self.decayed_idx]
            with torch.no_grad():
                total = total + losses_mod.l2_regularization(
                    dec, self.weight_decay)
                torch._foreach_add_([grads[i] for i in self.decayed_idx], dec,
                                    alpha=self.weight_decay)
        return grads, total, data_loss, logits.detach()

    def _all_reduce(self, grads, data_loss):
        """The ranks' gradients and data-loss shares summed in one
        all-reduce of a flat float32 buffer (allocated once); returns the
        gradients as views of it, and the global data loss."""
        if self._flat is None:
            n = sum(p.numel() for p in self.params)
            self._flat = torch.empty(n + 1, dtype=torch.float32,
                                     device=self.device)
            views, off = [], 0
            for p in self.params:
                views.append(self._flat[off:off + p.numel()].view(p.shape))
                off += p.numel()
            self._views = views
        torch._foreach_copy_(self._views, grads)
        self._flat[-1].copy_(data_loss)
        self.group.all_reduce_(self._flat)
        return list(self._views), self._flat[-1].clone()

    # -- dispatch ----------------------------------------------------------
    def _stage(self, batches: Sequence[Dict[str, np.ndarray]]) -> List[float]:
        """Copy the raw host batches and their schedule rows [lr, c1, c2]
        into the device buffers (on the card through pinned memory,
        non-blocking; two pinned sets in turn, each reused once its last copy
        has completed); returns the steps' learning rates.  Advances the
        optimizer's step count."""
        first = {k: v.view(np.int16) if v.dtype == np.uint16 else v
                 for k, v in batches[0].items()}
        spec = {k: (v.shape, v.dtype) for k, v in first.items()}
        if spec != self._spec:
            if self._graphs:
                raise ValueError("the raw batch layout changed after the "
                                 "train step was captured")
            self._alloc(spec)
        host, ready = self._host[self._turn], self._ready[self._turn]
        if ready is not None:
            ready.synchronize()
        lrs = []
        for i, batch in enumerate(batches):
            for k, buf in host["batch"].items():
                v = batch[k]
                buf[i].copy_(torch.from_numpy(
                    v.view(np.int16) if v.dtype == np.uint16 else v))
            lr = self.lr_fn(self._host_step + i, self.lr_scale)
            host["sched"][i].copy_(torch.from_numpy(
                self.optimizer.schedule(lr)))
            lrs.append(lr)
        if self.device.type == "cuda":
            n = len(batches)
            for k, buf in self._batch.items():
                buf[:n].copy_(host["batch"][k][:n], non_blocking=True)
            self._sched[:n].copy_(host["sched"][:n], non_blocking=True)
            self._ready[self._turn] = torch.cuda.Event()
            self._ready[self._turn].record()
            self._turn ^= 1
        return lrs

    def _alloc(self, spec):
        """Device buffers of K batches of layout ``spec`` (key -> (shape,
        numpy dtype)), K schedule rows and K value rows, the row counter,
        and their host sides (pinned on the card; on the CPU the device
        buffers themselves)."""
        k, dev = self.steps_per_dispatch, self.device
        dtypes = {key: torch.from_numpy(np.empty(0, dt)).dtype
                  for key, (_, dt) in spec.items()}
        self._spec = spec
        self._batch = {key: torch.empty((k,) + shape, dtype=dtypes[key],
                                        device=dev)
                       for key, (shape, _) in spec.items()}
        self._sched = torch.empty((k, 3), dtype=torch.float32, device=dev)
        self._out = torch.empty((k, 2 + len(self.metric_keys)),
                                dtype=torch.float32, device=dev)
        self._ctr = torch.zeros(1, dtype=torch.int64, device=dev)
        if dev.type == "cuda":
            self._host = [{"batch": {key: torch.empty(
                (k,) + shape, dtype=dtypes[key], pin_memory=True)
                for key, (shape, _) in spec.items()},
                "sched": torch.empty((k, 3), dtype=torch.float32,
                                     pin_memory=True)} for _ in range(2)]
        else:
            self._host = [{"batch": self._batch, "sched": self._sched}] * 2
        self._ready = [None, None]
        self._turn = 0

    def _step(self, metrics: bool):
        """One train step on the staged row ``ctr`` (device tensors only:
        this is what a CUDA graph captures); writes [total, data,
        *metrics] into row ``ctr`` of the value buffer and advances
        ``ctr``."""
        i = self._ctr
        batch = {k: v.index_select(0, i)[0] for k, v in self._batch.items()}
        features, labels = self.preprocess_fn(batch, self.generator)
        grads, total, data_loss, logits = self.gradients(features, labels)
        self.optimizer.apply(grads, self._sched.index_select(0, i)[0])
        if metrics:
            with torch.no_grad():
                probs = torch.softmax(logits, dim=-1)
                tm = metrics_mod.build_train_metrics(
                    probs, labels, self.classes, self.metric_names,
                    group=self.group)
                mvals = torch.stack([tm[k].float() for k in self.metric_keys])
        else:
            mvals = self._zeros
        vals = torch.cat([torch.stack([total, data_loss]), mvals])
        self._out.index_copy_(0, i, vals[None])
        self._ctr.add_(1)

    def _capture(self, metrics: bool):
        """Capture one step variant into a CUDA graph (the variants share
        one memory pool: they never run at once) with the trainer's
        generator registered; returns (graph, launches per replay)."""
        from boxsegliver_torch.ops.kernels import KERNELS

        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        pool = (next(iter(self._graphs.values()))[0].pool()
                if self._graphs else None)
        before = {n: fn.launches for n, fn in KERNELS.items()}
        with span("boxseg.train.capture"), torch.cuda.graph(graph, pool=pool):
            self._step(metrics)
        counts = {n: fn.launches - before[n] for n, fn in KERNELS.items()}
        for n, fn in KERNELS.items():
            fn.launches = before[n]          # capturing launches nothing
        self._graphs[metrics] = (graph, counts)
        logger.info("Captured the train step (metrics %s) in a CUDA graph: "
                    "kernel launches per replay %s", metrics, counts)
        return self._graphs[metrics]

    def _graph_step(self, metrics: bool):
        """The first WARMUP_STEPS steps run eagerly on a side stream (lazy
        library and kernel set-up happens outside any capture), then each
        step replays its captured variant."""
        from boxsegliver_torch.ops.kernels import KERNELS

        if self._warm < WARMUP_STEPS:
            with span("boxseg.train.step"):
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    self._step(metrics)
                torch.cuda.current_stream(self.device).wait_stream(side)
            self._warm += 1
            return
        graph, counts = self._graphs.get(metrics) or self._capture(metrics)
        with span("boxseg.train.replay"):
            graph.replay()
        for n, c in counts.items():
            KERNELS[n].launches += c

    def train_multi_step(self, raw_batches: Sequence[Dict[str, np.ndarray]]):
        """One dispatch of len(raw_batches) <= K steps; returns
        [(step, device values [total, data, *metrics], lr)] per step.
        Under a group each raw batch is the global one; the rank stages its
        rows."""
        if self.group is not None:
            raw_batches = [self.group.take_rows(b) for b in raw_batches]
        with span("boxseg.train.stage"):
            lrs = self._stage(raw_batches)
        self._ctr.zero_()
        first = self._host_step
        for j in range(len(raw_batches)):
            step = first + j + 1
            metrics = bool(self.metric_keys) and (
                step % self.metrics_every == 0 or step == 1)
            if self._graphed:
                self._graph_step(metrics)
            else:
                with span("boxseg.train.step"):
                    self._step(metrics)
        self._host_step += len(raw_batches)
        with span("boxseg.train.values"):
            out = self._out[:len(raw_batches)].clone()
        return [(first + j + 1, out[j], lr) for j, lr in enumerate(lrs)]

    def train_step(self, raw_batch: Dict[str, np.ndarray]):
        """One step on a raw host batch; returns ([total, data, *metrics]
        as one device tensor, lr)."""
        (_, vals, lr), = self.train_multi_step([raw_batch])
        return vals, lr

    def train(self, dataset, max_steps: int, eval_fn=None,
              batches_per_epoch: Optional[int] = None):
        """Main loop; eval_fn(trainer) -> metrics dict runs every
        batches_per_epoch steps (the reference's EvaluatorHook), quantized
        to the dispatch."""
        start = self.global_step
        if start >= max_steps:
            logger.info("Skipping training since max_steps has already saved.")
            return
        bpe = batches_per_epoch or self.args.batches_per_epoch
        fetch_every = max(1, min(int(self.args.log_step),
                                 int(getattr(self.args, "metrics_fetch_steps",
                                             0) or 16)))
        k = self.steps_per_dispatch
        step = start
        pending: List = []  # [(step, device values, lr)] awaiting one fetch
        stack: List = []    # raw batches awaiting a K-step dispatch
        for batch in iter(dataset):
            stack.append(batch)
            if len(stack) < min(k, max_steps - self.global_step):
                continue
            if len(stack) == k:
                pending += self.train_multi_step(stack)
            else:  # < K steps left: single-step remainders (exact stop)
                for b in stack:
                    pending += self.train_multi_step([b])
            stack = []
            prev, step = step, self.global_step
            at_epoch = eval_fn is not None and step // bpe > prev // bpe
            done = step >= max_steps
            if len(pending) >= fetch_every or at_epoch or done:
                self._drain(pending)
                pending = []
                if at_epoch:
                    self._run_eval(eval_fn, step)
            if done or self._stop:
                break
        self._drain(pending)
        self._save(self.global_step)

    def _save(self, step: int):
        """A periodic checkpoint, written by rank 0; under a group the other
        ranks wait for it."""
        if self.chief:
            self.ckpt.save(step, self.state())
        if self.group is not None:
            self.group.barrier()

    def _drain(self, pending):
        """One bulk device-to-host copy of the window's values, then the host
        hooks per step in order, and a periodic checkpoint if the window
        crossed a save boundary."""
        if not pending:
            return
        host = torch.stack([v for _, v, _ in pending]).cpu().numpy()
        for (step, _, lr), row in zip(pending, host):
            metrics = {"total_loss": row[0], "data_loss": row[1],
                       "learning_rate": lr}
            metrics.update(zip(self.metric_keys, row[2:]))
            self._after_step(step, metrics)
        self._stop = bool(self.plateau and self.plateau.should_stop())
        if self.group is not None:
            self.lr_scale, self._stop = self.group.broadcast_object(
                (self.lr_scale, self._stop))
        first, last = pending[0][0], pending[-1][0]
        interval = self.ckpt.save_interval_steps
        if last // interval > (first - 1) // interval:
            self._save(last)

    def _after_step(self, step: int, metrics):
        loss = float(metrics["total_loss"])
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"NaN/Inf loss at step {step}")  # reference NanTensorHook
        self.loss_meter.update(loss)
        lr = float(metrics["learning_rate"])
        if self.plateau is not None and self.chief:
            new_scale = self.plateau.step(step, self.loss_meter.avg, lr)
            if new_scale is not None:
                self.lr_scale = float(new_scale)
                logger.info("*** Decay learning rate, scale = %.3g", new_scale)
        log_vals = {"loss": loss, "loss_mean": self.loss_meter.avg,
                    "learning_rate": lr}
        for k, v in metrics.items():
            if "/" in k:
                log_vals[k] = float(v)
        self.speed.maybe_log(step, log_vals)
        if self.summary is not None and (step % self.args.log_step == 0
                                         or step == 1):
            self.summary.scalars(log_vals, step)
        if step % self.args.log_step == 0:
            self.loss_meter.reset()  # periodic reset (estimator.py:657-675)

    def _run_eval(self, eval_fn, step: int):
        """The epoch-end eval on every rank (its predicts are collective);
        rank 0 writes its summary and keeps the best checkpoint."""
        results = eval_fn(self)
        if results and self.summary is not None:
            self.summary.scalars({f"eval/{k}": v for k, v in results.items()},
                                 step)
        if results and self.best_keeper is not None:
            self.best_keeper.update(
                step, results,
                save_cb=lambda tag: self.ckpt.save_best(self.state(), tag))
        if self.group is not None:
            self.group.barrier()

    # -- predict -----------------------------------------------------------
    @torch.no_grad()
    def predict(self, features: Dict) -> torch.Tensor:
        """Softmax probabilities of one feature batch in eval mode (batch
        norm with its running statistics), on the trainer's device; host
        arrays are uploaded first (the volume evaluator's host batches).
        Under a group each rank runs its rows and every rank gets the whole
        batch's probabilities."""
        features = {k: torch.as_tensor(v, device=self.device)
                    for k, v in features.items()}
        if self.group is None:
            return torch.softmax(self.model(features, train=False), dim=-1)
        local = self.group.take_rows(features)
        probs = torch.softmax(self.model(local, train=False), dim=-1)
        return self.group.gather_rows(probs.float().contiguous())
