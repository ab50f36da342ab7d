"""Optimizer + learning-rate policy (port of
boxsegliver_tpu/train/solver.py:77-164; reference core/solver.py:112-254).

LR policies (reference _get_model_learning_rate, solver.py:138-200):
- period_step: staircase exponential decay  lr · rate^floor(step / decay_step)
- custom_step: piecewise-constant at boundaries
- poly:        polynomial decay to lr_end over num_of_total_steps
- plateau:     max(lr · lr_scale, lr_end), where lr_scale is set by the host
               ReduceLROnPlateau controller (train/hooks.py)
- slow start:  lr = slow_start_lr while step < slow_start_step
The schedule is evaluated on the host in float32, as the JAX package
evaluates it on the device.

Optimizers (reference _get_model_optimizer, solver.py:204-218): Adam
(β1 0.9, β2 0.99, eps 1e-8 added outside the square root, as in
``optax.scale_by_adam``), Momentum (0.9, ``optax.trace``) and AdamW (Adam +
decoupled weight decay), each a descent direction at unit rate that the
step scales by lr(step), as the JAX package's transform chain does.  The
per-tensor arithmetic runs as multi-tensor ``torch._foreach_*`` calls.
``--opt_moment_dtype bfloat16`` stores Adam's μ and ν in bfloat16 and does
the arithmetic in float32 (JAX ``scale_by_adam_lowp``, solver.py:29-74);
AdamW goes through the same moments, and checkpoints keep them in bf16.

The step's scalars — lr(step) and Adam's bias corrections c1 = 1 − β1^t,
c2 = 1 − β2^t — are computed on the host in float32 (``schedule``) and
reach the update as a device tensor [lr, c1, c2] (``apply``), never as
Python numbers: a CUDA graph of the train step (train/trainer.py) replays
the update with the values its buffer holds at replay time, and the eager
step reads the same buffer.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch


def make_lr_fn(args) -> Callable[[int, float], float]:
    """lr(step, lr_scale) -> float, float32 arithmetic."""
    f32 = np.float32
    policy = args.learning_policy
    base = f32(args.learning_rate)

    if policy == "period_step":
        def schedule(step):
            return base * np.power(f32(args.lr_decay_rate),
                                   np.floor(f32(step) / f32(args.lr_decay_step)))
    elif policy == "custom_step":
        boundaries = list(args.lr_decay_boundaries or [])
        values = list(args.lr_custom_values or [float(base)])
        if len(values) != len(boundaries) + 1:
            raise ValueError("len(lr_custom_values) - len(lr_decay_boundaries) != 1")

        def schedule(step):
            lr = f32(values[0])
            for b, v in zip(boundaries, values[1:]):
                lr = f32(v) if step >= b else lr
            return lr
    elif policy == "poly":
        total = f32(args.num_of_total_steps)
        power = f32(args.lr_power)
        end = f32(args.lr_end)

        def schedule(step):
            frac = np.clip(f32(step) / total, f32(0.0), f32(1.0))
            return (base - end) * np.power(f32(1.0) - frac, power) + end
    elif policy == "plateau":
        def schedule(step):
            return base
    else:
        raise ValueError("Not supported learning policy: " + policy)

    slow_start = bool(getattr(args, "lr_warm_up", False))
    ss_step = int(getattr(args, "slow_start_step", 0))
    ss_lr = f32(getattr(args, "slow_start_lr", 1e-4))

    def lr_fn(step: int, lr_scale: float = 1.0) -> float:
        lr = f32(schedule(step))
        if policy == "plateau":
            lr = max(f32(lr * f32(lr_scale)), f32(args.lr_end))
        if slow_start and ss_step > 0 and step < ss_step:
            lr = ss_lr
        return float(lr)

    return lr_fn


MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Optimizer:
    """Adam / Momentum / AdamW over a list of float32 parameters, applied
    in place as p ← p + direction·(−lr)."""

    def __init__(self, args, params: List[torch.Tensor]):
        self.kind = args.optimizer.lower()
        moment = getattr(args, "opt_moment_dtype", "float32")
        if moment not in MOMENT_DTYPES:
            raise ValueError("Not supported --opt_moment_dtype: " + moment)
        if self.kind not in ("adam", "momentum", "adamw"):
            raise ValueError("Not supported optimizer: " + args.optimizer)
        self.b1, self.b2, self.eps = 0.9, 0.99, 1e-8
        self.momentum, self.nesterov = 0.9, False
        self.weight_decay = float(args.weight_decay_rate)
        self.params = list(params)
        self.count = 0
        if self.kind == "momentum":
            self.state = {"trace": [torch.zeros_like(p) for p in self.params]}
        else:
            dt = MOMENT_DTYPES[moment]
            self.state = {k: [torch.zeros_like(p, dtype=dt)
                              for p in self.params] for k in ("mu", "nu")}
        self.lowp = (self.kind != "momentum"
                     and self.state["mu"][0].dtype != torch.float32)

    def schedule(self, lr: float) -> np.ndarray:
        """[lr, c1, c2] float32 of the next step, which advances ``count``
        (c1, c2: Adam's bias corrections 1 − β^count, as optax computes
        them in float32)."""
        f32 = np.float32
        self.count += 1
        c1 = f32(1.0) - f32(self.b1) ** f32(self.count)
        c2 = f32(1.0) - f32(self.b2) ** f32(self.count)
        return np.array([lr, c1, c2], np.float32)

    def _adam_direction(self, grads, c1, c2):
        mu, nu = self.state["mu"], self.state["nu"]
        if self.lowp:
            # the moments at rest in bf16, the arithmetic in float32, in
            # scale_by_adam_lowp's order: b·m + (1 − b)·g, then round
            m32 = torch._foreach_mul([m.float() for m in mu], self.b1)
            torch._foreach_add_(m32, torch._foreach_mul(grads, 1.0 - self.b1))
            v32 = torch._foreach_mul([v.float() for v in nu], self.b2)
            torch._foreach_add_(v32, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - self.b2))
            for dst, src in ((mu, m32), (nu, v32)):
                torch._foreach_copy_(dst, src)
        else:
            m32, v32 = mu, nu
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(v32, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        direction = torch._foreach_div(m32, c1)
        torch._foreach_div_(direction, denom)
        return direction

    @torch.no_grad()
    def direction(self, grads: List[torch.Tensor], sched: torch.Tensor):
        """The descent direction at unit rate (moments updated in place);
        sched: the device tensor [lr, c1, c2] of this step."""
        if self.kind == "momentum":
            trace = self.state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            if self.nesterov:
                return torch._foreach_add(
                    torch._foreach_mul(trace, self.momentum), grads)
            return trace
        direction = self._adam_direction(grads, sched[1], sched[2])
        if self.kind == "adamw":
            torch._foreach_add_(direction, self.params,
                                alpha=self.weight_decay)
        return direction

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor], sched: torch.Tensor):
        """p ← p + direction·(−lr), all on the device (no host number)."""
        torch._foreach_add_(self.params, torch._foreach_mul(
            self.direction(grads, sched), -sched[0]))

    def step(self, grads: List[torch.Tensor], lr: float):
        """One eager step at ``lr``: schedule() into a tensor, then
        apply()."""
        sched = torch.from_numpy(self.schedule(lr)).to(self.params[0].device)
        self.apply(grads, sched)

    def state_dict(self) -> Dict:
        return {"kind": self.kind, "count": self.count,
                "state": {k: [t.detach().clone() for t in v]
                          for k, v in self.state.items()}}

    def load_state_dict(self, d: Dict):
        if d["kind"] != self.kind:
            raise ValueError(f"optimizer state of {d['kind']}, not "
                             f"{self.kind}")
        self.count = int(d["count"])
        with torch.no_grad():
            for k, v in d["state"].items():
                for dst, src in zip(self.state[k], v):
                    dst.copy_(src)
