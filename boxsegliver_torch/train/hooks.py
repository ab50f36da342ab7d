"""Host-side training controllers (own numpy copy of
boxsegliver_tpu/train/hooks.py; reference core/hooks.py): plateau LR,
best-checkpoint keeper, speed logger, streaming loss mean.  The persisted
state (lr_schedule / best_result JSON sidecars) has the JAX package's and
the reference's formats (reference core/hooks.py:134-144, 646-671).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from boxsegliver_torch.evaluators.base import default_compare


class AverageMeter:
    """Streaming mean with periodic reset (reference core/estimator.py:657-675
    Losses/total_loss_mean + AverageTensorHook:546-578)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float):
        self.sum += float(value)
        self.count += 1

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def reset(self):
        self.sum = 0.0
        self.count = 0


class ReduceLROnPlateau:
    """Loss-EMA plateau detection → LR decay → early stop
    (reference ReduceLROnPlateauHook, core/hooks.py:581-723).

    `step()` returns the new lr_scale multiplier (or None), which the
    trainer uses for the learning rate of the following steps.  `should_stop()` implements check_stop (hooks.py:700-706).
    """

    def __init__(self, save_dir, lr_patience: int = 30, tr_patience: int = 50,
                 mode: str = "min", min_delta: float = 5e-4, cooldown: int = 0,
                 moving_average: float = 0.95, every_n_steps: int = 200,
                 decay_rate: float = 0.2, min_lr_scale: float = 1e-6,
                 lr_threshold: float = 1e-6):
        self.save_dir = Path(save_dir)
        self.lr_patience = lr_patience
        self.tr_patience = tr_patience
        self.inc_tr_patience = tr_patience // 2
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.lr_wait = 0
        self.tr_wait = 0
        self.alpha = moving_average
        self.total_loss_MA: Optional[float] = None
        self.every_n_steps = every_n_steps
        self.decay_rate = decay_rate
        self.min_lr_scale = min_lr_scale
        self.lr_threshold = lr_threshold
        self.lr_scale = 1.0
        self._last_triggered = 0
        self._stop = False
        if mode == "min":
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
            self.best = np.inf
        elif mode == "max":
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)
            self.best = -np.inf
        else:
            raise ValueError(f"Unknown plateau mode {mode}")
        self.load()

    # -- persistence (key set matches reference hooks.py:661-671) ----------
    def load(self):
        f = self.save_dir / "lr_schedule"
        if f.exists():
            d = json.loads(f.read_text())
            self.best = d["best"]
            self.total_loss_MA = d["total_loss_MA"]
            self.tr_wait = d["tr_wait"]
            self.lr_wait = d["lr_wait"]
            self.cooldown_counter = d["cooldown_counter"]
            self.lr_scale = d.get("lr_scale", 1.0)

    def save(self):
        self.save_dir.mkdir(parents=True, exist_ok=True)
        d = {"best": float(self.best),
             "total_loss_MA": float(self.total_loss_MA),
             "tr_wait": self.tr_wait,
             "lr_wait": self.lr_wait,
             "lr_patience": self.lr_patience,
             "lr_threshold": float(self.lr_threshold),
             "tr_patience": self.tr_patience,
             "cooldown_counter": self.cooldown_counter,
             "mode": self.mode,
             "lr_scale": float(self.lr_scale)}
        (self.save_dir / "lr_schedule").write_text(json.dumps(d))

    # -- control -----------------------------------------------------------
    def step(self, global_step: int, current_loss: float,
             current_lr: float) -> Optional[float]:
        """Call every train step; returns new lr_scale when a decay fires."""
        if (global_step - self._last_triggered < self.every_n_steps
                or global_step <= 2):
            return None
        self._last_triggered = global_step

        if self.total_loss_MA is None:
            self.total_loss_MA = float(current_loss)
        else:
            self.total_loss_MA = (self.alpha * self.total_loss_MA
                                  + (1 - self.alpha) * float(current_loss))
        changed = None
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.lr_wait = 0
        if self.monitor_op(self.total_loss_MA, self.best):
            self.best = self.total_loss_MA
            self.lr_wait = 0
            self.tr_wait = 0
        elif self.cooldown_counter <= 0:
            self.lr_wait += 1
            self.tr_wait += 1
            if self.lr_wait > self.lr_patience:
                self.lr_scale = max(self.lr_scale * self.decay_rate,
                                    self.min_lr_scale)
                self.cooldown_counter = self.cooldown
                self.lr_wait = 0
                changed = self.lr_scale
        # early stop (reference check_stop hooks.py:700-706)
        if self.tr_wait > self.tr_patience:
            if current_lr > self.lr_threshold:
                self.tr_wait -= self.inc_tr_patience
            else:
                self._stop = True
        self.save()
        return changed

    def should_stop(self) -> bool:
        return self._stop


class BestKeeper:
    """Best-checkpoint bookkeeping with JSON sidecars + optional interval
    bests (reference EvaluatorHook._save_or_not / V2, core/hooks.py:193-286).

    The actual checkpoint writing is delegated to a callback so the same
    keeper serves any checkpointer.
    """

    def __init__(self, model_dir, primary_metric: str,
                 secondary_metric: Optional[str] = None,
                 compare_fn: Optional[Callable] = None,
                 save_interval: int = 0, min_delta: float = 0.0):
        self.model_dir = Path(model_dir)
        self.primary = primary_metric
        self.secondary = secondary_metric
        self.compare_fn = compare_fn or (
            lambda c, b: default_compare(c, b, primary_metric, secondary_metric,
                                         min_delta))
        self.save_interval = save_interval
        self.best: Dict[str, float] = {}
        self.interval_best: Dict[int, Dict[str, float]] = {}
        self._load()

    def _best_file(self, interval: Optional[int] = None) -> Path:
        name = "best_result" if interval is None else f"best_result_{interval}"
        return self.model_dir / name

    def _load(self):
        f = self._best_file()
        if f.exists():
            self.best = json.loads(f.read_text())

    def update(self, global_step: int, results: Dict[str, float],
               save_cb: Optional[Callable] = None) -> bool:
        """Returns True (and invokes save_cb(tag)) when results beat the best."""
        results = dict(results)
        results["global_step"] = int(global_step)
        improved = self.compare_fn(results, self.best)
        if improved:
            self.best = results
            self.model_dir.mkdir(parents=True, exist_ok=True)
            self._best_file().write_text(json.dumps(self.best))
            if save_cb:
                save_cb("best")
        if self.save_interval:
            interval = global_step // self.save_interval
            ib = self.interval_best.get(interval, {})
            if self.compare_fn(results, ib):
                self.interval_best[interval] = results
                self._best_file(interval).write_text(json.dumps(results))
                if save_cb:
                    save_cb(f"best_{interval}")
        return improved


class BestKeeperMA(BestKeeper):
    """Moving-average best tracking (reference EvaluatorHookV2,
    core/hooks.py:288-470): each eval's metrics are EMA-smoothed before the
    comparison, damping per-epoch noise.  Sidecar stores {ma_results,
    ma_best_result} like the reference's best-result dump."""

    def __init__(self, model_dir, primary_metric: str,
                 secondary_metric: Optional[str] = None,
                 save_interval: int = 0, min_delta: float = 0.0,
                 ma_alpha: float = 0.9):
        self.ma_alpha = ma_alpha
        self.ma_results: Optional[Dict[str, float]] = None
        super().__init__(model_dir, primary_metric, secondary_metric,
                         save_interval=save_interval, min_delta=min_delta)

    def _best_file(self, interval: Optional[int] = None) -> Path:
        name = "best_result_ma" if interval is None else f"best_result_ma_{interval}"
        return self.model_dir / name

    def _load(self):
        f = self._best_file()
        if f.exists():
            d = json.loads(f.read_text())
            self.ma_results = d.get("ma_results")
            self.best = d.get("ma_best_result", {})

    def update(self, global_step: int, results: Dict[str, float],
               save_cb: Optional[Callable] = None) -> bool:
        results = {k: float(v) for k, v in results.items()}
        if self.ma_results is None:
            self.ma_results = dict(results)
        else:
            for k, v in results.items():
                prev = self.ma_results.get(k, v)
                self.ma_results[k] = self.ma_alpha * prev + (1 - self.ma_alpha) * v
        candidate = dict(self.ma_results)
        candidate["global_step"] = int(global_step)
        improved = self.compare_fn(candidate, self.best)
        if improved:
            self.best = candidate
            if save_cb:
                save_cb("best")
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self._best_file().write_text(json.dumps(
            {"ma_results": self.ma_results, "ma_best_result": self.best}))
        return improved


class SpeedLogger:
    """Step console line: loss, lr, step, metrics (N it/s)
    (reference LoggingTensorWithSpeedFormatterHook, core/hooks.py:521-543)."""

    def __init__(self, log_step: int = 500, logger=None):
        self.log_step = log_step
        self._t0 = time.time()
        self._last_step = 0
        import logging as _logging
        self.logger = logger or _logging.getLogger("boxsegliver")

    def maybe_log(self, step: int, values: Dict[str, float]):
        if step % self.log_step != 0 and step != 1:
            return
        now = time.time()
        its = (step - self._last_step) / max(now - self._t0, 1e-6)
        self._t0, self._last_step = now, step
        parts = [f"{k} = {float(v):.4g}" for k, v in values.items()]
        self.logger.info(", ".join(parts) + f", step = {step} ({its:.3g} it/s)")
