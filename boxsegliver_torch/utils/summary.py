"""Summary writing: TensorBoard scalars/images + JSONL mirror (own copy of
boxsegliver_tpu/utils/summary.py:25-78; reference
utils/summary_kits.py:12-110).

All tags are prefixed with `summary_prefix` (default: experiment tag) so
multiple experiments merge onto shared TensorBoard charts
(reference config.py:48-52).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np


class SummaryWriter:
    """Scalar/image writer: torch TensorBoard backend when importable,
    always mirrored to metrics.jsonl for hermetic environments."""

    def __init__(self, log_dir, prefix: str = ""):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self._jsonl = (self.log_dir / "metrics.jsonl").open("a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
            self._tb = TBWriter(log_dir=str(self.log_dir))
        except ImportError:  # tensorboard is optional; metrics.jsonl stays
            pass

    def _tag(self, tag: str) -> str:
        return f"{self.prefix}/{tag}" if self.prefix else tag

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(self._tag(tag), float(value), step)
        self._jsonl.write(json.dumps(
            {"tag": self._tag(tag), "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")

    def scalars(self, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(k, v, step)
        self.flush()

    def image(self, tag: str, image: np.ndarray, step: int):
        """image: [h, w] or [h, w, c] float in [0,1] or uint8
        (reference summary_kits.summary_image / model image summaries)."""
        if self._tb is None:
            return
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[..., None]
        if img.dtype != np.uint8:
            lo, hi = float(img.min()), float(img.max())
            img = ((img - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)
        self._tb.add_image(self._tag(tag), img, step, dataformats="HWC")

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

