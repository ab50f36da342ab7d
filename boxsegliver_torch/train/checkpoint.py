"""Checkpoint management: periodic + best + warm start (port of
boxsegliver_tpu/train/checkpoint.py; reference core/estimator.py:693-719,
core/hooks.py:193-228, core/models.py:160-221), written with ``torch.save``:

    model_dir/
      ckpt/<step>/state.pt      periodic checkpoints (max_to_keep, every
                                save_ckpt_steps, and at the end of training)
      ckpt_best/<tag>/state.pt  best-metric checkpoints (best, best_<N>)
      best_result, lr_schedule  JSON sidecars (train/hooks.py)

A state file holds {"model": state_dict, "optimizer": Optimizer.state_dict,
"step", "lr_scale", "generator": the trainer's torch.Generator state}.  The
JAX package writes orbax directories at the same paths; the two packages'
checkpoints are not interchangeable (weights cross over through the
``.npz`` bridge of models/weights.py).
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch

logger = logging.getLogger("boxsegliver")

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, model_dir, max_to_keep: int = 1,
                 save_interval_steps: int = 5000):
        self.model_dir = Path(model_dir).resolve()
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self._dir = self.model_dir / "ckpt"
        self._best_dir = self.model_dir / "ckpt_best"

    @staticmethod
    def _write(path: Path, state: Dict):
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(state, tmp)
        tmp.replace(path / STATE_FILE)

    # -- periodic ----------------------------------------------------------
    def steps(self):
        if not self._dir.exists():
            return []
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict):
        self._write(self._dir / str(step), state)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._dir / str(old))

    def latest_path(self) -> Optional[Path]:
        step = self.latest_step()
        return None if step is None else self._dir / str(step) / STATE_FILE

    # -- best line ---------------------------------------------------------
    def save_best(self, state: Dict, tag: str = "best"):
        self._write(self._best_dir / tag, state)

    def best_path(self, tag: str = "best") -> Path:
        return self._best_dir / tag / STATE_FILE

    def has_best(self, tag: str = "best") -> bool:
        return self.best_path(tag).exists()


def load_state(path) -> Dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def model_state(path) -> Dict[str, torch.Tensor]:
    """The model state_dict in ``path``: a checkpoint's state.pt (or its
    directory), a ``.pt`` state_dict, or a ``.npz`` of flattened flax
    variables (models/weights.py)."""
    from boxsegliver_torch.models.weights import flax_to_state_dict

    path = Path(path)
    if path.is_dir():
        path = path / STATE_FILE
    if path.suffix == ".npz":
        import numpy as np
        with np.load(path) as f:
            return flax_to_state_dict({k: f[k] for k in f.files})
    if path.suffix != ".pt":
        raise ValueError(f"{path}: expected a checkpoint directory, a .pt "
                         "file or a .npz of flax variables")
    state = load_state(path)
    return state["model"] if "model" in state else state


def remap_scopes(state: Dict[str, torch.Tensor],
                 scope_map: Optional[Dict[str, str]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Rename top-level scopes ``old`` → ``new`` (JAX remap_params,
    checkpoint.py:78-86).  A state_dict key's first component is the flax
    top-level scope of the tensor: the bridge names each top-level module
    as flax does (models/weights.flax_names), so one ``--weights_scope``
    string renames the same tensors in both packages."""
    if not scope_map:
        return state
    out = {}
    for key, v in state.items():
        top, _, rest = key.partition(".")
        out[".".join([scope_map.get(top, top)] + ([rest] if rest else []))] = v
    return out


def warm_start(model: torch.nn.Module, path,
               scope_map: Optional[Dict[str, str]] = None) -> int:
    """Copy the matching-shaped tensors of ``path`` (see model_state), its
    top-level scopes renamed by ``scope_map``, into ``model``; the others
    keep their fresh init (the reference's partial restore).  Returns the
    number of tensors copied.  A ``.h5`` path is the DenseNet-161 ImageNet
    import (utils/h5_import.py; JAX trainer.py:319-333), which returns the
    flax leaves it restored."""
    if str(path).endswith(".h5"):
        from boxsegliver_torch.utils.h5_import import load_densenet161_h5
        return load_densenet161_h5(model, path, log=logger)
    src = remap_scopes(model_state(path), scope_map)
    n = 0
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in src and tuple(src[k].shape) == tuple(v.shape):
                v.copy_(src[k])
                n += 1
    return n
