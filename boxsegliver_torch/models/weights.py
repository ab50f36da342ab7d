"""Weight bridge: flax ``params`` / ``batch_stats`` trees ↔ torch
``state_dict``, and weight files for ``--ckpt_path``.

The flax side arrives flattened with "/" separators, as
``flax.traverse_util.flatten_dict({"params": ..., "batch_stats": ...},
sep="/")`` gives it (README shows how to write such an ``.npz`` from an
orbax checkpoint of the JAX package).  The port's modules are named after
the flax tree (models/layers.py), so keys map by rule:

- module path: flax's auto-named wrappers ``InstanceNorm_0``, ``BatchNorm_0``
  and ``ConvTranspose_0`` disappear (the torch module holds the leaves
  itself); ``Conv_0`` → ``conv`` and ``Norm_0`` → ``norm`` (ConvNormAct),
  except under ``context``, where GUNet's PatchCNN and VGG1D keep flax's
  ``Conv_k`` and ``MLP_0``; a flax ``nn.BatchNorm`` a model names itself
  (DenseUNet's flat ``conv1_bn``, ``bn_up0``, ...: layers.BatchNorm) has
  no wrapper level on either side;
- leaves: ``kernel`` → ``weight``, ``scale`` → ``weight``, ``bias`` → ``bias``,
  batch-norm ``mean`` / ``var`` → ``running_mean`` / ``running_var``,
  ChannelAffine ``gamma`` / ``beta`` unchanged;
- layouts: conv kernels WIO → OIW, HWIO → OIHW and DHWIO → OIDHW; dense
  kernels [in, out] → [out, in]; transpose-conv kernels [kh, kw, in, out]
  → [in, out, kh, kw] (and [kd, kh, kw, in, out] → [in, out, kd, kh, kw]) with
  EVERY spatial axis flipped (flax's output phase (p, q) uses tap (1-p,
  1-q), boxsegliver_tpu/models/layers.py:172-176; torch's uses tap (p, q);
  UNet3D's (1, 2, 2) taps flip their depth axis of one onto itself).

The inverse, ``state_dict_to_flax`` (with ``flax_names``, torch key → flax
name), reads the module types to rebuild the names flax gives; the train
step picks its L2-decayed tensors through it (ops/losses.decayed_parameters).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

_DROPPED = ("InstanceNorm_0", "BatchNorm_0", "ConvTranspose_0")
_RENAMED = {"Conv_0": "conv", "Norm_0": "norm"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var",
           "gamma": "gamma", "beta": "beta"}


def flax_key_to_torch(key: str) -> str:
    """'params/up1/ConvTranspose_0/kernel' -> 'up1.weight'."""
    parts = key.split("/")
    if parts[0] in ("params", "batch_stats"):
        parts = parts[1:]
    *path, leaf = parts
    path = [p if p == "Conv_0" and i and path[i - 1] == "context"
            else _RENAMED.get(p, p)
            for i, p in enumerate(path) if p not in _DROPPED]
    return ".".join(path + [_LEAVES[leaf]])


def _to_torch_layout(key: str, arr: np.ndarray) -> np.ndarray:
    if not key.endswith("/kernel"):
        return arr
    nd = arr.ndim - 2                       # spatial axes
    if "/ConvTranspose_0/" in key:
        flipped = arr[(slice(None, None, -1),) * nd]
        return np.transpose(flipped, (nd, nd + 1) + tuple(range(nd)))
    if arr.ndim in (3, 4, 5):
        return np.transpose(arr, (nd + 1, nd) + tuple(range(nd)))
    if arr.ndim == 2:
        return arr.T
    raise ValueError(f"Unexpected kernel rank {arr.ndim} for {key}")


def flax_to_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax variables ('params/...', 'batch_stats/...') → a torch
    state_dict of float32 tensors."""
    out = {}
    for key, arr in flat.items():
        arr = _to_torch_layout(key, np.asarray(arr, np.float32))
        out[flax_key_to_torch(key)] = torch.from_numpy(np.array(arr))
    return out


def flax_names(model: torch.nn.Module) -> Dict[str, str]:
    """state_dict key → flattened flax name ('params/...' for parameters,
    'batch_stats/...' for running statistics) of every tensor of ``model``."""
    from boxsegliver_torch.models.layers import (BatchNorm, ConvNormAct,
                                                 Norm, UpConv)

    modules = dict(model.named_modules())
    out = {}
    for mod_name, mod in modules.items():
        path = []
        parts = mod_name.split(".") if mod_name else []
        for i, part in enumerate(parts):
            parent = modules[".".join(parts[:i])]
            if isinstance(parent, ConvNormAct):
                part = {"conv": "Conv_0", "norm": "Norm_0"}[part]
            path.append(part)
        if isinstance(mod, Norm):
            if not isinstance(mod, BatchNorm):
                path.append("InstanceNorm_0"
                            if mod.normalizer == "instance_norm"
                            else "BatchNorm_0")
            leaves = {"weight": "scale"}
        elif isinstance(mod, UpConv):
            path.append("ConvTranspose_0")
            leaves = {"weight": "kernel"}
        else:
            leaves = {"weight": "kernel"}
        leaves.update(running_mean="mean", running_var="var")
        tensors = [("params", n) for n, _ in mod.named_parameters(recurse=False)]
        tensors += [("batch_stats", n)
                    for n, _ in mod.named_buffers(recurse=False)]
        for coll, leaf in tensors:
            key = f"{mod_name}.{leaf}" if mod_name else leaf
            out[key] = "/".join([coll] + path + [leaves.get(leaf, leaf)])
    return out


def _to_flax_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if not name.endswith("/kernel"):
        return arr
    nd = arr.ndim - 2
    if "/ConvTranspose_0/" in name:
        return np.transpose(arr, tuple(range(2, arr.ndim)) + (0, 1))[
            (slice(None, None, -1),) * nd]
    if arr.ndim in (3, 4, 5):
        return np.transpose(arr, tuple(range(2, arr.ndim)) + (1, 0))
    return arr.T


def state_dict_to_flax(model: torch.nn.Module,
                       tensors: Mapping[str, torch.Tensor] = None
                       ) -> Dict[str, np.ndarray]:
    """Flattened flax variables of ``model``'s tensors (or of ``tensors``,
    keyed like its state_dict: gradients, say), in flax's layouts."""
    names = flax_names(model)
    tensors = model.state_dict() if tensors is None else tensors
    return {names[k]: np.ascontiguousarray(_to_flax_layout(
        names[k], v.detach().float().cpu().numpy()))
        for k, v in tensors.items()}


def load_weights(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load ``--ckpt_path`` into ``model`` (strict): a ``.npz`` of flattened
    flax variables, or a ``.pt`` torch state_dict."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as f:
            state = flax_to_state_dict({k: f[k] for k in f.files})
    elif path.suffix == ".pt":
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"--ckpt_path {path}: expected a .npz of flax "
                         "variables or a .pt state_dict (orbax checkpoint "
                         "directories: convert with the README snippet)")
    model.load_state_dict(state, strict=True)
    return model
