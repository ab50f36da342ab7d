"""DenseNet-161 ImageNet ``.h5`` warm start for DenseUNet (port of
boxsegliver_tpu/utils/h5_import.py; reference init_dense_model,
core/models.py:188-221).

The ``densenet161_weights_tf.h5`` file holds one group per layer:

    <layer>/<layer>_W                         conv kernels (HWIO)
    <layer>_bn/<layer>_bn_running_mean        BN moving mean
    <layer>_bn/<layer>_bn_running_std         BN moving variance
    <layer>_scale/<layer>_scale_{beta,gamma}  BN affine parameters

DenseUNet's modules carry the file's layer names (models/dense_unet.py), so
the import walks the model's flax names (models/weights.flax_names): a
top-level layer with a kernel takes ``<layer>/<layer>_W``, a ``*_bn`` layer
its affine from ``<base>_scale``, and, unless ``skip_batch_stats``, its
running statistics from ``<layer>_bn``; every other tensor (the decoder)
keeps its value, the reference's partial restore.  As in the JAX package,
restoring the running statistics goes beyond the reference, which warm
starts trainable variables only; ``skip_batch_stats=True`` is the
reference's restore.  A shape mismatch raises.  h5py is imported when the
import runs; without it the import raises an ImportError that names it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)


def _layers(flat: Dict[str, np.ndarray], coll: str
            ) -> Dict[str, Dict[str, str]]:
    """{top-level layer: {leaf: flax name}} of the leaves held directly by a
    top-level module of collection ``coll``."""
    out: Dict[str, Dict[str, str]] = {}
    for name in flat:
        parts = name.split("/")
        if parts[0] == coll and len(parts) == 3:
            out.setdefault(parts[1], {})[parts[2]] = name
    return out


def load_densenet161_h5(model: torch.nn.Module, h5_path, log=None,
                        skip_batch_stats: bool = False) -> int:
    """Copy the file's encoder tensors into ``model`` (in place); returns the
    number of flax leaves restored (a kernel counts one, an affine or a pair
    of statistics two)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("--load_weights <file>.h5 needs h5py, which is "
                          "not installed") from e

    flat = state_dict_to_flax(model)
    restored: Dict[str, np.ndarray] = {}

    def take(group, key, name, what):
        value = np.asarray(group[key])
        if value.shape != flat[name].shape:
            raise ValueError(
                f"h5 import shape mismatch for {what}: file {value.shape} "
                f"vs model {flat[name].shape}")
        restored[name] = value.astype(np.float32)

    with h5py.File(h5_path, "r") as f:
        keys = set(f.keys())
        for layer, leaves in _layers(flat, "params").items():
            if "kernel" in leaves and layer in keys:
                take(f[layer], layer + "_W", leaves["kernel"], layer)
                _log(log, "Restore %s/kernel", layer)
            base = layer[:-3] + "_scale"
            if layer.endswith("_bn") and base in keys and (
                    "scale" in leaves or "bias" in leaves):
                take(f[base], base + "_gamma", leaves["scale"], base)
                take(f[base], base + "_beta", leaves["bias"], base)
                _log(log, "Restore %s/{scale,bias}", layer)
        if not skip_batch_stats:
            for layer, leaves in _layers(flat, "batch_stats").items():
                if layer in keys:
                    take(f[layer], layer + "_running_mean", leaves["mean"],
                         layer)
                    take(f[layer], layer + "_running_std", leaves["var"],
                         layer)
                    _log(log, "Restore %s/{mean,var}", layer)

    state = model.state_dict()
    with torch.no_grad():
        for key, value in flax_to_state_dict(restored).items():
            state[key].copy_(value)
    return len(restored)


def _log(log, fmt, *args):
    if log is not None:
        log.info(fmt, *args)
