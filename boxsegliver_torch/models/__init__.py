"""Model zoo of the port and model construction from flags + configs
(port of boxsegliver_tpu/models/__init__.py; reference core/models.py:36-118).

The JAX package reads its model configs from YAML files; the port keeps its
own copies as Python dicts (``MODEL_CONFIGS``, keyed by the YAML file name;
tests/test_torch_gunet.py holds them equal to the ``.yml`` files): every
config of the JAX package is carried (tests/test_torch_model_select.py).

Flax infers a model's input widths at init from a feature template (JAX
cli/main.build_feature_template); the port's constructors take them from
the flags: ``--im_channel``, the summed ``--context_list`` lengths and the
guide's channels (``guide_channels``); UNet3D's from JAX's 3-D template:
one image channel, two with ``--use_cascade``, and ``--guide_channel``
guide channels under ``--use_spatial``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import torch

from boxsegliver_torch.models.dense_unet import DenseUNet
from boxsegliver_torch.models.gunet import GUNet
from boxsegliver_torch.models.inter_unet import InterUNet
from boxsegliver_torch.models.layers import ct_sizes
from boxsegliver_torch.models.lgnet import LGNet
from boxsegliver_torch.models.small_unet import SmallUNet
from boxsegliver_torch.models.unet import UNet
from boxsegliver_torch.models.unet3d import UNet3D
from boxsegliver_torch.models.unet_inter import UNetInter

MODEL_ZOO = {
    "UNet": UNet,
    "GUNet": GUNet,
    "UNetInter": UNetInter,
    "LGNet": LGNet,
    "SmallUNet": SmallUNet,
    "InterUNet": InterUNet,
    "UNet3D": UNet3D,
    "DenseUNet": DenseUNet,
}

_GUNET_BASE = {
    "init_channels": 64, "num_down_samples": 4, "mod_layers": [1, 2, 3, 4],
    "context_model": "fc", "context_conv_init_channels": 2,
    "ret_prob": False, "ret_pred": True,
}

# configs/models/<name> and configs/models/ext_config/<name> of the JAX package
MODEL_CONFIGS: Dict[str, Dict[str, Any]] = {
    "UNet.yml": {"init_channels": 64, "num_down_samples": 4,
                 "ret_prob": False, "ret_pred": True},
    "UNet_TINY.yml": {"init_channels": 8, "num_down_samples": 2},
    "UNet3D.yml": {"init_channels": 30, "max_channels": 320,
                   "num_pool_layers": 4, "ret_prob": False,
                   "ret_pred": True},
    "UNetInter.yml": {"init_channels": 64, "num_down_samples": 4,
                      "ret_prob": False, "ret_pred": True},
    "UNetInter_TINY.yml": {"init_channels": 4, "num_down_samples": 2},
    "InterUNet.yml": {"init_channel_factor": 1, "num_pool_layers": 3,
                      "ret_prob": False, "ret_pred": True},
    "SmallUNet.yml": {"init_channel_factor": 1, "num_pool_layers": 3,
                      "ret_prob": False, "ret_pred": True},
    "LGNet.yml": {"mod_layers": [[0, 1], [0, 1]], "ret_prob": False,
                  "ret_pred": True},
    "LGNet_v3.yml": {"mod_layers": [[1], [2]], "ret_prob": False,
                     "ret_pred": True},
    "GUNet.yml": dict(_GUNET_BASE, context_fc_channels=[256, 256],
                      norm_with_center=True, norm_with_scale=False),
    "GUNet_SP.yml": dict(_GUNET_BASE, context_fc_channels=[200, 200],
                         norm_with_center=False, norm_with_scale=True),
    "GUNet_DE.yml": dict(_GUNET_BASE, context_fc_channels=[200, 200],
                         norm_with_center=True, norm_with_scale=False),
    "GUNet_BOTH.yml": dict(_GUNET_BASE, context_fc_channels=[200, 200],
                           norm_with_center=False, norm_with_scale=False),
    "GUNet_BOTH_AA.yml": dict(_GUNET_BASE, context_fc_channels=[200, 200],
                              norm_with_center=False, norm_with_scale=False,
                              after_affine=True),
    "GUNet_TINY.yml": dict(_GUNET_BASE, init_channels=8, num_down_samples=2,
                           mod_layers=[1, 2], context_fc_channels=[16, 16],
                           norm_with_center=True, norm_with_scale=False),
    "GUNet_IIN.yml": dict(_GUNET_BASE, context_fc_channels=[256, 256],
                          context_model="conv", context_conv_init_channels=16,
                          norm_with_center=True, norm_with_scale=False),
    "GUNet_IIN_TINY.yml": dict(_GUNET_BASE, init_channels=8,
                               num_down_samples=2, mod_layers=[1, 2],
                               context_fc_channels=[16, 16],
                               context_model="conv",
                               context_conv_init_channels=4,
                               norm_with_center=True, norm_with_scale=False),
    "DenseUNet.yml": {"stem_channels": 96, "growth_rate": 48,
                      "nb_layers": [6, 12, 36, 24], "compression": 0.5,
                      "ret_prob": False, "ret_pred": True},
    "DenseUNet_tiny.yml": {"stem_channels": 8, "growth_rate": 4,
                           "nb_layers": [2, 2, 2, 2], "compression": 0.5,
                           "ret_prob": False, "ret_pred": True},
}

# Which constructor fields each model pulls from the flag namespace.
_ARG_FIELDS = {
    "UNet": ("normalizer", "without_norm", "img_grad", "weight_init"),
    "GUNet": ("normalizer", "without_norm", "img_grad", "weight_init",
              "use_context", "use_spatial", "use_se", "guide_channel",
              "side_dropout", "dropout", "fix"),
    "UNetInter": ("normalizer", "without_norm", "img_grad", "weight_init",
                  "mid_cat"),
    "LGNet": ("normalizer", "without_norm", "img_grad", "weight_init",
              "use_spatial"),
    "SmallUNet": ("normalizer", "without_norm", "weight_init"),
    "InterUNet": ("normalizer", "without_norm", "img_grad", "weight_init"),
    "UNet3D": ("normalizer", "without_norm", "img_grad", "weight_init",
               "use_spatial"),
    "DenseUNet": ("weight_init", "dropout"),
}

# config keys consumed by the runtime rather than the model constructor
_RUNTIME_KEYS = ("ret_prob", "ret_pred", "build_metrics", "build_summaries")


def load_model_config(model: str, model_config: Optional[str] = None) -> Dict:
    """Model hyperparams by config file name (``--model_config`` or
    ``<model>.yml``); a name the JAX package lacks gives {}, as there."""
    return dict(MODEL_CONFIGS.get(model_config or (model + ".yml"), {}))


def get_model_params(args) -> Dict[str, Any]:
    """params dict {model, model_kwargs} (reference core/models.py:92-118)."""
    if args.model not in MODEL_ZOO:
        raise ValueError(f"Unknown model {args.model}; registered: {list(MODEL_ZOO)}")
    kwargs = load_model_config(args.model, getattr(args, "model_config", None))
    return {"model": args.model, "model_kwargs": kwargs}


def guide_channels(args, model: Optional[str] = None) -> int:
    """Channels of the guide ``model`` (default --model) takes (JAX
    build_feature_template, cli/main.py:98-121): ``--guide_channel`` for
    the click-guided UNetInter and InterUNet and for every model of the
    nf_inter task, else 1."""
    if ((model or getattr(args, "model", None)) in ("UNetInter", "InterUNet")
            or getattr(args, "task", "") == "nf_inter"):
        return int(getattr(args, "guide_channel", 2))
    return 1


def context_length(args) -> int:
    raw = getattr(args, "context_list", None) or ["hist", "200"]
    return sum(int(raw[i + 1]) for i in range(0, len(raw), 2))


def context_channels(args) -> int:
    """Scales of the nf2 context pyramid (``--ct_base``: 1 or 3 sizes)."""
    return len(ct_sizes(getattr(args, "ct_base", None) or [32]))


def build_model(model_name: str, args=None,
                model_kwargs: Optional[Dict] = None,
                num_classes: Optional[int] = None,
                dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """Instantiate a torch module from flags + config kwargs (parameters
    float32, ``dtype`` the compute dtype).  num_classes defaults to
    len(args.classes) + 1 (Background prepended, reference
    NetworksV2/base.py:44).  Input widths that flax infers at init come from
    the flags: ``--im_channel``, the summed ``--context_list`` lengths and
    the guide's channels (guide_channels).
    Keys the model's constructor does not take are dropped, as the JAX
    package drops the fields a flax module lacks."""
    cls = MODEL_ZOO[model_name]
    kwargs = dict(model_kwargs or {})
    for key in _RUNTIME_KEYS:
        kwargs.pop(key, None)
    if args is not None:
        for field in _ARG_FIELDS.get(model_name, ()):
            if hasattr(args, field):
                kwargs.setdefault(field, getattr(args, field))
        if model_name == "UNet3D":
            # JAX cli/main.build_feature_template's 3-D branch
            kwargs.setdefault("in_channels", 2 if getattr(
                args, "use_cascade", False) else 1)
            kwargs.setdefault("sp_channels", int(getattr(
                args, "guide_channel", 2)))
        kwargs.setdefault("in_channels", int(args.im_channel))
        kwargs.setdefault("context_length", context_length(args))
        kwargs.setdefault("context_channels", context_channels(args))
        kwargs.setdefault("guide_channels", guide_channels(args, model_name))
        kwargs.setdefault("sp_channels", guide_channels(args, model_name))
        if num_classes is None:
            num_classes = len(args.classes) + 1
    if num_classes is not None:
        kwargs["num_classes"] = num_classes
    if dtype is not None:
        kwargs["dtype"] = dtype
    valid = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in valid})
