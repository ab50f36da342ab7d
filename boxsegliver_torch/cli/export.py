"""Serving export of the port: ``--mode export`` writes a torch.export
bundle (port of boxsegliver_tpu/cli/export.py; reference
entry/main_export.py:28-120):

    <out_dir, default model_dir/export>/
      model.pt2       the torch.export program of the serve function
                      (images [, sp_guide, context] -> probabilities),
                      saved with its tensors on the CPU
      state.pt        the weights it was traced with, {"model": state_dict}
                      as train/checkpoint.py writes them
      signature.json  the serving signature, with the JAX bundle's keys and
                      values

The serve function is JAX's: images cast to float32 and resized to
``--im_height`` x ``--im_width``, the model in eval mode, softmax over the
classes.  The exported input shape is that size, and the server takes no
other, so the resize is the identity there.  The model is traced on the
CPU under no_grad with static shapes, whatever ``--device``: there
torch.export's fake convolutions lay out their outputs as the card's
convolutions do (channels-last for channels-last operands, where on the
card they report contiguous ones), so the graph holds the operators of the
layouts the card then runs.  Every full-affine instance
norm + ReLU of a GUNet traces to one node of a registered operator
(ops/kernels.py: ``boxseg::in_relu_nhwc_fwd`` on its channels-last
activations, ``boxseg::in_relu_fwd`` on contiguous ones), and each modulated
block to one of ``boxseg::modnorm_relu_nhwc_fwd`` (``boxseg::modnorm_relu_fwd``
on contiguous activations): a program loaded on the card launches
kernels B2-fwd and B3-fwd there, and on the CPU runs their plain versions.  The
program is saved on the CPU, so a bundle serves on either device, as the JAX
bundle lowered for cpu and tpu does.

    python -m boxsegliver_torch.cli.main liver --mode export --model GUNet \\
        --classes Liver Tumor --im_height 256 --im_width 256 \\
        --im_channel 3 --normalizer instance_norm --use_context \\
        --context_list hist 200 --use_spatial --batch_size 8 \\
        --model_dir <dir> [--ckpt_path <ckpt>] [--device cpu]
    python -m boxsegliver_torch.cli.main nf2 --mode export --model GUNet \
        --model_config GUNet_IIN.yml --classes NF --use_context \
        --ct_base 32 --use_spatial ...          # 004_gnet_iin.sh flags
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boxsegliver_torch import config as config_mod
from boxsegliver_torch.cli.main import _build_model, restore_weights
from boxsegliver_torch.models import context_channels, context_length
from boxsegliver_torch.models.layers import CT_PATCH

PROGRAM_FILE = "model.pt2"
STATE_FILE = "state.pt"
SIGNATURE_FILE = "signature.json"


def build_feature_template(args) -> Dict[str, np.ndarray]:
    """The serving inputs at their exported shapes (JAX cli/main.py:
    86-121).  UNet3D: images [bs, D, H, W, 1] (2 channels with
    --use_cascade), D = --im_depth or 8 where it is -1, and sp_guide [bs,
    D, H, W, --guide_channel] of zeros under --use_spatial.  2-D models:
    images [bs, H, W, C]; sp_guide [bs, H, W, --guide_channel] of zeros for
    the click-guided models (the nf_inter task, UNetInter, InterUNet), else
    [bs, H, W, 1] filled with 0.5 under --use_spatial; context [bs, context
    length] under --use_context, for nf2 the pyramid [bs, 32, 32,
    n_scales]."""
    bs, h, w = args.batch_size, args.im_height, args.im_width
    if args.model == "UNet3D":
        depth = args.im_depth if args.im_depth > 0 else 8
        ch = 2 if getattr(args, "use_cascade", False) else 1
        feats = {"images": np.zeros((bs, depth, h, w, ch), np.float32)}
        if getattr(args, "use_spatial", False):
            gc = int(getattr(args, "guide_channel", 2))
            feats["sp_guide"] = np.zeros((bs, depth, h, w, gc), np.float32)
        return feats
    feats = {"images": np.zeros((bs, h, w, args.im_channel), np.float32)}
    if args.task == "nf_inter" or args.model in ("UNetInter", "InterUNet"):
        # these models consume a click guide unconditionally
        gc = int(getattr(args, "guide_channel", 2))
        feats["sp_guide"] = np.zeros((bs, h, w, gc), np.float32)
    elif getattr(args, "use_spatial", False):
        feats["sp_guide"] = np.full((bs, h, w, 1), 0.5, np.float32)
    if getattr(args, "use_context", False) and args.task == "nf2":
        # the nf2 image-patch pyramid (models/layers.PatchCNN's input)
        feats["context"] = np.zeros((bs, CT_PATCH, CT_PATCH,
                                     context_channels(args)), np.float32)
    elif getattr(args, "use_context", False):
        feats["context"] = np.zeros((bs, context_length(args)), np.float32)
    return feats


class Serve(nn.Module):
    """The exported function (JAX cli/export.py:47-58): images to float32,
    resized to ``size`` (bilinear with antialiasing, as jax.image.resize's
    "linear"; the identity at the exported shape), the model, softmax over
    the last axis.  A volume [bs, D, H, W, C] (UNet3D) must come at
    ``size``: JAX's resize takes a 4-D target shape and refuses rank-5
    images, so its UNet3D export fails where this one traces the identity."""

    def __init__(self, model: nn.Module, size):
        super().__init__()
        self.model = model
        self.size = (int(size[0]), int(size[1]))

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        images = features["images"].float()
        if images.ndim == 5 and tuple(images.shape[2:4]) != self.size:
            raise ValueError(f"volume {tuple(images.shape)}: H x W must be "
                             f"{self.size}")
        if images.ndim == 4 and tuple(images.shape[1:3]) != self.size:
            images = F.interpolate(images.permute(0, 3, 1, 2), size=self.size,
                                   mode="bilinear", align_corners=False,
                                   antialias=True).permute(0, 2, 3, 1)
        logits = self.model(dict(features, images=images))
        return torch.softmax(logits, dim=-1)


def export_model(args, dataset_dir=None, out_dir=None, device=None) -> Path:
    """Trace the serve function of the flagged model and write the bundle;
    returns its directory.  Weights: cli/main.restore_weights(export=True).
    ``device``: the flags' device (default ``--device``, which is the card
    unless ``--device cpu``), which must exist; the trace runs on the CPU
    (the module's docstring says why).  ``dataset_dir`` is unused (the JAX
    signature builds its trainer from it)."""
    if device is None:
        config_mod.resolve_device(args.device)
    feats = build_feature_template(args)
    model = _build_model(args)
    args.restored_from = restore_weights(args, model, export=True)
    model = model.cpu().eval()
    example = {k: torch.from_numpy(v) for k, v in feats.items()}
    with torch.no_grad():
        program = torch.export.export(
            Serve(model, (args.im_height, args.im_width)), (example,),
            strict=False)

    out = Path(out_dir or Path(args.model_dir) / "export")
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out / PROGRAM_FILE)
    torch.save({"model": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()}},
               out / STATE_FILE)
    signature = {
        "inputs": {k: [list(v.shape), str(v.dtype)] for k, v in feats.items()},
        "output": "softmax probabilities [bs, h, w, num_classes]",
        "model": args.model,
        "classes": ["Background"] + list(args.classes),
    }
    (out / SIGNATURE_FILE).write_text(json.dumps(signature, indent=2))
    return out


def load_exported(export_dir, device="cuda"):
    """Reload a bundle onto ``device`` ("cuda", which needs a GPU, or
    "cpu") → (serve, signature).  ``serve(features)`` takes a dict of
    arrays at the signature's shapes and returns the probabilities as a
    tensor on ``device``."""
    from torch.export.passes import move_to_device_pass

    from boxsegliver_torch.ops import kernels  # noqa: F401  the boxseg operators

    if not isinstance(device, torch.device):
        device = config_mod.resolve_device(device)
    export_dir = Path(export_dir)
    signature = json.loads((export_dir / SIGNATURE_FILE).read_text())
    program = torch.export.load(export_dir / PROGRAM_FILE)
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    module = program.module()
    keys = list(signature["inputs"])

    def serve(features):
        feats = {k: torch.as_tensor(features[k]).to(device) for k in keys}
        with torch.no_grad():
            return module(feats)

    return serve, signature
