"""Device-resident volume cache: train without per-step pixel uploads (port
of boxsegliver_tpu/data/device_cache.py).

When the training split's volumes fit a memory budget, all case slices are
uploaded once as two stacked tensors (volume / label, concatenated along
z).  Each train step then ships only per-sample slice indices and crop
scalars: the device pipeline gathers the 2.5D slice window from the cache,
crops, resizes and augments (data/pipeline.py).

torch's ``uint16`` lacks most CUDA operations (indexing among them), so the
volume is kept as the same 2 bytes per voxel viewed as ``int16`` and
widened on gather (``widen``); a LiTS training split at 512^2 is ~30 GB as
uint16, so doubling it to int32 is not an option.

Datasets larger than the budget raise MemoryError; the CLI then logs it and
keeps the streaming sampler (TrainSampler's device-resize layout), as the
JAX package does.  Under a data-parallel group every rank uploads its own
copy to its device (JAX's replicated sharding, device_cache.py:44,74).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("boxsegliver")


def widen(vol16: torch.Tensor) -> torch.Tensor:
    """int16 view of uint16 voxels -> their int32 values."""
    return vol16.int() & 0xFFFF


class DeviceVolumeCache:
    """All case volumes of a split, stacked along z and resident on a device.

    Attributes:
        volume: [Z_total, H, W] int16 tensor (uint16 voxels, see ``widen``)
        label:  [Z_total, H, W] uint8 tensor
        zbase:  {pid: (z_offset, depth)} index table shared with the sampler
    """

    def __init__(self, dataset_dir, pids: Sequence[int], device,
                 budget_gb: float = 8.0):
        root = Path(dataset_dir)
        vols, labs = [], []
        self.zbase: Dict[int, Tuple[int, int]] = {}
        z = 0
        hw: Optional[Tuple[int, int]] = None
        total = 0
        for pid in pids:
            pid = int(pid)
            vol = np.load(root / f"volume-{pid}" / "volume.npy", mmap_mode="r")
            lab = np.load(root / f"volume-{pid}" / "segmentation.npy",
                          mmap_mode="r")
            if hw is None:
                hw = vol.shape[1:]
            elif vol.shape[1:] != hw:
                raise ValueError(
                    f"device cache needs uniform in-plane shapes; case {pid} "
                    f"is {vol.shape[1:]} vs {hw}")
            total += vol.shape[0] * vol.shape[1] * vol.shape[2] * 3  # u16+u8
            if total > budget_gb * 1e9:
                raise MemoryError(
                    f"device cache would need >{budget_gb} GB of device "
                    f"memory ({total / 1e9:.1f} GB at case {pid}); use the "
                    f"streaming sampler or raise --device_cache_gb")
            vols.append(vol)
            labs.append(lab)
            self.zbase[pid] = (z, vol.shape[0])
            z += vol.shape[0]

        vol_host = np.concatenate([np.asarray(v, np.uint16) for v in vols])
        lab_host = np.concatenate([np.asarray(l, np.uint8) for l in labs])
        self.volume = torch.from_numpy(vol_host.view(np.int16)).to(device)
        self.label = torch.from_numpy(lab_host).to(device)
        self.nbytes = vol_host.nbytes + lab_host.nbytes
        logger.info("Device volume cache: %d cases, %d slices, %.2f GB on %s",
                    len(pids), z, self.nbytes / 1e9, device)
