#!/usr/bin/env python3
"""Time the port's eager train step (K = 1) of one checkout, to compare two
commits on the same card in one call (parent, change, change, parent).

    python3 tools/torch_step_time.py --root <checkout> [--seed 0]

Imports ``boxsegliver_torch`` from ``--root``, builds a synthetic LiTS-like
set (4 cases of 24 x 256 x 256) in a temporary directory, and runs the
flagship G-Net step (002_gnet_sp.sh train flags) and the headline UNet step
(001_unet.sh train flags) at batch 8 with --device_cache: 5 warm-up steps,
then 3 windows of 16 steps, each closed by one fetch of its values.  Prints
one JSON line: the median ms/step of each model and the card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

COMMON = ["--classes", "Liver", "Tumor", "--im_height", "256", "--im_width",
          "256", "--im_channel", "3", "--random_flip", "3", "--noise_scale",
          "0.05", "--loss_weight_type", "numerical", "--loss_numeric_w",
          "0.2", "0.4", "4.4", "--batch_size", "8", "--weight_decay_rate",
          "0.000001", "--learning_policy", "plateau", "--learning_rate",
          "0.001", "--lr_end", "0.0000005", "--device_cache", "--k_folds",
          "2", "--test_fold", "0", "--dataset", "ds"]
MODELS = {
    "gnet": ["--model", "GUNet", "--normalizer", "instance_norm",
             "--use_context", "--context_list", "hist", "200", "--hist_noise",
             "--use_spatial", "--spatial_random", "1.0",
             "--spatial_inner_random", "--center_random_ratio", "0.2",
             "--stddev_random_ratio", "0.4", "--min_std", "2"],
    "unet": ["--model", "UNet"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    import torch

    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.config import resolve_device
    from boxsegliver_torch.data.device_cache import DeviceVolumeCache
    from boxsegliver_torch.data.pipeline import TrainDataset
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    dev = resolve_device("cuda")
    out = {}
    with tempfile.TemporaryDirectory(prefix="step_time_") as tmp:
        ds = Path(tmp) / "ds"
        make_synthetic_dataset(ds, n_cases=4, shape=(24, 256, 256),
                               k_split=2, seed=opts.seed)
        for name, flags in MODELS.items():
            args = cli.get_args(["liver", "--mode", "train", "--tag", name]
                                + flags + COMMON + [
                                    "--data_root", tmp, "--model_dir",
                                    str(Path(tmp) / name)])
            pids, _ = cli._split_pids(args, ds)
            cache = DeviceVolumeCache(ds, [int(p) for p in pids], dev)
            trainer = cli.build_trainer(args, dev, cache=cache)
            data = TrainDataset(TrainSampler(ds, args, seed=1,
                                             zbase=cache.zbase), args,
                                seed=args.seed, workers=1)

            def window(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vals = [trainer.train_step(next(data))[0] for _ in range(n)]
                torch.stack(vals).cpu()
                return (time.perf_counter() - t0) / n

            try:
                window(5)
                walls = [window(16) for _ in range(3)]
            finally:
                data.close()
                trainer.summary.close()
            out[name] = {"ms_per_step": [w * 1e3 for w in walls],
                         "median_ms": statistics.median(walls) * 1e3}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"root": opts.root, "card": card, **out}))


if __name__ == "__main__":
    main()
