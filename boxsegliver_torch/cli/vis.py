"""Drive an exported model for visualization (port of
boxsegliver_tpu/cli/vis.py; reference export_dir/vis.py:27-110 +
vis_nf.py): run the serving bundle of ``--mode export`` (cli/export.py)
over a prepared case and write prediction overlay PNGs.

    python -m boxsegliver_torch.cli.vis --export_dir <model_dir>/export \\
        --dataset_dir data/synthetic --pid 0 --out vis_out [--device cpu]

The bundle runs on ``--device``: the card by default (it raises where there
is none), the CPU only when asked for.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--export_dir", required=True)
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--pid", type=int, default=0)
    parser.add_argument("--out", default="vis_out")
    parser.add_argument("--im_channel", type=int, default=3)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import torch

    from boxsegliver_torch.cli.export import load_exported
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.eval_loader import parse_case_eval
    from boxsegliver_torch.ops.image_ops import resize_nearest
    from boxsegliver_torch.utils.viewer import save_case_overlays

    serve, signature = load_exported(args.export_dir, args.device)
    bs, h, w, c = signature["inputs"]["images"][0]

    metas = {int(m["PID"]): m for m in load_meta(args.dataset_dir)}
    case = parse_case_eval(metas[args.pid], args.dataset_dir,
                           im_channel=args.im_channel)
    preds = np.zeros((case.depth,) + case.segmentation.shape[1:], np.uint8)
    stack_c = case.lhc + case.rhc + 1
    for z0 in range(0, case.depth, bs):
        batch = np.zeros((bs, h, w, c), np.float32)
        n = min(bs, case.depth - z0)
        for j in range(n):
            img = np.transpose(case.volume[z0 + j:z0 + j + stack_c], (1, 2, 0))
            batch[j, :img.shape[0], :img.shape[1]] = img[:h, :w, :c]
        feats = {"images": batch}
        for key, (shape, dtype) in signature["inputs"].items():
            if key not in feats:
                feats[key] = (np.full(shape, 0.5, np.float32)
                              if key == "sp_guide"
                              else np.zeros(shape, np.float32))
        labels = serve(feats)[:n].argmax(-1).to(torch.uint8)
        preds[z0:z0 + n] = resize_nearest(
            labels, case.segmentation.shape[1:]).cpu().numpy()

    vol = case.volume[case.lhc:case.lhc + case.depth]
    out = save_case_overlays(vol, case.segmentation, preds, args.out,
                             f"case-{args.pid}")
    print(f"Overlays written to {out}")
    return out


if __name__ == "__main__":
    main()
