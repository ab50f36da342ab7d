"""Checkpoint-sweep evaluation (port of boxsegliver_tpu/cli/eval_all_ckpt.py;
reference run_scripts/eval_all_ckpt.sh): every ``ckpt_best/<tag>`` (the
interval bests ``best_<N>`` and the overall ``best``) scored with the online
2D eval — for UNet3D with EvaluateVolume3D.run over the test fold (the
whole-volume forward of evaluators/volume3d.make_volume_predict, blank click
guides, the frozen-2-D cascade channel under ``--use_cascade --ckpt_2d``) —,
the metrics collected into one table.

    python -m boxsegliver_torch.cli.eval_all_ckpt liver --mode eval --tag t \
        --model UNet --classes Liver Tumor [flags]

Writes ``<model_dir>/eval_sweep.txt`` (one JSON line per checkpoint tag).
Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import logging
import types
from pathlib import Path

logger = logging.getLogger("boxsegliver")


def sweep(args, dataset_dir, device):
    from boxsegliver_torch.cli.main import (_build_model, _make_online_eval,
                                            _test_metas, build_eval_cascade,
                                            is_3d)
    from boxsegliver_torch.train.checkpoint import STATE_FILE, model_state

    best_dir = Path(args.model_dir) / "ckpt_best"
    tags = sorted(p.name for p in best_dir.iterdir() if p.is_dir()) \
        if best_dir.exists() else []
    if not tags:
        raise SystemExit(f"No best checkpoints under {best_dir}")
    model = _build_model(args).to(device).eval()
    if is_3d(args):
        from boxsegliver_torch.evaluators.volume3d import (EvaluateVolume3D,
                                                           make_volume_predict)
        ev = EvaluateVolume3D(args, dataset_dir,
                              ["Background"] + list(args.classes))
        metas = _test_metas(args, dataset_dir)
        cascade = build_eval_cascade(args, device)
        # JAX's trainer.predict(_with_blank_guide(args, f)): probabilities
        # of the host-normalized volume, blank click guides
        predict = make_volume_predict(
            model, device, ret="prob", in_zscore=False,
            blank_guide_channels=int(args.guide_channel)
            if getattr(args, "use_spatial", False) else 0)

        def eval_fn(trainer):
            return ev.run(trainer.predict, metas, cascade=cascade)
    else:
        from boxsegliver_torch.evaluators.device_eval import \
            DeviceSlicePredictor
        predict = DeviceSlicePredictor(model, args, device=device)
        eval_fn = _make_online_eval(args, dataset_dir)
    # what the evals ask of a trainer: an eval-mode predict on a device, and
    # no summaries
    trainer = types.SimpleNamespace(predict=predict, device=device,
                                    global_step=0, summary=None)

    out_path = Path(args.model_dir) / "eval_sweep.txt"
    rows = []
    for tag in tags:
        path = best_dir / tag / STATE_FILE
        if not path.exists():
            logger.warning("Skipping unrestorable checkpoint %s", tag)
            continue
        model.load_state_dict(model_state(path), strict=True)
        results = eval_fn(trainer)
        row = {"ckpt": tag, **{k: float(v) for k, v in results.items()}}
        rows.append(row)
        logger.info("%s: %s", tag,
                    " ".join(f"{k}={v:.4f}" for k, v in results.items()))
    with out_path.open("w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    # summary: best checkpoint by the primary metric
    primary = getattr(args, "primary_metric", None)
    if primary and rows:
        best = max(rows, key=lambda r: r.get(primary, float("-inf")))
        logger.info("Best by %s: %s (%.4f)", primary, best["ckpt"],
                    best.get(primary, float("nan")))
    return rows


def main(argv=None):
    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.cli.main import get_args, resolve_dataset_dir
    from boxsegliver_torch.utils.logger import setup_logger

    args = get_args(argv)
    setup_logger(args.model_dir, "eval_sweep", args.tag, args.out_file)
    device = config_mod.resolve_device(args.device)
    return sweep(args, resolve_dataset_dir(args), device)


if __name__ == "__main__":
    main()
