"""Main CLI of the port: training, unguided eval / infer of the UNet family,
guided eval / infer of the G-Net family, the NF tasks and the serving
export (port of boxsegliver_tpu/cli/main.py:33-95,186-547; reference
entry/main.py, entry/main_g.py, entry/main_export.py).

    python -m boxsegliver_torch.cli.main liver --mode train --tag 001_unet \
        --model UNet --classes Liver Tumor --test_fold 2 --im_height 256 \
        --im_width 256 --im_channel 3 --random_flip 3 --dataset LiTS \
        --noise_scale 0.05 --primary_metric Tumor/Dice \
        --secondary_metric Liver/Dice --loss_weight_type numerical \
        --loss_numeric_w 0.2 0.4 4.4 --batch_size 8 \
        --weight_decay_rate 0.000001 --learning_policy plateau \
        --learning_rate 0.001 --eval_per_epoch --evaluator Volume \
        --save_best                              # + 001_unet.sh's others
    python -m boxsegliver_torch.cli.main liver --mode eval --tag 001_unet \
        --model UNet ... --metrics_eval Dice VOE RVD --evaluator Volume
    python -m boxsegliver_torch.cli.main liver --mode train --tag 002_gnet_sp \
        --model GUNet --classes Liver Tumor --test_fold 2 --im_height 256 \
        --im_width 256 --im_channel 3 --random_flip 3 --dataset LiTS \
        --normalizer instance_norm --use_context --context_list hist 200 \
        --hist_noise --use_spatial --spatial_random 1.0 \
        --spatial_inner_random --center_random_ratio 0.2 \
        --stddev_random_ratio 0.4 --min_std 2 --noise_scale 0.05 \
        --primary_metric Tumor/Dice --secondary_metric Liver/Dice \
        --loss_weight_type numerical --loss_numeric_w 0.2 0.4 4.4 \
        --batch_size 8 --learning_policy plateau --eval_per_epoch \
        --evaluator Volume --save_best          # + 002_gnet_sp.sh's others
    python -m boxsegliver_torch.cli.main liver --mode eval ... --eval_mirror
    python -m boxsegliver_torch.cli.main liver --mode train --tag \
        003_denseunet --model DenseUNet --dropout 0.2 ... \
        [--load_weights densenet161_weights_tf.h5]  # 003_denseunet.sh
    python -m boxsegliver_torch.cli.main nf --mode train --tag 101_unet_v2 \
        --model UNet --classes NF --normalizer instance_norm \
        --batch_size 16 ...                     # run_scripts/nf/101_unet_v2.sh
    python -m boxsegliver_torch.cli.main nf_inter --mode train \
        --tag 101_unetinter_v10 --model UNetInter --use_spatial \
        --local_enhance --stddev 5. ...         # 101_unetinter_v10.sh
    python -m boxsegliver_torch.cli.main nf_3d --mode train --tag \
        201_unet_v1 --model UNet3D --classes NF --im_depth 10 \
        --batch_size 4 ...                      # threed/201_unet_v1.sh
    python -m boxsegliver_torch.cli.main nf2 --mode train --tag \
        004_gnet_iin --model GUNet --model_config GUNet_IIN.yml \
        --classes NF --use_context --ct_base 32 --use_spatial --zscore \
        --gamma --batch_size 8 ...              # template/004_gnet_iin.sh
    python -m boxsegliver_torch.cli.main nf2 --mode infer ... \
        --case_id 3 --pos 12 140 96             # one patch -> model_dir/infer

Runs on the GPU unless ``--device cpu`` is given.  ``--mode train`` trains
a 2D UNet or G-Net (batch or instance norm) with the online 2D eval per
epoch, or with ``--eval_3d`` the whole-volume eval of the held-out cases,
and writes checkpoints under ``--model_dir`` (train/checkpoint.py); the
``nf`` task trains on the NF data (clip window or ``--zscore``,
``--gamma``), ``nf_inter`` the click-simulation training of UNetInter,
GUNet, InterUNet, SmallUNet or LGNet (data/sampler_inter.py,
data/pipeline_inter.py; ``--geodesic`` guides; no ``--device_cache``, as
in JAX); the click-refinement eval is cli/interactive_eval.py.  ``--mode eval`` scores the test fold and
``--mode infer`` saves predictions: with the guided sweep (``run_g``) for
``--use_spatial`` models of the liver tasks — the device double sweep, or
the per-slice host loop under ``--device_sweep off`` —, with the NF
sp-point guides (``run_sp``) for ``nf --use_spatial``, else (or with
``--eval_no_sp``) with the unguided whole-volume eval (``run`` with a
DeviceSlicePredictor); ``nf_inter --mode eval`` runs the online 2D eval
over the fixed eval batches and appends its metrics to
``model_dir/eval_results_2d.txt``.  ``nf_3d`` (``--model UNet3D``)
trains on 3-D patches (data/sampler3d.py, data/pipeline3d.py; the
``--eval_per_epoch`` eval is evaluators/volume3d.EvaluateVolume3D) and
evaluates whole volumes (``--im_depth -1``), with the device sliding window
(``--im_depth > 0``), or with the frozen-2-D cascade channel
(``--use_cascade --ckpt_2d``, interactive/cascade.py).  ``nf2`` trains
the click-instance GUNet with the image-patch context (data/sampler_iin.py,
data/pipeline_iin.py: kernel B1 draws the one-click guide) and evaluates
per lesion patch (``EvaluateVolume.run_patch``, evaluators/iin_eval.py);
``--mode infer --case_id --pos`` predicts one patch.  Their weights come
from ``--ckpt_path`` (a checkpoint, a ``.pt`` state_dict or a ``.npz`` of
flattened flax variables), else from ``--model_dir``: the best checkpoint,
or the latest periodic one under ``--eval_final`` or when there is no best,
else a warm start from ``--warm_start_from`` / ``--load_weights``.
``--mode export`` writes the serving bundle of cli/export.py (weights as
eval's, the seeded init where there are none), which cli/serve.py serves.
Every branch of the JAX CLI is ported.

Data and spatial parallel (``--num_replicas``, JAX's mesh size;
parallel/mesh.py, parallel/spatial.py): training takes N =
``--num_replicas`` ranks, 0 meaning every visible GPU (one process with
``--device cpu``); the 2-D eval and infer take N only when
``--num_replicas > 1`` (JAX's eval mesh rule), and the whole-volume 3-D
eval (``--im_depth -1``) takes N = ``--z_shards`` when it is above 1.  With
N > 1 the CLI starts N spawned workers (NCCL, one GPU a rank; gloo with
``--device cpu``) that run the same command in a process group: training
over the global batch ``--batch_size`` (sync batch norm, one gradient
all-reduce a step); the unguided ``run`` and ``run_sp`` with each slice
batch split over the ranks and the probabilities gathered to rank 0; the
nf_inter online eval with each batch split and gathered; ``run_g``'s
device sweep with each TTA forward sharded over image height (its host
loop, ``--device_sweep off``, splits each slice's mirror batch); and the
3-D whole-volume eval with the volume's depth sharded.  Rank 0 writes
every file and log.  The nf2 eval, the sliding-window 3-D eval and
``--im_depth > 0`` use no mesh in JAX and run in one process.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

from boxsegliver_torch import config as config_mod
from boxsegliver_torch.utils.logger import setup_logger

TASKS = ("liver", "only_liver", "tumor", "nf", "nf2", "nf_inter", "nf_3d",
         "synthetic")


def get_args(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    task = "synthetic"
    if argv and not argv[0].startswith("-"):
        task = argv.pop(0)
    if task not in TASKS:
        raise SystemExit(f"Unknown task {task!r}; choose from {TASKS}")
    parser = config_mod.build_parser()
    args = parser.parse_args(argv)
    config_mod.check_args(args, parser)
    config_mod.fill_default_args(args)
    args.task = task
    if task == "nf_3d":  # reference entry/main.py nf_3d: the 3D NF pipeline
        args.task = "nf"
        if args.model != "UNet3D":
            parser.error("task nf_3d requires --model UNet3D")
    if args.dataset == "synthetic" and task != "synthetic":
        args.dataset = {"liver": "LiTS", "only_liver": "LiTS", "tumor": "LiTS",
                        "nf": "NF", "nf2": "NF", "nf_inter": "NF",
                        "nf_3d": "NF"}[task]
    return args


def resolve_dataset_dir(args) -> Path:
    if args.task == "synthetic" or args.dataset == "synthetic":
        nf_like = args.task.startswith("nf")
        root = Path(args.data_root) / ("synthetic_nf" if nf_like
                                       else "synthetic")
        if not (root / "meta.json").exists():
            from boxsegliver_torch.data.synthetic import make_synthetic_dataset
            make_synthetic_dataset(root, n_cases=4, shape=(24, 256, 256),
                                   k_split=args.k_folds,
                                   modality="nf" if nf_like else "liver")
        return root
    return Path(args.data_root) / args.dataset


def is_3d(args) -> bool:
    return args.model == "UNet3D"


def is_inter(args) -> bool:
    """nf_inter: the click-simulation training task (reference
    entry/main_g.py nf_inter + DataLoader/NF/input_pipeline_g_simply.py)."""
    return getattr(args, "task", "") == "nf_inter"


def is_iin(args) -> bool:
    """nf2: click-instance training + the per-lesion patch eval (reference
    entry/main_g.py:64-66 nf2 -> DataLoader/NF/input_pipeline_iin.py)."""
    return getattr(args, "task", "") == "nf2"


def _build_model(args):
    import torch

    from boxsegliver_torch.models import build_model, get_model_params

    params = get_model_params(args)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    return build_model(params["model"], args=args,
                       model_kwargs=params["model_kwargs"], dtype=dtype)


def checkpoint_path(args, eval_final: bool = False) -> Optional[Path]:
    """--ckpt_path, else model_dir's best checkpoint, else — under
    ``eval_final`` or when there is no best — its latest periodic one; None
    when model_dir holds no checkpoint."""
    from boxsegliver_torch.train.checkpoint import CheckpointManager

    if getattr(args, "ckpt_path", None):
        return Path(args.ckpt_path)
    ckpt = CheckpointManager(args.model_dir)
    if not eval_final and ckpt.has_best():
        return ckpt.best_path()
    return ckpt.latest_path()


def eval_checkpoint(args) -> Path:
    """The checkpoint eval restores (JAX evaluate's selection,
    cli/main.py:395-410, with --eval_final); FileNotFoundError when
    model_dir holds none."""
    path = checkpoint_path(args, getattr(args, "eval_final", False))
    if path is None:
        raise _no_checkpoint(args)
    return path


def _no_checkpoint(args) -> FileNotFoundError:
    return FileNotFoundError(f"no checkpoint under {args.model_dir}; train "
                             "first or pass --ckpt_path, --warm_start_from "
                             "or --load_weights")


def restore_weights(args, model, export: bool = False) -> str:
    """Load into ``model`` the weights eval (or, with ``export``, export)
    restores and return where they came from.  A checkpoint first (eval:
    eval_checkpoint's; export: --ckpt_path, else the best, else the latest,
    as JAX cli/export.py:28-36).  With none under --model_dir, JAX's
    trainer.restore at step 0 (train/trainer.py:315-343): the seeded init,
    warm started from --warm_start_from / --load_weights.  With neither
    flag, export takes the seeded init as JAX does; eval raises
    FileNotFoundError (JAX would score the seeded init)."""
    from boxsegliver_torch.train.checkpoint import model_state
    from boxsegliver_torch.train.trainer import warm_start_source

    path = checkpoint_path(args, not export
                           and getattr(args, "eval_final", False))
    if path is not None:
        model.load_state_dict(model_state(path), strict=True)
        return str(path)
    if not export and warm_start_source(args)[0] is None:
        raise _no_checkpoint(args)
    return initial_weights(args, model)


def initial_weights(args, model) -> str:
    """JAX's trainer.restore at step 0 (train/trainer.py:315-343): the
    seeded init of --seed, warm started from --warm_start_from /
    --load_weights when given; returns where the weights came from."""
    import torch

    from boxsegliver_torch.train.checkpoint import warm_start
    from boxsegliver_torch.train.trainer import warm_start_source

    src, scope_map = warm_start_source(args)
    model.reset_parameters(torch.Generator().manual_seed(int(args.seed)))
    if src is None:
        return f"the seeded init (--seed {args.seed})"
    warm_start(model, src, scope_map=scope_map)
    return f"a warm start from {src}"


def build_model_from_args(args, device):
    """The flagged model on ``device`` in eval mode, weights from
    restore_weights(args)."""
    model = _build_model(args)
    args.restored_from = restore_weights(args, model)
    return model.to(device).eval()


def main(argv=None):
    args = get_args(argv)
    device = config_mod.resolve_device(args.device)
    world = replicas(args, device)
    if world > 1:
        from boxsegliver_torch.parallel import launch
        return launch(_rank_main, world, device, args)
    return run(args, device)


def replicas(args, device) -> int:
    """Ranks of the run (module docstring): ValueError with JAX's text when
    N exceeds the devices or --batch_size does not divide N."""
    from boxsegliver_torch.parallel import (per_device_batch_size,
                                            resolve_replicas)

    n = int(getattr(args, "num_replicas", 0) or 0)
    if args.mode == "export":
        return 1
    if is_3d(args) and args.mode != "train":
        # JAX cli/main.py:443-457: --z_shards shards the whole-volume eval
        z = int(getattr(args, "z_shards", 0) or 0)
        return resolve_replicas(z, device) if z > 1 and \
            args.im_depth <= 0 else 1
    if args.mode == "train":
        world = resolve_replicas(n, device)
    elif n > 1 and not is_iin(args):
        world = resolve_replicas(n, device)
    else:
        return 1
    if world > 1:
        per_device_batch_size(int(args.batch_size), world)
    return world


def _rank_main(group, args):
    """One rank of a data-parallel CLI run (parallel.launch): rank 0's
    result is the command's."""
    device = config_mod.resolve_device(args.device)
    out = run(args, device, group)
    if args.mode == "train":
        return {"global_step": out.global_step}
    return out


def run(args, device, group=None):
    """The command on this process (one rank of ``group``, if given)."""
    import logging

    if group is None or group.chief:
        logger = setup_logger(args.model_dir, args.mode, args.tag,
                              args.out_file)
    else:
        logger = setup_logger(level=logging.WARNING)
    logger.info("Task %s, mode %s, model_dir %s", args.task, args.mode,
                args.model_dir)
    if group is not None:
        logger.info("Rank %d of %d (%s) on %s", group.rank, group.size,
                    group.backend, device)
    dataset_dir = resolve_dataset_dir(args)
    if args.mode == "export":
        from boxsegliver_torch.cli.export import export_model
        return export_model(args, dataset_dir, device=device)
    if args.mode == "train":
        return train(args, dataset_dir, logger, device, group)
    return evaluate(args, dataset_dir, logger, device,
                    do_eval=args.mode == "eval", group=group)


def build_trainer(args, device, cache=None, group=None):
    """Trainer of the flagged model, seeded from --seed, with the device
    augmentation of its task (cache: a DeviceVolumeCache for the index
    layout; group: the data-parallel group of this rank)."""
    import torch

    from boxsegliver_torch.train.trainer import Trainer

    if is_3d(args):
        from boxsegliver_torch.data.pipeline3d import make_preprocess_fn_3d
        preprocess_fn = make_preprocess_fn_3d(args, group=group)
    elif is_inter(args):
        from boxsegliver_torch.data.pipeline_inter import \
            make_inter_preprocess_fn
        preprocess_fn = make_inter_preprocess_fn(args, train=True,
                                                 group=group)
    elif is_iin(args):
        from boxsegliver_torch.data.pipeline_iin import make_iin_preprocess_fn
        preprocess_fn = make_iin_preprocess_fn(args, train=True, group=group)
    else:
        from boxsegliver_torch.data.pipeline import make_preprocess_fn
        preprocess_fn = make_preprocess_fn(args, cache=cache, group=group)
    model = _build_model(args)
    model.reset_parameters(torch.Generator().manual_seed(int(args.seed)))
    return Trainer(model, args, ["Background"] + list(args.classes), device,
                   preprocess_fn=preprocess_fn,
                   save_ckpt_steps=int(getattr(args, "save_ckpt_steps", 5000)),
                   group=group)


def _test_metas(args, dataset_dir):
    """The metas of the test fold's cases, in meta.json order."""
    from boxsegliver_torch.data.meta import load_meta

    _, test_pids = _split_pids(args, dataset_dir)
    test_pids = set(int(p) for p in test_pids)
    return [m for m in load_meta(dataset_dir) if int(m["PID"]) in test_pids]


def _split_pids(args, dataset_dir):
    from boxsegliver_torch.data.kfold import (LITS_SEED, read_or_create_k_folds,
                                              train_test_split)
    from boxsegliver_torch.data.meta import load_meta

    metas = load_meta(dataset_dir)
    folds = read_or_create_k_folds(
        Path(dataset_dir) / "k_folds.txt", [m["PID"] for m in metas],
        k_split=args.k_folds, seed=LITS_SEED)
    return train_test_split(folds, args.test_fold)


def train(args, dataset_dir, logger, device, group=None):
    from boxsegliver_torch.data.pipeline import TrainDataset
    from boxsegliver_torch.data.sampler import TrainSampler

    cache = None
    if getattr(args, "device_cache", False) and not is_inter(args) \
            and not is_3d(args) and not is_iin(args):
        from boxsegliver_torch.data.device_cache import DeviceVolumeCache
        train_pids, _ = _split_pids(args, dataset_dir)
        try:
            cache = DeviceVolumeCache(dataset_dir, [int(p) for p in train_pids],
                                      device, budget_gb=args.device_cache_gb)
        except MemoryError as e:
            logger.warning("--device_cache disabled (%s); falling back to "
                           "the streaming host sampler", e)

    trainer = build_trainer(args, device, cache=cache, group=group)
    start = trainer.restore()
    logger.info("Starting at global step %d on %s", start, device)
    if is_3d(args):
        from boxsegliver_torch.data.sampler3d import Sampler3D
        cascade2d = None
        if getattr(args, "use_cascade", False) and getattr(args, "use_2d",
                                                           False):
            if not getattr(args, "ckpt_2d", None):
                raise SystemExit("--use_cascade --use_2d needs --ckpt_2d")
            cascade2d = build_cascade2d(args, device)
        sampler = Sampler3D(dataset_dir, args, mode="train", seed=args.seed,
                            cascade2d=cascade2d)
    elif is_inter(args):
        from boxsegliver_torch.data.sampler_inter import InterSampler
        sampler = InterSampler(dataset_dir, args, mode="train",
                               seed=args.seed, max_clicks=args.max_clicks)
    elif is_iin(args):
        from boxsegliver_torch.data.sampler_iin import IinSampler
        sampler = IinSampler(dataset_dir, args, mode="train", seed=args.seed)
    else:
        sampler = TrainSampler(dataset_dir, args, mode="train",
                               seed=args.seed,
                               zbase=cache.zbase if cache else None)
    workers = None
    if group is not None:
        # every rank takes its rows of the same global batches: one host
        # worker keeps the seeded stream's order
        workers = 1
        logger.info("One host sampler worker a rank (--host_workers %d "
                    "would reorder the global batches between ranks)",
                    args.host_workers)
    dataset = TrainDataset(sampler, args, seed=args.seed, workers=workers)
    eval_fn = None
    if args.eval_per_epoch and is_3d(args):
        from boxsegliver_torch.evaluators.volume3d import EvaluateVolume3D
        ev3 = EvaluateVolume3D(args, dataset_dir,
                               ["Background"] + list(args.classes))
        metas = _test_metas(args, dataset_dir)
        metas = metas if args.eval_num <= 0 else metas[:args.eval_num]

        def eval_fn(trainer):
            return ev3.run(
                lambda f: trainer.predict(_with_blank_guide(args, f)), metas)
    elif args.eval_per_epoch and args.eval_3d and not is_inter(args):
        # the whole-volume eval of the held-out cases (reference --eval_3d)
        from boxsegliver_torch.evaluators.volume import (EvaluateVolume,
                                                         make_inline_eval_fn)
        evaluator = EvaluateVolume(args, dataset_dir,
                                   ["Background"] + list(args.classes),
                                   group=group)
        eval_fn = make_inline_eval_fn(evaluator, _test_metas(args,
                                                             dataset_dir),
                                      max_cases=args.eval_num)
    elif args.eval_per_epoch:
        eval_fn = _make_online_eval(args, dataset_dir)
    max_steps = args.num_of_steps or args.num_of_total_steps
    try:
        trainer.train(dataset, max_steps=max_steps, eval_fn=eval_fn)
    finally:
        dataset.close()
        if trainer.summary is not None:
            trainer.summary.close()
    logger.info("Training finished at step %d", trainer.global_step)
    return trainer


def _make_online_eval(args, dataset_dir, num_batches: int = 0):
    """OnlineEval2D over the eval split with the deterministic eval-mode
    device processing: the inter pipeline on InterSampler's fixed eval
    batches (EVAL_ZOOM, EVAL_SEED; reference get_val_loader) for nf_inter,
    the IIN pipeline on IinSampler(tumor_percent=0, spatial_random=1) for
    nf2 (reference get_dataset_for_eval_online, input_pipeline_iin.py:
    658-672), else the plain pipeline without noise, flips or gamma on
    TrainSampler's host layout, the one JAX's CLI evaluates (reference 2D
    batch-metric averaging)."""
    import functools

    from boxsegliver_torch.evaluators.online2d import OnlineEval2D

    if is_inter(args):
        from boxsegliver_torch.data.pipeline_inter import \
            make_inter_preprocess_fn
        from boxsegliver_torch.data.sampler_inter import InterSampler
        sampler = InterSampler(dataset_dir, args, mode="eval",
                               max_clicks=args.max_clicks)
        process_fn = make_inter_preprocess_fn(args, train=False)
    elif is_iin(args):
        from boxsegliver_torch.data.pipeline_iin import make_iin_preprocess_fn
        from boxsegliver_torch.data.sampler_iin import IinSampler
        sampler = IinSampler(dataset_dir, args, mode="eval",
                             tumor_percent=0.0, spatial_random=1.0)
        process_fn = make_iin_preprocess_fn(args, train=False)
    else:
        from boxsegliver_torch.data.pipeline import (_process_batch,
                                                     norm_statics)
        from boxsegliver_torch.data.sampler import TrainSampler
        sampler = TrainSampler(dataset_dir, args, mode="eval",
                               resize_on_host=True)
        statics = norm_statics(args)
        statics["use_gamma"] = False  # deterministic eval processing
        process_fn = functools.partial(
            _process_batch, im_h=args.im_height, im_w=args.im_width,
            noise_scale=0.0, random_flip=0,
            use_spatial=bool(getattr(args, "use_spatial", False)),
            min_std=float(getattr(args, "min_std", 2.0)), **statics)
    return OnlineEval2D(sampler, args, process_fn,
                        ["Background"] + list(args.classes),
                        num_batches=num_batches,
                        use_global_dice=bool(getattr(args, "use_global_dice",
                                                     False)))


def _inter_eval(args, dataset_dir, logger, device, group=None):
    """nf_inter --mode eval: batch-averaged metrics over the fixed
    validation batches (reference get_val_loader, NF/input_pipeline_g_simply
    .py:668-686), appended as one JSON line to model_dir/eval_results_2d.txt
    (JAX cli/main.py:412-426); under a group each batch is split over the
    ranks and rank 0 writes the line."""
    import json
    import types

    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor

    model = build_model_from_args(args, device)
    logger.info("Restored %s from %s on %s", args.model, args.restored_from,
                device)
    runner = types.SimpleNamespace(
        device=device, global_step=0, summary=None,
        predict=DeviceSlicePredictor(model, args, device=device,
                                     group=group))
    results = _make_online_eval(args, dataset_dir)(runner)
    if group is not None and not group.chief:
        return results
    out = Path(args.model_dir) / "eval_results_2d.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        json.dump({"results": results}, f)
        f.write("\n")
    logger.info("Online eval: %s", results)
    return results


def _iin_eval(args, dataset_dir, logger, device, do_eval=True):
    """nf2 eval / infer (JAX cli/main.py:476-500): ``--mode infer --case_id
    --pos z y x`` predicts the one patch at --pos and writes its npz under
    model_dir/infer/; else the per-lesion patch eval run_patch over the
    test fold (``--eval_mirror``: the mirror variants in one forward a
    batch), scoring (eval) or saving (infer) each case."""
    from boxsegliver_torch.evaluators.iin_eval import (make_patch_predict,
                                                       run_patch_infer)
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    model = build_model_from_args(args, device)
    logger.info("Restored %s from %s on %s", args.model, args.restored_from,
                device)
    mirror = bool(getattr(args, "eval_mirror", False))
    if not do_eval and getattr(args, "case_id", None) is not None:
        if not getattr(args, "pos", None):
            raise SystemExit("nf2 --mode infer needs --pos z y x")
        from boxsegliver_torch.data.meta import load_meta
        meta = {int(m["PID"]): m
                for m in load_meta(dataset_dir)}[int(args.case_id)]
        out = run_patch_infer(make_patch_predict(model, device), meta,
                              dataset_dir, args)
        return {"infer_path": str(out)}
    predict = make_patch_predict(model, device, int(args.random_flip),
                                 mirror=mirror)
    evaluator = EvaluateVolume(args, dataset_dir,
                               ["Background"] + list(args.classes))
    return evaluator.run_patch(predict, _test_metas(args, dataset_dir),
                               save=args.save_predict or not do_eval,
                               do_eval=do_eval)


def _with_blank_guide(args, feats):
    """UNet3D eval without interactions: zero click guides (reference
    threed_script eval defaults)."""
    import numpy as np

    if getattr(args, "use_spatial", False) and "sp_guide" not in feats:
        shape = feats["images"].shape[:-1] + (int(args.guide_channel),)
        feats = dict(feats, sp_guide=np.zeros(shape, np.float32))
    return feats


def build_frozen_2d_predict(args, device):
    """The frozen click-guided 2-D model of --model_2d with --ckpt_2d's
    weights (reference entry/infer_2d.py:32-80 InferenceWithGuide2D; JAX
    cli/main.py:124-151): a predict function of device tensors
    {"images" [n, H, W, --im_channel], "sp_guide" [n, H, W, 2]} →
    probabilities."""
    import torch

    from boxsegliver_torch.models import build_model, load_model_config
    from boxsegliver_torch.train.checkpoint import warm_start

    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    kw = dict(load_model_config(args.model_2d), guide_channels=2,
              sp_channels=2, in_channels=int(args.im_channel))
    model = build_model(args.model_2d, args=args, model_kwargs=kw,
                        num_classes=len(args.classes) + 1, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    warm_start(model, args.ckpt_2d)
    model = model.to(device).eval()

    @torch.no_grad()
    def predict(feats):
        return torch.softmax(model(feats), dim=-1)

    return predict


def build_cascade2d(args, device):
    """CascadeClick2D for the training-time frozen-2-D cascade channel."""
    from boxsegliver_torch.interactive.cascade import CascadeClick2D

    return CascadeClick2D(build_frozen_2d_predict(args, device),
                          im_height=args.im_height, im_width=args.im_width,
                          im_channel=args.im_channel, device=device)


def build_eval_cascade(args, device):
    """Whole-volume Cascade2D of the eval paths, or None without
    --use_cascade and --ckpt_2d (the frozen 2-D model runs click-less, with
    blank guides)."""
    if not (getattr(args, "use_cascade", False)
            and getattr(args, "ckpt_2d", None)):
        return None
    import torch

    from boxsegliver_torch.interactive.cascade import Cascade2D

    p2d = build_frozen_2d_predict(args, device)

    def p2d_blank(feats):
        if "sp_guide" not in feats:
            x = feats["images"]
            feats = dict(feats, sp_guide=torch.zeros(
                x.shape[:-1] + (2,), device=x.device))
        return p2d(feats)

    return Cascade2D(p2d_blank, batch_size=args.batch_size,
                     im_channel=args.im_channel,
                     channel_mode="binary" if args.cascade_binary else "edt",
                     tau=25.0, device=device)


def _evaluate_3d(args, dataset_dir, logger, device, do_eval=True,
                 group=None):
    """UNet3D eval (JAX cli/main.py:436-474): the whole-volume fast path
    (z-score and argmax on the device, blank guides there), the device
    sliding window at ``--im_depth > 0``, or the host-normalized
    whole-volume forward when a cascade channel is set; the whole-volume
    forward depth-sharded over ``group`` (``--z_shards``)."""
    from boxsegliver_torch.evaluators.volume3d import (EvaluateVolume3D,
                                                       make_sliding_predict,
                                                       make_volume_predict)

    model = build_model_from_args(args, device)
    logger.info("Restored %s from %s on %s", args.model, args.restored_from,
                device)
    ev3 = EvaluateVolume3D(args, dataset_dir,
                           ["Background"] + list(args.classes), group=group)
    cascade = build_eval_cascade(args, device)
    gc = int(args.guide_channel) if getattr(args, "use_spatial",
                                            False) else 0
    whole = args.im_depth <= 0
    no_cascade = cascade is None and not getattr(args, "use_cascade", False)
    if not whole:
        predict = make_sliding_predict(
            model, device, (args.im_depth, args.im_height, args.im_width),
            num_classes=len(args.classes) + 1, ret="pred",
            in_zscore=no_cascade, blank_guide_channels=gc)
    else:
        fast = no_cascade
        predict = make_volume_predict(
            model, device, ret="pred" if fast else "prob", in_zscore=fast,
            blank_guide_channels=gc, group=group,
            z_axis_shards=0 if group is None else group.size)
    return ev3.run(predict, _test_metas(args, dataset_dir), do_eval=do_eval,
                   cascade=cascade)


def evaluate(args, dataset_dir, logger, device, do_eval=True, group=None):
    """Eval / infer of the flagged model (cli.main's docstring); under a
    ``group`` (replicas) the unguided ``run``, ``run_sp``, ``run_g``'s host
    loop and the nf_inter online eval split each batch over the ranks,
    ``run_g``'s device sweep shards each image's height and the 3-D
    whole-volume eval the volume's depth."""
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    if is_3d(args):
        return _evaluate_3d(args, dataset_dir, logger, device, do_eval, group)
    if is_iin(args):
        return _iin_eval(args, dataset_dir, logger, device, do_eval)
    if is_inter(args):
        return _inter_eval(args, dataset_dir, logger, device, group)
    spatial = bool(getattr(args, "use_spatial", False))
    sp_point = spatial and args.task == "nf"
    guided = spatial and not getattr(args, "eval_no_sp", False)

    model = build_model_from_args(args, device)
    logger.info("Restored %s from %s on %s", args.model, args.restored_from,
                device)
    eval_metas = _test_metas(args, dataset_dir)
    evaluator = EvaluateVolume(args, dataset_dir,
                               ["Background"] + list(args.classes),
                               group=group)
    save = args.save_predict or not do_eval
    # the whole-case device predictor: one upload per case, 2.5D gather +
    # mirror TTA + averaging on the device; its plain per-batch forward
    # serves run_g's per-slice host loop under --device_sweep off
    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor
    predictor = DeviceSlicePredictor(model, args, device=device, group=group)
    if sp_point:
        # NF: the fixed sp-point guides (reference get_dataset_for_sp_point)
        return evaluator.run_sp(predictor, eval_metas, save=save,
                                do_eval=do_eval)
    if not guided:
        return evaluator.run(predictor, eval_metas, save=save,
                             do_eval=do_eval)
    if getattr(args, "device_sweep", "on") != "on":
        return evaluator.run_g(predictor, eval_metas, save=save,
                               do_eval=do_eval)

    from boxsegliver_torch.interactive.device_sweep import GuidedSweepPredictor

    # same id rule as run_g (base strips Background from classes)
    fg = [c for c in args.classes if c != "Background"]
    tumor_id = fg.index("Tumor") + 1 if "Tumor" in fg else len(fg)
    predictor = GuidedSweepPredictor(model, args, num_classes=len(fg) + 1,
                                     tumor_id=tumor_id, device=device,
                                     group=group)
    return evaluator.run_g(predictor, eval_metas, save=save, do_eval=do_eval)


if __name__ == "__main__":
    main()
