"""Composed flag registry of the PyTorch port (own copy of
boxsegliver_tpu/config.py: same flag names, defaults and validation).

Differences from the JAX registry:
- ``--device`` (cuda | cpu) selects where the port runs; cuda is the default
  and there is no silent fall back to the CPU (``resolve_device``).
- ``--lane_pack`` is accepted and ignored: the width-packed stage is a TPU
  layout (models/packed.py of the JAX package) and is not ported.
- ``build_parser`` offers the port's model zoo.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def add_arguments(parser: argparse.ArgumentParser):
    """Global + device flags (reference config.py:26-79)."""
    group = parser.add_argument_group(title="Global Arguments")
    group.add_argument("--mode", type=str,
                       choices=["train", "eval", "infer", "export"],
                       required=True, help="Model mode for train/val/test")
    group.add_argument("--tag", type=str, required=True,
                       help="Configuration tag (like UID)")
    group.add_argument("--model_dir", type=str, default="",
                       help="Directory to save model parameters, logs, etc.")
    group.add_argument("-s", "--save_predict", action="store_true",
                       help="Save prediction to file")
    group.add_argument("--warm_start_from", type=str,
                       help="Warm start the model from a checkpoint")
    group.add_argument("-l", "--load_status_file", type=str, default="checkpoint",
                       help="Status file to locate checkpoint for restore")
    group.add_argument("--out_file", type=str,
                       help="Logging file name to replace default")
    group.add_argument("--summary_prefix", type=str,
                       help="String prepended to summary tags (default: tag)")
    group.add_argument("--save_best", action="store_true",
                       help="Save best checkpoint")
    group.add_argument("--save_best_ma", action="store_true",
                       help="Track best by metric moving average (the "
                            "reference G-Net entry's EvaluatorHookV2)")
    group.add_argument("--ma_alpha", type=float, default=0.9,
                       help="Moving-average factor for --save_best_ma")
    group.add_argument("--save_interval", type=int, default=0,
                       help="Save best checkpoint in each interval")
    group.add_argument("--log_step", type=int, default=500,
                       help="Log running information per `log_step`")
    group.add_argument("--save_ckpt_steps", type=int, default=5000,
                       help="Periodic checkpoint cadence (reference saves "
                            "every 5000 steps, entry/main.py:143)")
    group.add_argument("--min_delta", type=float, default=5e-4,
                       help="min_delta for plateau lr strategy")
    group.add_argument("--seed", type=int, default=1234,
                       help="Base PRNG seed (new: single keyed-PRNG story)")

    group = parser.add_argument_group(title="Device Arguments")
    group.add_argument("--num_replicas", "--num_gpus", dest="num_replicas",
                       type=int, default=0,
                       help="Data-parallel ranks, one process a device "
                            "(parallel/mesh.py). Training: 0 = all visible "
                            "GPUs (one process with --device cpu); eval: "
                            "ranks only above 1")
    group.add_argument("--compute_dtype", type=str, default="bfloat16",
                       choices=["bfloat16", "float32"],
                       help="Activation compute dtype (params stay float32)")
    group.add_argument("--metrics_train_steps", type=int, default=0,
                       help="Cadence for COMPUTING in-graph train metrics "
                            "(lax.cond-gated; structure is step-invariant, "
                            "zeros off-cadence). 0 = follow --log_step — the "
                            "reference's TF1 cost model, which only executes "
                            "the metric subgraph on fetched steps. 1 = every "
                            "step.")
    group.add_argument("--metrics_fetch_steps", type=int, default=16,
                       help="Train-loop metric drain cadence: device metric "
                            "arrays are fetched to host in ONE bulk transfer "
                            "every N steps so the device pipeline never "
                            "stalls on a host round trip")
    group.add_argument("--steps_per_dispatch", type=int, default=1,
                       help="Run K train steps per dispatch: K raw "
                            "batches staged at once and, on the GPU, the "
                            "train step captured in a CUDA graph and "
                            "replayed K times (the JAX package's lax.scan "
                            "over K stacked batches).  Requires the device "
                            "preprocess.  Host hooks see metrics with <=K "
                            "extra steps of lag; epoch-eval cadence is "
                            "quantized to K.")
    group.add_argument("--fix", action="store_true",
                       help="Remove norm+relu in spatial guide module")
    group.add_argument("--device", type=str, default="cuda",
                       choices=["cuda", "cpu"],
                       help="Device of the port; cuda raises when no GPU is "
                            "present, cpu must be asked for explicitly")


def add_model_arguments(parser: argparse.ArgumentParser, model_choices):
    """Model flags (reference core/models.py:41-89)."""
    group = parser.add_argument_group(title="Model Arguments")
    group.add_argument("--model", type=str, choices=list(model_choices),
                       required=True, help="Model backbone")
    group.add_argument("--model_config", type=str,
                       help="Model configuration. (default: <model>.yml)")
    group.add_argument("--classes", type=str, nargs="+", required=True,
                       help="Class names of the objects")
    group.add_argument("--batch_size", type=int, default=8,
                       help="Global batch size (divided across replicas)")
    group.add_argument("--weight_init", type=str, default="xavier",
                       choices=["trunc_norm", "xavier"],
                       help="Model variable initialization method")
    group.add_argument("--lane_pack", type=str, default="auto",
                       choices=["auto", "on", "off"],
                       help="Accepted for flag compatibility and ignored: "
                            "the width-packed stage is a TPU layout")
    group.add_argument("--normalizer", type=str, default="batch_norm",
                       choices=["batch_norm", "instance_norm"],
                       help="Normalization method")
    group.add_argument("--cls_branch", action="store_true", help="Classify branch")
    group.add_argument("--load_weights", type=str,
                       help="Initialize model parameters from this checkpoint")
    group.add_argument("--load_weights_version", type=str, default="checkpoint",
                       help="Used for latest_filename")
    group.add_argument("--weights_scope", type=str,
                       help="'old=new[,old2=new2]': rename top-level scopes "
                            "of the --load_weights source before the "
                            "partial restore")
    group.add_argument("--without_norm", action="store_true",
                       help="Conv without normalization")
    group.add_argument("--batches_per_epoch", type=int, default=2000,
                       help="Number of batches per epoch")
    group.add_argument("--eval_per_epoch", action="store_true")
    group.add_argument("--dropout", type=float,
                       help="Dropout for backbone networks")
    group.add_argument("--img_grad", action="store_true",
                       help="Use image gradients")
    group.add_argument("--mid_cat", action="store_true",
                       help="Concat guide to middle layers")


def add_solver_arguments(parser: argparse.ArgumentParser):
    """Training/LR flags (reference core/solver.py:23-82)."""
    group = parser.add_argument_group(title="Training Arguments")
    group.add_argument("--learning_rate", type=float, default=1e-3)
    group.add_argument("--learning_policy", type=str, default="period_step",
                       choices=["custom_step", "period_step", "poly", "plateau"])
    group.add_argument("--num_of_steps", type=int, default=0,
                       help="Number of steps for training")
    group.add_argument("--num_of_total_steps", type=int, default=1000,
                       help="Number of total steps for training")
    group.add_argument("--lr_decay_boundaries", type=int, nargs="*",
                       help="custom_step policy boundaries")
    group.add_argument("--lr_custom_values", type=float, nargs="+",
                       help="custom_step policy values "
                            "(len(values) - len(boundaries) = 1)")
    group.add_argument("--lr_decay_step", type=int, default=int(1e5))
    group.add_argument("--lr_decay_rate", type=float, default=0.1)
    group.add_argument("--lr_power", type=float, default=0.9)
    group.add_argument("--lr_end", type=float, default=1e-6)
    group.add_argument("--optimizer", type=str, default="Adam",
                       choices=["Adam", "Momentum", "AdamW"])
    group.add_argument("--lr_warm_up", action="store_true",
                       help="Warm up with a low learning rate")
    group.add_argument("--slow_start_step", type=int, default=1000)
    group.add_argument("--slow_start_lr", type=float, default=1e-4)
    group.add_argument("--adam_beta1", type=float)
    group.add_argument("--adam_beta2", type=float)
    group.add_argument("--adam_eps", type=float)
    group.add_argument("--opt_moment_dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"],
                       help="Storage dtype of Adam moments (update math stays "
                            "float32). bfloat16 halves optimizer-state HBM "
                            "traffic per step; changing it between runs is "
                            "checkpoint-incompatible (opt_state dtypes)")
    group.add_argument("--mm_mm", type=float)
    group.add_argument("--mm_nesterov", action="store_true")
    group.add_argument("--lr_patience", type=int, default=30,
                       help="Plateau LR patience (unit: epoch)")
    group.add_argument("--tr_patience", type=int, default=0,
                       help="Early-stop patience after last LR decay (0 = off)")


def add_loss_arguments(parser: argparse.ArgumentParser):
    """Loss/metric flags (reference loss_metrics.py:26-67)."""
    group = parser.add_argument_group(title="Loss Arguments")
    group.add_argument("--weight_decay_rate", type=float, default=1e-5)
    group.add_argument("--bias_decay", action="store_true")
    group.add_argument("--loss_type", type=str, default="xentropy",
                       choices=["xentropy", "dice", "xentropy+dice"])
    group.add_argument("--loss_weight_type", type=str, default="none",
                       choices=["none", "numerical", "proportion", "boundary"])
    group.add_argument("--loss_numeric_w", type=float, nargs="+")
    group.add_argument("--loss_proportion_decay", type=float, default=1000)
    group.add_argument("--metrics_train", type=str, default=["Dice"],
                       choices=["Dice", "VOE", "VD"], nargs="+")
    group.add_argument("--metrics_eval", type=str, default=["Dice"],
                       choices=["Dice", "VOE", "RVD", "ASSD", "RMSD", "MSD"],
                       nargs="+")


def add_pipeline_arguments(parser: argparse.ArgumentParser):
    """Input pipeline flags (reference Liver/input_pipeline_g.py:71-125)."""
    group = parser.add_argument_group(title="Input Pipeline Arguments")
    group.add_argument("--dataset", type=str, default="synthetic",
                       help="Dataset name / directory under --data_root")
    group.add_argument("--data_root", type=str, default="data",
                       help="Root directory with prepared datasets")
    group.add_argument("--test_fold", type=int, default=2)
    group.add_argument("--k_folds", type=int, default=5)
    group.add_argument("--im_height", type=int, default=256)
    group.add_argument("--im_width", type=int, default=256)
    group.add_argument("--im_depth", type=int, default=-1,
                       help="3D patch depth (-1 = whole volume at eval)")
    group.add_argument("--im_channel", type=int, default=3)
    group.add_argument("--filter_size", type=int, default=0,
                       help="Filter tumors smaller than the given size")
    group.add_argument("--noise_scale", type=float, default=0.1)
    group.add_argument("--zoom_scale", type=float, nargs=2, default=[1.0, 1.4])
    group.add_argument("--random_flip", type=int, default=1,
                       help="0 none, 1 left/right, 2 up/down, 3 both")
    group.add_argument("--w_width", type=float, default=550.0,
                       help="CT window width (HU)")
    group.add_argument("--w_level", type=float, default=25.0,
                       help="CT window level (HU)")
    group.add_argument("--random_window", action="store_true",
                       help="Randomly perturb window width/level in training")
    group.add_argument("--zscore", "--use_zscore", dest="zscore",
                       action="store_true",
                       help="Z-score normalization; disables window/level "
                            "(NF MRI pipelines, reference "
                            "NF/input_pipeline_g.py:86)")
    group.add_argument("--gamma", "--use_gamma", dest="gamma",
                       action="store_true",
                       help="Gamma augmentation (NF pipelines, reference "
                            "NF/input_pipeline_g.py:87)")
    group.add_argument("--no_gamma", action="store_true",
                       help="Disable gamma augmentation in the nf_inter "
                            "pipeline (the reference applies it always there, "
                            "NF/input_pipeline_g_simply.py:510-513)")
    group.add_argument("--gamma_range", type=float, nargs=2, default=[0.7, 1.5])
    group.add_argument("--tumor_percent", type=float, default=0.5,
                       help="Fraction of training crops centered on tumors")
    group.add_argument("--guide_percent", type=float, default=0.66,
                       help="Fraction of training crops inside the organ bbox")
    group.add_argument("--eval_in_patches", action="store_true")
    group.add_argument("--eval_num_batches_per_epoch", type=int, default=100)
    group.add_argument("--eval_mirror", action="store_true")
    group.add_argument("--host_workers", type=int, default=4,
                       help="Host sampler worker threads")
    group.add_argument("--device_cache", action="store_true",
                       help="Keep the training split's volumes resident in "
                            "HBM: per-step host->device traffic drops to a "
                            "few hundred bytes of slice indices (2D train "
                            "path; dataset must fit --device_cache_gb)")
    group.add_argument("--device_cache_gb", type=float, default=8.0,
                       help="HBM budget for --device_cache")

    group = parser.add_argument_group(title="G-Net Arguments")
    group.add_argument("--side_dropout", type=float, default=0.5,
                       help="Dropout used in G-Net sub-networks")
    group.add_argument("--use_context", action="store_true")
    group.add_argument("--context_list", type=str, nargs="+",
                       help="Paired context info: (name, length), e.g. hist 200")
    group.add_argument("--hist_noise", action="store_true")
    group.add_argument("--hist_noise_scale", type=float, default=0.002)
    group.add_argument("--hist_scale", type=float, default=20)
    group.add_argument("--glcm", action="store_true")
    group.add_argument("--glcm_noise", action="store_true")
    group.add_argument("--use_spatial", action="store_true")
    group.add_argument("--spatial_random", type=float, default=1.0)
    group.add_argument("--spatial_inner_random", action="store_true")
    group.add_argument("--center_random_ratio", type=float, default=0.2)
    group.add_argument("--stddev_random_ratio", type=float, default=0.4)
    group.add_argument("--eval_no_sp", action="store_true")
    group.add_argument("--min_std", type=float, default=2.0)
    group.add_argument("--save_sp_guide", action="store_true")
    group.add_argument("--use_se", action="store_true")
    group.add_argument("--eval_discount", type=float, default=0.85)
    group.add_argument("--guide_scale", type=float, default=5.0,
                       help="Base Gaussian stddev of sp-point eval guides "
                            "(reference NF/input_pipeline_g.py:788)")
    group.add_argument("--real_sp", type=str, help="Path to real spatial guide")
    group.add_argument("--ct_base", type=int, nargs="+", default=[32],
                       help="nf2/iin context patch sizes: one value s -> "
                            "pyramid (s, 2s, 4s), or three explicit sizes "
                            "(reference input_pipeline_iin.py:98)")
    group.add_argument("--case_id", type=int,
                       help="nf2 --mode infer: case PID for the single-patch "
                            "inference (reference input_pipeline_iin.py:96)")
    group.add_argument("--pos", type=int, nargs=3,
                       help="nf2 --mode infer: (slice, y, x) click position "
                            "(reference input_pipeline_iin.py:97)")
    group.add_argument("--device_sweep", choices=["on", "off"], default="on",
                       help="Run the interactive guide-propagation eval "
                            "(run_g) as one in-graph double sweep per case "
                            "(interactive/device_sweep.py); off = "
                            "reference-shaped per-slice host loop")
    group.add_argument("--sweep_max_objects", type=int, default=16,
                       help="Static per-slice object cap of the device "
                            "sweep; cases exceeding it fall back to the "
                            "host loop")
    group.add_argument("--guide_channel", type=int, default=2,
                       help="Interactive guide channels (1 = fg-bg, 2 = both)")
    group.add_argument("--max_objs", type=int, default=8,
                       help="Static padding size for per-slice guide objects")
    group.add_argument("--stddev", type=float, default=3.0,
                       help="Click-guide Gaussian stddev (interactive "
                            "pipelines)")
    group.add_argument("--local_enhance", action="store_true",
                       help="Gaussian click guides (default Euclidean, "
                            "NF interactive pipelines)")
    group.add_argument("--geodesic", action="store_true",
                       help="Geodesic click guides via the C++ fast-marching "
                            "kernel (reference "
                            "NF/input_pipeline_g_simply.py:478-496)")
    group.add_argument("--fp_sample", action="store_true",
                       help="Negative clicks sampled from false-positive "
                            "regions (needs <dataset>/neg cache, see "
                            "data/sampler_inter.build_neg_cache)")
    group.add_argument("--sample_neg", type=float, default=0.0,
                       help="Fraction of training crops centered on "
                            "false-positive voxels")
    group.add_argument("--fp_version", type=int, default=1, choices=[1, 2],
                       help="Negatives-cache variant: 1 = neg/ (single-model "
                            "predictions), 2 = neg_v2/ (union over several "
                            "checkpoints; reference load_neg_v2)")
    group.add_argument("-ds", "--downsampling", action="store_true",
                       help="Train on 2x spatially-downsampled volumes for "
                            "fast experiments (reference load_data_ds, "
                            "NF/input_pipeline_g_simply.py:161-204)")
    group.add_argument("--max_clicks", type=int, default=8,
                       help="Static padding size for simulated click arrays")
    group.add_argument("--use_cascade", action="store_true",
                       help="2D->3D cascade: add a frozen-2D (or GT-oracle) "
                            "prediction channel to the 3D net input "
                            "(reference NF/input_pipeline_3d.py:474-539)")
    group.add_argument("--cascade_binary", action="store_true",
                       help="Binary cascade channel instead of boundary-EDT")
    group.add_argument("--use_2d", action="store_true",
                       help="Cascade channel from the frozen 2D model "
                            "(--ckpt_2d) instead of the GT oracle")
    group.add_argument("--ckpt_2d", type=str,
                       help="Frozen 2D-model checkpoint for the cascade / "
                            "hybrid entry (reference main_train_hybrid.py)")
    group.add_argument("--model_2d", type=str, default="UNetInter",
                       help="Architecture of the frozen 2D cascade model")
    group.add_argument("--z_shards", type=int, default=0,
                       help="Shard whole-volume 3D eval over the depth axis "
                            "across this many devices (0 = off; new TPU "
                            "capability, SURVEY.md §5.7)")


def add_evaluator_arguments(parser: argparse.ArgumentParser):
    """Evaluation flags (reference evaluators/evaluator_liver.py:36-71)."""
    group = parser.add_argument_group(title="Evaluation Arguments")
    group.add_argument("--primary_metric", type=str,
                       help="Primary metric, format <class>/<metric>")
    group.add_argument("--secondary_metric", type=str,
                       help="Secondary metric, format <class>/<metric>")
    group.add_argument("--eval_final", action="store_true",
                       help="Evaluate with final (not best) checkpoint")
    group.add_argument("--ckpt_path", type=str,
                       help="Explicit checkpoint path for evaluation")
    group.add_argument("--evaluator", type=str, choices=["Volume"])
    group.add_argument("--eval_num", type=int, default=-1)
    group.add_argument("--eval_skip_num", type=int, default=0)
    group.add_argument("--eval_3d", action="store_true",
                       help="Inline eval in 3D volumes (default 2D slices)")
    group.add_argument("--pred_type", type=str, choices=["pred", "prob"],
                       default="pred")
    group.add_argument("--save_path", type=str, default="prediction")
    group.add_argument("--use_global_dice", action="store_true")


def check_args(args, parser: argparse.ArgumentParser):
    """Cross-flag validation (reference config.py:96-125)."""
    if hasattr(args, "loss_weight_type"):
        if args.loss_weight_type == "numerical":
            if not args.loss_numeric_w:
                parser.error("loss_weight_type==numerical needs --loss_numeric_w")
            if len(args.loss_numeric_w) != len(args.classes) + 1:
                parser.error("len(--loss_numeric_w) must equal len(classes) + 1")
        elif args.loss_weight_type == "proportion":
            if not args.loss_proportion_decay:
                parser.error("loss_weight_type==proportion needs --loss_proportion_decay")

    for name in ("primary_metric", "secondary_metric"):
        val = getattr(args, name, None)
        if val:
            parts = val.split("/")
            if len(parts) == 2 and (
                    parts[0] not in args.classes or parts[1] not in args.metrics_eval):
                raise ValueError(f"Wrong {name}: {val}")

    if not getattr(args, "summary_prefix", None):
        args.summary_prefix = args.tag
    return args


def fill_default_args(args, project_root=None):
    """Default model_dir = <root>/model_dir/<tag> (reference config.py:128-133)."""
    if not args.model_dir:
        root = Path(project_root) if project_root else Path.cwd()
        model_dir = root / "model_dir"
        model_dir.mkdir(parents=True, exist_ok=True)
        args.model_dir = str(model_dir / args.tag)
    return args


def build_parser(model_choices=None):
    """Full composed parser, as each reference entry point assembles it."""
    if model_choices is None:
        from boxsegliver_torch.models import MODEL_ZOO
        model_choices = tuple(MODEL_ZOO)
    parser = argparse.ArgumentParser(
        description="BoxSegLiver (PyTorch/CUDA port): guided/interactive "
                    "medical image segmentation")
    add_arguments(parser)
    add_model_arguments(parser, model_choices)
    add_solver_arguments(parser)
    add_loss_arguments(parser)
    add_pipeline_arguments(parser)
    add_evaluator_arguments(parser)
    return parser


def parse_args(argv=None, project_root=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(args, parser)
    fill_default_args(args, project_root)
    return args


def resolve_device(name: str = "cuda"):
    """torch.device for --device.  ``cuda`` requires a visible GPU and
    raises otherwise: the CPU runs only when the caller asks for it.

    On the GPU both TF32 switches are set off explicitly: ``--compute_dtype
    bfloat16`` (the default) runs convolutions and products in bf16 anyway,
    and ``--compute_dtype float32`` then means full float32, as on the
    reference's CPU tests."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"Unknown device {name!r}; choose cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "visible; pass --device cpu to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
