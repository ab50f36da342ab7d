"""The port's online 2D eval against the JAX package's (same weights, same
eval batches: keys equal, values within 1e-4), its checkpoints, and the
train CLI on a tiny synthetic set on the CPU: checkpoints and sidecars are
written, a second run resumes and skips the finished steps, and --mode eval
restores what training wrote from --model_dir."""

import functools
import json
import types

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.data import pipeline as jpipe
from boxsegliver_tpu.data.sampler import TrainSampler as JSampler
from boxsegliver_tpu.evaluators.online2d import OnlineEval2D as JOnline
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.train.checkpoint import (CheckpointManager,
                                                model_state, warm_start)

torch.set_num_threads(2)
TRAIN = ["liver", "--mode", "train", "--tag", "t", "--model", "GUNet",
         "--classes", "Liver", "Tumor", "--test_fold", "0", "--k_folds", "2",
         "--im_height", "48", "--im_width", "48", "--im_channel", "3",
         "--random_flip", "3", "--dataset", "ds", "--normalizer",
         "instance_norm", "--use_context", "--context_list", "hist", "200",
         "--hist_noise", "--use_spatial", "--spatial_random", "1.0",
         "--spatial_inner_random", "--center_random_ratio", "0.2",
         "--stddev_random_ratio", "0.4", "--min_std", "2", "--noise_scale",
         "0.05", "--primary_metric", "Tumor/Dice", "--secondary_metric",
         "Liver/Dice", "--loss_weight_type", "numerical", "--loss_numeric_w",
         "0.2", "0.4", "4.4", "--batches_per_epoch", "3", "--batch_size", "2",
         "--weight_decay_rate", "0.000001", "--learning_policy", "plateau",
         "--learning_rate", "0.001", "--lr_end", "0.0000005",
         "--lr_decay_rate", "0.2", "--eval_per_epoch", "--evaluator",
         "Volume", "--save_best", "--device", "cpu", "--model_config",
         "GUNet_TINY.yml", "--log_step", "2", "--eval_num_batches_per_epoch",
         "2", "--host_workers", "1", "--metrics_eval", "Dice", "VOE", "RVD"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    make_synthetic_dataset(root / "ds", n_cases=4, shape=(8, 48, 48),
                           k_split=2, seed=1)
    return root


def _argv(root, *extra):
    return TRAIN + ["--data_root", str(root), "--model_dir",
                    str(root / "md")] + list(extra)


def test_online_eval_matches_jax(root):
    args = cli.get_args(_argv(root, "--compute_dtype", "float32",
                              "--use_global_dice"))
    ds = root / "ds"
    classes = ["Background", "Liver", "Tumor"]
    kw = dict(im_h=48, im_w=48, noise_scale=0.0, random_flip=0,
              use_spatial=True, min_std=2.0)
    jeval = JOnline(JSampler(ds, args, mode="eval", resize_on_host=False),
                    args, functools.partial(jpipe._process_batch, **kw,
                                            **jpipe.norm_statics(args)),
                    classes, num_batches=3, use_global_dice=True)
    teval = cli._make_online_eval(args, ds, num_batches=3)

    feats = {k: v[:1] for k, v in jeval.batches[0].items()}
    jmodel = jbuild("GUNet", args=args,
                    model_kwargs=MODEL_CONFIGS["GUNet_TINY.yml"])
    fj = jax.jit(jeval.process_fn)({k: jax.numpy.asarray(v)
                                    for k, v in feats.items()},
                                   jax.random.PRNGKey(0))[0]
    fj.pop("names")
    variables = jmodel.init(jax.random.PRNGKey(2), fj)
    rng = np.random.default_rng(0)
    flat = {f"params/{k}": np.asarray(v) + rng.normal(0, 0.05, v.shape
                                                      ).astype(np.float32)
            for k, v in traverse_util.flatten_dict(
                jax.tree_util.tree_map(np.asarray, dict(variables["params"])),
                sep="/").items()}
    params = traverse_util.unflatten_dict(
        {k[len("params/"):]: v for k, v in flat.items()}, sep="/")

    def jpredict(f):
        f = {k: v for k, v in f.items() if k != "names"}
        return jax.nn.softmax(jmodel.apply({"params": params}, f), axis=-1)

    want = jeval(types.SimpleNamespace(predict=jpredict, global_step=0,
                                       summary=None))
    model = cli._build_model(args)
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    trainer = types.SimpleNamespace(
        predict=lambda f: torch.softmax(model(f), dim=-1), device="cpu",
        global_step=0, summary=None)
    with torch.no_grad():
        got = teval(trainer)
    assert sorted(got) == sorted(want)
    assert "Tumor/RVD" in got and "Liver/GlobalDice" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_checkpoint_manager_keeps_the_latest(tmp_path):
    ckpt = CheckpointManager(tmp_path, max_to_keep=2)
    for step in (5, 10, 15):
        ckpt.save(step, {"model": {"w": torch.full((2,), float(step))},
                         "step": step})
    assert ckpt.steps() == [10, 15] and ckpt.latest_step() == 15
    assert not ckpt.has_best()
    ckpt.save_best({"model": {"w": torch.ones(2)}})
    assert ckpt.has_best()
    assert torch.equal(model_state(ckpt.latest_path())["w"],
                       torch.full((2,), 15.0))


def test_warm_start_from_npz_and_pt(tmp_path):
    lin = torch.nn.Linear(3, 2)
    torch.save({"weight": torch.ones(2, 3), "bias": torch.ones(3)},
               tmp_path / "w.pt")
    assert warm_start(lin, tmp_path / "w.pt") == 1     # bias shape differs
    assert torch.equal(lin.weight, torch.ones(2, 3))
    np.savez(tmp_path / "w.npz", **{"params/kernel": np.zeros((3, 2),
                                                              np.float32)})
    assert warm_start(lin, tmp_path / "w.npz") == 1
    assert torch.equal(lin.weight, torch.zeros(2, 3))
    with pytest.raises(ValueError):
        model_state(tmp_path / "w.ckpt")


def test_train_cli_writes_resumes_and_eval_restores(root):
    trainer = cli.main(_argv(root, "--num_of_total_steps", "6",
                             "--device_cache"))
    md = root / "md"
    assert trainer.global_step == 6
    assert (md / "ckpt" / "6" / "state.pt").exists()
    assert (md / "ckpt_best" / "best" / "state.pt").exists()
    best = json.loads((md / "best_result").read_text())
    assert best["global_step"] in (3, 6) and "Tumor/Dice" in best
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    assert {ln["step"] for ln in lines if ln["tag"] == "t/loss"} == \
        {1, 2, 4, 6}
    assert all(np.isfinite(ln["value"]) for ln in lines)

    # resume on the streaming sampler: steps 7-8 only
    again = cli.main(_argv(root, "--num_of_total_steps", "8"))
    assert again.global_step == 8
    assert CheckpointManager(md).steps() == [8]
    skipped = cli.main(_argv(root, "--num_of_total_steps", "8"))
    assert skipped.global_step == 8

    # --mode eval restores from --model_dir: best, or the latest periodic
    ev = _argv(root)
    ev[ev.index("train")] = "eval"
    args = cli.get_args(ev)
    assert cli.eval_checkpoint(args) == md.resolve() / "ckpt_best" / "best" / \
        "state.pt"
    args = cli.get_args(ev + ["--eval_final"])
    path = cli.eval_checkpoint(args)
    assert path == md.resolve() / "ckpt" / "8" / "state.pt"
    model = cli.build_model_from_args(args, torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.model.state_dict()[k]), k
    args = cli.get_args(ev + ["--model_dir", str(root / "empty")])
    with pytest.raises(FileNotFoundError):
        cli.eval_checkpoint(args)


def test_train_cli_refuses_unported_paths(root):
    """Training over --num_replicas 2 is ported (tests/test_torch_dist_*.py
    hold it against JAX): the flagship's train CLI starts two gloo ranks
    that train 2 steps in one dispatch and rank 0 writes the checkpoint; a
    global batch the ranks do not divide is refused with JAX's error before
    any rank starts."""
    md = root / "md_ranks"
    out = cli.main(_argv(root, "--num_replicas", "2", "--num_of_total_steps",
                         "2", "--steps_per_dispatch", "2", "--model_dir",
                         str(md)))
    assert out == {"global_step": 2}
    assert CheckpointManager(md).steps() == [2]
    with pytest.raises(ValueError, match="try --batch_size=2"):
        cli.main(_argv(root, "--num_replicas", "2", "--batch_size", "3",
                       "--model_dir", str(md)))
