"""``run_scripts/template/001_dist.sh`` through the port's CLI with
``--device cpu --num_replicas 2`` on a tiny synthetic set: the CLI starts
two gloo ranks, which train (UNet_TINY, batch norm synchronized over the
ranks, the device cache, the online eval and the best checkpoint), resume
and evaluate (each slice batch split over the ranks).  Only rank 0 writes:
one log file a run, each summary (tag, step) once, one checkpoint line.
The 2-rank eval equals the one-process eval of the same checkpoint."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.train.checkpoint import CheckpointManager, load_state

torch.set_num_threads(2)
COMMON = ["--tag", "001_dist", "--model", "UNet", "--classes", "Liver",
          "Tumor", "--test_fold", "0", "--k_folds", "2", "--im_height", "48",
          "--im_width", "48", "--im_channel", "3", "--random_flip", "3",
          "--dataset", "ds", "--device", "cpu", "--model_config",
          "UNet_TINY.yml"]
TRAIN = ["liver", "--mode", "train"] + COMMON + [
    "--num_replicas", "2", "--batch_size", "4", "--noise_scale", "0.05",
    "--primary_metric", "Tumor/Dice", "--secondary_metric", "Liver/Dice",
    "--loss_weight_type", "numerical", "--loss_numeric_w", "0.2", "0.4",
    "4.4", "--batches_per_epoch", "3", "--learning_policy", "plateau",
    "--learning_rate", "0.001", "--lr_end", "0", "--lr_decay_rate", "0.2",
    "--eval_per_epoch", "--evaluator", "Volume", "--save_best",
    "--device_cache", "--eval_num_batches_per_epoch", "2", "--log_step",
    "2"]
EVAL = ["liver", "--mode", "eval"] + COMMON + ["--batch_size", "8",
                                               "--evaluator", "Volume"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    make_synthetic_dataset(root / "ds", n_cases=4, shape=(8, 48, 48),
                           k_split=2, seed=3)
    return root


def _once_each(md):
    """Every summary (tag, step) written once: rank 0 alone writes."""
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    counts = Counter((ln["tag"], ln["step"]) for ln in lines)
    assert counts and max(counts.values()) == 1
    return lines


def test_001_dist_cli_trains_resumes_and_evaluates(root):
    md = root / "md"
    common = ["--data_root", str(root), "--model_dir", str(md)]
    assert cli.main(TRAIN + common + ["--num_of_total_steps", "6"]) == \
        {"global_step": 6}
    state = load_state(md / "ckpt" / "6" / "state.pt")
    bn = "Encode1_conv1.norm.running_var"
    assert not torch.equal(state["model"][bn],
                           torch.ones_like(state["model"][bn]))
    assert (md / "ckpt_best" / "best" / "state.pt").exists()
    assert json.loads((md / "best_result").read_text())["global_step"] in \
        (3, 6)
    lines = _once_each(md)
    assert {ln["step"] for ln in lines
            if ln["tag"] == "001_dist/eval/Liver/Dice"} == {3, 6}
    assert all(np.isfinite(ln["value"]) for ln in lines)
    assert len(list((md / "logs").iterdir())) == 1

    # resume on both ranks from rank 0's checkpoint
    assert cli.main(TRAIN + common + ["--num_of_total_steps", "8"]) == \
        {"global_step": 8}
    assert CheckpointManager(md).steps() == [8]
    _once_each(md)
    assert len(list((md / "logs").iterdir())) == 2

    # 001_dist.sh eval over the two ranks against one process
    two = cli.main(EVAL + common + ["--num_replicas", "2", "--eval_final"])
    assert {"Liver/Dice", "Tumor/Dice", "GLiverDice", "GTumorDice"} <= \
        set(two)
    assert json.loads((md / "eval_results_3d.txt").read_text()) == \
        pytest.approx(two)
    one = cli.main(EVAL + common + ["--num_replicas", "1", "--eval_final"])
    assert set(one) == set(two)
    for k in one:
        np.testing.assert_allclose(two[k], one[k], atol=1e-6, err_msg=k)
    assert len(list((md / "logs").iterdir())) == 4


@pytest.mark.parametrize("extra,error,match", [
    # the guided sweep and the 3-D eval shard one image or volume over the
    # devices: ROADMAP item 4b
    (["--use_spatial", "--model", "GUNet", "--model_config",
      "GUNet_TINY.yml", "--num_replicas", "2"], NotImplementedError,
     "item 4b"),
    (["--batch_size", "7", "--num_replicas", "2"], ValueError,
     "try --batch_size=6"),
    (["--num_replicas", "100000"], ValueError,
     "Requested 100000 replicas but only"),
])
def test_001_dist_cli_refusals(root, tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        cli.main(EVAL + ["--data_root", str(root), "--model_dir",
                         str(tmp_path)] + extra)


def test_z_shards_raise_naming_item_4b(root, tmp_path):
    argv = ["nf_3d", "--mode", "eval", "--tag", "t", "--model", "UNet3D",
            "--classes", "NF", "--device", "cpu", "--z_shards", "2",
            "--data_root", str(root), "--model_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="item 4b"):
        cli.main(argv)
