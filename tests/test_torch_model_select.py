"""Which model config and which weights the port builds.

- Model configs: every config file of the JAX package
  (boxsegliver_tpu/configs/models/ and its ext_config/) is either carried by
  the port (models.MODEL_CONFIGS) or refused with NotImplementedError naming
  its ROADMAP item; only a name JAX lacks too gives {}.
- Weights (cli/main.restore_weights), one test per branch of the selection
  that eval and export share with JAX (cli/main.py:395-410,
  cli/export.py:28-36, train/trainer.py:315-343): --ckpt_path; the best
  checkpoint, or the latest one under --eval_final (eval only); with no
  checkpoint, a warm start from --warm_start_from or --load_weights on top
  of the seeded init; with neither, the seeded init for export and
  FileNotFoundError for eval."""

from pathlib import Path

import pytest
import torch

from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.models import MODEL_CONFIGS, load_model_config
from boxsegliver_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
JAX_CONFIGS = sorted(
    p.name for d in ("configs/models", "configs/models/ext_config")
    for p in (ROOT / "boxsegliver_tpu" / d).glob("*.yml"))


@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_every_jax_config_is_carried_or_refused(name):
    assert name in MODEL_CONFIGS
    assert load_model_config("GUNet", name) == MODEL_CONFIGS[name]


def test_unetinter_configs_are_ported():
    """UNetInter.yml and UNetInter_TINY.yml moved to the ported side with
    the nf_inter slice: carried, and built as the port's UNetInter with the
    guide's channels from --guide_channel."""
    assert {"UNetInter.yml", "UNetInter_TINY.yml"} <= set(MODEL_CONFIGS)
    assert {"UNetInter.yml", "UNetInter_TINY.yml"} <= set(JAX_CONFIGS)
    args = cli.get_args(["nf_inter", "--mode", "train", "--tag", "t",
                         "--model", "UNetInter", "--model_config",
                         "UNetInter_TINY.yml", "--classes", "NF",
                         "--guide_channel", "1", "--device", "cpu",
                         "--model_dir", "md"])
    model = cli._build_model(args)
    assert type(model).__name__ == "UNetInter"
    assert model.Encode1_conv1.conv.weight.shape[1] == 3 + 1


def test_unported_list_names_only_jax_configs():
    assert set(MODEL_CONFIGS) == set(JAX_CONFIGS)
    assert load_model_config("GUNet", "NoSuchConfig.yml") == {}


def _args(tmp_path, mode, *extra, model_dir="md"):
    return cli.get_args([
        "liver", "--mode", mode, "--tag", "t", "--model", "GUNet",
        "--model_config", "GUNet_TINY.yml", "--classes", "Liver", "Tumor",
        "--normalizer", "instance_norm", "--use_context", "--context_list",
        "hist", "20", "--use_spatial", "--im_height", "32", "--im_width",
        "32", "--device", "cpu", "--seed", "3",
        "--model_dir", str(tmp_path / model_dir)] + list(extra))


def _weights(args, seed):
    model = cli._build_model(args)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _restored(args, export=False):
    model = cli._build_model(args)
    source = cli.restore_weights(args, model, export=export)
    return source, model.state_dict()


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture
def model_dir(tmp_path):
    """md/ with a periodic checkpoint at step 4 (seed 11) and a best one
    (seed 12)."""
    args = _args(tmp_path, "eval")
    ckpt = CheckpointManager(args.model_dir)
    ckpt.save(4, {"model": _weights(args, 11)})
    ckpt.save_best({"model": _weights(args, 12)})
    return args


@pytest.mark.parametrize("mode", ["eval", "export"])
def test_ckpt_path_comes_first(tmp_path, model_dir, mode):
    path = tmp_path / "explicit.pt"
    torch.save({"model": _weights(model_dir, 13)}, path)
    args = _args(tmp_path, mode, "--ckpt_path", str(path))
    source, got = _restored(args, export=mode == "export")
    assert source == str(path)
    _assert_equal(got, _weights(args, 13))


@pytest.mark.parametrize("mode", ["eval", "export"])
def test_best_checkpoint(tmp_path, model_dir, mode):
    _, got = _restored(_args(tmp_path, mode), export=mode == "export")
    _assert_equal(got, _weights(model_dir, 12))


def test_eval_final_takes_the_latest_and_export_ignores_it(tmp_path,
                                                           model_dir):
    _, got = _restored(_args(tmp_path, "eval", "--eval_final"))
    _assert_equal(got, _weights(model_dir, 11))
    _, got = _restored(_args(tmp_path, "export", "--eval_final"), export=True)
    _assert_equal(got, _weights(model_dir, 12))


@pytest.mark.parametrize("mode", ["eval", "export"])
def test_warm_start_from_without_a_checkpoint(tmp_path, mode):
    src = tmp_path / "warm.pt"
    args = _args(tmp_path, mode, "--warm_start_from", str(src),
                 model_dir="empty")
    torch.save({"model": _weights(args, 14)}, src)
    source, got = _restored(args, export=mode == "export")
    assert source == f"a warm start from {src}"
    _assert_equal(got, _weights(args, 14))


@pytest.mark.parametrize("mode", ["eval", "export"])
def test_load_weights_sibling_without_a_checkpoint(tmp_path, model_dir,
                                                   mode):
    """--load_weights names a sibling experiment under model_dir's parent:
    its best checkpoint; --weights_scope renames scopes first, and the
    tensors it leaves unmatched keep the seeded init."""
    args = _args(tmp_path, mode, "--load_weights", "md", "--weights_scope",
                 "AdjustChannels=Nowhere", model_dir="fresh")
    _, got = _restored(args, export=mode == "export")
    want, init = _weights(args, 12), _weights(args, 3)
    for k in want:
        ref = init[k] if k.startswith("AdjustChannels.") else want[k]
        assert torch.equal(got[k], ref), k


def test_export_without_weights_takes_the_seeded_init(tmp_path):
    args = _args(tmp_path, "export", model_dir="empty")
    source, got = _restored(args, export=True)
    assert source == "the seeded init (--seed 3)"
    _assert_equal(got, _weights(args, 3))


def test_eval_without_weights_raises(tmp_path):
    """Kept from before: JAX would score the seeded init; the port refuses
    (tests/test_torch_train_cli.py pins eval_checkpoint's raise)."""
    args = _args(tmp_path, "eval", model_dir="empty")
    with pytest.raises(FileNotFoundError, match="--ckpt_path"):
        _restored(args)
