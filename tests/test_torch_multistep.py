"""--steps_per_dispatch K on the CPU: the port's K-step dispatch against the
JAX package's ``make_multi_train_step`` (lax.scan over K stacked raw
batches) on the same raw batches through each package's device preprocess,
with noise, flips and dropout off (the two frameworks draw different
numbers) and Momentum (Adam turns a gradient within float32 round-off
of 0 into ±lr, which no tolerance on the parameters absorbs;
tests/test_torch_train.py holds Adam itself): per-step losses within 1e-5
relative, parameters after the K steps within 1e-5, the train-metric
cadence equal.  Then the port against
itself: a K = 4 dispatch equals four K = 1 steps bit for bit, with noise,
flips and dropout on (one generator, the same draws in the same order);
the train loop's single-step remainders, its hook order, its epoch eval
quantized to K and a resume in the middle of a run give what K = 1 gives.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.data import pipeline as jpipe
from boxsegliver_tpu.models import build_model as jbuild
from boxsegliver_tpu.train.solver import Solver
from boxsegliver_tpu.train.trainer import (create_train_state,
                                           make_multi_train_step,
                                           make_train_step)
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data import pipeline as tpipe
from boxsegliver_torch.data.sampler import TrainSampler
from boxsegliver_torch.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.models import MODEL_CONFIGS
from boxsegliver_torch.models.weights import (flax_to_state_dict,
                                              state_dict_to_flax)
from boxsegliver_torch.train.trainer import Trainer

torch.set_num_threads(2)
CLASSES = ["Background", "Liver", "Tumor"]
FLAGS = ["liver", "--mode", "train", "--tag", "t", "--model", "GUNet",
         "--model_config", "GUNet_TINY.yml", "--classes", "Liver", "Tumor",
         "--test_fold", "0", "--k_folds", "2", "--im_height", "48",
         "--im_width", "48", "--im_channel", "3", "--dataset", "ds",
         "--normalizer", "instance_norm", "--use_context", "--context_list",
         "hist", "200", "--use_spatial", "--spatial_random", "1.0",
         "--spatial_inner_random", "--min_std", "2", "--loss_weight_type",
         "numerical", "--loss_numeric_w", "0.2", "0.4", "4.4",
         "--batch_size", "2", "--weight_decay_rate", "0.000001",
         "--learning_policy", "plateau", "--learning_rate", "0.001",
         "--lr_end", "0.0000005", "--device", "cpu", "--compute_dtype",
         "float32", "--log_step", "2", "--host_workers", "1"]
QUIET = ["--noise_scale", "0", "--random_flip", "0", "--side_dropout", "0"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("multistep")
    make_synthetic_dataset(root / "ds", n_cases=4, shape=(8, 48, 48),
                           k_split=2, seed=1)
    return root


def _args(root, md, *extra):
    return cli.get_args(FLAGS + ["--data_root", str(root), "--model_dir",
                                 str(md)] + list(extra))


def _batches(root, args, n, seed=3):
    sampler = TrainSampler(root / "ds", args, mode="train", seed=seed)
    rng = np.random.RandomState(seed)
    return [sampler.sample_batch(2, rng=rng) for _ in range(n)]


def _trainer(args, seed=0):
    model = cli._build_model(args)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return Trainer(model, args, CLASSES, "cpu",
                   preprocess_fn=tpipe.make_preprocess_fn(args))


def _params(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_k_steps_match_jax_multi_train_step(root, tmp_path):
    args = _args(root, tmp_path, "--steps_per_dispatch", "4",
                 "--optimizer", "Momentum", *QUIET)
    batches = _batches(root, args, 4)
    jmodel = jbuild("GUNet", args=args,
                    model_kwargs=MODEL_CONFIGS["GUNet_TINY.yml"])
    solver = Solver(args)
    jprep = jpipe.make_preprocess_fn(args)
    sample, _ = jax.jit(jprep)({k: jax.numpy.asarray(v)
                                for k, v in batches[0].items()},
                               jax.random.PRNGKey(0))
    sample.pop("names")
    state = create_train_state(jmodel, solver, sample, jax.random.PRNGKey(4))
    flat = {f"params/{k}": np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(state.params)),
        sep="/").items()}
    multi = jax.jit(make_multi_train_step(make_train_step(
        jmodel, solver, args, CLASSES, preprocess_fn=jprep)))
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    state, jm = multi(state, stacked, jax.random.PRNGKey(5))

    trainer = _trainer(args)
    trainer.model.load_state_dict(flax_to_state_dict(flat), strict=True)
    out = trainer.train_multi_step(batches)
    assert [s for s, _, _ in out] == [1, 2, 3, 4]
    vals = torch.stack([v for _, v, _ in out]).numpy()
    np.testing.assert_allclose(vals[:, 0], np.asarray(jm["total_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(vals[:, 1], np.asarray(jm["data_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose([lr for _, _, lr in out],
                               np.asarray(jm["learning_rate"]), rtol=1e-7)
    # metrics on steps 1, 2 and 4 (log_step 2), zeros on step 3
    for i, key in enumerate(trainer.metric_keys):
        want = np.asarray(jm[key])
        np.testing.assert_array_equal(vals[:, 2 + i] == 0, want == 0)
        np.testing.assert_allclose(vals[:, 2 + i], want, atol=1e-3)
    got = state_dict_to_flax(trainer.model)
    for k, v in traverse_util.flatten_dict(jax.tree_util.tree_map(
            np.asarray, dict(state.params)), sep="/").items():
        np.testing.assert_allclose(got["params/" + k], v, atol=1e-5, rtol=0,
                                   err_msg=k)


def test_k_steps_equal_k_single_steps(root, tmp_path):
    """Noise, flips and dropout on: one dispatch of 4 steps and four K = 1
    steps draw the same numbers from the same generator."""
    a4 = _args(root, tmp_path / "k4", "--steps_per_dispatch", "4",
               "--noise_scale", "0.05", "--random_flip", "3",
               "--side_dropout", "0.5")
    a1 = _args(root, tmp_path / "k1", "--noise_scale", "0.05",
               "--random_flip", "3", "--side_dropout", "0.5")
    batches = _batches(root, a1, 4)
    t4, t1 = _trainer(a4), _trainer(a1)
    out4 = t4.train_multi_step(batches)
    out1 = [t1.train_step(b) for b in batches]
    for (_, v4, lr4), (v1, lr1) in zip(out4, out1):
        assert torch.equal(v4, v1) and lr4 == lr1
    p4, p1 = _params(t4), _params(t1)
    for k in p1:
        assert torch.equal(p4[k], p1[k]), k
    assert t4.optimizer.count == t1.optimizer.count == 4
    for a, b in zip(t4.optimizer.state["mu"], t1.optimizer.state["mu"]):
        assert torch.equal(a, b)
    assert torch.equal(t4.generator.get_state(), t1.generator.get_state())


def _train(args, batches, max_steps, resume=False):
    """Trainer.train over ``batches``; returns (trainer, steps the hooks
    saw in order, steps the epoch eval ran at)."""
    trainer = _trainer(args)
    if resume:
        trainer.restore()
    seen, evals = [], []
    after = trainer._after_step

    def record(step, metrics):
        seen.append(step)
        after(step, metrics)
    trainer._after_step = record
    trainer.train(iter(batches), max_steps=max_steps,
                  eval_fn=lambda t: evals.append(t.global_step) or {},
                  batches_per_epoch=3)
    trainer.summary.close()
    return trainer, seen, evals


def test_remainder_hooks_and_resume_mid_window(root, tmp_path):
    extra = ("--noise_scale", "0.05", "--random_flip", "3")
    a1 = _args(root, tmp_path / "k1", *extra)
    batches = _batches(root, a1, 10)
    ref, seen1, evals1 = _train(a1, batches, 10)
    assert seen1 == list(range(1, 11)) and evals1 == [3, 6, 9]

    a4 = _args(root, tmp_path / "k4", "--steps_per_dispatch", "4", *extra)
    k4, seen4, evals4 = _train(a4, batches, 10)
    assert seen4 == list(range(1, 11))
    # dispatches end at 4 and 8; the last two steps run as single-step
    # remainders in one window, as the JAX loop runs them
    assert evals4 == [4, 8, 10]
    want = _params(ref)
    for k, v in _params(k4).items():
        assert torch.equal(v, want[k]), k

    # stop at 6 (one dispatch, two single steps), resume to 10 (one
    # dispatch of 4 from a checkpoint in the middle of a K window)
    ar = _args(root, tmp_path / "kr", "--steps_per_dispatch", "4", *extra)
    first, seen_a, _ = _train(ar, batches[:6], 6)
    assert first.global_step == 6 and seen_a == list(range(1, 7))
    second, seen_b, _ = _train(ar, batches[6:], 10, resume=True)
    assert second.global_step == 10 and seen_b == list(range(7, 11))
    assert second.optimizer.count == 10
    for k, v in _params(second).items():
        assert torch.equal(v, want[k]), k
