"""The plain reference agrees with the program at tiny sizes: the same
features from the same raw batch and seed, the same logits from the same
weights, the same decayed set, and (the program in float32) the same
checked-step readings."""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, weights
from portbench.drivers import train as drv
from portbench.reference import nets
from portbench.reference import train as ref
from tiny import _set, tiny_config

CPU = torch.device("cpu")


def _ctx(name, tmp, float32=False, seed=12345):
    spec = run.resolve(run.load_bench(), f"{name}.train")
    cfg = tiny_config(name)
    if float32:
        cfg["flags"] = _set(cfg["flags"], "--compute_dtype", "float32")
        cfg["settings"]["compute_dtype"] = "float32"
    spec["config"] = cfg
    spec["traffic"] = dict(spec["traffic"], steps_per_dispatch=4)
    return run.Context(spec, seed, 1.0, False, CPU, Path(tmp))


@pytest.mark.parametrize("name", ["gnet_sp", "unet3d"])
def test_features_logits_and_decay_match(name):
    from boxsegliver_torch.data.pipeline import batch_to_device
    from boxsegliver_torch.ops.losses import decayed_parameters

    with tempfile.TemporaryDirectory() as tmp:
        ctx = _ctx(name, tmp, float32=True)
        args = drv.program_args(ctx)
        trainer, data, ds = drv.build(ctx, args)
        raw = next(data)
        data.close()
        pf, pl = trainer.preprocess_fn(batch_to_device(raw, CPU),
                                       torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        flags = ctx.config["settings"]
        if name == "gnet_sp":
            stack = ref.stacked_volumes(ds, ref.train_pids(
                ds, flags["test_fold"]), CPU)
            rf, rl = ref.preprocess_liver(raw, *stack, gen, flags, CPU)
        else:
            rf, rl = ref.preprocess_patch(raw, gen, flags, CPU)
        assert torch.equal(pl, rl)
        for k in rf:
            torch.testing.assert_close(pf[k].float(), rf[k], rtol=0, atol=0)
        net = nets.build(ctx.config)
        net.load_state_dict(weights.make(ctx.config, ctx.seed, CPU))
        with torch.no_grad():
            lp = trainer.model(pf, train=True,
                               generator=torch.Generator().manual_seed(5))
            lr = net(pf, nets.Ops(), torch.Generator().manual_seed(5))
        torch.testing.assert_close(lp, lr, rtol=1e-4, atol=1e-4)
        mine = {n for n, _ in net.named_parameters() if ref.decayed(n)}
        assert mine == set(decayed_parameters(trainer.model))


def test_gunet_steps_match_program_in_float32():
    """The checked steps of the tiny G-Net (1, 2, then a full dispatch):
    the program in float32 and the reference agree to float32 rounding in
    the losses, the first gradient and the three-step change; the full
    dispatch's change, read after rounding has moved the parameters
    through three Adam steps, to a tenth of a percent."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = _ctx("gnet_sp", tmp, float32=True)
        args = drv.program_args(ctx)
        trainer, data, ds = drv.build(ctx, args)
        raws, prog = drv.checked_steps(trainer, drv.Feed(data),
                                         int(args.steps_per_dispatch))
        data.close()
        got = drv.compare(prog, drv.reference_readings(ctx, args, ds, raws))
    assert got["loss_gap"] < 1e-5
    assert got["grad1_gap"] < 1e-4 and got["change3_gap"] < 1e-4
    assert got["dispatch_change_gap"] < 2e-3


def test_unet3d_steps_match_program_in_float32():
    """The tiny UNet3D (full widths at 10 x 32 x 32) is chaotic in its
    gradient: a 1e-6 relative change of its input moves a leaf's gradient
    by about 1 %, so its steps agree to that, not to rounding."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = _ctx("unet3d", tmp)
        args = drv.program_args(ctx)
        trainer, data, ds = drv.build(ctx, args)
        raws, prog = drv.checked_steps(trainer, drv.Feed(data),
                                         int(args.steps_per_dispatch))
        data.close()
        got = drv.compare(prog, drv.reference_readings(ctx, args, ds, raws))
    assert got["loss_gap"] < 2e-3
    assert got["grad1_gap"] < 2e-2 and got["change3_gap"] < 5e-2


def test_leaf_gaps():
    r = np.array([1.0, 2.0, 0.0, 4.0])
    p = np.array([1.1, 2.0, 0.1, 4.0])
    # leaves under the median leaf's norm (1.5) are measured against it
    np.testing.assert_allclose(drv.leaf_gaps(p, r),
                               [0.1 / 1.5, 0, 0.1 / 1.5, 0])
    np.testing.assert_allclose(
        drv.leaf_gaps(p, r, keep=np.array([1, 0, 0, 1], bool)),
        [0.1 / 2.5, 0])


def _liver_case(tmp, seed=3):
    from portbench import data

    cfg = tiny_config("gnet_sp")
    root = data.make_dataset(Path(tmp) / "ds", cfg["data"], seed, CPU,
                             train_cases=0, test_cases=1, k_folds=5,
                             test_fold=2, hist_modes=("eval",), prior=True)
    return root, json.loads((root / "meta.json").read_text())[0]


def test_sweep_crop_and_context_match_program():
    """The reference's crop and eval hist context, worked out from the raw
    case, equal the program's prepare step's."""
    from boxsegliver_torch.evaluators.eval_loader import aligned_bbox
    from portbench.reference import sweep

    with tempfile.TemporaryDirectory() as tmp:
        root, meta = _liver_case(tmp)
        vol, lab = sweep.load_case(root, 0)
        assert sweep.aligned_crop(lab) == aligned_bbox(meta)
        hu = vol.astype(np.float32) / 64 - 250
        want = np.load(root / "feat" / "hist" / "eval" / "000.npy")
        np.testing.assert_array_equal(sweep.eval_hist(hu, lab), want)


def test_sweep_class_map_resize_matches_program():
    from boxsegliver_torch.ops.image_ops import resize_nearest
    from portbench.reference import sweep

    probs = np.random.default_rng(0).random((3, 32, 32, 3), np.float32)
    want = resize_nearest(torch.from_numpy(
        probs.argmax(-1).astype(np.uint8)), (80, 48)).numpy()
    np.testing.assert_array_equal(sweep.crop_classes(probs, (80, 48)), want)
