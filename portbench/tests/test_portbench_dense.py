"""DenseUNet's cell (``dense_unet.train``): its counts equal hooks on the
program's modules, the cell resolves with its ten metrics, its reference's
preprocess equals the program's, a whole run at a tiny size on the CPU
reads ``correct`` true when the program is sound and false when its steps
are broken (its running statistics frozen or its generator stale in the
full dispatch among them), every planted fault of the calibration fails a
limit, its metric readers read a trace's records, and its driver,
reference and counts load no JAX (the reference nothing of the
program)."""

import copy
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from portbench import dense_counts, run
from portbench.drivers import train_dense as drv
from portbench.reference import dense_unet as ref
from test_portbench_faults import (_altered_gradient, _full_dispatch,
                                   _half_batch, _replays_unchanged,
                                   _stale_rows, _unchanged)
from tiny import _set

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "dense_unet.train"
METRICS = {"input_wait_ms.dense", "host_launches_per_step.dense",
           "device_kernels_per_step.dense", "conv_ms_per_step.dense",
           "norm_ms_per_step.dense", "elementwise_ms_per_step.dense",
           "optimizer_ms_per_step.dense", "norm_roofline.dense",
           "device_idle_share.dense", "mfu.dense"}


def _config():
    return json.loads((ROOT / "portbench" / "configs" / "dense_unet.json")
                      .read_text())


def _tiny_spec():
    """The cell with DenseUNet_tiny.yml's widths at 64², batch 2, in
    float32, on 2 cases of 8 x 96², K = 4."""
    spec = run.resolve(run.load_bench(), CELL)
    cfg = copy.deepcopy(_config())
    f = cfg["flags"] + cfg.pop("train_flags")
    for name, value in (("--model_config", "DenseUNet_tiny.yml"),
                        ("--im_height", "64"), ("--im_width", "64"),
                        ("--batch_size", "2"), ("--log_step", "4"),
                        ("--compute_dtype", "float32")):
        f = _set(f, name, value)
    cfg["flags"], cfg["train_flags"] = f, []
    cfg["model"].update(stem_channels=8, growth_rate=4, nb_layers=[2, 2, 2, 2])
    cfg["settings"].update(im_height=64, im_width=64, batch_size=2,
                           compute_dtype="float32")
    cfg["data"]["shape"] = [8, 96, 96]
    cfg["cases"] = {"train": 2}
    spec["config"] = cfg
    spec["traffic"] = dict(spec["traffic"], steps_per_dispatch=4)
    return spec


def _program_model(cfg):
    from boxsegliver_torch.models.dense_unet import DenseUNet

    m = cfg["model"]
    return DenseUNet(m["num_classes"], m["stem_channels"], m["growth_rate"],
                     m["nb_layers"], m["compression"], m["dropout"],
                     dtype=torch.float32, in_channels=m["in_channels"])


def test_counts_match_program_hooks():
    """The full widths at 64²: every conv's multiply-adds and every batch
    norm's plane, hooked on the program's modules."""
    from boxsegliver_torch.models import layers

    cfg = _config()
    model = _program_model(cfg).eval()
    macs, planes = [0], []

    def conv(mod, inp, out):
        macs[0] += out.numel() // out.shape[0] * mod.weight.shape[1] \
            * math.prod(mod.weight.shape[2:])

    def norm(mod, inp, out):
        planes.append((inp[0].shape[1], math.prod(inp[0].shape[2:])))

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, layers.Conv)]
    hooks += [m.register_forward_hook(norm) for m in model.modules()
              if isinstance(m, layers.BatchNorm)]
    with torch.no_grad():
        model({"images": torch.randn(1, 64, 64, 3)})
    for h in hooks:
        h.remove()
    want_macs, want_planes = dense_counts.work(cfg, (64, 64))
    assert macs[0] == want_macs
    assert sorted(planes) == sorted(want_planes)
    assert len(planes) == 166


def test_full_size_counts():
    """The counts at the cell's size, as PERF.md quotes them."""
    cfg = _config()
    macs, planes = dense_counts.work(cfg, (256, 256))
    assert macs / 1e9 == pytest.approx(24.26, abs=0.005)
    assert 8 * dense_counts.train_flops_per_sample(cfg, (256, 256)) / 1e12 \
        == pytest.approx(1.165, abs=0.001)
    assert dense_counts.norm_min_seconds(cfg, (256, 256), 8) * 1e3 == \
        pytest.approx(1.079, abs=0.001)


def test_cell_resolves_with_its_metrics():
    spec = run.resolve(run.load_bench(), CELL)
    assert spec["cell"]["chips"] == 1
    assert spec["traffic"]["driver"] == "train_dense"
    assert {m["name"] for m in spec["end_to_end"]} == {"train_samples_per_s",
                                                       "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == METRICS
    assert set(spec["limits"]) == {"grad1_median_gap", "change3_gap",
                                   "dispatch_loss_median_gap",
                                   "dispatch_loss_mean_gap",
                                   "dispatch_change_median_gap",
                                   "running_change_median_gap",
                                   "generator_gap"}
    assert spec["limits"]["generator_gap"] == 0


def test_reference_weights_load_into_the_program():
    cfg = _tiny_spec()["config"]
    model = _program_model(cfg)
    state = ref.make_weights(cfg, 2 ** 31 + 5, CPU)
    model.load_state_dict(state, strict=True)
    assert set(state) == set(model.state_dict())
    assert all(torch.equal(state[n], torch.zeros_like(state[n]))
               for n in state if n.endswith("running_mean"))


def test_preprocess_matches_program():
    from boxsegliver_torch.data.pipeline import batch_to_device
    from portbench.reference import train as rtrain

    with tempfile.TemporaryDirectory() as tmp:
        ctx = run.Context(_tiny_spec(), 4321, 1.0, False, CPU, Path(tmp))
        args = drv.program_args(ctx)
        trainer, data, ds = drv.build(ctx, args)
        raw = next(data)
        data.close()
        pf, pl = trainer.preprocess_fn(batch_to_device(raw, CPU),
                                       torch.Generator().manual_seed(3))
        flags = ctx.config["settings"]
        stack = rtrain.stacked_volumes(
            ds, rtrain.train_pids(ds, flags["test_fold"]), CPU)
        rf, rl = ref.preprocess(raw, *stack, torch.Generator().manual_seed(3),
                                flags, CPU)
    assert torch.equal(pl, rl)
    assert torch.equal(pf["images"].float(), rf["images"])


def _running_frozen(self, multi, batches):
    """The dispatch leaves the batch norms' running statistics as they
    were: a replay that updates a copy of them."""
    state = {n: b.detach().clone() for n, b in self.model.named_buffers()}
    out = multi(self, batches)
    with torch.no_grad():
        for n, b in self.model.named_buffers():
            b.copy_(state[n])
    return out


def _stale_generator(self, multi, batches):
    """Every step of the dispatch draws its first step's noise and dropout
    masks: a replay whose generator is not registered."""
    state = self.generator.get_state()
    out = []
    for batch in batches:
        self.generator.set_state(state)
        out += multi(self, [batch])
    return out


def _run():
    with tempfile.TemporaryDirectory() as tmp:
        return run.execute(_tiny_spec(), 2 ** 31 + 99, 0.5, False, CPU,
                           Path(tmp))


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _altered_gradient,
                                   _full_dispatch(_stale_rows),
                                   _full_dispatch(_replays_unchanged),
                                   _full_dispatch(_running_frozen),
                                   _full_dispatch(_stale_generator)])
def test_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not _run()["correct"]


@pytest.fixture(scope="module")
def calibration_rows():
    """The calibration's readings at the tiny size with the cell's K = 16:
    the program (float32 here), the control and the planted faults."""
    spec = _tiny_spec()
    spec["traffic"]["steps_per_dispatch"] = 16
    with tempfile.TemporaryDirectory() as tmp:
        ctx = run.Context(spec, 2 ** 31 + 17, 0.0, False, CPU, Path(tmp))
        return spec["limits"], drv.calibrate(ctx, True)


@pytest.mark.parametrize("reading", ["fault_half_batch", "fault_stale_rows",
                                     "fault_stale_generator",
                                     "fault_running_frozen"])
def test_planted_fault_fails_a_limit(calibration_rows, reading):
    limits, rows = calibration_rows
    assert run.judge(rows["program"], limits)[1], rows["program"]
    assert not run.judge(rows[reading], limits)[1], rows[reading]


@pytest.mark.parametrize("reading, key", [
    ("fault_stale_generator", "generator_gap"),
    ("fault_running_frozen", "running_change_median_gap")])
def test_exact_faults_read_their_own_number(calibration_rows, reading, key):
    """The stale generator and the frozen running statistics leave every
    other number near a sound program's; their own reads at its ceiling
    (the generator's states differ; the running statistics do not move,
    so the median buffer's change is all gap), where the program's reads
    0 or near it."""
    _, rows = calibration_rows
    assert rows[reading][key] > 0.9
    assert rows["program"][key] < 0.01


def test_metric_readers():
    """The ten readers over a hand-made trace: batch-norm kernels by name,
    the rest of the elementwise group without them."""
    rec = {"units": 2, "window_s": 1.0, "busy_s": 0.9, "traced_s": 1.0,
           "input_wait_s": 0.004, "host_launches": 8, "device_kernels": 16000,
           "norm_min_s_per_unit": 0.001, "flops_per_unit": 1e12,
           "kernels": [
               ("sm90_xmma_fprop", "conv", 0.010),
               ("void at::native::batch_norm_collect_statistics_kernel",
                "elementwise", 0.003),
               ("void at::native::batch_norm_backward_elemt_kernel",
                "elementwise", 0.001),
               ("void at::native::elementwise_kernel<relu>", "elementwise",
                0.002),
               ("Memcpy DtoD", "copy", 0.001),
               ("multi_tensor_apply_kernel", "optimizer", 0.0005)]}
    got = {m: run.reader(m)(rec) for m in METRICS}
    want = {"input_wait_ms.dense": 2.0, "host_launches_per_step.dense": 4.0,
            "device_kernels_per_step.dense": 8000.0,
            "conv_ms_per_step.dense": 5.0, "norm_ms_per_step.dense": 2.0,
            "elementwise_ms_per_step.dense": 1.5,
            "optimizer_ms_per_step.dense": 0.25,
            "norm_roofline.dense": 50.0, "device_idle_share.dense": 10.0,
            "mfu.dense": 100.0 * 2e12 / 989e12}
    assert got == pytest.approx(want)
    rec["kernels"] = rec["kernels"][:1]
    assert run.reader("norm_roofline.dense")(rec) is None
    del rec["device_kernels"]
    assert run.reader("device_kernels_per_step.dense")(rec) is None


def _tops(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_driver_reference_and_counts_load_no_jax():
    tops = _tops(["portbench.drivers.train_dense", "portbench.dense_counts",
                  "portbench.reference.dense_unet"])
    assert not tops & {"jax", "jaxlib", "flax", "boxsegliver_tpu"}
    tops = _tops(["portbench.reference.dense_unet", "portbench.dense_counts"])
    assert not tops & {"jax", "jaxlib", "flax", "boxsegliver_tpu",
                       "boxsegliver_torch"}
