"""DenseUNet of the port against the benchmark's plain float32 reference
(``portbench/reference/dense_unet.py``, which imports nothing of the port)
on the CPU, both on the reference's seeded weights (``make_weights``) and
drawing their dropout masks from generators of the same seed, at
DenseUNet_tiny.yml and a mid size (stem 16, growth 8, blocks 2 / 3 / 4 / 3)
at 64² and batch 2:

- the train-mode forward: logits within 1e-5 of their largest (float32
  rounding through a dozen batch norms), both generators left in the same
  state (the same masks drawn, in the same order);
- the running statistics after it, within 1e-5 of each buffer's largest;
- the loss with L2 within 1e-5 relative, the gradients within 1e-4 of the
  largest of their leaf, the batch-norm offsets at 3 (a ReLU input within
  rounding of 0 moves a gradient by a pixel's share of the sum: two of six
  weight seeds put one there);
- the state after each of 3 Adam steps, the reference starting each from
  the port's: parameters within 1e-5 (a step moves a leaf by about
  lr = 1e-3 whatever its gradient's rounding; the test's docstring says
  which elements it leaves out), running statistics as above;
- the eval-mode forward on the moved running statistics within 1e-5;
- the reference's L2 set equal to ``ops/losses.decayed_parameters``;
- the port's stage spans recorded under a profiler in an eager forward,
  and its outputs bit-equal with the profiler on and off.
"""

import numpy as np
import pytest
import torch

from boxsegliver_torch import config as tconfig
from boxsegliver_torch.models.dense_unet import DenseUNet
from boxsegliver_torch.ops.losses import decayed_parameters
from boxsegliver_torch.train.trainer import Trainer
from portbench.reference import dense_unet as ref

torch.set_num_threads(2)
CPU = torch.device("cpu")
CLASSES = ["Background", "Liver", "Tumor"]
SIZES = {"tiny": dict(stem_channels=8, growth_rate=4, nb_layers=[2, 2, 2, 2]),
         "mid": dict(stem_channels=16, growth_rate=8, nb_layers=[2, 3, 4, 3])}
SETTINGS = {"loss_numeric_w": [0.2, 0.4, 4.4], "weight_decay_rate": 1e-6,
            "learning_rate": 1e-3, "lr_end": 5e-7}
FLAGS = ["--mode", "train", "--tag", "t", "--model", "DenseUNet",
         "--classes", "Liver", "Tumor", "--compute_dtype", "float32",
         "--loss_weight_type", "numerical", "--loss_numeric_w", "0.2", "0.4",
         "4.4", "--weight_decay_rate", "0.000001", "--dropout", "0.2",
         "--learning_policy", "plateau", "--learning_rate", "0.001",
         "--lr_end", "0.0000005", "--lr_decay_rate", "0.2", "--log_step",
         "1", "--seed", "77"]


def _config(size):
    return {"model": dict(SIZES[size], compression=0.5, dropout=0.2,
                          num_classes=3, in_channels=3),
            "settings": SETTINGS}


def _pair(size, seed=3):
    cfg = _config(size)
    state = ref.make_weights(cfg, seed, CPU)
    m = cfg["model"]
    port = DenseUNet(3, m["stem_channels"], m["growth_rate"], m["nb_layers"],
                     0.5, 0.2, dtype=torch.float32)
    port.load_state_dict(state, strict=True)
    net = ref.build(cfg)
    net.load_state_dict(state, strict=True)
    return cfg, state, port, net


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    feats = {"images": torch.from_numpy(
        rng.normal(size=(2, 64, 64, 3)).astype(np.float32))}
    labels = torch.from_numpy(rng.integers(0, 3, (2, 64, 64))).long()
    return feats, labels


def _close(got, want, tol):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=tol * max(scale, 1e-30))


def _buffers(module):
    return {n: b for n, b in module.named_buffers()}


def _close_buffers(got, want):
    """Running statistics within 1e-5 of each buffer's largest."""
    for n, b in want.items():
        _close(got[n], b, 1e-5)


def _away_from_kinks(port, net):
    """Every batch-norm offset at 3: the ReLUs' inputs sit away from 0,
    where a float32 rounding would flip a gradient."""
    with torch.no_grad():
        for model in (port, net):
            for n, p in model.named_parameters():
                if n.endswith(".bias"):
                    p.fill_(3.0)


@pytest.mark.parametrize("size", ["tiny", "mid"])
def test_train_forward_and_running_update_match(size):
    _, _, port, net = _pair(size)
    feats, _ = _inputs()
    gp = torch.Generator().manual_seed(11)
    gr = torch.Generator().manual_seed(11)
    with torch.no_grad():
        got = port(feats, train=True, generator=gp)
        want = net(feats, ref.Ops(), gr)
    _close(got, want, 1e-5)
    assert torch.equal(gp.get_state(), gr.get_state())
    pb, rb = _buffers(port), _buffers(net)
    assert set(pb) == set(rb)
    moved = 0
    for n in rb:
        _close(pb[n], rb[n], 1e-5)
        base = 0.0 if n.endswith("running_mean") else 1.0
        moved += not torch.all(rb[n] == base)
    assert moved == len(rb)


@pytest.mark.parametrize("size", ["tiny", "mid"])
def test_eval_forward_matches(size):
    _, _, port, net = _pair(size)
    feats, _ = _inputs()
    with torch.no_grad():
        for _ in range(2):          # move the running statistics first
            port(feats, train=True, generator=torch.Generator().manual_seed(1))
            net(feats, ref.Ops(), torch.Generator().manual_seed(1))
        got = port(feats)
        want = net(feats, ref.Ops())
    _close(got, want, 1e-5)


def _trainer(port, model_dir):
    args = tconfig.build_parser().parse_args(
        FLAGS + ["--model_dir", str(model_dir)])
    feats, labels = _inputs()
    return Trainer(port, args, CLASSES, "cpu",
                   preprocess_fn=lambda batch, gen: (feats, labels)), args


@pytest.mark.parametrize("size", ["tiny", "mid"])
def test_loss_and_gradients_match(size, tmp_path):
    cfg, state, port, _ = _pair(size)
    trainer, args = _trainer(port, tmp_path)
    feats, labels = _inputs()
    rt = ref.RefDenseTrainer(cfg, state, CPU)
    _away_from_kinks(port, rt.net)
    grads, total, _, _ = trainer.gradients(feats, labels)
    want_total, want = rt.step(feats, labels,
                               torch.Generator().manual_seed(args.seed))
    np.testing.assert_allclose(float(total), want_total, rtol=1e-5)
    assert trainer.param_names == rt.names
    for name, g, w in zip(rt.names, grads, want):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=1e-4 * max(float(w.abs().max()), 1e-12), err_msg=name)


@pytest.mark.parametrize("size", ["tiny", "mid"])
def test_three_adam_steps_match(size, tmp_path):
    """Each of 3 Adam steps from the port's state (parameters, running
    statistics, moments) gives the same state.  The reference starts each
    step from the port's state: a float32 gradient within rounding of 0
    turns into ±lr under Adam, and in a third of the weight seeds one such
    element then moves the tiny network's next steps off by 1e-4 to 1e-3.
    The batch-norm offsets sit at 3 (``_away_from_kinks``).  Adam divides
    an element's moment by its own root mean square, so a gradient's error
    relative to its leaf's largest becomes the step's error relative to lr
    once divided by the element's share of that largest: elements whose
    gradient stayed under 1e-2 of their leaf's largest in every step so far
    are left out of the parameters' comparison."""
    cfg, state, port, _ = _pair(size)
    trainer, args = _trainer(port, tmp_path)
    feats, labels = _inputs()
    rt = ref.RefDenseTrainer(cfg, state, CPU)
    _away_from_kinks(port, rt.net)
    gen = torch.Generator().manual_seed(args.seed)
    raw = {"names": np.zeros((2,), np.int32)}
    params = [dict(port.named_parameters())[n] for n in rt.names]
    seen = [torch.zeros_like(p) for p in params]
    for step in range(3):
        with torch.no_grad():
            for q, p in zip(rt.params, params):
                q.copy_(p)
            for n, b in rt.net.named_buffers():
                b.copy_(_buffers(port)[n])
            if step:
                opt = trainer.optimizer.state
                for q, m, v, pm, pv in zip(rt.params, rt.mu, rt.nu,
                                           opt["mu"], opt["nu"]):
                    m.copy_(pm)
                    v.copy_(pv)
        vals, _ = trainer.train_step(raw)
        want_total, grads = rt.step(feats, labels, gen)
        np.testing.assert_allclose(float(vals[0]), want_total, rtol=1e-5)
        assert torch.equal(trainer.generator.get_state(), gen.get_state())
        for i, (name, g) in enumerate(zip(rt.names, grads)):
            seen[i] = torch.maximum(seen[i], g.abs() / g.abs().max())
            keep = seen[i] >= 1e-2
            np.testing.assert_allclose(
                params[i].detach()[keep].numpy(),
                rt.params[i].detach()[keep].numpy(), rtol=0, atol=1e-5,
                err_msg=f"step {step + 1} {name}")
        _close_buffers(_buffers(port), _buffers(rt.net))
    assert rt.count == trainer.optimizer.count == 3


def test_l2_set_matches_decayed_parameters():
    _, _, port, net = _pair("mid")
    assert ref.decayed(net) == decayed_parameters(port)


def test_stage_spans_recorded_and_outputs_unchanged():
    _, _, port, _ = _pair("tiny")
    feats, _ = _inputs()
    with torch.no_grad():
        off = port(feats, train=True, generator=torch.Generator().manual_seed(2))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            on = port(feats, train=True,
                      generator=torch.Generator().manual_seed(2))
    assert torch.equal(on, off)
    names = [e.name for e in prof.events() if e.name.startswith("boxseg.")]
    want = (["boxseg.dense.stem"]
            + [f"boxseg.dense.{s}{i}" for i in (2, 3, 4)
               for s in ("block", "transition")]
            + ["boxseg.dense.block5", "boxseg.dense.decoder"])
    assert sorted(names) == sorted(want)
