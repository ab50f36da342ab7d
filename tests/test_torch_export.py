"""The port's serving export (boxsegliver_torch/cli/export.py) against the
JAX package's (boxsegliver_tpu/cli/export.py).

For UNet_TINY (batch norm) and GUNet_TINY (instance norm, whose norm + ReLU
pairs run the operator boxseg::in_relu_fwd through its CPU implementation,
the plain version) at 32^2, batch 2, float32: the JAX trainer's seeded
weights are exported by JAX export_model, bridged into a port checkpoint
(models/weights.flax_to_state_dict) and exported by the port's
``--mode export --ckpt_path``.  The same seeded features served from both
bundles agree within 1e-5, as JAX's own export test holds its bundle
against its live model; the two signature.json files are equal; the port's
bundle gives its live model's output; the operator is a node of the GUNet's
exported graph and not of the UNet's."""

import json

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import main as jmain
from boxsegliver_tpu.cli.export import export_model as jexport_model
from boxsegliver_tpu.cli.export import load_exported as jload_exported
from boxsegliver_tpu.data.synthetic import make_synthetic_dataset
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.cli.export import export_model, load_exported
from boxsegliver_torch.models.weights import flax_to_state_dict

torch.set_num_threads(2)

MODEL_FLAGS = {
    "UNet": ["--model", "UNet", "--model_config", "UNet_TINY.yml"],
    "GUNet": ["--model", "GUNet", "--model_config", "GUNet_TINY.yml",
              "--normalizer", "instance_norm", "--use_context",
              "--context_list", "hist", "20", "--use_spatial"],
}


def _argv(model, tmp, root, *extra):
    return (["liver", "--mode", "export", "--tag", "texp"]
            + MODEL_FLAGS[model]
            + ["--classes", "Liver", "Tumor", "--batch_size", "2",
               "--im_height", "32", "--im_width", "32", "--im_channel", "3",
               "--compute_dtype", "float32", "--test_fold", "0",
               "--k_folds", "4", "--model_dir", str(tmp / "m"),
               "--data_root", str(root.parent), "--dataset", root.name]
            + list(extra))


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.tree_util.tree_map(
                np.asarray, dict(tree)), sep="/").items()}


def _features(signature, seed):
    rng = np.random.RandomState(seed)
    feats = {}
    for key, (shape, dtype) in signature["inputs"].items():
        arr = rng.rand(*shape).astype(dtype)
        feats[key] = arr * 0.5 + 0.25 if key == "sp_guide" else arr
    return feats


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp") / "synthetic"
    make_synthetic_dataset(root, n_cases=4, shape=(10, 64, 64), k_split=4)
    return root


@pytest.fixture(scope="module", params=sorted(MODEL_FLAGS))
def bundles(request, root, tmp_path_factory):
    """(model, JAX bundle, port bundle, port args) from the same weights."""
    model = request.param
    tmp = tmp_path_factory.mktemp(f"export_{model}")
    jargs = jmain.get_args(_argv(model, tmp, root))
    jargs.num_replicas = 1
    jdir = jexport_model(jargs, root, out_dir=tmp / "jax")
    trainer = jmain.build_trainer(jargs, root)
    flat = _flat(trainer.state.params, "params")
    if trainer.state.batch_stats:
        flat.update(_flat(trainer.state.batch_stats, "batch_stats"))
    trainer.ckpt.close()
    ckpt = tmp / "bridged.pt"
    torch.save({"model": flax_to_state_dict(flat)}, ckpt)
    args = cli.get_args(_argv(model, tmp, root, "--device", "cpu",
                              "--ckpt_path", str(ckpt)))
    pdir = export_model(args, out_dir=tmp / "port")
    return model, jdir, pdir, args


def test_port_bundle_matches_jax_bundle(bundles):
    model, jdir, pdir, _ = bundles
    assert {p.name for p in pdir.iterdir()} == {"model.pt2", "state.pt",
                                                "signature.json"}
    jserve, jsig = jload_exported(jdir)
    serve, sig = load_exported(pdir, "cpu")
    feats = _features(sig, seed=7)
    want = np.asarray(jserve(feats))
    got = serve(feats)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(want.sum(-1), 1.0, atol=1e-5)


def test_signature_equals_jax(bundles):
    _, jdir, pdir, _ = bundles
    assert (json.loads((pdir / "signature.json").read_text())
            == json.loads((jdir / "signature.json").read_text()))


def test_port_bundle_matches_live_model(bundles):
    """The exported program gives what the live model and softmax give on
    the same weights (restored from the bundle's state.pt)."""
    model, _, pdir, args = bundles
    serve, sig = load_exported(pdir, "cpu")
    feats = _features(sig, seed=3)
    live = cli._build_model(args)
    live.load_state_dict(torch.load(pdir / "state.pt")["model"], strict=True)
    with torch.no_grad():
        want = torch.softmax(live.eval()({k: torch.from_numpy(v)
                                          for k, v in feats.items()}), -1)
    torch.testing.assert_close(serve(feats), want, atol=1e-6, rtol=0)


def test_in_relu_op_in_exported_graph(bundles):
    """B2-fwd is one node of a registered operator per full-affine
    instance-norm + ReLU pair (GUNet_TINY: the two of its unmodulated first
    level and the four of its decoder, boxseg::in_relu_nhwc_fwd on its
    channels-last activations); batch norm has none."""
    model, _, pdir, _ = bundles
    program = torch.export.load(pdir / "model.pt2")
    nodes = [n for n in program.graph.nodes
             if n.op == "call_function"
             and n.target in (torch.ops.boxseg.in_relu_fwd.default,
                              torch.ops.boxseg.in_relu_nhwc_fwd.default)]
    assert len(nodes) == (6 if model == "GUNet" else 0)


def test_device_defaults_to_the_card(bundles):
    """Loading onto "cuda" and the CLI's export without --device cpu raise
    where torch sees no GPU: the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA paths are tests/"
                    "test_torch_cuda.py's")
    model, _, pdir, args = bundles
    with pytest.raises(RuntimeError, match="--device cpu"):
        load_exported(pdir, "cuda")
    argv = _argv(model, pdir.parent, pdir.parent / "unused")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv)
