"""The port's host tools against the JAX package's: cli/compare_preds (its
output and exit code on the same prediction directories), utils/ckpt_tools
over the port's state.pt (list; rename with the JAX rules' key mapping;
find_checkpoint on one model_dir layout) and cli/vis (the predicted class
volume of a port bundle against JAX vis on a JAX bundle of the same,
bridged, weights, both with save_case_overlays captured)."""

import json

import numpy as np
import pytest
import torch

from boxsegliver_tpu.cli import compare_preds as j_compare
from boxsegliver_tpu.cli import main as jmain
from boxsegliver_tpu.cli import vis as j_vis
from boxsegliver_tpu.cli.export import export_model as jexport_model
from boxsegliver_tpu.data.synthetic import make_synthetic_dataset
from boxsegliver_tpu.utils import ckpt_tools as j_ckpt
from boxsegliver_torch.cli import compare_preds as t_compare
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.cli import vis as t_vis
from boxsegliver_torch.cli.export import export_model
from boxsegliver_torch.data import nii as t_nii
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.train.checkpoint import CheckpointManager, load_state
from boxsegliver_torch.utils import ckpt_tools as t_ckpt

from test_torch_export import _argv, _flat

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# compare_preds
# ---------------------------------------------------------------------------

def _preds(root, case):
    """Two prediction directories for one scenario of the parity gate."""
    rng = np.random.RandomState(len(case))
    ref, ours = root / "ref", root / "ours"
    ref.mkdir(), ours.mkdir()
    arr = rng.randint(0, 3, size=(8, 32, 32)).astype(np.uint8)
    if case == "identical":
        for pid in (3, 11):
            t_nii.write_nii(arr, ref / f"predict-{pid}.nii.gz")
            t_nii.write_nii(arr, ours / f"predict-{pid}.nii.gz")
    elif case == "diverging":
        other = arr.copy()
        other[:4] = (other[:4] + 1) % 3
        t_nii.write_nii(arr, ref / "predict-5.nii.gz")
        t_nii.write_nii(other, ours / "predict-5.nii.gz")
    elif case == "shape":
        t_nii.write_nii(arr, ref / "predict-5.nii.gz")
        t_nii.write_nii(arr[:, :, :31], ours / "predict-5.nii.gz")
    elif case == "one_side":
        t_nii.write_nii(arr, ref / "predict-5.nii.gz")
        t_nii.write_nii(arr, ours / "predict-5.nii.gz")
        t_nii.write_nii(arr, ours / "predict-6.nii.gz")
        np.savez_compressed(ref / "9.npz", arr)
        np.savez_compressed(ours / "9.npz", arr)
    elif case == "disjoint":
        t_nii.write_nii(arr, ref / "predict-5.nii.gz")
        t_nii.write_nii(arr, ours / "predict-6.nii.gz")
    return ref, ours


@pytest.mark.parametrize("case", ["identical", "diverging", "shape",
                                  "one_side", "disjoint"])
@pytest.mark.parametrize("extra", [[], ["--json"],
                                   ["--json", "--min_dice", "1.0",
                                    "--classes", "Liver"]],
                         ids=["text", "json", "gate"])
def test_compare_preds_matches_jax(tmp_path, capsys, case, extra):
    ref, ours = _preds(tmp_path, case)
    argv = [str(ref), str(ours)] + extra
    rc_j = j_compare.main(argv)
    out_j = capsys.readouterr()
    rc_t = t_compare.main(argv)
    out_t = capsys.readouterr()
    assert (rc_t, out_t.out, out_t.err) == (rc_j, out_j.out, out_j.err)
    assert rc_t == {"identical": 0, "diverging": 1, "shape": 1,
                    "one_side": 0, "disjoint": 2}[case]
    if "--json" in extra and case != "disjoint":
        assert set(json.loads(out_t.out)) == {"aggregate", "per_case"}


# ---------------------------------------------------------------------------
# ckpt_tools
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt(tmp_path):
    """A port checkpoint (GUNet_TINY) as the trainer writes it."""
    args = cli.get_args(_argv("GUNet", tmp_path, tmp_path / "ds", "--device",
                              "cpu"))
    model = cli._build_model(args)
    model.reset_parameters(torch.Generator().manual_seed(0))
    manager = CheckpointManager(tmp_path / "md")
    manager.save(7, {"model": model.state_dict(), "step": 7,
                     "lr_scale": 0.5})
    return manager.latest_path(), model.state_dict()


def test_ckpt_list(ckpt, capsys):
    path, state = ckpt
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in state.items()}
    assert t_ckpt.list_vars(path) == want
    assert t_ckpt.list_vars(path.parent) == want
    t_ckpt.main(["list", str(path.parent)])
    assert capsys.readouterr().out.splitlines() == [
        f"{k} {s} {d}" for k, (s, d) in sorted(want.items())]


@pytest.mark.parametrize("replace,prefix", [
    (["Encode1:Enc1"], None), (["conv:empty", "weight:w"], None),
    ([], "ema_"), (["Decode:Up", "bias:b"], "m_")])
def test_ckpt_rename_matches_jax_rules(ckpt, tmp_path, monkeypatch, replace,
                                       prefix):
    """The port renames state_dict keys as JAX renames the same names as
    tree paths ('.' for '/'), then writes a state.pt that keeps the
    checkpoint's other entries."""
    path, state = ckpt
    pairs = [r.split(":", 1) for r in replace]
    frm, to = [p[0] for p in pairs], [p[1] for p in pairs]
    tree = j_ckpt.unflatten_tree({k.replace(".", "/"): np.zeros(1)
                                  for k in state})
    monkeypatch.setattr(j_ckpt, "load_ckpt_tree", lambda p: tree)
    want = set(j_ckpt.flatten_tree(j_ckpt.ckpt_vars_rename("x", None, frm,
                                                           to, prefix)))
    out = tmp_path / "renamed" / "state.pt"
    argv = ["rename", str(path), str(out)]
    argv += ["--replace"] + replace if replace else []
    argv += ["--add_prefix", prefix] if prefix else []
    t_ckpt.main(argv)
    written = load_state(out)
    assert {k.replace(".", "/") for k in written["model"]} == want
    assert (written["step"], written["lr_scale"]) == (7, 0.5)
    names = t_ckpt.rename_keys(state, frm, to, prefix)
    for old, new in names.items():
        assert torch.equal(written["model"][new], state[old])


def test_ckpt_rename_rejects_a_collision(ckpt, tmp_path):
    path, _ = ckpt
    with pytest.raises(ValueError, match="two variables"):
        t_ckpt.ckpt_vars_rename(path, tmp_path / "x.pt", ["weight", "bias"],
                                ["p", "p"])


def test_find_checkpoint_matches_jax(tmp_path):
    md = tmp_path / "md"
    manager = CheckpointManager(md, max_to_keep=3)
    for step in (4, 12):
        manager.save(step, {"model": {}})
    manager.save_best({"model": {}})
    manager.save_best({"model": {}}, tag="best_1")
    (md / "ckpt" / "30").mkdir()              # no state.pt: not a checkpoint
    (md / "ckpt" / "tmp").mkdir()
    for status in ("checkpoint", "checkpoint_best", "checkpoint_best_1"):
        got = t_ckpt.find_checkpoint(md, status)
        assert got is not None and (got / "state.pt").exists()
        if status != "checkpoint":
            assert got == j_ckpt.find_checkpoint(md, status)
    assert t_ckpt.find_checkpoint(md) == md / "ckpt" / "12"
    for status in ("checkpoint", "checkpoint_best_2"):
        assert t_ckpt.find_checkpoint(tmp_path / "none", status) is None
        assert j_ckpt.find_checkpoint(tmp_path / "none", status) is None
    assert t_ckpt.find_checkpoint(md, "checkpoint_best_2") is None


# ---------------------------------------------------------------------------
# vis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vis_bundles(tmp_path_factory):
    """(dataset, JAX bundle, port bundle) of GUNet_TINY at 32^2 from the
    same weights: JAX's seeded init, bridged into a port checkpoint."""
    tmp = tmp_path_factory.mktemp("vis")
    root = tmp / "synthetic"
    make_synthetic_dataset(root, n_cases=2, shape=(10, 48, 48), k_split=2)
    jargs = jmain.get_args(_argv("GUNet", tmp, root))
    jargs.num_replicas = 1
    jdir = jexport_model(jargs, root, out_dir=tmp / "jax")
    trainer = jmain.build_trainer(jargs, root)
    flat = _flat(trainer.state.params, "params")
    trainer.ckpt.close()
    torch.save({"model": flax_to_state_dict(flat)}, tmp / "bridged.pt")
    args = cli.get_args(_argv("GUNet", tmp, root, "--device", "cpu",
                              "--ckpt_path", str(tmp / "bridged.pt")))
    return root, jdir, export_model(args, out_dir=tmp / "port")


def _captured(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module, "save_case_overlays",
                        lambda *a, **k: calls.append(a) or a[3])
    return calls


def test_vis_matches_jax(vis_bundles, tmp_path, monkeypatch):
    from boxsegliver_tpu.utils import viewer as j_uviewer
    from boxsegliver_torch.utils import viewer as t_uviewer

    root, jdir, pdir = vis_bundles
    j_calls = _captured(monkeypatch, j_uviewer)
    t_calls = _captured(monkeypatch, t_uviewer)
    for pid in (0, 1):
        common = ["--dataset_dir", str(root), "--pid", str(pid), "--out",
                  str(tmp_path / "out")]
        j_vis.main(["--export_dir", str(jdir)] + common)
        t_vis.main(["--export_dir", str(pdir), "--device", "cpu"] + common)
    assert len(j_calls) == len(t_calls) == 2
    for (jv, jl, jp, _, jname), (tv, tl, tp, _, tname) in zip(j_calls,
                                                              t_calls):
        assert tname == jname
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tl, jl)
        assert tp.dtype == jp.dtype == np.uint8 and tp.shape == jp.shape
        np.testing.assert_array_equal(tp, jp)
        assert len(np.unique(tp)) > 1          # not a constant volume


def test_vis_writes_overlays(vis_bundles, tmp_path):
    root, _, pdir = vis_bundles
    out = t_vis.main(["--export_dir", str(pdir), "--dataset_dir", str(root),
                      "--pid", "1", "--out", str(tmp_path), "--device",
                      "cpu"])
    assert out == tmp_path / "case-1"
    assert (out / "sheet.png").exists() and list(out.glob("slice_*.png"))


def test_vis_defaults_to_the_card(vis_bundles, tmp_path, monkeypatch):
    """No --device means the card: without one vis raises, it does not run
    on the CPU."""
    root, _, pdir = vis_bundles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_vis.main(["--export_dir", str(pdir), "--dataset_dir", str(root),
                    "--out", str(tmp_path)])
