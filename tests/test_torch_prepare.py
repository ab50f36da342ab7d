"""The port's data-preparation CLI (boxsegliver_torch.cli.prepare) against
the JAX package's on the same NIfTI files, written here from a seed with the
port's data/nii.write_nii: meta.json equal as JSON, the npy caches, the
histogram, GLCM and infer-context features and k_folds.txt equal (the same
numpy code on the same inputs), and the GLCM functions on their own,
parametrized over distances, angles and levels."""

import json

import numpy as np
import pytest

from boxsegliver_tpu.cli import prepare as j_prepare
from boxsegliver_tpu.ops import glcm as j_glcm
from boxsegliver_torch.cli import prepare as t_prepare
from boxsegliver_torch.data import nii as t_nii
from boxsegliver_torch.data.synthetic import make_case
from boxsegliver_torch.ops import glcm as t_glcm

# pid 3: no LiTS quirk; 30: volume and label stored flipped; 49: only the
# label stored flipped (the quirk's two ranges, 28-47 and 28-51, differ)
PIDS = (3, 30, 49)
SHAPE = (12, 64, 64)


@pytest.fixture(scope="module")
def nifti(tmp_path_factory):
    """LiTS-layout NIfTI files (volume-<pid>.nii, segmentation-<pid>.nii)
    stored in the quirk's orientation, and the arrays they hold once read
    the right way up."""
    src = tmp_path_factory.mktemp("prepare") / "nii"
    src.mkdir()
    rng = np.random.default_rng(5)
    cases = {}
    for pid in PIDS:
        volume, labels, spacing = make_case(rng, SHAPE)
        t_nii.write_nii(volume, src / f"volume-{pid}.nii", zooms=spacing,
                        special=28 <= pid < 48)
        t_nii.write_nii(labels, src / f"segmentation-{pid}.nii",
                        zooms=spacing, special=28 <= pid < 52)
        cases[pid] = (volume, labels)
    return src, cases


def _both(tmp_path, argv):
    """Run ``argv`` (with {dst} filled) through the JAX CLI and the port's,
    each into its own directory; returns the two directories."""
    out = []
    for name, mod in (("jax", j_prepare), ("torch", t_prepare)):
        dst = tmp_path / name
        mod.main([a.format(dst=dst) for a in argv])
        out.append(dst)
    return out


def _assert_same_tree(a, b):
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b and files_a
    for rel in files_a:
        if rel.suffix == ".npy":
            x, y = np.load(a / rel), np.load(b / rel)
            assert x.dtype == y.dtype and x.shape == y.shape, rel
            np.testing.assert_array_equal(x, y, err_msg=str(rel))
        elif rel.suffix == ".json":
            assert json.loads((a / rel).read_text()) == \
                json.loads((b / rel).read_text()), rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


@pytest.mark.parametrize("extra", [[], ["--no_lits_quirk"],
                                   ["--modality", "nf"], ["--only_meta"]],
                         ids=["lits", "no_quirk", "nf", "only_meta"])
def test_extract_matches_jax(nifti, tmp_path, extra):
    src, _ = nifti
    a, b = _both(tmp_path, ["extract", "--src", str(src), "--dst", "{dst}"]
                 + extra)
    _assert_same_tree(a, b)


def test_extract_applies_the_lits_quirk(nifti, tmp_path):
    """Each case's cache holds the arrays right way up: pid 30's volume and
    label and pid 49's label alone were flipped back on read."""
    from boxsegliver_torch.data.meta import load_meta, window_clip_uint16

    src, cases = nifti
    t_prepare.main(["extract", "--src", str(src), "--dst", str(tmp_path)])
    assert [m["PID"] for m in load_meta(tmp_path)] == list(PIDS)
    for pid, (volume, labels) in cases.items():
        d = tmp_path / f"volume-{pid}"
        np.testing.assert_array_equal(np.load(d / "volume.npy"),
                                      window_clip_uint16(volume))
        np.testing.assert_array_equal(np.load(d / "segmentation.npy"),
                                      labels)


@pytest.fixture(scope="module")
def prepared(nifti, tmp_path_factory):
    """extract, then every feature subcommand, through both CLIs."""
    src, _ = nifti
    root = tmp_path_factory.mktemp("prepared")
    dsts = {}
    for name, mod in (("jax", j_prepare), ("torch", t_prepare)):
        dst = root / name
        mod.main(["extract", "--src", str(src), "--dst", str(dst)])
        mod.main(["hist", "--dst", str(dst), "--bins", "50"])
        mod.main(["glcm", "--dst", str(dst)])
        mod.main(["prior", "--dst", str(dst)])
        mod.main(["kfold", "--dst", str(dst), "--k", "3", "--seed", "7"])
        mod.main(["infer_context", "--dst", str(dst), "--guide_file",
                  str(dst / "prior.json"), "--bins", "60"])
        dsts[name] = dst
    return dsts["jax"], dsts["torch"]


@pytest.mark.parametrize("rel", ["feat/hist", "feat/glcm", "prior.json",
                                 "k_folds.txt", "feat/hist/infer"])
def test_subcommand_output_matches_jax(prepared, rel):
    a, b = prepared
    if (a / rel).is_dir():
        _assert_same_tree(a / rel, b / rel)
    else:
        assert (a / rel).read_bytes() == (b / rel).read_bytes()


def test_prepared_features_are_real(prepared):
    """The chain produced tumors, non-zero guide histograms and GLCM rows,
    so the equalities above compare real data."""
    _, b = prepared
    prior = json.loads((b / "prior.json").read_text())
    assert all(prior[str(p)] for p in PIDS)
    for pid in PIDS:
        hist = np.load(b / "feat" / "hist" / "eval" / ("%03d.npy" % pid))
        assert hist.shape == (SHAPE[0], 100) and hist[:, 50:].any()
        infer = np.load(b / "feat" / "hist" / "infer" / ("%03d.npy" % pid))
        assert infer.shape == (SHAPE[0], 120) and infer[:, 60:].any()
        glcm = np.load(b / "feat" / "glcm" / "train" / ("%03d.npy" % pid))
        assert glcm.shape == (SHAPE[0], 96) and glcm.any()


def test_synthetic_matches_jax(tmp_path):
    a, b = _both(tmp_path, ["synthetic", "--dst", "{dst}", "--cases", "2",
                            "--depth", "6", "--size", "32", "--seed", "4"])
    _assert_same_tree(a, b)


@pytest.mark.parametrize("argv", [
    ["negcache", "--dst", "d", "--pred_dir", "p"],
    ["synthetic", "--dst", "d", "--modality", "nf"],
    ["synthetic", "--dst", "d", "--variant", "hard"]],
    ids=["negcache", "synthetic_nf", "synthetic_hard"])
def test_unported_subcommands_raise(tmp_path, argv):
    """These subcommands raised NotImplementedError until the NF slice
    ported them; each now writes what the JAX CLI writes (the synthetic NF
    sets of 2 cases of 6 x 32^2; the negatives cache from one prediction
    directory with a false-positive blob beside each case's labels)."""
    if argv[0] == "synthetic":
        a, b = _both(tmp_path, [x if x != "d" else "{dst}" for x in argv]
                     + ["--cases", "2", "--depth", "6", "--size", "32"])
        _assert_same_tree(a, b)
        return
    from boxsegliver_tpu.data.synthetic import make_synthetic_dataset

    pred = tmp_path / "p"
    pred.mkdir()
    for name in ("jax", "torch"):
        make_synthetic_dataset(tmp_path / name, n_cases=2, shape=(6, 32, 32),
                               modality="nf", seed=1)
    for pid in (0, 1):
        lab = np.load(tmp_path / "jax" / f"volume-{pid}" / "segmentation.npy")
        p = (lab > 0).astype(np.uint8)
        p[1:4, 2:9, 2:9] = 1
        np.savez_compressed(pred / f"predict-{pid}.npz", p)
    for name, mod in (("jax", j_prepare), ("torch", t_prepare)):
        mod.main([str(tmp_path / name) if a == "d" else
                  str(pred) if a == "p" else a for a in argv])
    _assert_same_tree(tmp_path / "jax" / "neg", tmp_path / "torch" / "neg")


def _image(levels, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, (23, 19)).astype(np.uint8)


@pytest.mark.parametrize("levels", [8, 64, 256])
@pytest.mark.parametrize("distances,angles", [
    ((1,), (0.0,)), ((1, 2, 3), (0.0, np.pi / 4, np.pi / 2, np.pi * 3 / 4)),
    ((2, 30), (np.pi / 2, np.pi))])
def test_glcm_matches_jax(levels, distances, angles):
    img = _image(levels, levels)
    for sym in (True, False):
        for normed in (True, False):
            np.testing.assert_array_equal(
                t_glcm.greycomatrix(img, distances, angles, levels, sym,
                                    normed),
                j_glcm.greycomatrix(img, distances, angles, levels, sym,
                                    normed))
    for norm in (True, False):
        tm, tr = t_glcm.glcm_features(img, distances, angles, levels,
                                      features="all", flat=True,
                                      norm_levels=norm)
        jm, jr = j_glcm.glcm_features(img, distances, angles, levels,
                                      features="all", flat=True,
                                      norm_levels=norm)
        np.testing.assert_array_equal(tm, jm)
        assert list(tr) == list(jr)
        assert sorted(tr) == sorted(t_glcm.ALL_FEATURES)
        for k in tr:
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_case_glcm_features_match_jax(prepared, mode):
    from boxsegliver_torch.data.meta import GRAY_MIN, IM_SCALE, load_meta

    _, b = prepared
    for m in load_meta(b):
        vol = np.load(b / f"volume-{m['PID']}" / "volume.npy")
        hu = vol.astype(np.float32) / IM_SCALE + GRAY_MIN
        np.testing.assert_array_equal(
            t_glcm.case_glcm_features(hu, m, mode, distances=(1, 2),
                                      filter_size=9),
            j_glcm.case_glcm_features(hu, m, mode, distances=(1, 2),
                                      filter_size=9))


def test_glcm_rejects_unknown_feature():
    with pytest.raises(ValueError, match="invalid property"):
        t_glcm.glcm_features(_image(8, 0), (1,), (0.0,), 8,
                             features=["nope"])
