"""The port's viewers against the JAX package's: cli/viewer (the PNG
encoder, build_case, parse_scores, load_pred, build_viewer) and
utils/viewer.save_case_overlays.  Images are compared by their decoded
pixels (the PNG bytes differ from OpenCV's): nearest-resized masks equal,
the INTER_AREA-downscaled gray within one level.  The overlays are checked
against the composite formula written out here, and by their file set
against the JAX package's matplotlib figures."""

import base64
import json
import re
import struct

import cv2
import numpy as np
import pytest
from scipy import ndimage as ndi

from boxsegliver_tpu.cli import viewer as j_viewer
from boxsegliver_tpu.data.synthetic import make_synthetic_dataset
from boxsegliver_tpu.utils import viewer as j_uviewer
from boxsegliver_torch.cli import viewer as t_viewer
from boxsegliver_torch.data import nii as t_nii
from boxsegliver_torch.data.meta import load_meta
from boxsegliver_torch.data.sampler import CaseVolumes
from boxsegliver_torch.utils import viewer as t_uviewer


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_viewer") / "synthetic"
    make_synthetic_dataset(root, n_cases=2, shape=(10, 64, 64), k_split=2,
                           seed=3)
    return root


def _decode(url_or_bytes):
    raw = (base64.b64decode(url_or_bytes.split(",", 1)[1])
           if isinstance(url_or_bytes, str) else url_or_bytes)
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_UNCHANGED)


def _text_chunks(png: bytes):
    out, pos = {}, 8
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if kind == b"tEXt":
            key, value = png[pos + 8:pos + 8 + n].split(b"\0", 1)
            out[key.decode("latin-1")] = value.decode("latin-1")
        pos += 12 + n
    return out


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 64), (512, 512)])
def test_png_b64_decodes_to_jax_pixels(shape):
    rng = np.random.default_rng(shape[0])
    for arr in (rng.integers(0, 256, shape).astype(np.uint8),
                rng.integers(0, 3, shape).astype(np.uint8)):
        got, want = _decode(t_viewer._png_b64(arr)), \
            _decode(j_viewer._png_b64(arr))
        assert got.dtype == np.uint8 and got.shape == shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr)


def test_encode_png_rgb_and_title():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    png = t_viewer.encode_png(rgb, text={"Title": "case-3 z=4 Dice=0.9"},
                              level=9)
    np.testing.assert_array_equal(_decode(png)[..., ::-1], rgb)
    assert _text_chunks(png) == {"Title": "case-3 z=4 Dice=0.9"}
    with pytest.raises(ValueError):
        t_viewer.encode_png(rgb.astype(np.float32))


def test_parse_scores_matches_jax(tmp_path):
    log = tmp_path / "log.txt"
    log.write_text(
        "01:00 I Evaluate-1 case 27 Liver/Dice: 0.954 Liver/VOE: 0.100 "
        "Tumor/Dice: 0.713 (1.2 s)\n"
        "01:01 I Evaluate-2 case 5 NF/Dice: 0.792 (2.3 s)\n")
    res = tmp_path / "eval_results_3d.txt"
    res.write_text(json.dumps({"Liver/Dice": 0.9, "Tumor/Dice": 0.6,
                               "GLiverDice": 0.91}))
    for f in (log, res):
        assert t_viewer.parse_scores(f) == j_viewer.parse_scores(f)
    assert t_viewer.parse_scores(log)["27"] == {"Liver": 0.954,
                                                "Tumor": 0.713}


def test_load_pred_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 3, (4, 8, 9)).astype(np.uint8)
    t_nii.write_nii(arr, tmp_path / "predict-7.nii.gz")
    probs = rng.random((4, 8, 9, 3)).astype(np.float32)
    np.savez_compressed(tmp_path / "7.npz", probs)
    for name in ("predict-7.nii.gz", "7.npz"):
        got = t_viewer.load_pred(tmp_path / name)
        np.testing.assert_array_equal(got, j_viewer.load_pred(tmp_path / name))
        assert got.dtype == np.uint8
    np.testing.assert_array_equal(t_viewer.load_pred(tmp_path / "7.npz"),
                                  probs.argmax(-1))


def _assert_case_equal(got, want):
    """Payloads equal: geometry, masks pixel for pixel, the gray image
    within one level; returns (differing gray pixels, gray pixels)."""
    assert {k: v for k, v in got.items() if k != "axes"} == \
        {k: v for k, v in want.items() if k != "axes"}
    assert list(got["axes"]) == list(want["axes"])
    n_diff = n_all = 0
    for ax in got["axes"]:
        assert len(got["axes"][ax]) == len(want["axes"][ax])
        for g, w in zip(got["axes"][ax], want["axes"][ax]):
            for kind in ("gt", "pred"):
                np.testing.assert_array_equal(_decode(g[kind]),
                                              _decode(w[kind]))
            gi, wi = _decode(g["img"]), _decode(w["img"])
            assert gi.shape == wi.shape
            d = np.abs(gi.astype(np.int32) - wi)
            assert d.max() <= 1
            n_diff += int((d > 0).sum())
            n_all += d.size
    return n_diff, n_all


# gray pixels one level off OpenCV's INTER_AREA, of all, per max_size: none
# without a resize and at the z axis' factor of 2; the others are rounding
# of sums that land within float32's error of a half (cv2 sums in float32)
AREA_DIFF = {256: (0, 270336), 48: (449, 147456), 32: (152, 65536),
             20: (7, 26240)}


@pytest.mark.parametrize("max_size", sorted(AREA_DIFF))
def test_build_case_matches_jax(ds, max_size):
    """48 and 20 shrink by non-integer factors (INTER_AREA's fractional
    weights), 32 the z axis by 2; every axis, spacing-corrected."""
    meta = load_meta(ds)[1]
    pid = int(meta["PID"])
    pred = np.roll(np.asarray(CaseVolumes(ds).label(pid)), 2, axis=1)
    got = t_viewer.build_case(meta, ds, pred, nf=False, axes="zyx",
                              max_size=max_size)
    want = j_viewer.build_case(meta, ds, pred, nf=False, axes="zyx",
                               max_size=max_size)
    assert _assert_case_equal(got, want) == AREA_DIFF[max_size]


def test_build_viewer_matches_jax(ds, tmp_path):
    metas = load_meta(ds)
    pred_dir = tmp_path / "prediction"
    pred_dir.mkdir()
    for m in metas:
        gt = np.asarray(CaseVolumes(ds).label(int(m["PID"])))
        t_nii.write_nii(np.roll(gt, 1, axis=0),
                        pred_dir / f"predict-{m['PID']}.nii.gz",
                        zooms=m["spacing"])
    log = tmp_path / "log.txt"
    log.write_text("Evaluate-1 case 0 Liver/Dice: 0.5 Tumor/Dice: 0.25\n")
    pat = re.compile(r"const DATA = (\{.*?\});\nlet cur", re.S)
    data = {}
    for name, mod in (("jax", j_viewer), ("torch", t_viewer)):
        out = mod.build_viewer(pred_dir, ds, tmp_path / f"{name}.html",
                               score_file=log, axes="zx", max_size=48)
        html = out.read_text()
        data[name] = json.loads(pat.search(html).group(1))
        assert html.replace(pat.search(html).group(1), "") == \
            j_viewer._HTML.replace("__DATA__", "")
    assert data["torch"]["scores"] == data["jax"]["scores"]
    assert list(data["torch"]["cases"]) == list(data["jax"]["cases"])
    for pid in data["jax"]["cases"]:
        _assert_case_equal(data["torch"]["cases"][pid],
                           data["jax"]["cases"][pid])
    one = t_viewer.build_viewer(pred_dir, ds, tmp_path / "one.html",
                                pids=[int(metas[0]["PID"])])
    assert list(json.loads(pat.search(one.read_text()).group(1))["cases"]) \
        == [str(metas[0]["PID"])]
    with pytest.raises(ValueError):
        t_viewer.build_viewer(pred_dir, ds, tmp_path / "q.html", axes="q")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        t_viewer.build_viewer(tmp_path / "empty", ds, tmp_path / "e.html")


def _want_composite(v, pred, label):
    """The overlay formula: gray, per class the prediction filled at alpha
    0.35, then the label's inner boundary (4-connected erosion, outside the
    image counting as background) in the class color; rounded to uint8."""
    rgb = np.repeat(v[..., None], 3, -1).astype(np.float32)
    for cls, color in ((1, (0.2, 0.6, 1.0)), (2, (1.0, 0.3, 0.2)),
                       (3, (0.2, 1.0, 0.4))):
        c = np.asarray(color, np.float32)
        m = pred == cls
        rgb[m] = 0.65 * rgb[m] + 0.35 * c
        if label is not None:
            lm = label == cls
            rgb[lm & ~ndi.binary_erosion(lm, border_value=0)] = c
    return np.round(rgb * 255).astype(np.uint8)


@pytest.mark.parametrize("every,max_slices,with_label",
                         [(1, 64, True), (2, 3, True), (1, 64, False)])
def test_save_case_overlays(tmp_path, every, max_slices, with_label):
    rng = np.random.default_rng(every + max_slices)
    vol = rng.normal(0, 50, (12, 20, 24)).astype(np.float32)
    label = np.zeros(vol.shape, np.uint8)
    label[3:8, 4:15, 5:18] = 1
    label[4:7, 6:10, 8:12] = 2
    label[3, 0:3, 0:4] = 1                 # touches the image edge
    pred = np.roll(label, 1, axis=2)
    label = label if with_label else None
    scores = {"Liver/Dice": 0.9, "Tumor/Dice": 0.5}
    out_t = t_uviewer.save_case_overlays(vol, label, pred, tmp_path / "t",
                                         "case-4", scores, every, max_slices)
    out_j = j_uviewer.save_case_overlays(vol, label, pred, tmp_path / "j",
                                         "case-4", scores, every, max_slices)
    files = sorted(p.name for p in out_t.iterdir())
    assert files == sorted(p.name for p in out_j.iterdir())
    zs = [int(f[6:9]) for f in files if f.startswith("slice_")]
    v = (vol - vol.min()) / (vol.max() - vol.min() + 1e-8)
    for z in zs:
        png = (out_t / f"slice_{z:03d}.png").read_bytes()
        np.testing.assert_array_equal(
            _decode(png)[..., ::-1],
            _want_composite(v[z], pred[z], None if label is None
                            else label[z]))
        assert _text_chunks(png) == {
            "Title": f"case-4 z={z}  Liver/Dice=0.900 Tumor/Dice=0.500"}
    sheet = _decode((out_t / "sheet.png").read_bytes())[..., ::-1]
    cols = min(8, len(zs))
    assert sheet.shape == (-(-len(zs) // cols) * 20, cols * 24, 3)
    for i, z in enumerate(zs):
        r, c = divmod(i, cols)
        np.testing.assert_array_equal(
            sheet[r * 20:(r + 1) * 20, c * 24:(c + 1) * 24],
            _want_composite(v[z], pred[z], None))
