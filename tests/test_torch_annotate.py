"""The port's annotation app (boxsegliver_torch.cli.annotate) on the CPU,
against the JAX app (tests/test_annotate.py mirrored): the state, the slice
payloads (decoded pixels against the JAX app's), the interaction round trip
in the prior schema, the guide preview (kernel B1's plain version here)
against the JAX app's numpy render (float within 1e-6, uint8 within one
level), and a live predict with the JAX app's fitted tiny GUNet bridged into
the port (class maps equal, metrics within 1e-6).  The weight selection of
the live predictor has one test per branch, and the app's --device is
checked against the model arguments'."""

import base64
import json
import threading
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from boxsegliver_tpu.cli import annotate as j_annotate
from boxsegliver_tpu.data.synthetic import make_synthetic_dataset
from boxsegliver_tpu.ops import array_kits as j_array_kits
from boxsegliver_torch import models as t_models
from boxsegliver_torch.cli import annotate as t_annotate
from boxsegliver_torch.cli import main as cli
from boxsegliver_torch.data import nii as t_nii
from boxsegliver_torch.data.meta import load_meta
from boxsegliver_torch.models.weights import flax_to_state_dict
from boxsegliver_torch.train.checkpoint import CheckpointManager

from test_device_sweep import _args, _gunet  # tiny fitted spatial GUNet

torch.set_num_threads(2)

ELLIPSE_TO_STD = t_annotate.ELLIPSE_TO_STD


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_annotate") / "ds"
    make_synthetic_dataset(root, n_cases=2, shape=(11, 96, 96), k_split=2,
                           seed=11)
    pred, cmp_ = root.parent / "pred", root.parent / "cmp"
    pred.mkdir(), cmp_.mkdir()
    rng = np.random.default_rng(0)
    for m in load_meta(root):
        shape = tuple(m["size"])
        t_nii.write_nii(rng.integers(0, 3, shape).astype(np.uint8),
                        pred / f"predict-{m['PID']}.nii.gz")
        np.savez_compressed(cmp_ / f"{m['PID']}.npz",
                            rng.random(shape + (3,)).astype(np.float32))
    return root


def _serve(app):
    server = (t_annotate if isinstance(app, t_annotate.AnnotateApp)
              else j_annotate).make_server(app, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture()
def served(ds, tmp_path):
    """The port app and the JAX app on the same dataset and overlays, each
    behind its own server; model_argv marks has_model (the live predictor
    is built or injected per test)."""
    kw = dict(pred_dir=ds.parent / "pred", cmp_dir=ds.parent / "cmp",
              model_argv=["liver"])
    t_app = t_annotate.AnnotateApp(ds, interactions_file=tmp_path / "t.json",
                                   device="cpu", **kw)
    j_app = j_annotate.AnnotateApp(ds, interactions_file=tmp_path / "j.json",
                                   **kw)
    t_server, t_base = _serve(t_app)
    j_server, j_base = _serve(j_app)
    yield t_app, t_base, j_app, j_base
    t_server.shutdown()
    j_server.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _decode(url):
    raw = base64.b64decode(url.split(",", 1)[1])
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_UNCHANGED)


def _assert_payload_equal(got, want, guide_levels=0):
    """Equal scalar fields and decoded images; the guide preview within
    ``guide_levels``."""
    assert set(got) == set(want)
    for k, v in want.items():
        if not isinstance(v, str) or not v.startswith("data:image/png"):
            assert got[k] == v, k
            continue
        g, w = _decode(got[k]), _decode(v)
        assert g.shape == w.shape, k
        tol = guide_levels if k == "guide" else 0
        assert np.abs(g.astype(np.int32) - w).max() <= tol, k


def test_state_and_slices_match_jax(served, ds):
    t_app, base, _, j_base = served
    state = _get(base + "/api/state")
    assert state == _get(j_base + "/api/state")
    assert [c["pid"] for c in state["cases"]] == \
        sorted(int(m["PID"]) for m in load_meta(ds))
    assert state["has_model"] and state["has_pred"] and state["has_cmp"]
    pid = state["cases"][0]["pid"]
    d, h, w = state["cases"][0]["size"]
    for axis, n in (("z", d), ("y", h), ("x", w)):
        for i in (0, n // 2, n + 3):             # i clips to the last plane
            url = f"/api/slice?pid={pid}&axis={axis}&i={i}"
            s = _get(base + url)
            _assert_payload_equal(s, _get(j_base + url))
            assert s["n"] == n and {"img", "gt", "pred", "cmp"} <= set(s)
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        html = r.read()
    assert b"boxsegliver annotate" in html and b"Predict (GPU)" in html
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert r.read() == b"ok"
    for url, code in (("/api/slice?pid=999&axis=z&i=0", 404),
                      ("/api/slice?pid=x&axis=z", 400), ("/nowhere", 404)):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + url)
        assert err.value.code == code


def test_interaction_roundtrip_matches_jax(served):
    t_app, base, j_app, j_base = served
    pid = _get(base + "/api/state")["cases"][0]["pid"]
    posts = [("/api/interaction", {"pid": pid, "sid": 5,
                                   "center": [40.0, 50.0],
                                   "radius": [8.0, 6.0], "z": [4, 7]}),
             ("/api/interaction", {"pid": pid, "sid": 5,
                                   "center": [20.0, 20.0], "radius": [4, 4]}),
             ("/api/interaction", {"pid": pid, "sid": 6,
                                   "center": [30.5, 60.25],
                                   "radius": [2, 12]}),
             ("/api/interaction/pop", {"pid": pid, "sid": 6}),
             ("/api/interaction/pop", {"pid": pid, "sid": 9})]
    for path, body in posts:
        assert _post(base + path, body) == _post(j_base + path, body)
    state = _get(base + "/api/state")
    assert state == _get(j_base + "/api/state")
    assert state["cases"][0]["guides"] == 2
    assert state["interactions"][str(pid)]["5"][0]["stddev"] == [
        round(8.0 * ELLIPSE_TO_STD, 3), round(6.0 * ELLIPSE_TO_STD, 3)]
    assert state["interactions"][str(pid)]["5"][1]["z"] == [5, 6]
    # the axial slice with interactions previews their guide
    url = f"/api/slice?pid={pid}&axis=z&i=5"
    s = _get(base + url)
    assert "guide" in s
    _assert_payload_equal(s, _get(j_base + url), guide_levels=1)
    assert "guide" not in _get(f"{base}/api/slice?pid={pid}&axis=z&i=0")
    # save writes the prior.json schema run_g consumes (--real_sp)
    saved = json.loads(open(_post(base + "/api/save", {})["path"]).read())
    assert saved == json.loads(open(_post(j_base + "/api/save",
                                          {})["path"]).read())
    assert set(saved[str(pid)]["5"][0]) == {"z", "center", "stddev"}
    for _ in range(2):
        _post(base + "/api/interaction/pop", {"pid": pid, "sid": 5})
    assert json.loads(open(_post(base + "/api/save",
                                 {})["path"]).read()) == {}
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/api/interaction", {"pid": pid})
    assert err.value.code == 400


@pytest.mark.parametrize("objs", [
    [{"center": [40.0, 50.0], "stddev": [2.965, 2.224]}],
    [{"center": [40.0, 50.0], "stddev": [2.965, 2.224]},
     {"center": [41.5, 47.25], "stddev": [5.0, 1.5]},
     {"center": [-3.0, 100.0], "stddev": [9.0, 20.0]}],
    [{"center": [12.0, 13.0], "stddev": [0.2, 0.6]}]],
    ids=["one", "three", "below_one_pixel"])
def test_render_guide_matches_jax(objs):
    """B1's function (its plain version on the CPU) against the JAX app's
    numpy render: float within 1e-6, the uint8 preview within one level."""
    shape = (96, 80)
    guide, preview = t_annotate.guide_preview(objs, shape, "cpu")
    want = j_array_kits.create_gaussian_distribution_v2(
        shape, [o["center"] for o in objs],
        [np.maximum(o["stddev"], 1.0) for o in objs])
    assert guide.dtype == np.float32 and guide.shape == shape
    np.testing.assert_allclose(guide, want, atol=1e-6, rtol=0)
    want8 = (np.clip(want, 0, 1) * 255).astype(np.uint8)
    assert preview.dtype == np.uint8
    assert np.abs(preview.astype(np.int32) - want8).max() <= 1
    assert preview.max() == 255


# ---------------------------------------------------------------------------
# live predict
# ---------------------------------------------------------------------------

_TINY = {"init_channels": 4, "num_down_samples": 2, "mod_layers": (1, 2),
         "use_spatial": True, "normalizer": "instance_norm"}


def _model_argv(*extra):
    """The JAX test's _args as CLI flags of the port (model: _TINY)."""
    return ["liver", "--mode", "eval", "--tag", "annotate", "--model", "GUNet",
            "--model_config", "tiny_annotate.yml",
            "--classes", "Liver", "Tumor", "--use_spatial", "--normalizer",
            "instance_norm", "--compute_dtype", "float32", "--im_height",
            "64", "--im_width", "64", "--batch_size", "4", "--eval_mirror",
            "--random_flip", "3", "--sweep_max_objects", "8",
            "--metrics_eval", "Dice"] + list(extra)


@pytest.fixture()
def tiny_config(monkeypatch):
    monkeypatch.setitem(t_models.MODEL_CONFIGS, "tiny_annotate.yml",
                        dict(_TINY))


def test_live_predict_matches_jax(ds, tmp_path, tiny_config):
    """The port app's Predict — its own predictor composition from the
    model arguments, weights by --ckpt_path — against the JAX app's with
    the same fitted weights injected: class maps equal, metrics within
    1e-6; with every interaction popped the maps change and still agree."""
    from boxsegliver_tpu.evaluators.eval_loader import parse_case_eval
    from boxsegliver_tpu.evaluators.volume import EvaluateVolume
    from boxsegliver_tpu.interactive.device_sweep import GuidedSweepPredictor

    metas = load_meta(ds)
    model, state = _gunet(fit_on=parse_case_eval(metas[0], ds, im_channel=3,
                                                 parse_label=True))
    flat = traverse_util.flatten_dict(
        {"params": jax.tree_util.tree_map(np.asarray, state.params)},
        sep="/")
    torch.save(flax_to_state_dict(flat), tmp_path / "w.pt")

    t_app = t_annotate.AnnotateApp(
        ds, interactions_file=tmp_path / "t.json", device="cpu",
        model_argv=_model_argv("--ckpt_path", str(tmp_path / "w.pt"),
                               "--model_dir", str(tmp_path / "md")))
    j_app = j_annotate.AnnotateApp(ds, interactions_file=tmp_path / "j.json",
                                   model_argv=["liver"])
    args = _args(tmp_path / "m")
    j_app._predictor = (EvaluateVolume(args, ds, ["Liver", "Tumor"]),
                        GuidedSweepPredictor(model, state, args,
                                             num_classes=3, tumor_id=2))
    (t_server, t_base), (j_server, j_base) = _serve(t_app), _serve(j_app)
    try:
        prior = json.loads((ds / "prior.json").read_text())
        pid = int(metas[0]["PID"])
        for sid, objs in prior[str(pid)].items():
            for o in objs:
                body = {"pid": pid, "sid": int(sid), "center": o["center"],
                        "radius": [s / ELLIPSE_TO_STD for s in o["stddev"]],
                        "z": o["z"]}
                _post(t_base + "/api/interaction", body)
                _post(j_base + "/api/interaction", body)
        got = _post(t_base + "/api/predict", {"pid": pid})
        want = _post(j_base + "/api/predict", {"pid": pid})
        assert got["guides"] == want["guides"] == sum(
            len(v) for v in prior[str(pid)].values())
        assert set(got["metrics"]) == set(want["metrics"]) >= {"Tumor/Dice"}
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-6, k
        np.testing.assert_array_equal(t_app._live[pid], j_app._live[pid])
        assert (t_app._live[pid] == 2).any()
        url = f"/api/slice?pid={pid}&axis=z&i=5"
        _assert_payload_equal(_get(t_base + url), _get(j_base + url),
                              guide_levels=1)
        st = _get(t_base + "/api/state")
        assert next(c for c in st["cases"] if c["pid"] == pid)["live"]
        guided = t_app._live[pid]
        # every interaction popped: the maps change, and still agree
        for sid, objs in prior[str(pid)].items():
            for _ in objs:
                for base in (t_base, j_base):
                    assert _post(base + "/api/interaction/pop",
                                 {"pid": pid, "sid": int(sid)})["popped"]
        assert pid not in t_app._live
        got = _post(t_base + "/api/predict", {"pid": pid})
        want = _post(j_base + "/api/predict", {"pid": pid})
        assert got["guides"] == want["guides"] == 0
        np.testing.assert_array_equal(t_app._live[pid], j_app._live[pid])
        assert (t_app._live[pid] != guided).any()
        _post(t_base + "/api/interaction", {"pid": pid, "sid": 3,
                                            "center": [30, 30],
                                            "radius": [5, 5]})
        assert pid not in t_app._live
    finally:
        t_server.shutdown()
        j_server.shutdown()


# ---------------------------------------------------------------------------
# weight selection of the live predictor (JAX annotate.py:226-257)
# ---------------------------------------------------------------------------

def _weights(argv, seed):
    model = cli._build_model(cli.get_args(argv + ["--device", "cpu"]))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _selected(ds, argv):
    app = t_annotate.AnnotateApp(ds, device="cpu", model_argv=argv)
    _, predictor = app._build_predictor()
    return predictor.args.restored_from, predictor.model.state_dict()


def _assert_weights(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture()
def model_dir(tmp_path, tiny_config):
    """md/ with a periodic checkpoint at step 4 (seed 11) and a best one
    (seed 12)."""
    argv = _model_argv("--model_dir", str(tmp_path / "md"), "--seed", "3")
    ckpt = CheckpointManager(tmp_path / "md")
    ckpt.save(4, {"model": _weights(argv, 11)})
    ckpt.save_best({"model": _weights(argv, 12)})
    return argv


def test_weights_ckpt_path_comes_first(ds, tmp_path, model_dir):
    torch.save({"model": _weights(model_dir, 13)}, tmp_path / "x.pt")
    source, got = _selected(ds, model_dir + ["--ckpt_path",
                                             str(tmp_path / "x.pt"),
                                             "--eval_final"])
    assert source == str(tmp_path / "x.pt")
    _assert_weights(got, _weights(model_dir, 13))


def test_weights_best_checkpoint(ds, model_dir):
    source, got = _selected(ds, model_dir)
    assert source.endswith("ckpt_best/best/state.pt")
    _assert_weights(got, _weights(model_dir, 12))


def test_weights_eval_final_takes_the_latest(ds, model_dir):
    source, got = _selected(ds, model_dir + ["--eval_final"])
    assert source.endswith("ckpt/4/state.pt")
    _assert_weights(got, _weights(model_dir, 11))


def test_weights_latest_without_a_best(ds, tmp_path, tiny_config):
    argv = _model_argv("--model_dir", str(tmp_path / "md2"))
    CheckpointManager(tmp_path / "md2").save(9, {"model": _weights(argv, 5)})
    source, got = _selected(ds, argv)
    assert source.endswith("ckpt/9/state.pt")
    _assert_weights(got, _weights(argv, 5))


def test_weights_seeded_init_without_a_checkpoint(ds, tmp_path, tiny_config):
    """JAX's trainer.restore at step 0: the seeded init (eval would raise
    here; the app scores the seeded init as JAX does)."""
    argv = _model_argv("--model_dir", str(tmp_path / "empty"), "--seed", "3")
    source, got = _selected(ds, argv)
    assert source == "the seeded init (--seed 3)"
    _assert_weights(got, _weights(argv, 3))


def test_weights_warm_start_without_a_checkpoint(ds, tmp_path, tiny_config):
    argv = _model_argv("--model_dir", str(tmp_path / "empty"),
                       "--warm_start_from", str(tmp_path / "warm.pt"))
    torch.save({"model": _weights(argv, 14)}, tmp_path / "warm.pt")
    source, got = _selected(ds, argv)
    assert source == f"a warm start from {tmp_path / 'warm.pt'}"
    _assert_weights(got, _weights(argv, 14))


def test_weights_load_weights_sibling(ds, tmp_path, model_dir):
    """--load_weights names a sibling experiment under model_dir's parent:
    its best checkpoint."""
    argv = _model_argv("--model_dir", str(tmp_path / "fresh"),
                       "--load_weights", "md")
    source, got = _selected(ds, argv)
    assert source.startswith("a warm start from")
    _assert_weights(got, _weights(model_dir, 12))


def test_host_loop_predictor_without_the_sweep(ds, tmp_path, tiny_config):
    """--device_sweep off composes the DeviceSlicePredictor (run_g's
    per-slice host loop), as cli/main.py evaluate() does."""
    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor

    app = t_annotate.AnnotateApp(ds, device="cpu", model_argv=_model_argv(
        "--model_dir", str(tmp_path / "md"), "--device_sweep", "off"))
    _, predictor = app._build_predictor()
    assert isinstance(predictor, DeviceSlicePredictor)
    assert predictor.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the app's device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [["--device", "cuda"], ["--device=cuda"]])
def test_contradicting_device_raises(ds, flag):
    with pytest.raises(ValueError, match="--device cuda"):
        t_annotate.AnnotateApp(ds, device="cpu", model_argv=["liver"] + flag)


def test_device_is_passed_to_the_model_arguments(ds):
    app = t_annotate.AnnotateApp(ds, device="cpu",
                                 model_argv=["liver", "--device", "cpu"])
    assert app.model_argv[-2:] == ["--device", "cpu"]
    assert t_annotate.model_argv_on(["liver"], "cuda") == ["liver",
                                                           "--device", "cuda"]


def test_app_defaults_to_the_card(ds, monkeypatch):
    """No device means the card: without one the app raises, it does not
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_annotate.AnnotateApp(ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_annotate.main([str(ds), "--port", "0"])
