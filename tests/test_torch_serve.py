"""The port's HTTP serving runtime over its torch.export bundle
(boxsegliver_torch/cli/serve.py): the eleven tests of tests/test_serve.py
on port bundles of UNet_TINY and GUNet_TINY at 32^2, batch 2, exported and
served on the CPU (``--device cpu``)."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

import torch

from boxsegliver_torch.cli.export import export_model
from boxsegliver_torch.cli.main import get_args
from boxsegliver_torch.cli.serve import ModelRunner, make_server

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    out = tmp_path_factory.mktemp("export")
    args = get_args([
        "liver", "--mode", "export", "--tag", "tserve", "--model", "UNet",
        "--model_config", "UNet_TINY.yml", "--classes", "Liver", "Tumor",
        "--batch_size", "2", "--im_height", "32", "--im_width", "32",
        "--im_channel", "3", "--model_dir", str(out / "m"),
        "--device", "cpu"])
    return export_model(args, out_dir=out / "bundle")


@pytest.fixture(scope="module")
def server(bundle):
    srv = make_server(bundle, host="127.0.0.1", port=0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def test_status_and_metadata(server):
    status, body = _get(server + "/v1/models/UNet")
    assert status == 200
    assert body["model_version_status"][0]["state"] == "AVAILABLE"
    status, meta = _get(server + "/v1/models/UNet/metadata")
    assert status == 200
    assert meta["signature"]["classes"] == ["Background", "Liver", "Tumor"]
    assert "images" in meta["signature"]["inputs"]


def test_predict_json_columnar(server):
    rng = np.random.RandomState(0)
    images = rng.rand(2, 32, 32, 3).astype(np.float32)
    body = json.dumps({"inputs": {"images": images.tolist()}}).encode()
    status, raw, _ = _post(server + "/v1/models/UNet:predict", body)
    assert status == 200, raw
    preds = np.asarray(json.loads(raw)["predictions"], np.float32)
    assert preds.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(preds.sum(-1), 1.0, atol=1e-4)


def test_predict_json_instances_rows(server):
    rng = np.random.RandomState(1)
    rows = [{"images": rng.rand(32, 32, 3).tolist()} for _ in range(2)]
    body = json.dumps({"instances": rows}).encode()
    status, raw, _ = _post(server + "/v1/models/UNet:predict", body)
    assert status == 200, raw
    preds = np.asarray(json.loads(raw)["predictions"], np.float32)
    assert preds.shape == (2, 32, 32, 3)


def test_predict_npz_binary_and_batch_chunking(server, bundle):
    # 5 samples through an exported batch of 2: pad + chunk must be invisible
    rng = np.random.RandomState(2)
    images = rng.rand(5, 32, 32, 3).astype(np.float32)
    buf = io.BytesIO()
    np.savez(buf, images=images)
    status, raw, ctype = _post(server + "/v1/models/UNet:predict",
                               buf.getvalue(), "application/x-npz")
    assert status == 200
    assert "x-npz" in ctype
    with np.load(io.BytesIO(raw)) as z:
        preds = z["predictions"]
    assert preds.shape == (5, 32, 32, 3)
    np.testing.assert_allclose(preds.sum(-1), 1.0, atol=1e-4)
    # chunked result == direct runner result sample-for-sample
    direct = ModelRunner(bundle, "cpu").predict({"images": images[:2]})
    np.testing.assert_allclose(preds[:2], direct, atol=1e-6)


def test_predict_bad_input_400(server):
    body = json.dumps({"inputs": {"images": [[0.0]]}}).encode()
    status, raw, _ = _post(server + "/v1/models/UNet:predict", body)
    assert status == 400
    assert "incompatible" in json.loads(raw)["error"]

    body = json.dumps({"bogus": 1}).encode()
    status, raw, _ = _post(server + "/v1/models/UNet:predict", body)
    assert status == 400

    status, raw, _ = _post(server + "/v1/models/Wrong:predict", b"{}")
    assert status == 404


def test_concurrent_requests(server):
    rng = np.random.RandomState(3)
    images = rng.rand(2, 32, 32, 3).astype(np.float32)
    body = json.dumps({"inputs": {"images": images.tolist()}}).encode()
    results = []

    def hit():
        results.append(_post(server + "/v1/models/UNet:predict", body)[0])

    threads = [threading.Thread(target=hit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [200, 200, 200, 200]


def test_serve_guided_model_multi_input(tmp_path):
    """A GUNet bundle (images + sp_guide + context) serves through the same
    REST surface — dict inputs with all three arrays."""
    args = get_args([
        "liver", "--mode", "export", "--tag", "tgserve", "--model", "GUNet",
        "--model_config", "GUNet_TINY.yml", "--classes", "Liver", "Tumor",
        "--batch_size", "2", "--im_height", "32", "--im_width", "32",
        "--im_channel", "3", "--normalizer", "instance_norm",
        "--use_context", "--context_list", "hist", "20",
        "--use_spatial", "--model_dir", str(tmp_path / "m"),
        "--device", "cpu"])
    bundle = export_model(args, out_dir=tmp_path / "bundle")

    srv = make_server(bundle, host="127.0.0.1", port=0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        rng = np.random.RandomState(0)
        buf = io.BytesIO()
        np.savez(buf,
                 images=rng.rand(3, 32, 32, 3).astype(np.float32),
                 sp_guide=np.full((3, 32, 32, 1), 0.5, np.float32),
                 context=rng.rand(3, 20).astype(np.float32))
        status, raw, ctype = _post(url + "/v1/models/GUNet:predict",
                                   buf.getvalue(), "application/x-npz")
        assert status == 200, raw
        with np.load(io.BytesIO(raw)) as z:
            preds = z["predictions"]
        assert preds.shape == (3, 32, 32, 3)
        np.testing.assert_allclose(preds.sum(-1), 1.0, atol=1e-4)

        # missing input -> 400 naming the expected inputs
        buf2 = io.BytesIO()
        np.savez(buf2, images=rng.rand(2, 32, 32, 3).astype(np.float32))
        status, raw, _ = _post(url + "/v1/models/GUNet:predict",
                               buf2.getvalue(), "application/x-npz")
        assert status == 400
        assert "missing input" in json.loads(raw)["error"]
    finally:
        srv.shutdown()


def test_keepalive_connection_survives_404_with_body(server):
    """A POST body to a wrong path must be drained, not left to desync the
    next request on a reused HTTP/1.1 connection."""
    import http.client
    host = server.split("//")[1]
    conn = http.client.HTTPConnection(host, timeout=30)
    try:
        body = json.dumps({"inputs": {"images": [[0.0]]}}).encode()
        conn.request("POST", "/v1/models/Wrong:predict", body=body,
                     headers={"Content-Type": "application/json"})
        r1 = conn.getresponse()
        assert r1.status == 404
        r1.read()
        # second request on the SAME connection must parse cleanly
        conn.request("GET", "/healthz")
        r2 = conn.getresponse()
        assert r2.status == 200
        assert r2.read() == b"ok"
    finally:
        conn.close()


def test_oversized_body_413(bundle):
    """Bodies above the configurable cap are refused with 413 without being
    read into memory (the Content-Length is rejected up front)."""
    srv = make_server(bundle, host="127.0.0.1", port=0, max_body_mb=0.001,
                      device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        body = b"x" * 4096  # 4 KiB > 1 KiB cap
        status, raw, _ = _post(url + "/v1/models/UNet:predict", body)
        assert status == 413
        assert "cap" in json.loads(raw)["error"]
        # a within-cap request still works on a fresh connection
        status, body = _get(url + "/v1/models/UNet")
        assert status == 200
        assert body["model_version_status"][0]["state"] == "AVAILABLE"
    finally:
        srv.shutdown()


def test_default_bind_is_localhost():
    """The unauthenticated endpoint must not bind 0.0.0.0 unless asked."""
    import inspect
    assert inspect.signature(make_server).parameters["host"].default \
        == "127.0.0.1"


def test_empty_batch_400(server):
    buf = io.BytesIO()
    np.savez(buf, images=np.zeros((0, 32, 32, 3), np.float32))
    status, raw, _ = _post(server + "/v1/models/UNet:predict",
                           buf.getvalue(), "application/x-npz")
    assert status == 400
    assert "empty batch" in json.loads(raw)["error"]
