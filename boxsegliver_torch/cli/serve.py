"""Serving runtime of the port: an HTTP model server over the torch.export
bundle (port of boxsegliver_tpu/cli/serve.py; reference README.md:122-139,
the TF-Serving docker deployment over the SavedModel of
entry/main_export.py).  It serves the bundle written by ``--mode export``
(cli/export.py: model.pt2 + state.pt + signature.json) with the TF-Serving
REST surface, so clients written against the reference's deployment port
over unchanged:

    python -m boxsegliver_torch.cli.serve /path/to/export --port 8501 \
        [--device cpu]

    GET  /v1/models/<name>            -> model status
    GET  /v1/models/<name>/metadata   -> serving signature
    GET  /healthz                     -> ok
    POST /v1/models/<name>:predict    -> predictions
         JSON  {"inputs": {"images": [...], ...}}  (row-major nested lists)
         or {"instances": [...]}, or Content-Type: application/x-npz with
         an .npz body of the feature arrays (the efficient path for
         volumes; the response is an .npz of {"predictions": ...})

The program runs on ``--device``: the card by default (it raises where
there is none), the CPU only when asked for.  Requests whose batch exceeds
the exported batch size are chunked; smaller batches are padded with their
last row and the padding stripped from the response — the exported program
has static shapes, and the server makes that invisible to clients.  Model
calls are serialized with a lock: one program, one device.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class ModelRunner:
    """Wraps the exported callable with batch padding/chunking."""

    def __init__(self, export_dir, device="cuda"):
        from boxsegliver_torch.cli.export import load_exported
        self.serve, self.signature = load_exported(export_dir, device)
        self.inputs = {k: (tuple(shape), dtype)
                       for k, (shape, dtype) in self.signature["inputs"].items()}
        self.batch = next(iter(self.inputs.values()))[0][0]
        self.name = self.signature.get("model", "model")
        self._lock = threading.Lock()

    def validate(self, features):
        feats = {}
        batch = None
        for key, (shape, dtype) in self.inputs.items():
            if key not in features:
                raise ValueError(f"missing input {key!r}; expected "
                                 f"{sorted(self.inputs)}")
            arr = np.asarray(features[key], dtype=dtype)
            if arr.shape[1:] != shape[1:]:
                raise ValueError(
                    f"input {key!r} shape {arr.shape} incompatible with "
                    f"exported {shape} (all dims but batch must match)")
            if batch is None:
                batch = arr.shape[0]
            elif arr.shape[0] != batch:
                raise ValueError("inconsistent batch across inputs")
            feats[key] = arr
        if batch == 0:
            raise ValueError("empty batch (0 instances)")
        extra = set(features) - set(self.inputs)
        if extra:
            raise ValueError(f"unknown inputs {sorted(extra)}; expected "
                             f"{sorted(self.inputs)}")
        return feats, batch

    def predict(self, features) -> np.ndarray:
        feats, batch = self.validate(features)
        outs = []
        for start in range(0, batch, self.batch):
            chunk = {k: v[start:start + self.batch] for k, v in feats.items()}
            n = next(iter(chunk.values())).shape[0]
            if n < self.batch:  # pad to the exported static batch
                chunk = {k: np.concatenate(
                    [v, np.repeat(v[-1:], self.batch - n, axis=0)])
                    for k, v in chunk.items()}
            with self._lock:
                probs = self.serve(chunk).cpu().numpy()
            outs.append(probs[:n])
        return np.concatenate(outs)


class _Handler(BaseHTTPRequestHandler):
    runner: ModelRunner = None  # set by serve_forever
    max_body_bytes: int = 256 * 1024 * 1024  # reject larger with 413
    protocol_version = "HTTP/1.1"

    # -- helpers -----------------------------------------------------------
    def _send(self, code, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code, obj):
        self._send(code, json.dumps(obj).encode())

    def _error(self, code, message):
        self._json(code, {"error": message})

    def _model_path(self, suffix=""):
        return f"/v1/models/{self.runner.name}{suffix}"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        import logging
        logging.getLogger("boxsegliver.serve").info(fmt, *args)

    # -- routes ------------------------------------------------------------
    def do_GET(self):
        if self.path == self._model_path():
            self._json(200, {"model_version_status": [
                {"version": "1", "state": "AVAILABLE",
                 "status": {"error_code": "OK", "error_message": ""}}]})
        elif self.path == self._model_path("/metadata"):
            self._json(200, {"model_spec": {"name": self.runner.name,
                                            "signature_version": "1"},
                             "signature": self.runner.signature})
        elif self.path == "/healthz":
            self._send(200, b"ok", "text/plain")
        else:
            self._error(404, f"unknown path {self.path}")

    def do_POST(self):
        # drain the body BEFORE any routing: under HTTP/1.1 keep-alive an
        # unread body would be parsed as the next request line, desyncing
        # the connection
        length = int(self.headers.get("Content-Length", 0))
        if length > self.max_body_bytes:
            # can't safely drain an oversized body — refuse and drop the
            # connection instead of reading it into memory
            self.close_connection = True
            return self._error(413, f"body of {length} bytes exceeds the "
                                    f"{self.max_body_bytes}-byte cap "
                                    "(--max_body_mb)")
        body = self.rfile.read(length)
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            self.close_connection = True
            return self._error(411, "chunked bodies unsupported; send "
                                    "Content-Length")
        if self.path != self._model_path(":predict"):
            return self._error(404, f"unknown path {self.path}")
        ctype = self.headers.get("Content-Type", "application/json")
        try:
            if "x-npz" in ctype or "octet-stream" in ctype:
                with np.load(io.BytesIO(body)) as z:
                    features = {k: z[k] for k in z.files}
                preds = self.runner.predict(features)
                buf = io.BytesIO()
                np.savez(buf, predictions=preds)
                self._send(200, buf.getvalue(), "application/x-npz")
            else:
                req = json.loads(body)
                if "inputs" in req:       # TF-Serving columnar format
                    features = req["inputs"]
                    if not isinstance(features, dict):
                        features = {"images": features}
                elif "instances" in req:  # TF-Serving row format
                    rows = req["instances"]
                    if rows and isinstance(rows[0], dict):
                        features = {k: np.stack([np.asarray(r[k])
                                                 for r in rows])
                                    for k in rows[0]}
                    else:
                        features = {"images": np.asarray(rows)}
                else:
                    raise ValueError('body must contain "inputs" or '
                                     '"instances"')
                preds = self.runner.predict(features)
                self._json(200, {"predictions": preds.tolist()})
        except ValueError as exc:
            self._error(400, str(exc))
        except Exception as exc:  # noqa: BLE001 — surface as a 500, keep serving
            self._error(500, f"{type(exc).__name__}: {exc}")


def make_server(export_dir, host="127.0.0.1", port=8501,
                max_body_mb=256, device="cuda") -> ThreadingHTTPServer:
    runner = ModelRunner(export_dir, device)
    handler = type("Handler", (_Handler,),
                   {"runner": runner,
                    "max_body_bytes": int(max_body_mb * 1024 * 1024)})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve a boxsegliver_torch export bundle over HTTP "
                    "(TF-Serving-compatible REST surface)")
    parser.add_argument("export_dir", help="directory written by --mode export")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address; the endpoint is unauthenticated, "
                             "so pass 0.0.0.0 explicitly to expose it beyond "
                             "localhost")
    parser.add_argument("--port", type=int, default=8501)
    parser.add_argument("--max_body_mb", type=float, default=256,
                        help="reject request bodies above this size with 413")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the program runs; cuda needs a GPU")
    args = parser.parse_args(argv)

    import logging
    logging.basicConfig(level=logging.INFO)
    server = make_server(args.export_dir, args.host, args.port,
                         max_body_mb=args.max_body_mb, device=args.device)
    name = server.RequestHandlerClass.runner.name
    logging.getLogger("boxsegliver.serve").info(
        "Serving %s on %s at http://%s:%d/v1/models/%s:predict",
        args.export_dir, args.device, args.host, args.port, name)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
