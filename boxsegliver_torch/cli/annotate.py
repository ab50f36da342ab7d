"""Interactive annotation + model-in-the-loop review app (browser-based;
port of boxsegliver_tpu/cli/annotate.py).

Re-design of the reference's Qt/traitsui annotation towers (reference
interaction/liver_fw.py + liver_view.py, nf_fw.py + nf_view.py: scroll
3-plane volumes, overlay masks, draw ellipse interactions, undo, save;
reference interaction/model_viewer*/: page through and A/B-compare model
prediction dirs).  Those apps need a desktop display server and PyQt; this
one is a single self-contained HTTP app (stdlib http.server, same runtime
shape as cli/serve.py) driving the SAME eval machinery the CLI uses, so
"Predict" runs the real guided double sweep on the GPU:

    python -m boxsegliver_torch.cli.annotate data/LiTS \
        [--interactions inter.json] [--pred_dir DIR] [--cmp_dir DIR] \
        [--port 8601] [--device cpu] -- liver --model_dir model_dir/002 \
        --use_spatial ...

The app runs on ``--device``: the card by default (it raises where there is
none), the CPU only when asked for; the device is passed on to the model
arguments after ``--``, and a ``--device`` there that says otherwise raises
ValueError.

Capabilities mapped from the reference apps:
- case list + slice counts (nf_view.py get_file_list), 3-plane browsing with
  spacing-corrected aspect (nf_fw.py keys 1/2/3 + viewer.py resized_image);
- label overlay with alpha / contour / class merge (liver_view.py update_lab);
- ellipse interactions drawn on axial slices; the half-axes convert to guide
  stddevs with the reference's 0.37065 factor (nf_view.py:225-231
  update_interaction); undo pops the last one (pop_interaction);
- the axial slice previews the Gaussian guide of its interactions, rendered
  by kernel B1 (ops/kernels.gaussian_guide_batch) on the app's device;
- interactions persist as the prior.json schema {pid: {sid: [{z, center,
  stddev}]}} (liver_view.py:242-252 save_interaction == the --real_sp format
  consumed by run_g guided eval, input_pipeline_g.py:1217-1224);
- "Predict" (when model args are given after `--`) runs the guided
  propagation sweep with the CURRENT user interactions as the prior
  (EvaluateVolume.predict_case_g → interactive/device_sweep.py) and
  overlays the fresh prediction + per-case metrics — the model_viewer's
  model-in-the-loop role, but live instead of from exported npy dirs;
- --pred_dir / --cmp_dir overlay precomputed prediction volumes for A/B
  comparison (model_viewer_nf/main.py loadModelButton/loadCmpModelButton).
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# ellipse half-axis -> Gaussian stddev (reference nf_view.py:225-231: the
# drawn ellipse covers the lesion at ~2.7 sigma)
ELLIPSE_TO_STD = 0.37065


def model_argv_on(model_argv, device: str):
    """The model arguments with ``--device device`` appended; ValueError if
    they name another device."""
    argv = list(model_argv)
    for i, arg in enumerate(argv):
        if arg == "--device" and i + 1 < len(argv):
            given = argv[i + 1]
        elif arg.startswith("--device="):
            given = arg.split("=", 1)[1]
        else:
            continue
        if given != device:
            raise ValueError(f"the model arguments ask for --device {given} "
                             f"but the app runs on {device}")
    return argv + ["--device", device]


def guide_preview(objs, shape, device):
    """The Gaussian guide of one slice's interactions, rendered by kernel
    B1 on ``device`` → (float32 [h, w], uint8 [h, w] = clip(·, 0, 1)·255),
    both on the host; stddevs are floored at 1 pixel (the JAX app's
    array_kits.create_gaussian_distribution_v2 preview)."""
    import torch

    from boxsegliver_torch.ops import kernels

    centers = torch.tensor([[o["center"] for o in objs]], dtype=torch.float32)
    stddevs = torch.tensor(np.array([[np.maximum(o["stddev"], 1.0)
                                      for o in objs]], np.float32))
    valid = torch.ones(centers.shape[:2], dtype=torch.bool)
    guide = kernels.gaussian_guide_batch(
        centers.to(device), stddevs.to(device), valid.to(device),
        height=int(shape[0]), width=int(shape[1]))[0, ..., 0].cpu().numpy()
    return guide, (np.clip(guide, 0.0, 1.0) * 255).astype(np.uint8)


class AnnotateApp:
    """Server-side state: dataset, interactions, optional live predictor."""

    def __init__(self, dataset_dir, interactions_file=None, pred_dir=None,
                 cmp_dir=None, nf: bool = False, model_argv=None,
                 max_size: int = 512, device: str = "cuda"):
        from boxsegliver_torch import config as config_mod
        from boxsegliver_torch.data.meta import load_meta
        from boxsegliver_torch.data.sampler import CaseVolumes

        self.device = config_mod.resolve_device(device)
        if model_argv is not None:
            model_argv = model_argv_on(model_argv, self.device.type)
        self.dataset_dir = Path(dataset_dir)
        self.metas = {int(m["PID"]): m for m in load_meta(self.dataset_dir)}
        self.vols = CaseVolumes(self.dataset_dir)
        self.nf = nf
        self.max_size = max_size
        self.interactions_file = Path(
            interactions_file or self.dataset_dir / "user_interactions.json")
        self.interactions: Dict[str, Dict] = {}
        if self.interactions_file.exists():
            self.interactions = json.loads(self.interactions_file.read_text())
        self.pred_dir = Path(pred_dir) if pred_dir else None
        self.cmp_dir = Path(cmp_dir) if cmp_dir else None
        self.model_argv = model_argv
        self._preds: Dict[str, Dict[int, np.ndarray]] = {"pred": {}, "cmp": {}}
        self._live: Dict[int, np.ndarray] = {}
        self._live_metrics: Dict[int, Dict[str, float]] = {}
        self._predictor = None     # (evaluator, predict_fn), lazy
        self._lock = threading.Lock()

    # -- case/slice access ---------------------------------------------------

    def state(self) -> Dict:
        cases = []
        for pid in sorted(self.metas):
            m = self.metas[pid]
            n_guides = sum(len(v) for v in
                           self.interactions.get(str(pid), {}).values())
            cases.append({"pid": pid, "size": list(m["size"]),
                          "spacing": [float(s) for s in m["spacing"]],
                          "guides": n_guides,
                          "live": pid in self._live,
                          "metrics": self._live_metrics.get(pid, {})})
        return {"cases": cases, "interactions": self.interactions,
                "has_model": self.model_argv is not None,
                "has_pred": self.pred_dir is not None,
                "has_cmp": self.cmp_dir is not None,
                "ellipse_to_std": ELLIPSE_TO_STD}

    def _stored_pred(self, kind: str, pid: int) -> Optional[np.ndarray]:
        root = self.pred_dir if kind == "pred" else self.cmp_dir
        if root is None:
            return None
        cache = self._preds[kind]
        if pid not in cache:
            from boxsegliver_torch.cli.viewer import load_pred
            for cand in (root / f"predict-{pid}.nii.gz", root / f"{pid}.npz"):
                if cand.exists():
                    cache[pid] = load_pred(cand)
                    break
            else:
                cache[pid] = None
        return cache[pid]

    def slice_payload(self, pid: int, axis: str, i: int) -> Dict:
        from boxsegliver_torch.cli.viewer import (_display_window, _png_b64,
                                                  plane)

        if pid not in self.metas:
            raise KeyError(f"unknown case {pid}")
        meta = self.metas[pid]
        ax = {"z": 0, "y": 1, "x": 2}[axis]
        spacing = meta["spacing"]
        volume = self.vols.volume(pid)
        img = plane(volume, ax, i, spacing, order=1)
        img = _display_window(img[None], self.nf)[0].astype(np.uint8)
        out = {"pid": pid, "axis": axis, "i": int(i),
               "n": int(volume.shape[ax]),
               "h": int(img.shape[0]), "w": int(img.shape[1]),
               "img": _png_b64(img)}
        try:
            gt = plane(self.vols.label(pid), ax, i, spacing, order=0)
            out["gt"] = _png_b64(gt.astype(np.uint8))
        except FileNotFoundError:
            pass
        for kind in ("pred", "cmp"):
            vol = self._stored_pred(kind, pid)
            if vol is not None:
                out[kind] = _png_b64(
                    plane(vol, ax, i, spacing, order=0).astype(np.uint8))
        if pid in self._live:
            out["live"] = _png_b64(
                plane(self._live[pid], ax, i, spacing,
                            order=0).astype(np.uint8))
        if axis == "z":
            guide = self.render_guide(pid, i, (img.shape[0], img.shape[1]))
            if guide is not None:
                out["guide"] = _png_b64(guide)
        return out

    def render_guide(self, pid: int, sid: int, shape) -> Optional[np.ndarray]:
        """The Gaussian spatial guide the model would see for this slice's
        interactions (reference interaction/demo_guide_enhance.py preview),
        drawn by kernel B1 (guide_preview); None without interactions."""
        objs = self.interactions.get(str(pid), {}).get(str(sid), [])
        if not objs:
            return None
        return guide_preview(objs, shape, self.device)[1]

    # -- interactions (reference *_view.py adapter surface) ------------------

    def add_interaction(self, pid: int, sid: int, center, radius,
                        z=None) -> Dict:
        """center [y, x] and radius (ellipse half-axes [ry, rx]) in original
        pixel coords; stored as the prior.json guide schema."""
        stddev = [round(float(r) * ELLIPSE_TO_STD, 3) for r in radius]
        rec = {"z": [int(z[0]), int(z[1])] if z else [int(sid), int(sid) + 1],
               "center": [round(float(c), 3) for c in center],
               "stddev": stddev}
        with self._lock:
            case = self.interactions.setdefault(str(pid), {})
            case.setdefault(str(sid), []).append(rec)
            self._live.pop(pid, None)  # the live pred is stale now
            self._live_metrics.pop(pid, None)
        return rec

    def pop_interaction(self, pid: int, sid: int) -> bool:
        with self._lock:
            objs = self.interactions.get(str(pid), {}).get(str(sid))
            if not objs:
                return False
            objs.pop()
            if not objs:
                del self.interactions[str(pid)][str(sid)]
            self._live.pop(pid, None)
            self._live_metrics.pop(pid, None)
        return True

    def save_interactions(self) -> str:
        """Drop empty levels like the reference save_interaction
        (liver_view.py:242-252), then write the prior.json-schema file."""
        with self._lock:
            res = {pid: {sid: objs for sid, objs in case.items() if objs}
                   for pid, case in self.interactions.items() if case}
            res = {pid: case for pid, case in res.items() if case}
            self.interactions_file.parent.mkdir(parents=True, exist_ok=True)
            self.interactions_file.write_text(json.dumps(res))
        return str(self.interactions_file)

    # -- live model-in-the-loop prediction ------------------------------------

    def _build_predictor(self):
        """The model of the arguments after ``--`` on the app's device, its
        weights chosen as the JAX app chooses them (annotate.py:226-257):
        --ckpt_path, else the latest checkpoint under --eval_final or when
        there is no best, else the best; with no checkpoint the seeded init,
        warm started from --warm_start_from / --load_weights.  The sweep is
        cli/main.py evaluate()'s: the GuidedSweepPredictor for
        --use_spatial with --device_sweep on, else a DeviceSlicePredictor
        (run_g's per-slice host loop)."""
        from boxsegliver_torch.cli.main import (_build_model, checkpoint_path,
                                                get_args, initial_weights)
        from boxsegliver_torch.evaluators.device_eval import \
            DeviceSlicePredictor
        from boxsegliver_torch.evaluators.volume import EvaluateVolume
        from boxsegliver_torch.train.checkpoint import model_state

        args = get_args(self.model_argv)
        model = _build_model(args)
        path = checkpoint_path(args, getattr(args, "eval_final", False))
        if path is None:
            args.restored_from = initial_weights(args, model)
        else:
            model.load_state_dict(model_state(path), strict=True)
            args.restored_from = str(path)
        model = model.to(self.device).eval()
        evaluator = EvaluateVolume(args, self.dataset_dir,
                                   ["Background"] + list(args.classes))
        if getattr(args, "use_spatial", False) and \
                getattr(args, "device_sweep", "on") == "on":
            from boxsegliver_torch.interactive.device_sweep import \
                GuidedSweepPredictor
            fg = [c for c in args.classes if c != "Background"]
            tumor_id = (fg.index("Tumor") + 1 if "Tumor" in fg else len(fg))
            return evaluator, GuidedSweepPredictor(
                model, args, num_classes=len(fg) + 1, tumor_id=tumor_id,
                device=self.device)
        return evaluator, DeviceSlicePredictor(model, args,
                                               device=self.device)

    def predict_case(self, pid: int) -> Dict:
        if self.model_argv is None:
            raise ValueError("no model: restart with model args after '--'")
        if pid not in self.metas:
            raise KeyError(f"unknown case {pid}")
        with self._lock:
            if self._predictor is None:
                self._predictor = self._build_predictor()
            evaluator, predict = self._predictor
            prior_case = self.interactions.get(str(pid), {})
            has_gt = (self.dataset_dir / f"volume-{pid}" /
                      "segmentation.npy").exists()
            case, probs = evaluator.predict_case_g(
                predict, self.metas[pid], prior_case, parse_label=has_gt)
            self._live[pid] = evaluator.full_class_map(case, probs)
            metrics = {}
            if has_gt:
                metrics = {k: round(float(v), 4) for k, v in
                           evaluator.evaluate_case(case, probs).items()}
            self._live_metrics[pid] = metrics
        return {"pid": pid, "metrics": metrics,
                "guides": sum(len(v) for v in prior_case.values())}


class _Handler(BaseHTTPRequestHandler):
    app: AnnotateApp = None  # set by make_server
    max_body_bytes = 4 * 1024 * 1024
    protocol_version = "HTTP/1.1"

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

    def log_message(self, fmt, *args):
        import logging
        logging.getLogger("boxsegliver.annotate").info(fmt, *args)

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse
        url = urlparse(self.path)
        try:
            if url.path == "/":
                self._send(200, _HTML.encode(), "text/html; charset=utf-8")
            elif url.path == "/api/state":
                self._json(200, self.app.state())
            elif url.path == "/api/slice":
                q = parse_qs(url.query)
                payload = self.app.slice_payload(
                    int(q["pid"][0]), q.get("axis", ["z"])[0],
                    int(q.get("i", ["0"])[0]))
                self._json(200, payload)
            elif url.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            else:
                self._error(404, f"unknown path {url.path}")
        except KeyError as exc:
            self._error(404, str(exc))
        except (ValueError, IndexError) as exc:
            self._error(400, str(exc))

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        if length > self.max_body_bytes:
            self.close_connection = True
            return self._error(413, "body too large")
        body = self.rfile.read(length)
        try:
            req = json.loads(body) if body else {}
            if self.path == "/api/interaction":
                rec = self.app.add_interaction(
                    int(req["pid"]), int(req["sid"]),
                    req["center"], req["radius"], req.get("z"))
                self._json(200, {"added": rec})
            elif self.path == "/api/interaction/pop":
                ok = self.app.pop_interaction(int(req["pid"]),
                                              int(req["sid"]))
                self._json(200, {"popped": ok})
            elif self.path == "/api/save":
                self._json(200, {"path": self.app.save_interactions()})
            elif self.path == "/api/predict":
                self._json(200, self.app.predict_case(int(req["pid"])))
            else:
                self._error(404, f"unknown path {self.path}")
        except KeyError as exc:
            self._error(400, f"missing/unknown field {exc}")
        except ValueError as exc:
            self._error(400, str(exc))
        except Exception as exc:  # noqa: BLE001 — surface as 500, keep serving
            self._error(500, f"{type(exc).__name__}: {exc}")


_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>boxsegliver annotate</title><style>
body{font-family:sans-serif;margin:0;display:flex;height:100vh}
#side{width:300px;overflow:auto;border-right:1px solid #ccc;padding:8px}
#main{flex:1;padding:8px;overflow:auto}
table{border-collapse:collapse;width:100%;font-size:13px}
td,th{border:1px solid #ddd;padding:3px 6px;text-align:left;cursor:pointer}
tr.sel{background:#def}
canvas{border:1px solid #999;image-rendering:pixelated;margin-right:8px;cursor:crosshair}
.row{margin:6px 0}
label{margin-right:10px;font-size:13px}
button{margin-right:6px}
#msg{font-size:12px;color:#06c;min-height:16px}
h4{margin:4px 0}
</style></head><body>
<div id="side"><h4>Cases</h4><table id="cases"><thead><tr>
<th>case</th><th>slices</th><th>guides</th><th>dice</th></tr></thead>
<tbody></tbody></table>
<div class="row" style="font-size:12px">
Draw: drag an ellipse over a lesion on an axial slice.<br>
Keys: &larr;/&rarr; or wheel = slice, u = undo.<br>
Guides save as the run_g prior/--real_sp JSON.</div></div>
<div id="main">
<div class="row">
<label>axis <select id="axis"><option>z</option><option>y</option><option>x</option></select></label>
<label>slice <input type="range" id="slice" min="0" max="0" value="0" style="width:280px">
<span id="sliceno">0</span></label>
<label>z-span <input type="number" id="zspan" min="1" value="1" style="width:44px"></label>
</div>
<div class="row">
<label><input type="checkbox" id="contour" checked> contour</label>
<label>alpha <input type="range" id="alpha" min="0" max="100" value="35" style="width:100px"></label>
<label>overlay
<span id="layers"></span></label>
<label>right <select id="rightsel"></select></label>
</div>
<div class="row">
<button id="undo">Undo (u)</button>
<button id="save">Save interactions</button>
<button id="predict" style="display:none">Predict (GPU)</button>
<span id="msg"></span>
</div>
<div><canvas id="cmain"></canvas><canvas id="cright"></canvas></div>
</div>
<script>
let ST=null, cur=null, curAxis="z", slices={}, drag=null;
const SCALE=2;
const LAYERCOL={gt:[50,150,255], pred:[255,80,50], cmp:[230,190,40], live:[60,220,90], guide:[240,60,240]};
const $=id=>document.getElementById(id);
function msg(t){ $("msg").textContent=t; }
async function getState(){ ST=await (await fetch("/api/state")).json();
  renderCases();
  if(ST.has_model) $("predict").style.display="";
  const ls=$("layers"); ls.innerHTML="";
  ["gt","pred","cmp","live","guide"].forEach(k=>{
    if(k==="pred"&&!ST.has_pred) return;
    if(k==="cmp"&&!ST.has_cmp) return;
    if(k==="live"&&!ST.has_model) return;
    const l=document.createElement("label");
    l.innerHTML='<input type="checkbox" data-k="'+k+'" '+(k==="gt"?"checked":"")+
      '><span style="color:rgb('+LAYERCOL[k].join(",")+')">'+k+'</span>';
    l.querySelector("input").addEventListener("input",draw);
    ls.appendChild(l);
  });
  const rs=$("rightsel"); rs.innerHTML="";
  ["img","gt","pred","cmp","live"].forEach(k=>{
    if(k==="pred"&&!ST.has_pred) return;
    if(k==="cmp"&&!ST.has_cmp) return;
    if(k==="live"&&!ST.has_model) return;
    const o=document.createElement("option"); o.value=o.textContent=k;
    rs.appendChild(o);
  });
  rs.value = ST.has_model ? "live" : (ST.has_pred ? "pred" : "gt");
}
function renderCases(){
  const tb=document.querySelector("#cases tbody"); tb.innerHTML="";
  ST.cases.forEach(c=>{
    const tr=document.createElement("tr"); tr.dataset.pid=c.pid;
    if(c.pid===cur) tr.classList.add("sel");
    const dice=Object.entries(c.metrics).filter(([k])=>k.endsWith("/Dice"))
      .map(([k,v])=>v.toFixed(3)).join(" ");
    tr.innerHTML="<td>"+c.pid+"</td><td>"+c.size[0]+"</td><td>"+c.guides+
      "</td><td>"+dice+"</td>";
    tr.onclick=()=>selectCase(c.pid);
    tb.appendChild(tr);
  });
}
async function fetchSlice(){
  const i=+$("slice").value;
  const r=await fetch("/api/slice?pid="+cur+"&axis="+curAxis+"&i="+i);
  slices=await r.json();
  $("sliceno").textContent=i;
  draw();
}
function loadImg(b64){ return new Promise(res=>{const im=new Image();
  im.onload=()=>res(im); im.src=b64;}); }
async function draw(){
  if(!slices.img) return;
  const base=await loadImg(slices.img);
  const W=base.width,H=base.height;
  const t=document.createElement("canvas"); t.width=W; t.height=H;
  const tc=t.getContext("2d"); tc.drawImage(base,0,0);
  const id=tc.getImageData(0,0,W,H);
  const alpha=+$("alpha").value/100, contour=$("contour").checked;
  for(const box of document.querySelectorAll("#layers input")){
    const k=box.dataset.k;
    if(!box.checked||!slices[k]) continue;
    const mi=await loadImg(slices[k]);
    const mt=document.createElement("canvas"); mt.width=W; mt.height=H;
    const mc=mt.getContext("2d"); mc.drawImage(mi,0,0);
    const md=mc.getImageData(0,0,W,H).data;
    const c=LAYERCOL[k];
    if(k==="guide"){ // continuous Gaussian heat: intensity IS the alpha
      for(let p=0;p<W*H;p++){
        const a=md[4*p]/255*0.7; if(a<0.02) continue;
        for(let q=0;q<3;q++) id.data[4*p+q]=(1-a)*id.data[4*p+q]+a*c[q];
      }
      continue;
    }
    const lab=new Uint8Array(W*H);
    for(let p=0;p<W*H;p++) lab[p]=md[4*p]>0?1:0;
    for(let y=0;y<H;y++)for(let x=0;x<W;x++){
      const p=y*W+x; if(!lab[p]) continue;
      if(contour){
        const edge=(x===0||!lab[p-1])||(x===W-1||!lab[p+1])||
                   (y===0||!lab[p-W])||(y===H-1||!lab[p+W]);
        if(!edge) continue;
      }
      const a=contour?1.0:alpha;
      for(let q=0;q<3;q++) id.data[4*p+q]=(1-a)*id.data[4*p+q]+a*c[q];
    }
  }
  tc.putImageData(id,0,0);
  const cv=$("cmain");
  cv.width=W*SCALE; cv.height=H*SCALE;
  const ctx=cv.getContext("2d");
  ctx.imageSmoothingEnabled=false;
  ctx.drawImage(t,0,0,cv.width,cv.height);
  // existing interactions on this axial slice: ellipse outlines at 1/0.37065
  if(curAxis==="z"&&ST){
    const objs=(ST.interactions[String(cur)]||{})[String(+$("slice").value)]||[];
    ctx.strokeStyle="orange"; ctx.lineWidth=1.5;
    objs.forEach(o=>{
      ctx.beginPath();
      ctx.ellipse(o.center[1]*SCALE, o.center[0]*SCALE,
        o.stddev[1]/ST.ellipse_to_std*SCALE, o.stddev[0]/ST.ellipse_to_std*SCALE,
        0,0,2*Math.PI);
      ctx.stroke();
    });
  }
  if(drag){
    ctx.strokeStyle="orange"; ctx.setLineDash([4,3]);
    ctx.beginPath();
    ctx.ellipse((drag.x0+drag.x1)/2,(drag.y0+drag.y1)/2,
      Math.abs(drag.x1-drag.x0)/2,Math.abs(drag.y1-drag.y0)/2,0,0,2*Math.PI);
    ctx.stroke(); ctx.setLineDash([]);
  }
  // right canvas: raw source
  const sel=$("rightsel").value;
  const src=slices[sel]||slices.img;
  const ri=await loadImg(src);
  const rcv=$("cright");
  rcv.width=W*SCALE; rcv.height=H*SCALE;
  const rctx=rcv.getContext("2d");
  rctx.imageSmoothingEnabled=false;
  if(sel!=="img"&&src!==slices.img){
    // labels are tiny ints — window to visible
    const mt=document.createElement("canvas"); mt.width=W; mt.height=H;
    const mc=mt.getContext("2d"); mc.drawImage(ri,0,0);
    const d=mc.getImageData(0,0,W,H);
    for(let p=0;p<W*H;p++){const v=d.data[4*p];
      d.data[4*p]=v?120+60*v:0; d.data[4*p+1]=v?110*v:0; d.data[4*p+2]=0;}
    mc.putImageData(d,0,0);
    rctx.drawImage(mt,0,0,rcv.width,rcv.height);
  } else rctx.drawImage(ri,0,0,rcv.width,rcv.height);
}
async function selectCase(pid){
  cur=pid; renderCases();
  const c=ST.cases.find(c=>c.pid===pid);
  const n=c.size[{z:0,y:1,x:2}[curAxis]];
  $("slice").max=n-1;
  $("slice").value=Math.min(+$("slice").value,n-1);
  await fetchSlice();
}
function canvasToImg(e){
  const cv=$("cmain"), r=cv.getBoundingClientRect();
  return {x:(e.clientX-r.left)*cv.width/r.width,
          y:(e.clientY-r.top)*cv.height/r.height};
}
$("cmain").addEventListener("mousedown",e=>{
  if(curAxis!=="z") return;
  const p=canvasToImg(e); drag={x0:p.x,y0:p.y,x1:p.x,y1:p.y};
});
$("cmain").addEventListener("mousemove",e=>{
  if(!drag) return; const p=canvasToImg(e); drag.x1=p.x; drag.y1=p.y; draw();
});
window.addEventListener("mouseup",async e=>{
  if(!drag) return;
  const d=drag; drag=null;
  const ry=Math.abs(d.y1-d.y0)/2/SCALE, rx=Math.abs(d.x1-d.x0)/2/SCALE;
  if(ry<1||rx<1){ draw(); return; }
  const sid=+$("slice").value, span=Math.max(1,+$("zspan").value);
  await fetch("/api/interaction",{method:"POST",body:JSON.stringify({
    pid:cur,sid:sid,center:[(d.y0+d.y1)/2/SCALE,(d.x0+d.x1)/2/SCALE],
    radius:[ry,rx],z:[sid,sid+span]})});
  await getState(); await fetchSlice();
  msg("guide added @ slice "+sid);
});
$("undo").onclick=async()=>{
  const r=await(await fetch("/api/interaction/pop",{method:"POST",
    body:JSON.stringify({pid:cur,sid:+$("slice").value})})).json();
  msg(r.popped?"undone":"nothing to undo on this slice");
  await getState(); await fetchSlice();
};
$("save").onclick=async()=>{
  const r=await(await fetch("/api/save",{method:"POST",body:"{}"})).json();
  msg("saved "+r.path);
};
$("predict").onclick=async()=>{
  msg("predicting (the first call builds the model)...");
  const r=await(await fetch("/api/predict",{method:"POST",
    body:JSON.stringify({pid:cur})})).json();
  if(r.error){ msg("error: "+r.error); return; }
  msg("predicted with "+r.guides+" guides "+JSON.stringify(r.metrics));
  await getState(); await fetchSlice();
};
$("slice").addEventListener("input",fetchSlice);
$("axis").addEventListener("input",async e=>{
  curAxis=e.target.value; await selectCase(cur);
});
["alpha","contour","rightsel"].forEach(id=>
  $(id).addEventListener("input",draw));
$("cmain").addEventListener("wheel",e=>{
  e.preventDefault();
  const sl=$("slice");
  sl.value=Math.max(0,Math.min(+sl.max,+sl.value+(e.deltaY>0?1:-1)));
  fetchSlice();
});
window.addEventListener("keydown",e=>{
  if(e.key==="ArrowRight"||e.key==="ArrowLeft"){
    const sl=$("slice");
    sl.value=Math.max(0,Math.min(+sl.max,+sl.value+(e.key==="ArrowRight"?1:-1)));
    fetchSlice();
  } else if(e.key==="u") $("undo").onclick();
});
(async function(){ await getState();
  if(ST.cases.length) await selectCase(ST.cases[0].pid); })();
</script></body></html>
"""


def make_server(app: AnnotateApp, host="127.0.0.1",
                port=8601) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    model_argv = None
    if "--" in argv:  # args after -- compose the live predictor via cli.main
        split = argv.index("--")
        argv, model_argv = argv[:split], argv[split + 1:]
    parser = argparse.ArgumentParser(
        description="Browser-based annotation + model-in-the-loop app "
                    "(the reference interaction/ + model_viewer Qt towers)")
    parser.add_argument("dataset_dir")
    parser.add_argument("--interactions",
                        help="interactions JSON to load/save (default "
                             "<dataset_dir>/user_interactions.json)")
    parser.add_argument("--pred_dir", help="precomputed predictions to overlay")
    parser.add_argument("--cmp_dir", help="second prediction dir (A/B compare)")
    parser.add_argument("--nf", action="store_true",
                        help="NF display window instead of the CT window")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address; unauthenticated — pass 0.0.0.0 "
                             "explicitly to expose beyond localhost")
    parser.add_argument("--port", type=int, default=8601)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device of the guide preview and the live "
                             "predictor; passed on to the model arguments")
    args = parser.parse_args(argv)

    import logging
    logging.basicConfig(level=logging.INFO)
    app = AnnotateApp(args.dataset_dir, interactions_file=args.interactions,
                      pred_dir=args.pred_dir, cmp_dir=args.cmp_dir,
                      nf=args.nf, model_argv=model_argv,
                      device=args.device)
    server = make_server(app, args.host, args.port)
    logging.getLogger("boxsegliver.annotate").info(
        "Annotation app at http://%s:%d/ (%d cases%s)", args.host, args.port,
        len(app.metas), ", live model" if model_argv else "")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
