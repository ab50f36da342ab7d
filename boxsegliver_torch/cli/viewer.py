"""Standalone HTML segmentation viewer: the reference Qt viewer, headless
(port of boxsegliver_tpu/cli/viewer.py).

Re-implements the reference's interactive viewer surface (reference
viewer.py:28-220 SegViewerAdapter + visualization/View_Kits.py Framework) as
ONE self-contained HTML file — no Qt/display server, viewable anywhere:

- case list with slice counts and per-case Dice scores parsed from eval logs
  (reference get_pred_score, visualization/Tool_Kits.py:21-50, adapted to
  this repo's "Evaluate-N case P Cls/Dice: x" log lines) or from
  eval_results_3d.txt;
- side-by-side GT-overlay vs prediction-overlay slice browsing with a slice
  slider (reference get_slice1/get_slice2);
- client-side contour/fill toggle + alpha slider + class selection
  (liver = merged foreground vs tumor only — reference update_choice's
  merge_labels semantics, viewer.py:198-204);
- optional coronal/sagittal axes with spacing-corrected aspect (reference
  resized_image, viewer.py:132-147);
- the z range trims to the organ bbox ±2 slices (reference
  get_min_idx/get_max_idx, viewer.py:99-103).

The port carries no OpenCV: slices are PNG-encoded by ``encode_png`` (numpy
+ zlib) and downscaled by ops/image_ops (``resize_area``, cv2.INTER_AREA's
weights; ``resize_nearest``, bit-identical to cv2.INTER_NEAREST).

    python -m boxsegliver_torch.cli.viewer --pred_dir <model_dir>/prediction \
        --dataset_dir data/LiTS --score_file <model_dir>/logs/<eval log> \
        --out viewer.html
"""

from __future__ import annotations

import argparse
import base64
import json
import re
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# reference display window for CT (viewer.py:80-81: clip [-100, 400] -> u8)
CT_WINDOW = (-100.0, 400.0)
NF_WINDOW = (0.0, 1000.0)

# "Evaluate-3 case 27 Liver/Dice: 0.954 Liver/VOE: 0.1 Tumor/Dice: 0.713 ..."
# zlib level of encode_png: 1 compresses a 512^2 CT slice to within 3 % of
# level 9's size at a fraction of its time (PERF.md, chip_smoke.py phase 18)
ZLIB_LEVEL = 1

_SCORE_PAT = re.compile(r"Evaluate-\d+\s+case\s+(\S+)\s+(.*)")
_PAIR_PAT = re.compile(r"(\S+)/Dice:\s+(\d+\.\d+)")


def parse_scores(score_file) -> Dict[str, Dict[str, float]]:
    """Per-case Dice table from an eval log (this repo's _finish_case lines)
    or an eval_results_3d.txt JSON (run-level means applied to every case)."""
    path = Path(score_file)
    text = path.read_text()
    out: Dict[str, Dict[str, float]] = {}
    for m in _SCORE_PAT.finditer(text):
        pairs = {cls: float(v) for cls, v in _PAIR_PAT.findall(m.group(2))}
        if pairs:
            out[m.group(1)] = pairs
    if not out:
        try:  # eval_results_3d.txt: {"Liver/Dice": ..., ...}
            data = json.loads(text)
            run = {k.split("/")[0]: float(v) for k, v in data.items()
                   if k.endswith("/Dice")}
            if run:
                out["*"] = run
        except (json.JSONDecodeError, AttributeError):
            pass
    return out


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(arr: np.ndarray, text: Optional[Dict[str, str]] = None,
               level: int = ZLIB_LEVEL) -> bytes:
    """uint8 [h, w] (gray) or [h, w, 3] (RGB) -> PNG bytes: 8 bits per
    sample, filter 0 on every row, one IDAT; ``text`` adds one tEXt chunk
    per (keyword, Latin-1 value)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"encode_png takes uint8 [h, w] or [h, w, 3], got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    color = 0 if arr.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, -1)], axis=1)
    out = [b"\x89PNG\r\n\x1a\n",
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                           0))]
    for key, value in (text or {}).items():
        out.append(_png_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                              + value.encode("latin-1", "replace")))
    out.append(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def _png_b64(arr: np.ndarray) -> str:
    """Grayscale uint8 [h, w] -> PNG data URL."""
    return ("data:image/png;base64,"
            + base64.b64encode(encode_png(arr)).decode("ascii"))


def _display_window(volume: np.ndarray, nf: bool) -> np.ndarray:
    """Stored uint16 -> display uint8 with the reference's viewing window."""
    from boxsegliver_torch.data.meta import GRAY_MIN, IM_SCALE

    raw = volume.astype(np.float32) / IM_SCALE + (0.0 if nf else GRAY_MIN)
    lo, hi = NF_WINDOW if nf else CT_WINDOW
    return (np.clip(raw, lo, hi) - lo) * (255.0 / (hi - lo))


def plane(arr: np.ndarray, axis: int, i: int, spacing,
          order: int) -> np.ndarray:
    """Plane i (clipped to the volume) of ``arr`` along ``axis`` with
    spacing-corrected aspect (reference resized_image, viewer.py:132-147):
    axis 1 (coronal) gives [d(z), w], axis 2 (sagittal) [d(z), h], and the
    pixels are squared by zooming whichever direction is coarser by the
    spacing ratio (images order 1, masks order 0)."""
    i = int(np.clip(i, 0, arr.shape[axis] - 1))
    sl = [slice(None)] * 3
    sl[axis] = i
    out = np.asarray(arr[tuple(sl)])
    if axis == 0:
        return out
    from scipy import ndimage as ndi

    a = spacing[2] if axis == 1 else spacing[1]  # in-plane (cols)
    b = spacing[0]                               # z (rows)
    scale = [b / a, 1.0] if b > a else [1.0, a / b]
    if scale != [1.0, 1.0]:
        out = ndi.zoom(out, scale, order=order)
    return out


def _axis_slices(img: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                 axis: int, spacing) -> List[Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]]:
    """Slice stacks along an axis, each plane cut by ``plane``."""
    return [(plane(img, axis, i, spacing, 1), plane(gt, axis, i, spacing, 0),
             plane(pred, axis, i, spacing, 0))
            for i in range(img.shape[axis])]


def build_case(meta: Dict, dataset_dir, pred: np.ndarray, nf: bool,
               axes: str = "z", max_size: int = 256, z_pad: int = 2) -> Dict:
    """Per-case payload: per-axis base64 slice triplets + geometry."""
    import torch

    from boxsegliver_torch.data.sampler import CaseVolumes
    from boxsegliver_torch.ops.image_ops import resize_area, resize_nearest

    vols = CaseVolumes(Path(dataset_dir))
    pid = int(meta["PID"])
    volume = np.asarray(vols.volume(pid))
    gt = np.array(vols.label(pid))       # writable copies: torch takes views
    assert pred.shape == gt.shape, (pred.shape, gt.shape)
    # organ-bbox z trim (reference get_min_idx/get_max_idx, viewer.py:99-103)
    bb = meta["bbox"]
    z1 = max(bb[0] - z_pad, 0)
    z2 = min(bb[3] + z_pad, volume.shape[0])
    disp = _display_window(volume[z1:z2], nf).astype(np.uint8)
    gt, pred = gt[z1:z2], np.array(pred[z1:z2])

    payload = {"pid": pid, "z1": z1, "axes": {},
               "spacing": [float(s) for s in meta["spacing"]]}
    for ax_name, axis in (("z", 0), ("y", 1), ("x", 2)):
        if ax_name not in axes:
            continue
        triplets = _axis_slices(disp, gt, pred, axis, meta["spacing"])
        slices = []
        for im, g, p in triplets:
            h, w = im.shape
            if max(h, w) > max_size:
                s = max_size / max(h, w)
                size = (max(int(h * s), 1), max(int(w * s), 1))
                im = resize_area(torch.from_numpy(im), size).numpy()
                g = resize_nearest(torch.from_numpy(g), size).numpy()
                p = resize_nearest(torch.from_numpy(p), size).numpy()
            slices.append({"img": _png_b64(im), "gt": _png_b64(g),
                           "pred": _png_b64(p)})
        payload["axes"][ax_name] = slices
    return payload


def load_pred(pred_path: Path) -> np.ndarray:
    """predict-<pid>.nii.gz (class map) or <pid>.npz (probs -> argmax)."""
    if pred_path.suffix == ".npz":
        probs = np.load(pred_path)["arr_0"]
        return probs.argmax(-1).astype(np.uint8)
    from boxsegliver_torch.data import nii as nii_kits

    _, arr = nii_kits.read_nii(pred_path, out_dtype=np.uint8)
    return arr


_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>boxsegliver viewer</title><style>
body{font-family:sans-serif;margin:0;display:flex;height:100vh}
#side{width:320px;overflow:auto;border-right:1px solid #ccc;padding:8px}
#main{flex:1;padding:8px;overflow:auto}
table{border-collapse:collapse;width:100%;font-size:13px}
td,th{border:1px solid #ddd;padding:3px 6px;text-align:left;cursor:pointer}
tr.sel{background:#def}
canvas{border:1px solid #999;image-rendering:pixelated;margin-right:8px}
.row{margin:6px 0}
label{margin-right:10px;font-size:13px}
h4{margin:4px 0}
</style></head><body>
<div id="side"><h4>Cases</h4><table id="cases"><thead><tr>
<th>case</th><th>slices</th><th id="scorehead">Dice</th></tr></thead>
<tbody></tbody></table></div>
<div id="main">
<div class="row">
<label>axis <select id="axis"></select></label>
<label>slice <input type="range" id="slice" min="0" max="0" value="0" style="width:300px">
<span id="sliceno">0</span></label>
</div>
<div class="row">
<label><input type="checkbox" id="contour" checked> contour</label>
<label>alpha <input type="range" id="alpha" min="0" max="100" value="30" style="width:120px"></label>
<label>class <select id="clssel">
<option value="merge">merged foreground</option>
<option value="all">each class</option>
<option value="2">class 2 (tumor) only</option></select></label>
</div>
<div><canvas id="cgt"></canvas><canvas id="cpred"></canvas></div>
<div class="row" style="font-size:13px">left: ground truth &nbsp;|&nbsp; right: prediction</div>
</div>
<script>
const DATA = __DATA__;
let cur = null, curAxis = "z";
const colors = {1:[50,150,255],2:[255,80,50],3:[50,255,100]};
function maskSet(v, mode){
  if(!v) return 0;
  if(mode==="merge") return v>0?2:0;     /* merged foreground, one color */
  if(mode==="2") return v===2?2:0;       /* tumor only */
  return v;                               /* each class its own color */
}
function draw(){
  if(cur===null) return;
  const slices = DATA.cases[cur].axes[curAxis];
  const i = +document.getElementById("slice").value;
  document.getElementById("sliceno").textContent = i + (curAxis==="z"?DATA.cases[cur].z1:0);
  const s = slices[Math.min(i, slices.length-1)];
  ["gt","pred"].forEach(kind=>{
    const cv = document.getElementById(kind==="gt"?"cgt":"cpred");
    const img = new Image(), msk = new Image();
    let ready = 0;
    function go(){
      if(++ready<2) return;
      cv.width = img.width*2; cv.height = img.height*2;
      const ctx = cv.getContext("2d");
      const t = document.createElement("canvas");
      t.width = img.width; t.height = img.height;
      const tc = t.getContext("2d");
      tc.drawImage(img,0,0);
      const base = tc.getImageData(0,0,t.width,t.height);
      tc.drawImage(msk,0,0);
      const m = tc.getImageData(0,0,t.width,t.height);
      const mode = document.getElementById("clssel").value;
      const alpha = +document.getElementById("alpha").value/100;
      const contour = document.getElementById("contour").checked;
      const W=t.width,H=t.height;
      const lab = new Uint8Array(W*H);
      for(let p=0;p<W*H;p++) lab[p]=maskSet(m.data[4*p],mode);
      for(let y=0;y<H;y++)for(let x=0;x<W;x++){
        const p=y*W+x, v=lab[p];
        if(!v) continue;
        let edge=false;
        if(contour){
          edge = (x===0||lab[p-1]!==v)||(x===W-1||lab[p+1]!==v)||
                 (y===0||lab[p-W]!==v)||(y===H-1||lab[p+W]!==v);
          if(!edge) continue;
        }
        const c = colors[v]||[255,255,255];
        const a = contour?1.0:alpha;
        for(let k=0;k<3;k++)
          base.data[4*p+k] = (1-a)*base.data[4*p+k] + a*c[k];
      }
      tc.putImageData(base,0,0);
      ctx.imageSmoothingEnabled=false;
      ctx.drawImage(t,0,0,cv.width,cv.height);
    }
    img.onload=go; msk.onload=go;
    img.src=s.img; msk.src=s[kind];
  });
}
function selectCase(pid){
  cur = pid;
  document.querySelectorAll("#cases tbody tr").forEach(tr=>
    tr.classList.toggle("sel", tr.dataset.pid===String(pid)));
  const axSel = document.getElementById("axis");
  axSel.innerHTML = "";
  Object.keys(DATA.cases[pid].axes).forEach(a=>{
    const o=document.createElement("option"); o.value=o.textContent=a;
    axSel.appendChild(o);
  });
  curAxis = axSel.value;
  const sl = document.getElementById("slice");
  sl.max = DATA.cases[pid].axes[curAxis].length-1;
  sl.value = Math.min(sl.value, sl.max);
  draw();
}
(function init(){
  const tb = document.querySelector("#cases tbody");
  const names = Object.keys(DATA.cases);
  names.forEach(pid=>{
    const tr=document.createElement("tr");
    tr.dataset.pid=pid;
    const sc = DATA.scores[pid]||DATA.scores["*"]||{};
    const stext = Object.entries(sc).map(([k,v])=>k+" "+v.toFixed(3)).join(" ");
    const ax0 = Object.values(DATA.cases[pid].axes)[0];
    tr.innerHTML = "<td>Pred-"+pid+"</td><td>"+ax0.length+
      "</td><td>"+stext+"</td>";
    tr.onclick=()=>selectCase(pid);
    tb.appendChild(tr);
  });
  ["slice","alpha","clssel","contour"].forEach(id=>
    document.getElementById(id).addEventListener("input",draw));
  document.getElementById("axis").addEventListener("input",e=>{
    curAxis=e.target.value;
    const sl=document.getElementById("slice");
    sl.max=DATA.cases[cur].axes[curAxis].length-1;
    sl.value=Math.min(sl.value,sl.max);
    draw();
  });
  if(names.length) selectCase(names[0]);
})();
</script></body></html>
"""


def build_viewer(pred_dir, dataset_dir, out_path, score_file=None,
                 axes: str = "z", max_size: int = 256,
                 pids: Optional[List[int]] = None, nf: Optional[bool] = None
                 ) -> Path:
    from boxsegliver_torch.data.meta import load_meta

    axes = "".join(a for a in axes if a in "zyx")
    if not axes:
        raise ValueError("--axes needs at least one of 'zyx'")
    pred_dir = Path(pred_dir)
    metas = {int(m["PID"]): m for m in load_meta(dataset_dir)}
    if nf is None:
        nf = False  # CT window by default; --nf selects the MRI window
    cases = {}
    for path in sorted(pred_dir.glob("predict-*.nii.gz")) + \
            sorted(pred_dir.glob("*.npz")):
        pid = int(re.findall(r"(\d+)", path.stem)[-1])
        if pids and pid not in pids:
            continue
        if pid not in metas:
            continue
        pred = load_pred(path)
        cases[str(pid)] = build_case(metas[pid], dataset_dir, pred, nf,
                                     axes=axes, max_size=max_size)
    if not cases:
        raise FileNotFoundError(f"No predictions matching meta.json PIDs in "
                                f"{pred_dir}")
    scores = parse_scores(score_file) if score_file else {}
    html = _HTML.replace("__DATA__", json.dumps(
        {"cases": cases, "scores": scores}))
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(html)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pred_dir", required=True,
                        help="directory with predict-<pid>.nii.gz / <pid>.npz "
                             "(--save_predict output)")
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--out", default="viewer.html")
    parser.add_argument("--score_file",
                        help="eval log or eval_results_3d.txt for the "
                             "per-case Dice column")
    parser.add_argument("--axes", default="z",
                        help="subset of 'zyx': which axes to embed")
    parser.add_argument("--max_size", type=int, default=256)
    parser.add_argument("--pids", type=int, nargs="*")
    parser.add_argument("--nf", action="store_true",
                        help="NF display window [0, 1000] instead of the CT "
                             "window [-100, 400]")
    args = parser.parse_args(argv)
    out = build_viewer(args.pred_dir, args.dataset_dir, args.out,
                       score_file=args.score_file, axes=args.axes,
                       max_size=args.max_size, pids=args.pids, nf=args.nf)
    print(f"Wrote {out} ({out.stat().st_size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
