"""Interactive web viewer of the port (twin of
``triangle_splatting_tpu/viewer.py`` and the root ``viser_viewer.py``).

A self-contained stdlib HTTP viewer: an embedded HTML/JS page with orbit
controls posts camera poses to ``/render``; the server renders them on the
viewer's device (``"cuda"`` unless the caller asks for the CPU) and answers
with JPEG frames. The GUI is the JAX viewer's: render mode (color / depth /
normal), background, resolution, live gamma (1-50), SH degree, and a model
selector over the saved PLY iterations and GLB meshes.

Each request renders under ``torch.inference_mode()`` in its handler
thread, behind the viewer's lock. It reads only render, depth and normal,
so it renders with rich info and without the contribution statistics
(those three outputs are the rich + stats form's bit for bit). Besides the
JAX viewer's ``X-Info`` line, a frame carries ``X-Num-Pairs`` and
``X-Overflow``. The frames bin at one ``PairBudget`` sized from the pairs
the frames needed (the JAX default, 6 a triangle, at the first frame),
across resolutions and loaded models; a frame whose pairs overflow it is
rendered again at a budget that holds them, where the JAX viewer drops
them.

    python -m triangle_splatting_tpu_torch.viewer --model_dir outputs/NerfSynthetic/VanillaTS/lego
    python -m triangle_splatting_tpu_torch.viewer --config config/NerfSynthetic_VanillaTS.yaml --scene lego
"""

from __future__ import annotations

import argparse
import io
import json
import math
import threading
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .models import triangle as M
from .models.facade import triangles_from_raw
from .models.raw_triangle import RawTriangle
from .ops.projection import RasterSettings
from .ops.rasterize import PairBudget
from .utils.camera import Camera

_PAGE = """<!DOCTYPE html>
<html><head><title>triangle_splatting_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:sans-serif;display:flex}
#view{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
#img{max-width:100%;max-height:100%}
#panel{width:260px;padding:12px;background:#1b1b1e;font-size:13px}
label{display:block;margin-top:10px;color:#9aa}
select,input{width:100%}
#stats{margin-top:14px;color:#7a8}
</style></head><body>
<div id="view"><img id="img"/></div>
<div id="panel">
  <h3>2DTS viewer</h3>
  <label>model</label><select id="model"></select>
  <label>mode</label>
  <select id="mode"><option>color</option><option>depth</option><option>normal</option></select>
  <label>background</label>
  <select id="bg"><option>white</option><option>black</option></select>
  <label>resolution <span id="resv"></span></label>
  <input type="range" id="res" min="128" max="1024" step="64" value="512"/>
  <label>gamma <span id="gammav"></span></label>
  <input type="range" id="gamma" min="0" max="100" value="0"/>
  <label>sh degree <span id="shv"></span></label>
  <input type="range" id="sh" min="0" max="3" value="3"/>
  <div id="stats"></div>
  <p style="color:#667">drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</p>
</div>
<script>
let theta=0.6, phi=1.2, radius=4.0, target=[0,0,0];
let busy=false, dirty=true;
const img=document.getElementById('img');
function pose(){
  const st=Math.sin(theta),ct=Math.cos(theta),sp=Math.sin(phi),cp=Math.cos(phi);
  const eye=[target[0]+radius*sp*st, target[1]+radius*cp, target[2]+radius*sp*ct];
  return {eye:eye, target:target, up:[0,-1,0]};
}
function params(){
  const g=document.getElementById('gamma').value;
  const gamma=Math.pow(50, g/100);
  document.getElementById('gammav').textContent=gamma.toFixed(2);
  document.getElementById('resv').textContent=document.getElementById('res').value;
  document.getElementById('shv').textContent=document.getElementById('sh').value;
  return {pose:pose(), mode:document.getElementById('mode').value,
          bg:document.getElementById('bg').value,
          res:parseInt(document.getElementById('res').value),
          gamma:gamma, sh:parseInt(document.getElementById('sh').value),
          model:document.getElementById('model').value};
}
async function render(){
  if(busy){dirty=true;return}
  busy=true;dirty=false;
  const t0=performance.now();
  const r=await fetch('/render',{method:'POST',body:JSON.stringify(params())});
  const blob=await r.blob();
  img.src=URL.createObjectURL(blob);
  document.getElementById('stats').textContent=
    'frame '+(performance.now()-t0).toFixed(0)+' ms · '+r.headers.get('X-Info');
  busy=false;
  if(dirty) render();
}
let drag=false,panning=false,lx=0,ly=0;
img.ondragstart=()=>false;
document.getElementById('view').addEventListener('mousedown',e=>{drag=true;panning=e.shiftKey;lx=e.clientX;ly=e.clientY});
window.addEventListener('mouseup',()=>drag=false);
window.addEventListener('mousemove',e=>{
  if(!drag)return;
  const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
  if(panning){target[0]-=dx*0.002*radius;target[1]-=dy*0.002*radius;}
  else{theta-=dx*0.005;phi=Math.min(3.0,Math.max(0.14,phi-dy*0.005));}
  render();
});
window.addEventListener('wheel',e=>{radius*=Math.exp(e.deltaY*0.001);render();});
for(const id of['mode','bg','res','gamma','sh','model'])
  document.getElementById(id).addEventListener('input',render);
fetch('/models').then(r=>r.json()).then(ms=>{
  const sel=document.getElementById('model');
  for(const m of ms){const o=document.createElement('option');o.textContent=m;sel.appendChild(o);}
  render();
});
</script></body></html>"""


def _depth_to_image(depth: np.ndarray) -> np.ndarray:
    """Robust-normalized JET colormap (2-98 percentile window, then the
    shared utils.vis_utils JET map), as float RGB."""
    from .utils.vis_utils import depth_to_image
    d = depth.copy()
    finite = np.isfinite(d)
    lo, hi = (np.percentile(d[finite], [2, 98]) if finite.any() else (0, 1))
    d = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    bgr = depth_to_image(d)
    return bgr[..., ::-1].astype(np.float32) / 255.0


def _normal_to_image(normal: np.ndarray) -> np.ndarray:
    n = normal / np.maximum(np.linalg.norm(normal, axis=0, keepdims=True), 1e-8)
    return (n.transpose(1, 2, 0) + 1) / 2


class ViewerState:
    """The models under ``model_dir`` (``point_cloud/*.ply``, ``glb/*.glb``),
    the one loaded, and the pose -> frame render."""

    def __init__(self, model_dir: str | Path, max_sh_degree: int = 3,
                 rasterizer_type: str = "2D", device="cuda"):
        self.model_dir = Path(model_dir)
        self.max_sh_degree = max_sh_degree
        self.rasterizer_type = rasterizer_type
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.models = self._discover()
        self.current = None
        self.params = None
        self.state = None
        self.last = {}          # the last frame's num_pairs and overflow
        self.budget = PairBudget()

    def _discover(self):
        out = []
        for pattern in ("point_cloud/*.ply", "glb/*.glb"):
            out += sorted(str(p.relative_to(self.model_dir))
                          for p in self.model_dir.glob(pattern))
        return out or ["<none>"]

    def load(self, rel: str):
        if rel == self.current or rel == "<none>":
            return
        path = self.model_dir / rel
        raw = (RawTriangle(glb_path=path) if rel.endswith(".glb")
               else RawTriangle(ply_path=path))
        self.params, state = triangles_from_raw(raw, self.max_sh_degree, self.device)
        self.state = replace(state, active_sh_degree=torch.tensor(
            self.max_sh_degree, dtype=torch.int32, device=self.device))
        self.current = rel

    def camera(self, req: dict) -> Camera:
        """The request's look-at pose (COLMAP convention) at res x res."""
        res = int(req.get("res", 512))
        eye = np.array(req["pose"]["eye"], np.float64)
        tgt = np.array(req["pose"]["target"], np.float64)
        up = np.array(req["pose"]["up"], np.float64)
        fwd = tgt - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R = np.stack([right, true_up, fwd], axis=1)   # c2w, COLMAP convention
        T = -R.T @ eye
        return Camera.create(R=R, T=T, fovx=math.radians(60), image_width=res,
                             image_height=res, device=self.device)

    def render(self, req: dict) -> tuple[np.ndarray, str]:
        """(H, W, 3) float frame in [0, 1] and the info line."""
        self.load(req.get("model", self.models[0]))
        if self.params is None:
            return np.zeros((64, 64, 3), np.float32), "no model"
        res = int(req.get("res", 512))
        cam = self.camera(req)
        settings = RasterSettings(image_width=res, image_height=res,
                                  max_sh_degree=self.max_sh_degree,
                                  rasterizer_type=self.rasterizer_type)
        dev = self.device
        with torch.inference_mode():
            state = replace(self.state,
                            gamma=torch.tensor(float(req.get("gamma", 1.0)),
                                               dtype=torch.float32, device=dev),
                            active_sh_degree=torch.tensor(
                                min(int(req.get("sh", 3)), self.max_sh_degree),
                                dtype=torch.int32, device=dev))
            bg = (torch.ones if req.get("bg", "white") == "white" else torch.zeros)(
                3, dtype=torch.float32, device=dev)
            cfg = M.ModelConfig(max_sh_degree=self.max_sh_degree,
                                rasterizer_type=self.rasterizer_type)
            pkg = self.budget.render(
                lambda max_pairs: M.forward(self.params, state, cam, bg, cfg, settings,
                                            is_training=False, max_pairs=max_pairs,
                                            apply_color_affine=False, need_stats=False))
            mode = req.get("mode", "color")
            if mode == "depth":
                img = _depth_to_image(pkg["depth"].cpu().numpy())
            elif mode == "normal":
                img = _normal_to_image(pkg["normal"].cpu().numpy())
            else:
                img = np.clip(pkg["render"].cpu().numpy().transpose(1, 2, 0), 0, 1)
            self.last = dict(num_pairs=int(pkg["num_pairs"]), overflow=bool(pkg["overflow"]))
        info = f"{int(self.state.alive.sum())} tris @ {res}px"
        return img, info


class _Handler(BaseHTTPRequestHandler):
    viewer: ViewerState = None

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path == "/models":
            body = json.dumps(self.viewer.models).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE.encode())

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        req = json.loads(self.rfile.read(length) or b"{}")
        with self.viewer.lock:
            img, info = self.viewer.render(req)
            last = dict(self.viewer.last)
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            buf, "JPEG", quality=90)
        self.send_response(200)
        self.send_header("Content-Type", "image/jpeg")
        self.send_header("X-Info", info)
        if last:
            self.send_header("X-Num-Pairs", str(last["num_pairs"]))
            self.send_header("X-Overflow", str(int(last["overflow"])))
        self.end_headers()
        self.wfile.write(buf.getvalue())


def run_viewer(model_dir: str, host: str = "0.0.0.0", port: int = 8080,
               max_sh_degree: int = 3, rasterizer_type: str = "2D",
               block: bool = True, device="cuda"):
    """Serve the viewer over HTTP; with ``block=False`` serve from a daemon
    thread and return the server (``server.shutdown()`` stops it). Each
    server has its own ``ViewerState``."""
    state = ViewerState(model_dir, max_sh_degree, rasterizer_type, device=device)
    handler = type("_ViewerHandler", (_Handler,), {"viewer": state})
    server = ThreadingHTTPServer((host, port), handler)
    print(f"viewer: http://{host}:{server.server_address[1]}  models={state.models}")
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None):
    """The root ``viser_viewer.py``'s arguments, plus ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--scene", default=None)
    parser.add_argument("--dataset_path", default=None)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    max_sh, rtype = 3, "2D"
    model_dir = args.model_dir
    if model_dir is None:
        if args.config is None:
            parser.error("provide --model_dir or --config/--scene")
        from .utils.config import loadConfig
        config = loadConfig(args.config)
        max_sh = config.model.max_sh_degree or 0
        rtype = config.model.rasterizer_type or "2D"
        out = config.trainer.output_dir
        model_dir = f"{out}/{args.scene}" if args.scene else out
    run_viewer(model_dir, host=args.host, port=args.port, max_sh_degree=max_sh,
               rasterizer_type=rtype, device=args.device)


if __name__ == "__main__":
    main()
