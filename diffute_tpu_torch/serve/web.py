"""Dependency-free web demo of the PyTorch port: the reference UI
(app.ipynb:856-928) on the Python standard library alone.

The port's own copy of ``diffute_tpu/serve/web.py`` (http.server + a
single-page canvas app), wired to the callbacks in ``serve/ui.py``:

  - two-click ROI selection with the point-marker/ROI overlay and labels
    (app.ipynb:860-884): clicks POST to ``/api/click`` which advances
    ``ui.select_coordinates`` and returns the AnnotatedImage-style sections;
  - X0/Y0/X1/Y1 number boxes live-updated by clicks and hand-editable
    (app.ipynb:906-907) -- the boxes are authoritative for Generate;
  - an examples gallery seeding (text, image, steps, box) rows
    (app.ipynb:905-912) from ``ui.make_examples``;
  - a 20-200 inference-steps slider defaulting to 150 (app.ipynb:914) and
    the beyond-reference sampler dropdown ({ddim, ddpm, dpmpp}).

The API is stateless: the client round-trips the ROI state blob.  Edits are
serialized behind a lock -- one job on the card at a time.

Launch::

    python -m diffute_tpu_torch.serve.web --scale full --port 7860
    python -m diffute_tpu_torch.serve.web --scale tiny --device cpu

The models run on the card by default (bf16, flash attention; without a card
the command exits non-zero) and on the CPU only with ``--device cpu`` (fp32).
Weights are random-init from a seed: ``--checkpoint`` is not yet ported and
raises.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from diffute_tpu_torch.serve.ui import (
    SAMPLERS,
    initial_roi_state,
    make_examples,
    roi_ready,
    run_edit,
    select_coordinates,
)


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _b64_png(arr: np.ndarray) -> str:
    return "data:image/png;base64," + base64.b64encode(
        _png_bytes(arr)).decode("ascii")


def _decode_image(data_url: str) -> np.ndarray:
    from PIL import Image

    b64 = data_url.split(",", 1)[-1]
    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


class DemoBackend:
    """The demo's server-side callbacks, independent of HTTP plumbing.

    Each method is one widget callback from the reference demo, delegating
    to serve/ui.py; ``handle_edit`` serializes pipeline calls (one card).
    """

    def __init__(self, pipe, examples_dir: Optional[str] = None):
        self.pipe = pipe
        self._edit_lock = threading.Lock()
        self.examples_dir = examples_dir or tempfile.mkdtemp(
            prefix="diffute_examples_")
        rows = make_examples(self.examples_dir)
        # rows: [text, path, steps, x0, y0, x1, y1] -> JSON-friendly dicts
        self.examples = [
            {"text": r[0], "image": "/examples/" + os.path.basename(r[1]),
             "steps": r[2], "box": [r[3], r[4], r[5], r[6]]} for r in rows]

    def handle_click(self, payload: dict) -> dict:
        state = payload.get("state") or initial_roi_state()
        xy = payload["xy"]
        hw = payload.get("hw") or (512, 512)
        state, sections, box = select_coordinates(state, xy, tuple(hw))
        return {"state": state, "box": list(box), "ready": roi_ready(state),
                "sections": [{"box": list(b), "label": lab}
                             for b, lab in sections]}

    def handle_edit(self, payload: dict) -> dict:
        import time

        text = payload.get("text") or ""
        image = _decode_image(payload["image"])
        steps = int(payload.get("steps") or 150)
        sampler = payload.get("sampler") or None
        if sampler is not None and sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; "
                             f"expected one of {SAMPLERS}")
        x0, y0, x1, y1 = (int(v) for v in payload["box"])
        if (x1 - x0) * (y1 - y0) <= 0:
            raise ValueError("click two corners of the text region (or fill "
                             "the X0/Y0/X1/Y1 boxes) first")
        t0 = time.perf_counter()
        with self._edit_lock:
            out, mask = run_edit(self.pipe, image, text, steps,
                                 x0, y0, x1, y1, sampler=sampler)
        mask = np.asarray(mask)
        if mask.dtype != np.uint8:  # reference shows mask*255 (app.ipynb:854)
            mask = (np.clip(mask, 0.0, 1.0) * 255).astype(np.uint8)
        return {"image": _b64_png(out), "mask": _b64_png(mask),
                "seconds": round(time.perf_counter() - t0, 3)}

    def example_png(self, name: str) -> Optional[bytes]:
        if os.path.sep in name or name != os.path.basename(name):
            return None
        path = os.path.join(self.examples_dir, name)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


class _Handler(BaseHTTPRequestHandler):
    backend: DemoBackend  # set by make_server
    quiet = True

    def log_message(self, fmt, *args):  # noqa: D102
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj: dict, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802
        if self.path in ("/", "/index.html"):
            self._send(200, INDEX_HTML.encode(), "text/html; charset=utf-8")
        elif self.path == "/api/examples":
            self._send_json({"examples": self.backend.examples,
                             "samplers": list(SAMPLERS)})
        elif self.path.startswith("/examples/"):
            data = self.backend.example_png(self.path[len("/examples/"):])
            if data is None:
                self._send_json({"error": "not found"}, 404)
            else:
                self._send(200, data, "image/png")
        else:
            self._send_json({"error": "not found"}, 404)

    def do_POST(self) -> None:  # noqa: N802
        n = int(self.headers.get("Content-Length") or 0)
        try:
            payload = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError:
            self._send_json({"error": "invalid JSON body"}, 400)
            return
        try:
            if self.path == "/api/click":
                self._send_json(self.backend.handle_click(payload))
            elif self.path == "/api/edit":
                self._send_json(self.backend.handle_edit(payload))
            else:
                self._send_json({"error": "not found"}, 404)
        except (KeyError, TypeError, ValueError) as e:
            self._send_json({"error": str(e)}, 400)


def make_server(backend: DemoBackend, host: str = "127.0.0.1",
                port: int = 0, quiet: bool = True) -> ThreadingHTTPServer:
    """Bind the demo on (host, port); port 0 picks a free one.  The caller
    owns the server (serve_forever / shutdown)."""
    handler = type("BoundHandler", (_Handler,),
                   {"backend": backend, "quiet": quiet})
    return ThreadingHTTPServer((host, port), handler)


def build_pipeline(checkpoint: Optional[str], scale: str, device="cuda"):
    """The demo's pipeline at ``scale`` with random weights from seed 0, on
    ``device``: the card by default (raises without one; bf16 with the
    flash kernel), the CPU only when asked (fp32)."""
    if checkpoint:
        raise NotImplementedError(
            "--checkpoint is not yet ported to the PyTorch port "
            "(ROADMAP queue 1 item 5)")
    from diffute_tpu_torch.config import (
        DiffUTEConfig,
        card_serving_config,
        small_config,
        tiny_test_config,
    )
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device

    device = resolve_device(device)
    config = {"full": DiffUTEConfig, "small": small_config,
              "tiny": tiny_test_config}[scale]()
    if device.type == "cuda":
        config = card_serving_config(config)
    return DiffUTEPipeline(config, init_pipeline_params(config, 0, device),
                           device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None,
                   help="not yet ported (random init from a seed)")
    p.add_argument("--scale", default="full",
                   choices=("full", "small", "tiny"))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    a = p.parse_args(argv)
    try:
        pipe = build_pipeline(a.checkpoint, a.scale, a.device)
    except (NotImplementedError, RuntimeError) as e:
        raise SystemExit(f"web: {e}")
    server = make_server(DemoBackend(pipe), a.host, a.port, quiet=False)
    host, port = server.server_address[:2]
    print(f"DiffUTE demo: http://{host}:{port}/  (scale={a.scale}, "
          f"device={pipe.device}, random-init weights)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


# The single-page app: canvas two-click ROI + overlays, coordinate boxes,
# steps slider, sampler dropdown, examples strip, result + mask panes.
INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8">
<title>DiffUTE: Universal Text Editing Diffusion Model</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.5rem;background:#fafafa;color:#222}
 h1{font-size:1.25rem} .row{display:flex;gap:2rem;flex-wrap:wrap}
 .col{flex:1;min-width:340px} canvas{border:1px solid #bbb;max-width:100%;cursor:crosshair;background:#fff}
 img.out{border:1px solid #bbb;max-width:100%;display:block}
 label{font-size:.85rem;color:#555;display:block;margin-top:.6rem}
 input[type=number]{width:5.5rem} input[type=text]{width:100%;box-sizing:border-box;padding:.35rem}
 button{margin-top:.8rem;padding:.5rem 1.4rem;font-size:1rem;background:#e8590c;color:#fff;border:0;border-radius:4px;cursor:pointer}
 button:disabled{background:#aaa} .coords{display:flex;gap:.8rem}
 .examples{display:flex;gap:.6rem;margin-top:.6rem;flex-wrap:wrap}
 .examples img{height:72px;border:1px solid #ccc;cursor:pointer}
 #status{margin-top:.6rem;font-size:.85rem;color:#555;white-space:pre-wrap}
 .err{color:#c0392b}
</style></head><body>
<h1>DiffUTE: Universal Text Editing Diffusion Model</h1>
<div class="row">
 <div class="col">
  <label>Original image (click two corners of the text region)</label>
  <canvas id="cv" width="512" height="384"></canvas>
  <label>Upload <input type="file" id="file" accept="image/*"></label>
  <label>Input the text you want to write here
   <input type="text" id="text"></label>
  <div class="coords">
   <label>X0 <input type="number" id="x0" value="0"></label>
   <label>Y0 <input type="number" id="y0" value="0"></label>
   <label>X1 <input type="number" id="x1" value="0"></label>
   <label>Y1 <input type="number" id="y1" value="0"></label>
  </div>
  <label>Inference step (the step of denoising process):
   <span id="stepsv">150</span>
   <input type="range" id="steps" min="20" max="200" step="1" value="150"></label>
  <label>Sampler <select id="sampler"></select></label>
  <button id="go">Generate</button>
  <div id="status"></div>
  <label>Examples</label><div class="examples" id="examples"></div>
 </div>
 <div class="col">
  <label>Generated image</label><img class="out" id="out">
  <label>Generated mask</label><img class="out" id="mask">
 </div>
</div>
<script>
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let img=new Image(),roiState=null,sections=[];
function draw(){ctx.clearRect(0,0,cv.width,cv.height);
 if(img.width)ctx.drawImage(img,0,0);
 for(const s of sections){const[a,b,c,d]=s.box;
  ctx.strokeStyle=s.label.startsWith('Click')?'#f44336':'#2e86de';
  ctx.lineWidth=2;ctx.strokeRect(a,b,c-a,d-b);
  ctx.fillStyle=ctx.strokeStyle;ctx.font='12px sans-serif';
  ctx.fillText(s.label,a+2,Math.max(12,b-4));}}
function setImage(src,cb){img=new Image();img.onload=()=>{
 cv.width=img.width;cv.height=img.height;roiState=null;sections=[];draw();
 if(cb)cb();};img.src=src;}
cv.addEventListener('click',async ev=>{
 const r=cv.getBoundingClientRect();
 const x=Math.round((ev.clientX-r.left)*cv.width/r.width);
 const y=Math.round((ev.clientY-r.top)*cv.height/r.height);
 const res=await fetch('/api/click',{method:'POST',
  body:JSON.stringify({state:roiState,xy:[x,y],hw:[cv.height,cv.width]})});
 const j=await res.json();roiState=j.state;sections=j.sections;draw();
 if(j.ready){const[a,b,c,d]=j.box;x0.value=a;y0.value=b;x1.value=c;y1.value=d;}});
document.getElementById('file').addEventListener('change',ev=>{
 const f=ev.target.files[0];if(!f)return;
 const rd=new FileReader();rd.onload=()=>setImage(rd.result);rd.readAsDataURL(f);});
steps.addEventListener('input',()=>stepsv.textContent=steps.value);
async function loadExamples(){
 const j=await(await fetch('/api/examples')).json();
 for(const s of j.samplers){const o=document.createElement('option');
  o.value=s;o.textContent=s;sampler.appendChild(o);}
 for(const e of j.examples){const t=document.createElement('img');
  t.src=e.image;t.title=e.text;
  t.onclick=()=>{setImage(e.image,()=>{
   text.value=e.text;steps.value=e.steps;stepsv.textContent=e.steps;
   const[a,b,c,d]=e.box;x0.value=a;y0.value=b;x1.value=c;y1.value=d;
   sections=[{box:e.box,label:'ROI of Text Editing'}];draw();});};
  document.getElementById('examples').appendChild(t);}
 if(j.examples.length)j.examples[0]&&document.getElementById('examples').firstChild.click();}
go.addEventListener('click',async()=>{
 go.disabled=true;status.textContent='generating...';status.className='';
 // send pixels without overlays: redraw image only
 const tmp=document.createElement('canvas');tmp.width=cv.width;tmp.height=cv.height;
 tmp.getContext('2d').drawImage(img,0,0);
 try{
  const res=await fetch('/api/edit',{method:'POST',body:JSON.stringify({
   image:tmp.toDataURL('image/png'),text:text.value,
   steps:+steps.value,sampler:sampler.value,
   box:[+x0.value,+y0.value,+x1.value,+y1.value]})});
  const j=await res.json();
  if(!res.ok){status.textContent=j.error;status.className='err';}
  else{out.src=j.image;mask.src=j.mask;
   status.textContent='done in '+j.seconds+' s';}
 }catch(e){status.textContent=String(e);status.className='err';}
 go.disabled=false;});
loadExamples();
</script></body></html>
"""

if __name__ == "__main__":
    main()
