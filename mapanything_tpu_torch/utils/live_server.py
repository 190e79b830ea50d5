"""Live inference demo server: upload images -> infer -> orbit viewer.

Counterpart of ``mapanything_tpu/utils/live_server.py`` (:1-220), the native
stand-in for the reference's gradio app (``scripts/gradio_app.py``): a
standard-library ``http.server`` app. GET / serves an upload page; the page
base64-encodes the selected images and POSTs JSON to /infer; the handler
decodes them (PNG and JPEG with the port's own decoders), resizes them to the
model's 518-px aspect-ratio bucket, runs the injected ``infer_fn``, and
responds with the self-contained WebGL orbit viewer (``utils/viewer.py``)
embedding the reconstruction.

``infer_fn(images: list[np.ndarray float HWC in [0,1]]) -> dict`` must
return {"points": (V,H,W,3), "colors": (V,H,W,3) [0,1],
"mask": (V,H,W) bool | None, "camera_poses": (V,4,4) | None,
"intrinsics": (V,3,3) | None}. ``make_model_infer_fn`` builds one from a
port ``MapAnything`` (which carries its weights and device). The server
(``ThreadingHTTPServer``) runs one forward at a time.

Run: python3 -m mapanything_tpu_torch.tools.live_demo [--checkpoint ...] [--port 8008]
"""

from __future__ import annotations

import base64
import json
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mapanything_tpu_torch.geometry.quaternion import quats_trans_to_pose_matrix
from mapanything_tpu_torch.models.mapanything import Views
from mapanything_tpu_torch.utils.image import RESOLUTION_MAPPINGS, decode_png, load_images
from mapanything_tpu_torch.utils.jpeg import decode_jpeg
from mapanything_tpu_torch.utils.viewer import export_viewer_html

_UPLOAD_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mapanything_tpu_torch live demo</title>
<style>
 body { background:#111; color:#ddd; font:15px sans-serif; max-width:640px;
        margin:60px auto; }
 input, button { font:inherit; margin:8px 0; }
 button { padding:8px 22px; background:#2d6cdf; border:0; color:white;
          border-radius:4px; cursor:pointer; }
 #status { color:#8fb6ff; }
</style></head><body>
<h2>mapanything_tpu_torch &mdash; live metric 3D reconstruction</h2>
<p>Select 2+ images of a scene; the model reconstructs a metric point
cloud with camera poses and opens an orbitable viewer.</p>
<input id="files" type="file" accept="image/*" multiple><br>
<button onclick="go()">Reconstruct</button> <span id="status"></span>
<script>
async function go() {
  const files = document.getElementById("files").files;
  if (files.length < 1) { alert("select images first"); return; }
  document.getElementById("status").textContent =
    "uploading " + files.length + " images + inferring...";
  const images = [];
  for (const f of files) {
    const buf = await f.arrayBuffer();
    images.push(btoa(String.fromCharCode(...new Uint8Array(buf))));
  }
  const resp = await fetch("/infer", {
    method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({images}),
  });
  if (!resp.ok) {
    document.getElementById("status").textContent =
      "error: " + (await resp.text());
    return;
  }
  document.open(); document.write(await resp.text()); document.close();
}
</script></body></html>
"""


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes (PNG or JPEG) -> float32 HWC RGB in [0, 1], the pixels of
    cv2.imdecode(IMREAD_COLOR) + BGR -> RGB; other formats raise ValueError."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        rgb = decode_png(data, name="uploaded PNG")
    elif data[:2] == b"\xff\xd8":
        rgb = decode_jpeg(data)
    else:
        raise ValueError("could not decode image: the live demo reads PNG and JPEG uploads")
    return rgb.astype(np.float32) / 255.0


def make_model_infer_fn(model, resolution: int = 518) -> Callable:
    """Build an infer_fn from a port MapAnything: resizes the upload set to
    its best shared aspect-ratio bucket (a square of ``resolution`` when that
    is not a bucket set), runs images-only metric inference on the model's
    device, returns viewer-ready numpy arrays."""
    lock = threading.Lock()

    def infer_fn(images):
        # The uploads are float in [0, 1]; back to uint8 as the JAX server does (truncating).
        u8 = [(np.clip(im, 0, 1) * 255).astype(np.uint8) for im in images]
        if resolution in RESOLUTION_MAPPINGS:
            loaded = load_images(u8, resolution_set=resolution, device=model.device)
        else:  # test scales: square bucket
            loaded = load_images(u8, resize_mode="square", size=resolution, device=model.device)
        with lock, torch.inference_mode():
            preds = model(Views(img=loaded["images"][None]))
            mask = preds.non_ambiguous_mask
            poses = None
            if preds.cam_quats is not None:
                poses = quats_trans_to_pose_matrix(preds.cam_quats[0], preds.cam_trans[0]).float().cpu().numpy()
            return {
                "points": preds.pts3d[0].float().cpu().numpy(),
                "colors": loaded["images_no_norm"].cpu().numpy(),
                "mask": None if mask is None else mask[0].cpu().numpy(),
                "camera_poses": poses,
                "intrinsics": None,
            }

    return infer_fn


def build_viewer_html(result: Dict, title: str = "live reconstruction") -> str:
    """Render an infer_fn result with the standalone WebGL viewer."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/viewer.html"
        export_viewer_html(
            path,
            points=result["points"],
            colors=result.get("colors"),
            camera_poses=result.get("camera_poses"),
            intrinsics=result.get("intrinsics"),
            mask=result.get("mask"),
            title=title,
        )
        with open(path) as f:
            return f.read()


class LiveDemoHandler(BaseHTTPRequestHandler):
    """GET / -> upload page; POST /infer -> viewer html."""

    infer_fn: Optional[Callable] = None  # injected via make_server

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        if self.path not in ("/", "/index.html"):
            self.send_error(404)
            return
        body = _UPLOAD_PAGE.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        if self.path != "/infer":
            self.send_error(404)
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(n))
            images = [
                decode_image(base64.b64decode(b)) for b in payload["images"]
            ]
            if not images:
                raise ValueError("no images")
            result = type(self).infer_fn(images)
            html = build_viewer_html(
                result, title=f"live reconstruction ({len(images)} views)"
            ).encode()
        except Exception as e:  # surface errors to the page
            msg = f"inference failed: {e}".encode()
            self.send_response(500)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(msg)))
            self.end_headers()
            self.wfile.write(msg)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(html)))
        self.end_headers()
        self.wfile.write(html)


def make_server(infer_fn: Callable, port: int = 8008, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Bind the live demo server (call .serve_forever() to run); port 0 takes
    a free one (``server.server_address[1]``)."""
    handler = type("Handler", (LiveDemoHandler,), {"infer_fn": staticmethod(infer_fn)})
    return ThreadingHTTPServer((host, port), handler)
