"""A self-contained interactive 3D viewer: one HTML file, no dependencies.

Counterpart of ``mapanything_tpu/utils/viewer.py``: ``export_viewer_html``
(:160) writes one html file that embeds the points, their colours and the
camera frusta, with an inline WebGL orbit viewer; ``_frustum_corners`` (:145);
``serve`` (:236) hosts it with the standard library's http server. numpy, json
and base64 only: on the same arrays the file's bytes are the JAX function's.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mapanything_tpu viewer</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif; overflow:hidden; }}
 #hud {{ position:fixed; top:8px; left:10px; z-index:2; user-select:none; }}
 canvas {{ display:block; width:100vw; height:100vh; }}
</style></head>
<body>
<div id="hud">{title} &mdash; {n_points} pts &middot; drag: orbit &middot; shift-drag: pan &middot; wheel: zoom &middot; [c] cameras</div>
<canvas id="c"></canvas>
<script>
const PTS = Uint8Array.from(atob("{pts_b64}"), ch => ch.charCodeAt(0)).buffer;
const COL = Uint8Array.from(atob("{col_b64}"), ch => ch.charCodeAt(0)).buffer;
const CAMS = {cams_json};
const N = {n_points};

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
 uniform float psize; varying vec3 vc;
 void main() {{ gl_Position = mvp * vec4(p, 1.0); gl_PointSize = psize / max(gl_Position.w, 0.1); vc = col; }}`;
const fs = `precision mediump float; varying vec3 vc;
 void main() {{ gl_FragColor = vec4(vc, 1.0); }}`;
function shader(type, src) {{ const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s); return s; }}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);

function buf(data, loc, ncomp, type, normed) {{
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribPointer(loc, ncomp, type, normed, 0, 0);
  return b;
}}
const locP = gl.getAttribLocation(prog, "p");
const locC = gl.getAttribLocation(prog, "col");
const bufP = buf(PTS, locP, 3, gl.FLOAT, false);
const bufC = buf(COL, locC, 3, gl.UNSIGNED_BYTE, true);
// camera frusta as line segments
let camBufP = null, camBufC = null, nCamVerts = 0, showCams = true;
if (CAMS.length) {{
  const lp = [], lc = [];
  for (const cam of CAMS) {{
    const o = cam.o;
    for (const corner of cam.f) {{
      lp.push(...o, ...corner);
      lc.push(255,180,0, 255,180,0);
    }}
    for (let i = 0; i < 4; i++) {{
      lp.push(...cam.f[i], ...cam.f[(i+1)%4]);
      lc.push(255,180,0, 255,180,0);
    }}
  }}
  nCamVerts = lp.length / 3;
  camBufP = new Float32Array(lp); camBufC = new Uint8Array(lc);
}}
const glCamP = gl.createBuffer(), glCamC = gl.createBuffer();
if (nCamVerts) {{
  gl.bindBuffer(gl.ARRAY_BUFFER, glCamP); gl.bufferData(gl.ARRAY_BUFFER, camBufP, gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, glCamC); gl.bufferData(gl.ARRAY_BUFFER, camBufC, gl.STATIC_DRAW);
}}

let theta = -0.6, phi = 0.3, dist = {init_dist}, cx = {cx}, cy = {cy}, cz = {cz};
let panX = 0, panY = 0;
function mat() {{
  const aspect = canvas.width / canvas.height;
  const f = 1.4, near = 0.01, far = 1e4;
  const P = [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];
  const ct = Math.cos(theta), st = Math.sin(theta), cp = Math.cos(phi), sp = Math.sin(phi);
  // camera position on orbit sphere (y-down scene: flip)
  const ex = cx + dist*st*cp, ey = cy - dist*sp, ez = cz - dist*ct*cp;
  const fwd = norm3([cx-ex, cy-ey, cz-ez]);
  const right = norm3(cross(fwd, [0,-1,0]));
  const up = cross(right, fwd);
  const e = [ex + right[0]*panX + up[0]*panY, ey + right[1]*panX + up[1]*panY, ez + right[2]*panX + up[2]*panY];
  const V = [right[0],up[0],-fwd[0],0, right[1],up[1],-fwd[1],0, right[2],up[2],-fwd[2],0,
             -(right[0]*e[0]+right[1]*e[1]+right[2]*e[2]),
             -(up[0]*e[0]+up[1]*e[1]+up[2]*e[2]),
             (fwd[0]*e[0]+fwd[1]*e[1]+fwd[2]*e[2]), 1];
  return mul4(P, V);
}}
function cross(a,b) {{ return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]]; }}
function norm3(v) {{ const l = Math.hypot(...v) || 1; return [v[0]/l, v[1]/l, v[2]/l]; }}
function mul4(a,b) {{
  const o = new Array(16).fill(0);
  for (let i=0;i<4;i++) for (let j=0;j<4;j++) for (let k=0;k<4;k++) o[j*4+i] += a[k*4+i]*b[j*4+k];
  return o;
}}
function draw() {{
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.066, 0.066, 0.066, 1); gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog, "mvp"), false, new Float32Array(mat()));
  gl.uniform1f(gl.getUniformLocation(prog, "psize"), {point_size});
  gl.bindBuffer(gl.ARRAY_BUFFER, bufP); gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, bufC); gl.vertexAttribPointer(locC, 3, gl.UNSIGNED_BYTE, true, 0, 0);
  gl.drawArrays(gl.POINTS, 0, N);
  if (nCamVerts && showCams) {{
    gl.bindBuffer(gl.ARRAY_BUFFER, glCamP); gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, glCamC); gl.vertexAttribPointer(locC, 3, gl.UNSIGNED_BYTE, true, 0, 0);
    gl.drawArrays(gl.LINES, 0, nCamVerts);
  }}
  requestAnimationFrame(draw);
}}
let drag = false, pan = false, lx = 0, ly = 0;
canvas.addEventListener("mousedown", e => {{ drag = true; pan = e.shiftKey; lx = e.clientX; ly = e.clientY; }});
addEventListener("mouseup", () => drag = false);
addEventListener("mousemove", e => {{
  if (!drag) return;
  const dx = e.clientX - lx, dy = e.clientY - ly; lx = e.clientX; ly = e.clientY;
  if (pan) {{ panX -= dx * dist * 0.002; panY += dy * dist * 0.002; }}
  else {{ theta += dx * 0.006; phi = Math.min(1.5, Math.max(-1.5, phi + dy * 0.006)); }}
}});
addEventListener("wheel", e => {{ dist *= Math.exp(e.deltaY * 0.001); }});
addEventListener("keydown", e => {{ if (e.key === "c") showCams = !showCams; }});
draw();
</script></body></html>
"""


def _frustum_corners(c2w: np.ndarray, K: Optional[np.ndarray], scale: float):
    """Four image-corner rays at unit-ish depth, in world frame."""
    if K is None:
        corners_cam = np.array(
            [[-0.5, -0.35, 1], [0.5, -0.35, 1], [0.5, 0.35, 1], [-0.5, 0.35, 1]]
        )
    else:
        w, h = K[0, 2] * 2, K[1, 2] * 2
        pix = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64)
        corners_cam = pix @ np.linalg.inv(K).T
    corners_cam = corners_cam / np.abs(corners_cam[:, 2:3]) * scale
    R, t = c2w[:3, :3], c2w[:3, 3]
    return (corners_cam @ R.T + t).tolist()


def export_viewer_html(
    out_path,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    camera_poses: Optional[Sequence[np.ndarray]] = None,
    intrinsics: Optional[Sequence[np.ndarray]] = None,
    mask: Optional[np.ndarray] = None,
    max_points: int = 1_500_000,
    point_size: float = 3.0,
    title: str = "reconstruction",
) -> Path:
    """Write a standalone interactive viewer for a point cloud.

    Args:
        points: (N, 3) or (..., 3) world points.
        colors: matching RGB in [0, 1] or uint8; grey if None.
        camera_poses: optional list/array of 4x4 OpenCV cam2world matrices,
            drawn as frusta.
        mask: optional boolean validity with points' leading shape.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is not None:
        col = np.asarray(colors).reshape(-1, 3)
        col = (
            col.astype(np.uint8)
            if col.dtype == np.uint8
            else np.clip(col * 255.0, 0, 255).astype(np.uint8)
        )
    else:
        col = np.full_like(pts, 180, dtype=np.uint8)
    if mask is not None:
        m = np.asarray(mask, bool).reshape(-1)
        pts, col = pts[m], col[m]
    finite = np.isfinite(pts).all(axis=1)
    pts, col = pts[finite], col[finite]
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts, col = pts[sel], col[sel]

    center = np.median(pts, axis=0) if len(pts) else np.zeros(3)
    spread = (
        float(np.percentile(np.linalg.norm(pts - center, axis=1), 90))
        if len(pts)
        else 1.0
    )

    cams = []
    if camera_poses is not None:
        for i, pose in enumerate(np.asarray(camera_poses).reshape(-1, 4, 4)):
            K = None
            if intrinsics is not None:
                K = np.asarray(intrinsics).reshape(-1, 3, 3)[i]
            cams.append(
                {
                    "o": pose[:3, 3].tolist(),
                    "f": _frustum_corners(pose, K, scale=spread * 0.12),
                }
            )

    html = _HTML_TEMPLATE.format(
        title=title,
        n_points=len(pts),
        pts_b64=base64.b64encode(np.ascontiguousarray(pts).tobytes()).decode(),
        col_b64=base64.b64encode(np.ascontiguousarray(col).tobytes()).decode(),
        cams_json=json.dumps(cams),
        init_dist=round(max(spread * 2.5, 1e-3), 5),
        cx=round(float(center[0]), 5),
        cy=round(float(center[1]), 5),
        cz=round(float(center[2]), 5),
        point_size=point_size,
    )
    out_path = Path(out_path)
    out_path.write_text(html)
    return out_path


def serve(path, port: int = 8008):
    """Host a directory (or one html file) with the stdlib http server."""
    import functools
    import http.server

    path = Path(path)
    directory = str(path if path.is_dir() else path.parent)
    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=directory
    )
    with http.server.ThreadingHTTPServer(("0.0.0.0", port), handler) as srv:
        print(f"serving {directory} at http://localhost:{port}/")
        srv.serve_forever()
