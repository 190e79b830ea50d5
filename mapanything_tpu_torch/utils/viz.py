"""Point-cloud export of the port: binary PLY and glTF 2.0 binary (GLB).

A copy of ``write_ply_pointcloud``, ``write_glb_pointcloud`` and
``predictions_to_glb`` of ``mapanything_tpu/utils/viz.py`` (:19-120), numpy
only. They take ``InferenceOutputs`` fields as numpy arrays (``.cpu().numpy()``
of the tensors ``infer`` returns) and write the same bytes as the JAX package.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np


def write_ply_pointcloud(path, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Binary little-endian PLY pointcloud (points (N, 3), colors [0,1] (N, 3))."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rgb8 = (np.clip(np.asarray(colors).reshape(-1, 3), 0, 1) * 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = rgb8
            f.write(rec.tobytes())
        else:
            f.write(points.tobytes())


def write_glb_pointcloud(path, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Minimal glTF 2.0 binary (.glb) pointcloud, POINTS primitive.

    Parity target: ``predictions_to_glb`` (reference viz.py:204) without the
    trimesh dependency.
    """
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    pos_bytes = points.tobytes()
    buffers = [pos_bytes]
    accessors = [
        {
            "bufferView": 0,
            "componentType": 5126,  # FLOAT
            "count": n,
            "type": "VEC3",
            "min": points.min(0).tolist(),
            "max": points.max(0).tolist(),
        }
    ]
    buffer_views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)}]
    attributes = {"POSITION": 0}

    if colors is not None:
        col = np.clip(np.asarray(colors, np.float32).reshape(-1, 3), 0, 1)
        col_bytes = col.astype(np.float32).tobytes()
        buffer_views.append(
            {"buffer": 0, "byteOffset": len(pos_bytes), "byteLength": len(col_bytes)}
        )
        accessors.append(
            {"bufferView": 1, "componentType": 5126, "count": n, "type": "VEC3"}
        )
        attributes["COLOR_0"] = 1
        buffers.append(col_bytes)

    bin_chunk = b"".join(buffers)
    pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\x00" * pad

    gltf = {
        "asset": {"version": "2.0", "generator": "mapanything_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "mode": 0}]}],
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    json_chunk = json.dumps(gltf).encode()
    json_chunk += b" " * ((-len(json_chunk)) % 4)

    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))  # glTF magic
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))  # JSON
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))  # BIN
        f.write(bin_chunk)


def predictions_to_glb(
    path,
    pts3d: np.ndarray,
    colors: np.ndarray,
    mask: Optional[np.ndarray] = None,
    max_points: int = 1_000_000,
):
    """Export masked dense predictions as a GLB pointcloud (viz.py:204)."""
    pts = np.asarray(pts3d).reshape(-1, 3)
    col = np.asarray(colors).reshape(-1, 3)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        pts, col = pts[m], col[m]
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, col = pts[sel], col[sel]
    write_glb_pointcloud(path, pts, col)
