"""Mesh rendering of WAI scenes: depth / face-id / colour from triangle meshes, on the card.

Counterpart of ``mapanything_tpu/data_processing/rendering.py`` (:1-418),
after the reference's ``data_processing/wai_processing/scripts/run_rendering.py``
(:101-279, 277-419): scenes that ship a reconstruction mesh get
``rendered_depth`` (EXR), ``rendered_image`` (PNG, vertex colours) and
``rendered_mesh_faces`` (face-id npz) frame modalities, rendered from the
scene mesh at each frame's camera (OpenCV convention, +z forward).

A two-pass z-buffer rasterizer, as in the JAX package:

  pass 1: coverage by edge functions at the pixel centres, with a
    perspective-correct depth; the z-buffer keeps the nearest triangle and,
    on equal depth, the lowest face id. The JAX package streams triangle
    chunks (``lax.scan``, strict ``<`` across chunks, first-index argmin
    within one) against pixel tiles (``lax.map``), which is the same order.
    Here each live triangle is binned to the pixels of its bounding box (one
    pixel of margin), every (triangle, pixel) pair is tested in batched
    tensor ops with the JAX package's float32 arithmetic, and the pairs that
    cover a pixel are reduced by two scatter-mins: the depth, then the face id
    among the pairs at that depth. No per-tile loop: a frame takes a few
    dozen launches, not ~10^5.
  pass 2: per-pixel perspective-correct vertex-colour shading of the winning
    face (barycentrics recomputed, weights 1/z).

Triangles with a vertex behind the near plane are discarded, as there.
Runs on ``device``, CUDA unless the caller names another.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from mapanything_tpu_torch.data import wai as wai_io
from mapanything_tpu_torch.models.mapanything import resolve_device
from mapanything_tpu_torch.utils.exr import write_depth_exr
from mapanything_tpu_torch.utils.image import write_png


# ---------------------------------------------------------------------------
# Minimal PLY mesh IO (trimesh is not available in this environment)
# ---------------------------------------------------------------------------


def read_ply_mesh(path) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Read a PLY triangle mesh -> (vertices (V, 3) f32, faces (T, 3) i32,
    colors (V, 3) f32 in [0, 1] or None). Supports ascii and
    binary_little_endian, the formats our PLY writer and common WAI scene
    meshes use; quads are fan-triangulated. (The JAX package's reader takes a
    binary face list's count and index types from the wrong fields and raises
    ``KeyError``; here they are the list's own, and an all-triangle face block
    is read in one piece.)"""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) or list-marker])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            parts = line.strip().split()
            if not parts:
                continue
            tag = parts[0]
            if tag == b"format":
                fmt = parts[1].decode()
            elif tag == b"element":
                elements.append([parts[1].decode(), int(parts[2]), []])
            elif tag == b"property":
                if parts[1] == b"list":
                    elements[-1][2].append(
                        ("list", parts[2].decode(), parts[3].decode(),
                         parts[4].decode())
                    )
                else:
                    elements[-1][2].append(
                        ("scalar", parts[1].decode(), parts[2].decode())
                    )
            elif tag == b"end_header":
                break

        np_types = {
            "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        }

        verts = faces = colors = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
            if name == "vertex":
                scalar_names = [p[2] for p in props if p[0] == "scalar"]
                if fmt == "ascii":
                    data = np.array(
                        [[float(v) for v in r] for r in rows], np.float64
                    )
                else:
                    dt = np.dtype(
                        [(p[2], "<" + np_types[p[1]]) for p in props]
                    )
                    raw = np.frombuffer(f.read(dt.itemsize * count), dt)
                    data = np.stack(
                        [raw[n].astype(np.float64) for n in scalar_names], 1
                    )
                idx = {n: i for i, n in enumerate(scalar_names)}
                verts = data[:, [idx["x"], idx["y"], idx["z"]]].astype(
                    np.float32
                )
                if "red" in idx:
                    colors = data[
                        :, [idx["red"], idx["green"], idx["blue"]]
                    ].astype(np.float32)
                    if colors.max() > 1.0:
                        colors = colors / 255.0
            elif name == "face":
                tris = []
                if fmt == "ascii":
                    for r in rows:
                        n = int(r[0])
                        poly = [int(v) for v in r[1 : 1 + n]]
                        for k in range(1, n - 1):
                            tris.append([poly[0], poly[k], poly[k + 1]])
                else:
                    # ("list", count type, index type, name)
                    cnt_t = "<" + np_types[props[0][1]]
                    idx_t = "<" + np_types[props[0][2]]
                    cnt_sz = np.dtype(cnt_t).itemsize
                    idx_sz = np.dtype(idx_t).itemsize
                    start = f.tell()
                    tri_dt = np.dtype([("n", cnt_t), ("idx", idx_t, (3,))])
                    block = np.frombuffer(f.read(tri_dt.itemsize * count), tri_dt)
                    if len(block) == count and np.all(block["n"] == 3):  # all triangles
                        tris = block["idx"]
                    else:
                        f.seek(start)
                        for _ in range(count):
                            n = int(np.frombuffer(f.read(cnt_sz), cnt_t)[0])
                            poly = np.frombuffer(f.read(idx_sz * n), idx_t)
                            for k in range(1, n - 1):
                                tris.append(
                                    [int(poly[0]), int(poly[k]), int(poly[k + 1])]
                                )
                faces = np.asarray(tris, np.int32).reshape(-1, 3)
        if verts is None or faces is None:
            raise ValueError(f"PLY missing vertex/face elements: {path}")
        return verts, faces, colors




# ---------------------------------------------------------------------------
# Rasterizer
# ---------------------------------------------------------------------------


def _edge(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (p[..., 0] - a[..., 0]) * (b[..., 1] - a[..., 1]) - (p[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0])


def _covering_pairs(tri_uv: torch.Tensor, tri_z: torch.Tensor, H: int, W: int, far: float, max_pairs: int):
    """Every (pixel, depth, face) with the pixel centre inside the face: the
    flat pixel index (int64), the perspective-correct depth and the face id
    (int64), over the faces' bounding boxes in batches of ``max_pairs`` pairs."""
    device = tri_uv.device
    a, b, c = tri_uv[:, 0], tri_uv[:, 1], tri_uv[:, 2]
    area = _edge(a, b, c)
    live = torch.all(tri_z > 0, dim=1) & (torch.abs(area) > 1e-12)
    lo = torch.floor(tri_uv.amin(dim=1)) - 1
    hi = torch.ceil(tri_uv.amax(dim=1)) + 1
    size = tri_uv.new_tensor([W - 1, H - 1])
    lo = torch.maximum(lo, torch.zeros_like(lo))
    hi = torch.minimum(hi, size)
    extent = torch.clamp(hi - lo + 1, min=0)
    extent = torch.where(live[:, None] & torch.isfinite(extent), extent, torch.zeros_like(extent))
    nx, ny = extent[:, 0].to(torch.int64), extent[:, 1].to(torch.int64)
    counts = nx * ny
    ids = torch.nonzero(counts).flatten()
    ends = torch.cumsum(counts[ids], 0)
    out = []
    start = 0
    while start < ids.numel():  # batches of whole faces
        stop = int(torch.searchsorted(ends, ends[start] - counts[ids[start]] + max_pairs, right=True))
        stop = max(stop, start + 1)
        faces = ids[start:stop]
        n = counts[faces]
        face = torch.repeat_interleave(faces, n)
        first = torch.cumsum(n, 0) - n
        k = torch.arange(face.numel(), device=device) - torch.repeat_interleave(first, n)
        x = lo[face, 0].to(torch.int64) + k % nx[face]
        y = lo[face, 1].to(torch.int64) + k // nx[face]
        p = torch.stack([x, y], -1).to(torch.float32)
        fa, fb, fc = a[face], b[face], c[face]
        w0, w1, w2 = _edge(fb, fc, p), _edge(fc, fa, p), _edge(fa, fb, p)
        ar = area[face]
        s = torch.sign(ar)
        inside = (w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0)
        inv_area = 1.0 / ar
        z = tri_z[face]
        inv_z = (w0 * inv_area) / z[:, 0] + (w1 * inv_area) / z[:, 1] + (w2 * inv_area) / z[:, 2]
        z_px = torch.where(inv_z > 1e-12, 1.0 / inv_z, torch.full_like(inv_z, float("inf")))
        keep = inside & (z_px <= far)
        out.append((y[keep] * W + x[keep], z_px[keep], face[keep]))
        start = stop
    if not out:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, torch.zeros(0, device=device), empty
    return tuple(torch.cat(parts) for parts in zip(*out))


def _raster_pass1(tri_uv: torch.Tensor, tri_z: torch.Tensor, H: int, W: int, far: float,
                  max_pairs: int = 1 << 24) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z-buffer coverage. tri_uv (T, 3, 2) screen coords, tri_z (T, 3) camera z
    (<= 0 marks an invalid or behind-near vertex). Depth (H, W) (inf where no
    face covers a pixel) and face ids (H, W) int32 (-1): the nearest face,
    the lowest id on equal depth."""
    pix, z, face = _covering_pairs(tri_uv, tri_z, H, W, far, max_pairs)
    best_z = torch.full((H * W,), float("inf"), device=tri_uv.device)
    best_z.scatter_reduce_(0, pix, z, "amin")
    at_best = z == best_z[pix]
    best_f = torch.full((H * W,), tri_uv.shape[0], dtype=torch.int64, device=tri_uv.device)
    best_f.scatter_reduce_(0, pix[at_best], face[at_best], "amin")
    best_f = torch.where(torch.isfinite(best_z), best_f, torch.full_like(best_f, -1))
    return best_z.reshape(H, W), best_f.to(torch.int32).reshape(H, W)


def _shade_pass2(tri_uv: torch.Tensor, tri_z: torch.Tensor, tri_rgb: torch.Tensor,
                 face_id: torch.Tensor) -> torch.Tensor:
    """Perspective-correct vertex-colour interpolation of the winning faces."""
    H, W = face_id.shape
    fid = torch.clamp(face_id, min=0).to(torch.int64)
    uv, z, rgb = tri_uv[fid], tri_z[fid], tri_rgb[fid]  # (H, W, 3, 2), (H, W, 3), (H, W, 3, 3)
    ys = torch.arange(H, dtype=torch.float32, device=uv.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=uv.device)[None, :].expand(H, W)
    p = torch.stack([xs, ys], -1)
    w0 = _edge(uv[..., 1, :], uv[..., 2, :], p)
    w1 = _edge(uv[..., 2, :], uv[..., 0, :], p)
    w2 = _edge(uv[..., 0, :], uv[..., 1, :], p)
    area = _edge(uv[..., 0, :], uv[..., 1, :], uv[..., 2, :])
    inv_area = torch.where(torch.abs(area) > 1e-12, 1.0 / area, torch.zeros_like(area))
    bary = torch.stack([w0, w1, w2], -1) * inv_area[..., None]
    wz = bary / torch.clamp(z, min=1e-8)
    col = sum(wz[..., k, None] * rgb[..., k, :] for k in range(3)) / torch.clamp(wz.sum(-1, keepdim=True), min=1e-12)
    return torch.where((face_id >= 0)[..., None], col, torch.zeros_like(col))


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    c2w: np.ndarray,
    H: int,
    W: int,
    vertex_colors: Optional[np.ndarray] = None,
    near: float = 0.01,
    far: float = 1000.0,
    device: Union[str, torch.device, None] = None,
):
    """Render one frame: depth (H, W), face ids (H, W), colour or None (numpy).

    OpenCV pinhole camera (c2w cam2world, +z forward). Invalid pixels:
    depth 0, face id -1. The projection runs on the host in float64, as in
    the JAX package; the rasterizer on ``device`` (CUDA unless given).
    """
    device = resolve_device(device)
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    cam = vertices @ w2c[:3, :3].T + w2c[:3, 3]
    uvw = cam @ np.asarray(K, np.float64).T
    z = cam[:, 2]
    safe_z = np.where(np.abs(z) < 1e-8, 1e-8, z)
    u = uvw[:, 0] / safe_z
    v = uvw[:, 1] / safe_z
    tri_uv = np.stack([u[faces], v[faces]], -1).astype(np.float32)  # (T, 3, 2)
    tri_z = z[faces].astype(np.float32)
    tri_z = np.where(tri_z < near, -1.0, tri_z).astype(np.float32)  # behind the near plane: rejected

    with torch.inference_mode():
        uv_t, z_t = torch.from_numpy(tri_uv).to(device), torch.from_numpy(tri_z).to(device)
        depth, face_id = _raster_pass1(uv_t, z_t, H, W, float(far))
        color = None
        if vertex_colors is not None:
            tri_rgb = torch.from_numpy(vertex_colors[faces].astype(np.float32)).to(device)
            col = _shade_pass2(uv_t, torch.clamp(z_t, min=1e-8), tri_rgb, face_id)
            color = torch.clamp(col, 0.0, 1.0).cpu().numpy()
        depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth)).cpu().numpy()
        return depth, face_id.cpu().numpy(), color


def render_scene_frames(
    scene_root,
    mesh_name: str = "mesh",
    modalities: Tuple[str, ...] = ("rendered_depth",),
    near: float = 0.01,
    far: float = 1000.0,
    device: Union[str, torch.device, None] = None,
) -> List[str]:
    """Render the scene mesh at every frame camera and register the WAI
    modalities (reference run_rendering.py:277-419 layout)."""
    device = resolve_device(device)
    scene_root = Path(scene_root)
    meta = wai_io.load_scene_meta(scene_root)
    sm = meta.get("scene_modalities", {})
    if mesh_name not in sm:
        raise ValueError(f"scene has no '{mesh_name}' scene modality")
    entry = sm[mesh_name]
    mesh_rel = entry["scene_key"] if isinstance(entry, dict) else entry
    verts, tris, colors = read_ply_mesh(scene_root / mesh_rel)

    done = []
    for fr in meta["frames"]:
        K = wai_io.get_intrinsics(meta, fr)
        c2w = wai_io.get_extrinsics(fr)
        src = fr if "w" in fr else meta
        H, W = int(src["h"]), int(src["w"])
        want_color = "rendered_image" in modalities and colors is not None
        depth, face_id, color = render_mesh(verts, tris, K, c2w, H, W, vertex_colors=colors if want_color else None,
                                            near=near, far=far, device=device)
        name = fr["frame_name"]
        if "rendered_depth" in modalities:
            rel = f"rendered_depth/{name}.exr"
            (scene_root / "rendered_depth").mkdir(exist_ok=True)
            write_depth_exr(scene_root / rel, depth)
            fr["rendered_depth"] = rel
        if "rendered_mesh_faces" in modalities:
            rel = f"rendered_mesh_faces/{name}.npz"
            (scene_root / "rendered_mesh_faces").mkdir(exist_ok=True)
            np.savez_compressed(scene_root / rel, face_id=face_id)
            fr["rendered_mesh_faces"] = rel
        if want_color:
            rel = f"rendered_image/{name}.png"
            (scene_root / "rendered_image").mkdir(exist_ok=True)
            write_png(scene_root / rel, (color * 255).astype(np.uint8))
            fr["rendered_image"] = rel
        done.append(name)

    fm = meta.setdefault("frame_modalities", {})
    if "rendered_depth" in modalities:
        fm["rendered_depth"] = {"frame_key": "rendered_depth", "format": "depth"}
    if "rendered_mesh_faces" in modalities:
        fm["rendered_mesh_faces"] = {"frame_key": "rendered_mesh_faces", "format": "numpy"}
    if "rendered_image" in modalities and colors is not None:
        fm["rendered_image"] = {"frame_key": "rendered_image", "format": "image"}
    with open(scene_root / "scene_meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return done


def write_ply_mesh(path, vertices: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray] = None) -> Path:
    """Write a binary little-endian PLY triangle mesh that ``read_ply_mesh``
    reads: float32 x, y, z, uchar red, green, blue (``colors`` in [0, 1]), and
    faces as uchar-counted int32 index lists."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    vert = np.empty(len(vertices), np.dtype(props))
    for i, axis in enumerate("xyz"):
        vert[axis] = vertices[:, i]
    if colors is not None:
        rgb = np.clip(np.round(np.asarray(colors) * 255.0), 0, 255).astype(np.uint8)
        for i, channel in enumerate(("red", "green", "blue")):
            vert[channel] = rgb[:, i]
    face = np.empty(len(faces), np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
    face["n"], face["idx"] = 3, faces
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(vertices)}"]
    header += [f"property {'float' if dt == '<f4' else 'uchar'} {name}" for name, dt in props]
    header += [f"element face {len(faces)}", "property list uchar int vertex_indices", "end_header"]
    path = Path(path)
    path.write_bytes(("\n".join(header) + "\n").encode() + vert.tobytes() + face.tobytes())
    return path
