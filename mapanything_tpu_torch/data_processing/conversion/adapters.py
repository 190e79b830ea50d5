"""Per-dataset raw->WAI adapters (15 datasets).

Counterpart of ``mapanything_tpu/data_processing/conversion/adapters.py``
(:1-837), after the reference's ``data_processing/wai_processing/scripts/
conversion/{ase,blendedmvs,co3d,dl3dv,dynamicreplica,eth3d,megadepth,mpsd,
mvs_synth,paralleldomain4d,sailvos3d,scannetppv2,spring,tav2_wb,
unrealstereo4k}.py``. Each adapter encodes the *raw layout and camera
conventions* documented in the corresponding reference converter; all
writing is shared (see ``core.py``).

Every adapter produces OpenCV-convention cam2world poses, pixel-space
pinhole intrinsics and metric z-depth (0 = invalid), which is exactly
the contract ``mapanything_tpu_torch.data.wai`` reads back.

Where the JAX package decodes with cv2, PIL or PyYAML, the port uses its own
readers: image sizes from the PNG and JPEG headers (``_image_size``), MPSD's
frames through ``utils/image.read_png`` and ``utils/jpeg.read_jpeg``,
SAILVOS3D's camera files through ``utils/yaml_subset``. MPSD's ``INTER_AREA``
resize (when an RGB frame is larger than its depth) and the sizes of other
image formats import cv2 only then, through ``utils/image._needs``. Host code.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np

from mapanything_tpu_torch.data_processing.conversion.core import (
    DatasetAdapter,
    RawFrame,
)
from mapanything_tpu_torch.data_processing.conversion import formats as F
from mapanything_tpu_torch.utils.image import _needs, read_png
from mapanything_tpu_torch.utils.jpeg import read_jpeg

# JPEG start-of-frame markers (baseline, extended, progressive, lossless and the
# arithmetic-coded ones): their segment holds the image's height and width.
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _image_size(path) -> tuple:
    """(H, W) of an image file from its header (PNG's IHDR, JPEG's start of
    frame) without decoding pixels, the stored size as the JAX package reads it
    (no EXIF rotation); other formats are decoded through cv2."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return int(h), int(w)
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    raise ValueError(f"{path}: no JPEG start-of-frame segment")
                if marker[1] == 0xFF:  # fill byte
                    f.seek(-1, 1)
                    continue
                if marker[1] == 0x01 or 0xD0 <= marker[1] <= 0xD7:  # no length
                    continue
                (length,) = struct.unpack(">H", f.read(2))
                if marker[1] in _JPEG_SOF:
                    _, h, w = struct.unpack(">BHH", f.read(5))
                    return int(h), int(w)
                f.seek(length - 2, 1)
    cv2 = _needs("cv2", f"{path}: {path.suffix.lstrip('.').upper() or 'an image without a suffix'}")
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img.shape[0], img.shape[1]


def _natsorted(names):
    import re

    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(s))]

    return sorted(names, key=key)


def _subdirs(root: Path) -> List[str]:
    return _natsorted(
        [d.name for d in Path(root).iterdir() if d.is_dir()]
    ) if Path(root).is_dir() else []


# ---------------------------------------------------------------------------


class BlendedMVSAdapter(DatasetAdapter):
    """Reference conversion/blendedmvs.py: PFM depth + COLMAP-style cam.txt
    (4x4 world2cam then 3x3 K), images in blended_images/."""

    name = "blendedmvs"
    scale_type = "colmap"

    def list_scenes(self, raw_root):
        return [s for s in _subdirs(raw_root) if (raw_root / s / "cams").is_dir()]

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        names = _natsorted(
            f[:-8] for f in os.listdir(scene / "cams") if not f.startswith("pair")
        )
        for n in names:
            with open(scene / "cams" / f"{n}_cam.txt") as f:
                lines = [line.strip() for line in f]
            # "extrinsic" header, 4 rows w2c, blank, "intrinsic", 3 rows K
            w2c = np.array(
                [list(map(float, lines[i].split())) for i in range(1, 5)]
            )
            k_start = lines.index("intrinsic") + 1
            K = np.array(
                [list(map(float, lines[k_start + i].split())) for i in range(3)]
            )
            depth = F.read_pfm(scene / "rendered_depth_maps" / f"{n}.pfm")
            yield RawFrame(
                frame_name=n,
                image=scene / "blended_images" / f"{n}.jpg",
                size_hw=depth.shape,
                depth=depth.astype(np.float32),
                intrinsics=K,
                cam2world=F.w2c_to_c2w(w2c),
            )


class MVSSynthAdapter(DatasetAdapter):
    """Reference conversion/mvs_synth.py: EXR depth (sky=inf -> 0),
    per-frame pose json with left-handed RUF w2c extrinsic; everything
    divided by 10 to be metric."""

    name = "mvs_synth"

    def list_scenes(self, raw_root):
        return [s for s in _subdirs(raw_root) if (raw_root / s / "poses").is_dir()]

    def iter_frames(self, raw_root, scene_name):
        from mapanything_tpu_torch.data.wai import load_depth

        scene = Path(raw_root) / scene_name
        for img in _natsorted(os.listdir(scene / "images")):
            if not img.endswith(".png"):
                continue
            n = img[:-4]
            depth = load_depth(scene / "depths" / f"{n}.exr")
            depth = np.where(np.isinf(depth), 0.0, depth) / 10.0
            with open(scene / "poses" / f"{n}.json") as f:
                cam = json.load(f)
            K = np.array(
                [
                    [cam["f_x"], 0, cam["c_x"]],
                    [0, cam["f_y"], cam["c_y"]],
                    [0, 0, 1],
                ]
            ) if "f_x" in cam else np.asarray(cam["intrinsic"], np.float64)
            c2w = F.FLIP_Y @ F.w2c_to_c2w(np.asarray(cam["extrinsic"]))
            c2w[:3, 3] /= 10.0
            yield RawFrame(
                frame_name=n,
                image=scene / "images" / img,
                size_hw=depth.shape,
                depth=depth.astype(np.float32),
                intrinsics=K,
                cam2world=c2w,
            )


class TartanAirV2WBAdapter(DatasetAdapter):
    """Reference conversion/tav2_wb.py: everything precomputed — EXR
    depth, .npy 3x3 K and .npy 4x4 OpenCV cam2world per frame."""

    name = "tav2_wb"

    def list_scenes(self, raw_root):
        return [s for s in _subdirs(raw_root) if (raw_root / s / "poses").is_dir()]

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        for img in _natsorted(os.listdir(scene / "images")):
            if not img.endswith(".png"):
                continue
            n = img[:-4]
            yield RawFrame(
                frame_name=n,
                image=scene / "images" / img,
                size_hw=_image_size(scene / "images" / img),
                depth=scene / "depth" / f"{n}.exr",
                intrinsics=np.load(scene / "camera_params" / f"{n}.npy"),
                cam2world=np.load(scene / "poses" / f"{n}.npy"),
            )


class UnrealStereo4KAdapter(DatasetAdapter):
    """Reference conversion/unrealstereo4k.py: stereo pairs; depth =
    baseline * fx / disparity (invalid >= 10 km), left-handed RUF poses
    flipped to RDF; both cameras emitted as separate frames."""

    name = "unrealstereo4k"

    def list_scenes(self, raw_root):
        return [s for s in _subdirs(raw_root) if (raw_root / s / "Image0").is_dir()]

    @staticmethod
    def _read_cam(path):
        with open(path) as f:
            k_line, e_line = f.read().strip().splitlines()
        K = np.fromstring(k_line, sep=" ").reshape(3, 3)
        w2c = np.eye(4)
        w2c[:3, :] = np.fromstring(e_line, sep=" ").reshape(3, 4)
        return K, w2c

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        for stem in _natsorted(p.stem for p in (scene / "Image0").glob("*.png")):
            K0, w2c0 = self._read_cam(scene / "Extrinsics0" / f"{stem}.txt")
            K1, w2c1 = self._read_cam(scene / "Extrinsics1" / f"{stem}.txt")
            baseline = np.linalg.norm((w2c0 @ F.w2c_to_c2w(w2c1))[:3, 3])
            for cam, K, w2c in (("cam0", K0, w2c0), ("cam1", K1, w2c1)):
                disp = np.load(scene / f"Disp{cam[-1]}" / f"{stem}.npy")
                depth = F.disparity_to_depth(
                    disp, K[0, 0], baseline, max_depth=10000.0
                )
                yield RawFrame(
                    frame_name=f"{stem}_{cam}",
                    image=scene / f"Image{cam[-1]}" / f"{stem}.png",
                    size_hw=depth.shape,
                    depth=depth,
                    intrinsics=K,
                    cam2world=F.FLIP_Y @ F.w2c_to_c2w(w2c),
                )


class SpringAdapter(DatasetAdapter):
    """Reference conversion/spring.py: .dsp5 disparity subsampled 2x ->
    metric depth via fx * 0.065 m baseline; per-frame intrinsics rows;
    left w2c extrinsics (train only), right camera offset by the
    baseline along x; sky masks forwarded as binary masks."""

    name = "spring"
    BASELINE = 0.065

    def list_scenes(self, raw_root):
        out = []
        for split in ("train", "test"):
            for s in _subdirs(Path(raw_root) / split):
                out.append(f"{split}/{s}")
        return out

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        intr = np.loadtxt(scene / "cam_data" / "intrinsics.txt", ndmin=2)
        extr_path = scene / "cam_data" / "extrinsics.txt"
        w2cs = (
            np.loadtxt(extr_path).reshape(-1, 4, 4) if extr_path.exists() else None
        )
        frames = _natsorted(os.listdir(scene / "frame_left"))
        for idx, fname in enumerate(frames):
            num = Path(fname).stem.split("_")[-1]
            fx, fy, cx, cy = intr[min(idx, len(intr) - 1)]
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
            left_w2c = right_w2c = None
            if w2cs is not None:
                left_w2c = w2cs[idx]
                right_w2c = left_w2c.copy()
                right_w2c[0, 3] -= self.BASELINE
            for side, w2c in (("left", left_w2c), ("right", right_w2c)):
                img = scene / f"frame_{side}" / f"frame_{side}_{num}.png"
                if not img.exists():
                    continue
                disp_path = (
                    scene / f"disp1_{side}" / f"disp1_{side}_{num}.dsp5"
                )
                depth = None
                if disp_path.exists():
                    disp = F.read_dsp5_disparity(disp_path)[::2, ::2]
                    depth = F.disparity_to_depth(disp, K[0, 0], self.BASELINE)
                sky = (
                    scene / "maps" / f"skymap_{side}" / f"skymap_{side}_{num}.png"
                )
                yield RawFrame(
                    frame_name=f"{side}_{num}",
                    image=img,
                    size_hw=_image_size(img),
                    depth=depth,
                    mask=sky if sky.exists() else None,
                    intrinsics=K,
                    cam2world=(
                        F.w2c_to_c2w(w2c) if w2c is not None else np.eye(4)
                    ),
                )


class ETH3DAdapter(DatasetAdapter):
    """Reference conversion/eth3d.py: COLMAP text calibration
    (dslr_calibration_undistorted cameras.txt/images.txt, PINHOLE
    fx fy cx cy, world2cam wxyz quats), undistorted images, EXR ground
    truth depth (pre-undistorted by the reference's step 1; we accept
    .exr or raw 4-byte float binaries at image resolution)."""

    name = "eth3d"

    def list_scenes(self, raw_root):
        return [
            s
            for s in _subdirs(raw_root)
            if (raw_root / s / "dslr_calibration_undistorted").is_dir()
        ]

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        calib = scene / "dslr_calibration_undistorted"
        cams: Dict[int, Dict] = {}
        with open(calib / "cameras.txt") as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                cams[int(parts[0])] = {
                    "wh": (int(parts[2]), int(parts[3])),
                    "params": list(map(float, parts[4:])),
                }
        with open(calib / "images.txt") as f:
            lines = [
                line for line in f if line.strip() and not line.startswith("#")
            ]
        for line in lines[::2]:  # every other line is POINTS2D
            parts = line.split()
            qw, qx, qy, qz, tx, ty, tz = map(float, parts[1:8])
            cam = cams[int(parts[8])]
            img_name = parts[9]
            base = os.path.basename(img_name)
            fx, fy, cx, cy = cam["params"][:4]
            w2c = np.eye(4)
            w2c[:3, :3] = F.quat_wxyz_to_matrix([qw, qx, qy, qz])
            w2c[:3, 3] = [tx, ty, tz]
            img = scene / "images" / "dslr_images_undistorted" / base
            depth_path = (
                scene
                / "ground_truth_depth"
                / "dslr_images_undistorted"
                / (os.path.splitext(base)[0] + ".exr")
            )
            depth = None
            if depth_path.exists():
                depth = depth_path
            else:
                raw = depth_path.with_suffix("")  # ETH3D raw binary (no ext)
                bin_path = (
                    scene / "ground_truth_depth" / "dslr_images" / base
                )
                if bin_path.exists():
                    w, h = cam["wh"]
                    d = np.fromfile(bin_path, "<f4").reshape(h, w)
                    depth = np.where(np.isfinite(d), d, 0.0).astype(np.float32)
                del raw
            yield RawFrame(
                frame_name=os.path.splitext(base)[0],
                image=img,
                size_hw=(cam["wh"][1], cam["wh"][0]),
                depth=depth,
                intrinsics=np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]),
                cam2world=F.w2c_to_c2w(w2c),
            )


class MegaDepthAdapter(DatasetAdapter):
    """Reference conversion/megadepth.py: COLMAP sparse text model under
    sparse/manhattan/<sub>, h5 MVS depth + undistorted images under
    dense<sub>/. Scene names are "<scene>_<sub>". Distortion is dropped
    (dense images are COLMAP-undistorted); depth is up-to-scale."""

    name = "megadepth"
    scale_type = "colmap"

    def list_scenes(self, raw_root):
        out = []
        for s in _subdirs(raw_root):
            for d in _subdirs(Path(raw_root) / s):
                if d.startswith("dense"):
                    out.append(f"{s}_{d[5:]}")
        return out

    def iter_frames(self, raw_root, scene_name):
        import h5py

        from mapanything_tpu_torch.utils import colmap as colmap_io

        scene_id, sub = scene_name.rsplit("_", 1)
        scene = Path(raw_root) / scene_id
        sparse = scene / "sparse" / "manhattan" / sub
        cameras, images, _ = colmap_io.read_model(sparse, ext=".txt")
        dense = scene / f"dense{sub}"
        by_name = {im.name: im for im in images.values()}
        for img_name in _natsorted(os.listdir(dense / "imgs")):
            im = by_name.get(img_name)
            if im is None:
                continue
            cam = cameras[im.camera_id]
            p = np.asarray(cam.params, np.float64)
            if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
                K = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1]])
            else:  # PINHOLE / RADIAL / OPENCV-style: fx fy cx cy first
                K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
            w2c = np.eye(4)
            w2c[:3, :3] = F.quat_wxyz_to_matrix(im.qvec)
            w2c[:3, 3] = im.tvec
            h5_path = dense / "depths" / (os.path.splitext(img_name)[0] + ".h5")
            depth = None
            if h5_path.exists():
                with h5py.File(h5_path, "r") as hf:
                    depth = np.asarray(hf["depth"], np.float32)
                depth = np.where(depth > 0, depth, 0.0)
            yield RawFrame(
                frame_name=os.path.splitext(img_name)[0],
                image=dense / "imgs" / img_name,
                size_hw=(
                    depth.shape if depth is not None
                    else _image_size(dense / "imgs" / img_name)
                ),
                depth=depth,
                intrinsics=K,
                cam2world=F.w2c_to_c2w(w2c),
            )


class DL3DVAdapter(DatasetAdapter):
    """Reference conversion/dl3dv.py: nerfstudio transforms.json with
    shared (distorted) intrinsics and OpenGL poses; RGB-only (no GT
    depth in the raw release). Distortion parameters are carried in
    frame extras for a downstream undistortion pass."""

    name = "dl3dv"
    shared_intrinsics = True
    scale_type = "none"

    def list_scenes(self, raw_root):
        return [
            s
            for s in _subdirs(raw_root)
            if (raw_root / s / "transforms.json").exists()
        ]

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        meta = F.read_nerfstudio_transforms(scene / "transforms.json")
        W, H = meta["wh"]
        for fr in meta["frames"]:
            img = scene / fr["file_path"]
            if not img.exists():
                continue
            yield RawFrame(
                frame_name=fr["name"],
                image=img,
                size_hw=(H, W),
                intrinsics=meta["intrinsics"],
                cam2world=fr["cam2world"],
                extras={"distortion": meta["distortion"].tolist()},
            )


class ScanNetPPAdapter(DatasetAdapter):
    """Reference conversion/scannetppv2.py: DSLR nerfstudio
    transforms.json (per-frame or shared intrinsics, OpenGL poses),
    resized (distorted) images, optional anonymization masks and
    mesh-rendered depth (uint16 mm png from the reference's rendering
    stage) when present."""

    name = "scannetppv2"
    shared_intrinsics = True

    def list_scenes(self, raw_root):
        return [
            s
            for s in _subdirs(raw_root)
            if (raw_root / s / "dslr" / "nerfstudio" / "transforms.json").exists()
        ]

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        dslr = scene / "dslr"
        meta = F.read_nerfstudio_transforms(dslr / "nerfstudio" / "transforms.json")
        shared_K = meta.get("intrinsics")
        for fr in meta["frames"]:
            img = dslr / "resized_images" / fr["file_path"]
            if not img.exists():
                continue
            K = fr.get("intrinsics", shared_K)
            wh = fr.get("wh", meta.get("wh"))
            depth_path = dslr / "render_depth" / (fr["name"] + ".png")
            mask_path = dslr / "resized_anon_masks" / (fr["name"] + ".png")
            yield RawFrame(
                frame_name=fr["name"],
                image=img,
                size_hw=(wh[1], wh[0]) if wh else _image_size(img),
                depth=depth_path if depth_path.exists() else None,
                mask=mask_path if mask_path.exists() else None,
                intrinsics=K,
                cam2world=fr["cam2world"],
            )


class DynamicReplicaAdapter(DatasetAdapter):
    """Reference conversion/dynamicreplica.py: per-split gzipped-json
    frame annotations carry image/depth relpaths and PyTorch3D NDC
    viewpoints; depth is float16-in-uint16 png; left/right cameras are
    separate frames (scene names end in _left / _right)."""

    name = "dynamicreplica"

    def list_scenes(self, raw_root):
        return [
            s for s in _subdirs(raw_root) if (raw_root / s / "images").is_dir()
        ]

    def _annotations(self, raw_root) -> Dict[str, List[Dict]]:
        cache = getattr(self, "_annot_cache", None)
        if cache is not None:
            return cache
        by_scene: Dict[str, List[Dict]] = {}
        for split in ("train", "valid", "test"):
            p = Path(raw_root) / f"frame_annotations_{split}.jgz"
            if not p.exists():
                continue
            with gzip.open(p, "rt") as f:
                for annot in json.load(f):
                    by_scene.setdefault(annot["sequence_name"], []).append(annot)
        self._annot_cache = by_scene
        return by_scene

    def iter_frames(self, raw_root, scene_name):
        raw_root = Path(raw_root)
        annots = self._annotations(raw_root).get(scene_name, [])
        for annot in sorted(annots, key=lambda a: a["frame_number"]):
            img_rel = annot["image"]["path"]
            W, H = annot["image"]["size"][1], annot["image"]["size"][0]
            K, c2w = F.pytorch3d_ndc_camera_to_opencv(
                annot["viewpoint"], (W, H)
            )
            depth = None
            if annot.get("depth") and annot["depth"].get("path"):
                depth = F.read_float16_png_depth(raw_root / annot["depth"]["path"])
            yield RawFrame(
                frame_name=f"{annot['frame_number']:04d}",
                image=raw_root / img_rel,
                size_hw=(H, W),
                depth=depth,
                intrinsics=K,
                cam2world=c2w,
            )


class CO3DAdapter(DatasetAdapter):
    """Reference conversion/co3d.py: scene names are
    "category/sequence"; per-category gzipped frame annotations with
    PyTorch3D NDC viewpoints, float16-png depth x scale_adjustment, and
    foreground masks. Up-to-scale (scale_type none)."""

    name = "co3d"
    scale_type = "none"

    def list_scenes(self, raw_root):
        out = []
        for cat in _subdirs(raw_root):
            cat_dir = Path(raw_root) / cat
            for seq in _subdirs(cat_dir):
                if (cat_dir / seq / "images").is_dir():
                    out.append(f"{cat}/{seq}")
        return out

    def iter_frames(self, raw_root, scene_name):
        raw_root = Path(raw_root)
        category, sequence = scene_name.split("/", 1)
        annots = []
        for split in ("train", "test"):
            p = raw_root / category / f"frame_annotations_{split}.jgz"
            if not p.exists():
                p = raw_root / f"{category}_{split}.jgz"
            if not p.exists():
                continue
            with gzip.open(p, "rt") as f:
                annots += [
                    a for a in json.load(f) if a["sequence_name"] == sequence
                ]
        for annot in sorted(annots, key=lambda a: a["frame_number"]):
            H, W = annot["image"]["size"]
            K, c2w = F.pytorch3d_ndc_camera_to_opencv(
                annot["viewpoint"], (W, H)
            )
            depth = None
            dinfo = annot.get("depth") or {}
            if dinfo.get("path"):
                depth = F.read_float16_png_depth(raw_root / dinfo["path"])
                depth = depth * float(dinfo.get("scale_adjustment", 1.0))
                depth = np.where(np.isfinite(depth), depth, 0.0)
            mask_rel = (annot.get("mask") or {}).get("path")
            yield RawFrame(
                frame_name=f"{annot['frame_number']:06d}",
                image=raw_root / annot["image"]["path"],
                size_hw=(H, W),
                depth=depth,
                mask=(raw_root / mask_rel) if mask_rel else None,
                intrinsics=K,
                cam2world=c2w,
            )


class MPSDAdapter(DatasetAdapter):
    """Reference conversion/mpsd.py: OpenSfM reconstruction.json shots
    (axis-angle world2cam), normalized focal x max(W, H), centimeter
    depth pngs resized RGB. Scene names are
    "<reconstruction_split>_<folder>"."""

    name = "mpsd"

    def list_scenes(self, raw_root):
        out = []
        recon = Path(raw_root) / "reconstruction_data"
        for split in _subdirs(recon):
            split_dir = recon / split
            for folder in _subdirs(split_dir):
                if (split_dir / folder / "reconstruction.json").exists():
                    out.append(f"{split}_{folder}")
        return out

    def iter_frames(self, raw_root, scene_name):
        raw_root = Path(raw_root)
        recon_root = raw_root / "reconstruction_data"
        split = next(
            s for s in _subdirs(recon_root) if scene_name.startswith(s + "_")
        )
        folder = scene_name[len(split) + 1 :]
        rdir = recon_root / split / folder
        with open(rdir / "reconstruction.json") as f:
            recon = json.load(f)
        shots = recon[0]["shots"]
        cameras = recon[0].get("cameras", {})
        with open(rdir / "image_list.txt") as f:
            image_names = [line.strip() for line in f if line.strip()]
        for image_name in image_names:
            if image_name not in shots:
                continue
            stem = os.path.splitext(image_name)[0]
            img_path = depth_path = None
            for part in ("train", "val"):
                cand = raw_root / part / f"{stem}.jpg"
                if cand.exists():
                    img_path = cand
                    depth_path = raw_root / part / f"{stem}.png"
                    break
            if img_path is None or not depth_path.exists():
                continue
            depth_cm = read_png(depth_path, unchanged=True)
            depth = depth_cm.astype(np.float32) / 100.0  # cm -> m
            H, W = depth.shape[:2]
            shot = shots[image_name]
            cam = cameras.get(shot.get("camera", ""), {})
            focal = float(cam.get("focal", shot.get("focal", 0.85)))
            f_px = focal * max(W, H)
            K = np.array([[f_px, 0, W / 2.0], [0, f_px, H / 2.0], [0, 0, 1]])
            w2c = np.eye(4)
            w2c[:3, :3] = F.axis_angle_to_matrix(shot["rotation"])
            w2c[:3, 3] = shot["translation"]
            # RGB must be resized to depth resolution (reference does so)
            rgb = read_jpeg(img_path)
            if rgb.shape[:2] != (H, W):
                cv2 = _needs("cv2", f"{img_path}: resizing an MPSD frame to its depth (INTER_AREA)")
                rgb = cv2.resize(rgb, (W, H), interpolation=cv2.INTER_AREA)
            yield RawFrame(
                frame_name=stem,
                image=rgb,
                depth=depth,
                intrinsics=K,
                cam2world=F.w2c_to_c2w(w2c),
            )


class SAILVOS3DAdapter(DatasetAdapter):
    """Reference conversion/sailvos3d.py: GTA-V renders — camera YAML
    (K with principal point offset by half the image, OpenGL Rt
    world2cam), NDC depth .npy + rage_matrices .npz P_inv, sky at
    depth==24e-5."""

    name = "sailvos3d"

    def list_scenes(self, raw_root):
        return [
            s for s in _subdirs(raw_root) if (raw_root / s / "camera").is_dir()
        ]

    def iter_frames(self, raw_root, scene_name):
        from mapanything_tpu_torch.utils import yaml_subset

        scene = Path(raw_root) / scene_name
        for cam_file in _natsorted(os.listdir(scene / "camera")):
            if not cam_file.endswith(".yaml"):
                continue
            n = cam_file[:-5]
            cam = yaml_subset.load_file(scene / "camera" / cam_file)
            ndc_depth = np.load(scene / "depth" / f"{n}.npy")
            sky = ndc_depth == 24e-5
            H, W = ndc_depth.shape
            K = np.asarray(cam["K"], np.float64).copy()
            K[0, 2] += W / 2.0
            K[1, 2] += H / 2.0
            w2c = np.eye(4)
            w2c[:3, :] = np.asarray(cam["Rt"], np.float64)
            c2w = F.gl2cv_pose(F.w2c_to_c2w(w2c))
            rage = np.load(scene / "rage_matrices" / f"{n}.npz")
            depth = F.gta_ndc_depth_to_camera(ndc_depth, rage["P_inv"])
            depth = np.where(sky, 0.0, depth).astype(np.float32)
            yield RawFrame(
                frame_name=n,
                image=scene / "images" / f"{n}.png",
                size_hw=(H, W),
                depth=depth,
                intrinsics=np.array(
                    [[K[0, 0], 0, K[0, 2]], [0, K[1, 1], K[1, 2]], [0, 0, 1]]
                ),
                cam2world=c2w,
            )


class ParallelDomain4DAdapter(DatasetAdapter):
    """Reference conversion/paralleldomain4d.py: scene_*.json data
    entries with per-camera npz depth (meters, invalid >= 500), LFU
    quaternion poses permuted to RDF, per-camera intrinsics from the
    calibration json."""

    name = "paralleldomain4d"

    def list_scenes(self, raw_root):
        return [
            s for s in _subdirs(raw_root) if (raw_root / s / "calibration").is_dir()
        ]

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        calib_file = os.listdir(scene / "calibration")[0]
        with open(scene / "calibration" / calib_file) as f:
            calib = json.load(f)
        cam_to_K = {}
        for cam_name, intr in zip(calib["names"], calib["intrinsics"]):
            cam_to_K[cam_name] = np.array(
                [
                    [intr["fx"], 0, intr["cx"]],
                    [0, intr["fy"], intr["cy"]],
                    [0, 0, 1],
                ]
            )
        import glob as _glob

        scene_jsons = _glob.glob(str(scene / "scene_*.json"))
        with open(scene_jsons[0]) as f:
            scene_meta = json.load(f)
        for entry in scene_meta["data"]:
            datum = entry.get("datum", {})
            if "image" not in datum:
                continue
            image_info = datum["image"]
            rgb_rel = image_info["filename"]
            depth_rel = image_info.get("annotations", {}).get("6")
            rgb_path = scene / rgb_rel
            if not rgb_path.exists() or depth_rel is None:
                continue
            depth_path = scene / depth_rel
            if not depth_path.exists():
                continue
            camera_name = Path(rgb_rel).parent.name
            file_name = Path(rgb_rel).stem
            depth = np.load(depth_path)["data"]
            depth = np.where(depth < 500, depth, 0.0).astype(np.float32)
            tr = image_info["pose"]["translation"]
            q = image_info["pose"]["rotation"]
            pose_lfu = np.eye(4)
            pose_lfu[:3, :3] = F.quat_xyzw_to_matrix(
                [q["qx"], q["qy"], q["qz"], q["qw"]]
            )
            pose_lfu[:3, 3] = [tr["x"], tr["y"], tr["z"]]
            yield RawFrame(
                frame_name=f"{file_name}_{camera_name}",
                image=rgb_path,
                size_hw=depth.shape,
                depth=depth,
                intrinsics=cam_to_K[camera_name],
                cam2world=F.LFU_TO_RDF @ pose_lfu,
            )


class ASEAdapter(DatasetAdapter):
    """Reference conversion/ase.py: Aria Synthetic Environments. The
    reference depends on ``projectaria_tools`` for device calibration
    (fisheye -> linear pinhole) — unavailable here, so this adapter
    requires pre-linearized scenes: per-scene ``trajectory.csv``
    (timestamp + cam2world), ``pinhole.json`` (fx fy cx cy w h) and
    rgb/depth render folders. Raises with guidance otherwise."""

    name = "ase"

    def list_scenes(self, raw_root):
        return [
            s for s in _subdirs(raw_root) if (raw_root / s / "rgb").is_dir()
        ]

    def iter_frames(self, raw_root, scene_name):
        scene = Path(raw_root) / scene_name
        pinhole_json = scene / "pinhole.json"
        if not pinhole_json.exists():
            raise NotImplementedError(
                "ASE raw scenes need projectaria_tools device calibration "
                "(reference ase.py:134). Pre-linearize the scene into "
                "pinhole.json + trajectory.csv to convert here."
            )
        with open(pinhole_json) as f:
            ph = json.load(f)
        K = np.array(
            [[ph["fx"], 0, ph["cx"]], [0, ph["fy"], ph["cy"]], [0, 0, 1]]
        )
        traj = np.loadtxt(scene / "trajectory.csv", delimiter=",", ndmin=2)
        rgbs = _natsorted(os.listdir(scene / "rgb"))
        for idx, rgb_name in enumerate(rgbs):
            c2w = traj[idx, 1:17].reshape(4, 4)
            stem = Path(rgb_name).stem
            depth_path = scene / "depth" / f"{stem}.exr"
            yield RawFrame(
                frame_name=stem,
                image=scene / "rgb" / rgb_name,
                size_hw=(int(ph["h"]), int(ph["w"])),
                depth=depth_path if depth_path.exists() else None,
                intrinsics=K,
                cam2world=c2w,
            )


ADAPTERS = {
    a.name: a
    for a in (
        ASEAdapter(),
        BlendedMVSAdapter(),
        CO3DAdapter(),
        DL3DVAdapter(),
        DynamicReplicaAdapter(),
        ETH3DAdapter(),
        MegaDepthAdapter(),
        MPSDAdapter(),
        MVSSynthAdapter(),
        ParallelDomain4DAdapter(),
        SAILVOS3DAdapter(),
        ScanNetPPAdapter(),
        SpringAdapter(),
        TartanAirV2WBAdapter(),
        UnrealStereo4KAdapter(),
    )
}


def get_adapter(name: str) -> DatasetAdapter:
    if name not in ADAPTERS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(ADAPTERS)}")
    return ADAPTERS[name]
