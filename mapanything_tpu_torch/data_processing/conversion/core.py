"""Conversion framework: RawFrame records, SceneWriter, the scene loop.

Counterpart of ``mapanything_tpu/data_processing/conversion/core.py``
(:1-290), after the reference's scene loop (``data_processing/wai_processing/
utils/wrapper.py:34`` convert_scenes_wrapper, ``utils/state.py``
set_processing_state) and its scene_meta schema (every reference converter
writes the same dict, e.g. ``conversion/blendedmvs.py:160-178``): frames with
image/depth relpaths, ``transform_matrix`` (OpenCV cam2world), per-frame
pinhole intrinsics, plus scene-level camera/scale metadata.

Adapters only *describe* frames; all IO and metadata assembly lives here
once. Images and masks given as arrays are written with the port's
``utils/image.write_png`` (the JAX package: ``cv2.imwrite``; the pixels are
the same, the compressed bytes may differ), depth arrays with
``utils/exr.write_depth_exr``. Host code.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from mapanything_tpu_torch.utils.exr import write_depth_exr
from mapanything_tpu_torch.utils.image import write_png

logger = logging.getLogger(__name__)

_STATE_FILE = "_process_state.json"


@dataclass
class RawFrame:
    """One source frame, fully described; the writer does the rest.

    ``image`` may be a filesystem path (symlinked/copied as-is) or an
    (H, W, 3) uint8 array (encoded to png). ``depth`` may be a path to a
    WAI-readable file (symlinked) or an (H, W) float32 z-depth array
    (written as EXR); None for RGB-only datasets.
    ``cam2world`` is a 4x4 OpenCV (RDF) camera-to-world matrix.
    """

    frame_name: str
    image: Union[str, Path, np.ndarray]
    intrinsics: np.ndarray  # (3, 3) pinhole K
    cam2world: np.ndarray  # (4, 4) OpenCV cam2world
    depth: Union[str, Path, np.ndarray, None] = None
    size_hw: Optional[tuple] = None  # required when image is a path
    mask: Union[str, Path, np.ndarray, None] = None  # optional binary mask
    extras: Dict = field(default_factory=dict)  # extra per-frame metadata


class DatasetAdapter:
    """Describes one raw dataset; subclasses implement the two hooks."""

    name: str = "dataset"
    # WAI scene-level metadata (reference converters' scene_meta fields)
    camera_model: str = "PINHOLE"
    shared_intrinsics: bool = False
    scale_type: str = "metric"  # "metric" | "colmap" | "none"
    version: str = "0.1"

    def list_scenes(self, raw_root: Path) -> List[str]:
        """All convertible scene names under the raw dataset root."""
        raise NotImplementedError

    def iter_frames(self, raw_root: Path, scene_name: str) -> Iterator[RawFrame]:
        """Yield every frame of one scene."""
        raise NotImplementedError


def set_processing_state(
    scene_root, key: str, state: str, message: str = ""
) -> None:
    """Record per-scene processing state (reference utils/state.py)."""
    path = Path(scene_root) / _STATE_FILE
    data = {}
    if path.exists():
        with open(path) as f:
            data = json.load(f)
    data[key] = {"state": state, "message": message, "time": time.time()}
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def get_processing_state(scene_root) -> Dict:
    path = Path(scene_root) / _STATE_FILE
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


class SceneWriter:
    """Writes one WAI scene directory from RawFrame records."""

    def __init__(
        self,
        scene_root,
        scene_name: str,
        adapter: DatasetAdapter,
        link_files: bool = True,
    ):
        self.scene_root = Path(scene_root)
        self.scene_name = scene_name
        self.adapter = adapter
        self.link_files = link_files
        self.frames: List[Dict] = []
        self.has_depth = False
        self.has_mask = False
        (self.scene_root / "images").mkdir(parents=True, exist_ok=True)

    def _place_file(self, src: Path, dst: Path) -> None:
        if dst.exists() or dst.is_symlink():
            dst.unlink()
        if self.link_files:
            os.symlink(os.path.abspath(src), dst)
        else:
            shutil.copy2(src, dst)

    def _write_image(self, frame: RawFrame) -> tuple:
        img_dir = self.scene_root / "images"
        if isinstance(frame.image, np.ndarray):
            assert frame.image.ndim == 3 and frame.image.shape[2] == 3
            rel = Path("images") / f"{frame.frame_name}.png"
            write_png(self.scene_root / rel, frame.image)
            return rel, frame.image.shape[:2]
        src = Path(frame.image)
        rel = Path("images") / f"{frame.frame_name}{src.suffix}"
        self._place_file(src, img_dir / f"{frame.frame_name}{src.suffix}")
        assert frame.size_hw is not None, (
            f"{frame.frame_name}: size_hw required when image is a path"
        )
        return rel, tuple(frame.size_hw)

    def _write_depth(self, frame: RawFrame):
        if frame.depth is None:
            return None
        depth_dir = self.scene_root / "depth"
        depth_dir.mkdir(exist_ok=True)
        self.has_depth = True
        if isinstance(frame.depth, np.ndarray):
            rel = Path("depth") / f"{frame.frame_name}.exr"
            write_depth_exr(self.scene_root / rel, frame.depth)
            return rel
        src = Path(frame.depth)
        rel = Path("depth") / f"{frame.frame_name}{src.suffix}"
        self._place_file(src, depth_dir / rel.name)
        return rel

    def _write_mask(self, frame: RawFrame):
        if frame.mask is None:
            return None
        mask_dir = self.scene_root / "masks"
        mask_dir.mkdir(exist_ok=True)
        self.has_mask = True
        if isinstance(frame.mask, np.ndarray):
            rel = Path("masks") / f"{frame.frame_name}.png"
            write_png(self.scene_root / rel, frame.mask.astype(np.uint8) * 255)
            return rel
        src = Path(frame.mask)
        rel = Path("masks") / f"{frame.frame_name}{src.suffix}"
        self._place_file(src, mask_dir / rel.name)
        return rel

    def add_frame(self, frame: RawFrame) -> None:
        rel_img, (h, w) = self._write_image(frame)
        rel_depth = self._write_depth(frame)
        rel_mask = self._write_mask(frame)

        K = np.asarray(frame.intrinsics, np.float64)
        pose = np.asarray(frame.cam2world, np.float64)
        assert K.shape == (3, 3) and pose.shape == (4, 4)
        assert np.isfinite(K).all() and np.isfinite(pose).all(), (
            f"{frame.frame_name}: non-finite camera parameters"
        )

        rec = {
            "frame_name": frame.frame_name,
            "image": str(rel_img),
            "file_path": str(rel_img),
            "transform_matrix": pose.tolist(),
            "h": int(h),
            "w": int(w),
            "fl_x": float(K[0, 0]),
            "fl_y": float(K[1, 1]),
            "cx": float(K[0, 2]),
            "cy": float(K[1, 2]),
        }
        if rel_depth is not None:
            rec["depth"] = str(rel_depth)
        if rel_mask is not None:
            rec["mask"] = str(rel_mask)
        rec.update(frame.extras)
        self.frames.append(rec)

    def finalize(self) -> Dict:
        assert self.frames, f"{self.scene_name}: no frames written"
        frame_modalities = {"image": {"frame_key": "image", "format": "image"}}
        if self.has_depth:
            frame_modalities["depth"] = {"frame_key": "depth", "format": "depth"}
        if self.has_mask:
            frame_modalities["mask"] = {
                "frame_key": "mask",
                "format": "binary",
            }
        meta = {
            "scene_name": self.scene_name,
            "dataset_name": self.adapter.name,
            "version": self.adapter.version,
            "shared_intrinsics": self.adapter.shared_intrinsics,
            "camera_model": self.adapter.camera_model,
            "camera_convention": "opencv",
            "scale_type": self.adapter.scale_type,
            "scene_modalities": {},
            "frames": self.frames,
            "frame_modalities": frame_modalities,
        }
        with open(self.scene_root / "scene_meta.json", "w") as f:
            json.dump(meta, f)
        return meta


def convert_scenes(
    adapter: DatasetAdapter,
    raw_root,
    out_root,
    scenes: Optional[Sequence[str]] = None,
    overwrite: bool = False,
    skip_finished: bool = True,
    link_files: bool = True,
) -> List[str]:
    """Convert scenes of one dataset to WAI; returns successful names.

    Mirrors the reference loop's semantics
    (``utils/wrapper.py:34-109``): per-scene running/finished/failed
    state with the failure traceback recorded; existing outputs either
    skipped (already finished), overwritten, or rejected.
    """
    raw_root, out_root = Path(raw_root), Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    if scenes is None:
        scenes = adapter.list_scenes(raw_root)
    succeeded = []
    for scene_name in sorted(scenes):
        scene_out = out_root / scene_name
        if scene_out.exists():
            state = get_processing_state(scene_out).get("conversion", {})
            if skip_finished and state.get("state") == "finished":
                succeeded.append(scene_name)
                continue
            if overwrite:
                shutil.rmtree(scene_out)
            else:
                raise FileExistsError(
                    f"{scene_out} exists (state={state.get('state')}); "
                    "pass overwrite=True to redo"
                )
        scene_out.mkdir(parents=True)
        set_processing_state(scene_out, "conversion", "running")
        try:
            writer = SceneWriter(
                scene_out, scene_name, adapter, link_files=link_files
            )
            for frame in adapter.iter_frames(raw_root, scene_name):
                writer.add_frame(frame)
            writer.finalize()
            set_processing_state(scene_out, "conversion", "finished")
            succeeded.append(scene_name)
        except Exception:
            tb = traceback.format_exc()
            logger.warning("conversion failed on %s:\n%s", scene_name, tb)
            set_processing_state(scene_out, "conversion", "failed", message=tb)
    logger.info("converted %d / %d scenes", len(succeeded), len(scenes))
    return succeeded
