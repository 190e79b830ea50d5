"""WAI dataset classes: one generic loader and 15 thin per-dataset configs.

Counterpart of ``mapanything_tpu/data/datasets/wai_datasets.py`` (:1-145),
after the reference's ``mapanything/datasets/wai/*.py``: one ``WAIDataset``
reads a scene list, its covisibility mmap and frames, and per-dataset classes
carry only their flags (metric / synthetic, split, metadata naming): ASE,
BlendedMVS, CO3D, DL3DV, DynamicReplica, ETH3D, MegaDepth, MPSD, MVSSynth,
ParallelDomain4D, SAILVOS3D, ScanNetPP, Spring, TartanAirV2WB,
UnrealStereo4K. As in the JAX package, a frame's float image goes back to
uint8 by truncation (``(image * 255).astype(np.uint8)``) before the crop.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from mapanything_tpu_torch.data import wai as wai_io
from mapanything_tpu_torch.data.base_dataset import BaseDataset


class WAIDataset(BaseDataset):
    """Generic WAI-scene dataset (pattern of e.g. reference eth3d.py:18-147)."""

    dataset_name: str = "WAI"
    metadata_prefix: str = ""  # e.g. "eth3d" -> eth3d_scene_list_{split}.npy
    default_split: str = "train"

    def __init__(
        self,
        *args,
        ROOT: str,
        dataset_metadata_dir: str,
        overfit_num_sets=None,
        sample_specific_scene: bool = False,
        specific_scene_name: str = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.ROOT = ROOT
        self.dataset_metadata_dir = dataset_metadata_dir
        if self.split is None:
            self.split = self.default_split
        self.overfit_num_sets = overfit_num_sets
        self.sample_specific_scene = sample_specific_scene
        self.specific_scene_name = specific_scene_name
        self._load_scene_list()

    def _load_scene_list(self):
        path = os.path.join(
            self.dataset_metadata_dir,
            self.split,
            f"{self.metadata_prefix}_scene_list_{self.split}.npy",
        )
        scene_list = np.load(path, allow_pickle=True)
        if self.sample_specific_scene:
            self.scenes = [self.specific_scene_name]
        else:
            self.scenes = list(scene_list)
            if self.overfit_num_sets is not None:
                self.scenes = self.scenes[: self.overfit_num_sets]
        self.num_of_scenes = len(self.scenes)

    def __len__(self):
        return self.num_of_scenes

    def _get_views(self, sampled_idx, num_views_to_sample, resolution):
        scene_name = self.scenes[sampled_idx]
        scene_root = Path(self.ROOT) / scene_name
        meta = wai_io.load_scene_meta(scene_root)
        frames = meta["frames"]
        covis = wai_io.load_covisibility(scene_root)

        view_indices = self._sample_view_indices(
            num_views_to_sample, len(frames), covis
        )

        views = []
        for vi in view_indices:
            frame = frames[int(vi)]
            data = wai_io.load_frame(
                scene_root, frame["frame_name"],
                modalities=["image", "depth", "pose", "intrinsics"], meta=meta,
            )
            image = (data["image"] * 255).astype(np.uint8)
            depthmap = data["depth"].astype(np.float32)
            image, depthmap, intrinsics, _ = self._crop_resize_if_necessary(
                image, resolution, depthmap, data["intrinsics"]
            )
            views.append(
                dict(
                    img=image,
                    depthmap=depthmap,
                    camera_pose=data["pose"],
                    camera_intrinsics=intrinsics,
                    dataset=self.dataset_name,
                    label=str(scene_name),
                    instance=str(frame["frame_name"]),
                )
            )
        return views


def _make(name, prefix, metric, synthetic, split="train"):
    cls = type(
        f"{name}WAI",
        (WAIDataset,),
        dict(
            dataset_name=name,
            metadata_prefix=prefix,
            default_split=split,
            is_metric_scale=metric,
            is_synthetic=synthetic,
        ),
    )
    return cls


# Per-dataset classes (flags of the reference's datasets/wai/<name>.py)
ASEWAI = _make("ASE", "ase", metric=True, synthetic=True)
BlendedMVSWAI = _make("BlendedMVS", "blendedmvs", metric=False, synthetic=False)
CO3DWAI = _make("CO3D", "co3d", metric=False, synthetic=False)  # [FORK]
DL3DVWAI = _make("DL3DV", "dl3dv", metric=False, synthetic=False)
DynamicReplicaWAI = _make("DynamicReplica", "dynamicreplica", metric=True, synthetic=True)
ETH3DWAI = _make("ETH3D", "eth3d", metric=True, synthetic=False, split="test")
MegaDepthWAI = _make("MegaDepth", "megadepth", metric=False, synthetic=False)
MPSDWAI = _make("MPSD", "mpsd", metric=True, synthetic=False)
MVSSynthWAI = _make("MVSSynth", "mvs_synth", metric=True, synthetic=True)
ParallelDomain4DWAI = _make("ParallelDomain4D", "paralleldomain4d", metric=True, synthetic=True)
SAILVOS3DWAI = _make("SAILVOS3D", "sailvos3d", metric=True, synthetic=True)
ScanNetPPWAI = _make("ScanNetPP", "scannetppv2", metric=True, synthetic=False)
SpringWAI = _make("Spring", "spring", metric=True, synthetic=True)
TartanAirV2WBWAI = _make("TartanAirV2WB", "tav2_wb", metric=True, synthetic=True)
UnrealStereo4KWAI = _make("UnrealStereo4K", "unrealstereo4k", metric=True, synthetic=True)

ALL_WAI_DATASETS = {
    c.dataset_name: c
    for c in [
        ASEWAI, BlendedMVSWAI, CO3DWAI, DL3DVWAI, DynamicReplicaWAI, ETH3DWAI,
        MegaDepthWAI, MPSDWAI, MVSSynthWAI, ParallelDomain4DWAI, SAILVOS3DWAI,
        ScanNetPPWAI, SpringWAI, TartanAirV2WBWAI, UnrealStereo4KWAI,
    ]
}
