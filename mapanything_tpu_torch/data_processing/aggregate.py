"""Aggregate converted WAI scenes into training metadata.

Counterpart of ``mapanything_tpu/data_processing/aggregate.py`` (:1-134),
after the reference's ``data_processing/aggregate_metadata.py``: (a) split
scene names into train/val/test and store the per-split scene list npys the
dataset classes consume (``{prefix}_scene_list_{split}.npy``, read by the
reference's ``mapanything/datasets/wai/eth3d.py:62`` and the port's
``data.datasets.wai_datasets.WAIDataset``); (b) optionally aggregate the
pairwise covisibility matrices into thresholded adjacency lists stored as
one npz per split (reference ``aggregate_scenes``/``process_single_scene``
:66-127). Host code, over the port's ``data/wai.py`` and ``data/splits.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mapanything_tpu_torch.data import wai as wai_io
from mapanything_tpu_torch.data.splits import split_scenes
from mapanything_tpu_torch.data_processing.conversion.core import get_processing_state


def list_converted_scenes(
    wai_root, require_covisibility: bool = False, require_depth: bool = False
) -> List[str]:
    """Scene names under a WAI root with finished conversion state.

    Mirrors the reference's scene filters (aggregate_metadata.py:180-186:
    scene_meta.json exists, covisibility exists, depth exists). Nested
    scene names (e.g. co3d "category/sequence") are discovered one level
    deep.
    """
    wai_root = Path(wai_root)
    out = []

    def check(scene_dir: Path, name: str):
        if not (scene_dir / "scene_meta.json").exists():
            return
        state = get_processing_state(scene_dir).get("conversion", {})
        if state and state.get("state") != "finished":
            return
        if require_depth and not (scene_dir / "depth").is_dir():
            return
        if require_covisibility and not (scene_dir / "covisibility").is_dir():
            return
        out.append(name)

    for entry in sorted(wai_root.iterdir()):
        if not entry.is_dir():
            continue
        if (entry / "scene_meta.json").exists():
            check(entry, entry.name)
        else:
            for sub in sorted(entry.iterdir()):
                if sub.is_dir():
                    check(sub, f"{entry.name}/{sub.name}")
    return out


def scene_adjacency(
    scene_root, threshold: float = 0.25, version: str = "v0"
) -> Optional[Dict]:
    """Thresholded covisibility adjacency for one scene.

    Reference process_single_scene (aggregate_metadata.py:66): symmetrize,
    normalize by the diagonal self-overlap, zero the diagonal, threshold,
    and convert to an adjacency list; None when no edges survive.
    """
    covis = np.asarray(wai_io.load_covisibility(scene_root, version=version))
    mat = (covis + covis.T) / 2.0
    diag = np.diag(mat) + 1e-8
    mat = mat / diag
    np.fill_diagonal(mat, 0.0)
    adj_mat = mat > threshold
    adjacency = {
        int(i): np.flatnonzero(adj_mat[i]).tolist()
        for i in range(adj_mat.shape[0])
        if adj_mat[i].any()
    }
    if not adjacency:
        return None
    return {
        "adjacency_list": adjacency,
        "total_number_of_edges": int(adj_mat.sum()),
    }


def aggregate_dataset_metadata(
    dataset: str,
    wai_root,
    output_dir,
    metadata_prefix: Optional[str] = None,
    threshold: float = 0.25,
    with_adjacency: bool = False,
    scenes: Optional[Sequence[str]] = None,
) -> Dict[str, List[str]]:
    """Write per-split scene lists (+ optional adjacency npz).

    Produces ``{output_dir}/{split}/{prefix}_scene_list_{split}.npy`` for
    every non-empty split — the exact file the WAI dataset classes load.
    Returns the split partition.
    """
    prefix = metadata_prefix or dataset
    if scenes is None:
        scenes = list_converted_scenes(wai_root)
    splits = split_scenes(dataset, scenes)
    output_dir = Path(output_dir)
    for split, names in splits.items():
        if not names:
            continue
        split_dir = output_dir / split
        split_dir.mkdir(parents=True, exist_ok=True)
        np.save(
            split_dir / f"{prefix}_scene_list_{split}.npy",
            np.asarray(names, dtype=object),
        )
        if with_adjacency:
            agg = {}
            for name in names:
                try:
                    data = scene_adjacency(
                        Path(wai_root) / name, threshold=threshold
                    )
                except FileNotFoundError:
                    data = None
                if data is not None:
                    agg[name] = data
            np.savez(
                split_dir / f"{prefix}_aggregated_metadata_{split}.npz", **agg
            )
    return splits
