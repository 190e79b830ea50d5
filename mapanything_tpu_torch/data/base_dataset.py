"""Multi-view scene dataset base: covisibility sampling and view construction.

Counterpart of ``mapanything_tpu/data/base_dataset.py`` (:1-350), after the
reference's ``mapanything/datasets/base/base_dataset.py:32-660``:
  - the per-item generator ``np.random.default_rng(seed + seed_offset + idx)``
    (JAX :238-243), drawn from in the JAX package's order: view indices,
    the crop jitter of each view, then its colour augmentation;
  - the covisibility random walk (:131-191): the native sampler
    (``mapanything_tpu_torch/native``, built with g++ at first use) seeded by
    a draw from that generator, or, when ``use_native_sampler`` is False,
    the numpy walk; a failed build raises, it does not fall back;
  - crop/resize with intrinsics bookkeeping (``data/cropping.py``, cv2's
    resize computed in float64 on the host);
  - pts3d / rays / depth along the ray / XYZW quaternions (Markley's, as
    SciPy's ``Rotation`` gives them) from depth, K and the cam2world pose,
    with the finiteness checks;
  - a failed item retried on another index, up to ``max_num_retries``
    times. The JAX package draws that index from numpy's global RNG (:312,
    :315), which forked loader workers share; the port draws it from the
    item's own generator.

Host-side numpy only: loader workers run it. ``collate_views`` stacks the
per-view dicts into the (B, V, ...) arrays the ``Trainer`` reads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mapanything_tpu_torch.data.cropping import crop_resize_if_necessary
from mapanything_tpu_torch.data.easy_dataset import EasyDataset
from mapanything_tpu_torch.data.transforms import apply_color_transform
from mapanything_tpu_torch.geometry.quaternion import rotmat_to_quat_markley
from mapanything_tpu_torch.models.encoders.normalizations import IMAGE_NORMALIZATION_DICT


def pointmaps_and_rays_from_depth(
    depthmap: np.ndarray, intrinsics: np.ndarray, camera_pose: np.ndarray
):
    """Derive all geometric view quantities from z-depth + K + cam2world.

    After the reference's ``get_absolute_pointmaps_and_rays_info`` (utils/geometry.py:1365).

    Returns dict with pts3d (world), valid_mask, depth_along_ray (H, W, 1),
    ray_directions_cam (unit sphere), pts3d_cam.
    """
    h, w = depthmap.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x_cam = (xx - cx) * depthmap / fx
    y_cam = (yy - cy) * depthmap / fy
    pts3d_cam = np.stack([x_cam, y_cam, depthmap], axis=-1)
    valid_mask = depthmap > 0.0

    rot, t = camera_pose[:3, :3], camera_pose[:3, 3]
    pts3d = pts3d_cam @ rot.T + t

    dirs = np.stack(
        [(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)], axis=-1
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depth_along_ray = np.linalg.norm(pts3d_cam, axis=-1, keepdims=True)

    return dict(
        pts3d=pts3d.astype(np.float32),
        valid_mask=valid_mask,
        depth_along_ray=depth_along_ray.astype(np.float32),
        ray_directions_cam=dirs.astype(np.float32),
        pts3d_cam=pts3d_cam.astype(np.float32),
    )


class BaseDataset(EasyDataset):
    """Subclass and implement ``_get_views(idx, num_views, resolution)``.

    ``_get_views`` must return a list of dicts containing at least:
    img (H, W, 3 uint8 or float in [0, 1]), depthmap (H, W), camera_pose
    (4, 4 cam2world), camera_intrinsics (3, 3). Optional: non_ambiguous_mask,
    prior_depth_z.
    """

    is_metric_scale: bool = True
    is_synthetic: bool = False

    def __init__(
        self,
        num_views: int,
        variable_num_views: bool = False,
        split: Optional[str] = None,
        covisibility_thres: Optional[float] = None,
        resolution: Union[int, Tuple, List] = None,
        principal_point_centered: bool = False,
        data_norm_type: str = "dinov2",
        transform: str = "imgnorm",
        aug_crop: int = 0,
        seed: Optional[int] = None,
        max_num_retries: int = 5,
    ):
        self.num_views = num_views
        self.variable_num_views = variable_num_views
        self.num_views_min = 2
        self.split = split
        self.covisibility_thres = covisibility_thres
        self.principal_point_centered = principal_point_centered
        self.data_norm_type = data_norm_type
        # Color augmentation spec (reference base_dataset.py:70-131):
        # "imgnorm" | "colorjitter" | "colorjitter+grayscale+gaublur".
        self.transform = transform
        self.aug_crop = aug_crop
        self.seed = seed
        self.max_num_retries = max_num_retries
        self._seed_offset = 0
        self._set_resolutions(resolution)

        if self.variable_num_views and self.num_views > self.num_views_min:
            self.num_views = list(range(self.num_views_min, self.num_views + 1))

    # ------------------------------------------------------------------
    def _set_resolutions(self, resolutions):
        assert resolutions is not None, "undefined resolution"
        if isinstance(resolutions, int):
            resolutions = [(resolutions, resolutions)]
        elif isinstance(resolutions, tuple):
            resolutions = [resolutions]
        self._resolutions = [tuple(map(int, r)) for r in resolutions]

    def set_epoch(self, epoch: int):
        pass

    def set_seed_offset(self, offset: int):
        self._seed_offset = offset

    # ------------------------------------------------------------------
    use_native_sampler: bool = True

    def _random_walk_sampling(
        self,
        covis: np.ndarray,
        num_of_samples: int,
        max_retries: int = 4,
        use_bidirectional_covis: bool = True,
    ) -> np.ndarray:
        """Connected-subgraph sampling by random walk and backtracking (the
        reference's :316): the native sampler seeded by one draw of the item's
        generator, or the numpy walk when ``use_native_sampler`` is False."""
        if self.use_native_sampler:
            from mapanything_tpu_torch.native import covis_random_walk_native

            seed = int(self._rng.integers(0, 2**63 - 1))
            return covis_random_walk_native(
                covis, self.covisibility_thres, num_of_samples, seed,
                max_retries, use_bidirectional_covis,
            )
        excluded = set()
        best_walk: list = []
        n = len(covis)
        for _ in range(max_retries):
            visited = set()
            walk, stack = [], []
            available = list(set(range(n)) - excluded)
            if not available:
                break
            start = int(self._rng.choice(available))
            walk.append(start)
            visited.add(start)
            stack.append(start)

            while len(walk) < num_of_samples and stack:
                cur = stack[-1]
                if use_bidirectional_covis:
                    pc = (covis[cur, :] + covis[:, cur].T) / 2
                else:
                    pc = np.array(covis[cur, :])
                pc = pc / (pc[cur] + 1e-8)
                pc[cur] = 0
                neighbors = np.flatnonzero(pc > self.covisibility_thres)
                candidates = [i for i in neighbors if i not in visited]
                if candidates:
                    nxt = int(self._rng.choice(candidates))
                    walk.append(nxt)
                    visited.add(nxt)
                    stack.append(nxt)
                else:
                    stack.pop()

            if len(walk) > len(best_walk):
                best_walk = walk
            if len(walk) >= num_of_samples:
                return np.asarray(walk)
            excluded.update(visited)
        return np.asarray(best_walk)

    def _sample_view_indices(
        self, num_views_to_sample: int, num_views_in_scene: int, covis: np.ndarray,
        use_bidirectional_covis: bool = True,
    ) -> np.ndarray:
        """(:413)"""
        if num_views_to_sample == num_views_in_scene:
            return self._rng.permutation(num_views_in_scene)
        if num_views_to_sample > num_views_in_scene:
            return self._rng.choice(
                num_views_in_scene, size=num_views_to_sample, replace=True
            )
        idx = self._random_walk_sampling(
            covis, num_views_to_sample,
            use_bidirectional_covis=use_bidirectional_covis,
        )
        if len(idx) < num_views_to_sample:
            idx = self._rng.choice(idx, size=num_views_to_sample, replace=True)
        return idx

    # ------------------------------------------------------------------
    def _crop_resize_if_necessary(
        self, image, resolution, depthmap, intrinsics, additional_quantities=None
    ):
        """numpy in, numpy out: the image (uint8 or float), depth and extras go
        through ``data.cropping`` as CPU tensors, the intrinsics stay numpy."""
        def t(x):
            return None if x is None else torch.from_numpy(np.ascontiguousarray(x))

        extras = None if additional_quantities is None else {k: t(v) for k, v in additional_quantities.items()}
        image, depthmap, intrinsics, extras = crop_resize_if_necessary(
            t(np.asarray(image)),
            resolution,
            t(depthmap),
            intrinsics,
            extras,
            principal_point_centered=self.principal_point_centered,
            rng=getattr(self, "_rng", None),
            aug_crop=self.aug_crop,
        )
        def a(x):  # contiguous, as cv2 returns its results
            return None if x is None else np.ascontiguousarray(x.numpy())

        return a(image), a(depthmap), intrinsics, None if extras is None else {k: a(v) for k, v in extras.items()}

    def _getitem_fn(self, idx):
        if isinstance(idx, tuple):
            if isinstance(self.num_views, int):
                idx, ar_idx = idx
                nv_idx = None
            else:
                idx, ar_idx, nv_idx = idx
        else:
            assert len(self._resolutions) == 1
            ar_idx, nv_idx = 0, None

        if self.seed is not None:
            self._rng = np.random.default_rng(
                seed=self.seed + self._seed_offset + idx
            )
        elif not hasattr(self, "_rng"):
            self._rng = np.random.default_rng()

        resolution = self._resolutions[ar_idx]
        if isinstance(self.num_views, int):
            num_views = self.num_views
        else:
            num_views = self.num_views[nv_idx if nv_idx is not None else -1]

        views = self._get_views(idx, num_views, resolution)
        assert len(views) == num_views

        norm = IMAGE_NORMALIZATION_DICT.get(self.data_norm_type)
        for v, view in enumerate(views):
            view["idx"] = (idx, ar_idx, v)
            view["is_metric_scale"] = self.is_metric_scale
            view["is_synthetic"] = self.is_synthetic

            assert "camera_intrinsics" in view and "camera_pose" in view
            assert np.isfinite(view["camera_pose"]).all(), "NaN in camera pose"
            assert np.isfinite(view["depthmap"]).all(), "NaN in depthmap"
            assert "pts3d" not in view, "pts3d computed here, not by _get_views"

            img = np.asarray(view["img"])
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            img = apply_color_transform(img, self.transform, self._rng)
            view["img_no_norm"] = img
            view["img"] = (
                norm.apply(img) if norm is not None else img
            ).astype(np.float32)
            view["data_norm_type"] = self.data_norm_type

            geo = pointmaps_and_rays_from_depth(
                view["depthmap"], view["camera_intrinsics"], view["camera_pose"]
            )
            view.update(geo)
            view["valid_mask"] = geo["valid_mask"] & np.isfinite(
                geo["pts3d"]
            ).all(axis=-1)

            if "non_ambiguous_mask" in view:
                view["non_ambiguous_mask"] = view["non_ambiguous_mask"].astype(bool)
            else:
                view["non_ambiguous_mask"] = ~(view["depthmap"] < 0)

            view["depthmap"] = view["depthmap"][..., None].astype(np.float32)

            rot = torch.from_numpy(np.asarray(view["camera_pose"][:3, :3], np.float64))
            view["camera_pose_quats"] = rotmat_to_quat_markley(rot).numpy().astype(np.float32)
            view["camera_pose_trans"] = view["camera_pose"][:3, 3].astype(np.float32)

            for key in ("pts3d", "depth_along_ray", "ray_directions_cam",
                        "pts3d_cam", "camera_pose_quats", "camera_pose_trans"):
                assert np.isfinite(view[key]).all(), f"NaN in {key}"
        return views

    def __getitem__(self, idx):
        if self.max_num_retries == 0:
            return self._getitem_fn(idx)
        num_retries = 0
        while True:
            try:
                return self._getitem_fn(idx)
            except Exception:  # noqa: BLE001 — as the reference: retry any failure
                if num_retries >= self.max_num_retries:
                    raise
                num_retries += 1
                # The failed item's own generator (never numpy's global one, which
                # forked loader workers would share) picks the next index.
                rng = getattr(self, "_rng", None) or np.random.default_rng()
                new = int(rng.integers(0, len(self)))
                idx = (new, *idx[1:]) if isinstance(idx, tuple) else new


def collate_views(samples: List[List[Dict]]) -> Dict[str, np.ndarray]:
    """Stack a batch of per-sample view lists into (B, V, ...) arrays.

    Produces the fields of ``train.losses.LossBatch`` + the model image
    input. All samples must share (V, H, W) — guaranteed by the batched
    samplers (same aspect-ratio / num-views feature per batch).
    """
    keys = {
        "img": np.float32,
        "pts3d": np.float32,
        "pts3d_cam": np.float32,
        "depth_along_ray": np.float32,
        "ray_directions_cam": np.float32,
        "camera_pose_quats": np.float32,
        "camera_pose_trans": np.float32,
        "valid_mask": bool,
        "non_ambiguous_mask": bool,
    }
    out = {}
    for key, dtype in keys.items():
        out[key] = np.stack(
            [np.stack([np.asarray(v[key], dtype) for v in views]) for views in samples]
        )
    out["is_metric_scale"] = np.asarray(
        [views[0]["is_metric_scale"] for views in samples], bool
    )
    out["is_synthetic"] = np.asarray(
        [views[0]["is_synthetic"] for views in samples], bool
    )
    # Scene labels ride along for per-scene benchmark aggregation
    # (reference benchmark.py:307 groups metrics by view["label"]).
    out["label"] = [str(views[0].get("label", "")) for views in samples]
    return out
