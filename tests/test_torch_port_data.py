"""The data path against the JAX package's, on the CPU: colour transforms, samplers,
the covisibility walks, datasets, the DSL, the loader, splits, camera functions.

Inputs come from numpy seeds. Tolerances: transforms within 1e-6; samplers'
index streams, the native walk (the JAX package's library against the port's,
each built from its own copy of covis_sampler.cpp) and the numpy walk
identical; a dataset's items and the loader's batches (in order) with image
fields within one grey level (the port's float64 resize against cv2's fixed
point), geometric fields within 1e-5 relative (the quaternion: Markley's, the
port's in torch float64 against SciPy's), masks equal where the depth is
equal; the camera functions within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mapanything_tpu.data import base_dataset as jax_bd
from mapanything_tpu.data import easy_dataset as jax_easy
from mapanything_tpu.data import loader as jax_loader
from mapanything_tpu.data import samplers as jax_samplers
from mapanything_tpu.data import splits as jax_splits
from mapanything_tpu.data import transforms as jax_tf
from mapanything_tpu.geometry import camera as jax_camera
from mapanything_tpu.native import covis_random_walk_native as jax_native_walk
from mapanything_tpu.utils import viz as jax_viz
from mapanything_tpu_torch import native as port_native
from mapanything_tpu_torch.data import base_dataset as port_bd
from mapanything_tpu_torch.data import easy_dataset as port_easy
from mapanything_tpu_torch.data import loader as port_loader
from mapanything_tpu_torch.data import samplers as port_samplers
from mapanything_tpu_torch.data import splits as port_splits
from mapanything_tpu_torch.data import transforms as port_tf
from mapanything_tpu_torch.geometry import camera as port_camera
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils import viz as port_viz

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

GREY = 1.0 / 255.0
GEOMETRY_KEYS = ("pts3d", "pts3d_cam", "depth_along_ray", "ray_directions_cam", "camera_pose_quats",
                 "camera_pose_trans")
MASK_KEYS = ("valid_mask", "non_ambiguous_mask")


# ---------------------------------------------------------------- transforms


def image(seed, h=15, w=17):
    return np.random.default_rng(seed).uniform(size=(h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("op,arg", [("adjust_brightness", 1.3), ("adjust_contrast", 0.6), ("adjust_saturation", 1.4),
                                    ("adjust_hue", 0.07), ("adjust_hue", -0.31), ("to_grayscale", None),
                                    ("gaussian_blur", 0.7)])
def test_colour_ops_match_jax(op, arg):
    img = image(1)
    args = () if arg is None else (arg,)
    np.testing.assert_allclose(getattr(port_tf, op)(img, *args), getattr(jax_tf, op)(img, *args), atol=1e-6, rtol=0)


@pytest.mark.parametrize("spec", ["imgnorm", "colorjitter", "colorjitter+grayscale+gaublur"])
def test_colour_transform_matches_jax_draw_for_draw(spec):
    """Every seed: the same image and the generator left in the same state."""
    for seed in range(24):  # the grey and blur branches (p = 0.05) among them
        img = image(seed)
        pr, jr = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_allclose(port_tf.apply_color_transform(img, spec, pr),
                                   jax_tf.apply_color_transform(img, spec, jr), atol=1e-6, rtol=0)
        assert pr.integers(1 << 30) == jr.integers(1 << 30)
    with pytest.raises(ValueError, match="Unknown transform"):
        port_tf.apply_color_transform(image(0), "sepia", np.random.default_rng(0))


# ---------------------------------------------------------------- samplers


class Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def streams(pkg, n, world, rank, epoch):
    ds = Sized(n)
    samplers = [
        pkg.BatchedRandomSampler(ds, 3, 5, world_size=world, rank=rank),
        pkg.BatchedMultiFeatureRandomSampler(ds, 4, [3, 2], world_size=world, rank=rank),
        pkg.DynamicBatchedMultiFeatureRandomSampler(ds, [10, 3], scaling_feature_idx=1,
                                                    feature_to_batch_size_map={0: 6, 1: 4, 2: 3},
                                                    world_size=world, rank=rank),
        pkg.DynamicBatchedMultiFeatureRandomSampler(ds, [2, 3], scaling_feature_idx=1, world_size=world,
                                                    rank=rank, drop_last=False),
    ]
    out = []
    for s in samplers:
        s.set_epoch(epoch)
        out.append((len(s), list(s)))
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_samplers_give_the_jax_index_streams(world):
    for n in (37, 96):
        for epoch in range(3):
            for rank in range(world):
                assert streams(port_samplers, n, world, rank, epoch) == streams(jax_samplers, n, world, rank, epoch)


def test_samplers_take_world_and_rank_from_the_process_group(monkeypatch):
    assert isinstance(port_samplers.BatchedRandomSampler(Sized(8), 2, 1), torch.utils.data.Sampler)
    assert port_samplers.world_and_rank() == (1, 0)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    assert port_samplers.world_and_rank() == (4, 3) and port_samplers.world_and_rank(2, 1) == (2, 1)
    port = port_samplers.DynamicBatchedMultiFeatureRandomSampler(Sized(64), [3, 2], scaling_feature_idx=1)
    jax = jax_samplers.DynamicBatchedMultiFeatureRandomSampler(Sized(64), [3, 2], scaling_feature_idx=1,
                                                               world_size=4, rank=3)
    port.set_epoch(2)
    jax.set_epoch(2)
    assert list(port) == list(jax)


# ---------------------------------------------------------------- covisibility walks


def covis_matrix(seed, n=40, blocks=2):
    """Two chains of views (two components) with random strengths."""
    rng = np.random.RandomState(seed)
    c = np.zeros((n, n), np.float32)
    size = n // blocks
    for b in range(blocks):
        for i in range(b * size, (b + 1) * size):
            for j in range(max(b * size, i - 3), min((b + 1) * size, i + 4)):
                c[i, j] = 1.0 if i == j else rng.uniform(0.0, 0.6)
    return c


def test_native_walk_matches_jax_native_walk():
    for seed in range(20):
        covis = covis_matrix(seed)
        for k, bidirectional in ((4, True), (12, True), (25, False)):  # 25: more than a component holds
            got = port_native.covis_random_walk_native(covis, 0.25, k, seed * 7919, 4, bidirectional)
            want = jax_native_walk(covis, 0.25, k, seed * 7919, 4, bidirectional)
            assert want is not None and np.array_equal(got, want)
    assert port_native.library_path().exists() and port_native.library_path().parent.name == "native"


def test_failed_native_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "covis_sampler.cpp"
    broken.write_text(port_native.SOURCE.read_text().replace("int covis_random_walk(", "int covis_random_walk(("))
    monkeypatch.setattr(port_native, "SOURCE", broken)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g.. failed"):
        port_native.build()
    monkeypatch.setattr(port_native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        port_native.build()


# ---------------------------------------------------------------- datasets


def synthetic_scenes(base_cls, h0=96, w0=128):
    """tests/test_data_layer.py's SyntheticScenes on either package's BaseDataset:
    seeded random images, depth and poses (rotations included), chain covisibility."""

    class SyntheticScenes(base_cls):
        is_metric_scale = True
        is_synthetic = True

        def __init__(self, n_scenes=6, frames_per_scene=12, fail_on=(), **kwargs):
            base_cls.__init__(self, **kwargs)
            self.n_scenes, self.frames, self.fail_on, self.calls = n_scenes, frames_per_scene, set(fail_on), []
            self.covis = np.zeros((frames_per_scene, frames_per_scene), np.float32)
            for i in range(frames_per_scene):
                for j in range(max(0, i - 2), min(frames_per_scene, i + 3)):
                    self.covis[i, j] = 100.0 if i != j else 200.0

        def __len__(self):
            return self.n_scenes

        def __repr__(self):
            return f"Synthetic({self.n_scenes})"

        def _get_views(self, idx, num_views, resolution):
            self.calls.append(idx)
            if idx in self.fail_on:
                self.fail_on.discard(idx)
                raise RuntimeError(f"scene {idx} fails once")
            view_ids = self._sample_view_indices(num_views, self.frames, self.covis)
            views = []
            for vid in view_ids:
                r = np.random.RandomState(1000 * idx + int(vid))
                img = r.randint(0, 255, (h0, w0, 3)).astype(np.uint8)
                depth = r.uniform(1.0, 5.0, (h0, w0)).astype(np.float32)
                depth[r.uniform(size=(h0, w0)) < 0.05] = 0.0  # holes: invalid pixels
                K = np.array([[100.0, 0, w0 / 2 - 0.5], [0, 100.0, h0 / 2 - 0.5], [0, 0, 1]], np.float32)
                q, _ = np.linalg.qr(r.randn(3, 3))
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = q * np.sign(np.linalg.det(q))
                pose[:3, 3] = r.randn(3)
                img, depth, K, _ = self._crop_resize_if_necessary(img, resolution, depth, K)
                views.append(dict(img=img, depthmap=depth, camera_pose=pose, camera_intrinsics=K,
                                  dataset="Synthetic", label=f"scene{idx}", instance=str(vid)))
            return views

    return SyntheticScenes


def pair(**kw):
    defaults = dict(num_views=4, split="train", covisibility_thres=0.25, resolution=(64, 48), seed=7)
    defaults.update(kw)
    make = lambda base, **extra: synthetic_scenes(base, **extra)(**defaults)  # noqa: E731
    if kw.get("resolution") == "native":
        defaults["resolution"] = (128, 96)
    return make(port_bd.BaseDataset), make(jax_bd.BaseDataset)


def assert_views_match(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        for key in ("idx", "label", "instance", "is_metric_scale", "is_synthetic", "data_norm_type"):
            assert g[key] == w[key], (what, key)
        np.testing.assert_allclose(g["img_no_norm"], w["img_no_norm"], atol=GREY + 1e-6, rtol=0, err_msg=what)
        assert_geometry_match(g, w, what)


def assert_geometry_match(g, w, what):
    for key in GEOMETRY_KEYS + ("depthmap", "camera_intrinsics"):
        scale = max(float(np.abs(w[key]).max()), 1e-12)
        np.testing.assert_allclose(g[key], w[key], atol=1e-5 * scale, rtol=0, err_msg=f"{what} {key}")
    same_depth = np.asarray(g["depthmap"]).squeeze(-1) == np.asarray(w["depthmap"]).squeeze(-1)
    for key in MASK_KEYS:
        assert np.array_equal(np.asarray(g[key])[same_depth], np.asarray(w[key])[same_depth]), (what, key)


@pytest.mark.parametrize("native", [True, False])
def test_items_match_jax(native):
    """Items over a resize (aug_crop jitter, no colour transform: the images within a
    grey level) with the native walk and with the numpy walk."""
    port, jax = pair(aug_crop=16, transform="imgnorm", num_views=5)
    port.use_native_sampler = jax.use_native_sampler = native
    for idx in range(len(port)):
        assert_views_match(port[(idx, 0)], jax[(idx, 0)], f"item {idx}")


def test_items_with_colour_augmentation_match_jax():
    """At the images' own size (no resize: both packages copy the pixels), the colour
    augmentation sees equal inputs and the same generator: the images within 1e-6."""
    port, jax = pair(resolution="native", transform="colorjitter+grayscale+gaublur")
    for idx in range(len(port)):
        got, want = port[(idx, 0)], jax[(idx, 0)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["img"], w["img"], atol=1e-6, rtol=0)
        assert_views_match(got, want, f"item {idx}")


def test_a_failed_item_is_retried_with_an_index_from_its_own_generator():
    port, _ = pair(fail_on=(2,))
    views = port[(2, 0)]
    retried = int(np.random.default_rng(7 + 0 + 2).integers(0, len(port)))  # the failed item's generator
    assert port.calls == [2, retried] and views[0]["label"] == f"scene{retried}"
    again, _ = pair(fail_on=(2,))
    assert again[(2, 0)][0]["label"] == views[0]["label"]  # the same in every process
    never, _ = pair(fail_on=(1,), max_num_retries=0)
    with pytest.raises(RuntimeError, match="fails once"):
        never[(1, 0)]


def test_collate_and_pointmaps_match_jax():
    port, jax = pair()
    samples_p, samples_j = [port[(i, 0)] for i in range(3)], [jax[(i, 0)] for i in range(3)]
    got, want = port_bd.collate_views(samples_p), jax_bd.collate_views(samples_j)
    assert sorted(got) == sorted(want) and got["label"] == want["label"]
    for key in ("is_metric_scale", "is_synthetic"):
        assert np.array_equal(got[key], want[key])
    rng = np.random.RandomState(3)
    depth = rng.uniform(0.5, 3, (12, 16)).astype(np.float32)
    K = np.array([[20.0, 0, 7.5], [0, 21.0, 5.5], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1, -2, 0.5]
    g, w = port_bd.pointmaps_and_rays_from_depth(depth, K, pose), jax_bd.pointmaps_and_rays_from_depth(depth, K, pose)
    assert all(np.array_equal(g[k], w[k]) for k in w)


def test_dsl_matches_jax():
    (p1, j1), (p2, j2) = pair(), pair(num_views=4, seed=11)
    port, jax = 20 @ p1 + 2 * p2, 20 @ j1 + 2 * j2
    assert isinstance(port, port_easy.CatDataset) and len(port) == len(jax) == 32 and repr(port) == repr(jax)
    assert repr(1_200_000 @ p1) == repr(1_200_000 @ j1) == "1_200_000 @ Synthetic(6)"
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        for i in (0, 5, 19, 20, 31):
            assert_views_match(port[(i, 0)], jax[(i, 0)], f"epoch {epoch} item {i}")


# ---------------------------------------------------------------- the loader


def test_loader_batches_match_jax_in_order():
    """Two epochs of the train loader (variable view counts, two aspect ratios, the crop
    jitter, no colour augmentation: that is held at the images' own size above; two
    worker processes) against the JAX loader: every batch, in order. The JAX loader
    runs one thread: its threads share the dataset object, whose per-item generator
    and seed offset are attributes, so two of them race (each process of the port's
    holds its own copy)."""
    kw = dict(num_views=4, variable_num_views=True, resolution=[(64, 48), (48, 64)], aug_crop=8)
    (p, j) = pair(**kw)
    port = port_loader.MultiViewDataLoader(10 @ p, images_per_batch=8, num_workers=2)
    jax = jax_loader.MultiViewDataLoader(10 @ j, images_per_batch=8, num_workers=1)
    assert len(port) == len(jax)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        got, want = list(port), list(jax)
        assert len(got) == len(want) > 1
        for b, (g, w) in enumerate(zip(got, want)):
            assert sorted(g) == sorted(w) and g["label"] == w["label"], (epoch, b)
            assert g["img"].shape == w["img"].shape
            std = np.asarray([0.229, 0.224, 0.225], np.float32)
            np.testing.assert_allclose(g["img"] * std, w["img"] * std, atol=GREY + 1e-6, rtol=0)
            for key in GEOMETRY_KEYS:
                scale = max(float(np.abs(w[key]).max()), 1e-12)
                np.testing.assert_allclose(g[key], w[key], atol=1e-5 * scale, rtol=0, err_msg=f"{epoch} {b} {key}")
            for key in MASK_KEYS + ("is_metric_scale", "is_synthetic"):
                assert np.array_equal(g[key], w[key]), (epoch, b, key)


def test_loader_raises_a_worker_failure_and_the_test_loader_matches_jax():
    p, j = pair(max_num_retries=0)
    p.fail_on = {0, 1, 2, 3, 4, 5}
    loader = port_loader.MultiViewDataLoader(p, images_per_batch=4, num_workers=2)
    loader.set_epoch(0)
    with pytest.raises(RuntimeError, match="fails once"):
        list(loader)
    p2, j2 = pair()
    got = port_loader.get_test_data_loader(p2, batch_size=2, num_workers=1)
    want = jax_loader.get_test_data_loader(j2, batch_size=2)
    got.set_epoch(3)
    want.set_epoch(3)
    gb, wb = list(got), list(want)
    assert len(got) == len(want) and len(gb) == len(wb) == 3
    for g, w in zip(gb, wb):
        assert g["label"] == w["label"]
        for key in GEOMETRY_KEYS:
            np.testing.assert_allclose(g[key], w[key], atol=1e-5 * max(float(np.abs(w[key]).max()), 1e-12), rtol=0)


# ---------------------------------------------------------------- splits


@pytest.mark.parametrize("dataset", sorted(jax_splits.SPLIT_RULES) + ["unknown"])
def test_splits_match_jax(dataset):
    lists = jax_splits.reference_split_lists()
    scenes = [f"{k:04d}" for k in range(30)] + ["train/0013", "val/0001", "HongKong", "0015_0",
                                                  "5a3ca9cb270f0ef2ec2e9e5d0000000a"]
    for d in (d for d in lists.values() if isinstance(d, dict)):
        for v in d.values():
            scenes += list(v)[:20] if isinstance(v, list) else []
    assert port_splits.split_scenes(dataset, scenes) == jax_splits.split_scenes(dataset, scenes)
    assert port_splits.reference_split_lists() == lists


# ---------------------------------------------------------------- camera functions and the image grid


def camera_inputs(seed, lead=(2, 3), h=5, w=7):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.5, 4.0, lead + (h, w)).astype(np.float32)
    K = np.tile(np.array([[30.0, 0, 3.2], [0, 28.0, 2.1], [0, 0, 1]], np.float32), lead + (1, 1))
    K[..., 0, 0] += rng.uniform(-5, 5, lead).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(*lead, 3, 3))
    pose = np.tile(np.eye(4, dtype=np.float32), lead + (1, 1))
    pose[..., :3, :3] = q
    pose[..., :3, 3] = rng.randn(*lead, 3)
    return depth, K, pose.astype(np.float32)


def test_camera_functions_match_jax():
    depth, K, pose = camera_inputs(0)
    t = torch.from_numpy
    pairs = [
        (port_camera.depthmap_to_world_frame(t(depth), t(K), t(pose)), jax_camera.depthmap_to_world_frame(
            jnp.asarray(depth), jnp.asarray(K), jnp.asarray(pose))),
        (port_camera.depthmap_to_world_frame(t(depth), t(K)), jax_camera.depthmap_to_world_frame(
            jnp.asarray(depth), jnp.asarray(K))),
        (port_camera.rays_in_world_frame(t(K), 5, 7, True, t(pose)),
         jax_camera.rays_in_world_frame(jnp.asarray(K), 5, 7, True, jnp.asarray(pose))),
        (port_camera.rays_in_world_frame(t(K), 5, 7, False),
         jax_camera.rays_in_world_frame(jnp.asarray(K), 5, 7, False)),
    ]
    pts = port_camera.depthmap_to_camera_frame(t(depth), t(K))[0]
    pts_j = jnp.asarray(pts.numpy())
    pairs += [
        ((port_camera.transform_pts3d(pts, t(pose)),), (jax_camera.transform_pts3d(pts_j, jnp.asarray(pose)),)),
        ((port_camera.project_pts3d_to_image(pts, t(K)[..., None, None, :, :]),),
         (jax_camera.project_pts3d_to_image(pts_j, jnp.asarray(K)[..., None, None, :, :]),)),
        ((port_camera.project_pts3d_to_image(pts, t(K)[..., None, None, :, :], True),),
         (jax_camera.project_pts3d_to_image(pts_j, jnp.asarray(K)[..., None, None, :, :], True),)),
        ((port_camera.colmap_to_opencv_intrinsics(t(K)),), (jax_camera.colmap_to_opencv_intrinsics(jnp.asarray(K)),)),
        ((port_camera.opencv_to_colmap_intrinsics(t(K)),), (jax_camera.opencv_to_colmap_intrinsics(jnp.asarray(K)),)),
    ]
    rays = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
    dist = torch.linalg.norm(pts, dim=-1, keepdim=True)
    pairs.append(((port_camera.pts3d_cam_from_rays_depth(rays, dist),),
                  (jax_camera.pts3d_cam_from_rays_depth(jnp.asarray(rays.numpy()), jnp.asarray(dist.numpy())),)))
    for k, (got, want) in enumerate(pairs):
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6 * max(1.0, float(np.abs(w).max())), rtol=0,
                                       err_msg=f"pair {k}")
    before = t(K).clone()
    port_camera.colmap_to_opencv_intrinsics(t(K))
    assert torch.equal(t(K), before)  # a new tensor, the input untouched


@pytest.mark.parametrize("ncols", [None, 1, 3])
def test_save_views_as_image_matches_jax(tmp_path, ncols):
    import cv2

    views = np.random.default_rng(4).uniform(-0.1, 1.1, (5, 9, 11, 3)).astype(np.float32)
    port_viz.save_views_as_image(views, tmp_path / "port" / "grid.png", ncols)
    jax_viz.save_views_as_image(views, tmp_path / "jax" / "grid.png", ncols)
    got, want = (cv2.imread(str(tmp_path / d / "grid.png")) for d in ("port", "jax"))
    assert got is not None and np.array_equal(got, want)
    with pytest.raises(ValueError, match="PNG"):
        port_viz.save_views_as_image(views, tmp_path / "grid.jpg")


def test_images_per_batch_budget_counts_the_dataset_views():
    """A variable view count (2..4) takes the JAX budget; a fixed one divides the images
    by its own count, where the JAX loader divides by 2 (a fixed 4 views got B=2, 8
    images, for images_per_batch=4)."""
    for variable in (True, False):
        p, j = pair(num_views=4, variable_num_views=variable)
        port = port_loader.MultiViewDataLoader(p, images_per_batch=4, num_workers=0)
        jax = jax_loader.MultiViewDataLoader(j, images_per_batch=4, num_workers=1)
        port.set_epoch(0)
        jax.set_epoch(0)
        got, want = list(port.sampler), list(jax.sampler)
        if variable:
            assert got == want
        else:
            assert {len(b) for b in got} == {1} and {len(b) for b in want} == {2}
            assert len(port) == 2 * len(jax) == 6
