"""The port's WAI processing stages against the JAX package's, on the CPU.

Covisibility, depth-consistency confidence, the plane sweep and
``run_mvs_on_scene``, ``run_moge_on_scene`` (small MoGe, the JAX tree's seeded
weights carried over by ``load_jax_params``), the rasterizer and
``render_scene_frames``, undistortion (the JAX functions call cv2 here) and
the baseline JPEG encoder, each on the same numpy-seeded inputs. Every port
function runs with ``device="cpu"``.

Tolerances:
- covisibility within 2e-3 absolute (its reprojection's products accumulate
  as XLA's CPU dot does, so it reads 0 here);
- confidence equal at >= 99.9% of pixels;
- plane-sweep depth within 1e-4 relative at >= 99.5% of pixels, a pixel also
  counting where its parabola is ill-conditioned: a 3e-5 change of a score
  (XLA fuses the ZNCC's products and approximates rsqrt; the two packages'
  scores differ by up to ~6e-5, 5e-7 at the median, 5e-5 at the 99.9th
  percentile) moves its depth by more than 1e-4, or its top two planes tie
  within 3e-5. Off the ties every pixel stays within one plane step; the
  confidence within 1e-3;
- MoGe depth within 1e-4 of its magnitude where both masks hold, the masks
  equal at >= 99.9% of pixels;
- rendering: depth within 1e-5 relative, face ids equal but for pixels on an
  edge two faces share (<= 0.1%), colours within 1e-5;
- undistortion: the new K within 1e-4 relative, the ROI exact, uint8 images
  within one grey level (they read equal), depth equal but for a stated count
  of pixels whose 1/32 position rounds the other way (0 here), masks exact;
- the JPEG encoder: cv2.imwrite's bytes, decoded pixels within one grey level.
"""

import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.data_processing import covisibility as jax_covis
from mapanything_tpu.data_processing import depth_confidence as jax_conf
from mapanything_tpu.data_processing import pseudo_depth as jax_pd
from mapanything_tpu.data_processing import rendering as jax_render
from mapanything_tpu.data_processing import undistort as jax_undistort
from mapanything_tpu.models.external import moge as jax_moge
from mapanything_tpu_torch.data_processing import covisibility as port_covis
from mapanything_tpu_torch.data_processing import depth_confidence as port_conf
from mapanything_tpu_torch.data_processing import pseudo_depth as port_pd
from mapanything_tpu_torch.data_processing import rendering as port_render
from mapanything_tpu_torch.data_processing import undistort as port_undistort
from mapanything_tpu_torch.models.external import moge as port_moge
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.exr import read_depth_exr
from mapanything_tpu_torch.utils.jax_params import load_jax_params
from mapanything_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from test_covisibility import make_scene
from test_data_processing_extra import _texture, make_plane_scene, write_wai_scene
from test_torch_port_infer import seeded_params

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

COVIS_ATOL = 2e-3
CONF_AGREEMENT = 0.999
SWEEP_RTOL, SWEEP_AGREEMENT, SCORE_EPS = 1e-4, 0.995, 3e-5
MOGE_RTOL, MASK_AGREEMENT = 1e-4, 0.999
RENDER_RTOL, FACE_TIES, COLOR_ATOL = 1e-5, 1e-3, 1e-5
K_RTOL = 1e-4


def rotation(ax, ang):
    c, s = np.cos(ang), np.sin(ang)
    R = np.eye(3)
    i, j = [k for k in range(3) if k != ax]
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def random_depth_scene(V, H, W, seed):
    """Views around a noisy surface: rotations, translations, holes."""
    rng = np.random.RandomState(seed)
    K = np.array([[0.9 * W, 0, W / 2 - 0.3], [0, 0.95 * W, H / 2 + 0.2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        poses[v, :3, :3] = rotation(1, rng.uniform(-0.1, 0.1)) @ rotation(0, rng.uniform(-0.1, 0.1))
        poses[v, :3, 3] = [0.15 * v, rng.uniform(-0.1, 0.1), rng.uniform(-0.2, 0.2)]
    depths = (3.0 + np.random.RandomState(seed + 1).uniform(-0.05, 0.05, (V, H, W))).astype(np.float32)
    depths[:, : H // 5, : W // 6] = 0.0
    return depths, np.tile(K, (V, 1, 1)), poses


def textured_views(V=4, H=48, W=64, depth=4.0, seed=0):
    """Images of a textured plane at z = ``depth`` from generic cameras (small
    rotations, translations in x, y and z), their intrinsics and cam2world
    poses: no pixel row maps exactly onto an image border, where float32
    rounding alone would decide validity."""
    rng = np.random.RandomState(seed)
    K = np.array([[50.0, 0, W / 2 - 0.37], [0, 52.0, H / 2 - 0.61], [0, 0, 1]], np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    imgs, poses = [], []
    for v in range(V):
        c2w = np.eye(4)
        c2w[:3, :3] = rotation(1, rng.uniform(-0.05, 0.05)) @ rotation(0, rng.uniform(-0.05, 0.05))
        c2w[:3, 3] = [0.25 * v + rng.uniform(-0.03, 0.03), rng.uniform(-0.05, 0.05), rng.uniform(-0.1, 0.1)]
        rays = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs, float)], -1) @ c2w[:3, :3].T
        wp = c2w[:3, 3] + ((depth - c2w[2, 3]) / rays[..., 2])[..., None] * rays
        g = _texture(wp[..., 0], wp[..., 1])
        imgs.append(np.clip(np.stack([g, 0.9 * g, 1.1 * g], -1), 0, 1))
        poses.append(c2w)
    return np.stack(imgs).astype(np.float32), np.tile(K, (V, 1, 1)), np.stack(poses).astype(np.float32)


# ---------------------------------------------------------------- covisibility and confidence


COVIS_SCENES = {
    "x_translation_v4": lambda: make_scene(V=4),
    "x_translation_v9_padded": lambda: make_scene(V=9, offset=0.1),
    "random_depth_v5": lambda: random_depth_scene(5, 60, 80, 3),
    "random_depth_v11": lambda: random_depth_scene(11, 48, 72, 4),
}


@pytest.mark.parametrize("name", sorted(COVIS_SCENES))
def test_covisibility_matches_jax(name, record_property):
    depths, Ks, poses = COVIS_SCENES[name]()
    for kwargs in ({}, {"depth_assoc_error_temp": 0.3, "chunk_size": 3}):
        want = jax_covis.compute_pairwise_covisibility(depths, Ks, poses, **kwargs)
        got = port_covis.compute_pairwise_covisibility(depths, Ks, poses, device="cpu", **kwargs)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=COVIS_ATOL, rtol=0)
        record_property(f"differing_{len(kwargs)}", int((got != want).sum()))


CONF_SCENES = {
    "plane_v3": lambda: make_plane_scene(V=3),
    "plane_corrupted_v4": lambda: corrupted(make_plane_scene(V=4)),
    "random_depth_v6": lambda: random_depth_scene(6, 30, 40, 5),
}


def corrupted(scene):
    depths, Ks, poses = scene
    depths = depths.copy()
    depths[1] *= 1.3
    depths[2, :5] = 0.0
    return depths, Ks, poses


@pytest.mark.parametrize("name", sorted(CONF_SCENES))
def test_depth_confidence_matches_jax(name, record_property):
    depths, Ks, poses = CONF_SCENES[name]()
    want = jax_conf.compute_depth_consistency_confidence(depths, Ks, poses)
    got = port_conf.compute_depth_consistency_confidence(depths, Ks, poses, device="cpu")
    assert got.shape == want.shape and got.dtype == want.dtype
    agree = float((got == want).mean())
    record_property("equal_fraction", agree)
    assert agree >= CONF_AGREEMENT


def test_depth_confidence_writer_matches_jax(tmp_path):
    depths, Ks, poses = make_plane_scene(V=3)
    conf = port_conf.compute_depth_consistency_confidence(depths, Ks, poses, device="cpu")
    names = [f"frame_{i:04d}" for i in range(3)]
    for side, writer in (("jax", jax_conf.write_depth_confidence), ("port", port_conf.write_depth_confidence)):
        write_wai_scene(tmp_path / side / "scene", np.zeros((3, 24, 32, 3), np.float32), Ks, poses, depths)
        writer(tmp_path / side / "scene", names, conf)
    assert json.loads((tmp_path / "port" / "scene" / "scene_meta.json").read_text()) == \
        json.loads((tmp_path / "jax" / "scene" / "scene_meta.json").read_text())
    for name in names:
        rel = Path("covisibility/v0/depth_confidence") / f"{name}.exr"
        np.testing.assert_array_equal(read_depth_exr(tmp_path / "port" / "scene" / rel), read_depth_exr(tmp_path / "jax" / "scene" / rel))


# ---------------------------------------------------------------- plane sweep


def sweep_inputs(imgs, Ks, poses, ref, nbrs):
    w2c = np.linalg.inv(poses)
    return (imgs[ref], imgs[nbrs], Ks[ref], Ks[nbrs], (w2c[nbrs] @ poses[ref]).astype(np.float32))


def port_scores(args, dmin, dmax, num_planes):
    tensors = [torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in (*args, dmin, dmax)]
    scores, inv_d = port_pd.plane_scores(*tensors, num_planes=num_planes)
    return scores.numpy(), inv_d.numpy()


def check_sweep(want, got, scores, inv_d, record_property, tag=""):
    stats = port_pd.sweep_agreement(want[0], got[0], scores, inv_d, eps=SCORE_EPS, rtol=SWEEP_RTOL)
    for k, v in stats.items():
        record_property(f"{tag}{k}", v)
    assert stats["within_rtol_or_sensitive"] >= SWEEP_AGREEMENT, stats
    assert stats["beyond_one_plane_off_ties"] == 0, stats
    return stats


@pytest.mark.parametrize("num_planes,radius", [(32, 2), (24, 1)])
def test_plane_sweep_matches_jax(num_planes, radius, record_property):
    imgs, Ks, poses = textured_views(V=3)
    args = sweep_inputs(imgs, Ks, poses, 0, [1, 2])
    want = [np.asarray(x) for x in jax_pd._plane_sweep_jit()(*map(jnp.asarray, args), 2.0, 8.0,
                                                              num_planes=num_planes, window_radius=radius)]
    got = port_pd.plane_sweep_depth(*args, 2.0, 8.0, num_planes=num_planes, window_radius=radius, device="cpu")
    assert got[0].dtype == got[1].dtype == np.float32 and got[0].shape == want[0].shape
    scores, inv_d = port_scores(args, 2.0, 8.0, num_planes)
    check_sweep(want, got, scores, inv_d, record_property)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    # The hypotheses are jnp.linspace's, to an ulp (XLA fuses its arithmetic).
    np.testing.assert_allclose(inv_d, np.asarray(jnp.linspace(jnp.float32(1 / 8.0), jnp.float32(1 / 2.0), num_planes)),
                               rtol=2e-7, atol=0)


def test_run_mvs_on_scene_matches_jax(tmp_path, record_property):
    imgs, Ks, poses = textured_views(V=4, seed=1)
    for side in ("jax", "port"):
        write_wai_scene(tmp_path / side / "scene", imgs, Ks, poses)
    jax_pd.run_mvs_on_scene(tmp_path / "jax" / "scene", num_neighbors=2, num_planes=16)
    port_pd.run_mvs_on_scene(tmp_path / "port" / "scene", num_neighbors=2, num_planes=16, device="cpu")
    meta = json.loads((tmp_path / "port" / "scene" / "scene_meta.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "scene" / "scene_meta.json").read_text())
    # The neighbours and range run_mvs_on_scene picks (no covisibility: the nearest indices).
    centers = poses[:, :3, 3]
    d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    b = float(np.median(d[d > 0]))
    for i, fr in enumerate(meta["frames"]):
        nbrs = [j for j in np.argsort(np.abs(np.arange(4) - i)) if j != i][:2]
        want = read_depth_exr(tmp_path / "jax" / "scene" / fr["mvs_depth"])
        got = read_depth_exr(tmp_path / "port" / "scene" / fr["mvs_depth"])
        scores, inv_d = port_scores(sweep_inputs(imgs, Ks, poses.astype(np.float64), i, nbrs), 0.1 * b, 50 * b, 16)
        both = (want > 0) & (got > 0)  # pixels kept by the confidence threshold on both sides
        assert ((want > 0) == (got > 0)).mean() >= SWEEP_AGREEMENT
        check_sweep((np.where(both, want, 1.0),), (np.where(both, got, 1.0),), scores, inv_d, record_property, f"f{i}_")


# ---------------------------------------------------------------- MoGe


@pytest.fixture(scope="module")
def moge_pair():
    cfg = jax_moge.MoGeConfig.small()
    wrapper = jax_moge.MoGeWrapper(cfg)
    shapes = jax.eval_shape(wrapper.init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 42, 3), jnp.float32))["params"]
    params = seeded_params(shapes, 5)
    port = port_moge.MoGeWrapper(port_moge.MoGeConfig.small(), device="cpu")
    load_jax_params(port, params)
    return {"params": params}, port


def test_run_moge_on_scene_matches_jax(moge_pair, tmp_path, record_property):
    params, port = moge_pair
    imgs = np.random.RandomState(0).rand(5, 28, 42, 3).astype(np.float32)
    Ks = np.tile(np.array([[30.0, 0, 20.5], [0, 30.0, 13.5], [0, 0, 1]], np.float32), (5, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    for side in ("jax", "port"):
        write_wai_scene(tmp_path / side / "scene", imgs, Ks, poses)
    want = jax_pd.run_moge_on_scene(tmp_path / "jax" / "scene", params=params, batch_size=2)
    got = port_pd.run_moge_on_scene(tmp_path / "port" / "scene", model=port, batch_size=2)
    assert [p.relative_to(tmp_path / "port") for p in got] == [p.relative_to(tmp_path / "jax") for p in want]
    assert json.loads((tmp_path / "port" / "scene" / "scene_meta.json").read_text()) == \
        json.loads((tmp_path / "jax" / "scene" / "scene_meta.json").read_text())
    a = np.stack([read_depth_exr(p) for p in want])
    b = np.stack([read_depth_exr(p) for p in got])
    agree = float(((a > 0) == (b > 0)).mean())
    both = (a > 0) & (b > 0)
    assert agree >= MASK_AGREEMENT and both.any()
    scale = max(1.0, float(np.abs(a[both]).max()))
    err = float(np.abs(a[both] - b[both]).max()) / scale
    record_property("mask_agreement", agree)
    record_property("depth_err_over_magnitude", err)
    assert err <= MOGE_RTOL


def test_run_moge_without_a_model_seeds_the_small_config(tmp_path):
    imgs = np.random.RandomState(1).rand(2, 28, 28, 3).astype(np.float32)
    write_wai_scene(tmp_path / "s", imgs, np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
                    np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    paths = port_pd.run_moge_on_scene(tmp_path / "s", batch_size=2, device="cpu")
    d = read_depth_exr(paths[0])
    assert d.shape == (28, 28) and np.isfinite(d).all() and (d >= 0).all()


# ---------------------------------------------------------------- rendering


def height_field(n, seed=0, colors=True):
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.linspace(-2, 2, n + 1), np.linspace(-1.5, 1.5, n + 1))
    zs = 5.0 + 0.3 * np.sin(2.1 * xs) * np.cos(1.7 * ys) + 0.05 * rng.randn(*xs.shape)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3), np.stack([a, d, c], -1).reshape(-1, 3)])
    faces = faces[rng.permutation(len(faces))].astype(np.int32)
    cols = rng.rand(len(verts), 3).astype(np.float32) if colors else None
    return verts, faces, cols


RENDER_CASES = {
    "front": (np.array([[60.0, 0, 31.7], [0, 60.0, 23.2], [0, 0, 1]]), [0.1, -0.05, 0.2], 0.0),
    "oblique_clipped": (np.array([[45.0, 0, 30.1], [0, 47.0, 25.3], [0, 0, 1]]), [1.2, 0.3, 2.9], 0.35),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_mesh_matches_jax(case, record_property):
    K, t, yaw = RENDER_CASES[case]
    verts, faces, cols = height_field(20, seed=len(case))
    c2w = np.eye(4)
    c2w[:3, :3] = rotation(1, yaw)
    c2w[:3, 3] = t
    want = jax_render.render_mesh(verts, faces, K, c2w, 50, 66, vertex_colors=cols, far=7.5)
    got = port_render.render_mesh(verts, faces, K, c2w, 50, 66, vertex_colors=cols, far=7.5, device="cpu")
    hit = want[0] > 0
    np.testing.assert_array_equal(got[0] > 0, hit)
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=RENDER_RTOL, atol=0)
    differ = got[1] != want[1]
    record_property("face_ids_differing", int(differ.sum()))
    assert differ.mean() <= FACE_TIES
    same = ~differ
    np.testing.assert_allclose(got[2][same], want[2][same], atol=COLOR_ATOL, rtol=0)
    assert got[1].dtype == want[1].dtype and got[2].dtype == want[2].dtype


def test_render_occlusion_ties_go_to_the_lowest_face():
    """Two copies of one quad at the same depth and a nearer one behind them in
    the face order: the nearer wins, and between the copies the lower id."""
    quad = np.array([[-10, -10, 5.0], [10, -10, 5.0], [10, 10, 5.0], [-10, 10, 5.0]], np.float32)
    near = quad * np.array([0.2, 0.2, 0.8], np.float32)
    verts = np.concatenate([quad, quad, near])
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7], [8, 9, 10], [8, 10, 11]], np.int32)
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]])
    want = jax_render.render_mesh(verts, faces, K, np.eye(4), 48, 64, tri_chunk=2)
    got = port_render.render_mesh(verts, faces, K, np.eye(4), 48, 64, device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    assert set(np.unique(got[1])) <= {0, 1, 4, 5}


def test_ply_reader_matches_jax_on_ascii_and_reads_binary(tmp_path):
    verts, faces, cols = height_field(3, seed=2)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}", "property float x", "property float y",
             "property float z", "property uchar red", "property uchar green", "property uchar blue",
             f"element face {len(faces) + 1}", "property list uchar int vertex_indices", "end_header"]
    rgb = np.round(cols * 255).astype(int)
    lines += [f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}" for v, c in zip(verts, rgb)]
    lines += [f"3 {f[0]} {f[1]} {f[2]}" for f in faces] + ["4 0 1 5 4"]
    (tmp_path / "a.ply").write_text("\n".join(lines) + "\n")
    for got, want in zip(port_render.read_ply_mesh(tmp_path / "a.ply"), jax_render.read_ply_mesh(tmp_path / "a.ply")):
        np.testing.assert_array_equal(got, want)
    port_render.write_ply_mesh(tmp_path / "b.ply", verts, faces, cols)
    v, f, c = port_render.read_ply_mesh(tmp_path / "b.ply")
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)
    np.testing.assert_array_equal(c, rgb.astype(np.float32) / 255.0)
    with pytest.raises(KeyError):  # the JAX reader's binary face lists (ROADMAP §3)
        jax_render.read_ply_mesh(tmp_path / "b.ply")


def test_render_scene_frames_matches_jax(tmp_path):
    verts, faces, cols = height_field(12, seed=3)
    imgs = np.zeros((2, 40, 52, 3), np.float32)
    Ks = np.tile(np.array([[45.0, 0, 25.5], [0, 45.0, 19.5], [0, 0, 1]], np.float32), (2, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[1, :3, 3] = [0.3, -0.1, 0.2]
    rgb = np.round(cols * 255).astype(int)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}", "property float x", "property float y",
             "property float z", "property uchar red", "property uchar green", "property uchar blue",
             f"element face {len(faces)}", "property list uchar int vertex_indices", "end_header"]
    lines += [f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}" for v, c in zip(verts, rgb)]
    lines += [f"3 {f[0]} {f[1]} {f[2]}" for f in faces]
    mods = ("rendered_depth", "rendered_mesh_faces", "rendered_image")
    for side in ("jax", "port"):
        meta = write_wai_scene(tmp_path / side / "scene", imgs, Ks, poses)
        (tmp_path / side / "scene" / "mesh.ply").write_text("\n".join(lines) + "\n")
        meta["scene_modalities"] = {"mesh": {"scene_key": "mesh.ply", "format": "mesh"}}
        (tmp_path / side / "scene" / "scene_meta.json").write_text(json.dumps(meta))
    jax_render.render_scene_frames(tmp_path / "jax" / "scene", modalities=mods)
    port_render.render_scene_frames(tmp_path / "port" / "scene", modalities=mods, device="cpu")
    meta = json.loads((tmp_path / "port" / "scene" / "scene_meta.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "scene" / "scene_meta.json").read_text())
    for fr in meta["frames"]:
        a, b = (read_depth_exr(tmp_path / s / "scene" / fr["rendered_depth"]) for s in ("jax", "port"))
        np.testing.assert_allclose(b, a, rtol=RENDER_RTOL, atol=0)
        fa, fb = (np.load(tmp_path / s / "scene" / fr["rendered_mesh_faces"])["face_id"] for s in ("jax", "port"))
        assert (fa != fb).mean() <= FACE_TIES
        ia, ib = (cv2.imread(str(tmp_path / s / "scene" / fr["rendered_image"])) for s in ("jax", "port"))
        assert np.abs(ia.astype(int) - ib).max() <= 1


# ---------------------------------------------------------------- undistortion


def cam(model, w=64, h=48, **dist):
    return dict(fl_x=60.0, fl_y=61.5, cx=31.2, cy=23.7, w=w, h=h, camera_model=model, **dist)


UNDISTORT_CAMS = {
    "fisheye": cam("OPENCV_FISHEYE", k1=0.05, k2=-0.01, k3=0.002, k4=-0.001),
    "fisheye_zero": cam("OPENCV_FISHEYE", k1=0.0, k2=0.0, k3=0.0, k4=0.0),
    "fisheye_odd": cam("OPENCV_FISHEYE", w=63, h=47, k1=-0.08, k2=0.02, k3=0.0, k4=0.0),
    "opencv_barrel": cam("OPENCV", k1=-0.2, k2=0.05, p1=0.002, p2=-0.001, k3=0.01),
    "opencv_pincushion": cam("OPENCV", k1=0.1, k2=0.02, p1=-0.001, p2=0.0015),
    "opencv_wide": cam("OPENCV", w=100, h=40, k1=-0.05, k2=0.0, p1=0.0, p2=0.0),
}


def jax_tables(c, center=True):
    new_K, w, h, m1, m2, roi = jax_undistort.undistort_precompute(c, center)
    return new_K, w, h, (m1, m2), roi


def cv2_maps_for_port(m1, m2):
    """The JAX tables in the port's form."""
    if m2.dtype == np.uint16:  # CV_16SC2 + CV_16UC1
        return port_undistort.UndistortMaps(m1, m2)
    return port_undistort.UndistortMaps(np.stack([m1, m2], -1))


@pytest.mark.parametrize("name", sorted(UNDISTORT_CAMS))
def test_undistort_tables_match_cv2(name, record_property):
    c = UNDISTORT_CAMS[name]
    for center in (True, False):
        want_K, w, h, (m1, m2), roi = jax_tables(c, center)
        got_K, gw, gh, maps, groi = port_undistort.undistort_precompute(c, center)
        assert (gw, gh, groi) == (w, h, roi)
        assert got_K.dtype == want_K.dtype
        np.testing.assert_allclose(got_K, want_K, rtol=K_RTOL, atol=0)
        if maps.frac is None:
            np.testing.assert_allclose(maps.xy, np.stack([m1, m2], -1), atol=1e-3, rtol=0)
        else:
            moved = int(((maps.xy != m1).any(-1) | (maps.frac != m2)).sum())
            record_property(f"map_entries_rounding_the_other_way_{center}", moved)
            assert moved <= 1e-3 * maps.frac.size


@pytest.mark.parametrize("name", sorted(UNDISTORT_CAMS))
def test_undistort_remaps_match_cv2(name, record_property):
    """The port's remaps on cv2's own tables, then on the port's."""
    c = UNDISTORT_CAMS[name]
    rng = np.random.RandomState(len(name))
    img = rng.randint(0, 256, (c["h"], c["w"], 3)).astype(np.uint8)
    depth = rng.uniform(0.5, 9, (c["h"], c["w"])).astype(np.float32)
    mask = (rng.rand(c["h"], c["w"]) > 0.05).astype(np.uint8) * 255
    _, _, _, (m1, m2), roi = jax_tables(c)
    _, _, _, port_maps, _ = port_undistort.undistort_precompute(c)
    for tag, maps in (("cv2_tables", cv2_maps_for_port(m1, m2)), ("port_tables", port_maps)):
        got = port_undistort.undistort_image(img, maps, roi, device="cpu")
        want = jax_undistort.undistort_image(img, m1, m2, roi)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(int) - want).max() <= 1
        record_property(f"{tag}_image_pixels_differing", int((got != want).sum()))
        got_d = port_undistort.undistort_depth(depth, maps, roi, device="cpu")
        want_d = jax_undistort.undistort_depth(depth, m1, m2, roi)
        moved = int((got_d != want_d).sum())
        record_property(f"{tag}_depth_pixels_differing", moved)
        assert moved <= 1e-3 * got_d.size
        got_m = port_undistort.undistort_mask(mask, maps, roi, device="cpu")
        np.testing.assert_array_equal(got_m, jax_undistort.undistort_mask(mask, m1, m2, roi))


def test_update_camera_meta_matches_jax():
    c = UNDISTORT_CAMS["fisheye"]
    K = np.diag([50.0, 51.0, 1.0]).astype(np.float32)
    assert port_undistort.update_camera_meta(c, K, 60, 40) == jax_undistort.update_camera_meta(c, K, 60, 40)


@pytest.mark.parametrize("model", ["OPENCV_FISHEYE", "OPENCV"])
def test_undistort_scene_matches_jax(model, tmp_path):
    rng = np.random.RandomState(7)
    imgs = rng.rand(2, 48, 64, 3).astype(np.float32)
    depths = rng.uniform(1, 5, (2, 48, 64)).astype(np.float32)
    Ks = np.tile(np.array([[60.0, 0, 31.5], [0, 61.0, 23.5], [0, 0, 1]], np.float32), (2, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    dist = ({"k1": 0.05, "k2": -0.01, "k3": 0.0, "k4": 0.001} if model == "OPENCV_FISHEYE"
            else {"k1": -0.15, "k2": 0.03, "p1": 0.001, "p2": -0.002})
    masks = (rng.rand(2, 48, 64) > np.array([0.0, 0.02])[:, None, None]).astype(np.uint8) * 255
    for side in ("jax", "port"):
        scene = tmp_path / side / "scene"
        meta = write_wai_scene(scene, imgs, Ks, poses, depths)
        (scene / "masks").mkdir()
        for i, fr in enumerate(meta["frames"]):
            fr["image_distorted"] = fr.pop("image")
            fr["depth_distorted"] = fr.pop("depth")
            fr["mask_distorted"] = f"masks/{fr['frame_name']}.png"
            cv2.imwrite(str(scene / fr["mask_distorted"]), masks[i])
            fr.update(camera_model=model, **dist)
        meta["frame_modalities"] = {"image_distorted": {"frame_key": "image_distorted", "format": "image"}}
        (scene / "scene_meta.json").write_text(json.dumps(meta))
    mods = ("image_distorted", "depth_distorted", "mask_distorted")
    assert port_undistort.undistort_scene(tmp_path / "port" / "scene", mods, device="cpu") == \
        jax_undistort.undistort_scene(tmp_path / "jax" / "scene", mods)
    want = json.loads((tmp_path / "jax" / "scene" / "scene_meta.json").read_text())
    got = json.loads((tmp_path / "port" / "scene" / "scene_meta.json").read_text())
    for fw, fg in zip(want["frames"], got["frames"]):
        assert set(fw) == set(fg)
        for key in ("fl_x", "fl_y", "cx", "cy"):
            assert fg[key] == pytest.approx(fw[key], rel=K_RTOL)
        assert {k: fg[k] for k in fg if k not in ("fl_x", "fl_y", "cx", "cy")} == \
               {k: fw[k] for k in fw if k not in ("fl_x", "fl_y", "cx", "cy")}
        jpg_a, jpg_b = ((tmp_path / s / "scene" / fw["image"]).read_bytes() for s in ("jax", "port"))
        assert jpg_b == jpg_a  # cv2.imwrite's bytes
        np.testing.assert_array_equal(read_depth_exr(tmp_path / "port" / "scene" / fw["depth"]),
                                      read_depth_exr(tmp_path / "jax" / "scene" / fw["depth"]))
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / "scene" / fw["mask"]), cv2.IMREAD_UNCHANGED),
                                      cv2.imread(str(tmp_path / "jax" / "scene" / fw["mask"]), cv2.IMREAD_UNCHANGED))
    assert got["frame_modalities"] == want["frame_modalities"]


# ---------------------------------------------------------------- JPEG encoder


def jpeg_cases():
    rng = np.random.RandomState(9)
    photo = cv2.imread(str(Path(__file__).parent / "data" / "jpeg" / "frame_0.jpg"))[..., ::-1]
    return {
        "noise_16x16": rng.randint(0, 256, (16, 16, 3)),
        "noise_37x45": rng.randint(0, 256, (37, 45, 3)),
        "flat_1x1": np.full((1, 1, 3), 200),
        "photo_crop_101x77": photo[:101, :77],
        "photo_crop_99x133": photo[31:130, 400:533],
        "photo_crop_11x8": photo[5:16, 3:11],
        "gradient_64x48": np.stack([*np.meshgrid(np.arange(48) * 5, np.arange(64) * 4), np.full((64, 48), 77)], -1),
    }


@pytest.mark.parametrize("name", sorted(jpeg_cases()))
def test_jpeg_encoder_matches_cv2(name, tmp_path):
    rgb = np.ascontiguousarray(np.clip(jpeg_cases()[name], 0, 255).astype(np.uint8))
    ours = encode_jpeg(rgb)
    cv2.imwrite(str(tmp_path / "ref.jpg"), rgb[..., ::-1])
    ref = (tmp_path / "ref.jpg").read_bytes()
    decoded = decode_jpeg(ours)
    ref_pixels = cv2.imread(str(tmp_path / "ref.jpg"))[..., ::-1]
    assert np.abs(decoded.astype(int) - ref_pixels).max() <= 1
    assert ours == ref


# ---------------------------------------------------------------- devices


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    depths, Ks, poses = make_plane_scene(V=2)
    imgs = textured_views(V=2)[0]
    maps = port_undistort.UndistortMaps(np.zeros((2, 2, 2), np.float32))
    calls = [
        lambda: port_covis.compute_pairwise_covisibility(depths, Ks, poses),
        lambda: port_conf.compute_depth_consistency_confidence(depths, Ks, poses),
        lambda: port_pd.plane_sweep_depth(imgs[0], imgs[1:], Ks[0], Ks[1:], np.eye(4)[None], 1.0, 5.0),
        lambda: port_render.render_mesh(*height_field(2)[:2], Ks[0], np.eye(4), 8, 8),
        lambda: port_undistort.remap_nearest(depths[0], maps),
        lambda: port_undistort.remap_bilinear(np.zeros((4, 4), np.uint8), maps),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
