"""Bundle adjustment of the port against the JAX package's, on the CPU.

The solver (``ba/solver.py``): the Huber-weighted residuals and the Jacobian blocks of
``_build_system`` (the JAX package's from ``jax.jacfwd``, the port's in closed form),
``_exp_so3`` at and near 0, ``ba_solve`` (N = 64 tracks, M = 4 cameras, 3 iterations of
10 CG steps) with its cost history and state, ``refined_camera_poses``, and
``ba_solve_sharded`` on 2 gloo ranks against ``ba_solve``. The tracks (``ba/tracks.py``):
``extract_tracks_from_predictions`` with the JAX package's tie-break noise fed in. The
classical tracker (``ba/tracker.py``): the pyramid's downsample against
``jax.image.resize``, ``harris_keypoints`` on an image with fewer corners than
``max_points`` (the zero-score ties), ``track_points`` and ``predict_tracks``.

Tolerances: float outputs within 1e-4 of max(1, their magnitude) (the solver's state
and costs relative to their magnitude), except the tracker's pixel coordinates, within
1e-3 px; indices, selections and masks exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.ba import solver as jax_solver
from mapanything_tpu.ba import tracker as jax_tracker
from mapanything_tpu.ba import tracks as jax_tracks
from mapanything_tpu_torch.ba import solver, tracker, tracks
from mapanything_tpu_torch.parallel.distributed import run_ranks
from mapanything_tpu_torch.tools import view_parallel_ranks
from mapanything_tpu_torch.utils import threads

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

RTOL = 1e-4
PX_TOL = 1e-3


def close(got, want, rtol=RTOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return 0.0
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0, err_msg=name)
    return float(np.abs(got - want).max()) / scale


def rotation(axis_angle) -> np.ndarray:
    w = np.asarray(axis_angle, np.float64)
    t = np.linalg.norm(w)
    if t == 0:
        return np.eye(3)
    k = w / t
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def problem(seed=0, N=64, M=4, pose_noise=0.01, px_noise=0.5) -> dict:
    """Cameras on an arc around a point cloud: noisy observations (a tenth of them
    invalid, a few outliers for Huber), perturbed initial poses and points; numpy."""
    rng = np.random.RandomState(seed)
    points = rng.uniform(-1, 1, (N, 3))
    points[:, 2] += 6.0
    K = np.array([[300.0, 0, 128.0], [0, 300.0, 96.0], [0, 0, 1]])
    rots, transs, uvs = [], [], []
    for m in range(M):
        angle = (m - M / 2) * 0.15
        R_w2c = rotation([0, angle, 0]).T
        t_w2c = -R_w2c @ np.array([np.sin(angle) * 6.0, 0.0, 6.0 - np.cos(angle) * 6.0])
        uv = (points @ R_w2c.T + t_w2c) @ K.T
        uvs.append(uv[:, :2] / uv[:, 2:3] + rng.randn(N, 2) * px_noise)
        rots.append(rotation(rng.randn(3) * pose_noise) @ R_w2c)
        transs.append(t_w2c + rng.randn(3) * pose_noise * 5)
    uv = np.stack(uvs, axis=1)
    uv[rng.rand(N, M) < 0.05] += 20.0  # outliers: Huber weights below 1
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(points3d=f32(points + rng.randn(N, 3) * pose_noise), observations_uv=f32(uv),
                valid=rng.rand(N, M) > 0.1, intrinsics=f32(np.stack([K] * M)),
                cam_from_world_rot=f32(np.stack(rots)), cam_from_world_trans=f32(np.stack(transs)))


def jax_tracks_of(arrays):
    return jax_tracks.Tracks(**{k: jnp.asarray(v) for k, v in arrays.items()})


def port_tracks_of(arrays):
    return tracks.Tracks(**{k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def ba_problem():
    return problem()


def test_exp_so3_matches_jax_at_and_near_zero():
    ws = np.asarray([[0, 0, 0], [1e-5, -2e-5, 3e-6], [0.3, -0.2, 0.1], [2.0, 1.0, -0.5]], np.float32)
    want = np.stack([np.asarray(jax_solver._exp_so3(jnp.asarray(w))) for w in ws])
    got = solver._exp_so3(torch.from_numpy(ws))
    close(got, want, name="exp_so3")
    # The Taylor guard keeps the derivative at 0: d exp(w) / dw_x there is [e_x]x.
    jac = torch.autograd.functional.jacobian(solver._exp_so3, torch.zeros(3))
    torch.testing.assert_close(jac[..., 0], solver._skew(torch.tensor([1.0, 0, 0])), rtol=0, atol=1e-6)


def test_build_system_residuals_and_jacobian_blocks_match_jax(ba_problem):
    jt = jax_tracks_of(ba_problem)
    state = jax_solver.BAState(rot=jt.cam_from_world_rot, trans=jt.cam_from_world_trans, points=jt.points3d)
    want = jax.jit(lambda t, s: jax_solver._build_system(t, s, 2.0))(jt, state)
    pt = port_tracks_of(ba_problem)
    got = solver._build_system(pt, solver.BAState(pt.cam_from_world_rot, pt.cam_from_world_trans, pt.points3d), 2.0)
    for name, g, w in zip(("r", "Jc", "Jp"), got, want):
        close(g, w, name=name)
    # Some observations are down-weighted by Huber, the invalid ones zeroed.
    r = np.asarray(want[0])
    assert (np.abs(r[~ba_problem["valid"]]) == 0).all() and np.abs(r).max() > 2.0


def test_ba_solve_matches_jax_cost_history_and_state(ba_problem, record_property):
    jt = jax_tracks_of(ba_problem)
    j_state, j_costs = jax_solver.ba_solve(jt, 3, 10)
    p_state, p_costs = solver.ba_solve(port_tracks_of(ba_problem), 3, 10)
    j_costs = np.asarray(j_costs)
    assert j_costs[-1] < j_costs[0]  # the solver moved
    np.testing.assert_allclose(p_costs.numpy(), j_costs, rtol=RTOL)
    errs = {name: close(getattr(p_state, name), np.asarray(getattr(j_state, name)), name=name)
            for name in ("rot", "trans", "points")}
    close(solver.refined_camera_poses(p_state), np.asarray(jax_solver.refined_camera_poses(j_state)), name="poses")
    record_property("max_err_over_magnitude", max(errs.values()))


def test_ba_solve_sharded_on_two_gloo_ranks_matches_ba_solve(tmp_path):
    """In float64: the gauge prior (1e12) makes the reduced system stiff, so fp32 sums
    taken in another order move a step by ~1e-4 (the JAX package's own 8-device test
    allows 8%); in float64 the split and the reductions must agree to 1e-9."""
    arrays = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in problem(seed=3, N=63).items()}
    kw = dict(num_iterations=3, cg_iters=10)  # 63 tracks: one pad track
    want_state, want_costs = solver.ba_solve(port_tracks_of(arrays), **kw)
    ranks = run_ranks(view_parallel_ranks.ba_sharded, 2, "cpu", tmp_path / "rendezvous", arrays, kw)
    assert want_costs[-1] < want_costs[0]
    for rot, trans, points, costs in ranks:  # every rank holds the whole state
        np.testing.assert_allclose(costs, want_costs.numpy(), rtol=1e-9)
        for got, want, name in ((rot, want_state.rot, "rot"), (trans, want_state.trans, "trans"),
                                (points, want_state.points, "points")):
            close(got, want.numpy(), rtol=1e-9, name=name)


# ------------------------------------------------------------------ tracks


def predictions(seed=0, V=3, H=24, W=32):
    """Consistent dense predictions of one scene: depth, intrinsics, cam2world poses and
    the world pointmaps they make; confidence and a mask."""
    rng = np.random.RandomState(seed)
    depth = (2.0 + rng.rand(V, H, W)).astype(np.float32)
    K = np.tile(np.asarray([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (V, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(1, V):
        poses[v, :3, :3] = rotation([0, 0.05 * v, 0.02])
        poses[v, :3, 3] = [0.1 * v, 0.0, 0.02]
    v_, u_ = np.mgrid[:H, :W].astype(np.float32)
    cam = np.stack([(u_ - W / 2) * depth / 30.0, (v_ - H / 2) * depth / 30.0, depth], -1)
    pts = np.einsum("vij,vhwj->vhwi", poses[:, :3, :3], cam) + poses[:, None, None, :3, 3]
    conf = (1.0 + rng.rand(V, H, W)).astype(np.float32)
    mask = rng.rand(V, H, W) > 0.2
    return pts.astype(np.float32), depth, K, poses, conf, mask


def test_extract_tracks_matches_jax_with_its_noise():
    pts, depth, K, poses, conf, mask = predictions()
    V, H, W = depth.shape
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (V, H, W))) * 1e-3
    want = jax_tracks.extract_tracks_from_predictions(*(jnp.asarray(x) for x in (pts, depth, K, poses, conf, mask)),
                                                      points_per_view=40)
    got = tracks._extract_tracks(*(torch.from_numpy(x) for x in (pts, depth, K, poses, conf, mask, noise)),
                                 points_per_view=40, depth_consistency_rtol=0.05)
    for f in dataclasses.fields(tracks.Tracks):
        close(getattr(got, f.name), np.asarray(getattr(want, f.name)), name=f.name)
    assert 0 < int(np.asarray(want.valid).sum()) < want.valid.size  # some observations kept, some not
    # The public entry draws its own noise from a torch generator: the same shapes.
    drawn = tracks.extract_tracks_from_predictions(*(torch.from_numpy(x) for x in (pts, depth, K, poses, conf, mask)),
                                                   points_per_view=40)
    assert drawn.observations_uv.shape == got.observations_uv.shape


# ------------------------------------------------------------------ the tracker


def textured(seed, S=3, H=64, W=80):
    """Smooth random texture, frame s shifted by (2s, s) pixels; (S, H, W, 3) in [0, 1]."""
    rng = np.random.RandomState(seed)
    base = rng.rand(H // 4 + 8, W // 4 + 8)
    big = np.kron(base, np.ones((4, 4)))
    frames = [big[s:s + H, 2 * s:2 * s + W] for s in range(S)]
    img = np.stack(frames)[..., None] * np.asarray([1.0, 0.8, 0.6])
    return img.astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 80), (49, 67)])
def test_downsample_matches_jax_image_resize(hw):
    g = np.random.RandomState(1).rand(*hw).astype(np.float32)
    close(tracker._downsample(torch.from_numpy(g)), np.asarray(jax_tracker._downsample(jnp.asarray(g))))


def test_harris_keypoints_match_jax_with_zero_score_ties():
    img = np.full((64, 80, 3), 0.2, np.float32)
    for y, x in ((12, 15), (30, 40), (44, 20), (20, 60)):  # four squares: 16 corners < 64
        img[y:y + 8, x:x + 8] = 0.9
    uv, score = jax_tracker.harris_keypoints(jnp.asarray(img), max_points=64)
    got_uv, got_score = tracker.harris_keypoints(torch.from_numpy(img), max_points=64)
    assert 0 < int((np.asarray(score) > 0).sum()) < 64  # padding entries: zero-score ties
    np.testing.assert_array_equal(got_uv.numpy(), np.asarray(uv))
    close(got_score, np.asarray(score))


def test_track_points_matches_jax():
    imgs = textured(2)
    uv, _ = jax_tracker.harris_keypoints(jnp.asarray(imgs[0]), max_points=24)
    want_uv, want_sc = jax_tracker.track_points(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), uv)
    got_uv, got_sc = tracker.track_points(torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1]),
                                          torch.from_numpy(np.array(uv)))
    close(got_uv, np.asarray(want_uv), rtol=PX_TOL / max(1.0, float(np.abs(want_uv).max())), name="uv")
    close(got_sc, np.asarray(want_sc), name="score")


def test_predict_tracks_matches_jax():
    imgs = textured(3)
    want = jax_tracker.predict_tracks(jnp.asarray(imgs), max_query_pts=32, query_frame_num=2)
    got = tracker.predict_tracks(torch.from_numpy(imgs), max_query_pts=32, query_frame_num=2)
    assert want[0].shape == got[0].shape and want[0].shape[1] > 32
    np.testing.assert_allclose(got[0], want[0], atol=PX_TOL, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=RTOL, rtol=0)
    assert tracker.select_query_frames(imgs, 2) == jax_tracker.select_query_frames(imgs, 2) == [0, 2]
    # Tracks from them: the query pixels unprojected with the predicted depth.
    _, depth, K, poses, _, _ = predictions(V=3, H=64, W=80)
    want_t = jax_tracks._assemble_tracks_from_uv(*want, depth, K, poses)
    got_t = tracks._assemble_tracks_from_uv(*got, torch.from_numpy(depth), torch.from_numpy(K),
                                            torch.from_numpy(poses))
    for f in dataclasses.fields(tracks.Tracks):
        want_f = np.asarray(getattr(want_t, f.name))
        rtol = PX_TOL / max(1.0, float(np.abs(want_f).max())) if f.name == "observations_uv" else RTOL
        close(getattr(got_t, f.name), want_f, rtol=rtol, name=f.name)



# ------------------------------------------------------------------ the COLMAP tools


def test_colmap_demo_with_ba_feeds_the_inference_demo(tmp_path):
    """``tools/demo_colmap.py --use-ba`` on the CPU (the small model, seeded; two PNGs
    at 518 x 392; the photometric tracker, whose tracks the seeded model's depths do not
    reject), its model read back with the refined poses, then
    ``tools/demo_inference_on_colmap_outputs.py`` on it with the model's calibration and
    poses as geometric inputs."""
    from mapanything_tpu_torch.tools import demo_colmap
    from mapanything_tpu_torch.tools import demo_inference_on_colmap_outputs as demo_inf
    from mapanything_tpu_torch.utils import colmap as port_colmap
    from mapanything_tpu_torch.utils.image import write_png

    (tmp_path / "images").mkdir()
    imgs = textured(5, S=2, H=96, W=128)
    for i, img in enumerate(imgs):
        write_png(tmp_path / "images" / f"view_{i}.png", (img * 255).astype(np.uint8))
    # One small seeded model with the geometric encoders serves both tools (bf16, as they build it).
    model = demo_inf.build_model(demo_inf.parse_args(["--data", str(tmp_path), "--small"]), torch.device("cpu"))
    res = demo_colmap.run(demo_colmap.parse_args(
        ["--images", str(tmp_path / "images"), "--out", str(tmp_path), "--small", "--device", "cpu", "--use-ba",
         "--tracker", "photometric", "--points-per-view", "64", "--ba-iters", "3"]), model=model)
    costs = res["costs"].numpy()
    assert res["n_obs"] > 0 and np.isfinite(costs).all() and res["final_cost"] <= res["initial_cost"]
    assert res["final_cost"] <= costs.min() * (1 + 1e-6)  # the state holds the best step taken
    cameras, images, points = port_colmap.read_model(tmp_path / "sparse")
    assert len(cameras) == len(images) == 2 and points
    for im in images.values():
        i = ["view_0.png", "view_1.png"].index(im.name)
        pose = res["poses"][i]  # fp32 through qvec and tvec: within 1e-5 of its magnitude
        np.testing.assert_allclose(port_colmap.colmap_qt_to_c2w(im.qvec, im.tvec), pose,
                                   atol=1e-5 * max(1.0, np.abs(pose).max()), rtol=0)
    got = demo_inf.run(demo_inf.parse_args(["--data", str(tmp_path), "--out", str(tmp_path / "inf"), "--small",
                                            "--device", "cpu"]), model=model)
    assert sorted(p.name for p in (tmp_path / "inf").iterdir()) == ["points.ply", "predictions.npz", "scene.glb"]
    assert got["intrinsics"].shape == (1, 2, 3, 3) and got["camera_poses"].shape == (1, 2, 4, 4)
    assert np.isfinite(got["outputs"].pts3d.numpy()).all()
