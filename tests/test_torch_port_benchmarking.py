"""The port's accuracy benchmarks and timers against the JAX package's, on the CPU.

Every function of ``utils/metrics.py``, ``benchmarking/rmvd_mvs.py`` and
``benchmarking/calibration.py`` on the same seeded numpy inputs as its JAX
counterpart: within 1e-6 relative, rotation errors within 0.1 degree (the JAX
module converts rotations to quaternions in float32 through ``jnp``, the port
through its own float32 ``rotmat_to_quat``: a rotation compared with itself
reads up to ~0.06 degree on either side, in another op order). The dense N-view
set metrics on the JAX tests' perfect predictions and perturbed ones, and the
three ``run_benchmark``s of both packages over one list of collated batches of
the JAX tests' ``SyntheticScenes`` (2 scenes, 2 views, 56 px), with
``MapAnythingConfig.small()`` weights seeded for the JAX tree and carried over by
``load_jax_params``: continuous metrics within 1e-4 relative (set metrics of the
same arrays within 1e-5). The inlier ratios (a hard 1.03 threshold) and
pose_auc_5 (1-degree bins) may move only by what the counted pixels and pairs
near an edge allow (``dense_n_view.metric_edges``, ``rmvd_mvs.inlier_edge_allowance``).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from test_benchmark_and_parallel import perfect_batch_and_preds
from test_data_layer import SyntheticScenes
from test_torch_port_infer import seeded_params

from mapanything_tpu.benchmarking import calibration as jax_calib
from mapanything_tpu.benchmarking import dense_n_view as jax_dense
from mapanything_tpu.benchmarking import rmvd_mvs as jax_rmvd
from mapanything_tpu.data.loader import get_test_data_loader
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.train.loop import loss_batch_from_numpy as jax_loss_batch
from mapanything_tpu.utils import metrics as jax_metrics
from mapanything_tpu_torch.benchmarking import calibration as port_calib
from mapanything_tpu_torch.benchmarking import dense_n_view as port_dense
from mapanything_tpu_torch.benchmarking import rmvd_mvs as port_rmvd
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.train.losses import LossBatch
from mapanything_tpu_torch.utils import metrics as port_metrics
from mapanything_tpu_torch.utils import threads, timing
from mapanything_tpu_torch.utils.jax_params import load_jax_params

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

RTOL = 1e-6  # the metric functions: the same numpy arithmetic on the same inputs
ROT_ATOL_DEG = 0.1  # float32 quaternions in another op order
SET_RTOL = 1e-5  # set metrics of the same arrays: the normalisation in torch against jnp
RUN_RTOL = 1e-4  # run_benchmark: the port's forward against the JAX one
ATOL = 1e-7  # beside a relative tolerance, for metrics that read ~0


def close(got, want, rtol=RTOL, atol=ATOL, allow=0.0):
    """|got - want| <= rtol·max|want| + atol + allow, elementwise (NaN where both are)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want[np.isfinite(want)]).max(initial=0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol + allow + rtol * scale, equal_nan=True)


def rotations(seed, n):
    return Rotation.random(n, random_state=np.random.RandomState(seed)).as_matrix().astype(np.float32)


def poses(seed, n):
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    out[:, :3, :3] = rotations(seed, n)
    out[:, :3, 3] = np.random.RandomState(seed + 1).randn(n, 3)
    return out


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def rand(seed, *shape, lo=0.5, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


# ------------------------------------------------------------ metric functions

def _mask(seed, *shape):
    return np.random.RandomState(seed).uniform(size=shape) < 0.8


# name -> (function name, inputs): the JAX and port functions of that name on the same arrays
METRIC_CASES = {
    "valid_mean": ("valid_mean", lambda: (rand(1, 6, 7), _mask(2, 6, 7))),
    "valid_mean_axis": ("valid_mean", lambda: (rand(3, 6, 7), _mask(4, 6, 7), 1)),
    "thresh_inliers": ("thresh_inliers", lambda: (rand(5, 9, 8, 3), rand(5, 9, 8, 3) * rand(6, 9, 8, 1, lo=0.97, hi=1.04),
                                                  1.03, _mask(7, 9, 8))),
    "thresh_inliers_nomask": ("thresh_inliers", lambda: (rand(8, 9, 8, 1), rand(9, 9, 8, 1))),
    "m_rel_ae": ("m_rel_ae", lambda: (rand(10, 9, 8, 3), rand(11, 9, 8, 3), _mask(12, 9, 8))),
    "m_rel_ae_zero_gt": ("m_rel_ae", lambda: (np.zeros((4, 4, 3), np.float32), rand(13, 4, 4, 3))),
    "ray_angular_error_deg": ("ray_angular_error_deg", lambda: (rand(14, 50, lo=0.0, hi=2.5),)),
    "horn_align": ("horn_align", lambda: (np.random.RandomState(15).randn(3, 12),
                                          np.random.RandomState(16).randn(3, 12))),
    "evaluate_ate": ("evaluate_ate", lambda: (poses(17, 8), poses(19, 8))),
    "translation_angle_deg": ("translation_angle_deg", lambda: (np.random.RandomState(21).randn(30, 3),
                                                                np.random.RandomState(22).randn(30, 3))),
    "translation_angle_deg_no_ambiguity": ("translation_angle_deg", lambda: (
        np.random.RandomState(23).randn(30, 3), np.random.RandomState(24).randn(30, 3), 1e-15, False)),
    "calculate_auc": ("calculate_auc", lambda: (rand(25, 40, lo=0, hi=8), rand(26, 40, lo=0, hi=8), 5)),
    "calculate_auc_30": ("calculate_auc", lambda: (rand(27, 40, lo=0, hi=40), rand(28, 40, lo=0, hi=40))),
    "build_pair_index": ("build_pair_index", lambda: (7,)),
    "closed_form_inverse_se3": ("closed_form_inverse_se3", lambda: (poses(29, 5),)),
}


def _flat(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metric_function_matches_jax(case):
    name, make = METRIC_CASES[case]
    want, got = getattr(jax_metrics, name)(*make()), getattr(port_metrics, name)(*make())
    for g, w in zip(_flat(got), _flat(want), strict=True):
        close(g, w)


@pytest.mark.parametrize("perturb", [0.0, 1e-4, 0.3])
def test_rotation_angle_deg_matches_jax_within_a_tenth_of_a_degree(perturb):
    """Trap 1: both sides convert in float32, so a rotation against itself is not 0."""
    a = rotations(31, 15)  # the shape of the next test's pairs: one JAX compile for both
    b = (Rotation.from_matrix(a) * Rotation.from_rotvec(
        perturb * np.random.RandomState(32).randn(15, 3))).as_matrix().astype(np.float32)
    want, got = jax_metrics.rotation_angle_deg(a, b), port_metrics.rotation_angle_deg(a, b)
    assert got.dtype == np.float32 and port_metrics._mat_to_quat(a).dtype == np.float32
    close(got, want, rtol=0, atol=ROT_ATOL_DEG)
    if perturb == 0.0:  # the float32 conversion shows: not exactly 0 on either side, for some rotation
        assert np.asarray(want).max() > 0 and got.max() > 0 and got.max() < ROT_ATOL_DEG


def test_se3_to_relative_pose_error_matches_jax():
    pred = poses(33, 6)
    gt = pred.copy()
    gt[:, :3, :3] = (Rotation.from_matrix(pred[:, :3, :3]) * Rotation.from_rotvec(
        0.05 * np.random.RandomState(34).randn(6, 3))).as_matrix()
    gt[:, :3, 3] += 0.1 * np.random.RandomState(35).randn(6, 3)
    (r_want, t_want), (r_got, t_got) = (m.se3_to_relative_pose_error(pred, gt, 6) for m in (jax_metrics, port_metrics))
    close(r_got, r_want, rtol=0, atol=ROT_ATOL_DEG)
    close(t_got, t_want)


RMVD_CASES = {
    "aligned": lambda: (rand(40, 24, 32) * 0.5, rand(41, 24, 32), _mask(42, 24, 32)),
    "not_aligned": lambda: (rand(43, 24, 32), rand(44, 24, 32), None, False),
    "holes_in_gt": lambda: (rand(45, 24, 32), rand(46, 24, 32) * _mask(47, 24, 32), None),
    "no_valid": lambda: (rand(48, 8, 8), np.zeros((8, 8), np.float32), None),
}


@pytest.mark.parametrize("case", sorted(RMVD_CASES))
def test_rmvd_depth_metrics_match_jax(case):
    want, got = jax_rmvd.rmvd_depth_metrics(*RMVD_CASES[case]()), port_rmvd.rmvd_depth_metrics(*RMVD_CASES[case]())
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])


def test_median_scale_align_and_calibration_metric_match_jax():
    pred, gt, mask = rand(50, 16, 16), rand(51, 16, 16), _mask(52, 16, 16)
    close(port_rmvd.median_scale_align(pred, gt, mask), jax_rmvd.median_scale_align(pred, gt, mask))
    assert port_rmvd.median_scale_align(pred, gt, np.zeros_like(mask)) == 1.0
    gt_rays, pr_rays = unit(np.random.RandomState(53).randn(2, 8, 8, 3)), unit(np.random.RandomState(54).randn(2, 8, 8, 3))
    close(port_calib.compute_calibration_metrics(gt_rays, torch.from_numpy(pr_rays)),
          jax_calib.compute_calibration_metrics(gt_rays, pr_rays))
    assert port_calib.compute_calibration_metrics(gt_rays, gt_rays) < 1e-4


# ------------------------------------------------------------ dense set metrics

def port_batch(batch) -> LossBatch:
    return LossBatch(**{f.name: torch.from_numpy(np.array(getattr(batch, f.name)))
                        for f in dataclasses.fields(LossBatch) if getattr(batch, f.name, None) is not None})


def port_preds(preds) -> port_ma.Predictions:
    return port_ma.Predictions(**{f.name: torch.from_numpy(np.array(getattr(preds, f.name)))
                                  for f in dataclasses.fields(port_ma.Predictions)
                                  if getattr(preds, f.name, None) is not None})


def perturbed(preds, seed):
    """Predictions off the ground truth: noisy depth and points, a turned and shifted
    camera, rays and scale off."""
    rng = np.random.RandomState(seed)
    noise = lambda x, s: x * jnp.asarray(1 + s * rng.randn(*x.shape[:-1], 1).astype(np.float32))  # noqa: E731
    quats = np.asarray(preds.cam_quats) + 0.02 * rng.randn(*preds.cam_quats.shape).astype(np.float32)
    rays = np.asarray(preds.ray_directions) + 0.01 * rng.randn(*preds.ray_directions.shape).astype(np.float32)
    return preds.replace(
        pts3d=noise(preds.pts3d, 0.02), pts3d_cam=noise(preds.pts3d_cam, 0.02),
        depth_along_ray=noise(preds.depth_along_ray, 0.02),
        ray_directions=jnp.asarray(unit(rays)),
        cam_quats=jnp.asarray(unit(quats)),
        cam_trans=preds.cam_trans + jnp.asarray(0.05 * rng.randn(*preds.cam_trans.shape).astype(np.float32)),
        metric_scaling_factor=preds.metric_scaling_factor * 1.1,
    )


SET_CASES = {"perfect": None, "perturbed": 5, "perturbed_again": 6}


def assert_set_metrics_close(got, want, edges, rtol):
    """Each set's continuous metrics within rtol; the discontinuous ones within their edges' allowance."""
    assert len(got) == len(want) == len(edges)
    for g, w, e in zip(got, want, edges):
        assert set(g) == set(w)
        for k in w:
            close(g[k], w[k], rtol=rtol, atol=1e-6, allow=e.get(k, 0.0))


@pytest.mark.parametrize("case", sorted(SET_CASES))
def test_compute_set_metrics_matches_jax(case):
    batch, preds = perfect_batch_and_preds(B=2, V=4)
    if SET_CASES[case] is not None:
        preds = perturbed(preds, SET_CASES[case])
    want = jax_dense.compute_set_metrics(batch, preds)
    pb, pp = port_batch(batch), port_preds(preds)
    got = port_dense.compute_set_metrics(pb, pp)
    edges = port_dense.metric_edges(pb, pp)
    assert_set_metrics_close(got, want, edges, SET_RTOL)
    if SET_CASES[case] is None:  # the ground truth fed back scores perfectly
        for m in got:
            assert m["pointmaps_abs_rel"] < 1e-4 and m["z_depth_abs_rel"] < 1e-4 and m["pose_ate_rmse"] < 1e-5
            assert m["pointmaps_inlier_thres_103"] == 1.0 and m["pose_auc_5"] > 99.0
    else:
        assert all(m["pose_auc_5"] < 100.0 and m["pointmaps_abs_rel"] > 1e-3 for m in got)


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_compute_set_metrics_global_pm_only_matches_jax(noise):
    batch, preds = perfect_batch_and_preds(B=2, V=4)
    pts = np.asarray(preds.pts3d) + noise * np.random.RandomState(7).randn(*preds.pts3d.shape).astype(np.float32)
    want = jax_dense.compute_set_metrics_global_pm_only(batch, jnp.asarray(pts))
    got = port_dense.compute_set_metrics_global_pm_only(port_batch(batch), pts)
    pp = port_preds(preds.replace(pts3d=jnp.asarray(pts)))
    edges = port_dense.metric_edges(port_batch(batch), pp)
    assert_set_metrics_close(got, want, edges, SET_RTOL)


def test_metric_edges_count_what_a_threshold_can_flip():
    """A pixel whose ratio lies within the margin of 1.03 is counted; the allowance is its
    share of its view, over the views."""
    batch, preds = perfect_batch_and_preds(B=2, V=4)
    z = np.array(preds.pts3d_cam)
    z[0, 0, 0, 0] *= 1.035  # one pixel of view 0 at a ratio of 1.035 (the points, and so the norm, unchanged)
    pp = port_preds(preds.replace(pts3d_cam=jnp.asarray(z)))
    tight = port_dense.metric_edges(port_batch(batch), pp)[0]
    loose = port_dense.metric_edges(port_batch(batch), pp, ratio_margin=0.01)[0]
    share = 1 / (4 * 24 * 32)  # one pixel of view 0's 24 x 32, over 4 views
    assert tight["z_depth_inlier_thres_103"] == 0.0
    assert loose["z_depth_inlier_thres_103"] == pytest.approx(share)
    assert port_dense.compute_set_metrics(port_batch(batch), pp)[0]["z_depth_inlier_thres_103"] == pytest.approx(1 - share)
    assert loose["pose_auc_5"] == 0.0 and loose["pose_edge_pairs"] == 0  # identical poses: error ~0, no edge


# ------------------------------------------------------------ the runners

@pytest.fixture(scope="module")
def runners():
    """One list of collated numpy batches of SyntheticScenes (2 scenes, 2 views, 56 px,
    one set a batch), the small fp32 JAX model with seeded weights of its tree (the
    geometric encoders included), and the port model holding the same weights."""
    ds = SyntheticScenes(n_scenes=2, frames_per_scene=8, num_views=2, split="test", covisibility_thres=0.25,
                         resolution=(56, 56), seed=3)
    loader = get_test_data_loader(ds, batch_size=1, num_workers=0)
    loader.set_epoch(0)
    batches = list(loader)
    B, V, H, W = batches[0]["img"].shape[:4]
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    views = jax_ma.Views(img=f32(B, V, H, W, 3), ray_directions=f32(B, V, H, W, 3),
                         depth_along_ray=f32(B, V, H, W, 1), camera_pose_quats=f32(B, V, 4),
                         camera_pose_trans=f32(B, V, 3), is_metric_scale=jax.ShapeDtypeStruct((B, V), jnp.bool_))
    model = jax_ma.MapAnything(jax_ma.MapAnythingConfig.small())
    params = seeded_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), views)["params"], 0)
    with torch.device("meta"):  # no seeded init: every weight comes from the JAX tree (the model has no buffers)
        port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(), device="meta", geometric_inputs=True)
    load_jax_params(port.to_empty(device="cpu"), params)
    return dict(batches=batches, model=model, params={"params": params}, port=port)


@pytest.mark.parametrize("task", ["images_only", "mvs"])
def test_dense_n_view_run_benchmark_matches_jax(runners, task):
    keep = dict(keep_rays=task == "mvs", keep_depth=task == "mvs", keep_cam=False)
    want = jax_dense.run_benchmark(runners["model"], runners["params"], runners["batches"], jax_loss_batch, **keep)
    edges = {}

    def on_batch(i, batch, preds, set_metrics):
        assert preds.pts3d.device.type == "cpu" and len(set_metrics) == 1
        edges[runners["batches"][i]["label"][0]] = port_dense.metric_edges(batch, preds)[0]

    got = port_dense.run_benchmark(runners["port"], runners["batches"], on_batch=on_batch, **keep)
    assert set(got) == set(want) == {"scene0", "scene1", "overall"}
    edges["overall"] = {k: float(np.mean([e[k] for e in edges.values()])) for k in ("pointmaps_inlier_thres_103",
                                                                                    "z_depth_inlier_thres_103",
                                                                                    "pose_auc_5")}
    for scene in want:
        assert set(got[scene]) == set(port_dense.METRIC_NAMES)
        for k, w in want[scene].items():
            close(got[scene][k], w, rtol=RUN_RTOL, atol=1e-6, allow=edges[scene].get(k, 0.0))


def test_calibration_run_benchmark_matches_jax(runners):
    want = jax_calib.run_benchmark(runners["model"], runners["params"], runners["batches"])
    got = port_calib.run_benchmark(runners["port"], runners["batches"])
    assert set(got) == set(want) == {"scene0", "scene1", "overall"}
    for scene, w in want.items():
        close(got[scene], w, rtol=RUN_RTOL)


def test_rmvd_run_benchmark_matches_jax(runners):
    want = jax_rmvd.run_benchmark(runners["model"], runners["params"], runners["batches"])
    got = port_rmvd.run_benchmark(runners["port"], runners["batches"])
    # The inlier ratio may move by the share of pixels near 1.03 after the median scaling.
    allow = []
    with torch.inference_mode():
        for b in runners["batches"]:
            pred_z = runners["port"](port_ma.Views(img=torch.from_numpy(b["img"]))).pts3d_cam[..., 2].numpy()
            allow.append(port_rmvd.inlier_edge_allowance(pred_z[0, 0], b["pts3d_cam"][0, 0, ..., 2],
                                                         b["valid_mask"][0, 0]))
    assert got["num_samples"] == want["num_samples"] == len(runners["batches"])
    close(got["absrel"], want["absrel"], rtol=RUN_RTOL)
    close(got["inlier103"], want["inlier103"], rtol=RUN_RTOL, allow=float(np.mean(allow)))


# ------------------------------------------------------------ timers

def test_block_timers_and_manager():
    printed = []
    timer = timing.BlockTimer("t", window=2, print_fn=printed.append)
    for dt in (0.002, 0.004, 0.006):
        with timer:
            time.sleep(dt)
    assert timer.count == 3 and len(timer.window) == 2 and len(printed) == 3
    assert timer.avg >= 0.005 and timer.global_avg >= 0.004 and timer.total >= 0.012
    calls = []
    timed = timing.BlockTimer("f")(lambda x: calls.append(x) or x + 1)
    assert timed(1) == 2 and calls == [1]
    manager = timing.BlockTimeManager()
    with manager("a"):
        pass
    with manager("a"):
        pass
    with manager("b"):
        time.sleep(0.001)
    assert manager("a").count == 2 and set(manager.summary()) == {"a", "b"} and manager.summary()["b"] > 0


def test_time_jitted_and_trace(tmp_path, monkeypatch):
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    seconds = timing.time_jitted(fn, torch.ones(4), iters=3, warmup=2, device="cpu")
    assert len(calls) == 5 and seconds >= 0
    with timing.trace(tmp_path / "trace") as log_dir:
        torch.ones(8).add_(1)
    assert log_dir == tmp_path / "trace" and (log_dir / "trace.json").stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.time_jitted(fn, torch.ones(4))
