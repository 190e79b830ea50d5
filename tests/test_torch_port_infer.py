"""The port's inference pipeline against the JAX package's, on the CPU.

The geometry of the postprocess (quaternions, cameras, normals and edges) at
odd sizes, so that padding shows; ``preprocess_inputs_for_inference`` with
its conflict checks; ``postprocess_model_outputs_for_inference`` on one set
of JAX predictions under four configs; ``head_chunk_size``; the rgb scene
representation; the whole ``infer``; and the PLY, GLB and COLMAP writers, byte
for byte. Inputs come from numpy seeds, weights from one JAX initialisation
of ``MapAnythingConfig.small()`` in fp32 carried over by ``load_jax_params``.

Tolerances: geometry within 1e-5 of each output's magnitude (fp32 on both
sides, sums in other orders), the intrinsics fit excepted (see below); model
outputs and the whole ``infer`` within 1e-4 of each field's magnitude, masks
equal on at least 99.9% of pixels, floats compared where both masks agree.
"""

from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.geometry import camera as jax_camera
from mapanything_tpu.geometry import normals as jax_normals
from mapanything_tpu.geometry import quaternion as jax_quat
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models.heads import adaptors as jax_adaptors
from mapanything_tpu.models.heads import dpt as jax_dpt
from mapanything_tpu.utils import colmap as jax_colmap
from mapanything_tpu.utils import inference as jax_inf
from mapanything_tpu.utils import viz as jax_viz
from mapanything_tpu_torch.geometry import camera as port_camera
from mapanything_tpu_torch.geometry import normals as port_normals
from mapanything_tpu_torch.geometry import quaternion as port_quat
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models.heads import adaptors as port_adaptors
from mapanything_tpu_torch.utils import colmap as port_colmap
from mapanything_tpu_torch.utils import inference as port_inf
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils import viz as port_viz
from mapanything_tpu_torch.utils.jax_params import load_jax_params


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)


GEOM_RTOL = 1e-5  # of each output's magnitude
MODEL_RTOL = 1e-4  # of each field's magnitude
MASK_AGREEMENT = 0.999
B, V, HW = 1, 2, 56
PRED_FIELDS = ("pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans", "cam_quats",
               "metric_scaling_factor", "conf", "non_ambiguous_mask_logits")


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def close(out, ref, rtol=GEOM_RTOL):
    """|out - ref| <= rtol · max(1, max|ref|); bool outputs equal."""
    out, ref = np.asarray(out.detach() if isinstance(out, torch.Tensor) else out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    if ref.dtype == bool:
        np.testing.assert_array_equal(out, ref)
        return 0.0
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, atol=rtol * scale, rtol=0)
    return float(np.abs(out - ref).max()) / scale


# ---------------------------------------------------------------- geometry


def rotations(seed, n):
    """n random rotation matrices, plus the identity and 180-degree turns about
    x, y and z: rotmat_to_quat's candidates tie there."""
    rots = port_quat.quat_to_rotmat(t(unit(randn(seed, n, 4)))).numpy()
    ties = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])])
    return np.concatenate([rots, ties.astype(np.float32)])


def poses_np(seed, batch):
    """Random 4x4 cam2world matrices."""
    quats, trans = unit(randn(seed, *batch, 4)), randn(seed + 1, *batch, 3)
    return port_quat.quats_trans_to_pose_matrix(t(quats), t(trans)).numpy()


# Each case takes the module and the array maker (jnp.asarray or t) and builds
# its inputs with numpy (or the port, outside the comparison).
QUAT_CASES = {
    "normalize": lambda P, a: P.quat_normalize(a(randn(1, 3, 5, 4) * 3)),
    "to_rotmat": lambda P, a: P.quat_to_rotmat(a(randn(2, 3, 5, 4))),
    "rotmat_to_quat": lambda P, a: P.rotmat_to_quat(a(rotations(3, 40))),
    "standardize": lambda P, a: P.quat_standardize(a(randn(4, 7, 4))),
    "pose_matrix": lambda P, a: P.quats_trans_to_pose_matrix(a(unit(randn(5, 2, 3, 4))), a(randn(6, 2, 3, 3))),
    "pose_split": lambda P, a: P.pose_matrix_to_quats_trans(a(poses_np(7, (2, 3)))),
}


def run_case(table, jax_module, port_module, name):
    """Run case ``name`` of ``table`` through the JAX package, then the port, on
    the same numpy inputs."""
    ref = jax.jit(lambda: table[name](jax_module, jnp.asarray))()  # one compile, not one per op
    out = table[name](port_module, t)
    if not isinstance(ref, tuple):
        ref, out = (ref,), (out,)
    return [close(o, r) for o, r in zip(out, ref)]


@pytest.mark.parametrize("name", list(QUAT_CASES))
def test_quaternion_functions_match_jax(name):
    run_case(QUAT_CASES, jax_quat, port_quat, name)


def test_rotmat_to_quat_takes_the_first_of_tied_candidates():
    rots = rotations(9, 0)  # identity, then 180-degree turns about x, y and z
    want = np.array([[0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    np.testing.assert_array_equal(port_quat.rotmat_to_quat(t(rots)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jax.jit(jax_quat.rotmat_to_quat)(rots)), want)


def intrinsics_np(seed, batch, h, w, off_centre):
    rng = np.random.RandomState(seed)
    K = np.zeros(batch + (3, 3), np.float32)
    K[..., 0, 0] = rng.uniform(15, 30, batch)
    K[..., 1, 1] = rng.uniform(15, 30, batch)
    shift = 4 * w if off_centre else 1.5
    K[..., 0, 2] = (w - 1) / 2 + rng.uniform(-shift, shift, batch)
    K[..., 1, 2] = (h - 1) / 2 + rng.uniform(-shift, shift, batch)
    K[..., 2, 2] = 1.0
    return K


def rays_np(seed, off_centre):
    K = intrinsics_np(seed, (2, 3), 17, 19, off_centre)
    return port_camera.rays_in_camera_frame(t(K), 17, 19)[1].numpy()


CAMERA_CASES = {
    "pixel_grid": lambda P, a: P.pixel_grid(17, 19),
    "rays_unit": lambda P, a: P.rays_in_camera_frame(a(intrinsics_np(10, (2, 3), 17, 19, False)), 17, 19),
    "rays_plane": lambda P, a: P.rays_in_camera_frame(a(intrinsics_np(11, (2, 3), 17, 19, True)), 17, 19, False),
    "intrinsics_centred": lambda P, a: P.recover_pinhole_intrinsics_from_ray_directions(a(rays_np(12, False))),
    "z_to_along": lambda P, a: P.convert_z_depth_to_depth_along_ray(
        a(np.abs(randn(13, 2, 3, 17, 19)) + 0.1), a(intrinsics_np(14, (2, 3), 17, 19, True))),
    "along_to_z": lambda P, a: P.depth_along_ray_to_z_depth(a(np.abs(randn(15, 2, 3, 17, 19, 1))),
                                                         a(rays_np(16, True))),
}


@pytest.mark.parametrize("name", list(CAMERA_CASES))
def test_camera_functions_match_jax(name):
    run_case(CAMERA_CASES, jax_camera, port_camera, name)


def test_intrinsics_fit_off_centre_matches_jax():
    """The fit solves n·Σtu − Σt·Σu over n·Σt² − (Σt)² in fp32. With the
    principal point far off the image, t = x/z is nearly constant in sign and
    the denominator cancels: both packages lose about log10(κ) digits, with
    κ = n·Σt² / (n·Σt² − (Σt)²) the cancellation factor, so the tolerance is
    GEOM_RTOL · κ of each output's magnitude."""
    rays = rays_np(17, True)
    tx = rays[..., 0] / rays[..., 2]
    n = tx.shape[-1] * tx.shape[-2]
    s, ss = tx.sum((-2, -1), dtype=np.float64), (tx.astype(np.float64) ** 2).sum((-2, -1))
    kappa = float(np.max(n * ss / (n * ss - s * s)))
    assert kappa > 5  # the case is a cancelling one
    ref = np.asarray(jax.jit(jax_camera.recover_pinhole_intrinsics_from_ray_directions)(rays))
    out = port_camera.recover_pinhole_intrinsics_from_ray_directions(t(rays))
    close(out, ref, GEOM_RTOL * kappa)
    # Both recover the K that made the rays, to the same cancellation-limited precision.
    close(out, intrinsics_np(17, (2, 3), 17, 19, True), 1e-4 * kappa)


def depth_np(seed):
    """A tilted plane with 0.1% noise and a raised block, so that edges show."""
    d = 2.0 + 0.01 * np.arange(19, dtype=np.float32) + 0.002 * randn(seed, 2, 3, 17, 19)
    d[..., 5:9, 3:12] += 1.0
    return d


def normals_np(seed):
    """Normals near +z with a block turned towards +x."""
    n = np.float32([0, 0, 1]) + 0.01 * randn(seed, 2, 3, 17, 19, 3)
    n[..., 5:9, 3:12, :] += np.float32([1, 0, -1])
    return unit(n)


def mask_np(seed):
    return np.random.RandomState(seed).rand(2, 3, 17, 19) > 0.2


def pointmap_np(seed):
    rays = rays_np(seed, False)
    return rays * depth_np(seed + 1)[..., None]


NORMALS_CASES = {
    "max_pool": lambda P, a: P._max_pool_2d(a(randn(20, 2, 3, 17, 19)), 3),
    "depth_edge_rtol": lambda P, a: P.depth_edge(a(depth_np(21)), rtol=0.03),
    "depth_edge_atol_mask": lambda P, a: P.depth_edge(a(depth_np(22)), atol=0.5, kernel_size=5,
                                                   mask=a(mask_np(23))),
    "points_to_normals": lambda P, a: P.points_to_normals(a(pointmap_np(24))),
    "points_to_normals_mask": lambda P, a: P.points_to_normals(a(pointmap_np(26)), a(mask_np(27))),
    "normals_edge": lambda P, a: P.normals_edge(a(normals_np(28)), 5.0),
    "normals_edge_mask": lambda P, a: P.normals_edge(a(normals_np(29)), 5.0,
                                                  mask=a(mask_np(30))),
}


@pytest.mark.parametrize("name", list(NORMALS_CASES))
def test_normals_and_edges_match_jax(name):
    run_case(NORMALS_CASES, jax_normals, port_normals, name)


def test_edge_cases_are_not_trivial():
    """The cases above mark some pixels and leave others."""
    for edge in (port_normals.depth_edge(t(depth_np(21)), rtol=0.03),
                 port_normals.normals_edge(t(normals_np(28)), 5.0)):
        assert 0.01 < edge.float().mean().item() < 0.99
    _, normal_mask = port_normals.points_to_normals(t(pointmap_np(26)), t(mask_np(27)))
    assert 0.3 < normal_mask.float().mean().item() < 1.0


# ---------------------------------------------------------------- preprocess


def user_inputs_np(seed=0, b=B, v=V, hw=HW):
    """Images in [0, 1], intrinsics, z-depth and 4x4 cam2world poses."""
    rng = np.random.RandomState(seed)
    return dict(
        images=rng.uniform(0, 1, (b, v, hw, hw, 3)).astype(np.float32),
        intrinsics=intrinsics_np(seed + 1, (b, v), hw, hw, False) * np.float32([[2], [2], [1]]),
        depth_z=rng.uniform(0.5, 4.0, (b, v, hw, hw)).astype(np.float32),
        camera_poses=poses_np(seed + 2, (b, v)),
    )


def preprocess_case(name):
    x = user_inputs_np(1)
    rays = np.asarray(jax_camera.rays_in_camera_frame(jnp.asarray(x["intrinsics"]), HW, HW)[1])
    return {
        "images": dict(images=x["images"]),
        "intrinsics_depth_z": dict(images=x["images"], intrinsics=x["intrinsics"], depth_z=x["depth_z"][..., None]),
        "rays_depth_along_ray": dict(images=x["images"], ray_directions=rays,
                                     depth_along_ray=x["depth_z"][..., None] * 1.5,
                                     is_metric_scale=np.array([[True, False]])),
        "pose_4x4": dict(images=x["images"], camera_poses=x["camera_poses"]),
    }[name]


@pytest.mark.parametrize("name", ["images", "intrinsics_depth_z", "rays_depth_along_ray", "pose_4x4"])
def test_preprocess_matches_jax(name):
    kw = preprocess_case(name)
    ref = jax_preprocess(**kw)
    out = port_inf.preprocess_inputs_for_inference(**{k: t(v) for k, v in kw.items()})
    for field in ("img", "ray_directions", "depth_along_ray", "camera_pose_quats", "camera_pose_trans",
                  "is_metric_scale"):
        r, o = getattr(ref, field), getattr(out, field)
        assert (r is None) == (o is None), field
        if r is not None:
            close(o, np.asarray(r))


CONFLICTS = {
    "intrinsics_and_rays": (dict(intrinsics=1, ray_directions=1), "either intrinsics or ray_directions"),
    "depth_z_without_intrinsics": (dict(depth_z=1), "depth_z input requires intrinsics"),
    "depth_along_ray_uncalibrated": (dict(depth_along_ray=1), "requires intrinsics or ray_directions"),
    "poses_twice": (dict(camera_poses=1, camera_pose_quats=1), "either camera_poses or quats"),
    "two_depths": (dict(intrinsics=1, depth_z=1, depth_along_ray=1), "either depth_z or depth_along_ray"),
}


@pytest.mark.parametrize("name", list(CONFLICTS))
def test_preprocess_conflicts_raise(name):
    x = user_inputs_np(2)
    given, match = CONFLICTS[name]
    arrays = dict(intrinsics=x["intrinsics"], ray_directions=np.zeros((B, V, HW, HW, 3), np.float32),
                  depth_z=x["depth_z"], depth_along_ray=x["depth_z"][..., None],
                  camera_poses=x["camera_poses"], camera_pose_quats=np.zeros((B, V, 4), np.float32))
    kw = {k: arrays[k] for k in given}
    with pytest.raises(ValueError, match=match):
        port_inf.preprocess_inputs_for_inference(t(x["images"]), **{k: t(v) for k, v in kw.items()})
    with pytest.raises(ValueError, match=match):
        jax_inf.preprocess_inputs_for_inference(jnp.asarray(x["images"]), **{k: jnp.asarray(v) for k, v in kw.items()})


# ---------------------------------------------------------------- the model


GEOMETRIC_ENCODERS = ("ray_dirs_encoder", "depth_encoder", "depth_scale_encoder", "cam_rot_encoder",
                      "cam_trans_encoder", "cam_trans_scale_encoder")


def seeded_params(shapes, seed):
    """Weights of the JAX tree's shapes from a numpy seed: kernels N(0, 1/fan-in),
    LayerNorm scales 1 + N(0, 0.02²), LayerScale gammas 0.1 + N(0, 0.02²), the rest
    N(0, 0.02²). Shapes come from ``jax.eval_shape`` of ``init``, which traces
    the model without compiling it (a jitted ``init`` takes ~20 s here)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.standard_normal(x.shape, dtype=np.float32)
        if name == "['kernel']":
            return noise / np.float32(np.sqrt(np.prod(x.shape[:-1])))
        base = {"['scale']": 1.0, "['gamma']": 0.1}.get(name, 0.0)
        return np.float32(base) + np.float32(0.02) * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def small():
    """The small fp32 model with every geometric encoder: seeded weights of
    the JAX tree, one jitted JAX forward per config, and the port model
    holding the same weights (it also runs images-only views)."""
    x = user_inputs_np(0)
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    views = jax_ma.Views(img=f32(B, V, HW, HW, 3), ray_directions=f32(B, V, HW, HW, 3),
                         depth_along_ray=f32(B, V, HW, HW, 1), camera_pose_quats=f32(B, V, 4),
                         camera_pose_trans=f32(B, V, 3), is_metric_scale=jax.ShapeDtypeStruct((B, V), jnp.bool_))
    cfg = jax_ma.MapAnythingConfig.small()
    shapes = jax.eval_shape(jax_ma.MapAnything(cfg).init, jax.random.PRNGKey(0), views)["params"]
    params = seeded_params(shapes, 0)
    applies = {}

    def apply(config=cfg):
        """The jitted JAX forward of ``config``."""
        if config not in applies:
            model = jax_ma.MapAnything(config)
            applies[config] = jax.jit(lambda p, views: model.apply({"params": p}, views))
        return applies[config]

    port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(), device="cpu", geometric_inputs=True)
    load_jax_params(port, params)
    return SimpleNamespace(inputs=x, params=params, apply=apply, port=port)


def assert_fields_match(out, ref, fields, rtol=MODEL_RTOL):
    return {f: close(getattr(out, f), np.asarray(getattr(ref, f)), rtol) for f in fields}


def predictions_to_torch(preds):
    names = {f.name for f in port_ma.Predictions.__dataclass_fields__.values()}
    return port_ma.Predictions(**{k: None if getattr(preds, k, None) is None else t(np.asarray(getattr(preds, k)))
                                  for k in names})


POSTPROCESS_CONFIGS = {
    "default": {},
    "confidence_mask": dict(apply_confidence_mask=True, confidence_percentile=60.0),
    "no_mask": dict(apply_mask=False),
    "no_edges": dict(mask_edges=False),
}
jax_preprocess = jax.jit(jax_inf.preprocess_inputs_for_inference, static_argnames="data_norm_type")
jax_postprocess = jax.jit(jax_inf.postprocess_model_outputs_for_inference, static_argnums=(2, 3))


@pytest.fixture(scope="module")
def jax_predictions(small):
    """The JAX forward of the small model with every modality, and its views
    (the port's preprocess of the inputs: test_preprocess_matches_jax holds it
    to the JAX package's). The non-ambiguous mask keeps about half of the
    pixels and the edges remove some of those."""
    port_views = port_inf.preprocess_inputs_for_inference(**{k: t(v) for k, v in small.inputs.items()})
    views = jax_ma.Views(**{k: jnp.asarray(v.numpy()) for k, v in vars(port_views).items()})
    return small.apply()(small.params, views), views


@pytest.mark.parametrize("name", list(POSTPROCESS_CONFIGS))
def test_postprocess_matches_jax(jax_predictions, name, record_property):
    preds, views = jax_predictions
    cfg = POSTPROCESS_CONFIGS[name]
    ref = jax_postprocess(preds, views, jax_inf.PostprocessConfig(**cfg), "dinov2")
    port_views = port_ma.Views(img=t(np.asarray(views.img)))
    out = port_inf.postprocess_model_outputs_for_inference(
        predictions_to_torch(preds), port_views, port_inf.PostprocessConfig(**cfg))
    assert (ref.mask is None) == (out.mask is None) == (name == "no_mask")
    if out.mask is not None:
        # the same predictions on both sides: the masks are equal, and not trivial
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
        assert 0.01 < out.mask.float().mean().item() < 0.99
    fields = [f for f in port_inf.InferenceOutputs.__dataclass_fields__ if getattr(ref, f) is not None]
    record_property("max_err_over_magnitude", assert_fields_match(out, ref, fields, GEOM_RTOL))


def test_postprocess_options_change_the_mask(jax_predictions):
    """The confidence mask and the edge mask each change the default mask, so
    the configs above test what they name."""
    preds, views = jax_predictions
    port_preds, port_views = predictions_to_torch(preds), port_ma.Views(img=t(np.asarray(views.img)))
    masks = {name: port_inf.postprocess_model_outputs_for_inference(
        port_preds, port_views, port_inf.PostprocessConfig(**cfg)).mask for name, cfg in POSTPROCESS_CONFIGS.items()}
    for name in ("confidence_mask", "no_edges"):
        assert not torch.equal(masks[name], masks["default"]), name


@pytest.mark.parametrize("chunk", [1, 2])
def test_head_chunk_size_matches_jax_and_unchunked(small, chunk, monkeypatch, record_property):
    """1 x 4 views: the dense head over chunks of 1 and of 2 views against JAX's
    chunked forward, and against the port's unchunked forward. The same ops run
    on fewer views at once, but the convolutions may take another algorithm
    at another batch size (2.9e-5 seen on unit ray directions, normalised
    from small raw vectors): within MODEL_RTOL of each field's magnitude."""
    img = randn(40, 1, 4, HW, HW, 3)
    cfg = jax_ma.MapAnythingConfig.small(head_chunk_size=chunk)
    ref = small.apply(cfg)(small.params, jax_ma.Views(img=jnp.asarray(img)))
    port = small.port
    with torch.inference_mode():
        whole = port(port_ma.Views(img=t(img)))
        monkeypatch.setattr(port, "config", replace(port.config, head_chunk_size=chunk))
        out = port(port_ma.Views(img=t(img)))
        monkeypatch.setattr(port, "config", replace(port.config, head_chunk_size=3))
        with pytest.raises(ValueError, match="must divide"):
            port(port_ma.Views(img=t(img)))
    record_property("max_err_over_magnitude", assert_fields_match(out, ref, PRED_FIELDS))
    record_property("max_err_over_magnitude_vs_unchunked", assert_fields_match(out, whole, PRED_FIELDS))


@pytest.fixture(scope="module")
def rgb(small):
    """``raydirs+depth+rgb+pose`` (test_model_forward.py:171's config), built
    without geometric encoders: the small model's weights, the regression
    head's at the wider channel count."""
    def config(m):
        return m.MapAnythingConfig.small(
            scene_rep_type="raydirs+depth+rgb+pose",
            dense_adaptor=(jax_adaptors if m is jax_ma else port_adaptors).DenseAdaptorConfig(
                components=("ray_directions", "depth", "rgb"), with_confidence=True, with_mask=True),
        )

    jcfg = config(jax_ma)
    regressor = jax_dpt.DPTRegressionProcessor(output_dim=jcfg.dense_adaptor.num_channels)
    head = jax.eval_shape(lambda rng, feat: regressor.init(rng, feat, (HW, HW)), jax.random.PRNGKey(1),
                          jnp.zeros((2, 32, 32, 64)))["params"]
    params = {k: v for k, v in small.params.items() if k not in GEOMETRIC_ENCODERS}
    params["dpt_regressor_head"] = seeded_params(head, 1)
    port = port_ma.MapAnything(config(port_ma), device="cpu")
    load_jax_params(port, params)
    return SimpleNamespace(jax_config=jcfg, params=params, port=port)


def test_rgb_scene_rep_matches_jax(small, rgb, record_property):
    img = small.inputs["images"]
    jviews = jax_inf.preprocess_inputs_for_inference(jnp.asarray(img))
    ref = small.apply(rgb.jax_config)(rgb.params, jviews)
    ref_post = jax_postprocess(ref, jviews, jax_inf.PostprocessConfig(), "dinov2")
    with torch.inference_mode():
        preds = rgb.port(port_inf.preprocess_inputs_for_inference(t(img)))
    out = port_inf.infer(rgb.port, img)
    errs = assert_fields_match(preds, ref, PRED_FIELDS + ("rgb",))
    assert preds.rgb.shape == (B, V, HW, HW, 3) and 0 <= preds.rgb.min() and preds.rgb.max() <= 1
    torch.testing.assert_close(out.img_no_norm, preds.rgb, rtol=0, atol=0)
    close(out.img_no_norm, np.asarray(ref_post.img_no_norm), MODEL_RTOL)
    record_property("max_err_over_magnitude", errs)


@pytest.mark.parametrize("modalities", ["images_only", "all"])
def test_infer_matches_jax(small, modalities, monkeypatch, record_property):
    x = small.inputs
    kw = {} if modalities == "images_only" else {k: v for k, v in x.items() if k != "images"}
    post = dict(apply_confidence_mask=modalities == "images_only")
    # The JAX infer with its three stages jitted: the same functions, compiled
    # once each rather than run op by op.
    monkeypatch.setattr(jax_inf, "preprocess_inputs_for_inference", jax_preprocess)
    monkeypatch.setattr(jax_inf, "postprocess_model_outputs_for_inference", jax_postprocess)
    jitted = SimpleNamespace(apply=lambda variables, views: small.apply()(variables["params"], views))
    ref = jax_inf.infer(jitted, {"params": small.params}, jnp.asarray(x["images"]),
                        jax_inf.PostprocessConfig(**post), **{k: jnp.asarray(v) for k, v in kw.items()})
    out = port_inf.infer(small.port, x["images"], port_inf.PostprocessConfig(**post), **kw)
    assert out.pts3d.device == torch.device("cpu")
    both = out.mask.numpy() == np.asarray(ref.mask)
    agree = float(both.mean())
    assert agree >= MASK_AGREEMENT
    errs = {}
    for f in port_inf.InferenceOutputs.__dataclass_fields__:
        r, o = getattr(ref, f), getattr(out, f)
        assert (r is None) == (o is None), f
        r, o = np.asarray(r), o.numpy()
        if f in ("pts3d", "pts3d_cam", "depth_along_ray", "depth_z"):  # masked: compared where both masks agree
            r, o = r * both, o * both
        errs[f] = close(o, r, MODEL_RTOL)
    record_property("max_err_over_magnitude", errs)
    record_property("mask_agreement", agree)


def test_infer_rejects_modalities_on_a_model_without_geometric_encoders(small, rgb):
    with pytest.raises(ValueError, match="geometric_inputs=True"):
        port_inf.infer(rgb.port, small.inputs["images"], intrinsics=small.inputs["intrinsics"])


# ---------------------------------------------------------------- export


def export_arrays(seed=50):
    rng = np.random.RandomState(seed)
    pts = rng.randn(2, 17, 19, 3).astype(np.float32)
    colors = rng.uniform(-0.1, 1.1, (2, 17, 19, 3)).astype(np.float32)
    mask = rng.rand(2, 17, 19) > 0.3
    return pts, colors, mask, intrinsics_np(seed, (2,), 17, 19, False), poses_np(seed, (2,))


WRITERS = {
    "ply": lambda m, d, a: m.write_ply_pointcloud(d / "x.ply", a[0][a[2]], a[1][a[2]]),
    "ply_no_colour": lambda m, d, a: m.write_ply_pointcloud(d / "x.ply", a[0]),
    "glb": lambda m, d, a: m.write_glb_pointcloud(d / "x.glb", a[0], a[1]),
    "predictions_to_glb": lambda m, d, a: m.predictions_to_glb(d / "x.glb", a[0], a[1], a[2], max_points=300),
}


def read_tree(d):
    return {p.name: p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("name", list(WRITERS))
def test_pointcloud_writers_match_jax_byte_for_byte(tmp_path, name):
    arrays = export_arrays()
    for side, module in (("jax", jax_viz), ("port", port_viz)):
        (tmp_path / side).mkdir()
        WRITERS[name](module, tmp_path / side, arrays)
    assert read_tree(tmp_path / "port") == read_tree(tmp_path / "jax")


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_writers_match_jax_byte_for_byte(tmp_path, ext):
    pts, colors, mask, K, poses = export_arrays(51)
    model = port_colmap.predictions_to_colmap(pts, colors, K, poses, masks=mask, max_points=200)
    port_colmap.write_model(*model, tmp_path / "port", ext)
    jax_colmap.write_model(*model, tmp_path / "jax", ext)
    assert read_tree(tmp_path / "port") == read_tree(tmp_path / "jax")


def test_predictions_to_colmap_matches_jax_and_round_trips(tmp_path):
    """Cameras and points equal the JAX package's; the poses agree to 1e-6:
    the JAX package converts rotations with SciPy, which first makes the fp32
    matrices orthogonal, the port with numpy alone. Then the binary model
    reads back as written."""
    pts, colors, mask, K, poses = export_arrays(52)
    names = ["a.png", "b.png"]
    cams, ims, p3d = port_colmap.predictions_to_colmap(pts, colors, K, poses, mask, names, max_points=150)
    jcams, jims, jp3d = jax_colmap.predictions_to_colmap(pts, colors, K, poses, mask, names, max_points=150)
    for cid in jcams:
        assert (cams[cid].model, cams[cid].width, cams[cid].height) == (jcams[cid].model, jcams[cid].width,
                                                                        jcams[cid].height)
        np.testing.assert_array_equal(cams[cid].params, jcams[cid].params)
    for iid in jims:
        assert (ims[iid].name, ims[iid].camera_id) == (jims[iid].name, jims[iid].camera_id)
        np.testing.assert_allclose(ims[iid].qvec, jims[iid].qvec, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ims[iid].tvec, jims[iid].tvec, atol=1e-6, rtol=0)
        np.testing.assert_allclose(port_colmap.colmap_qt_to_c2w(ims[iid].qvec, ims[iid].tvec), poses[iid - 1],
                                   atol=1e-6, rtol=0)
    assert sorted(p3d) == sorted(jp3d) and len(p3d) == 150
    for pid in jp3d:
        np.testing.assert_array_equal(p3d[pid].xyz, jp3d[pid].xyz)
        np.testing.assert_array_equal(p3d[pid].rgb, jp3d[pid].rgb)

    port_colmap.write_model(cams, ims, p3d, tmp_path / "sparse", ".bin")
    rcams, rims, rp3d = port_colmap.read_model(tmp_path / "sparse", ".bin")
    for cid, cam in cams.items():
        assert (rcams[cid].model, rcams[cid].width, rcams[cid].height) == (cam.model, cam.width, cam.height)
        np.testing.assert_array_equal(rcams[cid].params, cam.params)
    for iid, im in ims.items():
        assert (rims[iid].name, rims[iid].camera_id) == (im.name, im.camera_id)
        np.testing.assert_array_equal(rims[iid].qvec, im.qvec)
        np.testing.assert_array_equal(rims[iid].tvec, im.tvec)
    for pid, pt in p3d.items():
        np.testing.assert_array_equal(rp3d[pid].xyz, pt.xyz)
        np.testing.assert_array_equal(rp3d[pid].rgb, pt.rgb)
