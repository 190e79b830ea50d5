"""The port's multimodal forward against the JAX package's, on the CPU.

The geometry functions and each geometric encoder are held to their JAX
counterparts, then the small fp32 model with every geometric input (rays,
depth, poses, metric-scale flags) under three kinds of masks: all on, sampled
by the JAX package's ``sample_modality_masks`` (depth sparsification
included), and all off, which must equal the same model fed zeroed inputs
exactly. Inputs are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.geometry import normalization as jax_norm
from mapanything_tpu.geometry import quaternion as jax_quat
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models.encoders import dense_rep as jax_dense_rep
from mapanything_tpu_torch.geometry import normalization as port_norm
from mapanything_tpu_torch.geometry import quaternion as port_quat
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models.encoders import dense_rep as port_dense_rep
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import load_jax_params


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)


FP32_ATOL = 1e-4  # fp32 on both sides, sums in other orders
PRED_FIELDS = (
    "pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans", "cam_quats",
    "metric_scaling_factor", "conf", "non_ambiguous_mask_logits",
)
B, V, HW = 2, 2, 56


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def close(out, ref, atol=FP32_ATOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


# ---------------------------------------------------------------- geometry


def test_quaternion_functions_match_jax():
    q1, q2 = unit(randn(1, 3, 5, 4)), unit(randn(2, 3, 5, 4))
    t1, t2 = randn(3, 3, 5, 3), randn(4, 3, 5, 3)
    tq1, tq2, tt1, tt2 = (torch.from_numpy(x) for x in (q1, q2, t1, t2))
    jq1, jq2, jt1, jt2 = (jnp.asarray(x) for x in (q1, q2, t1, t2))
    close(port_quat.quat_inverse(tq1), jax_quat.quat_inverse(jq1), 1e-6)
    close(port_quat.quat_multiply(tq1, tq2), jax_quat.quat_multiply(jq1, jq2), 1e-6)
    close(port_quat.quat_rotate(tq1, tt1), jax_quat.quat_rotate(jq1, jt1), 1e-5)
    for got, ref in zip(port_quat.relative_pose_quats_trans(tq1, tt1, tq2, tt2),
                        jax_quat.relative_pose_quats_trans(jq1, jt1, jq2, jt2)):
        close(got, ref, 1e-5)


@pytest.mark.parametrize("norm_mode", ["avg_dis", "avg_log1p", "avg_warp-log1p"])
def test_normalization_functions_match_jax(norm_mode):
    depth = np.abs(randn(5, 3, 6, 7, 1))
    depth[0, :2] = 0.0  # zero pixels are left out of the mean
    trans = randn(6, 2, 3, 3)
    trans[1, 0] = 0.0
    pts = randn(7, 2, 3, 6, 7, 3)
    valid = randn(8, 2, 3, 6, 7) > -0.5
    for got, ref in zip(
        port_norm.normalize_depth_using_non_zero_pixels(torch.from_numpy(depth), True),
        jax_norm.normalize_depth_using_non_zero_pixels(jnp.asarray(depth), True),
    ):
        close(got, ref, 1e-6)
    for got, ref in zip(
        port_norm.normalize_pose_translations(torch.from_numpy(trans), True),
        jax_norm.normalize_pose_translations(jnp.asarray(trans), True),
    ):
        close(got, ref, 1e-6)
    for got, ref in zip(
        port_norm.normalize_pointcloud(torch.from_numpy(pts), torch.from_numpy(valid), norm_mode, True),
        jax_norm.normalize_pointcloud(jnp.asarray(pts), jnp.asarray(valid), norm_mode, True),
    ):
        close(got, ref, 1e-5)
    close(port_norm.apply_log_to_norm(torch.from_numpy(pts)), jax_norm.apply_log_to_norm(jnp.asarray(pts)), 1e-6)


# ---------------------------------------------------------------- encoders


def jax_init_apply(module, x, seed):
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.RandomState(seed + 1)  # seeded noise: biases and norms away from 0 and 1
    params = jax.tree.map(lambda p: (np.asarray(p) + 0.05 * rng.randn(*np.shape(p))).astype(np.float32), params)
    return params, np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("in_chans", [3, 1])
def test_dense_representation_encoder(in_chans):
    x = randn(10 + in_chans, 2, 28, 42, in_chans)
    kw = dict(in_chans=in_chans, enc_embed_dim=32, patch_size=14, intermediate_dims=(24, 32, 40))
    params, ref = jax_init_apply(jax_dense_rep.DenseRepresentationEncoder(apply_pe=False, **kw), x, seed=in_chans)
    port = load_jax_params(port_dense_rep.DenseRepresentationEncoder(apply_pe=False, **kw), params)
    out = port(torch.from_numpy(x))
    assert out.shape == (2, 2, 3, 32)
    close(out, ref, 1e-5)
    unshuffled = port_dense_rep.pixel_unshuffle(torch.from_numpy(x), 14)
    close(unshuffled, jax_dense_rep.pixel_unshuffle(jnp.asarray(x), 14), 0)


@pytest.mark.parametrize("in_chans", [4, 3, 1])
def test_global_representation_encoder(in_chans):
    x = randn(20 + in_chans, 6, in_chans)
    params, ref = jax_init_apply(jax_dense_rep.GlobalRepresentationEncoder(in_chans, 48), x, seed=in_chans)
    port = load_jax_params(port_dense_rep.GlobalRepresentationEncoder(in_chans, 48), params)
    close(port(torch.from_numpy(x)), ref, 1e-5)


# ---------------------------------------------------------------- the model


def geometric_views_np(seed=0):
    rng = np.random.RandomState(seed)
    rays = rng.randn(B, V, HW, HW, 3).astype(np.float32)
    rays[..., 2] = np.abs(rays[..., 2]) + 0.5
    return dict(
        img=rng.randn(B, V, HW, HW, 3).astype(np.float32),
        ray_directions=unit(rays),
        depth_along_ray=rng.uniform(0.5, 4.0, (B, V, HW, HW, 1)).astype(np.float32),
        camera_pose_quats=unit(rng.randn(B, V, 4).astype(np.float32)),
        camera_pose_trans=rng.randn(B, V, 3).astype(np.float32),
        is_metric_scale=np.array([[True, True], [False, True]]),
    )


def masks_np(masks):
    return {k: None if v is None else np.array(v) for k, v in vars(masks).items()}


@pytest.fixture(scope="module")
def small_multimodal():
    """JAX MapAnythingConfig.small() with every geometric input: init (seed 0),
    and the port model holding the same weights."""
    arrays = geometric_views_np()
    views = jax_ma.Views(**{k: jnp.asarray(v) for k, v in arrays.items()})
    model = jax_ma.MapAnything(jax_ma.MapAnythingConfig.small())
    params = jax.jit(model.init)(jax.random.PRNGKey(0), views)["params"]
    apply = jax.jit(lambda p, views, masks: model.apply({"params": p}, views, masks))
    port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(), device="cpu", geometric_inputs=True)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    return arrays, params, apply, port


def run_both(small_multimodal, masks, arrays=None):
    base, params, apply, port = small_multimodal
    arrays = base if arrays is None else arrays
    ref = apply(params, jax_ma.Views(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                jax_ma.ModalityMasks(**{k: None if v is None else jnp.asarray(v) for k, v in masks.items()}))
    with torch.inference_mode():
        out = port(port_ma.Views(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                   port_ma.ModalityMasks(**{k: None if v is None else torch.from_numpy(v) for k, v in masks.items()}))
    return out, ref


def assert_predictions_match(out, ref, record_property):
    worst = 0.0
    for name in PRED_FIELDS:
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert o.shape == r.shape, name
        scale = max(1.0, float(np.abs(r).max()))
        worst = max(worst, float(np.abs(o - r).max()) / scale)
        np.testing.assert_allclose(o, r, atol=FP32_ATOL * scale, rtol=0, err_msg=name)  # relative to the magnitude
    record_property("max_err_over_magnitude", worst)


def test_full_modality_forward_matches_jax(small_multimodal, record_property):
    masks = masks_np(jax_ma.full_modality_masks(B, V, True, True, True))
    out, ref = run_both(small_multimodal, masks)
    assert_predictions_match(out, ref, record_property)
    port_masks = port_ma.full_modality_masks(B, V, True, True, True)
    for name, value in masks.items():
        got = getattr(port_masks, name)
        assert (value is None and got is None) or np.array_equal(got.numpy(), value), name


def test_sampled_masks_forward_matches_jax(small_multimodal, record_property):
    cfg = jax_ma.GeometricInputConfig(dropout_prob=0.3, sparse_depth_prob=1.0, depth_scale_norm_all_prob=0.5)
    masks = masks_np(jax_ma.sample_modality_masks(jax.random.PRNGKey(3), B, V, (HW, HW), cfg))
    keep = masks["depth_sparsification_keep"]
    assert keep is not None and 0.02 < keep.mean() < 0.3  # the sparsification is in play
    assert any(m.any() and not m.all() for m in (masks["ray_dirs"], masks["depth"], masks["cam"],
                                                 masks["depth_scale_norm_all"]))
    out, ref = run_both(small_multimodal, masks)
    assert_predictions_match(out, ref, record_property)


def test_all_off_masks_equal_zeroed_inputs(small_multimodal, record_property):
    arrays, _, _, port = small_multimodal
    off = masks_np(jax_ma.full_modality_masks(B, V, False, False, False))
    out, ref = run_both(small_multimodal, off)
    assert_predictions_match(out, ref, record_property)
    zeroed = {k: (v if k == "img" else np.zeros_like(v)) for k, v in arrays.items()}
    out_zero, _ = run_both(small_multimodal, off, zeroed)
    with torch.inference_mode():
        images_only = port(port_ma.Views(img=torch.from_numpy(arrays["img"])))
    for name in PRED_FIELDS:
        assert torch.equal(getattr(out, name), getattr(out_zero, name)), name
        assert torch.equal(getattr(out, name), getattr(images_only, name)), name


def test_sample_modality_masks_port():
    cfg = port_ma.GeometricInputConfig(sparse_depth_prob=1.0, rgb_dropout_prob=0.5)
    a = port_ma.sample_modality_masks(torch.Generator().manual_seed(4), 64, 3, (6, 5), cfg)
    b = port_ma.sample_modality_masks(torch.Generator().manual_seed(4), 64, 3, (6, 5), cfg)
    for name in vars(a):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.depth_sparsification_keep.shape == (64, 3, 6, 5, 1)
    assert bool(a.rgb[:, 0].all()) and not bool(a.rgb.all())
    assert bool((a.ray_dirs | a.rgb).all()) and bool((a.cam | a.rgb).all())  # no-RGB views get rays and poses
    # one uniform draw feeds both metric-scale kill switches, as in the JAX package
    assert torch.equal(a.depth_scale_norm_all, a.pose_scale_norm_all)
    for name in ("ray_dirs", "depth", "cam"):  # per-sample draws, shared across the views
        m = getattr(a, name) | ~getattr(a, "rgb")
        assert 0 < int(m.sum()) < m.numel()


def test_geometric_inputs_need_the_encoders():
    model = port_ma.MapAnything(port_ma.MapAnythingConfig.small(info_sharing_depth=2), device="cpu")
    img = torch.zeros(1, 1, 28, 28, 3)
    with pytest.raises(ValueError, match="geometric_inputs=True"):
        model(port_ma.Views(img=img, depth_along_ray=torch.ones(1, 1, 28, 28, 1)))
