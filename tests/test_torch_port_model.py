"""Module-by-module parity of the PyTorch port with the JAX package, on the CPU.

Each test initialises the JAX module, carries its parameters into the port
module with ``load_jax_params``, feeds both the same numpy inputs (fixed
seeds) and compares the outputs in fp32. Module tests add seeded noise to
the JAX initialisation so that no block is near the identity (LayerScale
starts at 1e-5). The whole-slice test uses the JAX initialisation as it is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mapanything_tpu.geometry import camera as jax_camera
from mapanything_tpu.geometry import normalization as jax_norm
from mapanything_tpu.models import blocks as jax_blocks
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models.encoders import vit as jax_vit
from mapanything_tpu.models.heads import adaptors as jax_adaptors
from mapanything_tpu.models.heads import dpt as jax_dpt
from mapanything_tpu.models.heads import pose as jax_pose
from mapanything_tpu.models.info_sharing import alternating as jax_alt
from mapanything_tpu.utils import torch_convert
from mapanything_tpu_torch.geometry import camera as port_camera
from mapanything_tpu_torch.geometry import normalization as port_norm
from mapanything_tpu_torch.models import blocks as port_blocks
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models.encoders import vit as port_vit
from mapanything_tpu_torch.models.heads import adaptors as port_adaptors
from mapanything_tpu_torch.models.heads import dpt as port_dpt
from mapanything_tpu_torch.models.heads import pose as port_pose
from mapanything_tpu_torch.models.info_sharing import alternating as port_alt
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import load_jax_params


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)


FP32_ATOL = 1e-4  # fp32 on both sides, sums in other orders; ~5e-6 seen at these sizes


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_init_apply(module, *args, static=(), perturb=0.05, seed=0):
    """Init ``module`` on ``args`` (then ``static``, untraced), add seeded noise,
    apply; numpy params and output."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    init = jax.jit(lambda rng, *a: module.init(rng, *a, *static))
    params = init(jax.random.PRNGKey(seed), *jargs)["params"]
    rng = np.random.RandomState(seed + 1)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + perturb * rng.randn(*np.shape(x))).astype(np.float32), params
    )
    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a, *static))(params, *jargs)
    return params, jax.tree.map(np.asarray, out)


def port_apply(module, params, *args):
    load_jax_params(module, params)
    with torch.no_grad():
        return module(*[torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args])


def close(port_out, ref, atol=FP32_ATOL):
    np.testing.assert_allclose(port_out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0)


# ---------------------------------------------------------------- blocks


def test_gelu_dtype_policy():
    x = randn(0, 1000) * 3
    port32 = port_blocks.gelu_matched(torch.from_numpy(x))
    np.testing.assert_allclose(port32.numpy(), np.asarray(jax_blocks.gelu_matched(jnp.asarray(x))), atol=1e-6)
    torch.testing.assert_close(port32, F.gelu(torch.from_numpy(x)))  # erf in fp32
    xb = torch.from_numpy(x).bfloat16()
    port16 = port_blocks.gelu_matched(xb)
    assert port16.dtype == torch.bfloat16
    torch.testing.assert_close(port16, F.gelu(xb, approximate="tanh"), rtol=0, atol=0)
    jax16 = np.asarray(jax_blocks.gelu_matched(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    # both tanh in bf16, rounded at other places: one bf16 ulp at |gelu| < 16
    np.testing.assert_allclose(port16.float().numpy(), jax16, atol=0.0625)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attention_block(dtype):
    x = randn(1, 2, 20, 128)
    jmod = jax_blocks.SelfAttentionBlock(dim=128, num_heads=2, init_values=1e-5, dtype=jnp.dtype(dtype))
    params, ref = jax_init_apply(jmod, x)
    port = port_blocks.SelfAttentionBlock(128, 2, init_values=1e-5, dtype=getattr(torch, dtype))
    out = port_apply(port, params, x)
    assert out.dtype == torch.float32  # fp32 residual stream + compute-dtype branch, as in JAX
    # bf16: each side rounds to bf16 at its own places (2e-3 seen at |out| ~ 4)
    close(out, ref, atol=FP32_ATOL if dtype == "float32" else 1e-2)


def test_drop_path_is_identity_in_eval_and_per_sample_in_training():
    x = torch.from_numpy(randn(6, 64, 3, 5))
    dp = port_blocks.DropPath(0.5)
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(port_blocks.DropPath(0.0).train()(x), x)
    torch.manual_seed(0)
    y = dp.train()(x)
    kept = (y == 2 * x).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and 0 < int(kept.sum()) < 64


# ---------------------------------------------------------------- encoder


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_interpolate_pos_embed(hw):
    pe = randn(2, 1, 37 * 37, 8)
    ref = np.asarray(jax_vit.interpolate_pos_embed(jnp.asarray(pe), *hw))
    out = port_vit.interpolate_pos_embed(torch.from_numpy(pe), *hw)
    close(out, ref, atol=1e-5)


def test_vit_encoder_small_56px():
    images = randn(3, 2, 56, 56, 3)
    params, ref = jax_init_apply(jax_vit.ViTEncoder(size="small"), images)
    out = port_apply(port_vit.ViTEncoder("small"), params, images)
    assert out.shape == (2, 4, 4, 384)
    close(out, ref)


# ---------------------------------------------------------------- trunk


@pytest.mark.parametrize("non_ref_pe", [False, True])
def test_alternating_trunk_small_with_scale_token(non_ref_pe):
    feats = randn(4, 1, 3, 4, 4, 384)
    tokens = randn(5, 1, 1, 384)
    kw = dict(depth=4, dim=256, num_heads=4, indices=(1, 2), use_pe_for_non_reference_views=non_ref_pe)
    jmod = jax_alt.AlternatingAttentionTransformer(input_embed_dim=384, **kw)
    pe_idx = np.array([5, 2]) if non_ref_pe else None
    params, (ref_final, ref_inter, ref_tok) = jax_init_apply(
        jmod, feats, tokens, None if pe_idx is None else jnp.asarray(pe_idx)
    )
    port = port_alt.AlternatingAttentionTransformer(384, **kw)
    load_jax_params(port, params)
    with torch.no_grad():
        final, inter, tok = port(
            torch.from_numpy(feats), torch.from_numpy(tokens),
            None if pe_idx is None else torch.from_numpy(pe_idx),
        )
    close(final, ref_final)
    assert len(inter) == 2
    for a, b in zip(inter, ref_inter):
        close(a, b)
    close(tok, ref_tok)


# ---------------------------------------------------------------- heads


@pytest.mark.parametrize("hw", [(4, 4), (5, 3)])
def test_dpt_feature_and_regressor(hw):
    h, w = hw
    dims = (384, 256, 256, 256)
    feats = [randn(10 + i, 2, h, w, c) for i, c in enumerate(dims)]
    jfeat = jax_dpt.DPTFeature(input_feature_dims=dims, layer_dims=(32, 48, 64, 96), feature_dim=64)
    params_f, ref_f = jax_init_apply(jfeat, feats)
    pfeat = port_dpt.DPTFeature(input_feature_dims=dims, layer_dims=(32, 48, 64, 96), feature_dim=64)
    out_f = port_apply(pfeat, params_f, [torch.from_numpy(f) for f in feats])
    assert out_f.shape == (2, 8 * h, 8 * w, 64)
    close(out_f, ref_f)

    hw_out = (14 * h, 14 * w)
    params_r, ref_r = jax_init_apply(
        jax_dpt.DPTRegressionProcessor(output_dim=6), np.asarray(ref_f), static=(hw_out,)
    )
    out_r = port_apply(port_dpt.DPTRegressionProcessor(64, 6), params_r, np.asarray(ref_f), hw_out)
    assert out_r.shape == (2, 14 * h, 14 * w, 6)
    close(out_r, ref_r)


def test_strided_conv_transpose_in_ne_out():
    # in != out channels: a swapped (in, out) weight layout fails here.
    x = randn(20, 2, 3, 3, 7)
    params, ref = jax_init_apply(jax_dpt.StridedConvTranspose(features=5, kernel_size=4), x)
    out = port_apply(port_dpt.StridedConvTranspose(7, 5, 4), params, x.transpose(0, 3, 1, 2).copy())
    close(out.permute(0, 2, 3, 1), ref, atol=1e-5)


def test_resize_over_batch_pieces_changes_no_value(monkeypatch):
    # Past the element limit (as 64 views at 518 px on the card) the resize runs
    # over batch pieces: 3 items of 2 x 11 x 13 outputs a piece here, 7 items in all.
    x = torch.from_numpy(randn(21, 7, 2, 5, 6)).to(memory_format=torch.channels_last)
    whole = F.interpolate(x, size=(11, 13), mode="bilinear", align_corners=True)
    monkeypatch.setattr(port_dpt, "MAX_RESIZE_ELEMENTS", 3 * 2 * 11 * 13 + 1)
    torch.testing.assert_close(port_dpt._resize_bilinear_align_corners(x, (11, 13)), whole, rtol=0, atol=0)


def test_pose_head():
    feat = randn(21, 2, 4, 4, 256)
    params, ref = jax_init_apply(jax_pose.PoseHead(patch_size=14), feat)
    out = port_apply(port_pose.PoseHead(256, patch_size=14), params, feat)
    assert out.shape == (2, 7)
    close(out, ref)


def test_mlp_head():
    tokens = randn(22, 2, 1, 256)
    params, ref = jax_init_apply(jax_pose.MLPHead(output_dim=1), tokens)
    out = port_apply(port_pose.MLPHead(256, output_dim=1), params, tokens)
    assert out.shape == (2, 1, 1)
    close(out, ref)


def _dense_cfg(m, variant):
    if variant == "default":
        return m.DenseAdaptorConfig()
    return m.DenseAdaptorConfig(
        components=("pointmap", "ray_origins", "ray_directions", "depth", "rgb", "cam_translation", "quaternions"),
        pointmap=m.RangeConfig("z_exp" if variant == "z_exp" else "exp"),
        cam_translation=m.RangeConfig("square", -5.0, 5.0),
        depth=m.RangeConfig("square", 0.0, 10.0),
        ray_dirs=m.RayDirsConfig(clamp_min_of_z_dir=True, z_dir_min=0.5),
        confidence=m.ConfidenceConfig("sigmoid", 1.0, 5.0),
        with_mask=variant != "z_exp",
    )


@pytest.mark.parametrize("variant", ["default", "all_components", "z_exp"])
def test_dense_adaptor(variant):
    jcfg, pcfg = _dense_cfg(jax_adaptors, variant), _dense_cfg(port_adaptors, variant)
    x = randn(23, 2, 5, 6, pcfg.num_channels)
    ref = jax_adaptors.apply_dense_adaptor(jnp.asarray(x), jcfg)
    out = port_adaptors.apply_dense_adaptor(torch.from_numpy(x), pcfg)
    for name in ("value", "confidence", "mask", "logits"):
        r, o = getattr(ref, name), getattr(out, name)
        assert (r is None) == (o is None), name
        if r is not None:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6, err_msg=name)


def test_pose_and_scale_adaptors_and_scene_reps():
    x = randn(24, 2, 3, 7)
    np.testing.assert_allclose(
        port_adaptors.apply_pose_adaptor(torch.from_numpy(x), port_adaptors.PoseAdaptorConfig()).numpy(),
        np.asarray(jax_adaptors.apply_pose_adaptor(jnp.asarray(x), jax_adaptors.PoseAdaptorConfig())),
        rtol=1e-5, atol=1e-6,
    )
    s = randn(25, 2, 1, 1)
    np.testing.assert_allclose(
        port_adaptors.apply_scale_adaptor(torch.from_numpy(s), port_adaptors.ScaleAdaptorConfig()).numpy(),
        np.asarray(jax_adaptors.apply_scale_adaptor(jnp.asarray(s), jax_adaptors.ScaleAdaptorConfig())),
        rtol=1e-6,
    )
    for rep in jax_adaptors._COMPONENTS_BY_SCENE_REP:
        assert port_adaptors.dense_components_for_scene_rep(rep) == jax_adaptors.dense_components_for_scene_rep(rep)


# ---------------------------------------------------------------- geometry


def test_pointmap_from_rays_depth_pose_and_safe_norm():
    rays = randn(30, 2, 3, 5, 6, 3)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    depth = np.abs(randn(31, 2, 3, 5, 6, 1)) + 0.1
    trans = randn(32, 2, 3, 3)
    quats = randn(33, 2, 3, 4)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ref = jax_camera.pointmap_from_rays_depth_pose(*(jnp.asarray(a) for a in (rays, depth, trans, quats)))
    out = port_camera.pointmap_from_rays_depth_pose(*(torch.from_numpy(a) for a in (rays, depth, trans, quats)))
    close(out, ref, atol=1e-5)

    x = randn(34, 4, 3)
    x[1] = 0.0
    ref_n = np.asarray(jax_norm.safe_norm(jnp.asarray(x), axis=-1, keepdims=True))
    out_n = port_norm.safe_norm(torch.from_numpy(x), dim=-1, keepdim=True)
    close(out_n, ref_n, atol=1e-6)
    xt = torch.zeros(3, requires_grad=True)
    port_norm.safe_norm(xt).backward()
    assert torch.equal(xt.grad, torch.zeros(3))  # 0 gradient at the origin, not NaN


# ---------------------------------------------------------------- the slice


PRED_FIELDS = (
    "pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans", "cam_quats",
    "metric_scaling_factor", "conf", "non_ambiguous_mask_logits",
)


def jax_small_slice(**cfg_kw):
    """JAX MapAnythingConfig.small(**cfg_kw) at 2 views x 56 px: init (seed 0) and
    forward, and the port model with the same weights."""
    img = randn(0, 1, 2, 56, 56, 3)
    model = jax_ma.MapAnything(jax_ma.MapAnythingConfig.small(**cfg_kw))
    views = jax_ma.Views(img=jnp.asarray(img))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), views)
    preds = jax.jit(model.apply)(variables, views)
    params = jax.tree.map(np.asarray, variables["params"])
    port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**cfg_kw), device="cpu")
    load_jax_params(port, params)
    return img, params, preds, port


@pytest.fixture(scope="module")
def small_slice():
    return jax_small_slice()


def assert_forward_matches(small_slice):
    """The port's images-only forward against ``jax_small_slice``'s, field by field."""
    img, _, ref, port = small_slice
    from mapanything_tpu_torch.ops.flash_attention import flash_attention

    before = flash_attention.launches
    with torch.inference_mode():  # the forward is differentiable; inference runs it so
        out = port(port_ma.Views(img=torch.from_numpy(img)))
    assert flash_attention.launches == before  # CPU: the plain version, no kernel
    for name in PRED_FIELDS:
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert o.shape == r.shape, name
        # fp32 both sides; errors relative to the field's magnitude (depths reach ~15)
        tol = 1e-4 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o, r, atol=tol, rtol=0, err_msg=name)
    agree = np.mean(np.asarray(ref.non_ambiguous_mask) == out.non_ambiguous_mask.numpy())
    assert agree >= 0.999


def test_small_model_forward_matches_jax(small_slice):
    assert_forward_matches(small_slice)


def test_state_dict_names_are_the_reference_names(small_slice):
    """port.state_dict() through torch_convert's sub-converters gives the JAX tree back."""
    _, params, _, port = small_slice
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    enc = {k[len("encoder.model."):]: v for k, v in sd.items() if k.startswith("encoder.model.")}
    tree = {
        "scale_token": sd["scale_token"],
        "fusion_norm": torch_convert.layer_norm(sd["fusion_norm_layer.weight"], sd["fusion_norm_layer.bias"]),
        "encoder": torch_convert.convert_dinov2_vit(enc),
        "info_sharing": torch_convert.convert_alternating_transformer(sd, "info_sharing."),
        "dpt_feature_head": torch_convert.convert_dpt_feature(sd, "dpt_feature_head."),
        "dpt_regressor_head": torch_convert.convert_dpt_regressor(sd, "dpt_regressor_head."),
        "pose_head": torch_convert.convert_pose_head(sd, "pose_head."),
        "scale_head": torch_convert.convert_mlp_head(sd, "scale_head."),
    }
    flat_ref = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert sorted(flat_got) == sorted(flat_ref)
    for key, ref in flat_ref.items():
        assert flat_got[key].shape == ref.shape, key
        assert np.array_equal(flat_got[key], ref), key


def test_load_jax_params_is_strict():
    params, _ = jax_init_apply(jax_pose.MLPHead(output_dim=1), randn(40, 1, 1, 32))
    port = port_pose.MLPHead(32, output_dim=1)
    with pytest.raises(KeyError, match="not used"):
        load_jax_params(port, {**params, "extra": {"kernel": np.zeros((2, 2), np.float32)}})
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(port, {k: v for k, v in params.items() if k != "output_proj"})
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_jax_params(port_pose.MLPHead(32, output_dim=2), params)
