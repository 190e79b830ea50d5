"""The port's other model parts against the JAX package's, on the CPU.

The small model (``MapAnythingConfig.small()`` with a 4-layer encoder of 64,
``encoder_size="test"``, and a 2-layer trunk, to keep the JAX compiles short) in
each of the four scene representations the port lacked, ``pointmap``,
``raymap+depth``, ``campointmap+pose`` and ``pointmap+raydirs+depth+pose`` (with
and without ``use_factored_predictions_for_global_pointmaps``), the ``linear``
dense head among them; the global-attention trunk with a scale token; the ViT's
register tokens and ``return_layers``; the RADIO and Cosmos encoders; and the
encoder and model registries.

Weights: the JAX trees' shapes from ``jax.eval_shape`` of ``init``, filled from
a numpy seed (``seeded_params``), carried over by ``load_jax_params``. Inputs
from numpy seeds. Tolerances: fp32 on both sides, sums in other orders: model
fields within 1e-4 of each field's magnitude; modules within 1e-4 absolute
(outputs of order 1-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models import registry as jax_registry
from mapanything_tpu.models.encoders import ENCODER_REGISTRY as JAX_ENCODERS
from mapanything_tpu.models.encoders import cosmos as jax_cosmos
from mapanything_tpu.models.encoders import radio as jax_radio
from mapanything_tpu.models.encoders import vit as jax_vit
from mapanything_tpu.models.heads import adaptors as jax_adaptors
from mapanything_tpu.models.heads import pose as jax_pose
from mapanything_tpu.models.info_sharing import global_attention as jax_global
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models import modular_dust3r as port_dust3r
from mapanything_tpu_torch.models import registry as port_registry
from mapanything_tpu_torch.models.encoders import ENCODER_REGISTRY as PORT_ENCODERS
from mapanything_tpu_torch.models.encoders import cosmos as port_cosmos
from mapanything_tpu_torch.models.encoders import encoder_factory
from mapanything_tpu_torch.models.encoders import radio as port_radio
from mapanything_tpu_torch.models.encoders import vit as port_vit
from mapanything_tpu_torch.models.heads import adaptors as port_adaptors
from mapanything_tpu_torch.models.heads import pose as port_pose
from mapanything_tpu_torch.models.info_sharing import global_attention as port_global
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import jax_params_to_state_dict, load_jax_params
from test_torch_port_dust3r import init_apply, randn, run_port
from test_torch_port_infer import seeded_params

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ATOL = 1e-4
MODEL_RTOL = 1e-4  # of each field's magnitude
B, V, HW = 1, 2, 42


def family_config(m, scene_rep_type, **kw):
    """``MapAnythingConfig.small`` of module ``m`` (the JAX or the port model) in
    ``scene_rep_type``, with the small encoder and trunk of this file."""
    adaptors = jax_adaptors if m is jax_ma else port_adaptors
    return m.MapAnythingConfig.small(
        encoder_size="test", info_sharing_depth=2, info_sharing_indices=(0, 1), scene_rep_type=scene_rep_type,
        dense_adaptor=adaptors.DenseAdaptorConfig(components=adaptors.dense_components_for_scene_rep(scene_rep_type),
                                                  with_confidence=True, with_mask=True),
        **kw,
    )


# (scene representation, dense head, use_factored_predictions_for_global_pointmaps)
FAMILIES = [
    ("pointmap", "dpt", True),
    ("raymap+depth", "linear", True),
    ("campointmap+pose", "dpt", True),
    ("pointmap+raydirs+depth+pose", "dpt", True),
    ("pointmap+raydirs+depth+pose", "linear", False),
]


@pytest.mark.parametrize("rep,head,factored", FAMILIES)
def test_small_model_in_each_scene_representation_matches_jax(rep, head, factored, record_property):
    kw = dict(dense_head_type=head, use_factored_predictions_for_global_pointmaps=factored)
    model = jax_ma.MapAnything(family_config(jax_ma, rep, **kw))
    img = randn(1, B, V, HW, HW, 3)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jax_ma.Views(img=jnp.asarray(img)))["params"]
    params = seeded_params(shapes, 2)
    ref = jax.jit(lambda p, x: model.apply({"params": p}, jax_ma.Views(img=x)))(params, jnp.asarray(img))
    port = port_ma.MapAnything(family_config(port_ma, rep, **kw), device="cpu")
    load_jax_params(port, params)
    with torch.inference_mode():
        out = port(port_ma.Views(img=torch.from_numpy(img)))
    errs = {}
    for name in vars(ref):
        want = getattr(ref, name)
        got = getattr(out, name)
        assert (got is None) == (want is None), name
        if want is None:
            continue
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape, name
        if want.dtype == bool:
            assert np.mean(got == want) > 0.999, name
            continue
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=MODEL_RTOL * scale, rtol=0, err_msg=name)
        errs[name] = float(np.abs(got - want).max()) / scale
    assert out.pts3d.shape == (B, V, HW, HW, 3)
    if rep == "raymap+depth":
        assert out.ray_origins is not None and out.cam_trans is None
    record_property("max_err_over_magnitude", errs)


def test_linear_heads_match_jax():
    feat = randn(3, 2, 3, 4, 32)
    params, ref = init_apply(jax_pose.LinearFeature(output_dim=5, patch_size=4), feat)
    out = run_port(port_pose.LinearFeature(32, 5, 4), params, feat)
    assert out.shape == (2, 12, 16, 5)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    params, ref = init_apply(jax_pose.MLPFeature(output_dim=5, patch_size=4, mlp_ratio=2.0), feat)
    np.testing.assert_allclose(run_port(port_pose.MLPFeature(32, 5, 4, mlp_ratio=2.0), params, feat).numpy(), ref,
                               atol=ATOL, rtol=0)


def test_global_attention_trunk_matches_jax(record_property):
    feats, tokens = randn(4, 1, 3, 2, 3, 48), randn(5, 1, 1, 48)
    pe_rows = np.array([7, 3], np.int32)
    kw = dict(depth=2, dim=64, num_heads=4, mlp_ratio=2.0, max_num_views_for_pe=10, indices=(0,))
    params, (ref, ref_inters, ref_tokens) = init_apply(
        jax_global.GlobalAttentionTransformer(input_embed_dim=48, **kw), feats, tokens, pe_rows)
    port = port_global.GlobalAttentionTransformer(48, **kw)
    out, inters, out_tokens = run_port(port, params, feats, tokens, pe_rows)
    for got, want in ((out, ref), (inters[0], ref_inters[0]), (out_tokens, ref_tokens)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))


def test_vit_register_tokens_and_return_layers_match_jax():
    img = randn(6, 2, 28, 42, 3)
    kw = dict(size="test", patch_size=14, pos_embed_grid=4, num_register_tokens=4, return_layers=(1, 3))
    params, (ref_inters, ref) = init_apply(jax_vit.ViTEncoder(**kw), img)
    port = port_vit.ViTEncoder(**kw)
    inters, out = run_port(port, params, img)
    assert out.shape == (2, 2, 3, 64) and port.register_tokens.shape == (1, 4, 64)
    for got, want in zip(list(inters) + [out], list(ref_inters) + [ref]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_radio_encoder_matches_jax():
    img = np.random.RandomState(7).uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    kw = dict(model_version="radio_v2.5-b", patch_size=16, pos_embed_grid=4, size_override="test")
    params, ref = init_apply(jax_radio.RADIOEncoder(**kw), img)
    port = port_radio.RADIOEncoder(**kw)
    np.testing.assert_allclose(run_port(port, params, img).numpy(), ref, atol=ATOL, rtol=0)
    assert {"model.patch_embed.proj.weight", "model.cls_token", "model.blocks.3.ls2.gamma"} <= set(
        dict(port.named_parameters()))
    # "huge" is not a ViT size: the version builds "giant", as in the JAX module.
    assert port_radio.RADIOEncoder("radio_v2.5-h", pos_embed_grid=2).model.embed_dim == 1536


@pytest.mark.parametrize("method", ["haar", "rearrange"])
def test_cosmos_patcher_matches_jax(method):
    x = randn(8, 2, 16, 24, 3)
    ref = np.asarray(jax_cosmos.Patcher2D(4, method).apply({}, jnp.asarray(x)))
    got = port_cosmos.Patcher2D(4, method)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_cosmos_encoder_matches_jax(record_property):
    img = randn(9, 2, 32, 32, 3)
    kw = dict(patch_size=8, patcher_size=4, channels=32, channels_mult=(1, 2), num_res_blocks=1, z_channels=8,
              latent_channels=8)
    params, ref = init_apply(jax_cosmos.CosmosEncoder(**kw), img)
    port = port_cosmos.CosmosEncoder(**kw)
    out = run_port(port, params, img)
    assert out.shape == (2, 4, 4, 8)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    names = {n for n, _ in port.named_parameters()}
    assert {"encoder.down.0.block.0.norm1.weight", "encoder.down.0.downsample.conv.weight",
            "encoder.down.1.block.0.nin_shortcut.weight", "encoder.mid.attn_1.proj_out.bias",
            "encoder.norm_out.weight", "quant_conv.weight"} <= names


# ---------------------------------------------------------------- registries


def test_encoder_factory_matches_the_jax_registry():
    assert sorted(PORT_ENCODERS) == sorted(JAX_ENCODERS)
    for name in JAX_ENCODERS:
        assert PORT_ENCODERS[name].__name__ == JAX_ENCODERS[name].__name__, name
    enc = encoder_factory("croco", embed_dim=64, depth=1, num_heads=4)
    assert type(enc).__name__ == "CroCoEncoder" and enc(torch.zeros(1, 32, 32, 3)).shape == (1, 2, 2, 64)
    with pytest.raises(KeyError, match="unknown encoder"):
        encoder_factory("not_an_encoder")


def test_init_model_matches_the_jax_registry():
    assert sorted(port_registry.MODEL_REGISTRY) == sorted(jax_registry.MODEL_REGISTRY)
    kw = dict(enc_embed_dim=64, enc_depth=1, enc_num_heads=4, dec_embed_dim=64, dec_depth=2, dec_num_heads=4,
              dpt_feature_dim=32, dpt_layer_dims=(16, 32, 48, 64), indices=(0, 0, 1))
    port = port_registry.init_model("modular_dust3r", device="cpu", **kw)
    assert isinstance(port, port_dust3r.ModularDUSt3R) and port.config == port_dust3r.ModularDUSt3RConfig(**kw)
    jax_model = jax_registry.init_model("modular_dust3r", **kw)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)))["params"]
    state = jax_params_to_state_dict(port, seeded_params(shapes, 0))  # strict: every leaf, every parameter
    assert all(state[n].shape == p.shape for n, p in port.named_parameters())
    ablation = port_registry.init_model("mapanything_ablations", scene_rep_type="raymap+depth", device="cpu",
                                        encoder_size="test", info_sharing_depth=2, info_sharing_dim=64,
                                        info_sharing_num_heads=1, info_sharing_indices=(0, 1), dpt_feature_dim=32,
                                        dpt_layer_dims=(16, 32, 48, 64))
    assert ablation.config.dense_adaptor.components == ("ray_origins", "ray_directions", "depth")
    with pytest.raises(KeyError, match="unknown model"):
        port_registry.init_model("not_a_model")
