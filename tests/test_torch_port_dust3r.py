"""The DUSt3R family of the port against the JAX package's, on the CPU.

RoPE2D in fp32 and bf16; self-attention with the rope hook and qk-norm; the
cross-attention and its block; the CroCo encoder with ``return_layers``; the
cross-attention decoder at two and three views, standard and differential; the
whole ``ModularDUSt3R`` at the registry's small preset (heads of 16) with
``return_features``; and a DUSt3R state dict in the release's names, loaded
into the port by name and held to ``convert_modular_dust3r`` of the same dict.

Weights: the JAX trees' shapes from ``jax.eval_shape`` of ``init``, filled from
a numpy seed (``seeded_params``), carried over by ``load_jax_params``. Inputs
from numpy seeds. Tolerances: fp32 on both sides, sums in other orders: RoPE
within 1e-6 absolute (inputs of order 1); blocks, encoder and decoder within
1e-4 absolute (outputs of order 1-10); the model's fields within 1e-4 of each
field's magnitude. RoPE in bf16: within one bf16 step of the magnitude (2^-7 of
the largest output), since XLA may keep a product in fp32 that torch rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.models import blocks as jax_blocks
from mapanything_tpu.models import modular_dust3r as jax_dust3r
from mapanything_tpu.models.encoders import croco as jax_croco
from mapanything_tpu.models.info_sharing import cross_attention as jax_xattn
from mapanything_tpu.ops import rope as jax_rope
from mapanything_tpu.utils import torch_convert
from mapanything_tpu_torch.models import blocks as port_blocks
from mapanything_tpu_torch.models import modular_dust3r as port_dust3r
from mapanything_tpu_torch.models.encoders import croco as port_croco
from mapanything_tpu_torch.models.info_sharing import cross_attention as port_xattn
from mapanything_tpu_torch.ops import rope as port_rope
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import jax_params_to_state_dict, load_jax_params
from test_torch_port_infer import seeded_params

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ROPE_ATOL = 1e-6
ATOL = 1e-4
MODEL_RTOL = 1e-4  # of each field's magnitude


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def init_apply(module, *args, seed=0):
    """The JAX module's tree seeded from its eval_shape, and its jitted output."""
    jargs = [jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *jargs)["params"]
    params = seeded_params(shapes, seed)
    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params, *jargs)
    return params, jax.tree.map(np.asarray, out)


def run_port(module, params, *args):
    load_jax_params(module, params)
    with torch.no_grad():
        return module(*[torch.from_numpy(np.array(a)) for a in args])


def grid(b, h, w):
    return np.asarray(jax_rope.patch_position_grid(b, h, w))


# ---------------------------------------------------------------- RoPE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_2d_matches_jax(dtype, record_property):
    x = randn(0, 2, 24, 3, 64) * 2
    pos = np.random.RandomState(1).randint(0, 512, (2, 24, 2))
    ref = np.asarray(jax_rope.rope_2d(jnp.asarray(x, dtype), jnp.asarray(pos)).astype(jnp.float32))
    got = port_rope.rope_2d(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    atol = ROPE_ATOL if dtype == "float32" else 2.0**-7 * float(np.abs(ref).max())
    err = float(np.abs(got.float().numpy() - ref).max())
    record_property("max_abs_err", err)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)


def test_rope_tables_and_grid_are_the_jax_ones():
    for got, want in zip(port_rope._cos_sin_table(32, 512, 100.0), jax_rope._cos_sin_table(32, 512, 100.0)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_rope.patch_position_grid(2, 3, 5).numpy(), grid(2, 3, 5))
    with pytest.raises(ValueError, match="divisible by 4"):
        port_rope.rope_2d(torch.zeros(1, 2, 1, 6), torch.zeros(1, 2, 2, dtype=torch.int64))


def test_plain_attention_routes_sdpa_to_the_plain_version_and_restores_the_kernels():
    from mapanything_tpu_torch.ops import attention
    from mapanything_tpu_torch.ops import flash_attention as port_fa

    q = torch.from_numpy(randn(30, 1, 5, 2, 16))
    with attention.plain_attention():
        assert attention.flash_attention is not port_fa.flash_attention
        torch.testing.assert_close(attention.sdpa(q, q, q), port_fa.attention_reference(q, q, q), rtol=0, atol=0)
    assert attention.flash_attention is port_fa.flash_attention
    with pytest.raises(RuntimeError), attention.plain_attention():
        raise RuntimeError
    assert attention.flash_attention is port_fa.flash_attention


# ---------------------------------------------------------------- blocks


def test_attention_with_rope_and_qk_norm_matches_jax(record_property):
    x, pos = randn(2, 2, 15, 64), grid(2, 3, 5)
    jmod = jax_blocks.Attention(dim=64, num_heads=4, qkv_bias=True, qk_norm=True, rope=jax_rope.make_rope2d())
    params, ref = init_apply(jmod, x, pos)
    port = port_blocks.Attention(64, 4, qkv_bias=True, qk_norm=True, rope=port_rope.make_rope2d())
    out = run_port(port, params, x, pos)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert "q_norm.weight" in dict(port.named_parameters())


def test_cross_attention_with_rope_and_qk_norm_matches_jax():
    q, kv = randn(3, 2, 15, 64), randn(4, 2, 20, 64)
    qpos, kpos = grid(2, 3, 5), grid(2, 4, 5)
    jmod = jax_blocks.CrossAttention(dim=64, num_heads=4, qkv_bias=True, qk_norm=True, rope=jax_rope.make_rope2d(),
                                     use_scalable_softmax=True)
    params, ref = init_apply(jmod, q, kv, kv, qpos, kpos)
    port = port_blocks.CrossAttention(64, 4, qkv_bias=True, qk_norm=True, rope=port_rope.make_rope2d(),
                                      use_scalable_softmax=True)
    np.testing.assert_allclose(run_port(port, params, q, kv, kv, qpos, kpos).numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("differential", [False, True])
def test_cross_attention_block_matches_jax(differential, record_property):
    x, ctx = randn(5, 2, 15, 64), randn(6, 2, 30, 64)
    kw = dict(mlp_ratio=2.0, init_values=0.1, differential=differential, layer_depth=3)
    jmod = jax_blocks.CrossAttentionBlock(dim=64, num_heads=2, **kw)
    params, ref = init_apply(jmod, x, ctx)
    port = port_blocks.CrossAttentionBlock(64, 2, **kw)
    out = run_port(port, params, x, ctx)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert {"norm_y.weight", "ls3.gamma"} <= set(dict(port.named_parameters()))


def test_differential_self_attention_block_matches_jax():
    x, pos = randn(7, 2, 15, 64), grid(2, 3, 5)
    jmod = jax_blocks.SelfAttentionBlock(dim=64, num_heads=2, differential=True, layer_depth=2,
                                         rope=jax_rope.make_rope2d())
    params, ref = init_apply(jmod, x, pos)
    port = port_blocks.SelfAttentionBlock(64, 2, differential=True, layer_depth=2, rope=port_rope.make_rope2d())
    np.testing.assert_allclose(run_port(port, params, x, pos).numpy(), ref, atol=ATOL, rtol=0)


# ---------------------------------------------------------------- encoder and decoder


def test_croco_encoder_with_return_layers_matches_jax(record_property):
    img = randn(8, 2, 48, 64, 3)
    kw = dict(patch_size=16, embed_dim=64, depth=3, num_heads=4, return_layers=(0, 2))
    params, (ref_inters, ref) = init_apply(jax_croco.CroCoEncoder(**kw), img)
    port = port_croco.CroCoEncoder(**kw)
    inters, out = run_port(port, params, img)
    assert out.shape == (2, 3, 4, 64) and len(inters) == 2
    for got, want in zip(list(inters) + [out], list(ref_inters) + [ref]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))
    names = [n for n, _ in port.named_parameters()]
    assert names[:2] == ["patch_embed.proj.weight", "patch_embed.proj.bias"] and names[-1] == "enc_norm.bias"


@pytest.mark.parametrize("views,differential", [(2, False), (3, False), (2, True), (3, True)])
def test_cross_attention_transformer_matches_jax(views, differential, record_property):
    feats = randn(9 + views, 1, views, 3, 4, 48)
    kw = dict(depth=2, dim=64, num_heads=4, mlp_ratio=2.0, indices=(0, 1), differential=differential)
    params, (ref, ref_inters) = init_apply(jax_xattn.CrossAttentionTransformer(input_embed_dim=48, **kw), feats)
    port = port_xattn.CrossAttentionTransformer(48, **kw)
    out, inters = run_port(port, params, feats)
    assert out.shape == (1, views, 3, 4, 64) and len(inters) == 2
    for got, want in zip(list(inters) + [out], list(ref_inters) + [ref]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))


# ---------------------------------------------------------------- the model


B, H, W = 1, 64, 96


@pytest.fixture(scope="module")
def small_dust3r():
    """The small preset's JAX tree (seeded), its jitted forward with the decoder's
    features, and the port model holding the same weights."""
    cfg = jax_dust3r.ModularDUSt3RConfig(**vars_of(port_dust3r.small_config()))
    model = jax_dust3r.ModularDUSt3R(cfg)
    img = randn(20, B, 2, H, W, 3)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(img))["params"]
    params = seeded_params(shapes, 21)
    ref = jax.jit(lambda p, x: model.apply({"params": p}, x, return_features=True))(params, jnp.asarray(img))
    port = port_dust3r.ModularDUSt3R(port_dust3r.small_config(), device="cpu")
    load_jax_params(port, params)
    return params, img, jax.tree.map(np.asarray, ref), port


def vars_of(cfg):
    """A port config's fields as JAX config arguments (the adaptor configs excepted)."""
    return {k: v for k, v in vars(cfg).items() if k not in ("pointmap", "confidence")}


def close_field(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=MODEL_RTOL * scale, rtol=0)
    return float(np.abs(got - want).max()) / scale


def test_modular_dust3r_matches_jax(small_dust3r, record_property):
    _, img, (ref, ref_feats), port = small_dust3r
    with torch.inference_mode():
        preds, feats = port(torch.from_numpy(img), return_features=True)
    assert preds.pts3d.shape == (B, 2, H, W, 3) and preds.conf.shape == (B, 2, H, W)
    assert float(preds.conf.min()) >= 1.0
    errs = {name: close_field(getattr(preds, name).numpy(), getattr(ref, name)) for name in ("pts3d", "conf")}
    errs["features"] = close_field(feats.numpy(), ref_feats)
    record_property("max_err_over_magnitude", errs)


def test_modular_dust3r_is_a_two_view_model_and_needs_cuda_by_default():
    with pytest.raises(ValueError, match="two-view"):
        port_dust3r.ModularDUSt3R(port_dust3r.small_config(enc_depth=1, dec_depth=1), device="cpu")(
            torch.zeros(1, 3, 32, 32, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_dust3r.ModularDUSt3R(port_dust3r.small_config())


def reference_state_dict(port, seed):
    """A seeded DUSt3R state dict in the release's names: every encoder and decoder
    tensor of ``port``'s shapes, with each decoder block's ``norm_y``."""
    rng = np.random.default_rng(seed)
    return {name: (0.05 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
            for name, p in port.state_dict().items() if not name.startswith("dpt_")}


def test_release_state_dict_loads_by_name_as_convert_modular_dust3r_reads_it():
    """A decoder narrower than the encoder, so the release's ``decoder_embed`` exists."""
    cfg = port_dust3r.small_config(dec_embed_dim=48, dec_num_heads=3)
    port = port_dust3r.ModularDUSt3R(cfg, device="cpu")
    jax_model = jax_dust3r.ModularDUSt3R(jax_dust3r.ModularDUSt3RConfig(**vars_of(cfg)))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((B, 2, H, W, 3)))["params"]
    state = reference_state_dict(port, 22)
    assert {"patch_embed.proj.weight", "enc_blocks.1.mlp.fc2.bias", "enc_norm.weight", "decoder_embed.weight",
            "dec_blocks.0.norm_y.weight", "dec_blocks2.1.cross_attn.projv.weight", "dec_norm.bias"} <= set(state)
    tree = torch_convert.convert_modular_dust3r(state)
    assert torch_convert.verify_tree_shapes(tree, {k: shapes[k] for k in ("encoder", "decoder")}) == []
    heads = seeded_params({k: v for k, v in shapes.items() if k.startswith("dpt_")}, 23)
    want = jax_params_to_state_dict(port, dict(tree, **heads))
    missing = port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=False).missing_keys
    assert missing and all(k.startswith("dpt_") for k in missing)
    for name, value in port.state_dict().items():
        if not name.startswith("dpt_"):
            assert torch.equal(value, want[name]), name
