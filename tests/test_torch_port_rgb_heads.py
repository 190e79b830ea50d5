"""The RGB-prediction models of the port against the JAX package's, on the CPU.

The MAE decoder and the MoGe convolutional decoder alone (narrow widths, the
decoder's heads of 32 as at full width); the small model
(``MapAnythingConfig.small()``) with each head and the ``raydirs+depth+rgb+pose``
scene representation, images only, with and without the raw-encoder-feature
preset and with ``head_chunk_size``; the small MAE model's train step with a
seeded ``target_rgb`` (the loss, its details and every gradient); and the RGB L1
term of the production loss on the small DPT-RGB model, which the port's loss
lacked (its ``LossBatch`` had no ``target_rgb``).

Weights: the JAX trees' shapes from ``jax.eval_shape`` of ``init``, filled from a
numpy seed (``seeded_params``), carried over by ``load_jax_params``. Inputs from
numpy seeds. Tolerances: fp32 on both sides, sums in other orders: the heads alone
within 1e-4 absolute (their outputs are of order 1), model fields within 1e-4 of
each field's magnitude, losses within 1e-4 relative, gradients within 1e-4 of
each leaf's largest.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models.heads import adaptors as jax_adaptors
from mapanything_tpu.models.heads import mae as jax_mae
from mapanything_tpu.models.heads import moge_conv as jax_moge
from mapanything_tpu.train import losses as jax_losses
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models.heads import adaptors as port_adaptors
from mapanything_tpu_torch.models.heads import mae as port_mae
from mapanything_tpu_torch.models.heads import moge_conv as port_moge
from mapanything_tpu_torch.ops import flash_attention as port_fa
from mapanything_tpu_torch.train import losses as port_losses
from mapanything_tpu_torch.train import step as port_step
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import jax_params_to_state_dict, load_jax_params
from test_torch_port_infer import seeded_params
from test_torch_port_model import jax_init_apply, port_apply
from test_torch_port_train import PRED_FIELDS, jax_batch, loss_batch_np, port_batch

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

HEAD_ATOL = 1e-4
MODEL_RTOL = 1e-4  # of each field's magnitude
B, V, HW = 1, 2, 56
RGB_FIELDS = PRED_FIELDS + ("rgb",)


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def rgb_config(m, **kw):
    """``MapAnythingConfig.small(**kw)`` of module ``m`` (the JAX or the port model)
    with the ``raydirs+depth+rgb+pose`` scene representation."""
    adaptors = jax_adaptors if m is jax_ma else port_adaptors
    return m.MapAnythingConfig.small(
        scene_rep_type="raydirs+depth+rgb+pose",
        dense_adaptor=adaptors.DenseAdaptorConfig(components=("ray_directions", "depth", "rgb"),
                                                  with_confidence=True, with_mask=True),
        **kw,
    )


def close_fields(out, ref, fields=RGB_FIELDS):
    errs = {}
    for name in fields:
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).detach().numpy()
        assert o.shape == r.shape, name
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o, r, atol=MODEL_RTOL * scale, rtol=0, err_msg=name)
        errs[name] = float(np.abs(o - r).max()) / scale
    return errs


# ---------------------------------------------------------------- the heads alone


LEVEL_DIMS = (48, 32, 32, 40)


@pytest.mark.parametrize("out_hw", [(56, 56), (60, 50)])
def test_mae_head_matches_jax(out_hw, record_property):
    feats = [randn(10 + i, 2, 4, 4, c) for i, c in enumerate(LEVEL_DIMS)]
    kw = dict(patch_size=14, decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=2)  # heads of 32
    jmod = jax_mae.MAEGeneralDecoder(output_dim=7, **kw)
    params, ref = jax_init_apply(jmod, feats, static=(out_hw,))
    port = port_mae.MAEGeneralDecoder(LEVEL_DIMS, 7, **kw)
    out = port_apply(port, params, [torch.from_numpy(f) for f in feats], out_hw)
    assert out.shape == (2, *out_hw, 7)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=HEAD_ATOL, rtol=0)


def test_sincos_pos_embed_is_the_jax_one():
    np.testing.assert_array_equal(port_mae.sincos_2d_pos_embed(64, 3, 5), jax_mae.sincos_2d_pos_embed(64, 3, 5))


@pytest.mark.parametrize("out_hw", [(56, 56), (32, 32)])
def test_moge_head_matches_jax(out_hw, record_property):
    feats = [randn(20 + i, 2, 4, 4, c) for i, c in enumerate(LEVEL_DIMS)]
    kw = dict(dim_proj=48, dim_upsample=(64, 24, 16), last_conv_channels=8)  # GroupNorms of 32, 24 and 16 groups
    jmod = jax_moge.MoGeConvFeature(output_dim=7, **kw)
    params, ref = jax_init_apply(jmod, feats, static=(out_hw,))
    port = port_moge.MoGeConvFeature(LEVEL_DIMS, 7, **kw)
    out = port_apply(port, params, [torch.from_numpy(f) for f in feats], out_hw)
    assert out.shape == (2, *out_hw, 7)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=HEAD_ATOL, rtol=0)


def test_moge_group_norm_keeps_flax_epsilon():
    port = port_moge.MoGeConvFeature((8,), 3, dim_proj=16, dim_upsample=(8,), last_conv_channels=4)
    assert port.res_0_0.norm.eps == 1e-6 and port.res_0_0.norm.num_groups == 8


# ---------------------------------------------------------------- the small models


def small_rgb_model(head, raw=False, geometric=False, seed=0):
    """The JAX tree of the small RGB model with ``head`` (seeded from its eval_shape),
    its jitted JAX forward on images, and the port model with the same weights."""
    kw = dict(dense_head_type=head, use_raw_encoder_features_for_dpt=raw)
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    views = jax_ma.Views(img=f32(B, V, HW, HW, 3))
    if geometric:
        views = jax_ma.Views(img=f32(B, V, HW, HW, 3), ray_directions=f32(B, V, HW, HW, 3),
                             depth_along_ray=f32(B, V, HW, HW, 1), camera_pose_quats=f32(B, V, 4),
                             camera_pose_trans=f32(B, V, 3),
                             is_metric_scale=jax.ShapeDtypeStruct((B, V), jnp.bool_))
    jcfg = rgb_config(jax_ma, **kw)
    model = jax_ma.MapAnything(jcfg)
    params = seeded_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), views)["params"], seed)
    port = port_ma.MapAnything(rgb_config(port_ma, **kw), device="cpu", geometric_inputs=geometric)
    load_jax_params(port, params)
    return model, params, port


@pytest.mark.parametrize("head,raw", [("mae", False), ("mae", True), ("moge", False), ("moge", True)])
def test_small_rgb_model_forward_matches_jax(head, raw, monkeypatch, record_property):
    model, params, port = small_rgb_model(head, raw)
    img = randn(0, B, V, HW, HW, 3)
    ref = jax.jit(lambda p, x: model.apply({"params": p}, jax_ma.Views(img=x)))(params, jnp.asarray(img))
    seen = set()
    attend = port_fa.flash_attention

    def spy(q, k, v, scale=None):
        seen.add(q.shape[-1])
        return attend(q, k, v, scale)

    monkeypatch.setattr("mapanything_tpu_torch.ops.attention.flash_attention", spy)
    with torch.inference_mode():
        out = port(port_ma.Views(img=torch.from_numpy(img)))
    errs = close_fields(out, ref)
    assert 0 <= out.rgb.min() and out.rgb.max() <= 1
    if head == "mae":
        assert 32 in seen  # the decoder's heads of 32 (sdpa's length cut sends T < 1024 elsewhere on the TPU)
    record_property("max_err_over_magnitude", errs)
    if not raw:  # the dense head over chunks of one view
        monkeypatch.setattr(port, "config", replace(port.config, head_chunk_size=1))
        with torch.inference_mode():
            chunked = port(port_ma.Views(img=torch.from_numpy(img)))
        close_fields(chunked, ref)


def test_raw_encoder_features_need_a_list_head():
    with pytest.raises(ValueError, match="list-consuming"):
        port_ma.MapAnything(rgb_config(port_ma, use_raw_encoder_features_for_dpt=True), device="cpu")


def test_mae_model_parameter_names_follow_the_jax_modules():
    _, params, port = small_rgb_model("mae")
    names = [n for n, _ in port.named_parameters() if n.startswith("mae_head.")]
    assert names[:2] == ["mae_head.embed_0.weight", "mae_head.embed_0.bias"]
    assert "mae_head.decoder_block_7.attn.qkv.weight" in names and "mae_head.decoder_pred.bias" in names
    assert not any(n.startswith("dpt_") for n, _ in port.named_parameters())
    assert sorted(params["mae_head"]) == sorted({n.split(".")[1] for n in names})


# ---------------------------------------------------------------- training


STEP_BATCH_SEED = 12


def rgb_step_inputs():
    rng = np.random.RandomState(11)
    img = rng.randn(B, V, HW, HW, 3).astype(np.float32)
    batch = loss_batch_np(B, V, HW, HW, STEP_BATCH_SEED, [True], [True], 0.8)
    batch["target_rgb"] = rng.uniform(0, 1, (B, V, HW, HW, 3)).astype(np.float32)
    return img, batch


@pytest.fixture(scope="module")
def mae_step():
    """The small MAE model's train step in JAX (loss, details, gradients; jitted once),
    the port model with the same weights, and the step's port inputs."""
    model, params, port = small_rgb_model("mae", geometric=True, seed=3)
    img, batch = rgb_step_inputs()
    jviews = jax_ma.Views(img=jnp.asarray(img), ray_directions=jnp.asarray(batch["ray_directions"]),
                          depth_along_ray=jnp.asarray(batch["depth_along_ray"]),
                          camera_pose_quats=jnp.asarray(batch["camera_pose_quats"]),
                          camera_pose_trans=jnp.asarray(batch["camera_pose_trans"]),
                          is_metric_scale=jnp.ones((B, V), bool))
    geo = jax_ma.GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, dropout_prob=0.3,
                                      sparse_depth_prob=0.0)
    masks = jax_ma.sample_modality_masks(jax.random.PRNGKey(2), B, V, (HW, HW), geo)

    def loss_fn(p):
        preds = model.apply({"params": p}, jviews, masks, deterministic=True)
        loss, details = jax_losses.factored_geometry_scale_loss(jax_batch(batch), preds, jax_losses.LossConfig())
        return loss * 2.0 / V, details

    (loss, details), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pmasks = port_ma.ModalityMasks(**{k: None if v is None else torch.from_numpy(np.array(v))
                                      for k, v in vars(masks).items()})
    return dict(port=port, loss=float(loss), details={k: float(v) for k, v in details.items()},
                want=jax_params_to_state_dict(port, grads), inputs=(port_batch(batch), torch.from_numpy(img), pmasks))


def port_step_gradients(step):
    """The port's loss, details and gradients (by name) of ``mae_step``'s inputs, from zero."""
    port = step["port"]
    port.zero_grad(set_to_none=True)
    got, got_details = port_step.make_loss_fn(port)(*step["inputs"])
    got.backward()
    return got, got_details, {name: p.grad for name, p in port.named_parameters()}


def check_gradients(grads, want) -> float:
    """Each leaf's gradient within 1e-4 of the JAX leaf's largest; the worst ratio."""
    worst = 0.0
    for name, g in grads.items():
        r = want[name].numpy()
        assert g is not None, name
        worst = max(worst, float(np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-12)))
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * np.abs(r).max() + 1e-12, rtol=0, err_msg=name)
    return worst


def test_small_mae_train_step_matches_jax(mae_step, record_property):
    got, got_details, grads = port_step_gradients(mae_step)
    details = mae_step["details"]
    assert "rgb_loss" in details
    np.testing.assert_allclose(got.item(), mae_step["loss"], rtol=1e-4)
    assert sorted(got_details) == sorted(details)
    for name, value in got_details.items():
        np.testing.assert_allclose(value.item(), details[name], rtol=1e-4, atol=1e-6, err_msg=name)
    want = mae_step["want"]
    worst = check_gradients(grads, want)
    assert float(np.abs(want["mae_head.decoder_block_0.attn.qkv.weight"].numpy()).max()) > 0
    record_property("grad_err_over_leaf_magnitude", worst)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_small_mae_train_step_gradients_do_not_depend_on_the_thread_count(mae_step, n_threads, record_property):
    """The same step on ``n_threads`` torch threads, held to the JAX gradients under
    the rule above. An fp32 product on the CPU used to split its sum by the thread
    count, and a ReLU input of the pose head near zero then took the other side on
    one thread; the port's layers now run their CPU products in float64."""
    threads_before = torch.get_num_threads()
    torch.set_num_threads(n_threads)
    try:
        _, _, grads = port_step_gradients(mae_step)
    finally:
        torch.set_num_threads(threads_before)
    record_property("grad_err_over_leaf_magnitude", check_gradients(grads, mae_step["want"]))


def test_rgb_l1_term_of_the_dpt_rgb_model_matches_jax(record_property):
    """The production loss of the small DPT-RGB model with a target image: the port
    has the RGB L1 term in its place (before the mask BCE), as the JAX loss does."""
    model, params, port = small_rgb_model("dpt")
    img, batch = rgb_step_inputs()
    preds = jax.jit(lambda p, x: model.apply({"params": p}, jax_ma.Views(img=x)))(params, jnp.asarray(img))
    ref, ref_details = jax.jit(jax_losses.factored_geometry_scale_loss)(jax_batch(batch), preds)
    with torch.inference_mode():
        out = port(port_ma.Views(img=torch.from_numpy(img)))
        total, details = port_losses.factored_geometry_scale_loss(port_batch(batch), out)
        without = port_losses.factored_geometry_scale_loss(
            port_batch({k: v for k, v in batch.items() if k != "target_rgb"}), out)[0]
    assert sorted(details) == sorted(ref_details) and "rgb_loss" in details
    np.testing.assert_allclose(details["rgb_loss"].item(), float(ref_details["rgb_loss"]), rtol=1e-4)
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose((total - without).item(), details["rgb_loss"].item(), rtol=1e-5)  # weight 1
    record_property("loss_rel_err", abs(total.item() - float(ref)) / abs(float(ref)))


def test_loss_batch_moves_with_and_without_target_rgb():
    _, batch = rgb_step_inputs()
    with_rgb = port_batch(batch).to("cpu")
    assert with_rgb.target_rgb is not None and with_rgb.target_rgb.shape == (B, V, HW, HW, 3)
    assert port_batch({k: v for k, v in batch.items() if k != "target_rgb"}).to("cpu").target_rgb is None


def test_mae_model_hub_round_trip(tmp_path):
    """save_pretrained -> from_pretrained of the small MAE model with the raw-encoder
    preset: the config and every weight come back bitwise."""
    from mapanything_tpu_torch.utils import hub as port_hub

    port = port_ma.MapAnything(rgb_config(port_ma, dense_head_type="mae", use_raw_encoder_features_for_dpt=True),
                               device="cpu", seed=4)
    back = port_hub.from_pretrained(port_hub.save_pretrained(port, tmp_path / "hub"), device="cpu")
    assert back.config == port.config
    for (name, p), (_, q) in zip(port.state_dict().items(), back.state_dict().items()):
        assert torch.equal(p, q), name
