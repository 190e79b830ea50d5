"""The port's last modules against the JAX package's, on the CPU.

The disentangled loss split over 2 gloo ranks of the view axis and over a 2 x 2 data x view
mesh (``view_parallel_ranks.loss_parts``: each rank's part, the parts summed) against the JAX
unsharded loss, its terms within 1e-5 and its gradients with respect to the predictions
within 1e-4 of each field's largest; ``DenseRepresentationEncoder(apply_pe=True)`` at 518 x 518
(no resize of the positional table) and at 280 x 378 (``jax.image.resize``'s bicubic with
antialiasing, shrinking both axes) within 1e-5; ``DPTSegmentationProcessor`` at the JAX test's
shapes and a non-square one within 1e-5; ``angle_diff_vec3`` within 1e-6. (The slice's
``tools/diagnose_lr_nan.py`` is held to JAX in tests/test_torch_port_diagnose.py: its JAX step
takes ~30 s to compile, which would take this file past a minute.) fp32 throughout; inputs
from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.geometry import normals as jax_normals
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models.encoders import dense_rep as jax_dense_rep
from mapanything_tpu.models.heads import dpt as jax_dpt
from mapanything_tpu.train import losses as jax_losses
from mapanything_tpu_torch import geometry as port_geometry
from mapanything_tpu_torch.models.encoders import dense_rep as port_dense_rep
from mapanything_tpu_torch.models.heads import dpt as port_dpt
from mapanything_tpu_torch.parallel.distributed import run_ranks
from mapanything_tpu_torch.tools import view_parallel_ranks
from mapanything_tpu_torch.utils import threads
from test_torch_port_model import jax_init_apply, port_apply
from test_torch_port_train import PRED_FIELDS, jax_batch, loss_batch_np, preds_np

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # of each gradient's largest magnitude
MODULE_ATOL = 1e-5


# ---------------------------------------------------------------- the disentangled loss over ranks


@pytest.fixture(scope="module")
def disentangled_case():
    """A batch of 4 samples of 4 views (metric and synthetic flags mixed, 70% valid pixels),
    its predictions, and JAX's unsharded disentangled loss, details and gradients."""
    B, V, H, W = 4, 4, 6, 8
    batch = loss_batch_np(B, V, H, W, 41, [True, False, True, True], [True, False, False, True], 0.7)
    preds = preds_np(B, V, H, W, 42)

    def jax_loss(p):
        return jax_losses.factored_geometry_scale_loss(jax_batch(batch), jax_ma.Predictions(**p),
                                                       jax_losses.LossConfig(disentangled=True))

    (loss, details), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    return dict(batch=batch, preds=preds, loss=float(loss), details={k: float(v) for k, v in details.items()},
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("world_size,data_axis", [(2, False), (4, True)], ids=["2_view_ranks", "2x2_mesh"])
def test_disentangled_loss_over_a_view_group_and_a_data_group_matches_jax(disentangled_case, world_size,
                                                                          data_axis, tmp_path, record_property):
    c = disentangled_case
    parts = run_ranks(view_parallel_ranks.loss_parts, world_size, "cpu", tmp_path / "rendezvous", 2, data_axis,
                      {"disentangled": True}, c["batch"], c["preds"])
    np.testing.assert_allclose(sum(p["loss"] for p in parts), c["loss"], rtol=LOSS_RTOL)
    assert sorted(parts[0]["details"]) == sorted(c["details"])
    for name, ref in c["details"].items():
        np.testing.assert_allclose(sum(p["details"][name] for p in parts), ref, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=name)
    worst = 0.0
    for name in PRED_FIELDS + ("non_ambiguous_mask_logits",):
        got = np.zeros_like(c["grads"][name])
        for p in parts:  # a (B, V, ...) field is this rank's block; the (B,) scale is summed over view ranks
            samples, views = slice(*p["samples"]), slice(*p["views"])
            if got.ndim == 1:
                got[samples] += p["grads"][name]
            else:
                got[samples, views] += p["grads"][name]
        ref = c["grads"][name]
        scale = max(float(np.abs(ref).max()), 1e-6)
        worst = max(worst, float(np.abs(got - ref).max()) / scale)
        np.testing.assert_allclose(got, ref, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)
    record_property("grad_err_over_magnitude", worst)


# ---------------------------------------------------------------- the model parts


@pytest.mark.parametrize("hw", [(518, 518), (280, 378)], ids=["518_no_resize", "280x378_shrinking_resize"])
def test_dense_rep_encoder_with_its_positional_encoding_matches_jax(hw):
    x = np.random.RandomState(hw[1]).randn(1, *hw, 3).astype(np.float32)
    kw = dict(in_chans=3, enc_embed_dim=32, patch_size=14, intermediate_dims=(24, 32, 40))
    params, ref = jax_init_apply(jax_dense_rep.DenseRepresentationEncoder(apply_pe=True, **kw), x, seed=3)
    assert "post_pe_norm" in params
    out = port_apply(port_dense_rep.DenseRepresentationEncoder(apply_pe=True, **kw), params, x)
    assert out.shape == (1, hw[0] // 14, hw[1] // 14, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=MODULE_ATOL, rtol=0)


def test_positional_table_resize_is_jax_image_resize():
    table = port_dense_rep.sinusoid_encoding_table(37 * 37, 16, 70007.0).reshape(1, 37, 37, 16)
    for out_hw in ((20, 27), (37, 20), (40, 52)):  # shrinking, one axis alone, growing
        ref = np.asarray(jax.image.resize(jnp.asarray(table), (1, *out_hw, 16), method="bicubic"))
        got = port_dense_rep.positional_encoding(37, out_hw, 16, 70007.0)
        # JAX forms the weights and their products in fp32 (2.2e-6 read), the port in float64
        np.testing.assert_allclose(got, ref[0], atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("shape,out_hw,hidden", [((1, 16, 16, 32), (64, 64), None), ((2, 12, 20, 24), (50, 70), 16)])
def test_dpt_segmentation_processor_matches_jax(shape, out_hw, hidden):
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    module = jax_dpt.DPTSegmentationProcessor(output_dim=5, hidden_dim=hidden)
    params, ref = jax_init_apply(module, x, static=(out_hw,), seed=5)
    port = port_dpt.DPTSegmentationProcessor(shape[-1], 5, hidden)
    assert port.conv1.bias is None
    out = port_apply(port, params, x, out_hw)
    assert out.shape == (shape[0], *out_hw, 5)
    np.testing.assert_allclose(out.numpy(), ref, atol=MODULE_ATOL, rtol=0)


def test_angle_diff_vec3_matches_jax():
    rng = np.random.RandomState(3)
    v1, v2 = rng.randn(2, 5, 7, 3).astype(np.float32)
    v2[0, 0] = v1[0, 0]  # parallel
    v2[0, 1] = -v1[0, 1]  # antiparallel
    ref = np.asarray(jax_normals.angle_diff_vec3(jnp.asarray(v1), jnp.asarray(v2)))
    got = port_geometry.angle_diff_vec3(torch.from_numpy(v1), torch.from_numpy(v2)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
