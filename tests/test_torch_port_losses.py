"""The port's other losses against the JAX package's, on the CPU.

The disentangled ablation of the production loss (reached through
``factored_geometry_scale_loss`` with ``LossConfig(disentangled=True)``, as the
JAX package dispatches it), the DUSt3R Regr3D confidence loss, the L1 and L2
distances, and the RGB models' VGG19 perceptual loss: each loss, its details
and its gradients with respect to the predictions, on seeded predictions and
batches (samples mixed in metric scale and synthetic flag, masks partly
invalid). The VGG19 tower runs on seeded weights at 32 px, the smallest size
its four pools leave a tap of (ImageNet weights are not in the repository), its
five taps held to the JAX tower's; its parameter names go through the JAX
package's torchvision converter (``convert_vgg19_features``) back to the JAX
tree. fp32 throughout. Tolerances: losses within 1e-5 relative, gradients within
1e-4 of each field's largest, taps within 1e-4 of each tap's magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models import perceptual as jax_perceptual
from mapanything_tpu.train import losses as jax_losses
from mapanything_tpu.utils import torch_convert
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models import perceptual as port_perceptual
from mapanything_tpu_torch.parallel.distributed import run_ranks
from mapanything_tpu_torch.tools import view_parallel_ranks
from mapanything_tpu_torch.train import losses as port_losses
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import load_jax_params
from test_torch_port_model import jax_init_apply
from test_torch_port_train import PRED_FIELDS, jax_batch, loss_batch_np, port_batch, preds_np, unit

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # of each gradient's largest magnitude
TAP_RTOL = 1e-4  # of each tap's magnitude


def assert_grads(grads, ref_grads, names):
    worst = 0.0
    for name, g in zip(names, grads):
        r = np.asarray(ref_grads[name])
        scale = max(float(np.abs(r).max()), 1e-6)
        worst = max(worst, float(np.abs(g.numpy() - r).max()) / scale)
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)
    return worst


@pytest.mark.parametrize("cfg_kw", [{}, {"criterion": "l1", "loss_in_log": False}, {"criterion": "l2"}])
def test_disentangled_loss_and_its_gradients_match_jax(cfg_kw, record_property):
    B, V, H, W = 4, 2, 8, 10
    batch = loss_batch_np(B, V, H, W, 21, [True, False, True, False], [True, True, False, False], 0.7)
    preds = preds_np(B, V, H, W, 22)
    jcfg = jax_losses.LossConfig(disentangled=True, **cfg_kw)
    pcfg = port_losses.LossConfig(disentangled=True, **cfg_kw)

    def jax_loss(p):
        return jax_losses.factored_geometry_scale_loss(jax_batch(batch), jax_ma.Predictions(**p), jcfg)

    (ref, ref_details), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    total, details = port_losses.factored_geometry_scale_loss(port_batch(batch), port_ma.Predictions(**tp), pcfg)
    assert sorted(details) == sorted(ref_details)
    for name, value in details.items():
        np.testing.assert_allclose(value.item(), float(ref_details[name]), rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(total.item(), float(ref), rtol=LOSS_RTOL)
    # pts3d_cam and conf take no part in the disentangled terms, pts3d only without a
    # gradient (the scale term's): their gradients are zero on both sides
    grads = torch.autograd.grad(total, [tp[k] for k in PRED_FIELDS], allow_unused=True)
    grads = [torch.zeros_like(tp[k]) if g is None else g for k, g in zip(PRED_FIELDS, grads)]
    assert all(not np.asarray(ref_grads[k]).any() for k in ("pts3d", "pts3d_cam", "conf"))
    record_property("grad_err_over_magnitude", assert_grads(grads, ref_grads, PRED_FIELDS))


def test_disentangled_loss_refuses_a_view_group(tmp_path):
    """Under a view group the disentangled loss is no longer refused: on a group of one gloo
    rank it is the unsharded loss, term by term (tests/test_torch_port_last_modules.py holds it
    to JAX on 2 and 2 x 2 ranks)."""
    B, V, H, W = 1, 2, 4, 4
    batch, preds = loss_batch_np(B, V, H, W, 1, [True], [True]), preds_np(B, V, H, W, 2)
    (got,) = run_ranks(view_parallel_ranks.loss_parts, 1, "cpu", tmp_path / "rendezvous", 1, False,
                       {"disentangled": True}, batch, preds)
    _, want = port_losses.factored_geometry_scale_loss(
        port_batch(batch), port_ma.Predictions(**{k: torch.from_numpy(v) for k, v in preds.items()}),
        port_losses.LossConfig(disentangled=True))
    assert sorted(got["details"]) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got["details"][name], value.item(), rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("loss_in_log", [False, True])
def test_dust3r_regr3d_conf_loss_and_its_gradients_match_jax(loss_in_log, record_property):
    B, V, H, W = 3, 2, 6, 7
    rng = np.random.RandomState(31)
    gt = rng.randn(B, V, H, W, 3).astype(np.float32)
    valid = rng.uniform(size=(B, V, H, W)) < 0.75
    q0, t0 = unit(rng.randn(B, 4).astype(np.float32)), rng.randn(B, 3).astype(np.float32)
    pred = rng.randn(B, V, H, W, 3).astype(np.float32)
    conf = rng.uniform(1, 3, (B, V, H, W)).astype(np.float32)
    kw = dict(conf_alpha=0.2, norm_mode="avg_dis", loss_in_log=loss_in_log)

    def jax_loss(p, c):
        pose0 = (jnp.asarray(q0), jnp.asarray(t0))
        return jax_losses.dust3r_regr3d_conf_loss(jnp.asarray(gt), jnp.asarray(valid), pose0, p, c, **kw)

    (ref, ref_details), ref_grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(pred), jnp.asarray(conf))
    tp, tc = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(conf).requires_grad_()
    t = torch.from_numpy
    total, details = port_losses.dust3r_regr3d_conf_loss(t(gt), t(valid), (t(q0), t(t0)), tp, tc, **kw)
    assert sorted(details) == sorted(ref_details)
    for name, value in details.items():
        np.testing.assert_allclose(value.item(), float(ref_details[name]), rtol=LOSS_RTOL, err_msg=name)
    grads = torch.autograd.grad(total, (tp, tc))
    record_property("grad_err_over_magnitude",
                    assert_grads(grads, dict(zip(("pred", "conf"), ref_grads)), ("pred", "conf")))


def test_l1_and_l2_distances_match_jax():
    rng = np.random.RandomState(32)
    a, b = rng.randn(5, 6, 3).astype(np.float32), rng.randn(5, 6, 3).astype(np.float32)
    b[0, 0] = a[0, 0]  # a zero difference: l2's safe norm
    for port_fn, jax_fn in ((port_losses.l1_distance, jax_losses.l1_distance),
                            (port_losses.l2_distance, jax_losses.l2_distance)):
        np.testing.assert_allclose(port_fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


# ---------------------------------------------------------------- the perceptual loss


B, V, HW = 2, 2, 32


@pytest.fixture(scope="module")
def vgg():
    """The JAX VGG19 tower's seeded tree and taps on one batch, and the port tower with
    the same weights."""
    images = np.random.RandomState(33).uniform(0, 1, (B * V, HW, HW, 3)).astype(np.float32)
    params, taps = jax_init_apply(jax_perceptual.VGG19Features(compute_dtype="float32"), images, perturb=0.01)
    port = load_jax_params(port_perceptual.VGG19Features(device="cpu"), params)
    return params, images, taps, port


def test_vgg19_taps_match_jax(vgg, record_property):
    params, images, taps, port = vgg
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert len(got) == len(taps) == 6
    errs = []
    for i, (g, r) in enumerate(zip(got, taps)):
        assert g.shape == r.shape, i
        scale = max(1.0, float(np.abs(r).max()))
        errs.append(float(np.abs(g.numpy() - r).max()) / scale)
        np.testing.assert_allclose(g.numpy(), r, atol=TAP_RTOL * scale, rtol=0, err_msg=f"tap {i}")
    assert not any(p.requires_grad for p in port.parameters())  # frozen
    record_property("max_err_over_magnitude", errs)


def test_vgg19_names_are_torchvisions(vgg):
    """The port tower's state dict is a torchvision vgg19 ``features`` dict: the JAX
    package's converter reads it back into the JAX tree, leaf for leaf."""
    params, _, _, port = vgg
    tree = torch_convert.convert_vgg19_features({k: v.numpy() for k, v in port.state_dict().items()})
    flat_ref = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert sorted(flat_got) == sorted(flat_ref)
    for key, ref in flat_ref.items():
        np.testing.assert_array_equal(flat_got[key], ref, err_msg=key)
    assert port_perceptual.VGG19_CONV_INDICES == jax_perceptual.VGG19_CONV_INDICES


@pytest.mark.parametrize("with_valid", [False, True])
def test_rgb_perception_loss_and_its_gradient_match_jax(vgg, with_valid, record_property):
    params, _, _, port = vgg
    rng = np.random.RandomState(34)
    pred = rng.uniform(0, 1, (B, V, HW, HW, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (B, V, HW, HW, 3)).astype(np.float32)
    valid = rng.uniform(size=(B, V, HW, HW)) < 0.6 if with_valid else None

    def jax_loss(p):
        return jax_losses.rgb_perception_loss({"params": params}, p, jnp.asarray(gt),
                                              None if valid is None else jnp.asarray(valid))

    (ref, ref_details), ref_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    total, details = port_losses.rgb_perception_loss(port, tp, torch.from_numpy(gt),
                                                     None if valid is None else torch.from_numpy(valid))
    assert sorted(details) == sorted(ref_details)
    np.testing.assert_allclose(total.item(), float(ref), rtol=LOSS_RTOL)
    (grad,) = torch.autograd.grad(total, tp)
    record_property("grad_err_over_magnitude", assert_grads([grad], {"pred_rgb": ref_grad}, ["pred_rgb"]))
