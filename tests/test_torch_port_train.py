"""The port's training against the JAX package's, on the CPU.

The production loss and its gradients on seeded predictions and batches
(synthetic and metric samples mixed), the zero-pixel gradient of
``safe_norm``, the optimizer against optax over three updates, and the whole
small train step: the loss, its details and every gradient leaf against
``jax.value_and_grad`` of the same ``model.apply`` + loss with masks sampled
by the JAX package, then one update against optax. fp32 throughout; inputs
made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.models.heads import pose as jax_pose
from mapanything_tpu.train import losses as jax_losses
from mapanything_tpu.train import optim as jax_optim
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models.heads import pose as port_pose
from mapanything_tpu_torch.parallel.distributed import run_ranks
from mapanything_tpu_torch.tools import view_parallel_ranks
from mapanything_tpu_torch.train import losses as port_losses
from mapanything_tpu_torch.train import optim as port_optim
from mapanything_tpu_torch.train import step as port_step
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import jax_params_to_state_dict, load_jax_params


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)


PRED_FIELDS = (
    "pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans", "cam_quats",
    "metric_scaling_factor", "conf", "non_ambiguous_mask_logits",
)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def loss_batch_np(B, V, H, W, seed, is_metric, is_synthetic, valid_frac=1.0):
    """The LossBatch recipe of bench.py (_make_loss_batch), with masks and flags to choose."""
    rng = np.random.RandomState(seed)
    dirs = rng.randn(B, V, H, W, 3).astype(np.float32)
    dirs[..., 2] = np.abs(dirs[..., 2]) + 0.5
    valid = rng.uniform(size=(B, V, H, W)) < valid_frac
    return dict(
        pts3d=rng.randn(B, V, H, W, 3).astype(np.float32),
        pts3d_cam=rng.randn(B, V, H, W, 3).astype(np.float32),
        depth_along_ray=rng.uniform(1, 5, (B, V, H, W, 1)).astype(np.float32),
        ray_directions=unit(dirs),
        camera_pose_quats=unit(rng.randn(B, V, 4).astype(np.float32)),
        camera_pose_trans=rng.randn(B, V, 3).astype(np.float32),
        valid_mask=valid,
        non_ambiguous_mask=rng.uniform(size=(B, V, H, W)) < 0.7,
        valid_non_ambiguous_mask=valid & (rng.uniform(size=(B, V, H, W)) < 0.9),
        is_metric_scale=np.asarray(is_metric, bool),
        is_synthetic=np.asarray(is_synthetic, bool),
    )


def preds_np(B, V, H, W, seed):
    rng = np.random.RandomState(seed)
    return dict(
        pts3d=rng.randn(B, V, H, W, 3).astype(np.float32),
        pts3d_cam=rng.randn(B, V, H, W, 3).astype(np.float32),
        ray_directions=unit(rng.randn(B, V, H, W, 3).astype(np.float32)),
        depth_along_ray=rng.uniform(0.5, 4, (B, V, H, W, 1)).astype(np.float32),
        cam_trans=rng.randn(B, V, 3).astype(np.float32),
        cam_quats=unit(rng.randn(B, V, 4).astype(np.float32)),
        metric_scaling_factor=rng.uniform(0.5, 2, (B,)).astype(np.float32),
        conf=rng.uniform(1, 3, (B, V, H, W)).astype(np.float32),
        non_ambiguous_mask_logits=rng.randn(B, V, H, W).astype(np.float32),
    )


def jax_batch(arrays):
    return jax_losses.LossBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def port_batch(arrays):
    return port_losses.LossBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


# ---------------------------------------------------------------- the loss


@pytest.mark.parametrize("cfg_kw", [{}, {"criterion": "l2", "loss_in_log": False}])
def test_production_loss_and_its_gradients_match_jax(cfg_kw, record_property):
    B, V, H, W = 4, 2, 8, 10
    batch = loss_batch_np(B, V, H, W, 1, [True, True, False, False], [True, False, True, False], 0.8)
    preds = preds_np(B, V, H, W, 2)
    jcfg, pcfg = jax_losses.LossConfig(**cfg_kw), port_losses.LossConfig(**cfg_kw)

    def jax_loss(p):
        return jax_losses.factored_geometry_scale_loss(jax_batch(batch), jax_ma.Predictions(**p), jcfg)

    (ref, ref_details), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()}
    )
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    total, details = port_losses.factored_geometry_scale_loss(port_batch(batch), port_ma.Predictions(**tp), pcfg)
    assert sorted(details) == sorted(ref_details)
    for name, value in details.items():
        np.testing.assert_allclose(value.item(), float(ref_details[name]), rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    grads = torch.autograd.grad(total, [tp[k] for k in PRED_FIELDS])
    worst = 0.0
    for name, g in zip(PRED_FIELDS, grads):
        r = np.asarray(ref_grads[name])
        worst = max(worst, float(np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1e-6)))
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * max(np.abs(r).max(), 1e-6), rtol=0, err_msg=name)
    record_property("loss_rel_err", abs(total.item() - float(ref)) / abs(float(ref)))
    record_property("grad_err_over_magnitude", worst)


def test_exclude_top_n_percent_mean_and_helpers_match_jax():
    rng = np.random.RandomState(3)
    loss, valid = rng.rand(5, 40).astype(np.float32), rng.rand(5, 40) < 0.7
    valid[4] = False
    for got, ref in zip(port_losses.exclude_top_n_percent_mean(torch.from_numpy(loss), torch.from_numpy(valid), 80.0),
                        jax_losses.exclude_top_n_percent_mean(jnp.asarray(loss), jnp.asarray(valid), 80.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    x = rng.randn(6, 7).astype(np.float32) * 5
    t = (rng.rand(6, 7) < 0.5).astype(np.float32)
    np.testing.assert_allclose(port_losses.bce_with_logits(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
                               np.asarray(jax_losses.bce_with_logits(jnp.asarray(x), jnp.asarray(t))), rtol=1e-6)
    np.testing.assert_allclose(
        port_losses.masked_mean(torch.from_numpy(x), torch.from_numpy(t > 0), dim=1).numpy(),
        np.asarray(jax_losses.masked_mean(jnp.asarray(x), jnp.asarray(t > 0), axis=1)), rtol=1e-6)


def test_zero_depth_pixel_gives_finite_gradients():
    # A depth that underflows to exactly 0 makes a zero pointmap pixel; safe_norm
    # keeps the joint normalisation's gradient finite (tests/test_losses.py).
    B, V, H, W = 1, 2, 6, 6
    batch = port_batch(loss_batch_np(B, V, H, W, 4, [True], [True]))
    p = {k: torch.from_numpy(v) for k, v in preds_np(B, V, H, W, 5).items()}
    depth = p["depth_along_ray"].clone()
    depth[0, 0, 1, 1, 0] = 0.0
    depth.requires_grad_()
    pts_cam = p["ray_directions"] * depth
    preds = port_ma.Predictions(**{**p, "depth_along_ray": depth, "pts3d_cam": pts_cam, "pts3d": pts_cam + 0.1})
    total, _ = port_losses.factored_geometry_scale_loss(batch, preds)
    (g,) = torch.autograd.grad(total, depth)
    assert torch.isfinite(total) and bool(torch.isfinite(g).all())


# ---------------------------------------------------------------- the optimizer


@pytest.mark.parametrize("mu_dtype,nu_dtype", [(None, None), ("bfloat16", None), ("bfloat16", "bfloat16")])
def test_optimizer_matches_optax_over_three_updates(mu_dtype, nu_dtype, record_property):
    tokens = np.random.RandomState(6).randn(1, 1, 32).astype(np.float32)
    params = jax.tree.map(np.asarray, jax_pose.MLPHead(output_dim=2).init(jax.random.PRNGKey(1), tokens)["params"])
    kw = dict(lr=1e-2, min_lr=1e-3, weight_decay=0.05, grad_clip_norm=1.0, epoch_len=2, total_epochs=2.0,
              warmup_epochs=0.5, mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    subs = {"mlp_0": 0.5, "output_proj": 0.0}
    jcfg = jax_optim.OptimConfig(**kw, submodules={k: jax_optim.SubmoduleOptimConfig(s) for k, s in subs.items()})
    pcfg = port_optim.OptimConfig(**kw, submodules={k: port_optim.SubmoduleOptimConfig(s) for k, s in subs.items()})
    jopt = jax_optim.build_optimizer(jcfg, params)
    jstate = jopt.init(params)
    model = load_jax_params(port_pose.MLPHead(32, output_dim=2), params)
    popt = port_optim.build_optimizer(pcfg, model)
    tparams = dict(model.named_parameters())
    pstate = popt.init(tparams)
    # the JAX rule on the JAX leaves: kernels decay, biases do not
    mask = popt.decay_mask
    assert mask["proj.weight"] and mask["mlp.0.0.weight"] and not mask["proj.bias"]
    # fp32 moments agree to rounding. A bf16 moment can round to the neighbouring
    # bf16 value where the two sides' fp32 sums differ in the last bit (1 element
    # of 6272 here), which moves that update by up to ~0.3% of lr.
    atol = 3e-3 * kw["lr"] if mu_dtype else 2e-7
    rng = np.random.RandomState(7)
    jparams = params
    worst = 0.0
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
        assert float(optax.global_norm(grads)) > jcfg.grad_clip_norm  # the clip is active
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = jax_params_to_state_dict(model, grads)
        pupdates, pstate = popt.update(tgrads, pstate, tparams)
        port_optim.apply_updates(tparams, pupdates)
        want = jax_params_to_state_dict(model, jparams)
        for name, p in tparams.items():
            worst = max(worst, float(np.abs(p.detach().numpy() - want[name].numpy()).max()))
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol, rtol=0, err_msg=name)
    record_property("param_max_abs_err", worst)
    assert torch.equal(tparams["output_proj.weight"], torch.from_numpy(params["output_proj"]["kernel"].T.copy()))
    if mu_dtype:
        assert pstate.mu["proj.weight"].dtype == torch.bfloat16
    assert pstate.nu["proj.weight"].dtype == (torch.bfloat16 if nu_dtype else torch.float32)


def test_schedule_matches_jax():
    cfg = dict(lr=1e-3, min_lr=1e-5, warmup_epochs=1.0, total_epochs=3.0, epoch_len=10)
    js = jax_optim.warmup_cosine_schedule(jax_optim.OptimConfig(**cfg))
    ps = port_optim.warmup_cosine_schedule(port_optim.OptimConfig(**cfg))
    for step in (0, 3, 10, 17, 29, 30):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6)


# ---------------------------------------------------------------- the train step


B, V, HW = 1, 2, 56
# A few layers and narrow widths: the "test" ViT (4 blocks of 64) and a two-layer trunk.
STEP_CFG = dict(encoder_size="test", info_sharing_depth=2, info_sharing_dim=64, info_sharing_indices=(0, 1))


def jax_small_step(step_cfg):
    """The JAX loss and gradients of ``MapAnythingConfig.small(**step_cfg)`` with
    JAX-sampled masks, one optax update, and the port model with the same weights."""
    rng = np.random.RandomState(11)
    img = rng.randn(B, V, HW, HW, 3).astype(np.float32)
    batch = loss_batch_np(B, V, HW, HW, 12, [True], [False], 0.9)
    model = jax_ma.MapAnything(jax_ma.MapAnythingConfig.small(**step_cfg))
    jviews = jax_ma.Views(
        img=jnp.asarray(img),
        ray_directions=jnp.asarray(batch["ray_directions"]),
        depth_along_ray=jnp.asarray(batch["depth_along_ray"]),
        camera_pose_quats=jnp.asarray(batch["camera_pose_quats"]),
        camera_pose_trans=jnp.asarray(batch["camera_pose_trans"]),
        is_metric_scale=jnp.ones((B, V), bool),
    )
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jviews)["params"]
    geo = jax_ma.GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, dropout_prob=0.3,
                                      sparse_depth_prob=1.0, sparsification_removal_percent=0.5)
    masks = jax_ma.sample_modality_masks(jax.random.PRNGKey(2), B, V, (HW, HW), geo)

    def loss_fn(p):
        preds = model.apply({"params": p}, jviews, masks, deterministic=True)
        loss, details = jax_losses.factored_geometry_scale_loss(jax_batch(batch), preds, jax_losses.LossConfig())
        return loss * 2.0 / V, details

    (loss, details), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    opt_cfg = dict(lr=1e-4, min_lr=1e-6)
    jopt = jax_optim.build_optimizer(jax_optim.OptimConfig(**opt_cfg), params)
    updates, _ = jax.jit(jopt.update)(grads, jax.jit(jopt.init)(params), params)
    new_params = jax.jit(optax.apply_updates)(params, updates)
    port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**step_cfg), device="cpu", geometric_inputs=True)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    np_masks = {k: None if v is None else np.array(v) for k, v in vars(masks).items()}
    threads.trim_heap()  # the compiles' transient heap, before the next step's (4.2 GB otherwise)
    return dict(img=img, batch=batch, masks=np_masks, loss=loss, details=details, grads=grads,
                new_params=new_params, opt_cfg=opt_cfg, port=port, params=jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def small_step():
    return jax_small_step(STEP_CFG)


def assert_step_matches(s, record_property):
    """The port's loss, details, gradients and one update against ``jax_small_step``'s."""
    port = s["port"]
    masks = port_ma.ModalityMasks(**{k: None if v is None else torch.from_numpy(v) for k, v in s["masks"].items()})
    assert bool(masks.ray_dirs.any()) and not bool(masks.depth_sparsification_keep.all())
    loss_fn = port_step.make_loss_fn(port)
    loss, details = loss_fn(port_batch(s["batch"]), torch.from_numpy(s["img"]), masks)
    np.testing.assert_allclose(loss.item(), float(s["loss"]), rtol=1e-4)
    assert sorted(details) == sorted(s["details"])
    for name, value in details.items():
        ref = float(s["details"][name])
        np.testing.assert_allclose(value.item(), ref, rtol=1e-4, atol=1e-6, err_msg=name)
    loss.backward()
    want = jax_params_to_state_dict(port, s["grads"])
    params = dict(port.named_parameters())
    assert sorted(want) == sorted(params)
    worst = 0.0
    for name, p in params.items():
        r = want[name].numpy()
        worst = max(worst, float(np.abs(p.grad.numpy() - r).max() / (np.abs(r).max() + 1e-12)))
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-4 * np.abs(r).max() + 1e-12, rtol=0, err_msg=name)
    record_property("loss_rel_err", abs(loss.item() - float(s["loss"])) / abs(float(s["loss"])))
    record_property("grad_err_over_leaf_magnitude", worst)

    # One update against optax. Adam's first step is lr·g/(|g| + eps) per
    # element, so it agrees wherever the gradients agree in sign; gradients
    # below 1e-3 of their leaf's largest are left out of the comparison. The
    # new parameters are rounded to fp32 on both sides: one ulp of each is allowed.
    lr = s["opt_cfg"]["lr"]
    opt = port_optim.build_optimizer(port_optim.OptimConfig(**s["opt_cfg"]), port)
    before = {n: p.detach().clone() for n, p in params.items()}
    updates, _ = opt.update({n: p.grad for n, p in params.items()}, opt.init(params), params)
    port_optim.apply_updates(params, updates)
    want_new = jax_params_to_state_dict(port, s["new_params"])
    for name, p in params.items():
        got, ref = (p.detach() - before[name]).numpy(), (want_new[name] - before[name]).numpy()
        g = want[name].numpy()
        ulp = np.spacing(np.abs(before[name].numpy()))
        ok = (np.abs(got - ref) <= 1e-3 * lr + ulp) | (np.abs(g) < 1e-3 * np.abs(g).max())
        assert ok.all(), name


def test_small_train_step_matches_jax(small_step, record_property):
    assert_step_matches(small_step, record_property)


# The same step with a trunk of 2 heads of 128: the D = 128 instances' plain
# versions under autograd (tests/test_torch_port_headdim128.py holds them to K8).
STEP_CFG_H128 = dict(STEP_CFG, info_sharing_dim=256, info_sharing_num_heads=2)


def test_small_h128_train_step_matches_jax(monkeypatch, record_property):
    from test_torch_port_headdim128 import head_dims_seen, trunk_head_dims

    s = jax_small_step(STEP_CFG_H128)
    assert trunk_head_dims(s["port"]) == {128}
    seen = head_dims_seen(monkeypatch)
    assert_step_matches(s, record_property)
    assert 128 in seen


def test_view_parallel_train_step_matches_jax(small_step, tmp_path, record_property):
    """The port's train step over 2 gloo ranks, one view each, under the ring
    schedule, against the JAX unsharded step: the loss, its details, every
    gradient and the parameters after the update. The ranks agree exactly."""
    s = small_step
    results = run_ranks(view_parallel_ranks.cp_train_step, 2, "cpu", tmp_path / "rendezvous",
                        STEP_CFG, s["params"], s["img"], s["batch"], s["masks"], s["opt_cfg"])
    got = results[0]
    for name in got["params"]:
        assert np.array_equal(got["params"][name], results[1]["params"][name]), name
    # one global layer: n = 2 ring steps each way
    assert got["counts"]["ring_steps"] == 2 and got["counts"]["ring_bwd_steps"] == 2
    np.testing.assert_allclose(got["metrics"]["loss"], float(s["loss"]), rtol=1e-4)
    for name, ref in s["details"].items():
        np.testing.assert_allclose(got["metrics"][name], float(ref), rtol=1e-4, atol=1e-6, err_msg=name)
    port = s["port"]
    want = jax_params_to_state_dict(port, s["grads"])
    assert sorted(want) == sorted(got["grads"])
    worst = 0.0
    for name, r in want.items():
        r = r.numpy()
        worst = max(worst, float(np.abs(got["grads"][name] - r).max() / (np.abs(r).max() + 1e-12)))
        np.testing.assert_allclose(got["grads"][name], r, atol=1e-4 * np.abs(r).max() + 1e-12, rtol=0, err_msg=name)
    record_property("grad_err_over_leaf_magnitude", worst)
    # The update, as in test_small_train_step_matches_jax.
    before = jax_params_to_state_dict(port, s["params"])
    want_new = jax_params_to_state_dict(port, s["new_params"])
    lr = s["opt_cfg"]["lr"]
    for name, p in got["params"].items():
        b = before[name].numpy()
        g = want[name].numpy()
        ok = (np.abs((p - b) - (want_new[name].numpy() - b)) <= 1e-3 * lr + np.spacing(np.abs(b))) \
            | (np.abs(g) < 1e-3 * np.abs(g).max())
        assert ok.all(), name


def test_train_step_runs_and_is_reproducible():
    cfg = port_ma.MapAnythingConfig.small(**STEP_CFG, use_pe_for_non_reference_views=True)
    batch = port_batch(loss_batch_np(1, 2, 28, 28, 13, [True], [True]))
    img = torch.from_numpy(np.random.RandomState(14).randn(1, 2, 28, 28, 3).astype(np.float32))
    runs = []
    for n_steps in (2, 1):  # the second run repeats the first step
        model = port_ma.MapAnything(cfg, device="cpu", seed=1, geometric_inputs=True)
        opt = port_optim.build_optimizer(port_optim.OptimConfig(lr=1e-4), model)
        state = port_step.init_train_state(model, opt)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        step = port_step.make_train_step(model, opt)
        gen = torch.Generator().manual_seed(5)
        metrics = []
        for _ in range(n_steps):
            state, m = step(state, img, batch, gen)
            grads = [p.grad for p in state.params.values() if p.grad is not None]
            assert m["grad_norm"].item() == pytest.approx(port_optim.global_norm(grads).item(), rel=1e-6)
            metrics.append({k: v.item() for k, v in m.items()})
        runs.append(metrics)
        assert state.step == n_steps and state.opt_state.count == n_steps
        assert any(not torch.equal(before[n], p) for n, p in state.params.items())
    assert runs[0][0] == runs[1][0]
    for m in runs[0]:
        assert {"loss", "grad_norm", "total_loss", "scale_loss", "mask_loss"} <= set(m)
        assert all(np.isfinite(v) for v in m.values())
        assert m["loss"] == pytest.approx(m["total_loss"] * 2.0 / 2, rel=1e-6)
    evaluated = port_step.make_eval_step(model)(img, batch)
    assert np.isfinite(evaluated["loss"].item())
