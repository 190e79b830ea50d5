"""From batches to checkpoints: the port's training runtime against the JAX package's, on the CPU.

The rigid transforms, the frustum masks and the batch refinement against their
JAX counterparts on seeded inputs; the accumulating train step against the
JAX one (two micro-batches, the JAX-sampled masks passed in); and the
``Trainer`` against the JAX ``Trainer`` on the same numpy batches (the JAX
``MultiViewDataLoader`` over tiny_setup's synthetic scenes, cut to three
samples for an odd batch count): two epochs with ``accum_iter=2`` and a
trailing partial group, run as one epoch, then a second Trainer that resumes
after it; two epochs with the default ``accum_iter=1`` under a decaying
learning rate; eval and checkpoint-best; the forensic dump; the checkpoint
retention against orbax's. The random draws of the Trainer are made inert
(no geometric input, no sparse depth, no random view-PE indices), since the
two packages draw from different generators. Each JAX step is jitted once.
"""

import hashlib
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.data.loader import MultiViewDataLoader
from mapanything_tpu.geometry import frustum as jax_frustum
from mapanything_tpu.geometry import transforms as jax_tf
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.train import checkpointing as jax_ckpt
from mapanything_tpu.train import loop as jax_loop
from mapanything_tpu.train import losses as jax_losses
from mapanything_tpu.train import masks as jax_masks
from mapanything_tpu.train import step as jax_step
from mapanything_tpu_torch.geometry import frustum as port_frustum
from mapanything_tpu_torch.geometry import transforms as port_tf
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.train import checkpointing as port_ckpt
from mapanything_tpu_torch.train import loop as port_loop
from mapanything_tpu_torch.train import losses as port_losses
from mapanything_tpu_torch.train import masks as port_masks
from mapanything_tpu_torch.train import optim as port_optim
from mapanything_tpu_torch.train import step as port_step
from mapanything_tpu_torch.utils import logging as port_logging
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import jax_params_to_state_dict, load_jax_params
from test_data_layer import make_ds
from test_torch_port_infer import seeded_params


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

# A few layers and narrow widths: the "test" ViT (4 blocks of 64) and a two-layer trunk.
STEP_CFG = dict(encoder_size="test", info_sharing_depth=2, info_sharing_dim=64, info_sharing_indices=(0, 1),
                use_rand_idx_pe_for_non_reference_views=False)
HW = 56


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def rigid(seed, *lead):
    """Seeded rigid 4x4 poses."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(*lead, 3, 3))
    pose = np.tile(np.eye(4), lead + (1, 1))
    pose[..., :3, :3] = q
    pose[..., :3, 3] = rng.randn(*lead, 3)
    return pose.astype(np.float32)


def close(got, ref, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0)


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("trf_shape,pts_shape,norm", [
    ((2, 3, 3), (2, 5, 3), False), ((2, 3, 4), (2, 5, 3), False), ((2, 4, 4), (2, 6, 7, 3), False),
    ((2, 4, 4), (2, 6, 7, 3), True), ((4, 4), (5, 3), True), ((3, 2, 4, 4), (3, 2, 9, 3), False),
])
def test_geotrf_matches_jax(trf_shape, pts_shape, norm):
    trf, pts = randn(1, *trf_shape), randn(2, *pts_shape)
    close(port_tf.geotrf(torch.from_numpy(trf), torch.from_numpy(pts), norm),
          jax_tf.geotrf(jnp.asarray(trf), jnp.asarray(pts), norm), 1e-5)


def test_pose_transforms_match_jax():
    a, b = rigid(3, 2, 5), rigid(4, 2, 5)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    close(port_tf.closed_form_pose_inverse(ta), jax_tf.closed_form_pose_inverse(ja), 1e-6)
    close(port_tf.closed_form_pose_inverse(ta[..., :3, :]), jax_tf.closed_form_pose_inverse(ja[..., :3, :]), 1e-6)
    close(port_tf.relative_pose_transformation(ta, tb), jax_tf.relative_pose_transformation(ja, jb), 1e-5)
    close(port_tf.extri_to_homo(ta[..., :3, :]), jax_tf.extri_to_homo(ja[..., :3, :]), 0)
    assert port_tf.inv_pose is port_tf.closed_form_pose_inverse


def frustum_inputs(seed, B=2, V=3, H=12, W=16):
    """Views of one scene: depth, K, cam2world poses near each other, prior masks."""
    rng = np.random.RandomState(seed)
    depth = rng.uniform(1.0, 4.0, (B, V, H, W)).astype(np.float32)
    depth[:, :, :2, :3] = 0.0
    K = np.tile(np.array([[14.0, 0, W / 2 - 0.5], [0, 14.0, H / 2 - 0.5], [0, 0, 1]], np.float32), (B, V, 1, 1))
    c2w = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    c2w[..., :3, 3] = rng.uniform(-0.3, 0.3, (B, V, 3))
    mask = rng.uniform(size=(B, V, H, W)) < 0.2
    return depth, K, c2w, mask


def test_in_frustum_mask_matches_jax():
    depth, K, c2w, mask = frustum_inputs(5)
    depth2, _, c2w2, mask2 = frustum_inputs(6)
    args = (depth, K, c2w, mask, depth2, K, c2w2, mask2)
    got = port_frustum.calculate_in_frustum_mask(*(torch.from_numpy(x) for x in args))
    ref = jax_frustum.calculate_in_frustum_mask(*(jnp.asarray(x) for x in args))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bool and np.array_equal(g.numpy(), np.asarray(r))
    assert 0 < got[0].float().mean() < 1 and 0 < got[1].float().mean() < 1  # neither mask trivial


def test_refine_batch_with_frustum_masks_matches_jax():
    """Every view against every view, itself included. A view's own pixels land on
    integer coordinates, where floor() and the image border tests decide by the
    last bit; with depths in eighths, a focal length of 16 and translations in
    quarters, identity rotations, every step of that projection is exact in fp32,
    and both packages must agree on every pixel."""
    depth, K, c2w, mask = frustum_inputs(7)
    depth = np.round(depth * 8) / 8
    K[..., 0, 0] = K[..., 1, 1] = 16.0
    c2w[..., :3, 3] = np.round(c2w[..., :3, 3] * 4) / 4
    B, V, H, W = depth.shape
    rng = np.random.RandomState(8)
    pts_cam = np.concatenate([rng.randn(B, V, H, W, 2).astype(np.float32), depth[..., None]], -1)
    quats = np.tile(np.array([0, 0, 0, 1], np.float32), (B, V, 1))
    arrays = dict(
        pts3d=rng.randn(B, V, H, W, 3).astype(np.float32), pts3d_cam=pts_cam,
        depth_along_ray=depth[..., None], ray_directions=unit(rng.randn(B, V, H, W, 3).astype(np.float32)),
        camera_pose_quats=quats, camera_pose_trans=c2w[..., :3, 3].copy(), valid_mask=rng.rand(B, V, H, W) < 0.9,
        non_ambiguous_mask=mask, valid_non_ambiguous_mask=mask, is_metric_scale=np.ones(B, bool),
        is_synthetic=np.zeros(B, bool),
    )
    ref = jax_masks.refine_batch_with_frustum_masks(jax_losses.LossBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                                    jnp.asarray(K))
    got = port_masks.refine_batch_with_frustum_masks(
        port_losses.LossBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}), torch.from_numpy(K))
    for name in ("non_ambiguous_mask", "valid_non_ambiguous_mask", "valid_mask"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name))), name
    assert not np.array_equal(got.valid_mask.numpy(), arrays["valid_mask"])  # the refinement did something
    assert torch.equal(got.pts3d, torch.from_numpy(arrays["pts3d"]))  # a new batch, the rest as it was


# ---------------------------------------------------------------- shared JAX setup


def jax_init_params(seed=0):
    """A seeded JAX tree of the small multimodal model (shapes from eval_shape)."""
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    views = jax_ma.Views(img=f32(1, 2, HW, HW, 3), ray_directions=f32(1, 2, HW, HW, 3),
                         depth_along_ray=f32(1, 2, HW, HW, 1), camera_pose_quats=f32(1, 2, 4),
                         camera_pose_trans=f32(1, 2, 3), is_metric_scale=jax.ShapeDtypeStruct((1, 2), jnp.bool_))
    model = jax_ma.MapAnything(jax_ma.MapAnythingConfig.small(**STEP_CFG))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), views)["params"]
    return model, seeded_params(shapes, seed)


def port_model(params):
    port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**STEP_CFG), device="cpu", geometric_inputs=True)
    return load_jax_params(port, params)


class ReplayLoader:
    """The JAX loader's batches of each epoch, recorded once: both Trainers see the same data."""

    def __init__(self, loader, epochs):
        self.batches = {}
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            self.batches[epoch] = list(loader)
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches[self.epoch])

    def __iter__(self):
        return iter(self.batches[self.epoch])


def assert_update_matches(port_params, before, want_new, grads, lr, steps, what):
    """The step test's rule over ``steps`` updates: each parameter's change within
    1e-3 · lr a step (plus one fp32 ulp of it) of the JAX one, except where the
    gradient is below 1e-3 of its leaf's largest (Adam's update is lr·sign there)."""
    for name, p in port_params.items():
        got, ref = (p.detach() - before[name]).numpy(), (want_new[name] - before[name]).numpy()
        g = grads[name].numpy()
        ulp = np.spacing(np.abs(before[name].numpy()))
        ok = (np.abs(got - ref) <= 1e-3 * lr * steps + ulp) | (np.abs(g) < 1e-3 * np.abs(g).max())
        assert ok.all(), f"{what}: {name} ({int((~ok).sum())} of {ok.size})"


# Over several Adam updates the per-element rule above no longer holds: an element whose
# gradient was near zero in an earlier step may have taken lr·sign the other way (up to
# 2·lr a step apart). What must agree is where the weights went: each leaf's displacement
# from the start weights against the JAX one's, by norm. Measured: 1.1e-2 in the worst
# leaf (a pose-head convolution), 4.8e-3 over all parameters.
LEAF_DISPLACEMENT_RTOL, DISPLACEMENT_RTOL = 3e-2, 1e-2


def displacement_errors(port_params, before, want_new):
    """Each leaf's displacement from the start weights against the JAX one's, by
    norm (None for a leaf that moves on neither side, inf where only the port's
    moves), and the same over all parameters."""
    errs, got_all, ref_all = {}, [], []
    for name, p in port_params.items():
        got, ref = (p - before[name]).ravel(), (np.asarray(want_new[name]) - before[name]).ravel()
        if not ref.any():  # a leaf that did not move (no gradient, no decay) must not move here either
            errs[name] = None if not got.any() else float("inf")
            continue
        errs[name] = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        got_all.append(got)
        ref_all.append(ref)
    got, ref = np.concatenate(got_all), np.concatenate(ref_all)
    return errs, float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def assert_displacement_within(errs, total, what):
    bad = {n: e for n, e in errs.items() if e is not None and not e <= LEAF_DISPLACEMENT_RTOL}
    assert not bad, f"{what}: leaves moved off the JAX displacement (by norm): {bad}"
    assert total <= DISPLACEMENT_RTOL, f"{what}: the parameters moved {total:.3g} (by norm) off the JAX displacement"


# ---------------------------------------------------------------- the accumulating step


def test_accum_train_step_matches_jax(record_property):
    """Two micro-batches with every geometric input, the JAX-sampled masks of each
    (the same draws as inside the JAX step) passed to the port: the loss, the
    grad norm of the mean gradients and the updated parameters."""
    model, params = jax_init_params(1)
    loader = ReplayLoader(MultiViewDataLoader(2 @ make_ds(num_views=2, resolution=(HW, HW)), images_per_batch=2,
                                              num_workers=1), 1)
    micro = loader.batches[0]
    assert len(micro) == 2
    geo = jax_ma.GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, dropout_prob=0.3,
                                      sparse_depth_prob=1.0, sparsification_removal_percent=0.5)
    opt_cfg = dict(lr=1e-4, min_lr=1e-6, epoch_len=10)
    from mapanything_tpu.train import optim as jax_optim

    jopt = jax_optim.build_optimizer(jax_optim.OptimConfig(**opt_cfg), params)
    jstep = jax_step.make_accum_train_step(model, jopt, 2, jax_losses.LossConfig(), geo, donate=False)
    state = jax_step.TrainState(params=params, opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    imgs = jnp.stack([jnp.asarray(b["img"]) for b in micro])
    batches = [jax_loop.loss_batch_from_numpy(b) for b in micro]
    rng = jax.random.PRNGKey(3)
    new_state, metrics = jstep(state, imgs, jax.tree.map(lambda *xs: jnp.stack(xs), *batches), rng)
    new_params = jax.tree.map(np.asarray, new_state.params)
    metrics = {k: float(v) for k, v in metrics.items()}
    del jstep, jopt, state, new_state
    threads.trim_heap()  # the compile's transient heap
    masks = []
    for r in jax.random.split(rng, 2):  # the draws of the JAX step
        B, V, H, W = micro[0]["valid_mask"].shape
        m = jax_ma.sample_modality_masks(jax.random.split(r)[0], B, V, (H, W), geo)
        masks.append(port_ma.ModalityMasks(**{k: None if v is None else torch.from_numpy(np.array(v))
                                              for k, v in vars(m).items()}))
    assert any(bool(m.ray_dirs.any()) for m in masks)

    port = port_model(params)
    opt = port_optim.build_optimizer(port_optim.OptimConfig(**opt_cfg), port)
    pstate = port_step.init_train_state(port, opt)
    before = {n: p.detach().clone() for n, p in pstate.params.items()}
    step = port_step.make_accum_train_step(port, opt, 2)
    pstate, pm = step(pstate, [port_loop._images(b, "cpu") for b in micro],
                      [port_loop.loss_batch_from_numpy(b, "cpu") for b in micro], torch.Generator(), masks=masks)
    np.testing.assert_allclose(pm["loss"].item(), metrics["loss"], rtol=1e-4)
    np.testing.assert_allclose(pm["grad_norm"].item(), metrics["grad_norm"], rtol=1e-4)
    assert pstate.step == 1 and pstate.opt_state.count == 1
    grads = {n: p.grad for n, p in pstate.params.items()}  # the mean gradients
    assert_update_matches(pstate.params, before, jax_params_to_state_dict(port, new_params), grads, opt_cfg["lr"], 1,
                          "accum step")
    record_property("loss_rel_err", abs(pm["loss"].item() - metrics["loss"]) / abs(metrics["loss"]))
    with pytest.raises(ValueError, match="accumulates 2"):
        step(pstate, [None], [None], torch.Generator())
    # Drawn from the generator instead: reproducible, micro-batch by micro-batch.
    del pstate, grads, before, opt, step
    first = None
    for _ in range(2):
        port = port_model(params)
        opt = port_optim.build_optimizer(port_optim.OptimConfig(**opt_cfg), port)
        s, m = port_step.make_accum_train_step(port, opt, 2)(
            port_step.init_train_state(port, opt), [port_loop._images(b, "cpu") for b in micro],
            [port_loop.loss_batch_from_numpy(b, "cpu") for b in micro], torch.Generator().manual_seed(4))
        run = (m["loss"].item(), {n: p.detach() for n, p in s.params.items()})
        if first is None:
            first = run
        else:
            assert run[0] == first[0] and all(torch.equal(t, first[1][n]) for n, t in run[1].items())
        del port, opt, s


# ---------------------------------------------------------------- the Trainer


INERT = dict(overall_prob=0.0, sparse_depth_prob=0.0, depth_scale_norm_all_prob=0.0, pose_scale_norm_all_prob=0.0)
# lr == min_lr: the schedule is the warm-up, then flat, whatever the epoch count, so
# that the resumed JAX Trainer (epochs=2) can run the first one's (epochs=1) jitted
# steps. The decaying schedule is compared by the accum_iter=1 test below.
LOOP_CFG = dict(warmup_epochs=0.5, lr=2e-4, min_lr=2e-4, accum_iter=2, print_freq=100, save_freq=1)


OPT_FIELDS = ("lr", "min_lr", "weight_decay", "grad_clip_norm", "warmup_epochs", "total_epochs", "epoch_len")


def trainer_facts(trainer, out, params_np):
    """What the tests read of a finished run: its config, step, best loss, log, its
    managers' steps and metadata, and its parameters (numpy, by the JAX tree or the
    port's names). Then its checkpoints are deleted (one of the small multimodal
    model, moments included, is 0.8 GB) and the trainer can go."""
    read = lambda m: dict(steps=sorted(m.manager.all_steps()) if hasattr(m, "manager") else m.all_steps(),  # noqa: E731
                          latest=m.latest_step(), meta=m.load_metadata())
    facts = dict(opt=[getattr(trainer.opt_cfg, f) for f in OPT_FIELDS], step=int(trainer.state.step),
                 start_epoch=trainer.start_epoch, best_loss=trainer.best_loss, log=read_log(out / "log.txt"),
                 ckpt=read(trainer.ckpt), best=read(trainer.ckpt_best), params=params_np(trainer.state.params))
    for m in (trainer.ckpt, trainer.ckpt_best):
        m.wait()
        m.close()
    shutil.rmtree(out / "checkpoints")
    shutil.rmtree(out / "checkpoints-best")
    return facts


def trainer_data(epochs):
    """tiny_setup's synthetic scenes, cut to three samples: 3 batches an epoch, so
    accum_iter=2 makes a full group and a trailing partial one."""
    ds = 3 @ make_ds(num_views=2, resolution=(HW, HW))
    data = ReplayLoader(MultiViewDataLoader(ds, images_per_batch=2, num_workers=1), epochs)
    assert [len(v) for v in data.batches.values()] == [3] * epochs
    return data


def digest(t: torch.Tensor) -> bytes:
    return hashlib.blake2b(t.detach().contiguous().numpy().data, digest_size=16).digest()


def trainer_runs(root):
    """One epoch of each package's Trainer, then a second Trainer (epochs=2) on the
    same directory that resumes and trains epoch 1; the JAX pair shares its jits.
    Only what the checks read is kept (each trainer holds 1 GB of state): numbers,
    digests, and the weights until their comparison. (One test reads it all: under
    pytest-xdist's load distribution a module fixture would run again in every
    worker that takes one of its tests.)"""
    data = trainer_data(2)
    model, params = jax_init_params(2)
    jgeo = jax_ma.GeometricInputConfig(**INERT)
    pgeo = port_ma.GeometricInputConfig(**INERT)
    jax_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    port_np = lambda p: {n: t.detach().numpy().copy() for n, t in p.items()}  # noqa: E731

    first = jax_loop.Trainer(model, data, jax_loop.TrainLoopConfig(output_dir=str(root / "jax"), epochs=1, **LOOP_CFG),
                             test_loader=data, geo_cfg=jgeo, init_params=params)
    first.train()
    first.ckpt.wait()
    jax_first = dict(opt=[getattr(first.opt_cfg, f) for f in OPT_FIELDS], step=int(first.state.step),
                     params=jax_np(first.state.params))
    first.state = None  # its jitted steps stay, for the second Trainer
    threads.trim_heap()
    second = jax_loop.Trainer(model, data, jax_loop.TrainLoopConfig(output_dir=str(root / "jax"), epochs=2, **LOOP_CFG),
                              test_loader=data, geo_cfg=jgeo, init_params=params)
    second._accum_steps, second.eval_step = first._accum_steps, first.eval_step
    second.train()
    first.ckpt.close()
    first.ckpt_best.close()
    jax_second = trainer_facts(second, root / "jax", jax_np)
    del first, second
    threads.trim_heap()

    port = port_model(params)
    before = port_np(dict(port.named_parameters()))
    pfirst = port_loop.Trainer(port, data, port_loop.TrainLoopConfig(output_dir=str(root / "port"), epochs=1,
                                                                     **LOOP_CFG), test_loader=data, geo_cfg=pgeo)
    pfirst.train()
    o = pfirst.state.opt_state
    end = dict(params={n: digest(t) for n, t in pfirst.state.params.items()},
               mu={n: digest(t) for n, t in o.mu.items()}, nu={n: digest(t) for n, t in o.nu.items()}, count=o.count)
    port_first = dict(opt=[getattr(pfirst.opt_cfg, f) for f in OPT_FIELDS], step=pfirst.state.step,
                      displacement=displacement_errors(port_np(pfirst.state.params), before,
                                                        jax_params_to_state_dict(port, jax_first.pop("params"))))
    del pfirst, port, o
    threads.trim_heap()

    # A fresh model with the start weights again: the resume must replace them.
    psecond = port_loop.Trainer(port_model(params), data, port_loop.TrainLoopConfig(
        output_dir=str(root / "port"), epochs=2, **LOOP_CFG), test_loader=data, geo_cfg=pgeo)
    s = psecond.state
    saved = torch.load(root / "port" / "checkpoints" / "0.pt", mmap=True, weights_only=True)["opt_state"]
    resume = dict(
        start_epoch=psecond.start_epoch, count=s.opt_state.count, step=s.step, end_count=end["count"],
        names=sorted(s.params) == sorted(end["params"]) == sorted(s.opt_state.mu) == sorted(saved["mu"]),
        params=all(digest(t) == end["params"][n] for n, t in s.params.items()),
        moments=all(digest(s.opt_state.mu[n]) == end["mu"][n] and digest(s.opt_state.nu[n]) == end["nu"][n]
                    for n in end["mu"]),
        saved_moments=all(digest(saved["mu"][n]) == end["mu"][n] and digest(saved["nu"][n]) == end["nu"][n]
                          for n in end["mu"]),
    )
    del s, saved, end
    psecond.train()
    port_second = trainer_facts(psecond, root / "port", port_np)
    port_second["displacement"] = displacement_errors(port_second.pop("params"), before, jax_params_to_state_dict(
        psecond.model, jax_second.pop("params")))
    del psecond
    threads.trim_heap()
    return dict(jax_first=jax_first, jax_second=jax_second, port_first=port_first, port_second=port_second,
                resume=resume)


def read_log(path):
    import json

    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_trainer_matches_jax_over_two_epochs_with_a_resume(tmp_path, record_property):
    """Per-epoch losses, grad norms and test losses; the optimizer configs; the step
    counts; the parameters after each epoch; the resume, bitwise; checkpoint-best and
    the managers' steps and metadata."""
    r = trainer_runs(tmp_path)
    jlog, plog = r["jax_second"]["log"], r["port_second"]["log"]
    assert [x["epoch"] for x in plog] == [x["epoch"] for x in jlog] == [0, 1]
    for j, p in zip(jlog, plog):
        assert sorted(p) == sorted(j)
        for key in ("train_loss", "train_loss_synced", "train_grad_norm", "test_loss"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-4, err_msg=f"epoch {j['epoch']} {key}")
    record_property("epoch_loss_rel_err", float(max(abs(p["train_loss"] - j["train_loss"]) / j["train_loss"]
                                                    for j, p in zip(jlog, plog))))
    # The schedule's wiring: the port's OptimConfig is the JAX one's, field by field.
    assert r["port_first"]["opt"] == r["jax_first"]["opt"] and r["port_second"]["opt"] == r["jax_second"]["opt"]
    # One optimizer step a full group and one for the trailing partial group, each epoch.
    assert r["port_first"]["step"] == r["jax_first"]["step"] == 2
    assert r["port_second"]["step"] == r["jax_second"]["step"] == 4
    for epoch, run in ((0, "port_first"), (1, "port_second")):
        errs, total = r[run]["displacement"]
        record_property(f"displacement_err_epoch_{epoch}", total)
        assert_displacement_within(errs, total, f"epoch {epoch}")

    # The resume: the second Trainer holds the first one's end state, bitwise.
    res = r["resume"]
    assert res["start_epoch"] == 1 == r["jax_second"]["start_epoch"]
    assert res["count"] == res["end_count"] == 2 and res["step"] == 2  # the file's own step (its name) is the epoch
    assert res["names"] and res["params"] and res["moments"] and res["saved_moments"]

    # Checkpoint-best and the managers' steps and metadata.
    jf, pf = r["jax_second"], r["port_second"]
    assert pf["best"]["latest"] == jf["best"]["latest"] is not None
    assert pf["best"]["steps"] == jf["best"]["steps"] == [pf["best"]["latest"]]  # max_to_keep=1
    assert pf["best"]["meta"]["epoch"] == jf["best"]["meta"]["epoch"]
    assert pf["best"]["meta"]["step"] == jf["best"]["meta"]["step"]
    np.testing.assert_allclose(pf["best"]["meta"]["best_loss"], jf["best"]["meta"]["best_loss"], rtol=1e-4)
    np.testing.assert_allclose(pf["best_loss"], jf["best_loss"], rtol=1e-4)
    assert pf["ckpt"]["meta"] == {"step": 1, "epoch": 1} == jf["ckpt"]["meta"]
    assert pf["ckpt"]["steps"] == jf["ckpt"]["steps"] == [0, 1]  # the checkpoint's step is the epoch


# The default accum_iter=1 (a group a batch) under a schedule that decays: two epochs in
# one run, lr above min_lr, so the steps after the warm-up follow the cosine down.
DECAY_CFG = dict(warmup_epochs=0.5, lr=2e-4, min_lr=1e-6, accum_iter=1, print_freq=100, save_freq=1, epochs=2)


def test_trainer_with_accum_iter_1_and_a_decaying_schedule_matches_jax(tmp_path, record_property):
    """Two epochs of three batches, a step a batch: the learning rate of each of the
    port's six updates against the JAX schedule at the same count (it falls tenfold
    after the warm-up), the per-epoch losses and grad norms, and the parameters."""
    from mapanything_tpu.train import optim as jax_optim

    data = trainer_data(2)
    model, params = jax_init_params(2)
    jt = jax_loop.Trainer(model, data, jax_loop.TrainLoopConfig(output_dir=str(tmp_path / "jax"), **DECAY_CFG),
                          geo_cfg=jax_ma.GeometricInputConfig(**INERT), init_params=params)
    jt.train()
    jax_schedule = jax_optim.warmup_cosine_schedule(jt.opt_cfg)
    jax_step_count, jax_params = int(jt.state.step), jax.tree.map(np.asarray, jt.state.params)
    for m in (jt.ckpt, jt.ckpt_best):
        m.close()
    jlog = read_log(tmp_path / "jax" / "log.txt")
    del jt
    shutil.rmtree(tmp_path / "jax")  # two checkpoints of 0.8 GB
    threads.trim_heap()

    port = port_model(params)
    before = {n: t.detach().numpy().copy() for n, t in port.named_parameters()}
    pt = port_loop.Trainer(port, data, port_loop.TrainLoopConfig(output_dir=str(tmp_path / "port"), **DECAY_CFG),
                           geo_cfg=port_ma.GeometricInputConfig(**INERT))
    applied, schedule = [], pt.optimizer.schedule
    pt.optimizer.schedule = lambda count: applied.append((count, schedule(count))) or applied[-1][1]
    pt.train()
    plog = read_log(tmp_path / "port" / "log.txt")
    shutil.rmtree(tmp_path / "port")
    assert pt.state.step == jax_step_count == 6 and [c for c, _ in applied] == list(range(6))
    lrs = np.array([lr for _, lr in applied])
    np.testing.assert_allclose(lrs, [float(jax_schedule(c)) for c, _ in applied], rtol=1e-6)
    assert lrs[-1] < 0.2 * lrs.max()  # the cosine, not the flat tail of lr == min_lr
    assert [x["epoch"] for x in plog] == [x["epoch"] for x in jlog] == [0, 1]
    for j, p in zip(jlog, plog):
        for key in ("train_loss", "train_loss_synced", "train_grad_norm"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-4, err_msg=f"epoch {j['epoch']} {key}")
    errs, total = displacement_errors({n: t.detach().numpy() for n, t in pt.state.params.items()}, before,
                                      jax_params_to_state_dict(port, jax_params))
    record_property("displacement_err", total)
    assert_displacement_within(errs, total, "accum_iter=1")


def test_forensic_dump_pickles_the_batch_and_raises(tmp_path):
    """A loss over max_loss_explosion, here in the trailing partial group only
    (accum_iter above the batch count): the batch is pickled, a debug checkpoint
    saved at the optimizer step, and FloatingPointError raised."""
    import pickle

    data = trainer_data(1)
    cfg = port_loop.TrainLoopConfig(output_dir=str(tmp_path), epochs=1, warmup_epochs=0.1, print_freq=100,
                                    resume=False, accum_iter=len(data) + 1, max_loss_explosion=0.0)
    trainer = port_loop.Trainer(port_model(jax_init_params(2)[1]), data, cfg,
                                geo_cfg=port_ma.GeometricInputConfig(**INERT))
    with pytest.raises(FloatingPointError, match="epoch 0 iter 2"):
        trainer.train_one_epoch(0)
    dumps = list((tmp_path / "debug").glob("bad_batch_*.pkl"))
    assert [p.name for p in dumps] == ["bad_batch_e0_i2.pkl"]
    with open(dumps[0], "rb") as f:
        batch = pickle.load(f)
    last = data.batches[0][-1]
    assert sorted(batch) == sorted(last) and all(np.array_equal(batch[k], last[k]) for k in last)
    assert trainer.ckpt.all_steps() == [1] and trainer.ckpt.load_metadata() == {"step": 1, "debug": True, "epoch": 0}
    shutil.rmtree(tmp_path / "checkpoints")
    with pytest.raises(TypeError, match="Mesh"):  # the data axis takes a parallel.mesh.Mesh
        port_loop.Trainer(trainer.model, data, cfg, mesh=object())


@pytest.mark.parametrize("keep_freq", [0, 4])
def test_retention_keeps_the_newest_three_and_the_keep_freq_multiples(tmp_path, keep_freq):
    """Saves under max_to_keep=3: the steps that orbax keeps. With keep_freq=0
    against the JAX CheckpointManager itself; with keep_freq=4 against orbax given
    the keep function directly (the JAX manager's keep_fn reads ``info.step``, and
    the orbax installed here passes the step itself)."""
    import orbax.checkpoint as ocp

    params = {"w": torch.nn.Parameter(torch.arange(3.0))}
    zeros = {"w": torch.zeros(3)}
    state = port_step.TrainState(params=params, opt_state=port_optim.OptState(0, dict(zeros), dict(zeros)), step=0)
    pm = port_ckpt.CheckpointManager(str(tmp_path / "port"), keep_freq=keep_freq)
    if keep_freq:
        options = ocp.CheckpointManagerOptions(max_to_keep=3, should_keep_fn=lambda step: step % keep_freq == 0)
        jm = ocp.CheckpointManager(tmp_path / "orbax", options=options)
        save = lambda step: jm.save(step, args=ocp.args.StandardSave({"w": jnp.zeros(3)}))  # noqa: E731
    else:
        jax_manager = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
        jm = jax_manager.manager
        save = lambda step: jax_manager.save(step, {"w": jnp.zeros(3)}, {"epoch": step})  # noqa: E731
    last = 9 if keep_freq else 5
    for step in range(last + 1):
        pm.save(step, state, {"epoch": step})
        save(step)
        jm.wait_until_finished()
    want = [0, 4, 7, 8, 9] if keep_freq else [3, 4, 5]
    assert pm.all_steps() == sorted(jm.all_steps()) == want
    assert pm.latest_step() == jm.latest_step() == last
    assert pm.load_metadata() == {"step": last, "epoch": last}
    if not keep_freq:
        assert jax_manager.load_metadata() == pm.load_metadata()
    assert not list((tmp_path / "port").glob("*.tmp"))
    jm.close()
    # restore is strict about names and shapes, and copies into the template's tensors
    other = port_step.TrainState(params={"v": torch.zeros(3)}, opt_state=state.opt_state, step=0)
    with pytest.raises(KeyError, match=r"missing \['v'\]"):
        pm.restore(other)
    wrong = port_step.TrainState(params={"w": torch.zeros(4)}, opt_state=state.opt_state, step=0)
    with pytest.raises(ValueError, match="params/w"):
        pm.restore(wrong)
    template = port_step.TrainState(params={"w": torch.zeros(3)}, opt_state=port_optim.OptState(
        5, {"w": torch.ones(3)}, {"w": torch.ones(3)}), step=7)
    restored = pm.restore(template, step=want[-2])
    assert restored.params["w"] is template.params["w"] and torch.equal(template.params["w"], torch.arange(3.0))
    assert restored.step == 0 and restored.opt_state.count == 0 and not template.opt_state.mu["w"].any()


def test_logging_helpers():
    assert port_logging.all_reduce_mean(2.5) == 2.5  # no process group: the value itself
    assert port_logging.is_main_process()
    v = port_logging.SmoothedValue(window_size=2)
    for x in (1.0, 2.0, 6.0):
        v.update(x)
    assert (v.median, v.avg, v.global_avg, v.max, v.value) == (4.0, 4.0, 3.0, 6.0, 6.0)
    logger = port_logging.MetricLogger(print_fn=lambda *a: None)
    for x in logger.log_every(range(3), 1, "h"):
        logger.update(loss=x)
    assert logger.global_avg_dict("t_") == {"t_loss": 1.0}
