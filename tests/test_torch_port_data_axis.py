"""The Trainer's data axis: a 2 (data) x 2 (view) mesh of gloo ranks on the CPU.

The JAX ``Trainer`` with a (data, view) mesh runs one program on the global
batch; the port runs one process a rank, each on its (data, view) block. Parity
is the same loss and gradients as the unsharded step on the global batch, which
``tests/test_torch_port_train.py`` holds to the JAX package. Here four gloo
ranks run one Trainer epoch of one global batch of 4 samples x 4 views (each
rank 2 samples x 2 views, the views under the ring), and the port's unsharded
Trainer runs the same batch in this process: the logged loss and gradient norm,
and every summed gradient, agree within fp32 tolerance (1e-5 relative for the
loss and norm, 1e-4 of each leaf's largest gradient); the ranks end with the
same parameters (they start from different seeds: the Trainer replicates the
first rank's); the first rank alone writes checkpoints and logs.

The purpose of the batch: its two data shards differ in valid-pixel count
(95/90% against 30/60% of pixels), metric scale and synthetic flag, so that a
loss that averaged per-shard means (plain data parallelism) would differ from
the global one; the test shows that it does, by far more than the tolerance.
Every file the ranks write is removed.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.parallel.distributed import run_ranks
from mapanything_tpu_torch.tools import view_parallel_ranks
from mapanything_tpu_torch.train import loop as port_loop
from mapanything_tpu_torch.train import step as port_step
from mapanything_tpu_torch.utils import threads

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

STEP_CFG = dict(encoder_size="test", info_sharing_depth=2, info_sharing_dim=64, info_sharing_indices=(0, 1))
B, V, HW = 4, 4, 28
DATA, VIEW = 2, 2
LOOP_KW = dict(warmup_epochs=0.5, lr=2e-4, min_lr=2e-4, accum_iter=1, print_freq=100, save_freq=1, seed=3)
VALID_FRACTION = (0.95, 0.9, 0.3, 0.6)  # data shard 0: samples 0-1, shard 1: samples 2-3
IS_METRIC = (True, True, False, True)
IS_SYNTHETIC = (True, True, False, False)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def global_batch(seed=5) -> dict:
    """A collated numpy batch of B samples of V views whose data shards differ."""
    rng = np.random.RandomState(seed)
    dirs = rng.randn(B, V, HW, HW, 3).astype(np.float32)
    dirs[..., 2] = np.abs(dirs[..., 2]) + 0.5
    valid = rng.uniform(size=(B, V, HW, HW)) < np.asarray(VALID_FRACTION)[:, None, None, None]
    return dict(
        img=rng.randn(B, V, HW, HW, 3).astype(np.float32),
        pts3d=rng.randn(B, V, HW, HW, 3).astype(np.float32),
        pts3d_cam=rng.randn(B, V, HW, HW, 3).astype(np.float32),
        depth_along_ray=rng.uniform(1, 5, (B, V, HW, HW, 1)).astype(np.float32),
        ray_directions_cam=unit(dirs),
        camera_pose_quats=unit(rng.randn(B, V, 4).astype(np.float32)),
        camera_pose_trans=rng.randn(B, V, 3).astype(np.float32),
        valid_mask=valid,
        non_ambiguous_mask=rng.uniform(size=(B, V, HW, HW)) < 0.7,
        valid_non_ambiguous_mask=valid & (rng.uniform(size=(B, V, HW, HW)) < 0.9),
        is_metric_scale=np.asarray(IS_METRIC),
        is_synthetic=np.asarray(IS_SYNTHETIC),
    )


def samples(x, sl):
    """Samples ``sl`` of a tensor, or of every tensor field of a dataclass."""
    if isinstance(x, torch.Tensor):
        return x[sl]
    return dataclasses.replace(x, **{f.name: getattr(x, f.name)[sl] for f in dataclasses.fields(x)
                                     if isinstance(getattr(x, f.name), torch.Tensor)})


def read_log(text):
    return [json.loads(line) for line in text.splitlines()]


def test_two_by_two_mesh_trainer_matches_the_unsharded_step(tmp_path, record_property):
    batch = global_batch()
    model = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**STEP_CFG), device="cpu", seed=0,
                                geometric_inputs=True)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}

    # What the batch is for: the mean of the two data shards' own losses is not the
    # global loss (each shard's masks drawn for the global batch, as the step draws them).
    gen = torch.Generator().manual_seed(LOOP_KW["seed"])
    masks, _ = port_step.draw_step_inputs(model, port_ma.GeometricInputConfig(), gen, (B, V, HW, HW))
    img, lb = port_loop._images(batch, "cpu"), port_loop.loss_batch_from_numpy(batch, "cpu")
    loss_fn = port_step.make_loss_fn(model)
    with torch.no_grad():
        whole = loss_fn(lb, img, masks)[0].item()
        shards = [loss_fn(*(samples(x, sl) for x in (lb, img, masks)))[0].item()
                  for sl in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(shards) - whole) > 1e-2 * abs(whole), (shards, whole)
    record_property("mean_of_shard_losses_vs_global", (float(np.mean(shards)), whole))

    # The unsharded Trainer on the global batch.
    trainer = port_loop.Trainer(model, [batch], port_loop.TrainLoopConfig(output_dir=str(tmp_path / "one"),
                                                                          epochs=1, **LOOP_KW))
    stats = trainer.train_one_epoch(0)
    want = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    np.testing.assert_allclose(stats["train_loss"], whole, rtol=1e-5)
    shutil.rmtree(tmp_path / "one")
    del trainer, model, loss_fn  # the model and its Adam state, while the four ranks run

    # The same on the 2 x 2 mesh.
    results = run_ranks(view_parallel_ranks.mesh_trainer, DATA * VIEW, "cpu", tmp_path / "rendezvous", VIEW,
                        STEP_CFG, state, batch, LOOP_KW, str(tmp_path / "mesh"))
    assert [r["mesh"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]  # view fastest
    assert len({r["digest"] for r in results}) == 1  # replicated parameters, one update
    assert "log.txt" in results[0]["files"] and any(f.startswith("checkpoints/") for f in results[0]["files"])
    assert all(r["files"] == [] for r in results[1:])  # only the first rank writes
    assert not any((tmp_path / "mesh").iterdir())
    (epoch,) = read_log(results[0]["log"])
    np.testing.assert_allclose(epoch["train_loss"], stats["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(epoch["train_grad_norm"], stats["train_grad_norm"], rtol=1e-5)
    record_property("grad_err_over_leaf_magnitude", assert_grads_match(results[0]["grads"], want))


def assert_grads_match(got, want) -> float:
    """Each summed gradient leaf within 1e-4 of its largest magnitude; returns the worst ratio."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for name, r in want.items():
        scale = float(np.abs(r).max()) + 1e-12
        worst = max(worst, float(np.abs(got[name] - r).max()) / scale)
        np.testing.assert_allclose(got[name], r, atol=1e-4 * scale, rtol=0, err_msg=name)
    return worst


def test_mesh_trainer_resumes_from_the_first_ranks_checkpoint(tmp_path, record_property):
    """Auto-resume under the mesh: each rank writes under a directory of its own, so only
    the first rank finds the checkpoint of epoch 0. It restores; every rank then takes
    its train state and its epoch (not their own fresh weights at epoch 0, which would
    run another number of steps), and the second epoch equals the unsharded Trainer's
    resumed one within the tolerances above. Every file either run writes is removed."""
    batch = global_batch()
    small = port_ma.MapAnythingConfig.small(**STEP_CFG)
    model = port_ma.MapAnything(small, device="cpu", seed=0, geometric_inputs=True)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    cfg = lambda epochs: port_loop.TrainLoopConfig(output_dir=str(tmp_path / "one"), epochs=epochs,  # noqa: E731
                                                   **LOOP_KW)
    port_loop.Trainer(model, [batch], cfg(1)).train()
    model = port_ma.MapAnything(small, device="cpu", seed=11, geometric_inputs=True)
    trainer = port_loop.Trainer(model, [batch], cfg(2))
    assert trainer.start_epoch == 1
    trainer.train()
    want = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    want_log = read_log((tmp_path / "one" / "log.txt").read_text())
    shutil.rmtree(tmp_path / "one")  # its checkpoints
    del trainer, model  # the model and its Adam state, while the four ranks run

    results = run_ranks(view_parallel_ranks.mesh_trainer, DATA * VIEW, "cpu", tmp_path / "rendezvous", VIEW,
                        STEP_CFG, state, batch, LOOP_KW, str(tmp_path / "mesh"), True)
    assert [(r["start_epoch"], r["step"]) for r in results] == [(1, 2)] * 4
    assert len({r["digest"] for r in results}) == 1
    assert all(r["files"] == [] for r in results[1:])
    got_log = read_log(results[0]["log"])
    assert [e["epoch"] for e in got_log] == [e["epoch"] for e in want_log] == [0, 1]
    for key in ("train_loss", "train_grad_norm"):
        np.testing.assert_allclose(got_log[1][key], want_log[1][key], rtol=1e-5, err_msg=key)
    record_property("grad_err_over_leaf_magnitude", assert_grads_match(results[0]["grads"], want))


def test_train_tool_builds_the_mesh_of_its_config(tmp_path):
    """``distributed.mesh`` of a config (the JAX script's keys) as the train tool reads
    it in a group of 4 gloo ranks: data_parallelism -1 takes the ranks left."""
    runs = {
        "2x2": {"view_parallelism": 2, "data_parallelism": -1},
        "4x1": {"view_parallelism": 1, "data_parallelism": 4},
        "bad": {"view_parallelism": 2, "data_parallelism": 4},
    }
    for name, mesh_cfg in runs.items():
        got = run_ranks(view_parallel_ranks.train_tool_mesh, 4, "cpu", tmp_path / f"rendezvous_{name}", mesh_cfg)
        if name == "2x2":
            assert got == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
        elif name == "4x1":
            assert got == [(4, 1, r, 0) for r in range(4)]
        else:
            assert all("needs 8 ranks" in g for g in got)
