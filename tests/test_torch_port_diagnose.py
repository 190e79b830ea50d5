"""The port's ``tools/diagnose_lr_nan.py`` against the JAX package's train step, on the CPU.

``--small --device cpu``: step 0's loss terms, loss and gradient norm within 1e-4 (relative)
of the JAX ``make_train_step``'s on the tool's seeded inputs (the JAX script's draws from
``RandomState(0)``) and the same modality masks (the JAX step's draw from ``PRNGKey(i)``,
handed to the tool), the port model built on the meta device and loaded from the JAX
parameters (both a narrow small config, the train test's ``STEP_CFG``); then three steps
whose lines and forensic lines are finite. fp32 throughout.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.train import optim as jax_optim
from mapanything_tpu.train import step as jax_step
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.tools import diagnose_lr_nan
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import load_jax_params
from test_torch_port_infer import seeded_params
from test_torch_port_train import STEP_CFG, jax_batch

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

STEP_RTOL = 1e-4


def test_diagnose_lr_nan_small_matches_the_jax_step(capsys):
    args = diagnose_lr_nan.parse_args(["--small", "--device", "cpu", "--steps", "3"])
    _, (B, V, H, W), _ = diagnose_lr_nan.build(args)
    arrays = diagnose_lr_nan.make_inputs(B, V, H, W)
    img = arrays.pop("img")
    batch = jax_batch(arrays)
    model = jax_ma.MapAnything(jax_ma.MapAnythingConfig.small(**STEP_CFG))
    views = jax_step.views_from_loss_batch(batch, jnp.asarray(img))
    params = seeded_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), views)["params"], 0)
    optimizer = jax_optim.build_optimizer(jax_optim.OptimConfig(lr=args.lr, min_lr=args.lr * 0.1, epoch_len=100,
                                                                total_epochs=1.0), params)
    state = jax_step.TrainState(params=params, opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))
    _, metrics = jax_step.make_train_step(model, optimizer, donate=False)(state, jnp.asarray(img), batch,
                                                                         jax.random.PRNGKey(0))

    def masks_for_step(i):  # the JAX step's draw from PRNGKey(i)
        masks = jax_ma.sample_modality_masks(jax.random.split(jax.random.PRNGKey(i))[0], B, V, (H, W),
                                             jax_ma.GeometricInputConfig())
        return port_ma.ModalityMasks(**{k: None if v is None else torch.from_numpy(np.array(v))
                                        for k, v in vars(masks).items()})

    with torch.device("meta"):  # no seeded init: every weight comes from the JAX tree
        port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**STEP_CFG), device="meta", geometric_inputs=True)
    load_jax_params(port.to_empty(device="cpu"), jax.tree.map(np.asarray, params))
    with threads.large_heap():  # the 65M-parameter steps' temporaries (the geometric encoders' full widths)
        records = diagnose_lr_nan.run(args, model=port, masks_for_step=masks_for_step)
    lines = capsys.readouterr().out.splitlines()
    assert len(records) == 3 and sum("forensic:" in line for line in lines) == 3
    got = records[0]["metrics"]
    assert sorted(got) == sorted(metrics)
    for name, ref in metrics.items():
        np.testing.assert_allclose(got[name], float(ref), rtol=STEP_RTOL, atol=1e-6, err_msg=name)
    for r in records:
        assert all(np.isfinite(v) for v in r["metrics"].values())
        assert all(np.isfinite(v) for v in r["forensic"].values())
        assert np.isfinite(r["param_norm"]) and np.isfinite(r["param_max"])
    fz = records[0]["forensic"]
    assert {f"dL/d{name}" for name in diagnose_lr_nan.DPRED_FIELDS} <= set(fz)
    assert {"g/encoder", "g/info_sharing", "g/ray_dirs_encoder"} <= set(fz)


def test_diagnose_lr_nan_inputs_are_the_jax_scripts():
    """The JAX script's draws from RandomState(0), in its order: unit rays facing +z, unit
    quaternions, depths in [1, 5), images in [0, 1), every pixel valid, metric and real."""
    a = diagnose_lr_nan.make_inputs(1, 2, 6, 5)
    rng = np.random.RandomState(0)
    dirs = rng.randn(1, 2, 6, 5, 3).astype(np.float32)
    dirs[..., 2] = np.abs(dirs[..., 2]) + 0.5
    np.testing.assert_array_equal(a["ray_directions"], dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    assert (a["depth_along_ray"] >= 1).all() and (a["depth_along_ray"] < 5).all()
    assert a["valid_mask"].all() and a["is_metric_scale"].all() and not a["is_synthetic"].any()
    assert a["img"].shape == (1, 2, 6, 5, 3) and 0 <= a["img"].min() and a["img"].max() < 1
    assert isinstance(diagnose_lr_nan.parse_args([]), argparse.Namespace)
    assert diagnose_lr_nan.parse_args([]).device == "cuda" and diagnose_lr_nan.parse_args([]).lr == 1e-4
