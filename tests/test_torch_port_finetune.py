"""The port's one-sample finetune tool against ``scripts/one_sample_finetune.py``, on the CPU.

The sample equals the arrays that the JAX script builds (captured where it hands
them to ``views_from_loss_batch``), and the loss falls as
``test_one_sample_finetune_converges`` asserts of the JAX script (``--small --steps
30 --resolution 28 --lr 1e-3``: the last printed loss under 0.9x the first). The
small model carries the six geometric encoders (92M parameters, 61M of them in the
encoders, as the JAX script's ``init`` on geometric views makes them), and a step on
one CPU thread takes ~4.5 s, most of it memory-bound passes over the parameters
(the optimizer, the products' float64 copies) and page faults; the 30 steps run on
up to 4 threads, with glibc keeping the freed blocks (``threads.large_heap``).
"""

import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.tools import one_sample_finetune
from mapanything_tpu_torch.utils import threads

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ROOT = Path(__file__).resolve().parents[1]
STEP_THREADS = min(4, os.cpu_count() or 1)


def jax_finetune_sample(monkeypatch, views, resolution):
    """The JAX script's (batch, img), captured where it builds the model's views."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import one_sample_finetune as jax_script

    from mapanything_tpu.train import step as jax_step

    captured = {}

    class Captured(Exception):
        pass

    def capture(batch, img):
        captured.update(batch=batch, img=img)
        raise Captured

    monkeypatch.setattr(jax_step, "views_from_loss_batch", capture)
    monkeypatch.setattr(sys, "argv", ["one_sample_finetune.py", "--small", "--views", str(views),
                                      "--resolution", str(resolution)])
    with pytest.raises(Captured):
        jax_script.main()
    return captured


def test_one_sample_finetune_sample_equals_the_jax_scripts(monkeypatch):
    want = jax_finetune_sample(monkeypatch, 3, 28)
    sample = one_sample_finetune.synthetic_sample(3, 28)
    np.testing.assert_array_equal(sample["img"], np.asarray(want["img"]))
    got = one_sample_finetune.loss_batch(sample, "cpu")
    for field in ("pts3d", "pts3d_cam", "depth_along_ray", "ray_directions", "camera_pose_quats", "camera_pose_trans",
                  "valid_mask", "non_ambiguous_mask", "valid_non_ambiguous_mask", "is_metric_scale", "is_synthetic"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want["batch"], field)), field)


def test_one_sample_finetune_loss_falls(capsys):
    torch.set_num_threads(STEP_THREADS)
    try:
        with threads.large_heap():
            run = one_sample_finetune.run(one_sample_finetune.parse_args(
                ["--small", "--steps", "30", "--resolution", "28", "--lr", "1e-3", "--device", "cpu"]))
    finally:
        torch.set_num_threads(1)
    out = capsys.readouterr().out
    losses = [float(m) for m in re.findall(r"loss ([0-9.]+) grad_norm", out)]
    assert losses == pytest.approx([loss for _, loss, _ in run["printed"]], abs=1e-4)
    assert len(losses) >= 3 and [i for i, _, _ in run["printed"]] == [0, 10, 20, 29]
    assert losses[-1] < losses[0] * 0.9, losses
    assert f"final loss: {run['final_loss']}" in out
