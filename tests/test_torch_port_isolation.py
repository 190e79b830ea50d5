"""The PyTorch port stands alone: no JAX, no Flax, nothing of mapanything_tpu.

The import check runs in a subprocess, because this test session has JAX
loaded already (conftest.py); it reaches every module, those of the training,
view-parallel and inference slices included. A second check reads the sources
of the port and of chip_smoke.py for such imports. Also: the port's entry
points (the model and ``infer``) run on CUDA unless the caller asks for the
CPU, and raise when there is no CUDA.
"""

import json
import re
import subprocess
import types
import sys
from pathlib import Path

import pytest
import torch

from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.ops.flash_attention import flash_attention
from mapanything_tpu_torch.parallel.distributed import run_ranks
from mapanything_tpu_torch.tools import view_parallel_ranks
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.inference import infer


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)


ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mapanything_tpu_torch"
FORBIDDEN = ("jax", "flax", "mapanything_tpu")
# `\b` after the name: the port's own name, mapanything_tpu_torch, does not match.
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|flax|mapanything_tpu)\b", re.M)

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import numpy, torch
base = {{m.split(".")[0] for m in sys.modules}}
import mapanything_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
# anything beyond torch, numpy (and what they load) and the standard library
extra = sorted({{m.split(".")[0] for m in sys.modules}} - base - set(sys.stdlib_module_names) - {{pkg.__name__}})
print(json.dumps({{"names": names, "bad": bad, "extra": extra}}))
"""

# Modules of the training, view-parallel, inference, files/trainer and data slices that the fresh-process
# import must reach.
SLICE_MODULES = (
    "mapanything_tpu_torch.train.losses",
    "mapanything_tpu_torch.train.optim",
    "mapanything_tpu_torch.train.step",
    "mapanything_tpu_torch.geometry.quaternion",
    "mapanything_tpu_torch.geometry.normalization",
    "mapanything_tpu_torch.models.encoders.dense_rep",
    "mapanything_tpu_torch.parallel.distributed",
    "mapanything_tpu_torch.parallel.mesh",
    "mapanything_tpu_torch.parallel.cp",
    "mapanything_tpu_torch.parallel.sharded_attention",
    "mapanything_tpu_torch.parallel.context",
    "mapanything_tpu_torch.tools.view_parallel_ranks",
    "mapanything_tpu_torch.geometry.camera",
    "mapanything_tpu_torch.geometry.normals",
    "mapanything_tpu_torch.models.encoders.normalizations",
    "mapanything_tpu_torch.utils.inference",
    "mapanything_tpu_torch.utils.viz",
    "mapanything_tpu_torch.utils.colmap",
    # files to a scene, batches to checkpoints
    "mapanything_tpu_torch.utils.checkpoint",
    "mapanything_tpu_torch.utils.hub",
    "mapanything_tpu_torch.data.cropping",
    "mapanything_tpu_torch.utils.image",
    "mapanything_tpu_torch.utils.viewer",
    "mapanything_tpu_torch.tools.load_model",
    "mapanything_tpu_torch.tools.demo_images_only_inference",
    "mapanything_tpu_torch.geometry.transforms",
    "mapanything_tpu_torch.geometry.frustum",
    "mapanything_tpu_torch.train.masks",
    "mapanything_tpu_torch.train.checkpointing",
    "mapanything_tpu_torch.utils.logging",
    "mapanything_tpu_torch.train.loop",
    # the data path: WAI scenes from disk through datasets, samplers and the loader to the train tool
    "mapanything_tpu_torch.utils.exr",
    "mapanything_tpu_torch.utils.jpeg",
    "mapanything_tpu_torch.utils.yaml_subset",
    "mapanything_tpu_torch.utils.config",
    "mapanything_tpu_torch.data.transforms",
    "mapanything_tpu_torch.data.easy_dataset",
    "mapanything_tpu_torch.data.splits",
    "mapanything_tpu_torch.native",
    "mapanything_tpu_torch.data.base_dataset",
    "mapanything_tpu_torch.data.samplers",
    "mapanything_tpu_torch.data.loader",
    "mapanything_tpu_torch.data.wai",
    "mapanything_tpu_torch.data.datasets.wai_datasets",
    "mapanything_tpu_torch.tools.train",
)
# Optional decoders that the port imports only when a file needs them, and what the JAX data path
# uses that the port must not (PyYAML, SciPy).
LAZY = ("cv2", "PIL", "pillow_heif", "yaml", "scipy")


def test_port_imports_no_jax_in_a_fresh_process():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL.format(forbidden=set(FORBIDDEN + LAZY))],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(got["names"]) >= 45, got["names"]  # every module of the port was imported
    assert set(SLICE_MODULES) <= set(got["names"]), got["names"]
    assert got["bad"] == [], f"the port pulled in {got['bad']}"
    assert got["extra"] == [], f"the port imports beyond torch, numpy and the standard library: {got['extra']}"


def test_rank_processes_import_no_jax(tmp_path):
    """A rank that the launcher starts (spawn, gloo) holds no JAX, though this
    test process does."""
    assert "jax" in sys.modules
    modules = run_ranks(view_parallel_ranks.loaded_modules, 2, "cpu", tmp_path / "rendezvous")
    for names in modules:
        assert "torch" in names and "mapanything_tpu_torch" in names
        assert not set(FORBIDDEN) & set(names), sorted(set(FORBIDDEN) & set(names))


def test_port_sources_and_chip_smoke_name_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = {
        str(f.relative_to(ROOT)): IMPORT_RE.findall(f.read_text()) for f in files
    }
    assert not {k: v for k, v in offenders.items() if v}
    # the pattern does catch what it is for, and spares the port's own name
    assert IMPORT_RE.findall("import jax.numpy as jnp\n    from mapanything_tpu.ops import x\n")
    assert not IMPORT_RE.findall("from mapanything_tpu_torch.ops import attention\n")


def test_entry_point_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ma.MapAnything(port_ma.MapAnythingConfig.small())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ma.resolve_device("cuda")
    assert port_ma.resolve_device("cpu") == torch.device("cpu")
    # infer runs where the model is: a model on the card (CUDA by default) needs
    # CUDA, and nothing moves to the card before the check.
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer(on_card, torch.zeros(1, 1, 14, 14, 3))
    # The files and trainer slice: images, batches, the demo and the model tool.
    import numpy as np

    from mapanything_tpu_torch.tools import demo_images_only_inference, load_model
    from mapanything_tpu_torch.train.loop import loss_batch_from_numpy
    from mapanything_tpu_torch.utils.image import load_images

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_images([np.zeros((28, 28, 3), np.uint8)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loss_batch_from_numpy({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_images_only_inference.main(["--images", str(ROOT)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model.main(["--small", "--save", str(ROOT / "unused")])
    assert not (ROOT / "unused").exists()


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="dense_head_type"):
        port_ma.MapAnything(port_ma.MapAnythingConfig.small(dense_head_type="moge"), device="cpu")
    with pytest.raises(NotImplementedError, match="scene_rep_type"):
        port_ma.MapAnything(port_ma.MapAnythingConfig.small(scene_rep_type="pointmap"), device="cpu")
    from mapanything_tpu_torch.train import losses as port_losses

    with pytest.raises(NotImplementedError, match="disentangled"):
        port_losses.factored_geometry_scale_loss(None, None, port_losses.LossConfig(disentangled=True))


def test_attention_on_a_device_it_does_not_serve_raises():
    q = torch.zeros(1, 4, 1, 64, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        flash_attention(q, q, q)


def test_seeded_initialisation_is_reproducible():
    cfg = port_ma.MapAnythingConfig.small(info_sharing_depth=2)
    a = port_ma.MapAnything(cfg, device="cpu", seed=3).state_dict()
    b = port_ma.MapAnything(cfg, device="cpu", seed=3).state_dict()
    c = port_ma.MapAnything(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["scale_token"], c["scale_token"])
    gamma = a["encoder.model.blocks.0.ls1.gamma"]
    assert torch.all(gamma == 1e-5)  # LayerScale starts at its init value, as in Flax
    assert torch.all(a["info_sharing.self_attention_blocks.0.attn.qkv.bias"] == 0)
