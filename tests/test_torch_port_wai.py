"""WAI scenes from disk through the port against the JAX package, on the CPU, and the
port's train tool against ``scripts/train.py``.

Scenes are written to tmp_path by cv2 (PNG and JPEG frames, 16-bit millimetre
PNG depth), the JAX package's EXR writer and numpy (npy depth, covisibility,
scene lists), from numpy seeds. ``load_frame`` equals the JAX one's exactly
for PNG, 16-bit PNG, EXR and npy, and within one grey level for JPEG (the
port's decoder against cv2); the WAI datasets' items match the JAX ones'
(images within one grey level, geometry within 1e-5 relative, masks equal);
``tools/train.main`` on a small model with a WAI dataset runs two steps on the
CPU, and its first batch, ``LossConfig``, ``TrainLoopConfig``, geometric-input
and model configs equal those that ``scripts/train.py`` builds from the same
config (its model init and Trainer stubbed: only what it builds is compared).
"""

import dataclasses
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mapanything_tpu.data import wai as jax_wai
from mapanything_tpu.data.datasets import wai_datasets as jax_wds
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.train import loop as jax_loop
from mapanything_tpu.utils.exr import write_depth_exr as jax_write_exr
from mapanything_tpu_torch.data import wai as port_wai
from mapanything_tpu_torch.data.datasets import wai_datasets as port_wds
from mapanything_tpu_torch.tools import train as port_train
from mapanything_tpu_torch.utils import exr as port_exr
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.image import read_png

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ROOT = Path(__file__).resolve().parents[1]
GREY = 1.0 / 255.0
GEOMETRY_KEYS = ("pts3d", "pts3d_cam", "depth_along_ray", "ray_directions_cam", "camera_pose_quats",
                 "camera_pose_trans")
FORMATS = {"sceneA": ("png", "png16"), "sceneB": ("jpg", "exr"), "sceneC": ("png", "npy")}


def write_scene(root: Path, name: str, n: int, h: int, w: int, image_fmt: str, depth_fmt: str, seed: int):
    """A WAI scene: n frames on a camera path, smooth depth with holes, chain covisibility."""
    rng = np.random.RandomState(seed)
    scene = root / name
    for sub in ("images", "depth", "covisibility/v0"):
        (scene / sub).mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        img = 128 + 90 * (np.sin(xx / 9.0 + i) * np.cos(yy / 13.0))[..., None] + rng.randn(h, w, 3) * 12
        img = np.clip(img, 0, 255).astype(np.uint8)
        image = f"images/{i:04d}.{image_fmt}"
        assert cv2.imwrite(str(scene / image), img[..., ::-1])
        depth = (2.0 + 0.5 * np.sin(xx / 20.0 + i) + 0.3 * np.cos(yy / 15.0)).astype(np.float32)
        depth[rng.uniform(size=(h, w)) < 0.03] = 0.0
        if depth_fmt == "png16":
            path = f"depth/{i:04d}.png"
            assert cv2.imwrite(str(scene / path), np.round(depth * 1000).astype(np.uint16))
        elif depth_fmt == "exr":
            path = f"depth/{i:04d}.exr"
            jax_write_exr(scene / path, depth)
        else:
            path = f"depth/{i:04d}.npy"
            np.save(scene / path, depth)
        q, _ = np.linalg.qr(np.eye(3) + 0.1 * rng.randn(3, 3))
        pose = np.eye(4)
        pose[:3, :3] = q * np.sign(np.linalg.det(q))
        pose[:3, 3] = [0.1 * i, 0.02 * i, 0.01 * rng.randn()]
        frame = dict(frame_name=f"{i:04d}", image=image, depth=path, transform_matrix=pose.tolist())
        if i % 3 == 2:  # per-frame intrinsics on some frames, the scene's on the others
            frame.update(fl_x=0.9 * w, fl_y=0.9 * w, cx=w / 2 - 0.5, cy=h / 2 - 0.5)
        frames.append(frame)
    meta = dict(frames=frames, fl_x=0.8 * w, fl_y=0.8 * w, cx=w / 2 - 0.5, cy=h / 2 - 0.5)
    (scene / "scene_meta.json").write_text(json.dumps(meta))
    covis = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(max(0, i - 3), min(n, i + 4)):
            covis[i, j] = 1.0 if i == j else rng.uniform(0.2, 0.8)
    np.save(scene / "covisibility" / "v0" / "pairwise.npy", covis)


@pytest.fixture(scope="module")
def wai(tmp_path_factory):
    """Three ETH3D scenes (one per format pair) and their scene list."""
    base = tmp_path_factory.mktemp("wai")
    root, meta = base / "eth3d", base / "meta"
    for k, (name, (image_fmt, depth_fmt)) in enumerate(FORMATS.items()):
        write_scene(root, name, 8, 48, 64, image_fmt, depth_fmt, k)
    (meta / "train").mkdir(parents=True)
    np.save(meta / "train" / "eth3d_scene_list_train.npy", np.array(list(FORMATS)))
    return base, root, meta


def test_load_frame_matches_jax(wai):
    _, root, _ = wai
    for name, (image_fmt, depth_fmt) in FORMATS.items():
        meta = port_wai.load_scene_meta(root / name)
        assert meta == jax_wai.load_scene_meta(root / name)
        for frame in meta["frames"]:
            got = port_wai.load_frame(root / name, frame["frame_name"], ["image", "depth", "pose", "intrinsics"])
            want = jax_wai.load_frame(root / name, frame["frame_name"], ["image", "depth", "pose", "intrinsics"],
                                      meta=meta)
            assert sorted(got) == sorted(want) and got["frame_idx"] == want["frame_idx"]
            for key in ("depth", "pose", "intrinsics"):
                assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), (name, key)
            if image_fmt == "png":
                assert np.array_equal(got["image"], want["image"]), name
            else:
                np.testing.assert_allclose(got["image"], want["image"], atol=GREY + 1e-7, rtol=0)
        assert np.array_equal(port_wai.load_covisibility(root / name), jax_wai.load_covisibility(root / name))
    assert not np.array_equal(*(port_wai.get_intrinsics(meta, f) for f in meta["frames"][1:3]))  # both routes
    with pytest.raises(FileNotFoundError):
        port_wai.load_image(root / "sceneA" / "images" / "missing.png")
    with pytest.raises(ValueError, match="unknown modality"):
        port_wai.load_frame(root / "sceneA", "0000", ["normals"])


def test_depth_and_exr_writers_round_trip(tmp_path):
    depth = np.random.default_rng(0).uniform(0.1, 9.0, (13, 17)).astype(np.float32)
    port_exr.write_depth_exr(tmp_path / "p.exr", depth)
    jax_write_exr(tmp_path / "j.exr", depth)
    assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    assert np.array_equal(port_exr.read_depth_exr(tmp_path / "j.exr"), depth)
    mm = np.round(depth * 1000).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), mm)
    assert np.array_equal(read_png(tmp_path / "d.png", unchanged=True), mm)
    assert np.array_equal(port_wai.load_depth(tmp_path / "d.png"), jax_wai.load_depth(tmp_path / "d.png"))


def dataset_kwargs(root, meta, **kw):
    out = dict(ROOT=str(root), dataset_metadata_dir=str(meta), split="train", num_views=4, covisibility_thres=0.25,
               resolution=[(56, 42), (42, 56)], aug_crop=16, transform="imgnorm", seed=5)
    out.update(kw)
    return out


def test_wai_dataset_items_match_jax(wai):
    _, root, meta = wai
    port = port_wds.ETH3DWAI(**dataset_kwargs(root, meta))
    jax = jax_wds.ETH3DWAI(**dataset_kwargs(root, meta))
    assert len(port) == len(jax) == 3 and sorted(port_wds.ALL_WAI_DATASETS) == sorted(jax_wds.ALL_WAI_DATASETS)
    for name, cls in port_wds.ALL_WAI_DATASETS.items():
        ref = jax_wds.ALL_WAI_DATASETS[name]
        assert (cls.metadata_prefix, cls.default_split, cls.is_metric_scale, cls.is_synthetic) == (
            ref.metadata_prefix, ref.default_split, ref.is_metric_scale, ref.is_synthetic), name
    for idx in range(3):
        for ar in (0, 1):
            got, want = port[(idx, ar)], jax[(idx, ar)]
            for g, w in zip(got, want):
                assert (g["label"], g["instance"], g["idx"]) == (w["label"], w["instance"], w["idx"])
                np.testing.assert_allclose(g["img_no_norm"], w["img_no_norm"], atol=GREY + 1e-6, rtol=0)
                for key in GEOMETRY_KEYS:
                    np.testing.assert_allclose(g[key], w[key], atol=1e-5 * float(np.abs(w[key]).max()), rtol=0)
                for key in ("valid_mask", "non_ambiguous_mask"):
                    assert np.array_equal(g[key], w[key]), key


# ---------------------------------------------------------------- the train tool


SMALL_MODEL = ["model.encoder.size=small", "model.info_sharing.depth=4", "model.info_sharing.dim=256",
               "model.info_sharing.num_heads=4", "model.info_sharing.indices=[1, 2]",
               "model.pred_head.dpt_feature_dim=64", "model.pred_head.dpt_layer_dims=[32, 48, 64, 96]",
               "model.compute_dtype=float32"]


def tool_args(base, root, meta, out):
    expr = ("2 @ ETH3DWAI(split='train', resolution=[(56, 42), (42, 56)], aug_crop=16, transform='imgnorm', "
            f"ROOT='{root}', dataset_metadata_dir='{meta}', num_views=2, covisibility_thres=0.25, seed=3)")
    overrides = SMALL_MODEL + [
        f"machine.root_data_dir={base}", f"machine.mapanything_dataset_metadata_dir={meta}",
        f"machine.root_experiments_dir={out}", "num_workers=1", "images_per_batch=2", "train_params.epochs=1",
        "train_params.lr=5e-5", "train_params.warmup_epochs=0.5", "model.task.overall_prob=0.5",
    ]
    return ["--config", str(ROOT / "configs" / "train.yaml"), "--dataset-expr", expr] + sum(
        (["--override", o] for o in overrides), [])


def jax_script_builds(monkeypatch, argv):
    """What scripts/train.py builds from ``argv``: its model init and Trainer stubbed."""
    spec = importlib.util.spec_from_file_location("jax_train_script", ROOT / "scripts" / "train.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    built = {}

    class Model:
        def __init__(self, cfg):
            built["model_cfg"] = cfg

        def init(self, rng, views):
            return {"params": {}}

    class Trainer:
        def __init__(self, model, loader, cfg, loss_cfg, geo_cfg, init_params, mesh):
            built.update(loader=loader, loop_cfg=cfg, loss_cfg=loss_cfg, geo_cfg=geo_cfg, mesh=mesh)

        def train(self):
            pass

    monkeypatch.setattr(jax_ma, "MapAnything", Model)
    monkeypatch.setattr(jax_loop, "Trainer", Trainer)
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    script.main()
    return built


def fields(obj, names):
    return {n: getattr(obj, n) for n in names}


def test_train_tool_matches_the_jax_script(wai, tmp_path, monkeypatch):
    base, root, meta = wai
    argv = tool_args(base, root, meta, tmp_path)
    trainer = port_train.main(argv + ["--device", "cpu"])
    assert trainer.state.step == 2 and trainer.state.opt_state.count == 2  # 2 samples, a batch each
    log = [json.loads(x) for x in (tmp_path / "train" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in log] == [0] and np.isfinite(log[0]["train_loss"])
    shutil.rmtree(tmp_path / "train")  # the small multimodal model's checkpoint: 0.8 GB

    want = jax_script_builds(monkeypatch, argv)
    assert want["mesh"] is None
    port_names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(trainer.model.config, ["encoder_size", "patch_size", "info_sharing_depth", "info_sharing_dim",
                                         "info_sharing_num_heads", "info_sharing_indices", "use_entropy_scaling",
                                         "dpt_feature_dim", "dpt_hooks", "dpt_layer_dims", "scene_rep_type",
                                         "compute_dtype"]) == fields(
        want["model_cfg"], ["encoder_size", "patch_size", "info_sharing_depth", "info_sharing_dim",
                            "info_sharing_num_heads", "info_sharing_indices", "use_entropy_scaling",
                            "dpt_feature_dim", "dpt_hooks", "dpt_layer_dims", "scene_rep_type", "compute_dtype"])
    for key in ("loop_cfg", "loss_cfg", "geo_cfg"):
        got = getattr(trainer, {"loop_cfg": "cfg"}.get(key, key))
        assert fields(got, port_names(type(got))) == fields(want[key], port_names(type(got))), key
    assert trainer.cfg.lr == 5e-5 and trainer.geo_cfg.overall_prob == 0.5

    got_loader, want_loader = trainer.train_loader, want["loader"]
    assert len(got_loader) == len(want_loader) == 2
    got_loader.set_epoch(0)
    want_loader.set_epoch(0)
    got, first = next(iter(got_loader)), next(iter(want_loader))
    assert sorted(got) == sorted(first) and got["label"] == first["label"]
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    np.testing.assert_allclose(got["img"] * std, first["img"] * std, atol=GREY + 1e-6, rtol=0)
    for key in GEOMETRY_KEYS:
        np.testing.assert_allclose(got[key], first[key], atol=1e-5 * float(np.abs(first[key]).max()), rtol=0)
    for key in ("valid_mask", "non_ambiguous_mask", "is_metric_scale", "is_synthetic"):
        assert np.array_equal(got[key], first[key]), key


def test_train_tool_refuses_what_the_port_lacks(wai, tmp_path, monkeypatch):
    base, root, meta = wai
    argv = tool_args(base, root, meta, tmp_path) + ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 1"):
        port_train.main(argv + ["--override", "distributed.mesh.view_parallelism=2"])
    with pytest.raises(NotImplementedError, match="not ported, by design"):
        port_train.main(argv + ["--override", "model.remat=true"])
    with pytest.raises(ValueError, match="no dataset"):
        port_train.build(port_train.parse_args(["--config", str(ROOT / "configs" / "train.yaml"), "--override",
                                                "dataset.train_dataset=???"]))
    ds = port_train.build_dataset(f"3 * ETH3D(ROOT='{root}', dataset_metadata_dir='{meta}', split='train', "
                                  "num_views=2, resolution=(56, 42))")
    assert len(ds) == 9 and repr(ds).startswith("3*")
    with pytest.raises(NameError):
        port_train.build_dataset("open('x')")  # no builtins in the DSL
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the card unless --device names another
        port_train.main(tool_args(base, root, meta, tmp_path))
