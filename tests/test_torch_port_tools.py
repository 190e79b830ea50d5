"""The port's benchmark, inference, finetune and data tools, in process on the CPU.

Each tool runs through its ``main`` (or ``run``) with ``--device cpu`` and the small
config on tiny inputs: two synthetic WAI scenes written to a temporary directory as
``test_torch_port_wai.py`` writes them (48 x 64 frames, a test-split scene list).
The one-sample finetune has a file of its own (``test_torch_port_finetune.py``).
Without CUDA every tool refuses to run unless ``--device cpu`` is given.
"""

import json

import numpy as np
import pytest
import torch
from test_torch_port_wai import write_scene

from mapanything_tpu_torch.benchmarking.dense_n_view import METRIC_NAMES
from mapanything_tpu_torch.tools import (
    benchmark_calibration,
    benchmark_dense_n_view,
    benchmark_many_views,
    benchmark_rmvd,
    inference_wai,
    one_sample_finetune,
    profile_dataloading,
    viz_dataset,
)
from mapanything_tpu_torch.utils import threads

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

SCENES = ("sceneA", "sceneB")


@pytest.fixture(scope="module")
def wai(tmp_path_factory):
    """Two ETH3D scenes of 8 frames (PNG frames, 16-bit PNG depth) listed in the test split."""
    base = tmp_path_factory.mktemp("wai_tools")
    root, meta = base / "eth3d", base / "meta"
    for k, name in enumerate(SCENES):
        write_scene(root, name, 8, 48, 64, "png", "png16", k)
    (meta / "test").mkdir(parents=True)
    np.save(meta / "test" / "eth3d_scene_list_test.npy", np.array(SCENES))
    return root, meta


def dataset_expr(wai, num_views=2, samples=None):
    root, meta = wai
    expr = (f"ETH3DWAI(ROOT={str(root)!r}, dataset_metadata_dir={str(meta)!r}, split='test', "
            f"num_views={num_views}, resolution=(56, 42), covisibility_thres=0.1, seed=0)")
    return expr if samples is None else f"{samples} @ {expr}"


def bench_argv(wai, tmp_path, *extra, num_views=2):
    return ["--dataset-expr", dataset_expr(wai, num_views), "--small", "--device", "cpu", "--num-workers", "0",
            "--batch-size", "1", "--out", str(tmp_path / "results.json"), *extra]


@pytest.mark.parametrize("task", ["images_only", "mvs"])
def test_benchmark_dense_n_view_tool(wai, tmp_path, task):
    results = benchmark_dense_n_view.main(bench_argv(wai, tmp_path, "--task", task))
    assert set(results) == {*SCENES, "overall"}
    assert json.loads((tmp_path / "results.json").read_text()) == results
    for scene in results.values():
        assert set(scene) == set(METRIC_NAMES) and all(np.isfinite(v) for v in scene.values()), scene
        assert 0 <= scene["pointmaps_inlier_thres_103"] <= 1 and 0 <= scene["pose_auc_5"] <= 100


def test_benchmark_calibration_and_rmvd_tools(wai, tmp_path):
    calib = benchmark_calibration.main(bench_argv(wai, tmp_path, num_views=1))
    assert set(calib) == {*SCENES, "overall"} and all(0 <= v < 180 for v in calib.values())
    rmvd = benchmark_rmvd.main(bench_argv(wai, tmp_path, "--max-batches", "1"))
    assert rmvd["num_samples"] == 1 and np.isfinite(rmvd["absrel"]) and 0 <= rmvd["inlier103"] <= 100
    assert json.loads((tmp_path / "results.json").read_text()) == rmvd


def test_benchmark_many_views_tool(capsys):
    run = benchmark_many_views.run(benchmark_many_views.parse_args(
        ["--views", "4", "--res", "56", "--iters", "1", "--head-chunk", "3", "--small", "--device", "cpu"]))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == run["line"] and line["metric"] == "4-view 56px memory-efficient inference"
    assert line["head_chunk_size"] == 2 and line["value"] > 0 and line["seconds_per_scene"] > 0
    assert run["model"].config.compute_dtype == "bfloat16" and run["preds"].pts3d.shape == (1, 4, 56, 56, 3)


@pytest.mark.parametrize("priors", [(), ("--use-calib", "--use-poses", "--use-depth")])
def test_inference_wai_tool(wai, tmp_path, priors):
    root, _ = wai
    run = inference_wai.run(inference_wai.parse_args(
        ["--scene", str(root / "sceneA"), "--out", str(tmp_path / "out"), "--num-views", "2", "--stride", "3",
         "--small", "--device", "cpu", *priors]))
    assert run["views"]["names"] == ["0000", "0003"]
    assert sorted(run["views"]["priors"]) == (["camera_poses", "depth_z", "intrinsics"] if priors else [])
    assert run["views"]["images"].shape == (1, 2, 392, 518, 3)  # 4:3 frames in the 518 x 392 bucket
    for name in inference_wai.OUTPUTS:
        assert (tmp_path / "out" / name).stat().st_size > 0
    npz = np.load(tmp_path / "out" / "predictions.npz")
    assert npz["depth_z"].shape == (2, 392, 518, 1) and np.isfinite(npz["camera_poses"]).all()
    assert list(npz["names"]) == ["0000", "0003"]


def test_viz_dataset_and_profile_dataloading_tools(wai, tmp_path):
    root, meta = wai
    written = viz_dataset.main(["--dataset", "ETH3D", "--root", str(root), "--metadata", str(meta),
                                "--split", "test", "--out", str(tmp_path / "viz"), "--num-views", "2",
                                "--num-sets", "2", "--resolution", "56", "42", "--covis-thres", "0.1"])
    assert [p.name for p in written] == ["set0_views.png", "set0_scene.html", "set1_views.png", "set1_scene.html"]
    assert all(p.stat().st_size > 0 for p in written)
    assert viz_dataset.dataset_class("tav2_wb").dataset_name == "TartanAirV2WB"
    with pytest.raises(SystemExit, match="unknown dataset"):
        viz_dataset.dataset_class("nope")
    stats = profile_dataloading.main(["--dataset-expr", dataset_expr(wai, samples=4), "--images-per-batch", "4",
                                      "--num-workers", "0", "--max-batches", "3"])
    assert stats["images"] > 0 and stats["images_per_s"] > 0 and stats["ms_per_batch"] > 0


def test_tools_run_on_the_card_unless_told_otherwise(wai, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = wai
    argv = ["--dataset-expr", dataset_expr(wai), "--small", "--out", str(tmp_path / "r.json")]
    for tool, args in ((benchmark_dense_n_view, argv), (benchmark_calibration, argv), (benchmark_rmvd, argv),
                       (benchmark_many_views, ["--views", "2", "--res", "28", "--small"]),
                       (one_sample_finetune, ["--small", "--steps", "1", "--resolution", "28"]),
                       (inference_wai, ["--scene", str(root / "sceneA"), "--small"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(args)
